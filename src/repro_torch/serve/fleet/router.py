"""Peer routing across N replicas + the fleet driver (the reference's clean
path: ``round_robin`` and ``least_loaded``).

  * ``round_robin``  — cyclic assignment;
  * ``least_loaded`` — the peer with the fewest queued + live requests at
                       arrival (ties -> lowest peer id).

``FleetReport`` carries every field of the reference's report; the canary,
weight-refresh, chaos and speculative fields stay at their zero values
until the slices that port those features. ``stream_digest`` is the same
sha256 over the client token streams, so a port run and a reference run on
the same weights and workload can be compared by digest.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import Histogram
from repro_torch.serve.fleet.batcher import (FleetConfig, FleetEngine,
                                             RequestRecord)
from repro_torch.serve.fleet.workload import Workload

PyTree = Any

POLICIES = ("round_robin", "least_loaded")
LATER_POLICIES = ("ensemble", "speculative")


@dataclass
class FleetReport:
    """SLO + accounting summary of one fleet run (all times simulated ms)."""
    scenario: str
    router: str
    peers: int
    seed: int
    completed: int
    rejected: int
    p50_ttft_ms: float
    p99_ttft_ms: float
    p50_e2e_ms: float
    p99_e2e_ms: float
    slo_ms: float
    slo_attainment: float            # fraction with TTFT <= slo_ms
    sim_tokens_per_s: float
    generated_tokens: int
    kv_bytes_written: int
    refresh_bytes: int
    refreshes: int
    refreshes_dropped_stale: int
    peak_pool_utilization: float
    canary: Dict = field(default_factory=dict)
    stream_digest: str = ""          # sha256 over client token streams
    goodput_tokens_per_s: float = 0.0
    lost_tokens: int = 0
    duplicated_tokens: int = 0
    migrations: int = 0
    migration_failures: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    preemptions: int = 0
    peers_died: int = 0
    peers_recovered: int = 0
    spec_rounds: int = 0
    spec_drafted_tokens: int = 0
    spec_accepted_tokens: int = 0
    spec_accept_rate: float = 0.0
    spec_fallback_ticks: int = 0

    def to_dict(self) -> Dict:
        return dict(self.__dict__)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)


# the reference's CanaryStats.summary() with no canary pairs observed
_NO_CANARY = {"count": 0, "mean_mse": 0.0, "max_mse": 0.0,
              "token_agreement": 1.0}


class FleetRouter:
    def __init__(self, model, peer_params: List[PyTree],
                 config: Optional[FleetConfig] = None,
                 policy: str = "round_robin",
                 cache_dtype=torch.float32, device="cuda"):
        if policy in LATER_POLICIES:
            raise NotImplementedError(
                f"router policy {policy!r} is not in the port yet: ensemble "
                "canaries and speculative decoding come in a later serving "
                "slice (ROADMAP Queue 1 item 8)")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        if not peer_params:
            raise ValueError("a fleet needs at least one peer")
        self.policy = policy
        self.config = config or FleetConfig()
        self.engines = [FleetEngine(model, p, self.config,
                                    cache_dtype=cache_dtype, device=device)
                        for p in peer_params]
        self._rr = 0
        self._primaries: List[RequestRecord] = []

    # ---- peer selection ----------------------------------------------------
    def _pick(self) -> int:
        n = len(self.engines)
        if self.policy == "least_loaded":
            return min(range(n), key=lambda i: (self.engines[i].load, i))
        peer = self._rr % n
        self._rr += 1
        return peer

    def _route(self, request) -> None:
        self._primaries.append(self.engines[self._pick()].enqueue(request))

    # ---- the run loop ------------------------------------------------------
    def run(self, workload: Workload, slo_ms: float = 50.0) -> FleetReport:
        for req in sorted(workload.requests, key=lambda r: r.arrival_ms):
            for eng in self.engines:
                eng.advance_to(req.arrival_ms)
            self._route(req)
        for eng in self.engines:
            eng.drain()
        end_ms = max((eng.now_ms for eng in self.engines), default=0.0)
        return self._report(workload, slo_ms, end_ms)

    def _report(self, workload: Workload, slo_ms: float,
                end_ms: float) -> FleetReport:
        done = [r for r in self._primaries if r.finished_ms is not None]
        ttfts = [r.ttft_ms for r in done]
        ttft_h = Histogram(name="fleet/ttft_ms")
        e2e_h = Histogram(name="fleet/e2e_ms")
        for t in ttfts:
            ttft_h.observe(t)
        for r in done:
            e2e_h.observe(r.e2e_ms)
        gen = sum(len(r.tokens) for r in done)
        good = sum(len(r.tokens) for r in done
                   if r.ttft_ms is not None and r.ttft_ms <= slo_ms)
        digest = hashlib.sha256()
        for r in sorted(self._primaries, key=lambda r: r.request.rid):
            digest.update(bytes(f"{r.request.rid}:", "ascii"))
            digest.update(np.asarray(r.tokens, np.int32).tobytes())
        return FleetReport(
            scenario=workload.scenario,
            router=self.policy,
            peers=len(self.engines),
            seed=workload.seed,
            completed=len(done),
            rejected=sum(1 for r in self._primaries if r.rejected),
            p50_ttft_ms=ttft_h.percentile(50) if ttft_h.count else 0.0,
            p99_ttft_ms=ttft_h.percentile(99) if ttft_h.count else 0.0,
            p50_e2e_ms=e2e_h.percentile(50) if e2e_h.count else 0.0,
            p99_e2e_ms=e2e_h.percentile(99) if e2e_h.count else 0.0,
            slo_ms=slo_ms,
            slo_attainment=(sum(1 for t in ttfts if t <= slo_ms) / len(ttfts)
                            if ttfts else 0.0),
            sim_tokens_per_s=gen / (end_ms / 1e3) if end_ms > 0 else 0.0,
            generated_tokens=gen,
            kv_bytes_written=sum(e.kv_bytes_written for e in self.engines),
            refresh_bytes=0,
            refreshes=0,
            refreshes_dropped_stale=0,
            peak_pool_utilization=max(e.peak_utilization
                                      for e in self.engines),
            canary=dict(_NO_CANARY),
            stream_digest=digest.hexdigest(),
            goodput_tokens_per_s=(good / (end_ms / 1e3) if end_ms > 0
                                  else 0.0),
            lost_tokens=sum(max(0, r.request.max_new - len(r.tokens))
                            for r in done),
            duplicated_tokens=sum(max(0, len(r.tokens) - r.request.max_new)
                                  for r in done),
        )
