"""Peer-aware routing across N codistilled replicas + the fleet driver.

  * ``round_robin``  — cyclic assignment;
  * ``least_loaded`` — the peer with the fewest queued + live requests at
                       arrival (ties -> lowest peer id);
  * ``ensemble``     — every request runs on ALL peers; the rotating
                       primary answers the client, the shadows feed the
                       agreement signal;
  * ``speculative``  — every serving peer is a ``SpecEngine`` drafting on
                       its ring neighbour, a dedicated draft peer, or a
                       student model.

Canaries: every ``canary_every``-th request is duplicated to the next peer,
and the pair's prefill logits are compared with ``distill_pair("mse")``, the
training side's agreement metric (on the card, the fused distillation
kernel). A peer whose divergence spikes has drifted.

Weight refresh follows the async runtime mailbox's keep-last policy:
``checkpoint/io.py`` snapshots are polled every ``refresh_every_ms`` of
simulated time; only a snapshot STRICTLY NEWER than the peer's weights is
adopted, and one more than ``staleness_bound`` steps behind the newest is
dropped. The bytes are billed once per adopted snapshot through
``core/comm_model.py``'s checkpoint-exchange event.

Chaos: with a ``ChaosConfig`` the engines consult the seeded fault schedule
every tick, and with a ``FleetDefense`` the router fights back: health-aware
peer selection, migration of in-flight work off dead or preempted peers
with at-most-once token emission, hedged dispatch of the slowest-decile
requests, and degraded-mode admission. Without either config the run path
is the clean one.

``FleetReport`` carries every field of the reference's report, and
``stream_digest`` is the same sha256 over the client token streams, so a
port run and a reference run on the same weights and workload compare by
digest. The reference's tracer, metrics and alert hooks come with the
observability port.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (has_snapshot, load_snapshot_params,
                                       snapshot_meta)
from repro_torch.core.codistillation import distill_pair
from repro_torch.core.comm_model import bits_per_exchange_event, param_bits_of
from repro_torch.obs.metrics import Histogram
from repro_torch.serve.fleet.batcher import (FleetConfig, FleetEngine,
                                             RequestRecord)
from repro_torch.serve.fleet.chaos import (ChaosConfig, ChaosSchedule,
                                           ChaosStats, FleetDefense,
                                           PeerHealth, _HedgePair, _Orphan)
from repro_torch.serve.fleet.spec import SpecConfig, SpecEngine
from repro_torch.serve.fleet.workload import Workload

PyTree = Any

POLICIES = ("round_robin", "least_loaded", "ensemble", "speculative")


@dataclass
class CanaryStats:
    """Agreement of primary / shadow pairs: the mse of their prefill logits
    (``distill_pair("mse")`` on ``device``) and their token agreement."""
    device: Any = "cpu"
    count: int = 0
    mse_sum: float = 0.0
    mse_max: float = 0.0
    token_agree: int = 0
    token_total: int = 0

    def observe(self, primary: RequestRecord, shadow: RequestRecord) -> None:
        if primary.prefill_logits is None or shadow.prefill_logits is None:
            return
        a = torch.as_tensor(primary.prefill_logits, device=self.device)[None]
        b = torch.as_tensor(shadow.prefill_logits, device=self.device)[None]
        mse = float(distill_pair("mse", a, b))
        self.count += 1
        self.mse_sum += mse
        self.mse_max = max(self.mse_max, mse)
        n = min(len(primary.tokens), len(shadow.tokens))
        self.token_total += n
        self.token_agree += sum(1 for x, y in zip(primary.tokens[:n],
                                                  shadow.tokens[:n]) if x == y)

    def summary(self) -> Dict:
        return {
            "count": self.count,
            "mean_mse": self.mse_sum / self.count if self.count else 0.0,
            "max_mse": self.mse_max,
            "token_agreement": (self.token_agree / self.token_total
                                if self.token_total else 1.0),
        }


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
    # chaos accounting (zero on clean runs)
    goodput_tokens_per_s: float = 0.0   # tokens of SLO-met completions
    lost_tokens: int = 0             # completed streams short of max_new
    duplicated_tokens: int = 0       # completed streams over max_new
    migrations: int = 0
    migration_failures: int = 0
    hedges: int = 0
    hedge_wins: int = 0
    preemptions: int = 0
    peers_died: int = 0
    peers_recovered: int = 0
    # speculative decoding (zero on plain runs)
    spec_rounds: int = 0
    spec_drafted_tokens: int = 0
    spec_accepted_tokens: int = 0
    spec_accept_rate: float = 0.0
    spec_fallback_ticks: int = 0

    def to_dict(self) -> Dict:
        return dict(self.__dict__)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)


class FleetRouter:
    def __init__(self, model, peer_params: List[PyTree],
                 config: Optional[FleetConfig] = None,
                 policy: str = "round_robin",
                 cache_dtype=torch.float32,
                 canary_every: int = 0,
                 snapshot_dir: Optional[str] = None,
                 refresh_every_ms: float = 0.0,
                 staleness_bound: int = 0,
                 chaos: Optional[ChaosConfig] = None,
                 defense: Optional[FleetDefense] = None,
                 spec: Optional[SpecConfig] = None,
                 draft_model=None, draft_params: PyTree = None,
                 device="cuda"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        if not peer_params:
            raise ValueError("a fleet needs at least one peer")
        self.policy = policy
        self.config = config or FleetConfig()
        # speculative pairing: every serving peer is a SpecEngine whose draft
        # is its ring neighbour, a dedicated peer (out of the serving
        # rotation) or a static student; _spec_serving is None otherwise
        self._spec_serving: Optional[List[int]] = None
        if policy == "speculative":
            sc = spec or SpecConfig()
            student = draft_params is not None
            dedicated = None if student else sc.draft_peer
            if dedicated is not None and not 0 <= dedicated < len(peer_params):
                raise ValueError(f"draft peer {dedicated} out of range for "
                                 f"{len(peer_params)} peers")
            if not student and len(peer_params) < 2:
                raise ValueError(
                    "speculative ring pairing needs >= 2 peers "
                    "(or pass draft_model/draft_params for a student draft)")
            self.engines = [
                FleetEngine(model, p, self.config, cache_dtype=cache_dtype,
                            device=device, peer_id=i)
                if i == dedicated else
                SpecEngine(model, p, self.config, sc, cache_dtype=cache_dtype,
                           device=device, peer_id=i, draft_model=draft_model,
                           draft_params=draft_params)
                for i, p in enumerate(peer_params)]
            serving = [i for i, e in enumerate(self.engines)
                       if isinstance(e, SpecEngine)]
            if not student:
                for pos, i in enumerate(serving):
                    self.engines[i].set_partner(
                        self.engines[dedicated] if dedicated is not None
                        else self.engines[serving[(pos + 1) % len(serving)]])
            self._spec_serving = serving
        else:
            self.engines = [FleetEngine(model, p, self.config,
                                        cache_dtype=cache_dtype,
                                        keep_logits=(policy == "ensemble"),
                                        device=device, peer_id=i)
                            for i, p in enumerate(peer_params)]
        self.canary_every = canary_every
        self.snapshot_dir = snapshot_dir
        self.refresh_every_ms = refresh_every_ms
        self.staleness_bound = staleness_bound
        self._next_refresh_ms = refresh_every_ms
        self._rr = 0
        self._since_canary = 0
        # one weight refresh moves one replica across the slow links: the
        # n=2 checkpoint-exchange event (sender + this peer), billed once
        # per adopted snapshot
        self._param_bytes = int(bits_per_exchange_event(
            "checkpoints", 2, b_model=param_bits_of(peer_params[0])) // 8)
        self.refresh_bytes = 0
        self.refreshes = 0
        self.refreshes_dropped_stale = 0
        self.canary_stats = CanaryStats(device=self.engines[0].device)
        # (primary record, shadow record) pairs compared after the run
        self._pairs: List[tuple] = []
        self._primaries: List[RequestRecord] = []
        # ---- chaos state ----
        self.chaos = chaos
        self.defense = defense
        self.chaos_stats = ChaosStats()
        if chaos is not None:
            sched = ChaosSchedule(chaos)
            for eng in self.engines:
                eng.chaos = sched
        if defense is not None:
            for eng in self.engines:
                eng.health = PeerHealth(alpha=defense.health_alpha)
        self._death_seen = [False] * len(self.engines)
        self._orphans: List[_Orphan] = []          # awaiting (re)placement
        self._continuations: List[RequestRecord] = []   # live migrated copies
        self._phys2logical: Dict[int, RequestRecord] = {}
        self._hedge_pairs: List[_HedgePair] = []
        self._hedge_by_id: Dict[int, _HedgePair] = {}
        # the hedging threshold over request sizes
        self._size_hist = Histogram(name="router/hedge_size_tokens")

    # ---- peer selection ----------------------------------------------------
    def _serving(self, peers: List[int]) -> List[int]:
        """Restrict to the serving rotation (drops a dedicated draft peer
        under the speculative policy; identity everywhere else)."""
        if self._spec_serving is None:
            return peers
        return [i for i in peers if i in self._spec_serving]

    def _available(self, t_ms: float) -> List[int]:
        return [i for i, e in enumerate(self.engines)
                if not e.dead and e.offline_until_ms <= t_ms]

    def _healthy(self, t_ms: float) -> List[int]:
        """Available peers whose tick-cost EWMA looks nominal; any available
        peer when every one looks sick (serving from a straggler beats not
        serving)."""
        avail = self._serving(self._available(t_ms))
        if self.defense is None:
            return avail
        ok = [i for i in avail
              if self.engines[i].health is None
              or self.engines[i].health.healthy(self.defense.unhealthy_factor)]
        return ok or avail

    def _pick(self, t_ms: float) -> Optional[int]:
        n = len(self.engines)
        if self.defense is None:
            # undefended: route blindly, dead peers included (the baseline
            # the defenses are measured against)
            cands = self._serving(list(range(n)))
        else:
            cands = self._healthy(t_ms)
        if not cands:
            return None
        if self.policy == "least_loaded":
            return min(cands, key=lambda i: (self.engines[i].load, i))
        for _ in range(n):
            peer = self._rr % n
            self._rr += 1
            if peer in cands:
                return peer
        return cands[0]

    def _route(self, request) -> None:
        n = len(self.engines)
        t = request.arrival_ms
        if self.policy == "ensemble":
            if self.defense is None:
                avail = list(range(n))
            else:
                avail = self._available(t)
                if not avail:
                    self._no_capacity(request, t)
                    return
            for _ in range(n):
                primary = self._rr % n
                self._rr += 1
                if primary in avail:
                    break
            prec = self.engines[primary].enqueue(request)
            self._primaries.append(prec)
            for off in range(1, n):
                peer = (primary + off) % n
                if peer not in avail:
                    continue
                srec = self.engines[peer].enqueue(request, canary=True)
                self._pairs.append((prec, srec))
            return
        peer = self._pick(t)
        if peer is None:
            self._no_capacity(request, t)
            return
        prec = self.engines[peer].enqueue(request)
        self._primaries.append(prec)
        self._since_canary += 1
        if (self.canary_every and n > 1
                and self._since_canary >= self.canary_every):
            self._since_canary = 0
            shadow = self._shadow_of(peer)
            if shadow != peer:
                prec.canary = True   # keep the primary's prefill logits too
                srec = self.engines[shadow].enqueue(request, canary=True)
                self._pairs.append((prec, srec))
        self._maybe_hedge(request, prec, peer)

    def _shadow_of(self, peer: int) -> int:
        """Canary shadow: the next peer in the SERVING rotation (a dedicated
        draft peer never serves, not even shadows); ``peer`` itself when
        there is no other serving peer."""
        n = len(self.engines)
        if self._spec_serving is None:
            return (peer + 1) % n
        if len(self._spec_serving) < 2 or peer not in self._spec_serving:
            return peer
        pos = self._spec_serving.index(peer)
        return self._spec_serving[(pos + 1) % len(self._spec_serving)]

    def _no_capacity(self, request, t_ms: float) -> None:
        """Every peer is dead or offline at arrival."""
        alive = self._serving([i for i, e in enumerate(self.engines)
                               if not e.dead])
        rec = RequestRecord(request)
        if self.defense is not None and alive:
            # park: the orphan machinery places it when a peer returns
            self._primaries.append(rec)
            self._orphans.append(_Orphan(rec, t_ms))
            return
        if alive:
            # undefended: queue on whichever peer comes back soonest
            peer = min(alive, key=lambda i: (self.engines[i].offline_until_ms,
                                             i))
            self._primaries.append(self.engines[peer].enqueue(request))
            return
        rec.rejected = True
        self._primaries.append(rec)

    def _maybe_hedge(self, request, prec: RequestRecord, ppeer: int) -> None:
        d = self.defense
        if not (d and d.hedging and len(self.engines) > 1):
            return
        h = self._size_hist
        if h.count < d.hedge_min_samples:
            h.observe(request.total_tokens)
            return
        # the threshold is over previously seen sizes only: this request is
        # observed after the quantile
        thr = h.quantile(d.hedge_quantile)
        h.observe(request.total_tokens)
        if request.total_tokens < thr:
            return
        cands = [i for i in self._healthy(request.arrival_ms) if i != ppeer]
        if not cands:
            return
        hpeer = min(cands, key=lambda i: (self.engines[i].load, i))
        hrec = self.engines[hpeer].enqueue(request)
        pair = _HedgePair(prec, hrec, ppeer, hpeer)
        self._hedge_pairs.append(pair)
        self._hedge_by_id[id(prec)] = pair
        self._hedge_by_id[id(hrec)] = pair
        self.chaos_stats.hedges += 1

    # ---- weight refresh (keep-last, staleness-bounded) ---------------------
    def refresh_now(self) -> int:
        """One poll of the snapshot directory; returns peers refreshed."""
        if not self.snapshot_dir:
            return 0
        n0 = self.refreshes
        metas = [snapshot_meta(self.snapshot_dir, i)
                 for i in range(len(self.engines))]
        steps = [m.get("step", -1) if m else -1 for m in metas]
        newest = max(steps) if steps else -1
        for i, eng in enumerate(self.engines):
            step = steps[i]
            if step < 0 or step <= eng.weights_version:
                continue             # keep-last: never adopt older weights
            if self.staleness_bound and newest - step > self.staleness_bound:
                self.refreshes_dropped_stale += 1
                continue             # too stale against the newest: drop
            params = load_snapshot_params(self.snapshot_dir, i, eng.params)
            eng.set_params(params)
            eng.weights_version = step
            self.refreshes += 1
            self.refresh_bytes += self._param_bytes
        return self.refreshes - n0

    def _maybe_refresh(self, t_ms: float) -> None:
        if not self.snapshot_dir or self.refresh_every_ms <= 0:
            return
        if t_ms >= self._next_refresh_ms:
            # one poll per catch-up however long the gap: the skipped polls
            # would all see the same directory
            periods = int((t_ms - self._next_refresh_ms)
                          // self.refresh_every_ms) + 1
            self._next_refresh_ms += periods * self.refresh_every_ms
            self.refresh_now()

    # ---- migration / hedging / recovery maintenance ------------------------
    def _logical_of(self, rec: RequestRecord) -> RequestRecord:
        """Resolve a harvested physical record to its client-facing record,
        folding any partial progress into it first."""
        logical = self._phys2logical.pop(id(rec), None)
        if logical is None:
            return rec               # the original placement
        if rec in self._continuations:
            self._continuations.remove(rec)
        self._fold(logical, rec)
        return logical

    @staticmethod
    def _fold(logical: RequestRecord, phys: RequestRecord) -> None:
        """Merge a continuation's progress into the client-facing record.
        Tokens already on ``logical`` were emitted BEFORE this placement, so
        extending keeps emission at most once."""
        logical.tokens.extend(phys.tokens)
        if logical.admitted_ms is None:
            logical.admitted_ms = phys.admitted_ms
        if logical.first_token_ms is None:
            logical.first_token_ms = phys.first_token_ms
        if phys.finished_ms is not None:
            logical.finished_ms = phys.finished_ms
            logical.cancelled = False

    def _queue_migration(self, logical: RequestRecord, t_ms: float) -> None:
        if len(logical.tokens) >= logical.request.max_new:
            # every output token was already emitted: complete
            logical.finished_ms = logical.finished_ms or t_ms
            logical.cancelled = False
            return
        backoff = (0.0 if logical.migrations == 0 else
                   self.defense.retry_backoff_ms
                   * (2 ** (logical.migrations - 1)))
        self._orphans.append(_Orphan(logical, t_ms + backoff))

    def _absorb_harvested(self, recs: List[RequestRecord],
                          t_ms: float) -> None:
        for rec in recs:
            pair = self._hedge_by_id.get(id(rec))
            if pair is not None:
                if rec is pair.rec:
                    pair.palive = False
                else:
                    pair.halive = False
                if pair.palive or pair.halive:
                    continue         # the surviving copy carries the request
                # both copies gone: hedging delivered nothing (whole-response
                # semantics), so the client record restarts from scratch
                self._unhedge(pair)
                logical = pair.rec
                logical.tokens.clear()
                logical.admitted_ms = None
                logical.first_token_ms = None
            else:
                logical = self._logical_of(rec)
            self._queue_migration(logical, t_ms)

    def _unhedge(self, pair: _HedgePair) -> None:
        self._hedge_pairs.remove(pair)
        self._hedge_by_id.pop(id(pair.rec), None)
        self._hedge_by_id.pop(id(pair.hrec), None)

    def _sweep_continuations(self, t_ms: float) -> None:
        for prec in list(self._continuations):
            logical = self._phys2logical[id(prec)]
            if prec.rejected:
                # the target queue shed the continuation: back off, retry
                self._continuations.remove(prec)
                del self._phys2logical[id(prec)]
                self._queue_migration(logical, t_ms)
            elif prec.finished_ms is not None:
                self._continuations.remove(prec)
                del self._phys2logical[id(prec)]
                self._fold(logical, prec)

    def _resolve_hedges(self, t_ms: float) -> None:
        for pair in list(self._hedge_pairs):
            prec, hrec = pair.rec, pair.hrec
            if pair.palive and prec.rejected:
                pair.palive = False  # admission shed == copy death
            if pair.halive and hrec.rejected:
                pair.halive = False
            pwin = pair.palive and prec.finished_ms is not None
            hwin = pair.halive and hrec.finished_ms is not None
            if pwin and (not hwin or prec.finished_ms <= hrec.finished_ms):
                if pair.halive and hrec.finished_ms is None:
                    self.engines[pair.hpeer].cancel(hrec)
                self._unhedge(pair)
            elif hwin:
                if pair.palive and prec.finished_ms is None:
                    self.engines[pair.ppeer].cancel(prec)
                # the first winner answers the client, wholesale (nothing was
                # delivered from the loser)
                prec.tokens[:] = hrec.tokens
                prec.admitted_ms = hrec.admitted_ms
                prec.first_token_ms = hrec.first_token_ms
                prec.finished_ms = hrec.finished_ms
                prec.rejected = False
                prec.cancelled = False
                self.chaos_stats.hedge_wins += 1
                self._unhedge(pair)
            elif not pair.palive and not pair.halive:
                # both copies rejected at admission: the shed stands
                self._unhedge(pair)

    def _sweep_peers(self, t_ms: float) -> None:
        migrate = self.defense is not None and self.defense.migration
        for i, eng in enumerate(self.engines):
            if eng.dead and not self._death_seen[i]:
                self._death_seen[i] = True
                self.chaos_stats.peers_died += 1
                if migrate:
                    self._absorb_harvested(eng.harvest(), t_ms)
            elif (migrate and not eng.dead and eng.has_work()
                  and eng.offline_until_ms - t_ms
                  > self.defense.migrate_pause_over_ms):
                # preempted past the timeout: treat like a death for the
                # work's sake (the peer itself will return)
                self._absorb_harvested(eng.harvest(), t_ms)

    def _revive_due(self, t_ms: float) -> None:
        cz = self.chaos
        if cz is None or cz.recover_after_ms <= 0:
            return
        for i, eng in enumerate(self.engines):
            if not eng.dead or t_ms < eng.died_at_ms + cz.recover_after_ms:
                continue
            if not (self.defense is not None and self.defense.migration):
                eng.harvest()        # undefended: the doomed work is dropped
            params = version = None
            if self.snapshot_dir and has_snapshot(self.snapshot_dir, i):
                params = load_snapshot_params(self.snapshot_dir, i,
                                              eng.params)
                meta = snapshot_meta(self.snapshot_dir, i) or {}
                version = meta.get("step")
                # recovery pulls one replica across the slow links: billed
                # to the same ledger as a refresh
                self.refresh_bytes += self._param_bytes
            eng.revive(t_ms, params, version)
            if eng.health is not None:
                eng.health.ewma = 1.0    # fresh machine, fresh prior
            self._death_seen[i] = False
            self.chaos_stats.peers_recovered += 1

    def _retry_orphans(self, t_ms: float) -> None:
        for orph in list(self._orphans):
            if orph.next_attempt_ms > t_ms:
                continue
            logical: RequestRecord = orph.rec
            if logical.migrations >= self.defense.max_migrations:
                self._orphans.remove(orph)
                self.chaos_stats.migration_failures += 1
                logical.rejected = True
                continue
            cands = self._healthy(t_ms)
            if not cands:
                orph.next_attempt_ms = t_ms + self.defense.retry_backoff_ms
                continue
            peer = min(cands, key=lambda i: (self.engines[i].load, i))
            req0 = logical.request
            cont = req0.continuation(tuple(logical.tokens),
                                     max(req0.arrival_ms, t_ms))
            new_rec = self.engines[peer].enqueue(cont)
            new_rec.origin = req0
            self._phys2logical[id(new_rec)] = logical
            self._continuations.append(new_rec)
            logical.migrations += 1
            self.chaos_stats.migrations += 1
            self._orphans.remove(orph)

    def _update_admission(self, t_ms: float) -> None:
        if not (self.defense is not None and self.defense.degraded_admission):
            return
        n = len(self.engines)
        up = len(self._available(t_ms))
        q = max(1, int(self.config.max_queue * up / n)) if up else 1
        for eng in self.engines:
            eng.max_queue_live = q

    def _chaos_maintenance(self, t_ms: float) -> None:
        self._sweep_continuations(t_ms)
        self._resolve_hedges(t_ms)
        self._sweep_peers(t_ms)
        self._revive_due(t_ms)
        if self.defense is not None:
            self._retry_orphans(t_ms)
        self._update_admission(t_ms)

    def _drain_chaos(self) -> None:
        """Drain in bounded time quanta so deaths, revivals, migrations and
        hedge resolutions keep happening after the last arrival."""
        quantum = (self.defense.maintenance_quantum_ms
                   if self.defense is not None else 20.0)
        guard = 0
        while guard < 200_000:
            guard += 1
            alive = [e for e in self.engines if not e.dead]
            recovering = (self.chaos is not None
                          and self.chaos.recover_after_ms > 0
                          and any(e.dead for e in self.engines))
            work = any(e.has_work() for e in alive)
            placing = bool(self._orphans or self._continuations
                           or self._hedge_pairs)
            if not work and not placing and not (recovering and self._orphans):
                break
            if not alive and not recovering:
                break                # nothing can ever progress again
            t = max(e.now_ms for e in self.engines) + quantum
            for e in self.engines:
                e.advance_to(t)
            self._chaos_maintenance(t)
        # stragglers that finished on the final quantum
        end = max(e.now_ms for e in self.engines)
        self._chaos_maintenance(end)

    # ---- the run loop ------------------------------------------------------
    def run(self, workload: Workload, slo_ms: float = 50.0) -> FleetReport:
        chaosy = self.chaos is not None or self.defense is not None
        for req in sorted(workload.requests, key=lambda r: r.arrival_ms):
            self._maybe_refresh(req.arrival_ms)
            for eng in self.engines:
                eng.advance_to(req.arrival_ms)
            if chaosy:
                self._chaos_maintenance(req.arrival_ms)
            self._route(req)
        if chaosy:
            self._drain_chaos()
        else:
            for eng in self.engines:
                eng.drain()
        end_ms = max((eng.now_ms for eng in self.engines), default=0.0)
        self._maybe_refresh(end_ms)
        for prec, srec in self._pairs:
            self.canary_stats.observe(prec, srec)
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
        cs = self.chaos_stats
        sstats = [e.spec_stats for e in self.engines
                  if isinstance(e, SpecEngine)]
        sp_drafted = sum(s.drafted for s in sstats)
        sp_accepted = sum(s.accepted for s in sstats)
        return FleetReport(
            scenario=workload.scenario,
            router=self.policy,
            peers=len(self.engines),
            seed=workload.seed,
            completed=len(done),
            # client-facing rejections only: canary and ensemble shadows
            # are bookkeeping duplicates
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
            refresh_bytes=self.refresh_bytes,
            refreshes=self.refreshes,
            refreshes_dropped_stale=self.refreshes_dropped_stale,
            peak_pool_utilization=max(e.peak_utilization
                                      for e in self.engines),
            canary=self.canary_stats.summary(),
            stream_digest=digest.hexdigest(),
            goodput_tokens_per_s=(good / (end_ms / 1e3) if end_ms > 0
                                  else 0.0),
            lost_tokens=sum(max(0, r.request.max_new - len(r.tokens))
                            for r in done),
            duplicated_tokens=sum(max(0, len(r.tokens) - r.request.max_new)
                                  for r in done),
            migrations=cs.migrations,
            migration_failures=cs.migration_failures,
            hedges=cs.hedges,
            hedge_wins=cs.hedge_wins,
            preemptions=sum(e.preemptions_hit for e in self.engines),
            peers_died=cs.peers_died,
            peers_recovered=cs.peers_recovered,
            spec_rounds=sum(s.rounds for s in sstats),
            spec_drafted_tokens=sp_drafted,
            spec_accepted_tokens=sp_accepted,
            spec_accept_rate=(sp_accepted / sp_drafted if sp_drafted
                              else 0.0),
            spec_fallback_ticks=sum(s.fallback_ticks for s in sstats),
        )
