"""Virtual time and seeded fault injection for the async peer runtime.

The runtime never reads the wall clock: every peer advances a **simulated**
clock by a per-step duration drawn from a seeded :class:`FaultSchedule`, so a
run is a pure function of ``(configs, seed)`` and is replayable bit-for-bit.

The schedule is **unit-agnostic**: a "step" is whatever the consumer's clock
ticks in — a training step for the async runtime, a decode tick for the
serving fleet's chaos driver (``repro.serve.fleet.chaos``) — and a
"duration" is a dimensionless multiple of the peer's base tick cost.
``duration()`` gives the full seconds-per-step (base speed x episode
multiplier); ``slowdown()`` gives the same number as a pure multiplier for
consumers whose tick cost is set elsewhere (the fleet's deterministic
per-tick cost model). The schedule models the failure modes that motivate
codistillation's weak synchronization (Anil et al., arXiv:1804.03235;
"Revisiting Distributed Synchronous SGD", arXiv:1604.00981):

  * **speed heterogeneity** — each peer has a base seconds-per-step drawn
    once (lognormal around 1.0, ``speed_sigma``) or given explicitly;
  * **straggler episodes** — designated peers run ``straggler_factor`` x
    slower for contiguous episodes covering ``straggler_frac`` of steps;
  * **preemption** — a peer is absent for a fixed span of simulated time
    after a given local step (the barrier baseline stalls everyone);
  * **permanent failure** — a peer dies at a local step; with checkpointing
    enabled the scheduler revives it from its last snapshot after
    ``recover_after`` simulated seconds (elastic membership);
  * **elastic join** — a fresh peer enters mid-training at a simulated time
    and burns in before its distillation loss activates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class FaultConfig:
    """Seeded description of the virtual cluster and its fault schedule."""
    n_peers: int = 2
    seed: int = 0
    # per-peer base seconds-per-step; () => 1.0 each, jittered by speed_sigma
    speeds: Tuple[float, ...] = ()
    speed_sigma: float = 0.0
    # straggler episodes: each listed peer spends ~straggler_frac of its steps
    # in episodes of straggler_len steps running straggler_factor x slower
    straggler_peers: Tuple[int, ...] = ()
    straggler_factor: float = 4.0
    straggler_frac: float = 0.2
    straggler_len: int = 5
    # (peer, local_step, pause_sim_seconds): absent for `pause` after `step`
    preemptions: Tuple[Tuple[int, int, float], ...] = ()
    # (peer, local_step): dies permanently when reaching `step`
    failures: Tuple[Tuple[int, int], ...] = ()
    # (peer_index, sim_time): fresh peer joins the cluster at `sim_time`;
    # peer_index must be >= n_peers (it extends the membership)
    joins: Tuple[Tuple[int, float], ...] = ()

    def __post_init__(self):
        join_ids = [p for p, _ in self.joins]
        if any(p < self.n_peers for p in join_ids):
            raise ValueError(
                f"join peer indices {join_ids} must be >= n_peers="
                f"{self.n_peers}: a join EXTENDS the membership, it cannot "
                "replace an incumbent")
        if len(join_ids) != len(set(join_ids)):
            raise ValueError(f"duplicate join peer indices: {join_ids}")

    @property
    def n_total(self) -> int:
        """Initial peers plus elastic joiners: the cluster's max membership."""
        return max([self.n_peers] + [p + 1 for p, _ in self.joins])


class FaultSchedule:
    """Deterministic realization of a :class:`FaultConfig` over a horizon.

    All randomness is drawn once at construction from
    ``np.random.default_rng(cfg.seed)`` — two schedules built from equal
    configs are identical, which `tests/test_runtime.py` pins.
    """

    def __init__(self, cfg: FaultConfig, total_steps: int):
        self.cfg = cfg
        self.total_steps = total_steps
        rng = np.random.default_rng(cfg.seed)
        n = cfg.n_total
        if cfg.speeds:
            base = list(cfg.speeds) + [1.0] * (n - len(cfg.speeds))
            self.speeds = np.asarray(base[:n], np.float64)
        elif cfg.speed_sigma > 0:
            self.speeds = np.exp(rng.normal(0.0, cfg.speed_sigma, n))
        else:
            self.speeds = np.ones(n, np.float64)
        # straggler multiplier per (peer, step), 1.0 outside episodes
        self.mult = np.ones((n, total_steps), np.float64)
        for p in cfg.straggler_peers:
            want = int(round(cfg.straggler_frac * total_steps))
            covered = 0
            guard = 0
            while covered < want and guard < 10 * total_steps:
                guard += 1
                s = int(rng.integers(0, max(1, total_steps)))
                e = min(total_steps, s + cfg.straggler_len)
                seg = self.mult[p, s:e]
                covered += int(np.sum(seg == 1.0))
                seg[:] = cfg.straggler_factor
        self.preempt: Dict[Tuple[int, int], float] = {
            (p, s): float(pause) for p, s, pause in cfg.preemptions}
        self.fail_at: Dict[int, int] = {p: s for p, s in cfg.failures}
        self.joins: Tuple[Tuple[int, float], ...] = tuple(
            sorted(cfg.joins, key=lambda j: j[1]))

    def duration(self, peer: int, step: int) -> float:
        """Simulated seconds peer `peer` spends on its local step `step`."""
        mult = self.mult[peer, step] if step < self.total_steps else 1.0
        return float(self.speeds[peer] * mult)

    def slowdown(self, peer: int, step: int) -> float:
        """``duration`` as a dimensionless multiplier of the peer's base tick
        cost — for consumers (the serving fleet) whose per-tick cost model
        lives elsewhere. Identical to ``duration`` because the base speed is
        itself a multiple of the unit tick."""
        return self.duration(peer, step)

    def pause_after(self, peer: int, step: int) -> float:
        """Preemption pause (simulated time units) following local step
        `step` — the consumer scales it into its own clock's units."""
        return self.preempt.get((peer, step), 0.0)

    def fails_at(self, peer: int) -> Optional[int]:
        return self.fail_at.get(peer)


@dataclass
class VirtualClock:
    """Per-peer ready times over one shared simulated timeline."""
    now: float = 0.0
    ready_at: Dict[int, float] = field(default_factory=dict)

    def add_peer(self, peer: int, at: Optional[float] = None) -> None:
        self.ready_at[peer] = self.now if at is None else at

    def remove_peer(self, peer: int) -> None:
        self.ready_at.pop(peer, None)

    def next_ready(self) -> Tuple[float, Tuple[int, ...]]:
        """Advance to the earliest ready time; return it plus every peer
        ready within float tolerance of it (ties step together, which is what
        makes equal-speed clusters reproduce the synchronous schedule)."""
        if not self.ready_at:
            raise RuntimeError("no peers on the clock")
        t = min(self.ready_at.values())
        self.now = max(self.now, t)
        ready = tuple(sorted(p for p, r in self.ready_at.items()
                             if r <= t + 1e-9))
        return t, ready

    def advance(self, peer: int, by: float) -> None:
        self.ready_at[peer] = self.now + by


# ----------------------------------------------------------------------------
# CLI fault spec:  "straggler=1*4@0.2,preempt=1@3+5,fail=1@30,hetero=0.3"
# ----------------------------------------------------------------------------

def _num(text: str, kind, what: str, clause: str):
    """Parse one numeric field with an actionable error message."""
    try:
        return kind(text)
    except (TypeError, ValueError):
        raise ValueError(
            f"fault clause {clause!r}: {what} must be a"
            f"{'n integer' if kind is int else ' number'}, got {text!r}"
        ) from None


def _peer(text: str, n_peers: int, clause: str) -> int:
    p = _num(text, int, "peer index", clause)
    if p < 0:
        raise ValueError(f"fault clause {clause!r}: peer index {p} is "
                         "negative")
    if p >= n_peers:
        raise ValueError(f"fault clause {clause!r}: peer index {p} is out of "
                         f"range for n_peers={n_peers} (valid: 0.."
                         f"{n_peers - 1})")
    return p


def parse_faults(spec: str, n_peers: int, seed: int = 0) -> FaultConfig:
    """Parse the ``--faults`` flag into a :class:`FaultConfig`.

    Clauses (comma-separated; "none" or "" => no faults):
      straggler=P*F@FRAC   peer P runs F x slower for FRAC of its steps
      preempt=P@S+PAUSE    peer P pauses PAUSE sim-seconds after local step S
      fail=P@S             peer P dies permanently at local step S
      speeds=A:B:...       explicit per-peer base seconds-per-step
      hetero=SIGMA         lognormal per-peer speed jitter

    Malformed specs raise ``ValueError`` with the offending clause named:
    negative durations/steps, out-of-range or duplicated peers (overlapping
    windows on one peer), non-positive factors/speeds, unknown clause kinds.
    """
    kw: Dict = dict(n_peers=n_peers, seed=seed)
    stragglers, preempts, fails = [], [], []
    factors, fracs = [], []
    for clause in filter(None, (spec or "").split(",")):
        if clause == "none":
            continue
        key, _, val = clause.partition("=")
        if key == "straggler":
            head, _, fr = val.partition("@")
            p, _, f = head.partition("*")
            peer = _peer(p, n_peers, clause)
            if peer in stragglers:
                raise ValueError(
                    f"fault clause {clause!r}: peer {peer} already has a "
                    "straggler clause (episodes would silently overlap)")
            factor = _num(f, float, "slowdown factor", clause) if f else 4.0
            frac = _num(fr, float, "step fraction", clause) if fr else 0.2
            if factor <= 0:
                raise ValueError(f"fault clause {clause!r}: slowdown factor "
                                 f"{factor} must be > 0")
            if not 0.0 < frac <= 1.0:
                raise ValueError(f"fault clause {clause!r}: step fraction "
                                 f"{frac} must be in (0, 1]")
            stragglers.append(peer)
            factors.append(factor)
            fracs.append(frac)
        elif key == "preempt":
            p, _, rest = val.partition("@")
            s, _, pause = rest.partition("+")
            peer = _peer(p, n_peers, clause)
            step = _num(s, int, "step", clause)
            dur = _num(pause, float, "pause duration", clause) if pause else 5.0
            if step < 0:
                raise ValueError(f"fault clause {clause!r}: step {step} is "
                                 "negative")
            if dur <= 0:
                raise ValueError(f"fault clause {clause!r}: pause duration "
                                 f"{dur} must be > 0")
            if any(q == peer and t == step for q, t, _ in preempts):
                raise ValueError(
                    f"fault clause {clause!r}: peer {peer} already has a "
                    f"preemption at step {step} (overlapping windows on one "
                    "peer)")
            preempts.append((peer, step, dur))
        elif key == "fail":
            p, _, s = val.partition("@")
            peer = _peer(p, n_peers, clause)
            step = _num(s, int, "step", clause)
            if step < 0:
                raise ValueError(f"fault clause {clause!r}: step {step} is "
                                 "negative")
            if any(q == peer for q, _ in fails):
                raise ValueError(f"fault clause {clause!r}: peer {peer} "
                                 "already has a failure clause (it can only "
                                 "die once)")
            fails.append((peer, step))
        elif key == "speeds":
            speeds = tuple(_num(x, float, "speed", clause)
                           for x in val.split(":"))
            if any(sp <= 0 for sp in speeds):
                raise ValueError(f"fault clause {clause!r}: speeds must all "
                                 "be > 0")
            kw["speeds"] = speeds
        elif key == "hetero":
            sigma = _num(val, float, "sigma", clause)
            if sigma < 0:
                raise ValueError(f"fault clause {clause!r}: sigma {sigma} is "
                                 "negative")
            kw["speed_sigma"] = sigma
        else:
            raise ValueError(f"unknown fault clause {clause!r} (known: "
                             "straggler, preempt, fail, speeds, hetero)")
    # FaultConfig carries ONE global factor/frac for all straggler peers —
    # refuse conflicting per-peer values rather than silently overriding
    if len(set(factors)) > 1 or len(set(fracs)) > 1:
        raise ValueError(
            f"straggler clauses disagree on factor/frac ({factors}/{fracs}); "
            "FaultConfig supports one global straggler_factor/straggler_frac")
    return FaultConfig(straggler_peers=tuple(stragglers),
                       straggler_factor=factors[0] if factors else 4.0,
                       straggler_frac=fracs[0] if fracs else 0.2,
                       preemptions=tuple(preempts), failures=tuple(fails),
                       **kw)
