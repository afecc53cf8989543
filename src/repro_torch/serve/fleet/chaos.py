"""Seeded fault injection + router defenses for the serving fleet.

The paper's resilience claim (weak synchronization tolerates replica
failure — Anil et al. arXiv:1804.03235; straggler analysis of Chen et al.
arXiv:1604.00981) was demonstrated for *training* by the async runtime's
fault schedule. This module extends the SAME seeded machinery
(:class:`repro.runtime.clock.FaultSchedule`) to serving: a fault-schedule
"step" becomes a decode tick, and a "duration" a multiple of the engine's
deterministic per-tick cost, so one ``--faults`` spec drives both worlds.

Fault model (applied inside ``FleetEngine.step`` when a schedule is
attached):

  * **straggler episodes** — the whole tick cost is multiplied by
    ``FaultSchedule.slowdown(peer, tick)`` (base speed x episode factor);
  * **preemption** — after the tick named in the schedule the peer goes
    offline for ``pause x unit_ms`` simulated ms: its clock jumps past the
    pause and in-flight slots are frozen (no decode progress, KV intact);
  * **permanent failure** — the peer dies at the start of the scheduled
    tick; its KV state is lost. With ``recover_after_ms`` set, the router
    revives it from its ``checkpoint/io.py`` snapshot (or, absent one, its
    last adopted in-memory weights — a warm spare).

Defenses (:class:`FleetDefense`, applied by ``FleetRouter``):

  * **health tracking** — per-peer EWMA of the observed/clean tick-cost
    ratio; a peer whose EWMA exceeds ``unhealthy_factor`` stops receiving
    new work until it recovers (routing falls back to unhealthy-but-alive
    peers only when nothing better exists);
  * **migration** — admitted-but-unfinished requests on a dead peer (or one
    preempted for longer than ``migrate_pause_over_ms``) are re-prefilled on
    a healthy peer as a *continuation*: already-emitted tokens become prompt
    context, so the client stream has at-most-once token emission — no
    duplicates, no gaps. Placement failures retry with exponential backoff
    up to ``max_migrations`` attempts;
  * **hedged dispatch** — the slowest-decile requests (by prompt+output
    size) run on two peers; the first complete response answers the client
    and the other copy is cancelled (whole-response hedging: nothing is
    delivered until a copy completes, so cancellation never rewinds the
    client stream);
  * **degraded admission** — queue bounds scale with the fraction of
    available peers, so a shrunken fleet sheds at the edge instead of
    accepting latency it cannot serve.

Everything is a pure function of (configs, seed): chaos runs are replayable
bit-for-bit, which the ``serve-chaos-smoke`` CI job and the
``benchmarks/serving_chaos.py`` rows pin.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.runtime.clock import FaultConfig, FaultSchedule


@dataclass(frozen=True)
class ChaosConfig:
    """Fault injection for one fleet run.

    ``faults`` is the runtime's own config (so ``parse_faults`` specs work
    unchanged); ``unit_ms`` converts its unit-less pause durations into
    simulated milliseconds (1.0 => spec pauses are written in ms).
    """
    faults: FaultConfig
    horizon_ticks: int = 4096        # fault-schedule realization horizon
    unit_ms: float = 1.0             # sim-ms per fault-schedule time unit
    recover_after_ms: float = 0.0    # 0 = dead peers stay dead

    def __post_init__(self):
        if self.horizon_ticks <= 0:
            raise ValueError(f"horizon_ticks={self.horizon_ticks} must be >0")
        if self.unit_ms <= 0:
            raise ValueError(f"unit_ms={self.unit_ms} must be > 0")
        if self.recover_after_ms < 0:
            raise ValueError(
                f"recover_after_ms={self.recover_after_ms} is negative")


class ChaosSchedule:
    """Deterministic realization of a :class:`ChaosConfig` in fleet units
    (ticks and simulated ms). Thin adapter over ``FaultSchedule`` — all
    randomness is the schedule's, drawn once from ``faults.seed``."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.sched = FaultSchedule(cfg.faults, cfg.horizon_ticks)

    def slowdown(self, peer: int, tick: int) -> float:
        """Multiplier on the peer's full tick cost (>= its base speed)."""
        return self.sched.slowdown(peer, tick)

    def pause_ms(self, peer: int, tick: int) -> float:
        """Preemption pause in simulated ms after local tick ``tick``."""
        return self.sched.pause_after(peer, tick) * self.cfg.unit_ms

    def fails_at(self, peer: int) -> Optional[int]:
        """Tick at which the peer dies permanently (None = never)."""
        return self.sched.fails_at(peer)

    def describe(self, peer: int, tick: int) -> Dict:
        """Deterministic snapshot of the fault state one peer sees at one
        tick — the Watchtower's postmortem bundles embed this so a dumped
        alert names the injected cause next to the observed symptom."""
        fails = self.fails_at(peer)
        return {
            "peer": peer,
            "tick": tick,
            "slowdown": self.slowdown(peer, tick),
            "pause_ms": self.pause_ms(peer, tick),
            "fails_at_tick": fails if fails is not None else -1,
        }


@dataclass(frozen=True)
class FleetDefense:
    """Router-side chaos defenses. Constructing one and passing it to
    ``FleetRouter`` turns the defenses on; ``None`` is the undefended
    baseline the chaos benchmark compares against."""
    # health: EWMA of observed/clean tick-cost ratio per peer
    health_alpha: float = 0.25
    unhealthy_factor: float = 2.0    # EWMA above this => route around
    # migration of admitted-but-unfinished work off dead/preempted peers
    migration: bool = True
    migrate_pause_over_ms: float = 10.0   # preemption timeout threshold
    retry_backoff_ms: float = 5.0         # base for exponential backoff
    max_migrations: int = 3               # attempts per logical request
    # hedged dispatch of the slowest-decile requests
    hedging: bool = False
    hedge_quantile: float = 0.9
    hedge_min_samples: int = 8            # sizes seen before hedging starts
    # admission control under reduced capacity
    degraded_admission: bool = True
    # drain-phase maintenance cadence (simulated ms between router sweeps)
    maintenance_quantum_ms: float = 20.0

    def __post_init__(self):
        if not 0.0 < self.health_alpha <= 1.0:
            raise ValueError(f"health_alpha={self.health_alpha} "
                             "must be in (0, 1]")
        if self.unhealthy_factor <= 1.0:
            raise ValueError(f"unhealthy_factor={self.unhealthy_factor} must "
                             "be > 1 (1.0 would flag healthy peers)")
        if not 0.0 < self.hedge_quantile < 1.0:
            raise ValueError(f"hedge_quantile={self.hedge_quantile} "
                             "must be in (0, 1)")
        if self.retry_backoff_ms <= 0 or self.maintenance_quantum_ms <= 0:
            raise ValueError("retry_backoff_ms and maintenance_quantum_ms "
                             "must be > 0")


@dataclass
class PeerHealth:
    """EWMA of a peer's observed tick cost relative to the clean cost model.

    1.0 = nominal; a straggler episode at factor F drives it toward F within
    ``~1/alpha`` ticks, and it decays back once the episode ends — that lag
    is the detector's (deterministic) reaction time.
    """
    alpha: float = 0.25
    ewma: float = 1.0
    ticks: int = 0

    def observe(self, ratio: float) -> None:
        self.ewma = (1.0 - self.alpha) * self.ewma + self.alpha * ratio
        self.ticks += 1

    def healthy(self, unhealthy_factor: float) -> bool:
        return self.ewma <= unhealthy_factor


@dataclass
class ChaosStats:
    """Router-side chaos accounting (all deterministic counters)."""
    migrations: int = 0              # continuations successfully placed
    migration_failures: int = 0      # gave up after max_migrations
    hedges: int = 0                  # requests dispatched to two peers
    hedge_wins: int = 0              # hedge copy answered the client
    peers_died: int = 0
    peers_recovered: int = 0

    def to_dict(self) -> Dict:
        """One serialization path, shared with ``FleetReport.to_dict`` —
        the CLI report, bench rows, and metrics export all read this."""
        return dict(self.__dict__)

    def summary(self) -> Dict:
        return self.to_dict()


@dataclass
class _HedgePair:
    """One hedged request: the client-facing record + its shadow copy."""
    rec: object                      # primary RequestRecord (in _primaries)
    hrec: object                     # hedge RequestRecord
    ppeer: int
    hpeer: int
    palive: bool = True              # copy still placed on a live peer
    halive: bool = True


@dataclass
class _Orphan:
    """A logical request awaiting (re-)placement after its peer failed."""
    rec: object                      # logical RequestRecord
    next_attempt_ms: float = 0.0
