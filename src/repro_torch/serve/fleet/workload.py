"""Seeded open-loop request generator: Poisson arrivals over scenario rate
curves, mixed prompt/output-length distributions.

Open-loop means arrivals do not wait for completions (the production regime
that stresses admission control); everything is driven by one
``np.random.Generator(PCG64(seed))`` so a (scenario, seed, n) triple always
yields the byte-identical request list — the determinism the CI serve-smoke
and the fleet benchmark rows gate on. Time-varying rates (bursty / diurnal)
are sampled by Lewis-Shedler thinning against the scenario's peak rate, which
stays exact and replayable for any bounded rate curve.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    """One generation request (tokens are sampled per-request from the seeded
    stream, so the workload is self-contained — no dataset dependency)."""
    rid: int
    arrival_ms: float
    prompt: Tuple[int, ...]     # prompt token ids
    max_new: int

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_tokens(self) -> int:
        """Worst-case context (prompt + full output) — the slot reservation
        size, and the 'work size' the hedging policy ranks requests by."""
        return self.prompt_len + self.max_new

    def continuation(self, emitted: Tuple[int, ...], at_ms: float) -> "Request":
        """The request that resumes THIS one on another peer after migration:
        already-emitted output tokens become prompt context (they were
        already delivered to the client — at-most-once emission), and only
        the remainder of the output budget is decoded. Same ``rid``: the
        client sees one logical request."""
        assert len(emitted) < self.max_new, (self.rid, len(emitted))
        return Request(self.rid, at_ms, self.prompt + tuple(emitted),
                       self.max_new - len(emitted))


@dataclass(frozen=True)
class LengthMix:
    """Discrete mixture over [lo, hi] ranges (uniform within a range)."""
    ranges: Tuple[Tuple[int, int], ...]
    weights: Tuple[float, ...]

    def sample(self, rng: np.random.Generator) -> int:
        i = int(rng.choice(len(self.ranges), p=np.asarray(self.weights)
                           / sum(self.weights)))
        lo, hi = self.ranges[i]
        return int(rng.integers(lo, hi + 1))


@dataclass(frozen=True)
class Scenario:
    """Arrival-rate curve + length mixes. ``rate_rps(t_s)`` must be bounded
    by ``peak_rps`` (thinning envelope)."""
    name: str
    peak_rps: float
    rate_fn: Callable[[float], float]        # simulated seconds -> req/s
    prompt_mix: LengthMix
    output_mix: LengthMix
    description: str = ""


def _steady(rps: float) -> Callable[[float], float]:
    return lambda t: rps


def _bursty(base: float, burst: float, period_s: float,
            duty: float) -> Callable[[float], float]:
    """On/off bursts: ``burst`` rps for the first ``duty`` fraction of each
    period, ``base`` rps otherwise."""
    def rate(t: float) -> float:
        return burst if (t % period_s) < duty * period_s else base
    return rate


def _diurnal(base: float, amp: float, period_s: float) -> Callable[[float], float]:
    """Sinusoidal day curve: base * (1 + amp * sin)."""
    def rate(t: float) -> float:
        return base * (1.0 + amp * math.sin(2.0 * math.pi * t / period_s))
    return rate


_SHORT_PROMPTS = LengthMix(((4, 12), (16, 28)), (0.7, 0.3))
_MIXED_PROMPTS = LengthMix(((4, 10), (12, 24), (28, 40)), (0.5, 0.35, 0.15))
_SHORT_OUT = LengthMix(((2, 6), (8, 12)), (0.6, 0.4))
_MIXED_OUT = LengthMix(((2, 5), (6, 14)), (0.5, 0.5))

# the scenario catalog (docs/serving.md): reduced-model scale — lengths are
# tokens into the reduced-config caches, rates are simulated req/s
SCENARIOS: Dict[str, Scenario] = {
    "steady": Scenario(
        "steady", peak_rps=40.0, rate_fn=_steady(40.0),
        prompt_mix=_SHORT_PROMPTS, output_mix=_SHORT_OUT,
        description="constant-rate Poisson arrivals, short chat shapes"),
    "bursty": Scenario(
        "bursty", peak_rps=120.0, rate_fn=_bursty(10.0, 120.0, 2.0, 0.25),
        prompt_mix=_MIXED_PROMPTS, output_mix=_MIXED_OUT,
        description="12x on/off bursts every 2s (queueing + admission "
                    "control stress)"),
    "diurnal": Scenario(
        "diurnal", peak_rps=80.0, rate_fn=_diurnal(40.0, 0.9, 8.0),
        prompt_mix=_MIXED_PROMPTS, output_mix=_SHORT_OUT,
        description="sinusoidal day curve (slow swing between near-idle "
                    "and ~2x mean load)"),
}


@dataclass
class Workload:
    scenario: str
    seed: int
    requests: List[Request] = field(default_factory=list)

    @property
    def total_prompt_tokens(self) -> int:
        return sum(r.prompt_len for r in self.requests)

    @property
    def total_output_tokens(self) -> int:
        return sum(r.max_new for r in self.requests)


def generate_workload(scenario: str, n_requests: int, vocab: int,
                      seed: int = 0,
                      max_prompt: Optional[int] = None,
                      max_new: Optional[int] = None) -> Workload:
    """Draw ``n_requests`` from the scenario's arrival process.

    ``max_prompt`` / ``max_new`` clamp lengths (the fleet's slot capacity is
    finite); clamping is part of the seeded stream, so it is deterministic.
    """
    if scenario not in SCENARIOS:
        raise KeyError(f"unknown scenario {scenario!r}; "
                       f"known: {', '.join(SCENARIOS)}")
    sc = SCENARIOS[scenario]
    rng = np.random.default_rng(np.random.PCG64(seed))
    out = Workload(scenario, seed)
    t = 0.0  # simulated seconds
    for rid in range(n_requests):
        # Lewis-Shedler thinning against the peak-rate envelope
        while True:
            t += rng.exponential(1.0 / sc.peak_rps)
            if rng.uniform() * sc.peak_rps <= sc.rate_fn(t):
                break
        p_len = sc.prompt_mix.sample(rng)
        o_len = sc.output_mix.sample(rng)
        if max_prompt is not None:
            p_len = min(p_len, max_prompt)
        if max_new is not None:
            o_len = min(o_len, max_new)
        prompt = tuple(int(x) for x in rng.integers(0, vocab, size=p_len))
        out.requests.append(Request(rid, t * 1e3, prompt, max(1, o_len)))
    return out
