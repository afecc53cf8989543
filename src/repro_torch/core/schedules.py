"""Learning-rate, weight-decay, label-smoothing and alpha schedules.

The paper's key finding (Section 4 / A.4) is that codistillation is itself a
regularizer, so the explicit regularization is decayed over training: L2
weight decay 5e-4 -> 1e-5 -> 0 at the LR milestones, label smoothing decayed
for NMT, alpha^k = alpha0 * growth^epoch.

The reference evaluates these as fp32 scalars traced into its step; the
port's step runs on the host, so each is a plain float of the integer step
(computed in double, the reference's fp32 values to within 1e-7 relative).
"""
from __future__ import annotations

import math
from typing import Sequence


def warmup_factor(step, warmup_steps: int) -> float:
    if warmup_steps <= 0:
        return 1.0
    return min(1.0, (float(step) + 1.0) / float(warmup_steps))


def stepwise_lr(step, base_lr: float, total_steps: int,
                milestones: Sequence[float] = (0.5, 0.75, 0.9),
                decay: float = 0.1, warmup_steps: int = 0) -> float:
    """Step-wise schedule of Goyal et al.; milestones are fractions of total."""
    s = float(step)
    factor = 1.0
    for m in milestones:
        factor *= decay if s >= m * total_steps else 1.0
    return base_lr * factor * warmup_factor(step, warmup_steps)


def cosine_lr(step, base_lr: float, total_steps: int, warmup_steps: int = 0,
              final_fraction: float = 0.0) -> float:
    """Half-cosine schedule (He et al., 'bag of tricks')."""
    s = float(step)
    t = min(max((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0),
            1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    lo = final_fraction
    return base_lr * (lo + (1.0 - lo) * cos) * warmup_factor(step, warmup_steps)


def make_lr_fn(kind: str, base_lr: float, total_steps: int, warmup_steps: int = 0,
               milestones: Sequence[float] = (0.5, 0.75, 0.9), decay: float = 0.1):
    if kind == "step":
        return lambda step: stepwise_lr(step, base_lr, total_steps, milestones,
                                        decay, warmup_steps)
    if kind == "cosine":
        return lambda step: cosine_lr(step, base_lr, total_steps, warmup_steps)
    if kind == "constant":
        return lambda step: base_lr * warmup_factor(step, warmup_steps)
    raise ValueError(f"unknown lr schedule {kind!r}")


def scheduled_weight_decay(step, total_steps: int,
                           values: Sequence[float] = (5e-4, 1e-5, 0.0),
                           milestones: Sequence[float] = (0.5, 0.75)) -> float:
    """Piecewise-constant weight decay keyed to LR-decay milestones: start
    at values[0]; after milestone[i] use values[i+1]."""
    if len(values) != len(milestones) + 1:
        raise ValueError(f"{len(values)} weight-decay values for "
                         f"{len(milestones)} milestones")
    s = float(step)
    wd = float(values[0])
    for m, v in zip(milestones, values[1:]):
        if s >= m * total_steps:
            wd = float(v)
    return wd


def constant_weight_decay(step, value: float = 1e-4) -> float:
    return float(value)


def decayed_label_smoothing(step, total_steps: int, initial: float = 0.1,
                            mode: str = "linear") -> float:
    """Label smoothing decayed to zero over training (Section 4.2 / A.5)."""
    t = min(max(float(step) / max(1, total_steps), 0.0), 1.0)
    if mode == "linear":
        return initial * (1.0 - t)
    if mode == "off":
        return 0.0
    raise ValueError(mode)


def alpha_schedule(step, alpha0: float = 1.0, growth: float = 1.0,
                   steps_per_epoch: int = 1, burn_in_steps: int = 0,
                   max_alpha: float = 100.0) -> float:
    """alpha^k = alpha0 * growth^epoch(k), capped at max_alpha; zero during
    burn-in (Anil et al.)."""
    s = float(step)
    if s < burn_in_steps:
        return 0.0
    epoch = math.floor(s / max(1, steps_per_epoch))
    return min(alpha0 * growth ** epoch, max_alpha)
