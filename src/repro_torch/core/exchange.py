"""Host-side step scheduling for the exchange mechanisms.

``StepPlan`` is what ``ExchangeStrategy.plan(step)`` returns: which step
variant runs and whether communication happens this step (Section 3's
"only periodically communicate predictions, and omit the distillation term
otherwise"). The reference's logic, verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import CodistConfig


@dataclass(frozen=True)
class StepPlan:
    """Host-side plan for step k."""
    distill: bool    # include the distillation term this step
    exchange: bool   # communication happens this step

    @staticmethod
    def for_step(cfg: CodistConfig, step: int) -> "StepPlan":
        if cfg.n_models < 2:
            return StepPlan(False, False)
        if step < cfg.burn_in_steps:
            return StepPlan(False, False)
        on = (step % cfg.period) == 0
        if cfg.mode == "checkpoints":
            # distill EVERY step against the stale replicas; exchange every T
            return StepPlan(True, on)
        # predictions: distill only on exchange steps (Section 3)
        return StepPlan(on, on)
