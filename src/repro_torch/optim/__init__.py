"""Optimizers with scheduled decoupled weight decay (the paper's knob)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    adamw_init,
    adamw_update,
    make_optimizer,
    sgdm_init,
    sgdm_update,
)
