"""Train states (single model, and n codistilling peers).

The reference stacks the n peers' parameters (and optimizer moments) on a
leading axis. The port keeps them as a LIST of n per-peer trees, and the
optimizer state's ``m``/``v`` as lists of the same shape: each peer's
tensors stay separate autograd leaves, updated in place. ``step`` is a
Python int (the host drives every step).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.codistillation import init_stacked
from repro_torch.optim import OptState
from repro_torch.tree import tree_map

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt: OptState
    step: int


class CodistState(NamedTuple):
    """State of n codistilling peers: ``params`` is a list of n trees and
    ``opt.m`` / ``opt.v`` lists of n trees. ``stale`` (checkpoint mode) and
    ``peer`` (pipelined mode) belong to strategies of a later slice and
    stay None here."""
    params: PyTree
    opt: OptState
    step: int
    stale: Optional[PyTree] = None
    peer: Optional[PyTree] = None


def trainable_params(params: PyTree) -> PyTree:
    """Mark every floating leaf as an autograd leaf (in place)."""
    def leaf(p):
        if p.is_floating_point():
            p.requires_grad_(True)
        return p
    return tree_map(leaf, params)


def init_train_state(model, generator: torch.Generator, opt_init,
                     device="cuda") -> TrainState:
    params = trainable_params(model.init(generator, device=device))
    return TrainState(params, opt_init(params), 0)


def init_codist_state(model, generator: torch.Generator, n: int, opt_init,
                      device="cuda") -> CodistState:
    params = trainable_params(init_stacked(model.init, generator, n,
                                           device=device))
    return CodistState(params, opt_init(params), 0, None, None)
