"""Train states (single model, and n codistilling peers).

The reference stacks the n peers' parameters (and optimizer moments) on a
leading axis. The port keeps them as a LIST of n per-peer trees, and the
optimizer state's ``m``/``v`` as lists of the same shape: each peer's
tensors stay separate autograd leaves, updated in place. ``step`` is a
Python int (the host drives every step).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

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
    ``opt.m`` / ``opt.v`` lists of n trees.

    ``stale`` (checkpoint mode): the peers' parameters as of the last
    exchange, a list of n detached trees. ``peer`` (pipelined mode): the
    previous exchange's batch and logits (``init_peer_state``)."""
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


def snapshot_params(params: PyTree) -> PyTree:
    """Detached copies of every leaf (the checkpoint exchange's replicas)."""
    return tree_map(lambda p: p.detach().clone(), params)


def init_codist_state(model, generator: torch.Generator, n: int, opt_init,
                      device="cuda", with_stale: bool = False) -> CodistState:
    params = trainable_params(init_stacked(model.init, generator, n,
                                           device=device))
    stale = snapshot_params(params) if with_stale else None
    return CodistState(params, opt_init(params), 0, stale, None)


def init_peer_state(batch_all: Dict, logits_shape: Tuple[int, ...]) -> Dict:
    """Pipelined-prediction peer buffer: the previous batch (zeros) and
    logits (fp32 zeros, as the reference's), invalid until the first
    exchange (``valid`` gates the distillation weight)."""
    dev = batch_all["labels"].device
    return {"batch": {k: torch.zeros_like(v) for k, v in batch_all.items()},
            "logits": torch.zeros(logits_shape, dtype=torch.float32,
                                  device=dev),
            "valid": False}
