"""Shape stand-ins for every model input and state, on ``torch.device
("meta")``: tensors with a shape and a dtype and no storage.

The reference's ``launch/specs.py`` returns ``jax.ShapeDtypeStruct`` trees
from ``jax.eval_shape``; these are their counterparts, shape for shape and
dtype for dtype: ``train_batch_specs`` (the codist split, the microbatch
axis, enc-dec frames or source tokens, the VLM patch prefix),
``prefill_batch_specs``, ``decode_token_specs``, ``cache_specs``,
``params_specs`` and ``stacked_params_specs``. The codist state keeps the
reference's stacked layout, a leading n axis on every leaf, because the
sharding rules read it (the port's training state is a list of n trees).
Nothing here allocates: ``LM.init`` / ``init_cache`` make empty leaves on
``meta``, and every kernel wrapper refuses a meta tensor.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig, torch_dtype
from repro_torch.optim import OptState
from repro_torch.train.state import CodistState, TrainState
from repro_torch.tree import tree_map

PyTree = Any
META = torch.device("meta")


def meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: InputShape, n_stack: int = 0,
                      microbatch: int = 1) -> Dict[str, torch.Tensor]:
    """Batch stand-ins for a train step.

    n_stack > 0 prepends the codist model axis (the global batch is SPLIT
    across the n models: the paper's "2-way codist with batch B a model vs
    all-reduce with 2B"); microbatch > 1 inserts a (k, B/k) gradient-
    accumulation axis after it."""
    b, s = shape.global_batch, shape.seq_len
    if n_stack:
        assert b % n_stack == 0
        b //= n_stack
    if microbatch > 1:
        assert b % microbatch == 0
        b //= microbatch
    act = torch_dtype(cfg.dtype)

    def st(*dims, dtype=torch.int32):
        if microbatch > 1:
            dims = (microbatch, *dims)
        if n_stack:
            dims = (n_stack, *dims)
        return meta(dims, dtype)

    batch: Dict[str, torch.Tensor] = {}
    if cfg.is_encdec:
        if cfg.num_audio_frames > 0:
            batch["frames"] = st(b, cfg.num_audio_frames, cfg.d_model,
                                 dtype=act)
        else:
            batch["src_tokens"] = st(b, s)
        text = s
    elif cfg.num_patches > 0:
        text = s - cfg.num_patches
        batch["patches"] = st(b, cfg.num_patches, cfg.d_model, dtype=act)
    else:
        text = s
    batch["tokens"] = st(b, text)
    batch["labels"] = st(b, text)
    batch["mask"] = st(b, text, dtype=torch.float32)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape
                        ) -> Dict[str, torch.Tensor]:
    batch = train_batch_specs(cfg, shape)
    batch.pop("labels", None)
    batch.pop("mask", None)
    return batch


def decode_token_specs(shape: InputShape) -> torch.Tensor:
    return meta((shape.global_batch, 1))


def cache_specs(model, cfg: ModelConfig, shape: InputShape,
                cache_dtype=torch.bfloat16) -> PyTree:
    """The cache of a decode step with capacity ``seq_len``."""
    return model.init_cache(shape.global_batch, shape.seq_len, cache_dtype,
                            device=META)


def params_specs(model) -> PyTree:
    return model.init(None, device=META)


def stacked_params_specs(model, n: int) -> PyTree:
    """n models' parameters stacked on a leading axis (the reference's
    ``vmap(model.init)``)."""
    return tree_map(lambda t: meta((n, *t.shape), t.dtype),
                    params_specs(model))


def optstate_specs(params: PyTree, optimizer: str = "sgdm",
                   dtype=torch.float32) -> OptState:
    """The optimizer state of ``params``: an int32 step and the moments in
    ``dtype`` (``m``; ``v`` for adamw), as the reference's ``opt_init``."""
    def zeros(t):
        return meta(t.shape, dtype)
    m = tree_map(zeros, params)
    v = tree_map(zeros, params) if optimizer == "adamw" else None
    return OptState(meta(()), m, v)


def train_state_specs(model, n_stack: int = 0, optimizer: str = "sgdm",
                      opt_dtype=torch.float32):
    """A ``TrainState`` (n_stack 0) or stacked ``CodistState`` of stand-ins,
    whose paths are the reference's state paths (``params/…``, ``opt/m/…``,
    ``step``)."""
    params = (stacked_params_specs(model, n_stack) if n_stack
              else params_specs(model))
    opt = optstate_specs(params, optimizer, opt_dtype)
    if n_stack:
        return CodistState(params, opt, meta(()), None, None)
    return TrainState(params, opt, meta(()))
