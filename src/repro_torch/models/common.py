"""Shared layer primitives: inits, norms, embeddings, RoPE, activations.

Parameters are plain nested dicts of tensors with the reference's tree and
layouts (``wq`` is ``(d, H, hd)``, layers stacked on a leading axis), so the
checkpoint bridge maps leaves one to one.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------------------
# initializers (same distributions as the reference's dense_init/embed_init;
# the random streams differ — parity tests share weights, never seeds)
# ----------------------------------------------------------------------------

def dense_init_(out: torch.Tensor, in_dim: int, gen: torch.Generator,
                scale: float = 1.0) -> torch.Tensor:
    """Fill ``out`` (``(in_dim, *out_shape)``) with a truncated-normal
    (+-2 sigma) fan-in init of std ``scale / sqrt(in_dim)``, drawn in fp32
    and stored in ``out``'s dtype."""
    std = scale / math.sqrt(in_dim)
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out.copy_(tmp.mul_(std))
    return out


def embed_init_(out: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    tmp.normal_(0.0, 1.0, generator=gen)
    out.copy_(tmp.mul_(0.02))
    return out


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """fp32 inside, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    if "bias" in params:
        raise NotImplementedError("layer_norm archs are not in the serving slice")
    return rms_norm(x, params["scale"], eps)


# ----------------------------------------------------------------------------
# rotary position embeddings (interleaved pairs, as the reference rotates)
# ----------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies in fp32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S). Rotates the
    interleaved pairs ``(x[..., 0::2], x[..., 1::2])``, not the halves."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    ang = positions[..., None].float() * inv          # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]                # (..., S, 1, hd/2)
    cos = torch.cos(ang)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


# ----------------------------------------------------------------------------
# embeddings / output head
# ----------------------------------------------------------------------------

def embedding_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    shapes = {"tokens": (cfg.padded_vocab, cfg.d_model)}
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.d_model, cfg.padded_vocab)
    return shapes


def embed_tokens(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return params["tokens"].to(dtype)[tokens]


def lm_head(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Logits in the activation dtype, ``padded_vocab`` wide (tied archs use
    the token table transposed)."""
    w = params["head"] if "head" in params else params["tokens"].t()
    return x @ w.to(x.dtype)


# ----------------------------------------------------------------------------
# activations
# ----------------------------------------------------------------------------

def activation(name: str):
    """The gate activation of the gated FFN (silu => SwiGLU, geglu)."""
    if name == "silu":
        return F.silu
    if name in ("gelu", "geglu"):
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)
