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
    if out.is_meta:
        return out
    std = scale / math.sqrt(in_dim)
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out.copy_(tmp.mul_(std))
    return out


def stacked_draw(n: int, shape, draw, generator: torch.Generator,
                 dtype: torch.dtype, device,
                 batch_dims: int = 0) -> torch.Tensor:
    """n slices of ``shape`` stacked on a leading axis, each filled by
    ``draw(tmp, generator)`` on an fp32 buffer and cast on store, so a bf16
    init never holds an fp32 copy of the whole stack. ``batch_dims``
    leading dims of ``shape`` are drawn slice by slice too (an expert stack
    ``(E, d, f)``: one matrix at a time)."""
    t = torch.empty((n, *shape), dtype=dtype, device=device)
    if t.is_meta:              # shape stand-ins: nothing to draw
        return t
    inner = tuple(shape[batch_dims:])
    for sl in t.reshape(-1, *inner):
        tmp = torch.empty(inner, dtype=torch.float32, device=device)
        sl.copy_(draw(tmp, generator))
    return t


def stacked_dense(n: int, shape, in_dim: int, generator: torch.Generator,
                  dtype: torch.dtype, device, scale: float = 1.0,
                  batch_dims: int = 0) -> torch.Tensor:
    """n fan-in inits of ``shape`` (``dense_init_``'s distribution) through
    ``stacked_draw``."""
    std = scale / math.sqrt(in_dim)

    def draw(tmp, g):
        return torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                           generator=g).mul_(std)
    return stacked_draw(n, shape, draw, generator, dtype, device, batch_dims)


def stacked_const(n: int, shape, value: float, dtype: torch.dtype,
                  device) -> torch.Tensor:
    return torch.full((n, *shape), value, dtype=dtype, device=device)


def embed_init_(out: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    if out.is_meta:
        return out
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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 inside (mean, biased variance), cast back to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def init_layer_norm(d: int, dtype=torch.float32, device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Scale 1 and bias 0: the tree whose ``bias`` makes ``apply_norm``
    take layer norm."""
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm when the parameters hold a ``bias``, else RMS norm."""
    if "bias" in params:
        return layer_norm(x, params["scale"], params["bias"], eps)
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
    """The rows of the token table, in ``dtype``. A DTensor table (a peer
    on its pod's mesh) is gathered whole, as FSDP gathers a weight before
    its use, and each rank reads the rows of its own tokens; the table's
    gradient is then a sum over the ranks that split the tokens."""
    table = params["tokens"].to(dtype)
    if type(table) is torch.Tensor or not hasattr(table, "device_mesh"):
        return table[tokens]
    return _embed_local(table, tokens)


def whole_weight(w, placements=None):
    """A DTensor weight in ``placements`` (default: replicated on every
    mesh dim) for a read on each rank (``_Gathered``), or a plain one as
    given."""
    if type(w) is torch.Tensor or not hasattr(w, "device_mesh"):
        return w
    from torch.distributed.tensor import Replicate
    want = tuple(placements or (Replicate(),) * w.device_mesh.ndim)
    return w if tuple(w.placements) == want else _Gathered.apply(w, want)


def on_local_rows(fn, x, *weights):
    """``fn(x, *weights)`` on each rank's own batch rows of the DTensor
    ``x``, every weight whole (``whole_weight``), through ``local_map``:
    the rows stay split as ``x``'s batch dim is, every other dim of ``x``
    and of the result is whole; a weight's gradient is a ``Partial`` sum
    over the mesh dims that split the rows, placed by the optimizer."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in x.placements)
    w_grad = tuple(Partial() if p == Shard(0) else Replicate() for p in rows)
    whole = (Replicate(),) * mesh.ndim
    if tuple(x.placements) != rows:
        x = x.redistribute(mesh, rows)
    n = len(weights)
    return local_map(fn, out_placements=(rows,),
                     in_placements=(rows,) + (whole,) * n,
                     in_grad_placements=(rows,) + (w_grad,) * n,
                     device_mesh=mesh)(x, *(whole_weight(w) for w in weights))


class _Gathered(torch.autograd.Function):
    """A DTensor weight gathered to ``placements`` for a read on each rank
    (as FSDP gathers a weight before its use). Its gradient goes back to
    the weight's placements on every mesh dim but "pod": a sum over the
    pods (the all-reduce baseline's rows span them) stays ``Partial``
    there, and the optimizer reduces it over "pod" with every other
    gradient (``optim/optimizers.py`` ``placed_grad``)."""

    @staticmethod
    def forward(ctx, w, placements):
        ctx.placements = tuple(w.placements)
        return w.redistribute(w.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        mesh = g.device_mesh
        want = tuple(gp if name == "pod" and gp.is_partial() else wp
                     for name, gp, wp in zip(mesh.mesh_dim_names,
                                             g.placements, ctx.placements))
        return (g if tuple(g.placements) == want
                else g.redistribute(mesh, want)), None


def _embed_local(table, tokens: torch.Tensor):
    """``table[tokens]`` for a DTensor ``table`` through ``local_map``:
    the table replicated (``whole_weight``), ``tokens`` (a DTensor, or a plain
    tensor taken as replicated) read on each rank, the rows placed as the
    tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    tok = tuple(tokens.placements)
    if any(p.is_partial() for p in tok):
        raise ValueError(f"token ids placed as {tok}")
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in tok)
    return local_map(lambda t, i: t[i], out_placements=(tok,),
                     in_placements=(rep, tok), in_grad_placements=(grad, tok),
                     device_mesh=mesh)(whole_weight(table), tokens)


def lm_head(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Logits in the activation dtype, ``padded_vocab`` wide (tied archs use
    the token table transposed)."""
    from repro_torch.models.sharding_hints import hint
    w = params["head"] if "head" in params else params["tokens"].t()
    return hint(x @ w.to(x.dtype), "btv")


# ----------------------------------------------------------------------------
# activations
# ----------------------------------------------------------------------------

def activation(name: str):
    """The FFN activation: silu (SwiGLU's gate) or gelu / geglu."""
    if name == "silu":
        return F.silu
    if name in ("gelu", "geglu"):
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)
