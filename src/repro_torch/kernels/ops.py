"""Differentiable fused-loss entry points over the loss kernels.

Drop-ins for the plain losses of ``core.codistillation``, dispatched there
by the ``fused_losses`` flag:

  * ``fused_cross_entropy_loss`` — masked, smoothed mean CE; the forward is
    ``fused_cross_entropy_parts``, the backward rebuilds softmax from the
    saved per-token ``logZ`` (``fused_cross_entropy_grad``);
  * ``fused_distill_mean`` — the masked mean distillation term D(y, y')
    alone, mse or kl (``fused_distill_loss`` / ``fused_distill_kl_parts``
    forward, ``fused_distill_mse_grad`` / ``fused_distill_kl_grad``
    backward): a third peer's term and a subsampled wire's;
  * ``fused_ce_distill`` — the task CE and the distillation term of one
    student against one target from ONE read of both logits
    (``fused_ce_distill_parts`` / ``fused_ce_distill_grad``): the hot path
    of ``--mode codist``.

Three ``torch.autograd.Function``s take the place of the reference's
``jax.custom_vjp`` primitives ``_ce_parts_p``, ``_distill_tokens_p`` and
``_ce_distill_tokens_p``.
Two forward-only entries mirror the reference's standalone kernels:
``cross_entropy_tokens`` (per-token NLL, ``fused_cross_entropy``) and
``attention`` (GQA flash attention, ``flash_attention``).
The autograd functions' boundary is per token, as there: flattening, label-smoothing mixing,
masking and the mean stay in (T,)-sized torch, so no (T, V) fp32 temporary
exists outside the kernels in either direction. The kernels take any T and
V, so nothing is padded; ``v_real`` is the logits' own width (the
reference's ``_flatten_pad`` passes ``v = logits.shape[-1]``, which counts
the config's vocab-padding columns as real).

The three differentiable entries also take DTensor logits (a peer's on
its pod's ("data", "model") mesh, or one model's on the whole (pod, data,
model) mesh, ``launch/sharding.py``; an LM's tokens or a classifier's
(B, classes) rows): every (T, V) and (T,) operand is
redistributed to the rows the logits hold (over "data"; over "pod" and
"data", pod outer, for one model over the whole mesh) with V whole (an
all-gather over "model"), and the same autograd function runs on each
rank's local rows through ``local_map`` with those placements in and out,
the kernel on the card and the plain version on the CPU. The masked means
are then DTensor sums over the whole batch, as on one device. Nothing
else passes a DTensor to a kernel wrapper, which raises on one.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.combined_loss import (fused_ce_distill_grad,
                                               fused_ce_distill_parts)
from repro_torch.kernels.distill_loss import (fused_distill_kl_grad,
                                              fused_distill_kl_parts,
                                              fused_distill_loss,
                                              fused_distill_mse_grad)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_ce import (fused_cross_entropy,
                                          fused_cross_entropy_grad,
                                          fused_cross_entropy_parts)


def fused_losses_default(device) -> bool:
    """Default for the ``fused_losses`` flag: on for CUDA (the kernels), off
    on the CPU, as the reference's is on for the TPU only."""
    return torch.device(device).type == "cuda"


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_device(x: torch.Tensor) -> torch.device:
    """The device ``x``'s values live on (a DTensor's local shard's)."""
    return x.to_local().device if is_dtensor(x) else x.device


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with a ``Partial`` placement (a sum or mean over sharded
    rows) reduced to its whole value on every rank; anything else as
    given. A scalar loss term is whole before it meets another, whose
    partial kind may differ (a masked sum against a mean)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def _row_placements(x) -> tuple:
    """The placements of the DTensor ``x``'s rows as they are (each
    ``Shard(0)`` kept: a batch's rows over "data", or over "pod" and
    "data" for one model over the whole mesh), every other mesh dim
    replicated: V whole."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) else Replicate() for p in x.placements)


# calls of the DTensor entry by the function it ran on local rows (a
# wrapper's launches there are counted in ``_build.launch_counts`` as
# anywhere else)
local_rows_calls: Dict[str, int] = {"_CEParts": 0, "_DistillTokens": 0,
                                    "_CEDistillTokens": 0,
                                    "fused_distill_loss": 0}


def _on_local_rows(name: str, fn, rows, n_out: int):
    """``fn`` (``name``'s autograd function over (T, V) / (T,) operands,
    its other arguments bound) on each rank's local rows of the DTensor
    ``rows``: each redistributed to the first's ``_row_placements`` (V
    whole), ``fn``'s
    n_out per-token outputs DTensors of the same rows."""
    from torch.distributed.tensor.experimental import local_map
    local_rows_calls[name] += 1
    mesh = rows[0].device_mesh
    for x in rows:
        if not is_dtensor(x) or x.device_mesh != mesh:
            raise TypeError("DTensor logits take DTensor targets and labels "
                            "on the same mesh")
    pl = _row_placements(rows[0])
    rows = [x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
            for x in rows]
    return local_map(fn, out_placements=(pl,) * n_out,
                     in_placements=(pl,) * len(rows), device_mesh=mesh)(*rows)


def _zeros_if_none(g: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if g is None:
        return torch.zeros_like(like, dtype=torch.float32)
    return g.float().contiguous()


class _CEParts(torch.autograd.Function):
    """(T, V) logits, (T,) labels -> per-token (nll, smooth)."""

    @staticmethod
    def forward(ctx, logits, labels, v_real):
        nll, smooth, logz = fused_cross_entropy_parts(logits, labels, v_real)
        ctx.save_for_backward(logits, labels, logz)
        ctx.v_real = v_real
        return nll, smooth

    @staticmethod
    def backward(ctx, g_nll, g_smooth):
        logits, labels, logz = ctx.saved_tensors
        dx = fused_cross_entropy_grad(
            logits, labels, logz, _zeros_if_none(g_nll, logz),
            _zeros_if_none(g_smooth, logz), ctx.v_real)
        return dx, None, None


class _DistillTokens(torch.autograd.Function):
    """(T, V) student and target logits -> per-token D. The forward is row
    8, or for kl row 9, whose residuals the backward (row 10 or 11) needs:
    the reference's primal is row 8 and its fwd rule row 9. The target's
    gradient is computed only when autograd asks for it."""

    @staticmethod
    def forward(ctx, logits, target, mode, v_total):
        ctx.mode, ctx.v_total = mode, v_total
        if mode == "mse":
            ctx.save_for_backward(logits, target)
            return fused_distill_loss(logits, target, "mse", v_total)
        loss, *residuals = fused_distill_kl_parts(logits, target)
        ctx.save_for_backward(logits, target, *residuals)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, target, *residuals = ctx.saved_tensors
        need_dt = ctx.needs_input_grad[1]
        g = g.float().contiguous()
        if ctx.mode == "mse":
            da, db = fused_distill_mse_grad(logits, target, g, ctx.v_total,
                                            need_target_grad=need_dt)
        else:
            da, db = fused_distill_kl_grad(logits, target, *residuals, g,
                                           need_target_grad=need_dt)
        return da, db, None, None


class _CEDistillTokens(torch.autograd.Function):
    """(T, V) student and target logits, (T,) labels -> per-token (nll,
    smooth, dist). The target's gradient is computed only when autograd
    asks for it; ``codist_loss`` detaches the targets, so it never does."""

    @staticmethod
    def forward(ctx, logits, target, labels, mode, v_real):
        (nll, smooth, dist), residuals = fused_ce_distill_parts(
            logits, target, labels, mode, v_real)
        ctx.save_for_backward(logits, target, labels, *residuals)
        ctx.mode, ctx.v_real = mode, v_real
        return nll, smooth, dist

    @staticmethod
    def backward(ctx, g_nll, g_smooth, g_dist):
        logits, target, labels, *residuals = ctx.saved_tensors
        like = residuals[0]
        ds, dt = fused_ce_distill_grad(
            logits, target, labels, residuals, _zeros_if_none(g_nll, like),
            _zeros_if_none(g_smooth, like), _zeros_if_none(g_dist, like),
            ctx.mode, ctx.v_real, need_target_grad=ctx.needs_input_grad[1])
        return ds, dt, None, None, None


# ----------------------------------------------------------------------------
# public entry points (scalar, masked: drop-ins for the core losses)
# ----------------------------------------------------------------------------

def _masked_mean(per_tok: torch.Tensor, mask) -> torch.Tensor:
    """``sum(loss * mask) / max(sum(mask), 1)`` with the ORIGINAL
    (unbroadcast) mask in the denominator, as the reference's losses."""
    if mask is not None:
        m_flat, m_raw = mask
        return whole((per_tok * m_flat).sum()
                     / torch.clamp(whole(m_raw.float().sum()), min=1.0))
    return whole(per_tok.mean())


def _flat_mask(mask: Optional[torch.Tensor], lead: Tuple[int, ...], t: int):
    """(broadcast-flattened fp32 mask, original mask) or None."""
    if mask is None:
        return None
    return torch.broadcast_to(mask, lead).reshape(t).float(), mask


def _flatten(logits: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    v = logits.shape[-1]
    t = math.prod(logits.shape[:-1])
    return logits.reshape(t, v).contiguous(), t, v


def distill_loss_tokens(logits: torch.Tensor, target_logits: torch.Tensor,
                        mode: str = "mse") -> torch.Tensor:
    """Per-token D over the trailing vocab dim, any leading shape (forward
    only). Nothing is padded, so the mse mean is over the logits' own
    width, as the reference's rescaled padded call gives."""
    lg, t, v = _flatten(logits)
    tg, _, _ = _flatten(target_logits)
    return fused_distill_loss(lg, tg, mode, v).reshape(logits.shape[:-1])


def _flat_labels(labels: torch.Tensor, t: int) -> torch.Tensor:
    return labels.reshape(t).to(torch.int32).contiguous()


def cross_entropy_tokens(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE (fp32) over the trailing vocab dim, any leading shape
    (forward only). Logits of another float type than fp32/bf16 are taken
    to fp32 first (exact from fp16); nothing is padded."""
    if logits.dtype not in (torch.float32, torch.bfloat16):
        logits = logits.float()
    lg, t, _v = _flatten(logits)
    return fused_cross_entropy(lg, _flat_labels(labels, t)).reshape(
        logits.shape[:-1])


# the reference's key block of ``ops.attention`` (its ops.py:121-131): it
# pads T to ``min(_BLOCK_K, max(16, T))`` and refuses a non-causal call
# that would need that padding
_BLOCK_K = 128


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA flash attention with the reference's contract: q (B, S, H, hd),
    k, v (B, T, KVh, hd) -> (B, S, H, hd) in q's dtype.

    The reference pads S and T to its blocks (its query padding changes no
    result, so the port has no query block), and asserts that a non-causal
    call needs no key padding; here that call raises ``ValueError``. The
    reference's zero key padding of a causal call is masked for every row
    below T, so it is appended here only when S > T, where rows at or past
    T see it, as there; the kernel pads nothing else."""
    tk = k.shape[1]
    bk = min(_BLOCK_K, max(16, tk))
    pad = (-tk) % bk
    if not causal and pad:
        raise ValueError(f"non-causal attention needs T % block_k == 0 "
                         f"(T={tk}, block_k={bk})")
    if pad and q.shape[1] > tk:
        zeros = k.new_zeros((k.shape[0], pad, *k.shape[2:]))
        k = torch.cat([k, zeros], dim=1)
        v = torch.cat([v, zeros], dim=1)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window)


def _smoothed(nll: torch.Tensor, smooth: torch.Tensor,
              label_smoothing) -> torch.Tensor:
    ls = torch.as_tensor(label_smoothing, dtype=torch.float32,
                         device=nll.device)
    return (1.0 - ls) * nll + ls * smooth


def fused_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                             label_smoothing=0.0,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable drop-in for ``codistillation.cross_entropy``.

    logits (..., V) float; labels (...) int; mask (...) broadcastable."""
    lg, t, v = _flatten(logits)
    lb = _flat_labels(labels, t)
    if is_dtensor(lg):
        nll, smooth = _on_local_rows(
            "_CEParts", lambda a, b: _CEParts.apply(a, b, v), (lg, lb), 2)
    else:
        nll, smooth = _CEParts.apply(lg, lb, v)
    per_tok = _smoothed(nll, smooth, label_smoothing)
    return _masked_mean(per_tok, _flat_mask(mask, logits.shape[:-1], t))


def fused_distill_mean(logits: torch.Tensor, target_logits: torch.Tensor,
                       mode: str = "mse",
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable drop-in for ``distill_mse`` / ``distill_kl``: the
    masked mean over tokens of D(logits, target_logits).

    A target of another dtype than the student is upcast, with the
    student, to the wider of the two (exact, as in ``fused_ce_distill``).
    With no gradient to take (``no_grad``, or neither operand requires
    one) the forward is row 8 alone, as the reference's primal."""
    if mode not in ("mse", "kl"):
        raise ValueError(f"fused_distill_mean mode {mode!r}: mse or kl")
    wide = torch.promote_types(logits.dtype, target_logits.dtype)
    a, t, v = _flatten(logits.to(wide))
    b, _, _ = _flatten(target_logits.to(wide))
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        name = "_DistillTokens"

        def fn(x, y):
            return _DistillTokens.apply(x, y, mode, v)
    else:
        name = "fused_distill_loss"

        def fn(x, y):
            return fused_distill_loss(x, y, mode, v)
    per_tok = (_on_local_rows(name, fn, (a, b), 1) if is_dtensor(a)
               else fn(a, b))
    return _masked_mean(per_tok, _flat_mask(mask, logits.shape[:-1], t))


def fused_ce_distill(logits: torch.Tensor, target_logits: torch.Tensor,
                     labels: torch.Tensor, mode: str = "mse",
                     label_smoothing=0.0,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(task CE, distill) scalars from one read of each logits element:
    ``(cross_entropy(logits, labels, ls, mask), distill_pair(mode, logits,
    target_logits, mask))``.

    A target of another dtype than the student (the ``bf16`` wire of an
    fp32 model) is upcast, with the student, to the wider of the two before
    the kernel: an exact conversion, so the result is the mixed-dtype
    reference's, and the gradients return in each operand's own dtype."""
    if mode not in ("mse", "kl"):
        raise ValueError(f"fused_ce_distill mode {mode!r}: mse or kl")
    wide = torch.promote_types(logits.dtype, target_logits.dtype)
    lg, t, v = _flatten(logits.to(wide))
    tg, _, _ = _flatten(target_logits.to(wide))
    lb = _flat_labels(labels, t)
    if is_dtensor(lg):
        nll, smooth, dist = _on_local_rows(
            "_CEDistillTokens",
            lambda a, b, c: _CEDistillTokens.apply(a, b, c, mode, v),
            (lg, tg, lb), 3)
    else:
        nll, smooth, dist = _CEDistillTokens.apply(lg, tg, lb, mode, v)
    m = _flat_mask(mask, logits.shape[:-1], t)
    return (_masked_mean(_smoothed(nll, smooth, label_smoothing), m),
            _masked_mean(dist, m))
