"""Combined task CE + distillation, forward and backward: CUDA kernel
wrappers + plain versions.

The codistillation hot path (Algorithm 1, prediction exchange) needs both
the task cross-entropy and the distillation term D(y, sg(y')) of the same
student logits every step. These kernels (``csrc/fused_losses.cu``, modes
1 and 2) read each student and target logits element once per direction:

``fused_ce_distill_parts``  -> per-token ``(nll, smooth, dist)`` and the
    residuals ``(logZ_s,)`` for mse, ``(logZ_s, logZ_t, E)`` for kl, with
      mse: dist = sum_{c < v_real} (x - t)^2 / v_real   (paper A.3)
      kl:  dist = KL(softmax(t) || softmax(x)) = E - logZ_t + logZ_s,
           E = sum softmax(t) (t - x)
``fused_ce_distill_grad``   -> (dstudent, dtarget) in the logits' dtype:
      ds = CE term + g_dist * (mse: 2 (x - t)[c < v_real] / v_real | kl: q - p)
      dt = g_dist * (mse: -2 (x - t)[c < v_real] / v_real | kl: p ((t - x) - E))
    ``need_target_grad=False`` skips dt (a null pointer to the kernel):
    ``codist_loss`` detaches the targets, so the main path never writes it.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_ce import (ce_grad_term, check_inputs,
                                          fused_cross_entropy_parts_plain,
                                          launch_bwd, launch_fwd)
from repro_torch.kernels.paged_cache import _require, _same_device

DISTILL_MODES = ("mse", "kl")
N_RESIDUALS = {"mse": 1, "kl": 3}


def _check_mode(mode: str) -> None:
    _require(mode in DISTILL_MODES, f"mode {mode!r} not in {DISTILL_MODES}")


def fused_ce_distill_parts_plain(logits: torch.Tensor,
                                 target_logits: torch.Tensor,
                                 labels: torch.Tensor, mode: str = "mse",
                                 v_real: int = 0):
    """Plain version of ``fused_ce_distill_parts``."""
    v_real = v_real or logits.shape[-1]
    nll, smooth, logzs = fused_cross_entropy_parts_plain(logits, labels, v_real)
    x, t = logits.float(), target_logits.float()
    if mode == "mse":
        d = x[:, :v_real] - t[:, :v_real]
        return (nll, smooth, (d * d).sum(dim=-1) / v_real), (logzs,)
    mt = t.max(dim=-1).values
    w = torch.exp(t - mt[:, None])
    st = w.sum(dim=-1)
    e = (w * (t - x)).sum(dim=-1) / st
    logzt = mt + torch.log(st)
    return (nll, smooth, e - logzt + logzs), (logzs, logzt, e)


def fused_ce_distill_grad_plain(logits: torch.Tensor,
                                target_logits: torch.Tensor,
                                labels: torch.Tensor,
                                residuals: Sequence[torch.Tensor],
                                g_nll: torch.Tensor, g_smooth: torch.Tensor,
                                g_dist: torch.Tensor, mode: str = "mse",
                                v_real: int = 0,
                                need_target_grad: bool = True):
    """Plain version of ``fused_ce_distill_grad``."""
    v_real = v_real or logits.shape[-1]
    x, t = logits.float(), target_logits.float()
    gd = g_dist.float()[:, None]
    ds, q = ce_grad_term(x, labels, residuals[0].float(), g_nll.float(),
                         g_smooth.float(), v_real)
    if mode == "mse":
        d = torch.zeros_like(x)
        d[:, :v_real] = x[:, :v_real] - t[:, :v_real]
        two_inv_v = torch.tensor(2.0 / v_real, dtype=torch.float32,
                                 device=x.device)
        dd = gd * two_inv_v * d
        ds = ds + dd
        dt = -dd
    else:
        logzt, e = residuals[1].float(), residuals[2].float()
        p = torch.exp(t - logzt[:, None])
        ds = ds + gd * (q - p)
        dt = gd * p * ((t - x) - e[:, None])
    return (ds.to(logits.dtype),
            dt.to(target_logits.dtype) if need_target_grad else None)


def fused_ce_distill_parts(logits: torch.Tensor, target_logits: torch.Tensor,
                           labels: torch.Tensor, mode: str = "mse",
                           v_real: int = 0):
    """One-sweep CE + distill forward. logits, target_logits (T, V) of one
    dtype (fp32/bf16), contiguous; labels (T,) int32. Returns
    ``(nll, smooth, dist), residuals`` as fp32 (T,) tensors."""
    _check_mode(mode)
    dev, _t, _v, v_real = check_inputs(logits, labels, target_logits, v_real)
    if _build.runs_plain(dev):
        return fused_ce_distill_parts_plain(logits, target_logits, labels,
                                            mode, v_real)
    out = launch_fwd(mode, logits, target_logits, labels, v_real)
    _build.count_launch("fused_ce_distill_parts")
    return (out[0], out[1], out[2]), tuple(out[3:])


def fused_ce_distill_grad(logits: torch.Tensor, target_logits: torch.Tensor,
                          labels: torch.Tensor,
                          residuals: Sequence[torch.Tensor],
                          g_nll: torch.Tensor, g_smooth: torch.Tensor,
                          g_dist: torch.Tensor, mode: str = "mse",
                          v_real: int = 0, need_target_grad: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dlogits, dtarget or None) for ``g_nll * nll + g_smooth * smooth +
    g_dist * dist`` per token, one read of each logits element."""
    _check_mode(mode)
    dev, t, _v, v_real = check_inputs(logits, labels, target_logits, v_real)
    _require(len(residuals) == N_RESIDUALS[mode],
             f"{mode} takes {N_RESIDUALS[mode]} residuals, got {len(residuals)}")
    _same_device(logits, *residuals, g_nll, g_smooth, g_dist)
    for x in (*residuals, g_nll, g_smooth, g_dist):
        _require(tuple(x.shape) == (t,),
                 f"per-token operand shape {tuple(x.shape)} != ({t},)")
    if _build.runs_plain(dev):
        return fused_ce_distill_grad_plain(
            logits, target_logits, labels, residuals, g_nll, g_smooth, g_dist,
            mode, v_real, need_target_grad)
    out = launch_bwd(mode, logits, target_logits, labels, residuals,
                     (g_nll, g_smooth, g_dist), v_real, need_target_grad)
    _build.count_launch("fused_ce_distill_grad")
    return out
