"""The distillation loss D(y, y') alone, forward and backward: CUDA kernel
wrappers + plain versions.

Where the combined kernel does not apply (a third peer's term, a
subsampled wire narrower than the logits), ``codist_loss`` takes the
distillation term of a student against one target from these kernels
(``csrc/fused_losses.cu``, modes 3 and 4). Each reads every student and
target logits element once per direction and reads no labels:

``fused_distill_loss``     -> per-token D, fp32:
      mse: D = sum_c (a - b)^2 / v_total   (every column; paper A.3)
      kl:  D = KL(softmax(b) || softmax(a)) = E - logZ_b + logZ_a,
           E = sum softmax(b) (b - a)        (five-accumulator form)
``fused_distill_kl_parts`` -> (D, logZ_a, logZ_b, E): kl with the
    residuals of its backward (the same kernel, residual rows written)
``fused_distill_mse_grad`` -> dA = g 2 (a - b) / v_total, dB = -dA
``fused_distill_kl_grad``  -> dA = g (softmax a - softmax b),
                              dB = g softmax b ((b - a) - E)

``v_total`` (default V) is the mse's denominator only, as in the
reference's ``_mse_kernel``. ``need_target_grad=False`` skips dB (a null
pointer to the kernel): ``codist_loss`` detaches the targets.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_ce import (_check_logits, _resolve_v_real,
                                          launch_bwd, launch_fwd)
from repro_torch.kernels.paged_cache import _require, _same_device

DISTILL_MODES = ("mse", "kl")


def check_pair(logits: torch.Tensor, target: torch.Tensor,
               *per_token: torch.Tensor) -> Tuple[torch.device, int, int]:
    """Validate (T, V) logits and target of one dtype and (T,) per-token
    operands; returns (device, T, V)."""
    dev = _same_device(logits, target, *per_token)
    t, v = _check_logits(logits, "logits")
    _check_logits(target, "target_logits")
    _require(target.shape == logits.shape,
             f"target {tuple(target.shape)} != logits {tuple(logits.shape)}")
    _require(target.dtype == logits.dtype,
             f"target dtype {target.dtype} != logits dtype {logits.dtype}")
    for x in per_token:
        _require(tuple(x.shape) == (t,),
                 f"per-token operand shape {tuple(x.shape)} != ({t},)")
    return dev, t, v


# ----------------------------------------------------------------------------
# plain versions (fp32 inside, the kernels' formulas)
# ----------------------------------------------------------------------------

def _kl_parts_plain(a: torch.Tensor, b: torch.Tensor):
    """fp32 (D, logZ_a, logZ_b, E) of two fp32 (T, V) logits."""
    mt = b.max(dim=-1).values
    w = torch.exp(b - mt[:, None])
    st = w.sum(dim=-1)
    e = (w * (b - a)).sum(dim=-1) / st
    logzt = mt + torch.log(st)
    logzs = torch.logsumexp(a, dim=-1)
    return e - logzt + logzs, logzs, logzt, e


def fused_distill_loss_plain(logits: torch.Tensor, target_logits: torch.Tensor,
                             mode: str = "mse", v_total: int = 0) -> torch.Tensor:
    """Plain version of ``fused_distill_loss``."""
    a, b = logits.float(), target_logits.float()
    if mode == "mse":
        d = a - b
        return (d * d).sum(dim=-1) / (v_total or logits.shape[-1])
    return _kl_parts_plain(a, b)[0]


def fused_distill_kl_parts_plain(logits: torch.Tensor,
                                 target_logits: torch.Tensor):
    """Plain version of ``fused_distill_kl_parts``."""
    return _kl_parts_plain(logits.float(), target_logits.float())


def fused_distill_mse_grad_plain(logits: torch.Tensor,
                                 target_logits: torch.Tensor, g: torch.Tensor,
                                 v_total: int = 0,
                                 need_target_grad: bool = True):
    """Plain version of ``fused_distill_mse_grad``."""
    two_inv_v = torch.tensor(2.0 / (v_total or logits.shape[-1]),
                             dtype=torch.float32, device=logits.device)
    da = g.float()[:, None] * two_inv_v * (logits.float()
                                           - target_logits.float())
    return (da.to(logits.dtype),
            (-da).to(target_logits.dtype) if need_target_grad else None)


def fused_distill_kl_grad_plain(logits: torch.Tensor,
                                target_logits: torch.Tensor,
                                logzs: torch.Tensor, logzt: torch.Tensor,
                                e: torch.Tensor, g: torch.Tensor,
                                need_target_grad: bool = True):
    """Plain version of ``fused_distill_kl_grad``."""
    a, b = logits.float(), target_logits.float()
    gg = g.float()[:, None]
    q = torch.exp(a - logzs.float()[:, None])
    p = torch.exp(b - logzt.float()[:, None])
    da = gg * (q - p)
    db = gg * p * ((b - a) - e.float()[:, None]) if need_target_grad else None
    return da.to(logits.dtype), (None if db is None
                                 else db.to(target_logits.dtype))


# ----------------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------------

def fused_distill_loss(logits: torch.Tensor, target_logits: torch.Tensor,
                       mode: str = "mse", v_total: int = 0) -> torch.Tensor:
    """Per-token D of (T, V) logits against (T, V) target logits of one
    dtype (fp32/bf16), contiguous -> (T,) fp32. Row 8 of the kernel
    table."""
    _require(mode in DISTILL_MODES, f"mode {mode!r} not in {DISTILL_MODES}")
    dev, _t, v = check_pair(logits, target_logits)
    v_total = _resolve_v_real(v_total, v)
    if dev.type == "cpu":
        return fused_distill_loss_plain(logits, target_logits, mode, v_total)
    out = launch_fwd("distill_" + mode, logits, target_logits, None, v_total)
    _build.count_launch("fused_distill_loss")
    return out[0]


def fused_distill_kl_parts(logits: torch.Tensor, target_logits: torch.Tensor):
    """kl forward with its residuals: ``(D, logZ_s, logZ_t, E)``, each (T,)
    fp32. Row 9 of the kernel table."""
    dev, _t, v = check_pair(logits, target_logits)
    if dev.type == "cpu":
        return fused_distill_kl_parts_plain(logits, target_logits)
    out = launch_fwd("distill_kl", logits, target_logits, None, v,
                     residuals=True)
    _build.count_launch("fused_distill_kl_parts")
    return out[0], out[1], out[2], out[3]


def fused_distill_mse_grad(logits: torch.Tensor, target_logits: torch.Tensor,
                           g: torch.Tensor, v_total: int = 0,
                           need_target_grad: bool = True
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dA, dB or None) in the logits' dtype for ``g * D_mse`` per token.
    Row 10 of the kernel table."""
    dev, _t, v = check_pair(logits, target_logits, g)
    v_total = _resolve_v_real(v_total, v)
    if dev.type == "cpu":
        return fused_distill_mse_grad_plain(logits, target_logits, g, v_total,
                                            need_target_grad)
    out = launch_bwd("distill_mse", logits, target_logits, None, (), (g,),
                     v_total, need_target_grad)
    _build.count_launch("fused_distill_mse_grad")
    return out


def fused_distill_kl_grad(logits: torch.Tensor, target_logits: torch.Tensor,
                          logzs: torch.Tensor, logzt: torch.Tensor,
                          e: torch.Tensor, g: torch.Tensor,
                          need_target_grad: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dA, dB or None) in the logits' dtype for ``g * D_kl`` per token, from
    the residuals of ``fused_distill_kl_parts``. Row 11 of the kernel
    table."""
    dev, _t, v = check_pair(logits, target_logits, logzs, logzt, e, g)
    if dev.type == "cpu":
        return fused_distill_kl_grad_plain(logits, target_logits, logzs,
                                           logzt, e, g, need_target_grad)
    out = launch_bwd("distill_kl", logits, target_logits, None,
                     (logzs, logzt, e), (g,), v, need_target_grad)
    _build.count_launch("fused_distill_kl_grad")
    return out
