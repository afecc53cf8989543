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

The forward splits each row over a cluster of CTAs when the rows are few
(the serving canary's one, a subsampled wire's hundreds):
``distill_fwd_split_plan`` picks (vectors per split, splits) from the
shapes alone, each CTA keeps the fp32 online state of its run of columns
(``fwd_run_columns``) and the first folds the others in rank order.
``distill_split_merge_plain`` models that merge on the CPU for the tests.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_ce import (  # noqa: F401
    NEG, _check_logits, _resolve_v_real, distill_fwd_split_plan, fwd_runs,
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


def fwd_run_columns(v: int, itemsize: int, head: int, vps: int, splits: int,
                    vec: bool = True) -> List[List[Tuple[int, int]]]:
    """The column ranges [lo, hi) each CTA of a row's cluster streams, in
    rank order, as the forward kernel cuts a row of ``v`` elements of
    ``itemsize`` bytes whose first 16-byte boundary falls ``head`` columns
    in: rank r takes vectors [r vps, (r + 1) vps) after the head (the last
    rank up to the row's last whole vector), rank 0 also the head and the
    last rank the scalar tail. Off the vector path (``vec`` False: operands
    at different offsets from a 16-byte boundary) the row is all scalar and
    rank r takes columns [r vps n, (r + 1) vps n), the last rank to ``v``."""
    n = 16 // itemsize
    runs = []
    for r in range(splits):
        last = r == splits - 1
        if vec:
            h = min(v, head)
            nvec = (v - h) // n
            k0 = min(r * vps, nvec)
            k1 = nvec if last else min(k0 + vps, nvec)
            ranges = [(0, h)] if r == 0 else []
            ranges.append((h + k0 * n, h + k1 * n))
            if last:
                ranges.append((h + nvec * n, v))
        else:
            c0 = min(r * vps * n, v)
            ranges = [(c0, v if last else min(c0 + vps * n, v))]
        runs.append([(lo, hi) for lo, hi in ranges if hi > lo])
    return runs


def distill_split_merge_plain(logits: torch.Tensor,
                              target_logits: torch.Tensor, mode: str,
                              plan: Tuple[int, int], head: int = 0,
                              vec: bool = True, v_total: int = 0):
    """A model of the split forward, for the tests: the fp32 state (m, s,
    acc, mt, st, u) of each run of ``fwd_run_columns`` (its columns in one
    block; the kernel's threads sum in other orders), folded in rank order
    with the kernel's merge (both sides rescaled to the larger max).
    Returns D (mse) or (D, logZ_a, logZ_b, E) (kl)."""
    a_all, b_all = logits.float(), target_logits.float()
    t, v = a_all.shape
    fill = lambda x: torch.full((t,), x, dtype=torch.float32)
    m, s, acc, mt, st, u = fill(NEG), fill(0.0), fill(0.0), fill(NEG), \
        fill(0.0), fill(0.0)
    for ranges in fwd_run_columns(v, logits.element_size(), head, *plan,
                                  vec=vec):
        cols = torch.cat([torch.arange(lo, hi) for lo, hi in ranges])
        a, b = a_all[:, cols], b_all[:, cols]
        d = a - b
        acc = acc + (d * d).sum(dim=-1)
        rm = a.max(dim=-1).values
        rs = torch.exp(a - rm[:, None]).sum(dim=-1)
        rmt = b.max(dim=-1).values
        w = torch.exp(b - rmt[:, None])
        rst, ru = w.sum(dim=-1), (w * (b - a)).sum(dim=-1)
        big = torch.maximum(m, rm)
        s = s * torch.exp(m - big) + rs * torch.exp(rm - big)
        m = big
        big = torch.maximum(mt, rmt)
        ra, rb = torch.exp(mt - big), torch.exp(rmt - big)
        st, u, mt = st * ra + rst * rb, u * ra + ru * rb, big
    if mode == "mse":
        return acc / (v_total or v)
    logzs, logzt, e = m + torch.log(s), mt + torch.log(st), u / st
    return e - logzt + logzs, logzs, logzt, e


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
    if _build.runs_plain(dev):
        return fused_distill_loss_plain(logits, target_logits, mode, v_total)
    out = launch_fwd("distill_" + mode, logits, target_logits, None, v_total)
    _build.count_launch("fused_distill_loss")
    return out[0]


def fused_distill_kl_parts(logits: torch.Tensor, target_logits: torch.Tensor):
    """kl forward with its residuals: ``(D, logZ_s, logZ_t, E)``, each (T,)
    fp32. Row 9 of the kernel table."""
    dev, _t, v = check_pair(logits, target_logits)
    if _build.runs_plain(dev):
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
    if _build.runs_plain(dev):
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
    if _build.runs_plain(dev):
        return fused_distill_kl_grad_plain(logits, target_logits, logzs,
                                           logzt, e, g, need_target_grad)
    out = launch_bwd("distill_kl", logits, target_logits, None,
                     (logzs, logzt, e), (g,), v, need_target_grad)
    _build.count_launch("fused_distill_kl_grad")
    return out
