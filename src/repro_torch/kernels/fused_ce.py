"""Fused cross-entropy, forward and backward: CUDA kernel wrappers + plain
versions.

``fused_cross_entropy``        (T, V) logits, (T,) int32 labels
    -> per-token NLL, fp32: ``logZ - x[label]`` (forward only; a label
    outside [0, V) gives ``logZ``).
``fused_cross_entropy_parts``  (T, V) logits, (T,) int32 labels
    -> per-token (nll, smooth, logZ), fp32: ``nll = logZ - x[label]``,
    ``smooth = logZ - mean_{v < v_real}(x)`` (the label-smoothing term),
    and the ``logZ`` residual of the backward.
``fused_cross_entropy_grad``   dlogits of ``g_nll * nll + g_smooth * smooth``
    per token: ``(g_nll + g_smooth) softmax(x) - g_nll onehot(label)
    - g_smooth [col < v_real] / v_real``, in the logits' dtype.

The kernels (``csrc/fused_losses.cu``, mode 0; the NLL alone mode 5) read each logits element
once per direction and keep every (T, V) intermediate in registers. They
take any T and V: the reference's callers pad T and V to block multiples
(V with ``NEG``), the port pads nothing. ``v_real`` (default V) bounds the
smoothing mean; every column enters ``logZ``, as in the reference. A label
outside [0, V) has no true logit (0) and no one-hot column.

On a CPU tensor each wrapper runs its plain version (fp32 ``logsumexp``
and the closed-form gradient); on a CUDA tensor it launches the kernel or
raises. The shared launch helpers serve ``combined_loss.py`` and
``distill_loss.py`` too.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import _num_sms
from repro_torch.kernels.paged_cache import _require, _same_device

NEG = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' modes: CE, CE + distill (mse, kl), distill alone (mse, kl)
MODES = {"ce": 0, "mse": 1, "kl": 2, "distill_mse": 3, "distill_kl": 4,
         "nll": 5}
# fp32 (K, T) rows the forward writes, per mode
N_OUT = {"ce": 3, "mse": 4, "kl": 6, "distill_mse": 1, "distill_kl": 1,
         "nll": 1}
# the modes whose forward splits a row over a cluster of CTAs
SPLIT_MODES = ("distill_mse", "distill_kl")
# the split plan: at most FWD_MAX_SPLITS CTAs a row (the kernel's largest
# cluster, a non-portable size that beat 8 at one row on an H100)
FWD_MAX_SPLITS = 16


def _check_logits(x: torch.Tensor, name: str) -> Tuple[int, int]:
    _require(x.dim() == 2, f"{name} must be (T, V), got {tuple(x.shape)}")
    _require(x.dtype in _DTYPE_CODES,
             f"{name} dtype {x.dtype} unsupported (fp32/bf16)")
    _require(x.is_contiguous(), f"{name} must be contiguous")
    return x.shape


def _check_tok(t: torch.Tensor, n: int, name: str, dtype) -> None:
    _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _require(tuple(t.shape) == (n,), f"{name} shape {tuple(t.shape)} != ({n},)")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _resolve_v_real(v_real: int, v: int) -> int:
    v_real = v_real or v
    _require(0 < v_real <= v, f"v_real {v_real} outside (0, V={v}]")
    return v_real


def check_inputs(logits: torch.Tensor, labels: torch.Tensor,
                 target: Optional[torch.Tensor] = None,
                 v_real: int = 0) -> Tuple[torch.device, int, int, int]:
    """Validate (T, V) logits [+ target], (T,) int32 labels; returns
    (device, T, V, v_real)."""
    tensors = (logits, labels) if target is None else (logits, target, labels)
    dev = _same_device(*tensors)
    t, v = _check_logits(logits, "logits")
    if target is not None:
        _check_logits(target, "target_logits")
        _require(target.shape == logits.shape,
                 f"target {tuple(target.shape)} != logits {tuple(logits.shape)}")
        _require(target.dtype == logits.dtype,
                 f"target dtype {target.dtype} != logits dtype {logits.dtype}")
    _check_tok(labels, t, "labels", torch.int32)
    return dev, t, v, _resolve_v_real(v_real, v)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def fwd_runs(v: int, itemsize: int, splits: int) -> Tuple[int, int]:
    """(vectors per split, splits) of a row of ``v`` elements of
    ``itemsize`` bytes cut into runs of whole 16-byte vectors: the largest
    power of two up to ``splits`` whose runs are all non-empty at any
    alignment of the row (a row holds at least (v - n + 1) // n whole
    vectors of n elements after its scalar head). Run r is vectors
    [r vps, (r + 1) vps); the last run also takes what is left."""
    n = 16 // itemsize
    nvec = max(0, (v - n + 1) // n)
    splits = 1 << (splits.bit_length() - 1)
    while splits > 1 and (splits - 1) * -(-nvec // splits) >= nvec:
        splits //= 2
    return max(1, -(-nvec // splits)), splits


def distill_fwd_split_plan(n_tok: int, v: int, itemsize: int,
                           num_sms: int) -> Tuple[int, int]:
    """(vectors per split, splits) of the distillation forward's grid
    (splits x T CTAs, a cluster of ``splits`` a row), from ints alone, so
    the launch needs no value from the device: ceil(num_sms / T) splits,
    enough that the T x splits CTAs cover the SMs once, down to a power of
    two, at most ``FWD_MAX_SPLITS``, with no empty run; one split once the
    rows alone cover the SMs (``chip_smoke.py``'s kernels phase times every
    cluster size beside the plan's)."""
    for val in (n_tok, v, itemsize, num_sms):
        _require(type(val) is int and val > 0,
                 f"the split plan takes positive ints, got {val!r}")
    _require(itemsize in (2, 4), f"itemsize {itemsize} is not 2 or 4")
    return fwd_runs(v, itemsize, min(FWD_MAX_SPLITS, -(-num_sms // n_tok)))


def launch_fwd(mode: str, logits: torch.Tensor, target: Optional[torch.Tensor],
               labels: Optional[torch.Tensor], v_real: int,
               residuals: bool = False,
               plan: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The forward kernel; returns its fp32 (K, T) output rows, followed
    (``residuals``, mode ``distill_kl``) by the rows [logZ_s, logZ_t, E].
    The distillation modes split each row as ``distill_fwd_split_plan``
    says, or as ``plan`` = (vectors per split, splits) says; the others run
    one CTA a row."""
    dev = logits.device
    t, v = logits.shape
    out = torch.empty((N_OUT[mode] + (3 if residuals else 0), t),
                      dtype=torch.float32, device=dev)
    if t == 0:
        return out
    es = logits.element_size()
    if plan is None and mode in SPLIT_MODES and v > 0:
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        plan = distill_fwd_split_plan(t, v, es, _num_sms(index))
    vps, splits = plan or fwd_runs(v, es, 1)
    lib = _build.load("fused_losses")
    with torch.cuda.device(dev):
        rc = lib.repro_fused_loss_fwd(
            logits.data_ptr(), _ptr(target), _ptr(labels), out.data_ptr(),
            out[N_OUT[mode]].data_ptr() if residuals else None, t, v, v_real,
            vps, splits, MODES[mode], _DTYPE_CODES[logits.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, f"fused loss forward ({mode})")
    return out


def _f32_row(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``x`` itself when it is an fp32 contiguous row, as every path hands
    one; a copy otherwise (a strided local shard, a bf16 cotangent)."""
    return None if x is None else x.float().contiguous()


def launch_bwd(mode: str, logits: torch.Tensor, target: Optional[torch.Tensor],
               labels: Optional[torch.Tensor],
               residuals: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], v_real: int,
               need_target_grad: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The backward kernel, one launch; returns (ds, dt or None) in the
    logits' dtype. ``residuals`` are the mode's (T,) rows (logZ_s; logZ_s,
    logZ_t, E; or none) and ``grads`` its cotangents (g_nll, g_smooth and,
    but in mode ``ce``, g_dist; or g_dist alone), each passed by its own
    pointer."""
    dev = logits.device
    t, v = logits.shape
    ds = torch.empty_like(logits)
    dt = torch.empty_like(target) if need_target_grad else None
    if t == 0:
        return ds, dt
    res = [_f32_row(r) for r in residuals] + [None] * (3 - len(residuals))
    g = [_f32_row(x) for x in grads]
    g = [None, None, *g] if len(g) == 1 else g + [None] * (3 - len(g))
    lib = _build.load("fused_losses")
    with torch.cuda.device(dev):
        rc = lib.repro_fused_loss_bwd(
            logits.data_ptr(), _ptr(target), _ptr(labels),
            *(_ptr(x) for x in res), *(_ptr(x) for x in g), ds.data_ptr(),
            _ptr(dt), t, v, v_real, MODES[mode], _DTYPE_CODES[logits.dtype],
            1.0 / v_real, 2.0 / v_real,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, f"fused loss backward ({mode})")
    return ds, dt


# ----------------------------------------------------------------------------
# plain versions (fp32 inside, the kernels' formulas)
# ----------------------------------------------------------------------------

def _true_logit(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x[t, labels[t]], or 0 for a label outside [0, V)."""
    v = x.shape[-1]
    lb = labels.long()
    ok = (lb >= 0) & (lb < v)
    got = x.gather(-1, lb.clamp(0, max(v - 1, 0))[:, None])[:, 0]
    return torch.where(ok, got, torch.zeros((), dtype=x.dtype, device=x.device))


def fused_cross_entropy_plain(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fused_cross_entropy``."""
    x = logits.float()
    return torch.logsumexp(x, dim=-1) - _true_logit(x, labels)


def fused_cross_entropy_parts_plain(logits: torch.Tensor, labels: torch.Tensor,
                                    v_real: int = 0):
    """Plain version of ``fused_cross_entropy_parts``."""
    v_real = v_real or logits.shape[-1]
    x = logits.float()
    logz = torch.logsumexp(x, dim=-1)
    nll = logz - _true_logit(x, labels)
    smooth = logz - x[:, :v_real].sum(dim=-1) / v_real
    return nll, smooth, logz


def ce_grad_term(x: torch.Tensor, labels: torch.Tensor, logz: torch.Tensor,
                 g_nll: torch.Tensor, g_smooth: torch.Tensor, v_real: int):
    """fp32 (dL/dx, softmax) for ``g_nll * nll + g_smooth * smooth``, in the
    kernel's order of operations: ``(gn + gs) q - gn [c == label]
    - gs [c < v_real] / v_real``."""
    t, v = x.shape
    q = torch.exp(x - logz[:, None])
    dx = (g_nll + g_smooth)[:, None] * q
    lb = labels.long()
    hit = torch.nonzero((lb >= 0) & (lb < v)).flatten()
    dx[hit, lb[hit]] -= g_nll[hit]
    inv_v = torch.tensor(1.0 / v_real, dtype=torch.float32, device=x.device)
    dx[:, :v_real] -= g_smooth[:, None] * inv_v
    return dx, q


def fused_cross_entropy_grad_plain(logits: torch.Tensor, labels: torch.Tensor,
                                   logz: torch.Tensor, g_nll: torch.Tensor,
                                   g_smooth: torch.Tensor,
                                   v_real: int = 0) -> torch.Tensor:
    """Plain version of ``fused_cross_entropy_grad``."""
    v_real = v_real or logits.shape[-1]
    dx, _ = ce_grad_term(logits.float(), labels, logz.float(), g_nll.float(),
                         g_smooth.float(), v_real)
    return dx.to(logits.dtype)


# ----------------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------------

def fused_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-token NLL, fp32 (T,). logits (T, V) fp32/bf16 contiguous; labels
    (T,) int32. Forward only: the entry of ``ops.cross_entropy_tokens``."""
    dev, _t, v, _ = check_inputs(logits, labels)
    if _build.runs_plain(dev):
        return fused_cross_entropy_plain(logits, labels)
    out = launch_fwd("nll", logits, None, labels, v)
    _build.count_launch("fused_cross_entropy")
    return out[0]


def fused_cross_entropy_parts(logits: torch.Tensor, labels: torch.Tensor,
                              v_real: int = 0):
    """Per-token ``(nll, smooth, logZ)``, fp32. logits (T, V) fp32/bf16
    contiguous; labels (T,) int32; ``v_real`` (default V) bounds the
    smoothing mean."""
    dev, _t, _v, v_real = check_inputs(logits, labels, v_real=v_real)
    if _build.runs_plain(dev):
        return fused_cross_entropy_parts_plain(logits, labels, v_real)
    out = launch_fwd("ce", logits, None, labels, v_real)
    _build.count_launch("fused_cross_entropy_parts")
    return out[0], out[1], out[2]


def fused_cross_entropy_grad(logits: torch.Tensor, labels: torch.Tensor,
                             logz: torch.Tensor, g_nll: torch.Tensor,
                             g_smooth: torch.Tensor,
                             v_real: int = 0) -> torch.Tensor:
    """dlogits (T, V) in the logits' dtype for ``g_nll * nll + g_smooth *
    smooth``, from the forward's ``logZ`` residual."""
    dev, t, _v, v_real = check_inputs(logits, labels, v_real=v_real)
    _same_device(logits, logz, g_nll, g_smooth)
    for name, x in (("logz", logz), ("g_nll", g_nll), ("g_smooth", g_smooth)):
        _require(tuple(x.shape) == (t,), f"{name} shape {tuple(x.shape)} != ({t},)")
    if _build.runs_plain(dev):
        return fused_cross_entropy_grad_plain(logits, labels, logz, g_nll,
                                              g_smooth, v_real)
    dx, _ = launch_bwd("ce", logits, None, labels, (logz,), (g_nll, g_smooth),
                       v_real, need_target_grad=False)
    _build.count_launch("fused_cross_entropy_grad")
    return dx
