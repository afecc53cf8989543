"""The port's fused loss kernels held against the reference's Pallas kernels.

* The plain versions of ``fused_cross_entropy_parts`` / ``_grad`` and
  ``fused_ce_distill_parts`` / ``_grad`` (what a CPU tensor runs) against
  the Pallas kernels in interpret mode, called directly at block-divisible
  shapes (``block_t=8, block_v=128``), in fp32 and bf16, with v_real = V
  and v_real < V (the reference's padded columns hold ``NEG`` in both
  operands). Tolerances: per-token fp32 outputs within 1e-5 (both sum in
  fp32, in other orders); gradients within 1e-5 in fp32 and within one bf16
  ulp at the output's scale in bf16 (both round one fp32 value).
* ``torch.autograd`` through the port's ``fused_ce_distill`` and
  ``fused_cross_entropy_loss`` against ``jax.value_and_grad`` of the
  reference's (interpret mode) at a ragged shape, leading (2, 5), V = 700,
  with a mask and label smoothing 0.1: values within 1e-5 relative, the
  student's and the target's gradients as above.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import combined_loss as jcl
from repro.kernels import fused_ce as jce
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.combined_loss import (fused_ce_distill_grad,
                                               fused_ce_distill_grad_plain,
                                               fused_ce_distill_parts,
                                               fused_ce_distill_parts_plain)
from repro_torch.kernels.fused_ce import (NEG, fused_cross_entropy_grad,
                                          fused_cross_entropy_grad_plain,
                                          fused_cross_entropy_parts,
                                          fused_cross_entropy_parts_plain)

torch.set_num_threads(2)

T, V, BT, BV = 16, 384, 8, 128
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
V_REALS = [V, 300]


def _bf16_ulp(x: np.ndarray) -> float:
    m = float(np.abs(x).max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 2.0 ** -133


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_tok(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


def _close_grad(got, want, dtype_name):
    g, w = _np(got), _np(want)
    tol = 1e-5 if dtype_name == "float32" else _bf16_ulp(w)
    np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def _inputs(dtype_name, v_real, seed=0):
    """numpy logits/target (NEG past v_real in both), labels, cotangents
    -> (jax arrays, torch tensors) holding the same values."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, V)) * 2.0).astype(np.float32)
    t = (x + 0.5 * rng.standard_normal((T, V))).astype(np.float32)
    x[:, v_real:] = NEG
    t[:, v_real:] = NEG
    labels = rng.integers(0, v_real, size=T).astype(np.int32)
    g = rng.standard_normal((3, T)).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx, jt = jnp.asarray(x, jdt), jnp.asarray(t, jdt)
    # bf16 values cross as their exact fp32 upcast
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(tdt)
    return ((jx, jt, jnp.asarray(labels), jnp.asarray(g)),
            (tx, tt, torch.from_numpy(labels), torch.from_numpy(g)))


@pytest.mark.parametrize("v_real", V_REALS)
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_ce_parts_and_grad_match_pallas(dtype_name, v_real):
    (jx, _jt, jl, jg), (tx, _tt, tl, tg) = _inputs(dtype_name, v_real)
    want = jce.fused_cross_entropy_parts(jx, jl, block_t=BT, block_v=BV,
                                         v_real=v_real, interpret=True)
    got = fused_cross_entropy_parts(tx, tl, v_real)
    for a, b in zip(got, want):
        _close_tok(a, b)
    logz = want[2]
    dwant = jce.fused_cross_entropy_grad(jx, jl, logz, jg[0], jg[1],
                                         block_t=BT, block_v=BV,
                                         v_real=v_real, interpret=True)
    dgot = fused_cross_entropy_grad(tx, tl, torch.from_numpy(_np(logz)),
                                    tg[0], tg[1], v_real)
    assert dgot.dtype == tx.dtype
    _close_grad(dgot, dwant, dtype_name)


@pytest.mark.parametrize("v_real", V_REALS)
@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("mode", ["mse", "kl"])
def test_ce_distill_parts_and_grad_match_pallas(mode, dtype_name, v_real):
    (jx, jt, jl, jg), (tx, tt, tl, tg) = _inputs(dtype_name, v_real, seed=1)
    (w3, wres) = jcl.fused_ce_distill_parts(jx, jt, jl, mode=mode,
                                            block_t=BT, block_v=BV,
                                            v_real=v_real, interpret=True)
    (g3, gres) = fused_ce_distill_parts(tx, tt, tl, mode, v_real)
    assert len(gres) == len(wres)
    for a, b in zip(tuple(g3) + tuple(gres), tuple(w3) + tuple(wres)):
        _close_tok(a, b)
    wds, wdt = jcl.fused_ce_distill_grad(jx, jt, jl, tuple(wres), jg[0],
                                         jg[1], jg[2], mode=mode, block_t=BT,
                                         block_v=BV, v_real=v_real,
                                         interpret=True)
    res = tuple(torch.from_numpy(_np(r)) for r in wres)
    gds, gdt = fused_ce_distill_grad(tx, tt, tl, res, tg[0], tg[1], tg[2],
                                     mode, v_real)
    _close_grad(gds, wds, dtype_name)
    _close_grad(gdt, wdt, dtype_name)
    ods, odt = fused_ce_distill_grad(tx, tt, tl, res, tg[0], tg[1], tg[2],
                                     mode, v_real, need_target_grad=False)
    assert odt is None and torch.equal(ods, gds)


def test_plain_versions_take_any_shape():
    """No padding in the port: the plain versions at a ragged (T, V) equal
    the block-padded call of the same function."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((7, 333)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((7, 333)).astype(np.float32))
    lb = torch.from_numpy(rng.integers(0, 333, 7).astype(np.int32))
    pad_x = torch.full((8, 384), NEG)
    pad_t = torch.full((8, 384), NEG)
    pad_x[:7, :333], pad_t[:7, :333] = x, t
    pad_lb = torch.zeros(8, dtype=torch.int32)
    pad_lb[:7] = lb
    a = fused_cross_entropy_parts_plain(x, lb)
    b = fused_cross_entropy_parts_plain(pad_x, pad_lb, v_real=333)
    for u, w in zip(a, b):
        torch.testing.assert_close(u, w[:7], rtol=0, atol=1e-5)
    for mode in ("mse", "kl"):
        (a3, ar) = fused_ce_distill_parts_plain(x, t, lb, mode)
        (b3, br) = fused_ce_distill_parts_plain(pad_x, pad_t, pad_lb, mode, 333)
        for u, w in zip(a3 + ar, b3 + br):
            torch.testing.assert_close(u, w[:7], rtol=0, atol=1e-5)
        g = torch.ones(7)
        da, _ = fused_ce_distill_grad_plain(x, t, lb, ar, g, g, g, mode)
        db, _ = fused_ce_distill_grad_plain(pad_x, pad_t, pad_lb,
                                            tuple(r for r in br),
                                            torch.ones(8), torch.ones(8),
                                            torch.ones(8), mode, 333)
        torch.testing.assert_close(da, db[:7, :333], rtol=0, atol=1e-6)
    dx = fused_cross_entropy_grad_plain(x, lb, a[2], torch.ones(7),
                                        torch.ones(7))
    assert dx.shape == x.shape and torch.isfinite(dx).all()


# ----------------------------------------------------------------------------
# autograd: the port's Functions against the reference's custom_vjp
# ----------------------------------------------------------------------------

LEAD, VA = (2, 5), 700


def _loss_inputs(dtype_name, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(LEAD + (VA,)) * 2.0).astype(np.float32)
    t = (x + 0.5 * rng.standard_normal(LEAD + (VA,))).astype(np.float32)
    labels = rng.integers(0, VA, size=LEAD).astype(np.int32)
    mask = (rng.random(LEAD) > 0.3).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    jx, jt = jnp.asarray(x, jdt), jnp.asarray(t, jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(tdt)
    return (jx, jt, jnp.asarray(labels), jnp.asarray(mask)), (
        tx, tt, torch.from_numpy(labels), torch.from_numpy(mask))


def _close_scalar(got, want):
    w = float(want)
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    assert abs(got - w) <= 1e-5 * max(1.0, abs(w)), (got, w)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("mode", ["mse", "kl"])
def test_fused_ce_distill_autograd_matches_reference(mode, dtype_name):
    (jx, jt, jl, jm), (tx, tt, tl, tm) = _loss_inputs(dtype_name)

    def jloss(a, b):
        task, dist = jops.fused_ce_distill(a, b, jl, mode=mode,
                                           label_smoothing=0.1, mask=jm,
                                           interpret=True)
        return task + 0.7 * dist, (task, dist)

    (_, (jtask, jdist)), (jga, jgb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jx, jt)
    a = tx.clone().requires_grad_(True)
    b = tt.clone().requires_grad_(True)
    task, dist = ops.fused_ce_distill(a, b, tl, mode=mode, label_smoothing=0.1,
                                      mask=tm)
    (task + 0.7 * dist).backward()
    _close_scalar(task, jtask)
    _close_scalar(dist, jdist)
    assert a.grad.dtype == tx.dtype and b.grad.dtype == tt.dtype
    _close_grad(a.grad, jga, dtype_name)
    _close_grad(b.grad, jgb, dtype_name)
    # a detached target: the Function asks for no target gradient
    a.grad = None
    t2, d2 = ops.fused_ce_distill(a, tt, tl, mode=mode, label_smoothing=0.1,
                                  mask=tm)
    (t2 + 0.7 * d2).backward()
    _close_grad(a.grad, jga, dtype_name)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_fused_cross_entropy_loss_autograd_matches_reference(dtype_name,
                                                             masked):
    (jx, _jt, jl, jm), (tx, _tt, tl, tm) = _loss_inputs(dtype_name, seed=4)
    jmask, tmask = (jm, tm) if masked else (None, None)
    jval, jg = jax.value_and_grad(
        lambda a: jops.fused_cross_entropy_loss(a, jl, 0.1, jmask,
                                                interpret=True))(jx)
    a = tx.clone().requires_grad_(True)
    val = ops.fused_cross_entropy_loss(a, tl, 0.1, tmask)
    val.backward()
    _close_scalar(val, jval)
    _close_grad(a.grad, jg, dtype_name)
    with torch.no_grad():        # the eval / off-step path
        _close_scalar(ops.fused_cross_entropy_loss(tx, tl, 0.1, tmask), jval)


def test_fused_losses_default_follows_the_device():
    assert ops.fused_losses_default("cuda") is True
    assert ops.fused_losses_default("cpu") is False
    assert ops.fused_losses_default(torch.device("cpu")) is False


def test_mixed_dtype_target_is_upcast_exactly():
    """A bf16 wire against an fp32 student equals the fp32 call on the
    bf16 values, with each gradient in its operand's dtype."""
    (_j, (tx, tt, tl, tm)) = _loss_inputs("float32", seed=6)
    wire = tt.to(torch.bfloat16)
    a = tx.clone().requires_grad_(True)
    b = wire.clone().requires_grad_(True)
    task, dist = ops.fused_ce_distill(a, b, tl, "kl", 0.0, tm)
    (task + dist).backward()
    a2 = tx.clone().requires_grad_(True)
    b2 = wire.float().requires_grad_(True)
    task2, dist2 = ops.fused_ce_distill(a2, b2, tl, "kl", 0.0, tm)
    (task2 + dist2).backward()
    assert float(task.detach()) == float(task2.detach())
    assert float(dist.detach()) == float(dist2.detach())
    assert b.grad.dtype == torch.bfloat16
    torch.testing.assert_close(a.grad, a2.grad, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, b2.grad.to(torch.bfloat16), rtol=0,
                               atol=0)
