"""The port's standalone distillation kernels held against the reference's
Pallas kernels (rows 8-11 of the kernel table).

* The plain versions of ``fused_distill_loss`` (mse, kl),
  ``fused_distill_kl_parts``, ``fused_distill_mse_grad`` and
  ``fused_distill_kl_grad`` (what a CPU tensor runs) against the Pallas
  kernels in interpret mode, called directly at block-divisible shapes
  (``block_t=8, block_v=128``), in fp32 and bf16, for mse also with
  ``v_total`` below V (the denominator alone: every column enters the sum).
  Per-token outputs within 1e-5 (both sum in fp32, in other orders).
  Gradients within 1e-5 in fp32; in bf16 element by element within one
  bf16 ulp of the element plus 2^-23 of the largest magnitude (both round
  one fp32 value, computed with other ``exp``s where kl cancels terms).
* ``distill_loss_tokens`` against the reference's, at a vocab its blocks
  pad (the padded-column mse rescale).
* ``torch.autograd`` through the port's ``fused_distill_mean`` against
  ``jax.value_and_grad`` of the reference's (interpret mode) at a ragged
  shape, leading (2, 5), V = 700: with a mask that broadcasts, with the
  target differentiated (dA and dB), with a bf16 target against an fp32
  student. Values within 1e-5 relative, gradients as above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import distill_loss as jdl
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels.distill_loss import (fused_distill_kl_grad,
                                              fused_distill_kl_parts,
                                              fused_distill_loss,
                                              fused_distill_mse_grad)

torch.set_num_threads(2)

T, V, BT, BV = 16, 384, 8, 128
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_tok(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


def _close_grad(got, want, dtype_name):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        return
    m, e = np.frexp(np.abs(w))
    ulp = np.where(m > 0, np.ldexp(1.0, e - 8), 0.0)
    floor = 2.0 ** -23 * float(np.abs(w).max())
    bad = np.abs(g - w) > ulp + floor
    assert not bad.any(), (int(bad.sum()), float(np.abs(g - w).max()))


def _pair(dtype_name, shape, seed):
    """numpy student and correlated target -> (jax, torch) of one dtype."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    b = (a + 0.5 * rng.standard_normal(shape)).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    # bf16 values cross as their exact fp32 upcast
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32))).to(tdt)
    tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(tdt)
    g = rng.standard_normal(shape[:1]).astype(np.float32)
    return (ja, jb, jnp.asarray(g)), (ta, tb, torch.from_numpy(g))


@pytest.mark.parametrize("v_total", [0, 300])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_mse_rows_8_and_10_match_pallas(dtype_name, v_total):
    (ja, jb, jg), (ta, tb, tg) = _pair(dtype_name, (T, V), seed=1)
    want = jdl.fused_distill_loss(ja, jb, mode="mse", block_t=BT, block_v=BV,
                                  v_total=v_total, interpret=True)
    _close_tok(fused_distill_loss(ta, tb, "mse", v_total), want)
    wda, wdb = jdl.fused_distill_mse_grad(ja, jb, jg, block_t=BT, block_v=BV,
                                          v_total=v_total, interpret=True)
    da, db = fused_distill_mse_grad(ta, tb, tg, v_total)
    assert da.dtype == db.dtype == ta.dtype
    _close_grad(da, wda, dtype_name)
    _close_grad(db, wdb, dtype_name)
    da2, db2 = fused_distill_mse_grad(ta, tb, tg, v_total,
                                      need_target_grad=False)
    assert db2 is None and torch.equal(da2, da)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_kl_rows_8_9_and_11_match_pallas(dtype_name):
    (ja, jb, jg), (ta, tb, tg) = _pair(dtype_name, (T, V), seed=2)
    want = jdl.fused_distill_loss(ja, jb, mode="kl", block_t=BT, block_v=BV,
                                  interpret=True)
    _close_tok(fused_distill_loss(ta, tb, "kl"), want)
    wparts = jdl.fused_distill_kl_parts(ja, jb, block_t=BT, block_v=BV,
                                        interpret=True)
    parts = fused_distill_kl_parts(ta, tb)
    assert len(parts) == 4
    for got, w in zip(parts, wparts):
        _close_tok(got, w)
    _close_tok(parts[0], want)
    res = tuple(torch.from_numpy(_np(r).copy()) for r in wparts[1:])
    wda, wdb = jdl.fused_distill_kl_grad(ja, jb, *wparts[1:], jg, block_t=BT,
                                         block_v=BV, interpret=True)
    da, db = fused_distill_kl_grad(ta, tb, *res, tg)
    assert da.dtype == db.dtype == ta.dtype
    _close_grad(da, wda, dtype_name)
    _close_grad(db, wdb, dtype_name)
    da2, db2 = fused_distill_kl_grad(ta, tb, *res, tg, need_target_grad=False)
    assert db2 is None and torch.equal(da2, da)


def test_wrappers_validate_their_inputs():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="mode"):
        fused_distill_loss(a, a, "ce")
    with pytest.raises(ValueError, match="target"):
        fused_distill_loss(a, torch.zeros(4, 9))
    with pytest.raises(ValueError, match="dtype"):
        fused_distill_loss(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="unsupported"):
        fused_distill_loss(a.half(), a.half())
    with pytest.raises(ValueError, match="per-token"):
        fused_distill_mse_grad(a, a, torch.zeros(5))


@pytest.mark.parametrize("mode", ["mse", "kl"])
def test_distill_loss_tokens_matches_reference(mode):
    (ja, jb, _), (ta, tb, _) = _pair("float32", (2, 5, 700), seed=3)
    want = jops.distill_loss_tokens(ja, jb, mode=mode, interpret=True)
    got = ops.distill_loss_tokens(ta, tb, mode)
    assert tuple(got.shape) == (2, 5)
    _close_tok(got, want)


# ----------------------------------------------------------------------------
# autograd: the port's Function against the reference's custom_vjp
# ----------------------------------------------------------------------------

LEAD, VA = (2, 5), 700
CASES = [("float32", "float32", "tokens"), ("bfloat16", "bfloat16", "tokens"),
         ("float32", "float32", "broadcast"), ("float32", "bfloat16", "tokens")]


@pytest.mark.parametrize("student,target,mask_kind", CASES)
@pytest.mark.parametrize("mode", ["mse", "kl"])
def test_fused_distill_mean_autograd_matches_reference(mode, student, target,
                                                       mask_kind):
    """Both operands differentiated; a per-token mask, or one of shape
    (5,) that broadcasts over the leading axis (the denominator is the
    unbroadcast mask's sum); a bf16 target against an fp32 student."""
    (ja, jb, _), (ta, tb, _) = _pair(student, LEAD + (VA,), seed=4)
    rng = np.random.default_rng(5)
    mshape = LEAD if mask_kind == "tokens" else LEAD[1:]
    mask = (rng.random(mshape) > 0.3).astype(np.float32)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    if target != student:
        jb = jb.astype(jnp.bfloat16)
        tb = torch.from_numpy(np.array(jb.astype(jnp.float32))).to(
            torch.bfloat16)
    jval, (jga, jgb) = jax.value_and_grad(
        lambda a, b: jops.fused_distill_mean(a, b, mode, jm, interpret=True),
        argnums=(0, 1))(ja, jb)
    a = ta.clone().requires_grad_(True)
    b = tb.clone().requires_grad_(True)
    val = ops.fused_distill_mean(a, b, mode, tm)
    val.backward()
    w = float(jval)
    assert abs(float(val.detach()) - w) <= 1e-5 * max(1.0, abs(w))
    assert a.grad.dtype == ta.dtype and b.grad.dtype == tb.dtype
    _close_grad(a.grad, jga, student)
    _close_grad(b.grad, jgb, target)
    # a detached target (codist_loss's): the student's gradient alone
    a.grad = None
    ops.fused_distill_mean(a, tb, mode, tm).backward()
    _close_grad(a.grad, jga, student)
    with torch.no_grad():        # no gradient to take: the forward alone
        v2 = ops.fused_distill_mean(ta, tb, mode, tm)
    assert abs(float(v2) - w) <= 1e-5 * max(1.0, abs(w))
