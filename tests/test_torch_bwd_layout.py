"""The loss backward's operands, held on the CPU.

The CUDA backward (``csrc/fused_losses.cu``, modes 0-4: rows 7, 13, 10 and
11) is one launch a call: every residual row (logZ_s, logZ_t, E) and every
cotangent row (g_nll, g_smooth, g_dist) goes to the kernel by a pointer of
its own, null where the mode has none, so the forward's (K, T) rows and
autograd's cotangents are not stacked into one buffer first.

* the launch is one C call from shapes alone: with a recording stand-in for
  the CUDA library, every row goes in by its own pointer (the forward's rows
  as they are), ``torch.stack`` / ``torch.cat`` are never called, no tensor
  value is read on the host, and two calls that differ only in values pass
  the same ints; a strided or non-fp32 row alone is copied;
* at the classifiers' narrow rows (T 8 / V 10) the wrappers' CPU path (the
  plain versions) equals the reference's Pallas backward in interpret mode
  within 1e-5, mode by mode.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import combined_loss as jcl
from repro.kernels import distill_loss as jdl
from repro.kernels import fused_ce as jce
from repro_torch.kernels import _build
from repro_torch.kernels import combined_loss as cl
from repro_torch.kernels import distill_loss as dl
from repro_torch.kernels import fused_ce as fce

torch.set_num_threads(2)

MODES = ("ce", "mse", "kl", "distill_mse", "distill_kl")


def _inputs(t, v, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, v)) * 2.0).astype(np.float32)
    tg = (x + 0.5 * rng.standard_normal((t, v))).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    labels[::3] = v                     # out of range: no one-hot column
    g = rng.standard_normal((3, t)).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(tg).to(dtype),
            torch.from_numpy(labels), torch.from_numpy(g))


def _entries(x, tg, lb, out, g, need_dt=("distill_kl", "kl")):
    """(mode, call) of rows 7, 10, 11 and 13 (mse, kl) through their public
    wrappers, the target's gradient asked for in the modes ``need_dt``
    names: the residuals are rows of one (K, T) forward output, the
    cotangents rows of one (3, T)."""
    logzs, logzt, e = out[0], out[1], out[2]
    return [
        ("ce", lambda: fce.fused_cross_entropy_grad(x, lb, logzs, g[0], g[1])),
        ("distill_mse", lambda: dl.fused_distill_mse_grad(
            x, tg, g[2], need_target_grad="distill_mse" in need_dt)),
        ("distill_kl", lambda: dl.fused_distill_kl_grad(
            x, tg, logzs, logzt, e, g[2],
            need_target_grad="distill_kl" in need_dt)),
        ("mse", lambda: cl.fused_ce_distill_grad(
            x, tg, lb, (logzs,), g[0], g[1], g[2], "mse",
            need_target_grad="mse" in need_dt)),
        ("kl", lambda: cl.fused_ce_distill_grad(
            x, tg, lb, (logzs, logzt, e), g[0], g[1], g[2], "kl",
            need_target_grad="kl" in need_dt))]


# ----------------------------------------------------------------------------
# the launch: one C call, every row by its own pointer, from shapes alone
# ----------------------------------------------------------------------------

def _no_host_read(*_a, **_k):
    raise AssertionError("the launch read a tensor value on the host")


def _no_copy_kernel(*_a, **_k):
    raise AssertionError("the launch stacked or concatenated its rows")


@pytest.fixture
def recording_lib(monkeypatch):
    """The CUDA branch of the wrappers, run on CPU tensors against a
    stand-in library that records its arguments."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(repro_fused_loss_bwd=record)
    cuda0 = lambda *ts: torch.device("cuda", 0)  # noqa: E731
    for mod in (fce, dl, cl):
        monkeypatch.setattr(mod, "_same_device", cuda0)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "launch_counts", dict(_build.launch_counts))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("t,v", [(16, 10), (8, 1000), (4, 32768)])
def test_launch_is_one_call_with_a_pointer_a_row(recording_lib, monkeypatch,
                                                 t, v, dtype, code):
    calls = recording_lib
    n_entries = 0
    for seed in (0, 1):
        x, tg, lb, g = _inputs(t, v, seed, dtype)
        out = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (3, t)).astype(np.float32))
        entries = _entries(x, tg, lb, out, g)
        n_entries = len(entries)
        start = len(calls)
        with monkeypatch.context() as m:
            m.setattr(torch, "stack", _no_copy_kernel)
            m.setattr(torch, "cat", _no_copy_kernel)
            for name in ("item", "tolist", "numpy", "__int__", "__bool__",
                         "__index__", "__float__", "cpu"):
                m.setattr(torch.Tensor, name, _no_host_read)
            for _mode, fn in entries:
                fn()
        assert len(calls) == start + n_entries, "one C call a wrapper call"
        for (mode, _fn), c in zip(entries, calls[start:]):
            assert len(c) == 19
            ptrs = c[:11]
            assert ptrs[0] == x.data_ptr()
            assert ptrs[1] == (None if mode == "ce" else tg.data_ptr())
            has_ce = mode in ("ce", "mse", "kl")
            assert ptrs[2] == (lb.data_ptr() if has_ce else None)
            # the forward's rows and autograd's cotangents as they are
            want_res = {"ce": (out[0], None, None),
                        "mse": (out[0], None, None),
                        "kl": (out[0], out[1], out[2]),
                        "distill_mse": (None, None, None),
                        "distill_kl": (out[0], out[1], out[2])}[mode]
            want_g = ((g[0], g[1], None) if mode == "ce" else
                      (g[0], g[1], g[2]) if has_ce else (None, None, g[2]))
            for got, want in zip(ptrs[3:9], want_res + want_g):
                assert got == (None if want is None else want.data_ptr()), mode
            assert ptrs[9] is not None
            assert (ptrs[10] is None) == (mode in ("ce", "distill_mse",
                                                   "mse"))
            assert c[11:16] == (t, v, v, fce.MODES[mode], code)
            assert c[16:18] == (1.0 / v, 2.0 / v)
    ints = [c[11:16] for c in calls]
    assert ints[:n_entries] == ints[n_entries:], \
        "two calls that differ in values only launched differently"


def test_launch_copies_only_rows_it_cannot_take(recording_lib):
    """A strided (a local shard's) or bf16 row goes in as an fp32 copy; an
    fp32 contiguous row as it is."""
    calls = recording_lib
    x, tg, _lb, g = _inputs(8, 10, seed=4)
    res = torch.zeros((8, 3))[:, 0]             # stride 3
    assert not res.is_contiguous()
    fce.launch_bwd("distill_kl", x, tg, None, (res, g[1], g[2]),
                   (g[0].to(torch.bfloat16),), 10, True)
    c = calls[-1]
    assert c[3] not in (None, res.data_ptr())
    assert c[4] == g[1].data_ptr() and c[5] == g[2].data_ptr()
    assert c[8] is not None and c[6] is None and c[7] is None


# ----------------------------------------------------------------------------
# the narrow rows against the reference's Pallas backward
# ----------------------------------------------------------------------------

def _residuals(mode, x, tg, labels):
    """The mode's (T,) residual rows from the plain forward."""
    if mode == "ce":
        return (fce.fused_cross_entropy_parts_plain(x, labels,
                                                    x.shape[1])[2],)
    if mode in ("mse", "kl"):
        return tuple(cl.fused_ce_distill_parts_plain(x, tg, labels, mode,
                                                     x.shape[1])[1])
    if mode == "distill_mse":
        return ()
    return tuple(dl.fused_distill_kl_parts_plain(x, tg)[1:])


@pytest.mark.parametrize("mode", MODES)
def test_narrow_rows_match_pallas_at_v10(mode):
    """The public wrapper on CPU tensors (the plain version) against the
    reference's Pallas backward in interpret mode (one 8 x 10 block), from
    the same residuals and cotangents, within 1e-5."""
    t, v = 8, 10
    x, tg, lb, g = _inputs(t, v, seed=11)
    res = _residuals(mode, x, tg, lb)
    grads = ((g[0], g[1]) if mode == "ce" else
             (g[0], g[1], g[2]) if mode in ("mse", "kl") else (g[2],))
    out = torch.stack(list(res) + [torch.zeros(t)] * (3 - len(res)))
    got = dict(_entries(x, tg, lb, out, g, need_dt=MODES))[mode]()
    got = (got, None) if isinstance(got, torch.Tensor) else got
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    jx, jt, jl = j(x), j(tg), j(lb)
    kw = dict(block_t=t, block_v=v, interpret=True)
    if mode == "ce":
        want = (jce.fused_cross_entropy_grad(jx, jl, *map(j, res),
                                             *map(j, grads), **kw), None)
    elif mode in ("mse", "kl"):
        want = jcl.fused_ce_distill_grad(jx, jt, jl, tuple(map(j, res)),
                                         *map(j, grads), mode=mode, **kw)
    elif mode == "distill_mse":
        want = jdl.fused_distill_mse_grad(jx, jt, *map(j, grads), **kw)
    else:
        want = jdl.fused_distill_kl_grad(jx, jt, *map(j, res), *map(j, grads),
                                         **kw)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
