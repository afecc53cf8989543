"""The distillation forward's split of a row over a cluster of CTAs, held on
the CPU.

The CUDA forward of modes 3 and 4 (rows 8 and 9) cuts each token row into
runs of whole 16-byte vectors (``fwd_run_columns``), keeps each run's fp32
state (m, s, acc, mt, st, u) in its own CTA and folds the runs in rank
order with the kernel's merge. ``distill_split_merge_plain`` models that:

* over the plan's runs, at T in {1, 37}, V in {1000, 700}, for mse (also
  with v_total < V) and kl, at every head a row can have and off the vector
  path, it equals the plain versions (what a CPU tensor runs) within 1e-6
  relative: per token for mse; for kl within 1e-6 of the largest of the four
  outputs, since D = E - logZ_b + logZ_a is a difference of terms that size
  and their last-bit rounding carries into it. It equals the reference's
  Pallas kernels in interpret mode within ``test_torch_distill.py``'s 1e-5;
* ``distill_fwd_split_plan`` takes ints only, gives one split at T = 4096,
  at least 4 at T = 1 (V = 152064, fp32 and bf16), no empty run at any V and
  alignment, and runs that cover the row once on whole vectors;
* the launch path takes its plan from the shapes alone: with a recording
  stand-in for the CUDA library the distillation modes pass the plan's split
  count, the CE modes 1, two calls that differ only in values pass the same
  arguments, and no tensor value is read on the host.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import distill_loss as jdl
from repro_torch.kernels import _build
from repro_torch.kernels import combined_loss as cl
from repro_torch.kernels import distill_loss as dl
from repro_torch.kernels import fused_ce as fce

torch.set_num_threads(2)

SMS = 132    # an H100's SMs
FULL_V = 152064


def _pair(t, v, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((t, v)) * 2.0).astype(np.float32)
    b = (a + 0.5 * rng.standard_normal((t, v))).astype(np.float32)
    return (torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype))


def _heads(itemsize):
    """Every head a row can have on the vector path, then the all-scalar
    path (None)."""
    return [*range(16 // itemsize), None]


# (T, V, Pallas block_v): the plan gives 16 runs at T = 1, 4 at T = 37
SHAPES = [(1, 1000, 125), (1, 700, 100), (37, 1000, 200), (37, 700, 140)]


@pytest.mark.parametrize("mode,v_total", [("mse", 0), ("mse", 600), ("kl", 0)])
@pytest.mark.parametrize("t,v,block_v", SHAPES)
def test_split_merge_matches_plain_and_pallas(t, v, block_v, mode, v_total):
    a, b = _pair(t, v, seed=t + v)
    plan = dl.distill_fwd_split_plan(t, v, a.element_size(), SMS)
    assert plan[1] == (16 if t == 1 else 4)
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    if mode == "mse":
        plain = dl.fused_distill_loss_plain(a, b, "mse", v_total)
        pallas = [jdl.fused_distill_loss(ja, jb, mode="mse", block_t=t,
                                         block_v=block_v, v_total=v_total,
                                         interpret=True)]
    else:
        plain = dl.fused_distill_kl_parts_plain(a, b)
        pallas = jdl.fused_distill_kl_parts(ja, jb, block_t=t,
                                            block_v=block_v, interpret=True)
        d_only = jdl.fused_distill_loss(ja, jb, mode="kl", block_t=t,
                                        block_v=block_v, interpret=True)
        np.testing.assert_allclose(np.asarray(d_only), np.asarray(pallas[0]),
                                   rtol=0, atol=1e-5)
    plain = [plain] if mode == "mse" else list(plain)
    for head in _heads(a.element_size()):
        got = dl.distill_split_merge_plain(a, b, mode, plan, head or 0,
                                           vec=head is not None,
                                           v_total=v_total)
        got = [got] if mode == "mse" else list(got)
        assert len(got) == len(plain)
        if mode == "mse":
            np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(),
                                       rtol=1e-6, atol=0)
        else:
            scale = max(float(p.abs().max()) for p in plain)
            for g, p in zip(got, plain):
                np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0,
                                           atol=1e-6 * scale)
        for g, p in zip(got, pallas):
            np.testing.assert_allclose(g.numpy(), np.asarray(p), rtol=0,
                                       atol=1e-5)


def test_split_merge_bf16_runs_match_plain():
    """bf16 rows cut into runs of 8-element vectors, the canary's width."""
    a, b = _pair(1, FULL_V, seed=5, dtype=torch.bfloat16)
    plan = dl.distill_fwd_split_plan(1, FULL_V, 2, SMS)
    assert plan == (1188, 16)
    for head in (0, 5, None):
        got = dl.distill_split_merge_plain(a, b, "mse", plan, head or 0,
                                           vec=head is not None)
        np.testing.assert_allclose(
            got.numpy(), dl.fused_distill_loss_plain(a, b, "mse").numpy(),
            rtol=1e-6, atol=0)
        parts = dl.distill_split_merge_plain(a, b, "kl", plan, head or 0,
                                             vec=head is not None)
        plain = dl.fused_distill_kl_parts_plain(a, b)
        scale = max(float(p.abs().max()) for p in plain)
        for g, p in zip(parts, plain):
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0,
                                       atol=1e-6 * scale)


def test_one_split_is_the_whole_row_bitwise():
    """One run is the row's one state: no merge, the plain sums exactly."""
    a, b = _pair(3, 1000, seed=9)
    plan = dl.fwd_runs(1000, 4, 1)
    assert plan == (max(1, (1000 - 3) // 4), 1)
    assert torch.equal(dl.distill_split_merge_plain(a, b, "mse", plan),
                       dl.fused_distill_loss_plain(a, b, "mse"))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_split_plan_at_the_paths_shapes(itemsize):
    plan = dl.distill_fwd_split_plan
    assert plan(4096, FULL_V, itemsize, SMS)[1] == 1
    assert plan(1, FULL_V, itemsize, SMS)[1] >= 4
    got = {}
    for t in (1, 16, 37, 128, 512, 4096):
        vps, splits = plan(t, FULL_V, itemsize, SMS)
        assert type(vps) is int and type(splits) is int
        assert 1 <= splits <= fce.FWD_MAX_SPLITS
        assert splits & (splits - 1) == 0, "a power-of-two cluster"
        if splits > 1:      # more splits only while the rows leave SMs idle
            assert t * (splits // 2) < SMS
        got[t] = splits
    # the canary, a few rows, the subsample wire's 512, the main path's 4096
    assert got == {1: 16, 16: 8, 37: 4, 128: 2, 512: 1, 4096: 1}


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("v", [1, 7, 700, 1000, FULL_V])
def test_split_runs_cover_the_row_once_and_none_is_empty(v, itemsize):
    n = 16 // itemsize
    for t in (1, 16, 37, 128, 512, 4096):
        vps, splits = dl.distill_fwd_split_plan(t, v, itemsize, SMS)
        for head in _heads(itemsize):
            if head is not None and head > v:
                continue
            runs = dl.fwd_run_columns(v, itemsize, head or 0, vps, splits,
                                      vec=head is not None)
            assert len(runs) == splits
            assert all(runs), f"an empty run: V {v}, T {t}, head {head}"
            cols = [c for r in runs for lo, hi in r for c in range(lo, hi)]
            assert sorted(cols) == list(range(v)), "each column once"
            if head is None:
                continue
            nvec = (v - head) // n
            for r, ranges in enumerate(runs):
                vec_cols = [(lo, hi) for lo, hi in ranges
                            if lo >= head and hi <= head + nvec * n]
                for lo, hi in vec_cols:
                    assert (lo - head) % n == 0 and (hi - head) % n == 0
                if 0 < r < splits - 1:      # middle ranks: vectors only
                    assert ranges == vec_cols


@pytest.mark.parametrize("bad", [torch.tensor(16), np.int64(16), 16.0, 0,
                                 True])
def test_split_plan_takes_ints_only(bad):
    with pytest.raises(ValueError, match="positive ints"):
        dl.distill_fwd_split_plan(bad, FULL_V, 2, SMS)
    with pytest.raises(ValueError, match="positive ints"):
        dl.distill_fwd_split_plan(1, FULL_V, 2, bad)


def test_launch_passes_the_plan_from_shapes_alone(monkeypatch):
    """The CUDA branch of the wrappers, run on CPU tensors against a
    stand-in library that records its arguments."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(repro_fused_loss_fwd=record)
    cuda0 = lambda *ts: torch.device("cuda", 0)
    for mod in (fce, dl, cl):
        monkeypatch.setattr(mod, "_same_device", cuda0)
    monkeypatch.setattr(fce, "_num_sms", lambda index: SMS)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "launch_counts", dict(_build.launch_counts))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    t, v = 16, 1000
    entries = [("distill_mse", lambda a, b, lb: dl.fused_distill_loss(a, b)),
               ("distill_kl", lambda a, b, lb: dl.fused_distill_loss(a, b, "kl")),
               ("distill_kl", lambda a, b, lb: dl.fused_distill_kl_parts(a, b)),
               ("nll", lambda a, b, lb: fce.fused_cross_entropy(a, lb)),
               ("ce", lambda a, b, lb: fce.fused_cross_entropy_parts(a, lb)),
               ("mse", lambda a, b, lb: cl.fused_ce_distill_parts(a, b, lb)),
               ("kl", lambda a, b, lb: cl.fused_ce_distill_parts(a, b, lb,
                                                                 "kl"))]
    for seed in (0, 1):
        a, b = _pair(t, v, seed)
        lb = torch.from_numpy(np.random.default_rng(seed).integers(
            0, v, t).astype(np.int32))
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "__int__", "__bool__",
                         "__index__", "__float__", "cpu"):
                m.setattr(torch.Tensor, name, _no_host_read)
            for _mode, fn in entries:
                fn(a, b, lb)
    # T, V, v_real, vectors per split, splits, mode, dtype (no pointers)
    ints = [c[5:12] for c in calls]
    assert len(ints) == 2 * len(entries)
    assert ints[:len(entries)] == ints[len(entries):], \
        "two calls that differ in values only launched differently"
    plan = dl.distill_fwd_split_plan(t, v, 4, SMS)
    assert plan[1] > 1
    for (mode, _fn), got in zip(entries, ints):
        assert got[5] == fce.MODES[mode]
        want = plan if mode in fce.SPLIT_MODES else dl.fwd_runs(v, 4, 1)
        assert got[3:5] == want, (mode, got)


def _no_host_read(*_a, **_k):
    raise AssertionError("the launch read a tensor value on the host")
