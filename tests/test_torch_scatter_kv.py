"""The decode step's K+V scatters, held against the JAX reference on the CPU.

``paged_scatter_kv`` and ``paged_scatter_quant_kv`` write a layer's K rows
and V rows under one pair of write maps in one launch on the card. On a CPU
tensor they run their plain versions, which ``chip_smoke.py`` holds the
CUDA kernels against on the card. Here:

* ``paged_scatter_kv`` equals two calls of the reference's
  ``paged_scatter_ref`` (K, then V) bit for bit, over fp32 and bf16 pools;
* ``paged_scatter_quant_kv`` equals two calls of ``paged_scatter_quant_ref``
  bit for bit, over int8 and fp8 pools, from fp32 and from bf16 rows;
* on a map with an inactive slot, writers in block 1 and block NB - 1, at
  offsets 0 and BS - 1, an NB that is a multiple of neither 4 nor 128, a
  NaN-poisoned free block (untouched) and the null block (stays 0);
* ``paged_scatter_quant_kv`` takes rows of any length: at qwen1.5-4b's
  2,560 values (20 KV heads x 128; the kernel's two-pass path past 2,048)
  it equals two calls of ``paged_scatter_quant_ref`` bit for bit;
* the wrappers reject pools, scales or rows of K and V that differ, and
  int64 or mis-shaped maps;
* the decode step (``model_exec``) calls one K+V scatter per attention
  sub-layer, for bf16, int8 and fp8 pools on both attention paths.

The reference's Pallas scatters do not trace on every installed JAX; their
jnp oracles are called instead.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_cache as jax_paged_cache
from repro_torch.configs import get_reduced
from repro_torch.kernels import paged_scatter_kv, paged_scatter_quant_kv
from repro_torch.models import build_model
from repro_torch.serve.fleet import PagedCachePool
from repro_torch.serve.fleet import model_exec
from repro_torch.serve.fleet.model_exec import build_decode_step

torch.set_num_threads(2)

NB, BS, KVH, HD, S = 203, 4, 2, 8, 6     # NB: a multiple of neither 4 nor 128
POISON = 2          # a free block of NaN, named by no writer
# (slot, block, offset): slot 0 is inactive; block 1 and block NB - 1,
# offsets 0 and BS - 1 among them
WRITERS = [(1, 1, 0), (2, NB - 1, BS - 1), (3, 6, 2), (4, 10, 1), (5, 130, 3)]
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn}
QUANT = [torch.int8, torch.float8_e4m3fn]


def _maps():
    ws = np.full((NB,), -1, np.int32)
    wo = np.zeros((NB,), np.int32)
    for s, b, o in WRITERS:
        ws[b], wo[b] = s, o
    return ws, wo


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy / jax array or a CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.asarray(a)
    return a.view(np.uint8)


def _pair(a: np.ndarray, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``
    (bf16 rounded once, by jax, and handed to torch as bits)."""
    j = jnp.asarray(a).astype(JNP[dtype])
    if dtype == torch.bfloat16:
        t = torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(dtype)
    else:
        t = torch.from_numpy(np.asarray(j).copy())
    return j, t


def _pools(rng, dtype):
    """K and V pools of random values: the null block 0 zero, the poisoned
    block NaN."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((NB, BS, KVH, HD)).astype(np.float32)
        x[0] = 0.0
        x[POISON] = np.nan
        out.append(_pair(x, dtype))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_scatter_kv_equals_two_reference_scatters_bitwise(dtype):
    rng = np.random.default_rng(0)
    (jk, tk), (jv, tv) = _pools(rng, dtype)
    (jkn, tkn), (jvn, tvn) = (
        _pair(rng.standard_normal((S, KVH, HD)).astype(np.float32), dtype)
        for _ in range(2))
    ws, wo = _maps()
    before_k, before_v = tk.clone(), tv.clone()
    got_k, got_v = paged_scatter_kv(tk, tv, tkn, tvn, torch.from_numpy(ws),
                                    torch.from_numpy(wo))
    assert got_k is tk and got_v is tv, "the scatter works in place"
    for got, pool, new, before in ((got_k, jk, jkn, before_k),
                                   (got_v, jv, jvn, before_v)):
        want = jax_paged_cache.paged_scatter_ref(pool, new, jnp.asarray(ws),
                                                 jnp.asarray(wo))
        assert np.array_equal(_bits(got), _bits(want))
        assert not _bits(got[0]).any(), "null block written"
        assert np.array_equal(_bits(got[POISON]), _bits(before[POISON]))
        for s, b, o in WRITERS:
            assert not np.array_equal(_bits(got[b, o]), _bits(before[b, o]))


def _quant_pools(rng, dtype, kvh=KVH, hd=HD):
    """(jax pool, torch pool, jax scales, torch scales) for K and for V:
    random rows quantized, the null block and its scales 0, the poisoned
    block NaN scales (and NaN fp8 rows)."""
    out = []
    for _ in range(2):
        full = rng.standard_normal((NB, BS, kvh, hd)).astype(np.float32)
        jq, jsc = jax_paged_cache.quantize_rows(jnp.asarray(full), JNP[dtype])
        pool, scales = np.array(_bits(jq)), np.array(jsc, np.float32)
        pool[0], scales[0] = 0, 0.0
        scales[POISON] = np.nan
        if dtype == torch.float8_e4m3fn:
            pool[POISON] = 0x7F                       # e4m3fn NaN
        tp = torch.from_numpy(pool.copy()).view(dtype)
        out.append((jnp.asarray(pool).view(JNP[dtype]), tp,
                    jnp.asarray(scales), torch.from_numpy(scales.copy())))
    return out


@pytest.mark.parametrize("row_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_rows", "bf16_rows"])
@pytest.mark.parametrize("dtype", QUANT, ids=["int8", "fp8"])
def test_scatter_quant_kv_equals_two_reference_scatters_bitwise(dtype,
                                                                row_dtype):
    _check_quant_kv(dtype, row_dtype, KVH, HD, seed=1)


@pytest.mark.parametrize("row_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_rows", "bf16_rows"])
@pytest.mark.parametrize("dtype", QUANT, ids=["int8", "fp8"])
def test_scatter_quant_kv_takes_long_rows_bitwise(dtype, row_dtype):
    """Rows of 2,560 values (qwen1.5-4b: 20 KV heads x 128), which the
    wrapper refused while the kernel held a row in one warp's registers."""
    _check_quant_kv(dtype, row_dtype, 20, 128, seed=11)


def _check_quant_kv(dtype, row_dtype, kvh, hd, seed):
    """``paged_scatter_quant_kv`` on (NB, BS, kvh, hd) pools against two
    calls of the reference's oracle, bit for bit, in place; the null and
    poisoned blocks untouched; an all-zero row takes scale 0."""
    rng = np.random.default_rng(seed)
    k, v = _quant_pools(rng, dtype, kvh, hd)
    news = []
    for _ in range(2):
        x = (rng.standard_normal((S, kvh, hd)) * 3).astype(np.float32)
        x[3] = 0.0                                    # an all-zero row
        news.append(_pair(x, row_dtype))
    (jkn, tkn), (jvn, tvn) = news
    ws, wo = _maps()
    before = [(p.clone(), sc.clone()) for _j, p, _js, sc in (k, v)]
    got = paged_scatter_quant_kv(k[1], k[3], v[1], v[3], tkn, tvn,
                                 torch.from_numpy(ws), torch.from_numpy(wo))
    assert got[0] is k[1] and got[1] is k[3] and got[2] is v[1] \
        and got[3] is v[3], "the scatter works in place"
    for (jp, tp, jsc, tsc), new, (bp, bsc) in zip((k, v), (jkn, jvn), before):
        want_p, want_s = jax_paged_cache.paged_scatter_quant_ref(
            jp, jsc, new, jnp.asarray(ws), jnp.asarray(wo))
        assert np.array_equal(_bits(tp), _bits(want_p))
        assert np.array_equal(_bits(tsc), _bits(want_s))
        assert not _bits(tp[0]).any() and not _bits(tsc[0]).any(), \
            "null block written"
        assert np.array_equal(_bits(tp[POISON]), _bits(bp[POISON]))
        assert np.array_equal(_bits(tsc[POISON]), _bits(bsc[POISON]))
        assert float(tsc[10, 1]) != float(bsc[10, 1])
    assert float(k[3][6, 2]) == 0.0, "the all-zero row takes scale 0"


BAD = ["pool_shape", "pool_dtype", "row_shape", "row_dtype", "maps_int64",
       "maps_shape"]


@pytest.mark.parametrize("bad", BAD)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_kv_wrappers_reject_malformed_input(quant, bad):
    dtype = torch.int8 if quant else torch.bfloat16
    k = torch.zeros((NB, BS, KVH, HD), dtype=dtype)
    v = k.clone()
    kn = torch.zeros((S, KVH, HD), dtype=torch.bfloat16)
    vn = kn.clone()
    ws, wo = (torch.from_numpy(m) for m in _maps())
    if bad == "pool_shape":
        v = v[:-1].contiguous()
    elif bad == "pool_dtype":
        v = v.view(torch.float8_e4m3fn) if quant else v.float()
    elif bad == "row_shape":
        vn = vn[:-1].contiguous()
    elif bad == "row_dtype":
        vn = vn.float()
    elif bad == "maps_int64":
        ws = ws.long()
    else:
        wo = wo[:-1].contiguous()
    with pytest.raises(ValueError):
        if quant:
            sc = torch.zeros((NB, BS))
            paged_scatter_quant_kv(k, sc, v, sc.clone(), kn, vn, ws, wo)
        else:
            paged_scatter_kv(k, v, kn, vn, ws, wo)


def test_quant_kv_wrapper_rejects_scales_that_differ():
    k = torch.zeros((NB, BS, KVH, HD), dtype=torch.int8)
    rows = torch.zeros((S, KVH, HD))
    ws, wo = (torch.from_numpy(m) for m in _maps())
    with pytest.raises(ValueError, match="scales"):
        paged_scatter_quant_kv(k, torch.zeros((NB, BS)), k.clone(),
                               torch.zeros((NB, BS + 1)), rows, rows, ws, wo)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gather"])
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, *QUANT],
                         ids=["bf16", "int8", "fp8"])
def test_decode_step_scatters_once_per_attention_sublayer(monkeypatch,
                                                          cache_dtype, fused):
    model = build_model(get_reduced("qwen2-7b"))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen, device="cpu")
    pool = PagedCachePool(model, max_slots=3, block_size=4, num_blocks=16,
                          max_blocks_per_slot=4, cache_dtype=cache_dtype,
                          device="cpu")
    for s, n in enumerate((5, 2)):                  # slot 2 stays inactive
        pool.allocate(s, n + 4)
        pool.lengths[s] = n
    calls = []
    name = ("paged_scatter_quant_kv" if cache_dtype in QUANT
            else "paged_scatter_kv")
    real = getattr(model_exec, name)
    monkeypatch.setattr(model_exec, name,
                        lambda *a: calls.append(a) or real(*a))
    active = np.array([True, True, False])
    ws, wo = pool.write_maps(active)
    step = build_decode_step(model, fused_attention=fused)
    logits = step(params, pool.kv, torch.from_numpy(pool.table),
                  torch.from_numpy(pool.lengths), torch.from_numpy(ws),
                  torch.from_numpy(wo), torch.zeros((3, 1), dtype=torch.long))
    assert bool(torch.isfinite(logits).all())
    assert len(calls) == pool.n_scan * len(pool.kv_subs)
    # every call wrote a layer's K and V pools: slot 0's row 5 is block 2's
    # row 1, now nonzero in both
    blk, off = pool.slot_blocks[0][1], 1
    for i in pool.kv_subs:
        for key in ("k", "v"):
            assert _bits(pool.kv[f"sub{i}"][key][:, blk, off]).any(axis=-1).all()
