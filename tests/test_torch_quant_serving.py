"""The port's quantized (int8 / fp8) KV pools held against the JAX
reference on the CPU.

* ``quantize_rows`` equals the reference's bit for bit: random rows,
  all-zero rows, rows whose absmax element is negative, and rows whose
  ``x * inv`` lands exactly half-way between two representable values
  (round half to even).
* ``paged_scatter_quant`` (its plain version, which the CUDA kernel is held
  against on the card) equals ``paged_scatter_quant_ref`` bit for bit, with
  idle writers, pre-filled pools and a NaN-poisoned free block.
* ``paged_attention_decode`` with scales matches the Pallas kernel in
  interpret mode and ``paged_attention_decode_ref`` within 1e-5 (fp32; the
  sums run in other orders), over ragged lengths with 0 and G in {1, 2, 7}.
* A quantized ``PagedCachePool`` holds the reference pool's payload, scales
  and table bit for bit after prefill inserts, a free and a defrag.
* ``FleetEngine`` over int8 and fp8 pools, fused and gather paths, drains
  the reference engine's token streams with its byte accounting, and its
  teacher-forced decode logits match within 1e-4 of their scale.

The reference's Pallas ``paged_scatter_quant`` does not trace on every
installed JAX (``pl.load``), so the reference fleet runs with its two
scatters swapped for their jnp oracles (``monkeypatch``); nothing of the
JAX package changes.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import paged_cache as jax_paged_cache
from repro.kernels.paged_attention import (paged_attention_decode as
                                           jax_paged_attention_decode,
                                           paged_attention_decode_ref)
from repro.models import build_model as jax_build_model
from repro.serve.fleet import FleetConfig as JaxFleetConfig
from repro.serve.fleet import FleetEngine as JaxFleetEngine
from repro.serve.fleet import model_exec as jax_model_exec
from repro.serve.fleet.cache import PagedCachePool as JaxPagedCachePool
from repro.serve.fleet.workload import Request
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.kernels import (paged_attention_decode,
                                 paged_scatter_quant, quantize_rows,
                                 quantized_dtype_names)
from repro_torch.models import build_model
from repro_torch.serve import resolve_cache_dtype
from repro_torch.serve.fleet import FleetConfig, FleetEngine, PagedCachePool

torch.set_num_threads(2)

DTYPES = [(torch.int8, jnp.int8), (torch.float8_e4m3fn, jnp.float8_e4m3fn)]
DTYPE_IDS = ["int8", "fp8"]
POISON = 1   # free block of NaN scales (and NaN fp8 rows), named by no writer


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.int32)


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as ``_bits`` gives them (numpy has no fp8)."""
    if t.element_size() == 1:
        return t.view(torch.uint8).numpy()
    return _bits(t.numpy())


def _rows(dtype) -> np.ndarray:
    """(N, KVh=2, hd=8) rows: random at spread magnitudes, an all-zero row,
    a row whose absmax element is negative, and a row whose values sit
    exactly half-way on the quantization grid (scale 1)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((12, 2, 8))
         * rng.uniform(1e-3, 1e3, (12, 1, 1))).astype(np.float32)
    x[3] = 0.0
    x[4, 1, 5] = -4.0 * np.abs(x[4]).max()
    qmax = 127.0 if dtype == torch.int8 else 448.0
    half = x[5]
    half[:] = 0.0
    half[0, 0] = qmax                   # absmax == qmax: scale 1, inv 1
    if dtype == torch.int8:
        ties = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5, -3.5]
    else:                               # e4m3 steps: 0.125 on [1, 2), 2 on [16, 32)
        ties = [1.0625, 1.1875, 17.0, 19.0, -17.0, -1.0625, 0.0009765625,
                -0.0029296875, 3.25, 3.75]
    half.reshape(-1)[1:1 + len(ties)] = ties
    return x


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=DTYPE_IDS)
def test_quantize_rows_matches_reference_bitwise(dtype, jdtype):
    x = _rows(dtype)
    q, sc = quantize_rows(torch.from_numpy(x), dtype)
    jq, jsc = jax_paged_cache.quantize_rows(jnp.asarray(x), jdtype)
    assert np.array_equal(_np(q), _bits(jq))
    assert np.array_equal(_bits(sc.numpy()), _bits(jsc))
    assert float(sc[3]) == 0.0 and not _np(q)[3].any()
    assert float(sc[5]) == 1.0


def _pool_setup(dtype, jdtype, *, nb=24, bs=4, kvh=2, hd=8, s=5, seed=1):
    """A pre-filled quantized pool (null block 0 zero, a poisoned free
    block), its scales, new rows and writer maps with idle (-1) blocks."""
    rng = np.random.default_rng(seed)
    full = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    jq, jsc = jax_paged_cache.quantize_rows(jnp.asarray(full), jdtype)
    pool, scales = np.array(_bits(jq)), np.array(jsc, np.float32)
    pool[0], scales[0] = 0, 0.0
    scales[POISON] = np.nan
    if dtype == torch.float8_e4m3fn:
        pool[POISON] = 0x7F                       # e4m3fn NaN
    new = (rng.standard_normal((s, kvh, hd)) * 3).astype(np.float32)
    new[2] = 0.0                                  # an all-zero appended row
    wslot = np.full((nb,), -1, np.int32)
    woff = np.zeros((nb,), np.int32)
    for i, (blk, off) in enumerate([(3, 0), (7, 2), (8, 3), (20, 1)]):
        wslot[blk], woff[blk] = i + 1, off        # slot 0 idle
    return pool, scales, new, wslot, woff


def _as_torch_pool(pool: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(pool.copy())
    return t.view(dtype) if dtype == torch.float8_e4m3fn else t.view(torch.int8)


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=DTYPE_IDS)
def test_scatter_quant_plain_matches_reference_bitwise(dtype, jdtype):
    pool, scales, new, wslot, woff = _pool_setup(dtype, jdtype)
    jpool = jnp.asarray(pool).view(jdtype)
    want_p, want_s = jax_paged_cache.paged_scatter_quant_ref(
        jpool, jnp.asarray(scales), jnp.asarray(new), jnp.asarray(wslot),
        jnp.asarray(woff))
    tp, ts = _as_torch_pool(pool, dtype), torch.from_numpy(scales.copy())
    got_p, got_s = paged_scatter_quant(tp, ts, torch.from_numpy(new),
                                       torch.from_numpy(wslot),
                                       torch.from_numpy(woff))
    assert got_p is tp and got_s is ts, "the scatter works in place"
    assert np.array_equal(_np(got_p), _bits(want_p))
    assert np.array_equal(_bits(got_s.numpy()), _bits(want_s))
    assert not _np(got_p)[0].any() and not got_s[0].any(), "null block written"
    assert np.array_equal(_np(got_p)[POISON], pool[POISON])
    assert bool(torch.isnan(got_s[POISON]).all()), "poisoned block written"
    assert float(got_s[7, 2]) == 0.0, "the all-zero row takes scale 0"


def _decode_setup(lengths, g, dtype, jdtype, *, kvh=2, hd=16, bs=4, mb=6,
                  nb=48, seed=0):
    """Quantized pools over a disjoint-block table covering ``lengths``,
    dead entries of odd slots aimed at a block of NaN scales."""
    rng = np.random.default_rng(seed)
    s = len(lengths)
    lengths = np.asarray(lengths, np.int32)
    table = np.zeros((s, mb), np.int32)
    free = list(range(2, nb))
    for i, ln in enumerate(lengths):
        n = (ln + bs) // bs
        if ln > 0:
            for m in range(min(n, mb)):
                table[i, m] = free.pop(0)
        if i % 2 and n < mb:
            table[i, n:] = POISON
    out = {}
    for name in ("k", "v"):
        full = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
        full[0] = 0.0
        jq, jsc = jax_paged_cache.quantize_rows(jnp.asarray(full), jdtype)
        sc = np.array(jsc, np.float32)
        sc[POISON] = np.nan
        out[name] = (jq, jnp.asarray(sc))
    q = rng.standard_normal((s, kvh * g, hd)).astype(np.float32)
    return q, out, table, lengths


@pytest.mark.parametrize("g", [1, 2, 7])
@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=DTYPE_IDS)
def test_quant_decode_plain_matches_pallas_and_oracle(dtype, jdtype, g):
    q, kv, table, lengths = _decode_setup([0, 3, 9, 15, 22], g, dtype, jdtype)
    (kq, ks), (vq, vs) = kv["k"], kv["v"]
    jargs = (jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(lengths))
    pallas = np.asarray(jax_paged_attention_decode(
        *jargs, k_scale=ks, v_scale=vs, interpret=True))
    oracle = np.asarray(paged_attention_decode_ref(*jargs, k_scale=ks,
                                                   v_scale=vs))
    got = paged_attention_decode(
        torch.from_numpy(q), _as_torch_pool(_bits(kq), dtype),
        _as_torch_pool(_bits(vq), dtype), torch.from_numpy(table),
        torch.from_numpy(lengths), torch.from_numpy(np.array(ks)),
        torch.from_numpy(np.array(vs))).numpy()
    assert np.isfinite(got).all()
    assert not got[0].any(), "inactive slot on the null block must give 0"
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


def test_quant_decode_takes_both_scales_or_neither():
    q, kv, table, lengths = _decode_setup([3, 5], 1, torch.int8, jnp.int8)
    pool = _as_torch_pool(_bits(kv["k"][0]), torch.int8)
    sc = torch.from_numpy(np.array(kv["k"][1]))
    args = (torch.from_numpy(q), pool, pool, torch.from_numpy(table),
            torch.from_numpy(lengths))
    with pytest.raises(ValueError, match="both scales"):
        paged_attention_decode(*args, sc, None)
    with pytest.raises(ValueError, match="quantized"):
        paged_attention_decode(*args)


def test_quant_wrappers_take_fp32_or_bf16_rows_and_queries():
    """The quantized decode and scatter take the fleet's fp32 or bf16 q
    and rows; an fp16 one raises on the CPU as it would on the card."""
    q, kv, table, lengths = _decode_setup([3, 5], 1, torch.int8, jnp.int8)
    pool = _as_torch_pool(_bits(kv["k"][0]), torch.int8)
    sc = torch.from_numpy(np.array(kv["k"][1]))
    with pytest.raises(ValueError, match="fp32 or bf16 q"):
        paged_attention_decode(torch.from_numpy(q).half(), pool, pool,
                               torch.from_numpy(table),
                               torch.from_numpy(lengths), sc, sc)
    nb = pool.shape[0]
    rows = torch.zeros((2, *pool.shape[2:]), dtype=torch.float16)
    slots = torch.full((nb,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="fp32/bf16"):
        paged_scatter_quant(pool, sc, rows, slots, torch.zeros_like(slots))


# ----------------------------------------------------------------------------
# pool and engine, port vs reference
# ----------------------------------------------------------------------------

def _tiny_cfg(get):
    """The reference test's ``_tiny_model`` config."""
    return replace(get("qwen1.5-0.5b"), num_layers=2, d_model=64, d_ff=128,
                   vocab_size=64, num_heads=2, num_kv_heads=2, head_dim=32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = _tiny_cfg(jax_get_reduced)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    pm = build_model(_tiny_cfg(get_reduced))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, pm, pp


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=DTYPE_IDS)
def test_quantized_pool_matches_reference_bitwise(tiny, dtype, jdtype):
    """The same fp32 prefill caches inserted into three slots, then a free
    and a defrag: pools, scales and tables equal the reference pool's."""
    jm, _jp, pm, _pp = tiny
    kw = dict(max_slots=4, block_size=4, num_blocks=16, max_blocks_per_slot=4)
    ref = JaxPagedCachePool(jm, cache_dtype=jdtype, **kw)
    mine = PagedCachePool(pm, cache_dtype=dtype, device="cpu", **kw)
    assert mine.quantized and ref.quantized
    cfg = pm.cfg
    rng = np.random.default_rng(3)
    for slot, n in enumerate([5, 9, 3]):
        cache = {f"sub{i}": {
            name: (rng.standard_normal((cfg.num_layers, 1, n, cfg.num_kv_heads,
                                        cfg.resolved_head_dim)) * 2
                   ).astype(np.float32) for name in ("k", "v")}
            for i in mine.kv_subs}
        for pool in (ref, mine):
            pool.allocate(slot, n + 4)
        ref.insert_prefill(slot, jax.tree.map(jnp.asarray, cache), n)
        mine.insert_prefill(slot, jax.tree.map(torch.from_numpy, cache), n)
    for pool in (ref, mine):
        pool.free_slot(0)
    assert ref.defrag() == mine.defrag() > 0
    assert np.array_equal(ref.table, mine.table)
    assert ref.free == mine.free
    for sub, d in mine.kv.items():
        assert set(d) == {"k", "v", "k_scale", "v_scale"}
        for name, t in d.items():
            assert np.array_equal(_np(t), _bits(ref.kv[sub][name])), (sub, name)
        assert not _np(d["k"])[:, 0].any() and not d["k_scale"][:, 0].any()


REQ_LENS = [5, 9, 12, 7, 5]
MAX_NEW = 4


def _requests(vocab):
    rng = np.random.default_rng(5)
    return [Request(i, i * 1.0, tuple(int(x) for x in
                                      rng.integers(0, vocab, size=n)), MAX_NEW)
            for i, n in enumerate(REQ_LENS)]


@pytest.fixture
def oracle_scatters(monkeypatch):
    """The reference fleet on its scatters' jnp oracles."""
    monkeypatch.setattr(jax_model_exec, "paged_scatter",
                        jax_paged_cache.paged_scatter_ref)
    monkeypatch.setattr(jax_model_exec, "paged_scatter_quant",
                        jax_paged_cache.paged_scatter_quant_ref)


def _fleet_config(cls, fused):
    return cls(max_slots=2, block_size=4, num_blocks=32, max_blocks_per_slot=8,
               max_prefills_per_step=1, fused_attention=fused)


def _ref_tick(eng, active, tokens):
    """One reference decode step with the given input tokens."""
    pool = eng.pool
    wslot, woff = pool.write_maps(active)
    logits, pool.kv, pool.states = eng._decode(
        eng.params, pool.kv, pool.states, jnp.asarray(pool.table),
        jnp.asarray(pool.lengths), jnp.asarray(wslot), jnp.asarray(woff),
        jnp.asarray(tokens))
    return np.asarray(logits)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gather"])
@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=DTYPE_IDS)
def test_fleet_engine_quantized_matches_reference(tiny, oracle_scatters,
                                                  dtype, jdtype, fused):
    jm, jp, pm, pp = tiny
    reqs = _requests(pm.cfg.padded_vocab)
    ref = JaxFleetEngine(jm, jp, _fleet_config(JaxFleetConfig, fused),
                         cache_dtype=jdtype)
    mine = FleetEngine(pm, pp, _fleet_config(FleetConfig, fused),
                       cache_dtype=dtype, device="cpu")
    assert mine._kv_bytes_per_token == ref._kv_bytes_per_token
    cfg = pm.cfg
    assert mine._kv_bytes_per_token == (
        cfg.num_layers * 2 * (cfg.num_kv_heads * cfg.resolved_head_dim + 4))

    # teacher-forced: two requests admitted, three ticks fed the
    # reference's argmax tokens on both sides
    for eng in (ref, mine):
        for r in reqs[:2]:
            eng.enqueue(Request(r.rid, 0.0, r.prompt, 8))
        eng._intake()
        eng._admit()
        eng._admit()
    active = np.ones((2,), bool)
    tokens = np.asarray([[ref.slots[s].next_token] for s in range(2)], np.int32)
    assert [mine.slots[s].next_token for s in range(2)] == tokens[:, 0].tolist()
    worst = 0.0
    for _ in range(3):
        want = _ref_tick(ref, active, tokens)
        got = mine.decode_logits(active, tokens).numpy()
        worst = max(worst, float(np.abs(got - want).max())
                    / float(np.abs(want).max()))
        for eng in (ref, mine):
            eng.pool.lengths[:] += 1
        tokens = want.argmax(-1)[:, None].astype(np.int32)
    assert worst <= 1e-4, worst

    # drained streams: 2 slots, staggered arrivals, joins and evictions
    ref = JaxFleetEngine(jm, jp, _fleet_config(JaxFleetConfig, fused),
                         cache_dtype=jdtype)
    mine = FleetEngine(pm, pp, _fleet_config(FleetConfig, fused),
                       cache_dtype=dtype, device="cpu")
    for eng in (ref, mine):
        for r in reqs:
            eng.enqueue(r)
        eng.drain()
    want = {rec.request.rid: rec.tokens for rec in ref.records}
    got = {rec.request.rid: rec.tokens for rec in mine.records}
    assert got == want
    assert all(len(t) == MAX_NEW for t in got.values())
    assert mine.kv_bytes_written == ref.kv_bytes_written


def test_resolve_cache_dtype_names():
    assert resolve_cache_dtype("int8") == torch.int8
    assert resolve_cache_dtype("fp8") == torch.float8_e4m3fn
    assert resolve_cache_dtype("float8_e4m3fn") == torch.float8_e4m3fn
    assert resolve_cache_dtype("bf16") == torch.bfloat16
    assert resolve_cache_dtype("auto", "cpu") == torch.float32
    assert quantized_dtype_names() == jax_paged_cache.quantized_dtype_names()
    with pytest.raises(ValueError, match="valid names"):
        resolve_cache_dtype("int4")
