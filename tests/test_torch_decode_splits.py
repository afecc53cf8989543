"""The paged decode's split over each slot's blocks, held on the CPU.

The CUDA decode runs each run of ``blocks_per_split`` table entries in its
own CTA and merges the runs' softmax states (M = max m_i, L = sum l_i
e^(m_i - M), A = sum acc_i e^(m_i - M), out = A / max(L, 1e-30)). The plain
version does the same when it is given ``blocks_per_split``:

* with runs of 1, 2 and 3 blocks it matches ``paged_attention_decode_ref``
  and the Pallas kernel in interpret mode within 1e-5 (fp32; the sums run
  in other orders), over G in {1, 2, 7}, head_dim in {16, 32}, block size
  in {4, 16}, fp32 and int8 pools, an inactive slot (exactly 0) and dead
  table entries aimed at a NaN-poisoned block;
* ``decode_split_plan`` takes ints only, gives at least one split and the
  waves it aims for at MB = 1, 34, 256 and 2048;
* the launch path takes its grid from the shapes alone: with a recording
  stand-in for the CUDA library, two calls that differ only in ``lengths``
  launch the same grid, and no tensor value is read on the host;
* ``decode_head_groups`` keeps one CTA over every KV head wherever the
  kernel without head groups took the shape, and splits qwen1.5-4b's 20 KV
  heads (G = 1, hd 128) into groups whose stages fit the ring twice; the
  split plan counts the groups' CTAs;
* the plain decode at qwen1.5-4b's head shape (H = KVh = 20, hd 128) matches
  ``paged_attention_decode_ref`` within 1e-5, over fp32 and int8 pools;
* the wrapper raises only for head_dim not in {32, 64, 128} or G > 8: at
  20 KV heads it launches with 4 heads a CTA (bf16; 2 in fp32).
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (paged_attention_decode as
                                           jax_paged_attention_decode,
                                           paged_attention_decode_ref)
from repro_torch.kernels import _build
from repro_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

POISON = 1   # a block of NaN (NaN scales for int8), named only by dead entries
SMS = 132    # an H100's SMs


def _inputs(lengths, *, kvh, g, hd, bs, mb, pool, seed=0):
    """q, pools (and scales), a disjoint-block table covering ``lengths``
    (slot 0 inactive on the null block) with the dead entries of odd slots
    aimed at the poisoned block."""
    rng = np.random.default_rng(seed)
    s = len(lengths)
    lengths = np.asarray(lengths, np.int32)
    nb = 2 + sum((int(n) + bs) // bs for n in lengths)
    table = np.zeros((s, mb), np.int32)
    free = iter(range(2, nb))
    for i, ln in enumerate(lengths):
        n = (ln + bs) // bs
        if ln > 0:
            for m in range(min(n, mb)):
                table[i, m] = next(free)
        if i % 2 and n < mb:
            table[i, n:] = POISON
    q = rng.standard_normal((s, kvh * g, hd)).astype(np.float32)
    kv, scales = [], []
    for _ in range(2):
        if pool == "int8":
            x = rng.integers(-127, 128, (nb, bs, kvh, hd)).astype(np.int8)
            sc = (np.abs(rng.standard_normal((nb, bs))) / 127).astype(np.float32)
            x[0], sc[0], sc[POISON] = 0, 0.0, np.nan
            scales.append(sc)
        else:
            x = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
            x[0], x[POISON] = 0.0, np.nan
        kv.append(x)
    return q, kv, scales, table, lengths


SHAPES = [  # (G, head_dim, block size, pool); each compiles the Pallas
    (7, 16, 4, "fp32"),  # kernel once, whatever the split
    (2, 32, 16, "fp32"),
    (1, 32, 4, "int8"),
    (7, 16, 16, "int8"),
]


@pytest.mark.parametrize("bps", [1, 2, 3])
@pytest.mark.parametrize("g,hd,bs,pool", SHAPES)
def test_split_plain_matches_reference_and_pallas(bps, g, hd, bs, pool):
    lengths = [0, 3 * bs + 2, bs - 1, 5 * bs]
    q, kv, scales, table, lengths = _inputs(lengths, kvh=2, g=g, hd=hd,
                                            bs=bs, mb=6, pool=pool)
    t = [torch.from_numpy(a) for a in (q, *kv, table, lengths, *scales)]
    got = pa.paged_attention_decode_plain(*t[:5], *t[5:],
                                          blocks_per_split=bps).numpy()
    whole = pa.paged_attention_decode_plain(*t[:5], *t[5:]).numpy()
    jargs = [jnp.asarray(a) for a in (q, *kv, table, lengths)]
    jsc = dict(zip(("k_scale", "v_scale"), map(jnp.asarray, scales)))
    ref = np.asarray(paged_attention_decode_ref(*jargs, **jsc))
    pallas = np.asarray(jax_paged_attention_decode(*jargs, **jsc,
                                                   interpret=True))
    assert np.isfinite(got).all(), "a dead entry's poisoned block was read"
    assert not got[0].any(), "an inactive slot must give exactly 0"
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5)


def test_split_plain_with_one_live_run_is_the_walk_bitwise():
    """A slot whose live blocks all fall in the first run gets weight
    exp(0) = 1 on it and 0 on the rest: acc / max(l, 1e-30) exactly."""
    q, kv, _, table, lengths = _inputs([5, 0, 9], kvh=2, g=7, hd=16, bs=4,
                                       mb=6, pool="fp32")
    t = [torch.from_numpy(a) for a in (q, *kv, table, lengths)]
    split = pa.paged_attention_decode_plain(*t, blocks_per_split=3)
    whole = pa.paged_attention_decode_plain(*t)
    assert torch.equal(split, whole)


@pytest.mark.parametrize("mb", [1, 34, 256, 2048])
@pytest.mark.parametrize("slots", [1, 16])
def test_split_plan_covers_the_table_in_waves(slots, mb):
    bps, nsplit = pa.decode_split_plan(slots, mb, SMS)
    assert type(bps) is int and type(nsplit) is int
    assert bps >= 1 and nsplit >= 1
    assert (nsplit - 1) * bps < mb <= nsplit * bps, "runs cover MB exactly"
    if slots == 1:      # one round of the SMs' CTA slots, each run as long
        assert nsplit <= pa.CTAS_PER_SM * SMS
        assert nsplit == mb or nsplit * (bps + 1) > pa.CTAS_PER_SM * SMS
    elif slots * mb >= pa.WAVES * SMS:
        assert slots * nsplit >= pa.WAVES * SMS, "fewer CTAs than the waves"
    else:
        assert bps == 1
    if mb == 2048 and slots == 1:       # one request at 32k
        assert nsplit >= SMS
    if mb == 256 and slots == 16:       # 16 slots at 4k: two waves or more
        assert slots * nsplit >= 2 * SMS


@pytest.mark.parametrize("bad", [torch.tensor(16), np.int64(16), 16.0, 0,
                                 True])
def test_split_plan_takes_ints_only(bad):
    with pytest.raises(ValueError, match="positive ints"):
        pa.decode_split_plan(bad, 34, SMS)


def test_launch_grid_comes_from_shapes_alone(monkeypatch):
    """The CUDA branch of the wrapper, run on CPU tensors against a stand-in
    library that records its arguments: lengths change, the grid does not,
    and no tensor is read on the host on the way."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(repro_paged_attention_decode=record)
    monkeypatch.setattr(pa, "_same_device",
                        lambda *ts: torch.device("cuda", 0))
    monkeypatch.setattr(pa, "_num_sms", lambda index: SMS)
    monkeypatch.setattr(pa._build, "load", lambda name: lib)
    monkeypatch.setattr(pa._build, "launch_counts", dict(_build.launch_counts))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    q, kv, _, table, _ = _inputs([0] * 16, kvh=4, g=7, hd=128, bs=16, mb=34,
                                 pool="fp32")
    args = [torch.from_numpy(a) for a in (q, *kv, table)]
    for lengths in ([0] * 16, [543] * 16):
        lens = torch.tensor(lengths, dtype=torch.int32)
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "__int__", "__bool__",
                         "__index__", "cpu"):
                m.setattr(torch.Tensor, name, _no_host_read)
            pa.paged_attention_decode(*args[:3], args[3], lens)
    # S, H, KVh, hd, NB, BS, MB, blocks per split
    grids = [c[11:19] for c in calls]
    assert grids[0] == grids[1] == (16, 28, 4, 128, kv[0].shape[0], 16,
                                    34, pa.decode_split_plan(16, 34, SMS)[0])


# every (KVh, G) a kernel without head groups took: KVh <= 8, or <= 16 at
# G <= 2, and a K and a V block within 200 KB
ONE_CTA = [(kvh, g) for g in (1, 2, 3, 7, 8) for kvh in range(1, 17)
           if kvh <= (8 if g > 2 else 16)]


@pytest.mark.parametrize("hd,bs,es,quant", [(32, 16, 4, False),
                                            (64, 16, 4, False),
                                            (128, 16, 2, False),
                                            (128, 16, 1, True),
                                            (128, 32, 4, False)])
def test_head_groups_keep_one_cta_where_the_kernel_took_the_shape(hd, bs, es,
                                                                  quant):
    for kvh, g in ONE_CTA:
        legal = 2 * bs * kvh * hd * es + 8 * bs <= 200 * 1024
        got = pa.decode_head_groups(kvh, g, hd, bs, es, quant)
        if legal:
            assert got == kvh, (kvh, g)
        else:
            assert kvh % got == 0 and got < kvh, (kvh, g)


@pytest.mark.parametrize("es,quant,want", [(4, False, 2), (2, False, 4),
                                           (1, True, 4)],
                         ids=["fp32", "bf16", "int8/fp8"])
def test_head_groups_split_twenty_kv_heads(es, quant, want):
    """qwen1.5-4b: 20 KV heads at G = 1, hd 128, blocks of 16. One CTA
    would need 20 warps and a 160 KB bf16 stage (320 KB in fp32)."""
    kvg = pa.decode_head_groups(20, 1, 128, 16, es, quant)
    assert kvg == want and 20 % kvg == 0
    stage = 2 * 16 * kvg * 128 * es + (8 * 16 if quant else 0)
    assert 2 * stage <= pa.RING_BUDGET, "two stages in flight"
    groups = 20 // kvg
    for slots, mb in ((1, 2048), (16, 34), (16, 256)):
        bps, nsplit = pa.decode_split_plan(slots, mb, SMS, groups)
        assert (nsplit - 1) * bps < mb <= nsplit * bps
        if slots == 1:      # one round of the SMs' CTA slots over the groups
            assert nsplit * groups <= pa.CTAS_PER_SM * SMS
        else:
            assert slots * nsplit * groups >= pa.WAVES * SMS
    assert pa.decode_split_plan(16, 34, SMS, 1) == \
        pa.decode_split_plan(16, 34, SMS)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_plain_decode_at_qwen15_4b_heads_matches_reference(pool):
    q, kv, scales, table, lengths = _inputs([0, 21, 5], kvh=20, g=1, hd=128,
                                            bs=8, mb=4, pool=pool, seed=3)
    t = [torch.from_numpy(a) for a in (q, *kv, table, lengths, *scales)]
    got = pa.paged_attention_decode(*t[:5], *t[5:]).numpy()
    jargs = [jnp.asarray(a) for a in (q, *kv, table, lengths)]
    jsc = dict(zip(("k_scale", "v_scale"), map(jnp.asarray, scales)))
    ref = np.asarray(paged_attention_decode_ref(*jargs, **jsc))
    assert np.isfinite(got).all() and not got[0].any()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _stub_launch(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors against a stand-in library
    that records its arguments (as ``test_launch_grid_comes_from_shapes_
    alone``). Returns the list of recorded calls."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(repro_paged_attention_decode=record)
    monkeypatch.setattr(pa, "_same_device",
                        lambda *ts: torch.device("cuda", 0))
    monkeypatch.setattr(pa, "_num_sms", lambda index: SMS)
    monkeypatch.setattr(pa._build, "load", lambda name: lib)
    monkeypatch.setattr(pa._build, "launch_counts", dict(_build.launch_counts))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("h,kvh,hd,dtype,ok", [
    (20, 20, 128, torch.bfloat16, True),   # qwen1.5-4b
    (20, 20, 128, torch.float32, True),
    (40, 20, 64, torch.bfloat16, True),
    (64, 32, 32, torch.float32, True),     # 32 KV heads, G 2
    (64, 8, 128, torch.bfloat16, True),    # G 8
    (20, 20, 96, torch.bfloat16, False),   # head_dim 96
    (16, 16, 16, torch.float32, False),    # head_dim 16
    (36, 4, 128, torch.bfloat16, False),   # G 9
])
def test_wrapper_limits_are_head_dim_and_group_size(monkeypatch, h, kvh, hd,
                                                    dtype, ok):
    calls = _stub_launch(monkeypatch)
    s, mb, bs = 3, 4, 16
    q = torch.zeros((s, h, hd), dtype=dtype)
    pool = torch.zeros((2 + s * mb, bs, kvh, hd), dtype=dtype)
    table = torch.arange(2, 2 + s * mb, dtype=torch.int32).view(s, mb)
    lens = torch.tensor([0, 20, 63], dtype=torch.int32)
    if not ok:
        with pytest.raises(ValueError, match="head_dim 32/64/128 and G <= 8"):
            pa.paged_attention_decode(q, pool, pool.clone(), table, lens)
        return
    pa.paged_attention_decode(q, pool, pool.clone(), table, lens)
    (c,) = calls
    kvg = pa.decode_head_groups(kvh, h // kvh, hd, bs, pool.element_size(),
                                False)
    # S, H, KVh, hd, NB, BS, MB, blocks per split, KV heads a CTA
    assert c[11:20] == (s, h, kvh, hd, pool.shape[0], bs, mb,
                        pa.decode_split_plan(s, mb, SMS, kvh // kvg)[0], kvg)
    if kvh == 20:
        assert kvg == (4 if dtype == torch.bfloat16 and hd == 128 else
                       2 if hd == 128 else 4)


def _no_host_read(*_a, **_k):
    raise AssertionError("the launch read a tensor value on the host")
