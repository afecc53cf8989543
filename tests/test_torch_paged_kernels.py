"""The port's paged-KV kernels, held against the JAX reference on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, which is what
the CUDA kernels are compared with on the card (``chip_smoke.py``). Here the
plain versions are held against the reference's jnp oracles and, for decode
attention, the Pallas kernel in interpret mode:

* ``paged_scatter`` / ``paged_gather`` equal ``paged_scatter_ref`` /
  ``paged_gather_ref`` bit for bit;
* ``paged_attention_decode`` matches ``paged_attention_decode_ref`` and the
  interpret-mode kernel within 1e-5 (fp32; the sums run in other orders),
  over ragged lengths with 0, G in {1, 2, 7}, dead table entries aimed at a
  NaN-poisoned free block, and an inactive slot on the null block.

The reference's Pallas ``paged_scatter`` is never called (it does not
trace on every installed JAX); its jnp oracle is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (paged_attention_decode as
                                           jax_paged_attention_decode,
                                           paged_attention_decode_ref)
from repro.kernels.paged_cache import paged_gather_ref, paged_scatter_ref
from repro_torch.kernels import (launch_counts, paged_attention_decode,
                                 paged_attention_decode_plain, paged_gather,
                                 paged_scatter)

torch.set_num_threads(2)

POISON = 1   # free block full of NaN, named only by dead table entries


def _setup(lengths, *, kvh=2, g=2, hd=16, bs=4, mb=6, nb=48, seed=0):
    """Pools, a disjoint-block table covering ``lengths`` (slot 0 of a
    length-0 entry stays on the null block), dead entries of odd slots
    aimed at the poisoned block, and the scatter maps of this step."""
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
    k = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((nb, bs, kvh, hd)).astype(np.float32)
    k[0] = v[0] = 0.0
    k[POISON] = v[POISON] = np.nan
    q = rng.standard_normal((s, kvh * g, hd)).astype(np.float32)
    new = rng.standard_normal((s, kvh, hd)).astype(np.float32)
    wslot = np.full((nb,), -1, np.int32)
    woff = np.zeros((nb,), np.int32)
    for i, ln in enumerate(lengths):
        if 0 < ln and ln // bs < mb:     # length-0 slots are inactive
            blk = table[i, ln // bs]
            wslot[blk], woff[blk] = i, ln % bs
    return dict(q=q, k=k, v=v, new=new, table=table, lengths=lengths,
                wslot=wslot, woff=woff)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("lengths", [[0, 3, 9, 15], [7, 0, 23, 4, 1]])
def test_scatter_plain_matches_reference_bitwise(lengths):
    d = _setup(lengths)
    want = np.asarray(paged_scatter_ref(jnp.asarray(d["k"]), jnp.asarray(d["new"]),
                                        jnp.asarray(d["wslot"]),
                                        jnp.asarray(d["woff"])))
    pool = _t(d["k"])
    out = paged_scatter(pool, _t(d["new"]), _t(d["wslot"]), _t(d["woff"]))
    assert out is pool, "the port's scatter updates the pool in place"
    assert _same_bits(out.numpy(), want)
    assert not out[0].any(), "null block written"


@pytest.mark.parametrize("lengths", [[0, 3, 9, 15], [7, 0, 23, 4, 1]])
def test_gather_plain_matches_reference_bitwise(lengths):
    d = _setup(lengths)
    bs = d["k"].shape[1]
    n_live = ((d["lengths"] + bs) // bs).astype(np.int32)
    want = np.asarray(paged_gather_ref(jnp.asarray(d["k"]),
                                       jnp.asarray(d["table"]),
                                       jnp.asarray(n_live)))
    out = paged_gather(_t(d["k"]), _t(d["table"]), _t(n_live)).numpy()
    assert _same_bits(out, want)
    assert not np.isnan(out).any(), "a dead entry's poisoned block was read"


@pytest.mark.parametrize("kvh,g,hd,lengths", [
    (4, 1, 16, [0, 3, 9, 15, 23]),      # MHA
    (2, 2, 32, [0, 3, 9, 15, 23]),      # the reduced qwen2-7b grouping
    (2, 7, 16, [11, 0, 22, 5]),         # G = 7, as qwen2-7b at full width
    (1, 7, 8, [0, 0]),                  # every slot inactive
])
def test_decode_plain_matches_reference_and_pallas(kvh, g, hd, lengths):
    d = _setup(lengths, kvh=kvh, g=g, hd=hd)
    # decode reads the pool AFTER this step's scatter
    pool_k = paged_scatter(_t(d["k"]), _t(d["new"]), _t(d["wslot"]), _t(d["woff"]))
    pool_v = paged_scatter(_t(d["v"]), _t(d["new"]), _t(d["wslot"]), _t(d["woff"]))
    args = (_t(d["q"]), pool_k, pool_v, _t(d["table"]), _t(d["lengths"]))
    out = paged_attention_decode(*args).numpy()
    jargs = [jnp.asarray(a.numpy()) for a in args]
    ref = np.asarray(paged_attention_decode_ref(*jargs))
    pallas = np.asarray(jax_paged_attention_decode(*jargs, interpret=True))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=1e-5)
    for i, ln in enumerate(lengths):
        if ln == 0 and not d["table"][i].any():
            assert not out[i].any(), "inactive slot output must be exactly 0"


def test_decode_plain_keeps_q_dtype_and_masks_long_tables():
    """bf16 q -> bf16 out (fp32 state inside); lengths past the table's
    capacity clamp n_live to MB as the reference's grid does."""
    d = _setup([5, 30], kvh=2, g=2, hd=16, mb=4)
    q = _t(d["q"]).to(torch.bfloat16)
    out = paged_attention_decode(q, _t(d["k"]), _t(d["v"]), _t(d["table"]),
                                 _t(d["lengths"]))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    ref = paged_attention_decode_ref(
        jnp.asarray(d["q"]), jnp.asarray(d["k"]), jnp.asarray(d["v"]),
        jnp.asarray(d["table"]), jnp.asarray(d["lengths"]))
    np.testing.assert_allclose(
        paged_attention_decode_plain(_t(d["q"]), _t(d["k"]), _t(d["v"]),
                                     _t(d["table"]), _t(d["lengths"])).numpy(),
        np.asarray(ref), rtol=0, atol=1e-5)


def test_cpu_wrappers_do_not_count_launches():
    """Launch counts move only where a CUDA kernel is launched."""
    before = dict(launch_counts)
    d = _setup([0, 3, 9])
    pool = paged_scatter(_t(d["k"]), _t(d["new"]), _t(d["wslot"]), _t(d["woff"]))
    paged_gather(pool, _t(d["table"]), _t(np.ones(3, np.int32)))
    paged_attention_decode(_t(d["q"]), pool, pool, _t(d["table"]), _t(d["lengths"]))
    assert dict(launch_counts) == before


@pytest.mark.parametrize("bad", ["maps_int64", "row_shape", "row_dtype",
                                 "noncontig_q", "table_rows"])
def test_wrappers_reject_malformed_inputs(bad):
    d = _setup([0, 3, 9])
    pool, new = _t(d["k"]), _t(d["new"])
    ws, wo = _t(d["wslot"]), _t(d["woff"])
    q, table, lens = _t(d["q"]), _t(d["table"]), _t(d["lengths"])
    with pytest.raises(ValueError):
        if bad == "maps_int64":
            paged_scatter(pool, new, ws.long(), wo)
        elif bad == "row_shape":
            paged_scatter(pool, new[:, :1], ws, wo)
        elif bad == "row_dtype":
            paged_scatter(pool, new.double(), ws, wo)
        elif bad == "noncontig_q":
            paged_attention_decode(q.transpose(0, 1).contiguous().transpose(0, 1),
                                   pool, pool, table, lens)
        else:
            paged_attention_decode(q, pool, pool, table[:2], lens)
