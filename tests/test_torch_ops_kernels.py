"""The port's standalone forward CE and flash attention held against the
JAX reference's Pallas kernels (interpret mode) and jnp oracles on the CPU.

On a CPU tensor each wrapper runs its plain version, which is what the CUDA
kernels are compared with on the card (``chip_smoke.py``).

* ``ops.cross_entropy_tokens`` / ``fused_cross_entropy`` match the
  reference's ``ops.cross_entropy_tokens`` and ``fused_cross_entropy`` in
  interpret mode and ``ref.cross_entropy_ref`` within 1e-5, over a leading
  shape, an unaligned vocab, fp32 and bf16, labels at 0 and V - 1; a label
  outside [0, V) gives logZ, as the Pallas kernel does.
* ``flash_attention`` / ``ops.attention`` match the Pallas
  ``flash_attention`` in interpret mode within the reference's tolerances
  (1e-4 fp32, 3e-2 bf16): the reference's ``ATTN_CASES`` at S = 128, cross
  lengths, a ragged causal S that ``ops.attention`` pads, and the Pallas
  kernel's masks where its jnp oracle differs (a window without causal,
  causal on raw indices with T != S, rows masked in every column).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.fused_ce import fused_cross_entropy as jax_fused_cross_entropy
from repro_torch.kernels import (flash_attention, fused_cross_entropy,
                                 launch_counts)
from repro_torch.kernels import ops

torch.set_num_threads(2)


def _tol(dtype):
    return 3e-2 if dtype == "bfloat16" else 1e-4


def _cast(x: np.ndarray, dtype: str):
    """The same values on both sides: numpy fp32 -> (jax, torch) in dtype."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


# ----------------------------------------------------------------------------
# row 5: forward cross-entropy
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_tokens_matches_reference(dtype):
    rng = np.random.default_rng(0)
    v = 300                                          # not a block multiple
    x = (rng.standard_normal((2, 50, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, size=(2, 50)).astype(np.int32)
    labels[0, 0], labels[1, -1] = 0, v - 1
    jx, tx = _cast(x, dtype)
    got = ops.cross_entropy_tokens(tx, torch.from_numpy(labels))
    assert got.shape == (2, 50) and got.dtype == torch.float32
    pallas = jax_ops.cross_entropy_tokens(jx, jnp.asarray(labels),
                                          block_t=64, block_v=128,
                                          interpret=True)
    oracle = ref.cross_entropy_ref(jx.reshape(100, v),
                                   jnp.asarray(labels).reshape(100))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy().reshape(100), np.asarray(oracle),
                               rtol=1e-5, atol=1e-5)


def test_fused_cross_entropy_out_of_range_label_is_logz():
    rng = np.random.default_rng(1)
    t, v = 128, 256
    x = (rng.standard_normal((t, v)) * 4).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    labels[3], labels[7] = -1, v
    got = fused_cross_entropy(torch.from_numpy(x), torch.from_numpy(labels))
    pallas = jax_fused_cross_entropy(jnp.asarray(x), jnp.asarray(labels),
                                     block_t=128, block_v=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=1e-5, atol=1e-5)
    logz = torch.logsumexp(torch.from_numpy(x), dim=-1)
    assert torch.allclose(got[[3, 7]], logz[[3, 7]], rtol=0, atol=1e-5)


def test_cross_entropy_wrapper_contract():
    x = torch.zeros((4, 8))
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="int32"):
        fused_cross_entropy(x, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="unsupported"):
        fused_cross_entropy(x.half(), torch.zeros(4, dtype=torch.int32))
    out = ops.cross_entropy_tokens(x.half(), torch.zeros(4, dtype=torch.int64))
    assert torch.allclose(out, torch.full((4,), float(np.log(8.0))))
    assert dict(launch_counts) == before, "the plain version counts nothing"


# ----------------------------------------------------------------------------
# row 14: flash attention
# ----------------------------------------------------------------------------

def _qkv(b, s, t, h, kvh, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, kvh, hd), (b, t, kvh, hd))]
    return [_cast(a, dtype) for a in arrs]


# the reference's ATTN_CASES (tests/test_kernels.py) with S cut to 128
ATTN_CASES = [
    # (B, S, H, KV, hd, causal, window)
    (1, 128, 4, 4, 64, True, 0),
    (2, 128, 4, 2, 64, True, 0),      # GQA 2:1
    (1, 128, 8, 2, 32, True, 0),      # GQA 4:1
    (1, 128, 4, 4, 64, True, 48),     # sliding window
    (2, 128, 4, 1, 64, True, 0),      # MQA
    (1, 128, 2, 2, 128, False, 0),    # encoder (non-causal)
]


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(b, s, h, kv, hd, causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, s, s, h, kv, hd, dtype, s + h)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jax_flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("causal,window,s,t", [
    (False, 0, 64, 128),    # cross lengths (prefix cache reads)
    (True, 0, 64, 128),     # causal on raw indices: col <= row, T > S
    (False, 24, 128, 64),   # a window without causal: the Pallas mask
    (True, 16, 128, 64),    # rows >= T + 15 masked in every column
])
def test_flash_attention_pallas_masks(causal, window, s, t):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, s, t, 4, 2, 32, "float32", 7)
    got = flash_attention(tq, tk, tv, causal=causal, window=window).numpy()
    want = np.asarray(jax_flash_attention(jq, jk, jv, causal=causal,
                                          window=window, block_q=64,
                                          block_k=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if window and not causal:
        # the jnp oracle applies the window only when causal: the port
        # follows the kernel
        oracle = np.asarray(ref.flash_attention_ref(jq, jk, jv, causal=False,
                                                    window=window))
        assert np.abs(got - oracle).max() > 1e-2
    if causal and window and s > t:
        dead = np.asarray(jv).mean(axis=1)           # (1, KVh, hd)
        np.testing.assert_allclose(got[0, t + window:, 0], np.broadcast_to(
            dead[0, 0], (s - t - window, 32)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,t", [(100, 100), (160, 150)])
def test_attention_ops_matches_reference_padding(s, t):
    """A ragged causal S that the reference's ``ops.attention`` pads; with
    S > T its zero key padding is seen by the rows at or past T."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, s, t, 4, 2, 32, "float32", 3)
    got = ops.attention(tq, tk, tv, causal=True)
    want = jax_ops.attention(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    if s == t:
        oracle = ref.flash_attention_ref(jq, jk, jv, causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                                   rtol=1e-4, atol=1e-4)


def test_attention_ops_refuses_unpadded_non_causal():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 8, 200, 2, 2, 16, "float32", 0)
    with pytest.raises(ValueError, match="block_k"):
        ops.attention(tq, tk, tv, causal=False)
    with pytest.raises(AssertionError):
        jax_ops.attention(jq, jk, jv, causal=False, interpret=True)
    out = ops.attention(tq, tk[:, :128], tv[:, :128], causal=False)
    assert out.shape == tq.shape


def test_flash_attention_wrapper_contract():
    q = torch.zeros((1, 4, 4, 16))
    k = torch.zeros((1, 4, 3, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="share"):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="fp32/bf16"):
        flash_attention(q.half(), q.half(), q.half())
    before = dict(launch_counts)
    flash_attention(q, q, q)
    assert dict(launch_counts) == before, "the plain version counts nothing"
