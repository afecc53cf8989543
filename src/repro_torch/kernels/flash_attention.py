"""Forward GQA flash attention: CUDA kernel wrapper + plain version.

``flash_attention``  (q, k, v, causal, window) -> (B, S, H, hd)
    q (B, S, H, hd); k, v (B, T, KVh, hd); query head h attends with KV head
    ``h // (H // KVh)``; fp32 online softmax; the output in q's dtype.

The masks are the reference's Pallas kernel's (``_flash_kernel``), not its
jnp oracle's: ``causal`` keeps ``col <= row`` on raw indices, even when
T != S, and ``window > 0`` keeps ``row - col < window`` whether or not the
call is causal (the oracle applies the window only when causal). A row
masked in every column averages v over all T columns, as both do. The
plain version and the fp32 kernel scale ``q`` by ``hd ** -0.5`` in fp32
before the dot; the bf16 kernels, on the tensor cores, scale the fp32
scores after the unscaled bf16 dot and feed P to P V as bf16 hi + lo (the
arithmetic ``tests/test_torch_flash_rounding.py`` emulates).

The kernels (``csrc/flash_attention.cu``) take any S and T: nothing is
padded. On a CPU tensor the wrapper runs the plain version (a dense fp32
masked softmax); on a CUDA tensor it launches a kernel (by dtype and
head dim, all in one entry point) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_cache import _require, _same_device

NEG = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def attention_mask(s: int, t: int, causal: bool, window: int,
                   device) -> torch.Tensor:
    """(S, T) bool, True where a score is kept: the Pallas kernel's masks."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    keep = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        keep &= cols <= rows
    if window > 0:
        keep &= rows - cols < window
    return keep


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of ``flash_attention``: dense fp32 masked softmax."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, s, kvh, g, hd) * (hd ** -0.5)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    keep = attention_mask(s, t, causal, window, q.device)
    scores = torch.where(keep, scores, NEG)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA flash attention. q (B, S, H, hd); k, v (B, T, KVh, hd), one dtype
    (fp32 / bf16), contiguous; H % KVh == 0; hd in ``HEAD_DIMS``.
    Returns (B, S, H, hd) in q's dtype."""
    dev = _same_device(q, k, v)
    _require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
             f"q must be (B, S, H, hd) and k, v one (B, T, KVh, hd) shape, "
             f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    kb, t, kvh, khd = k.shape
    _require(kb == b and khd == hd,
             f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    _require(kvh > 0 and h % kvh == 0,
             f"num_heads {h} is not a multiple of kv heads {kvh}")
    _require(q.dtype in _DTYPE_CODES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             f"q, k, v must share one of fp32/bf16, got {q.dtype}, "
             f"{k.dtype}, {v.dtype}")
    _require(window >= 0, f"window {window} < 0")
    if _build.runs_plain(dev):
        return flash_attention_plain(q, k, v, causal, window)
    _require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _require(t > 0, "no keys (T = 0)")
    _require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
             "q, k and v must be contiguous")
    # the kernels read 16-byte units: a view off a 16-byte boundary is
    # copied to fresh (aligned) storage
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention")
    with torch.cuda.device(dev):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t,
            h, kvh, hd, int(bool(causal)), int(window), hd ** -0.5,
            _DTYPE_CODES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "flash_attention")
    _build.count_launch("flash_attention")
    return out
