"""Paged KV-cache scatter and gather: CUDA kernel wrappers + plain versions.

The pool ``(NB, BS, KVh, hd)`` is shared by every decode slot; a slot's
blocks are named by its row of the block table. Block 0 is the reserved
null block — never allocated, all-zero — and every dead table entry points
at it.

``paged_scatter``  (pool, new, write_slot, write_off) -> pool, IN PLACE
    writes ``new[write_slot[b]]`` at row ``write_off[b]`` of every block b
    with ``write_slot[b] >= 0`` (the allocator's block->writer map: at most
    one writer per block). The reference returns a new array; the port
    updates the pool in place.
``paged_gather``   (pool, table, n_live) -> (S, MB*BS, KVh, hd)
    copies block ``table[s, m]`` into slot s's contiguous view, zeros for
    ``m >= n_live[s]``. It copies bytes, so it takes any pool dtype, the
    quantized pools and their ``(NB, BS, 1, 1)`` fp32 scales included.
``paged_scatter_quant`` (pool, scales, new, write_slot, write_off)
    -> (pool, scales), IN PLACE: ``paged_scatter`` fused with per-row
    absmax quantization into an int8 / float8_e4m3fn pool; the row's fp32
    scale goes into ``scales (NB, BS)``.

Quantized pools store one fp32 scale per token row (KVh * hd elements):
``scale = absmax / QMAX``, ``q = x * (1 / scale)`` rounded half to even and
clipped to +-127 (int8) or converted to e4m3 (fp8); an all-zero row gets
scale 0 and dequantizes to exactly 0, so the null block stays exact.
``quantize_rows`` is that quantizer in torch (the pool's prefill insert).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches ``csrc/paged_cache.cu`` or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# absmax of the representable range per quantized pool dtype
QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}
_QUANT_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_ROW_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the quantizing scatter holds a row in registers: 128 threads x 16 values
MAX_QUANT_ROW = 2048


def is_quantized_dtype(dtype) -> bool:
    """True for the quantized KV-pool dtypes (int8 / fp8)."""
    return dtype in QMAX


def quantized_dtype_names():
    """The quantized pool dtypes' names, sorted (the reference's spelling)."""
    return tuple(sorted(str(d).replace("torch.", "") for d in QMAX))


def _quantize(x: torch.Tensor, inv_scale: torch.Tensor, dtype) -> torch.Tensor:
    """fp32 -> quantized storage given the reciprocal row scale (already
    broadcast against x): int8 rounds half to even, then clips; fp8 is a
    plain conversion (in range by construction of the scale)."""
    y = x.float() * inv_scale
    if dtype == torch.int8:
        return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    return y.to(dtype)


def quantize_rows(x: torch.Tensor, dtype):
    """Quantize ``x (..., KVh, hd)`` with one fp32 absmax scale per leading
    index (a row = one token position across all KV heads). Returns
    ``(q, scales)`` with ``scales.shape == x.shape[:-2]``; all-zero rows get
    scale 0."""
    absmax = x.float().abs().amax(dim=(-2, -1))
    # tensor-by-tensor IEEE divisions: PyTorch's CUDA ``div`` by a Python
    # scalar multiplies by its reciprocal, which rounds differently
    scales = absmax / torch.full_like(absmax, QMAX[dtype])
    inv = torch.where(scales > 0, torch.ones_like(scales)
                      / torch.clamp(scales, min=1e-30), torch.zeros_like(scales))
    return _quantize(x, inv[..., None, None], dtype), scales


def _same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_index(t: torch.Tensor, shape, name: str) -> None:
    _require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


# ----------------------------------------------------------------------------
# scatter
# ----------------------------------------------------------------------------

def paged_scatter_plain(pool: torch.Tensor, new: torch.Tensor,
                        write_slot: torch.Tensor,
                        write_off: torch.Tensor) -> torch.Tensor:
    """Plain version of ``paged_scatter`` (in place, returns ``pool``)."""
    blocks = torch.nonzero(write_slot >= 0).flatten()
    pool[blocks, write_off[blocks].long()] = new[write_slot[blocks].long()]
    return pool


def paged_scatter(pool: torch.Tensor, new: torch.Tensor,
                  write_slot: torch.Tensor,
                  write_off: torch.Tensor) -> torch.Tensor:
    """Append one KV row per writer into its owned block, in place.

    pool (NB, BS, KVh, hd); new (S, KVh, hd) in the pool's dtype;
    write_slot / write_off (NB,) int32 from ``PagedCachePool.write_maps``.
    """
    dev = _same_device(pool, new, write_slot, write_off)
    _require(pool.dim() == 4, f"pool must be (NB, BS, KVh, hd), got {tuple(pool.shape)}")
    nb, bs, kvh, hd = pool.shape
    _require(new.dim() == 3 and tuple(new.shape[1:]) == (kvh, hd),
             f"new {tuple(new.shape)} does not match pool rows {(kvh, hd)}")
    _require(new.dtype == pool.dtype,
             f"new dtype {new.dtype} != pool dtype {pool.dtype}")
    _require(pool.is_contiguous() and new.is_contiguous(),
             "pool and new must be contiguous")
    _check_index(write_slot, (nb,), "write_slot")
    _check_index(write_off, (nb,), "write_off")
    if dev.type == "cpu":
        return paged_scatter_plain(pool, new, write_slot, write_off)
    if nb == 0 or new.shape[0] == 0:
        return pool
    lib = _build.load("paged_cache")
    with torch.cuda.device(dev):
        rc = lib.repro_paged_scatter(
            pool.data_ptr(), new.data_ptr(), write_slot.data_ptr(),
            write_off.data_ptr(), nb, bs, kvh * hd * pool.element_size(),
            new.shape[0], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "paged_scatter")
    _build.count_launch("paged_scatter")
    return pool


# ----------------------------------------------------------------------------
# scatter with row quantization
# ----------------------------------------------------------------------------

def paged_scatter_quant_plain(pool: torch.Tensor, scales: torch.Tensor,
                              new: torch.Tensor, write_slot: torch.Tensor,
                              write_off: torch.Tensor):
    """Plain version of ``paged_scatter_quant`` (in place, returns
    ``(pool, scales)``)."""
    blocks = torch.nonzero(write_slot >= 0).flatten()
    offs = write_off[blocks].long()
    q, sc = quantize_rows(new[write_slot[blocks].long()].float(), pool.dtype)
    pool[blocks, offs] = q
    scales[blocks, offs] = sc
    return pool, scales


def paged_scatter_quant(pool: torch.Tensor, scales: torch.Tensor,
                        new: torch.Tensor, write_slot: torch.Tensor,
                        write_off: torch.Tensor):
    """Append one KV row per writer into its owned block, quantized, in
    place. pool (NB, BS, KVh, hd) int8 / float8_e4m3fn; scales (NB, BS)
    fp32; new (S, KVh, hd) fp32 / bf16 (taken to fp32 exactly);
    write_slot / write_off as ``paged_scatter``'s. Returns (pool, scales).
    """
    dev = _same_device(pool, scales, new, write_slot, write_off)
    _require(pool.dim() == 4, f"pool must be (NB, BS, KVh, hd), got {tuple(pool.shape)}")
    nb, bs, kvh, hd = pool.shape
    _require(is_quantized_dtype(pool.dtype),
             f"pool dtype {pool.dtype} is not a quantized dtype (int8, fp8)")
    _require(scales.dtype == torch.float32 and tuple(scales.shape) == (nb, bs),
             f"scales must be ({nb}, {bs}) float32, got "
             f"{tuple(scales.shape)} {scales.dtype}")
    _require(new.dim() == 3 and tuple(new.shape[1:]) == (kvh, hd),
             f"new {tuple(new.shape)} does not match pool rows {(kvh, hd)}")
    _require(new.dtype in _ROW_CODES,
             f"new dtype {new.dtype} unsupported (fp32/bf16)")
    _require(kvh * hd <= MAX_QUANT_ROW,
             f"rows of {kvh * hd} values: the kernel takes at most {MAX_QUANT_ROW}")
    _require(pool.is_contiguous() and scales.is_contiguous()
             and new.is_contiguous(), "pool, scales and new must be contiguous")
    _check_index(write_slot, (nb,), "write_slot")
    _check_index(write_off, (nb,), "write_off")
    if dev.type == "cpu":
        return paged_scatter_quant_plain(pool, scales, new, write_slot,
                                         write_off)
    if nb == 0 or new.shape[0] == 0:
        return pool, scales
    lib = _build.load("paged_cache")
    with torch.cuda.device(dev):
        rc = lib.repro_paged_scatter_quant(
            pool.data_ptr(), scales.data_ptr(), new.data_ptr(),
            write_slot.data_ptr(), write_off.data_ptr(), nb, bs, kvh * hd,
            new.shape[0], _ROW_CODES[new.dtype], _QUANT_CODES[pool.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "paged_scatter_quant")
    _build.count_launch("paged_scatter_quant")
    return pool, scales


# ----------------------------------------------------------------------------
# gather
# ----------------------------------------------------------------------------

def paged_gather_plain(pool: torch.Tensor, table: torch.Tensor,
                       n_live: torch.Tensor) -> torch.Tensor:
    """Plain version of ``paged_gather``."""
    s, mb = table.shape
    _, bs, kvh, hd = pool.shape
    g = pool[table.long()]                                   # (S, MB, BS, KVh, hd)
    live = torch.arange(mb, device=pool.device)[None, :] < n_live[:, None]
    g = torch.where(live[..., None, None, None], g, torch.zeros((), dtype=g.dtype,
                                                                device=g.device))
    return g.reshape(s, mb * bs, kvh, hd)


def paged_gather(pool: torch.Tensor, table: torch.Tensor,
                 n_live: torch.Tensor) -> torch.Tensor:
    """pool (NB, BS, KVh, hd); table (S, MB) int32; n_live (S,) int32 live
    blocks per slot. Returns (S, MB*BS, KVh, hd): slot s's context at
    positions [0, n_live[s]*BS), zeros beyond."""
    dev = _same_device(pool, table, n_live)
    _require(pool.dim() == 4, f"pool must be (NB, BS, KVh, hd), got {tuple(pool.shape)}")
    _require(pool.is_contiguous(), "pool must be contiguous")
    _require(table.dim() == 2, f"table must be (S, MB), got {tuple(table.shape)}")
    s, mb = table.shape
    _check_index(table, (s, mb), "table")
    _check_index(n_live, (s,), "n_live")
    if dev.type == "cpu":
        return paged_gather_plain(pool, table, n_live)
    nb, bs, kvh, hd = pool.shape
    out = torch.empty((s, mb * bs, kvh, hd), dtype=pool.dtype, device=dev)
    if s == 0 or mb == 0:
        return out
    lib = _build.load("paged_cache")
    with torch.cuda.device(dev):
        rc = lib.repro_paged_gather(
            pool.data_ptr(), table.data_ptr(), n_live.data_ptr(),
            out.data_ptr(), s, mb, bs * kvh * hd * pool.element_size(), nb,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "paged_gather")
    _build.count_launch("paged_gather")
    return out
