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
``paged_scatter_kv`` / ``paged_scatter_quant_kv``: the two scatters of a
    layer's K and V pools under the same write maps, in one launch (the
    decode step's calls). Their plain versions are the single-pool plain
    versions on K, then on V; a launch counts once.

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
    """The one device of every operand, which must be a plain tensor on the
    CPU or the card: a DTensor raises (a kernel reads ``data_ptr()`` of
    the one local tensor, and nothing here gathers a DTensor; its local
    shards reach the loss kernels through ``ops``'s local-rows entry)."""
    refuse_dtensor(*ts)
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def refuse_dtensor(*ts) -> None:
    """Raise ``TypeError`` if any operand is a DTensor."""
    for t in ts:
        if type(t) is torch.Tensor:
            continue
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            raise TypeError("a kernel wrapper takes plain tensors, not a "
                            "DTensor: pass its local shard (the loss "
                            "kernels' DTensor entry is in kernels/ops.py)")


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

# The scatters' checks run on every decode step's layer, so they format
# their messages only when they fail.

def _check_pair(k: torch.Tensor, v: torch.Tensor, what: str) -> None:
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError(f"{what}: K {tuple(k.shape)} {k.dtype} and V "
                         f"{tuple(v.shape)} {v.dtype} differ")


def _check_scatter(pools, new: torch.Tensor, write_slot: torch.Tensor,
                   write_off: torch.Tensor):
    """Checks the tensors a scatter takes: ``pools`` (the pool (NB, BS,
    KVh, hd) first) and ``new`` (S, KVh, hd) contiguous, every tensor on
    one device, the maps (NB,) int32. Returns (device, NB, BS, KVh, hd)."""
    refuse_dtensor(*pools, new, write_slot, write_off)
    pool = pools[0]
    dev = pool.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for t in (*pools, new, write_slot, write_off):
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs {t.device}")
        if not t.is_contiguous():
            raise ValueError("pools, rows and maps must be contiguous")
    if pool.dim() != 4:
        raise ValueError(f"pool must be (NB, BS, KVh, hd), got {tuple(pool.shape)}")
    nb, bs, kvh, hd = pool.shape
    if new.dim() != 3 or new.shape[1] != kvh or new.shape[2] != hd:
        raise ValueError(f"new {tuple(new.shape)} does not match pool rows "
                         f"{(kvh, hd)}")
    for t, name in ((write_slot, "write_slot"), (write_off, "write_off")):
        if t.dtype != torch.int32 or t.shape != (nb,):
            raise ValueError(f"{name} must be ({nb},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    return dev, nb, bs, kvh, hd


def _ptr(t):
    """data_ptr of a tensor for the C entry points; None (null) for None."""
    return None if t is None else t.data_ptr()


def _launch(dev: torch.device, fn, *args) -> int:
    """Calls the C entry point ``fn(*args, stream)`` on ``dev``'s current
    stream, with ``dev`` the current device."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if torch.cuda.current_device() == dev.index:
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


def paged_scatter_plain(pool: torch.Tensor, new: torch.Tensor,
                        write_slot: torch.Tensor,
                        write_off: torch.Tensor) -> torch.Tensor:
    """Plain version of ``paged_scatter`` (in place, returns ``pool``)."""
    blocks = torch.nonzero(write_slot >= 0).flatten()
    pool[blocks, write_off[blocks].long()] = new[write_slot[blocks].long()]
    return pool


def paged_scatter_kv_plain(k_pool, v_pool, k_new, v_new, write_slot,
                           write_off):
    """Plain version of ``paged_scatter_kv``: ``paged_scatter_plain`` on K,
    then on V."""
    return (paged_scatter_plain(k_pool, k_new, write_slot, write_off),
            paged_scatter_plain(v_pool, v_new, write_slot, write_off))


def _scatter(k_pool, k_new, v_pool, v_new, write_slot, write_off) -> None:
    """``paged_scatter`` of one pool (v_pool and v_new None) or of a layer's
    K and V pools in one launch."""
    two = v_pool is not None
    dev, nb, bs, kvh, hd = _check_scatter(
        (k_pool, v_pool, v_new) if two else (k_pool,), k_new, write_slot,
        write_off)
    if two:
        _check_pair(k_pool, v_pool, "pools")
        _check_pair(k_new, v_new, "new rows")
    if k_new.dtype != k_pool.dtype:
        raise ValueError(f"new dtype {k_new.dtype} != pool dtype {k_pool.dtype}")
    if _build.runs_plain(dev):
        paged_scatter_plain(k_pool, k_new, write_slot, write_off)
        if two:
            paged_scatter_plain(v_pool, v_new, write_slot, write_off)
        return
    if nb == 0 or k_new.shape[0] == 0:
        return
    lib = _build.load("paged_cache")
    rc = _launch(dev, lib.repro_paged_scatter, k_pool.data_ptr(),
                 k_new.data_ptr(), _ptr(v_pool), _ptr(v_new),
                 write_slot.data_ptr(), write_off.data_ptr(), nb, bs,
                 kvh * hd * k_pool.element_size(), k_new.shape[0])
    _build.check(lib, rc, "paged_scatter")
    _build.count_launch("paged_scatter")


def paged_scatter(pool: torch.Tensor, new: torch.Tensor,
                  write_slot: torch.Tensor,
                  write_off: torch.Tensor) -> torch.Tensor:
    """Append one KV row per writer into its owned block, in place.

    pool (NB, BS, KVh, hd); new (S, KVh, hd) in the pool's dtype;
    write_slot / write_off (NB,) int32 from ``PagedCachePool.write_maps``.
    """
    _scatter(pool, new, None, None, write_slot, write_off)
    return pool


def paged_scatter_kv(k_pool: torch.Tensor, v_pool: torch.Tensor,
                     k_new: torch.Tensor, v_new: torch.Tensor,
                     write_slot: torch.Tensor, write_off: torch.Tensor):
    """``paged_scatter`` of a layer's K rows into ``k_pool`` and its V rows
    into ``v_pool`` under the same write maps, in place and in one launch.
    The pools share shape and dtype, as do the rows. Returns (k_pool,
    v_pool)."""
    _scatter(k_pool, k_new, v_pool, v_new, write_slot, write_off)
    return k_pool, v_pool


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


def paged_scatter_quant_kv_plain(k_pool, k_scales, v_pool, v_scales, k_new,
                                 v_new, write_slot, write_off):
    """Plain version of ``paged_scatter_quant_kv``:
    ``paged_scatter_quant_plain`` on K, then on V."""
    return (*paged_scatter_quant_plain(k_pool, k_scales, k_new, write_slot,
                                       write_off),
            *paged_scatter_quant_plain(v_pool, v_scales, v_new, write_slot,
                                       write_off))


def _scatter_quant(k_pool, k_scales, k_new, v_pool, v_scales, v_new,
                   write_slot, write_off) -> None:
    """``paged_scatter_quant`` of one pool (the V arguments None) or of a
    layer's K and V pools in one launch."""
    two = v_pool is not None
    dev, nb, bs, kvh, hd = _check_scatter(
        (k_pool, k_scales, v_pool, v_scales, v_new) if two
        else (k_pool, k_scales), k_new, write_slot, write_off)
    if two:
        _check_pair(k_pool, v_pool, "pools")
        _check_pair(k_scales, v_scales, "scales")
        _check_pair(k_new, v_new, "new rows")
    if k_pool.dtype not in _QUANT_CODES:
        raise ValueError(f"pool dtype {k_pool.dtype} is not a quantized dtype "
                         "(int8, fp8)")
    if k_scales.dtype != torch.float32 or k_scales.shape != (nb, bs):
        raise ValueError(f"scales must be ({nb}, {bs}) float32, got "
                         f"{tuple(k_scales.shape)} {k_scales.dtype}")
    if k_new.dtype not in _ROW_CODES:
        raise ValueError(f"new dtype {k_new.dtype} unsupported (fp32/bf16)")
    if _build.runs_plain(dev):
        paged_scatter_quant_plain(k_pool, k_scales, k_new, write_slot,
                                  write_off)
        if two:
            paged_scatter_quant_plain(v_pool, v_scales, v_new, write_slot,
                                      write_off)
        return
    if nb == 0 or k_new.shape[0] == 0:
        return
    lib = _build.load("paged_cache")
    rc = _launch(dev, lib.repro_paged_scatter_quant, k_pool.data_ptr(),
                 k_scales.data_ptr(), k_new.data_ptr(), _ptr(v_pool),
                 _ptr(v_scales), _ptr(v_new), write_slot.data_ptr(),
                 write_off.data_ptr(), nb, bs, kvh * hd, k_new.shape[0],
                 _ROW_CODES[k_new.dtype], _QUANT_CODES[k_pool.dtype])
    _build.check(lib, rc, "paged_scatter_quant")
    _build.count_launch("paged_scatter_quant")


def paged_scatter_quant(pool: torch.Tensor, scales: torch.Tensor,
                        new: torch.Tensor, write_slot: torch.Tensor,
                        write_off: torch.Tensor):
    """Append one KV row per writer into its owned block, quantized, in
    place. pool (NB, BS, KVh, hd) int8 / float8_e4m3fn; scales (NB, BS)
    fp32; new (S, KVh, hd) fp32 / bf16 (taken to fp32 exactly);
    write_slot / write_off as ``paged_scatter``'s. Returns (pool, scales).
    """
    _scatter_quant(pool, scales, new, None, None, None, write_slot, write_off)
    return pool, scales


def paged_scatter_quant_kv(k_pool: torch.Tensor, k_scales: torch.Tensor,
                           v_pool: torch.Tensor, v_scales: torch.Tensor,
                           k_new: torch.Tensor, v_new: torch.Tensor,
                           write_slot: torch.Tensor, write_off: torch.Tensor):
    """``paged_scatter_quant`` of a layer's K rows into ``k_pool`` /
    ``k_scales`` and its V rows into ``v_pool`` / ``v_scales`` under the
    same write maps, in place and in one launch. The pools share shape and
    dtype, as do the scales and the rows. Returns (k_pool, k_scales,
    v_pool, v_scales)."""
    _scatter_quant(k_pool, k_scales, k_new, v_pool, v_scales, v_new,
                   write_slot, write_off)
    return k_pool, k_scales, v_pool, v_scales


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
    if _build.runs_plain(dev):
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
