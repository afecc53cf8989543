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
    ``m >= n_live[s]``.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches ``csrc/paged_cache.cu`` or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

QUANTIZED_DTYPES = (torch.int8, torch.float8_e4m3fn)


def is_quantized_dtype(dtype) -> bool:
    """True for the quantized KV-pool dtypes (int8 / fp8)."""
    return dtype in QUANTIZED_DTYPES


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
