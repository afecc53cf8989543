"""Slot-paged KV-cache pool: block allocate / free / defrag over one shared
buffer per attention sub-layer.

Per stacked layer, K and V pools of shape ``(L, num_blocks, block_size, KV,
hd)`` are shared by every decode slot, with one host-side block table
``(max_slots, max_blocks_per_slot)`` naming each slot's blocks in sequence
order (the same table indexes every layer). Block 0 is the reserved null
block: never allocated, never written, and every dead table entry points at
it. Allocation is deterministic (lowest-index free blocks first), so seeded
fleet runs are reproducible.

Quantized ``cache_dtype`` (int8 / fp8): the pools store quantized rows and
one fp32 scale per row in ``k_scale`` / ``v_scale`` ``(L, NB, BS)`` beside
``k`` / ``v`` in the same per-sublayer dict, so allocation, defrag and the
scatter move them with their blocks. Prefill rows are quantized at insert
time (``quantize_rows``), decode appends inside ``paged_scatter_quant_kv``.

The device pools are updated in place (the decode step's scatter kernel
writes into them); the reference rebinds new arrays instead.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.paged_cache import is_quantized_dtype, quantize_rows
from repro_torch.models.transformer import _n_scan, _sub_kinds


class PagedCachePool:
    def __init__(self, model, *, max_slots: int, block_size: int,
                 num_blocks: int, max_blocks_per_slot: int,
                 cache_dtype=torch.float32, device="cuda"):
        cfg = model.cfg
        if cfg.sliding_window > 0:
            raise ValueError("paged serving assumes full-length attention")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.block_size = block_size
        self.num_blocks = num_blocks          # includes the null block 0
        self.max_blocks_per_slot = max_blocks_per_slot
        self.cache_dtype = cache_dtype
        self.quantized = is_quantized_dtype(cache_dtype)
        self.kinds = _sub_kinds(cfg)
        self.n_scan = _n_scan(cfg)
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        self.kv_subs = [i for i, (m, _f) in enumerate(self.kinds) if m == "attn"]
        shape = (self.n_scan, num_blocks, block_size, kv, hd)

        def pools():
            d = {name: torch.zeros(shape, dtype=cache_dtype,
                                   device=self.device) for name in ("k", "v")}
            if self.quantized:
                for name in ("k_scale", "v_scale"):
                    d[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                          device=self.device)
            return d
        self.kv: Dict[str, Dict[str, torch.Tensor]] = {
            f"sub{i}": pools() for i in self.kv_subs}
        # host-side allocator state (numpy: the scheduler is host-driven)
        self.table = np.zeros((max_slots, max_blocks_per_slot), np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.slot_blocks: List[List[int]] = [[] for _ in range(max_slots)]
        self.free: List[int] = list(range(1, num_blocks))  # 0 = null block

    # ---- allocator ---------------------------------------------------------
    def blocks_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.block_size)

    def can_admit(self, total_tokens: int) -> bool:
        n = self.blocks_needed(total_tokens)
        return n <= len(self.free) and n <= self.max_blocks_per_slot

    def allocate(self, slot: int, total_tokens: int) -> List[int]:
        """Reserve the slot's full worst-case context (prompt + max output)
        at admission, so an admitted request never waits for blocks."""
        n = self.blocks_needed(total_tokens)
        if not self.can_admit(total_tokens):
            raise RuntimeError(f"cannot admit {n} blocks ({len(self.free)} free)")
        if self.slot_blocks[slot]:
            raise RuntimeError(f"slot {slot} already allocated")
        blocks = [self.free.pop(0) for _ in range(n)]  # lowest-index first
        self.slot_blocks[slot] = blocks
        self.table[slot, :] = 0
        self.table[slot, :n] = blocks
        return blocks

    def free_slot(self, slot: int) -> None:
        self.free.extend(self.slot_blocks[slot])
        self.free.sort()                      # deterministic reuse order
        self.slot_blocks[slot] = []
        self.table[slot, :] = 0
        self.lengths[slot] = 0

    def live_blocks(self) -> int:
        return sum(len(b) for b in self.slot_blocks)

    def utilization(self) -> float:
        return self.live_blocks() / max(1, self.num_blocks - 1)

    # ---- data movement -----------------------------------------------------
    def insert_prefill(self, slot: int, cache, length: int) -> None:
        """Copy a per-request prefill cache (leaves ``(L, 1, length, KV,
        hd)`` from ``LM.prefill`` with ``cap == length``) into the slot's
        allocated blocks."""
        bs = self.block_size
        nb = self.blocks_needed(length)
        ids = torch.as_tensor(self.slot_blocks[slot][:nb], dtype=torch.long,
                              device=self.device)
        pad = nb * bs - length
        for i in self.kv_subs:
            for name in ("k", "v"):
                src = cache[f"sub{i}"][name][:, 0]            # (L, len, kv, hd)
                src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, pad))
                src = src.reshape(self.n_scan, nb, bs, *src.shape[2:])
                if self.quantized:
                    src, scales = quantize_rows(src, self.cache_dtype)
                    self.kv[f"sub{i}"][f"{name}_scale"][:, ids] = scales
                self.kv[f"sub{i}"][name][:, ids] = src.to(self.cache_dtype)
        self.lengths[slot] = length

    def write_maps(self, active: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Invert slot->(block, offset) appends into the per-block writer
        maps ``paged_scatter`` wants, for the slots flagged active."""
        wslot = np.full((self.num_blocks,), -1, np.int32)
        woff = np.zeros((self.num_blocks,), np.int32)
        for s in np.nonzero(active)[0]:
            pos = int(self.lengths[s])
            blk = self.slot_blocks[s][pos // self.block_size]
            wslot[blk] = s
            woff[blk] = pos % self.block_size
        return wslot, woff

    # ---- defrag ------------------------------------------------------------
    def defrag(self) -> int:
        """Compact live blocks to the lowest pool indices (stable in
        (slot, sequence) order). Returns the number of blocks moved."""
        live: List[int] = []
        for s in range(self.max_slots):
            live.extend(self.slot_blocks[s])
        remap = {old: new for new, old in enumerate(live, start=1)}
        moved = sum(1 for o, n in remap.items() if o != n)
        if moved == 0:
            return 0
        # permutation: new block index -> old block index (identity for the
        # null block and the free tail)
        perm = np.arange(self.num_blocks)
        for old, new in remap.items():
            perm[new] = old
        used = 1 + len(live)
        perm[used:] = sorted(set(range(self.num_blocks))
                             - set(perm[:used].tolist()))
        perm_t = torch.as_tensor(perm, dtype=torch.long, device=self.device)
        for i in self.kv_subs:
            for name in self.kv[f"sub{i}"]:
                self.kv[f"sub{i}"][name] = self.kv[f"sub{i}"][name][:, perm_t]
        for s in range(self.max_slots):
            self.slot_blocks[s] = [remap[b] for b in self.slot_blocks[s]]
            n = len(self.slot_blocks[s])
            self.table[s, :] = 0
            self.table[s, :n] = self.slot_blocks[s]
        self.free = list(range(used, self.num_blocks))
        return moved
