"""Continuous-batching scheduler: per-step join/evict of ragged requests
into fixed decode slots over the paged KV pool (the reference's clean path:
no chaos, tracer, metrics or alert hooks).

One ``FleetEngine`` serves one peer. Every engine tick:

  1. requests whose (simulated) arrival time has passed move into the
     bounded waiting queue (overflow is rejected);
  2. up to ``max_prefills_per_step`` waiting requests are admitted into free
     decode slots, reserving their full worst-case context in blocks; each
     runs an exact-length single-request prefill whose KV is copied into
     the slot's blocks and whose last-token argmax is the first token;
  3. one batched decode step advances every live slot through the pool;
  4. finished requests evict, freeing their blocks.

Time is simulated (a deterministic per-step cost model), so the latency
report is reproducible across machines and devices. Greedy decoding only;
argmax runs over the full ``padded_vocab`` width, padded columns included,
as the reference does.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.fleet.cache import PagedCachePool
from repro_torch.serve.fleet.model_exec import build_decode_step
from repro_torch.serve.fleet.workload import Request

PyTree = Any


@dataclass(frozen=True)
class FleetConfig:
    max_slots: int = 8
    block_size: int = 8
    num_blocks: int = 128            # incl. the reserved null block
    max_blocks_per_slot: int = 16
    max_queue: int = 256             # admission control: beyond this, shed
    max_prefills_per_step: int = 2   # prefill/decode interleaving knob
    defrag_every: int = 0            # engine steps; 0 = never
    # None/True: the paged-attention decode kernel; False: gather + dense
    # softmax oracle
    fused_attention: Optional[bool] = None
    # deterministic simulated cost model (ms)
    prefill_ms_per_token: float = 0.2
    decode_ms_per_step: float = 1.5
    step_overhead_ms: float = 0.3


@dataclass
class RequestRecord:
    """Per-request lifecycle + output stream (the determinism surface)."""
    request: Request
    admitted_ms: Optional[float] = None
    first_token_ms: Optional[float] = None
    finished_ms: Optional[float] = None
    rejected: bool = False
    tokens: List[int] = field(default_factory=list)
    prefill_logits: Optional[np.ndarray] = None

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_ms is None:
            return None
        return self.first_token_ms - self.request.arrival_ms

    @property
    def e2e_ms(self) -> Optional[float]:
        if self.finished_ms is None:
            return None
        return self.finished_ms - self.request.arrival_ms


@dataclass
class _Slot:
    record: RequestRecord
    remaining: int
    next_token: int                  # decode input (last generated token)


class FleetEngine:
    """One peer's continuous batcher: paged pool + batched decode."""

    def __init__(self, model, params: PyTree, config: FleetConfig,
                 cache_dtype=torch.float32, keep_logits: bool = False,
                 device="cuda"):
        self.model = model
        self.params = params
        self.config = config
        self.cache_dtype = cache_dtype
        self.keep_logits = keep_logits
        self.pool = PagedCachePool(
            model, max_slots=config.max_slots, block_size=config.block_size,
            num_blocks=config.num_blocks,
            max_blocks_per_slot=config.max_blocks_per_slot,
            cache_dtype=cache_dtype, device=device)
        self.device = self.pool.device
        self._decode = build_decode_step(model, config.fused_attention)
        self.now_ms = 0.0
        self.steps = 0
        self.decode_ticks = 0            # ticks that ran the decode step
        self.pending: Deque[RequestRecord] = deque()  # future arrivals
        self.waiting: Deque[RequestRecord] = deque()  # admission queue
        self.slots: Dict[int, _Slot] = {}             # slot id -> live req
        self.records: List[RequestRecord] = []
        # deterministic accounting
        self.kv_bytes_written = 0
        self.peak_utilization = 0.0
        cfg = model.cfg
        n_attn = len(self.pool.kv_subs) * self.pool.n_scan
        per_row = cfg.num_kv_heads * cfg.resolved_head_dim * cache_dtype.itemsize
        if self.pool.quantized:
            per_row += 4             # one fp32 scale per stored row
        self._kv_bytes_per_token = int(n_attn * 2 * per_row)
        # quantized pools are quantized at insert time: prefill runs with an
        # fp32 cache, so there are exact rows to quantize
        self._prefill_dtype = (torch.float32 if self.pool.quantized
                               else cache_dtype)

    # ---- intake ------------------------------------------------------------
    def enqueue(self, request: Request) -> RequestRecord:
        rec = RequestRecord(request)
        self.records.append(rec)
        self.pending.append(rec)     # router submits in arrival order
        return rec

    @property
    def load(self) -> int:
        return len(self.slots) + len(self.waiting) + len(self.pending)

    def next_arrival_ms(self) -> Optional[float]:
        if not self.pending:
            return None
        return min(r.request.arrival_ms for r in self.pending)

    # ---- the engine tick ---------------------------------------------------
    def _intake(self) -> None:
        for _ in range(len(self.pending)):
            rec = self.pending.popleft()
            if rec.request.arrival_ms > self.now_ms:
                self.pending.append(rec)
                continue
            if len(self.waiting) >= self.config.max_queue:
                rec.rejected = True
                continue
            self.waiting.append(rec)

    def _admit(self) -> int:
        """Prefill + join up to ``max_prefills_per_step`` waiting requests.
        Returns prefilled token count (for the simulated cost model)."""
        admitted_tokens = 0
        n = 0
        while self.waiting and n < self.config.max_prefills_per_step:
            rec = self.waiting[0]
            req = rec.request
            total = req.prompt_len + req.max_new
            if self.pool.blocks_needed(total) > min(
                    self.pool.num_blocks - 1, self.pool.max_blocks_per_slot):
                # larger than the pool itself: shed instead of wedging the queue
                self.waiting.popleft()
                rec.rejected = True
                continue
            free_slots = [s for s in range(self.config.max_slots)
                          if s not in self.slots]
            if not free_slots or not self.pool.can_admit(total):
                break                # head-of-line: wait for evictions
            self.waiting.popleft()
            slot = free_slots[0]
            self.pool.allocate(slot, total)
            tokens = torch.as_tensor(req.prompt, dtype=torch.long,
                                     device=self.device)[None, :]
            logits, cache = self.model.prefill(self.params, tokens,
                                               req.prompt_len,
                                               cache_dtype=self._prefill_dtype)
            self.pool.insert_prefill(slot, cache, req.prompt_len)
            first = int(torch.argmax(logits[0, -1]))
            rec.admitted_ms = self.now_ms
            rec.tokens.append(first)
            if self.keep_logits:
                rec.prefill_logits = logits[0, -1].float().cpu().numpy()
            self.slots[slot] = _Slot(rec, remaining=req.max_new - 1,
                                     next_token=first)
            admitted_tokens += req.prompt_len
            self.kv_bytes_written += req.prompt_len * self._kv_bytes_per_token
            n += 1
        return admitted_tokens

    def decode_logits(self, active: np.ndarray,
                      tokens: np.ndarray) -> torch.Tensor:
        """Run the batched decode step over the pool for the slots flagged
        ``active`` with input ``tokens`` (S,1): appends their K/V rows and
        returns logits (S, V). Slot lengths are not advanced."""
        wslot, woff = self.pool.write_maps(active)
        dev = self.device
        return self._decode(self.params, self.pool.kv,
                    torch.as_tensor(self.pool.table, device=dev),
                    torch.as_tensor(self.pool.lengths, device=dev),
                    torch.as_tensor(wslot, device=dev),
                    torch.as_tensor(woff, device=dev),
                    torch.as_tensor(tokens, dtype=torch.long, device=dev))

    def _decode_tick(self) -> int:
        """One batched decode step over every live slot. Returns the total
        attended context rows (post-write lengths summed over live slots);
        0 means nothing decoded."""
        live = sorted(s for s, sl in self.slots.items() if sl.remaining > 0)
        if not live:
            return 0
        S = self.config.max_slots
        active = np.zeros((S,), bool)
        active[live] = True
        tokens = np.zeros((S, 1), np.int32)
        for s in live:
            tokens[s, 0] = self.slots[s].next_token
        logits = self.decode_logits(active, tokens)
        new_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        self.decode_ticks += 1
        ctx_rows = 0
        for s in live:
            self.pool.lengths[s] += 1
            ctx_rows += int(self.pool.lengths[s])
            sl = self.slots[s]
            tok = int(new_tokens[s])
            sl.record.tokens.append(tok)
            sl.next_token = tok
            sl.remaining -= 1
            self.kv_bytes_written += self._kv_bytes_per_token
        return ctx_rows

    def _evict(self, finish_ms: float) -> None:
        for s in [s for s, sl in self.slots.items() if sl.remaining <= 0]:
            sl = self.slots.pop(s)
            sl.record.finished_ms = finish_ms
            self.pool.free_slot(s)

    def step(self) -> bool:
        """One engine tick; returns False when nothing could progress (the
        caller should jump the clock to the next arrival)."""
        self._intake()
        admitted_tokens = self._admit()
        newly = {s for s, sl in self.slots.items()
                 if sl.record.admitted_ms == self.now_ms}
        decoded = self._decode_tick() > 0
        if admitted_tokens == 0 and not decoded:
            # single-token requests can still finish on prefill alone
            self._evict(self.now_ms)
            return False
        cost = (self.config.step_overhead_ms
                + self.config.prefill_ms_per_token * admitted_tokens
                + (self.config.decode_ms_per_step if decoded else 0.0))
        self.now_ms += cost
        # first-token times are read off before _evict pops any
        # single-step slot out of the slot table
        for s in newly:
            self.slots[s].record.first_token_ms = self.now_ms
        self._evict(self.now_ms)
        self.steps += 1
        self.peak_utilization = max(self.peak_utilization,
                                    self.pool.utilization())
        if self.config.defrag_every and \
                self.steps % self.config.defrag_every == 0:
            self.pool.defrag()
        return True

    def advance_to(self, t_ms: float) -> None:
        """Run ticks until the clock reaches ``t_ms`` (or work runs dry, in
        which case the clock jumps forward — idle time is free)."""
        while self.now_ms < t_ms:
            if not self.step():
                nxt = self.next_arrival_ms()
                self.now_ms = t_ms if nxt is None else min(
                    t_ms, max(nxt, self.now_ms))
                if nxt is None or nxt > t_ms:
                    break

    def drain(self) -> None:
        while self.slots or self.waiting or self.pending:
            if not self.step():
                nxt = self.next_arrival_ms()
                if nxt is None:
                    break
                self.now_ms = max(self.now_ms, nxt)
