"""Continuous-batching scheduler: per-step join/evict of ragged requests
into fixed decode slots over the paged KV pool (the reference's engine with
its chaos and observability hooks).

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

With a ``ChaosSchedule`` attached (``chaos.py``) each tick also consults
the seeded fault schedule: the tick cost is scaled by the peer's slowdown,
a scheduled preemption jumps the clock past the pause (in-flight slots
frozen, KV intact), and a scheduled failure kills the engine at the start
of the tick; a dead engine makes no progress until the router ``revive``s
it. Without a schedule the engine runs the clean path unchanged.

With a tracer, a metrics registry or a Watchtower attached (``repro_torch.
obs``) each tick records the reference's events on the simulated clock: the
``tick`` span, the ``kv_pool`` and ``decode_analytic`` counters, the
``fleet/*`` metrics, the preemption marker and span, and one alert
evaluation. They read only host state (the slot table, the simulated clock,
the counts of the tick); without them every hook is one attribute check.
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

# trace process rows (the reference's): the router is pid 0, peer engines
# 1 + peer_id, and the per-request span trees have their own process row, so
# a migrated request's tree stays on one row
ROUTER_PID = 0
REQUEST_PID = 1000


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
    """Per-request lifecycle + output stream (the determinism surface).

    ``origin`` is set on migrated continuations: the client's request, whose
    arrival anchors TTFT and E2E however many peers the work visited.
    ``migrations`` counts placements beyond the first (on the client-facing
    record)."""
    request: Request
    canary: bool = False
    admitted_ms: Optional[float] = None
    first_token_ms: Optional[float] = None
    finished_ms: Optional[float] = None
    rejected: bool = False
    cancelled: bool = False          # hedge loser / harvested off a peer
    origin: Optional[Request] = None
    migrations: int = 0
    tokens: List[int] = field(default_factory=list)
    prefill_logits: Optional[np.ndarray] = None   # kept for canary compares
    # trace bookkeeping (the router's): only client-facing placements are
    # traced, and each physical placement emits its span tree once
    traced: bool = False
    trace_emitted: bool = False

    @property
    def _arrival0_ms(self) -> float:
        return (self.origin or self.request).arrival_ms

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_ms is None:
            return None
        return self.first_token_ms - self._arrival0_ms

    @property
    def e2e_ms(self) -> Optional[float]:
        if self.finished_ms is None:
            return None
        return self.finished_ms - self._arrival0_ms


@dataclass
class _Slot:
    record: RequestRecord
    remaining: int
    next_token: int                  # decode input (last generated token)


class FleetEngine:
    """One peer's continuous batcher: paged pool + batched decode."""

    def __init__(self, model, params: PyTree, config: FleetConfig,
                 cache_dtype=torch.float32, keep_logits: bool = False,
                 device="cuda", peer_id: int = 0, tracer=None, metrics=None):
        self.model = model
        self.params = params
        self.config = config
        self.cache_dtype = cache_dtype
        self.keep_logits = keep_logits
        self.peer_id = peer_id
        # observability (None: each hook is one attribute check)
        self.tracer = tracer
        self.metrics = metrics
        self.watch = None                # Watchtower, set by the router
        self._pid = peer_id + 1          # trace process row (0 = router)
        # chaos hooks (None / untouched on the clean path)
        self.chaos = None                # Optional[ChaosSchedule]
        self.health = None               # Optional[PeerHealth]
        self.dead = False
        self._fail_fired = False         # scheduled permanent failure spent
        self.died_at_ms: Optional[float] = None
        self.offline_until_ms = 0.0
        self.preemptions_hit = 0
        self.max_queue_live = config.max_queue   # tightened when degraded
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
        self.weights_version = -1        # bumped by the router's refresh
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
        # analytic decode cost per attended context row: qk and av are each a
        # multiply-accumulate over num_heads * head_dim lanes per attention
        # sub-layer (2 FLOPs a MAC: factor 4)
        self._flops_per_ctx_row = int(
            4 * n_attn * cfg.num_heads * cfg.resolved_head_dim)
        # quantized pools are quantized at insert time: prefill runs with an
        # fp32 cache, so there are exact rows to quantize
        self._prefill_dtype = (torch.float32 if self.pool.quantized
                               else cache_dtype)
        if self.tracer is not None:
            self.tracer.name_process(self._pid, f"peer{peer_id}")
            self.tracer.name_thread(self._pid, 0, "engine")

    # ---- intake ------------------------------------------------------------
    def set_params(self, params: PyTree) -> None:
        self.params = params

    def enqueue(self, request: Request, canary: bool = False) -> RequestRecord:
        rec = RequestRecord(request, canary=canary)
        self.records.append(rec)
        self.pending.append(rec)     # router submits in arrival order
        return rec

    @property
    def load(self) -> int:
        # pending counts too: the router enqueues at arrival time, and ticks
        # may not run between close arrivals
        return len(self.slots) + len(self.waiting) + len(self.pending)

    def has_work(self) -> bool:
        return bool(self.slots or self.waiting or self.pending)

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
            if len(self.waiting) >= self.max_queue_live:
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
            if self.keep_logits or rec.canary:
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
        ``active`` with input ``tokens`` (S,1): appends their K/V rows,
        advances the recurrent states and returns logits (S, V). Slot
        lengths are not advanced."""
        wslot, woff = self.pool.write_maps(active)
        dev = self.device
        return self._decode(self.params, self.pool.kv,
                    torch.as_tensor(self.pool.table, device=dev),
                    torch.as_tensor(self.pool.lengths, device=dev),
                    torch.as_tensor(wslot, device=dev),
                    torch.as_tensor(woff, device=dev),
                    torch.as_tensor(tokens, dtype=torch.long, device=dev),
                    self.pool.states)

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

    def _decode_cost_ms(self) -> float:
        """Simulated cost of the tick's decode work (the speculative engine
        charges its draft and verify instead of one plain step)."""
        return self.config.decode_ms_per_step

    def _defrag(self) -> None:
        self.pool.defrag()

    def _evict(self, finish_ms: float) -> None:
        for s in [s for s, sl in self.slots.items() if sl.remaining <= 0]:
            sl = self.slots.pop(s)
            sl.record.finished_ms = finish_ms
            self.pool.free_slot(s)

    def step(self) -> bool:
        """One engine tick; returns False when nothing could progress (the
        caller should jump the clock to the next arrival)."""
        if self.dead:
            return False
        tick = self.steps
        if self.chaos is not None and not self._fail_fired:
            fail_tick = self.chaos.fails_at(self.peer_id)
            if fail_tick is not None and tick >= fail_tick:
                # a permanent failure fires once: the tick counter keeps
                # counting after a revival, and must not kill it again
                self._fail_fired = True
                self.die()
                return False
        t0 = self.now_ms
        self._intake()
        admitted_tokens = self._admit()
        newly = {s for s, sl in self.slots.items()
                 if sl.record.admitted_ms == self.now_ms}
        ctx_rows = self._decode_tick()
        decoded = ctx_rows > 0
        if admitted_tokens == 0 and not decoded:
            # single-token requests can still finish on prefill alone
            self._evict(self.now_ms)
            return False
        cost = (self.config.step_overhead_ms
                + self.config.prefill_ms_per_token * admitted_tokens
                + (self._decode_cost_ms() if decoded else 0.0))
        slow_mult = 1.0
        if self.chaos is not None:
            slow_mult = self.chaos.slowdown(self.peer_id, tick)
            cost *= slow_mult
            if self.health is not None:
                # the health signal is the observed / clean cost ratio
                self.health.observe(slow_mult)
        self.now_ms += cost
        # first-token times are read off before _evict pops any
        # single-step slot out of the slot table
        new_ttfts: List[float] = []
        for s in newly:
            rec = self.slots[s].record
            rec.first_token_ms = self.now_ms
            if rec.ttft_ms is not None:
                new_ttfts.append(rec.ttft_ms)
        self._evict(self.now_ms)
        self.steps += 1
        self.peak_utilization = max(self.peak_utilization,
                                    self.pool.utilization())
        if self.config.defrag_every and \
                self.steps % self.config.defrag_every == 0:
            self._defrag()
        if self.tracer is not None:
            self._trace_tick(t0, tick, admitted_tokens, ctx_rows)
        if self.metrics is not None:
            self._record_tick(cost, slow_mult, new_ttfts, admitted_tokens,
                              ctx_rows)
        if self.chaos is not None:
            pause = self.chaos.pause_ms(self.peer_id, tick)
            if pause > 0:
                # preemption: the clock jumps past the pause, slots stay
                # frozen, the router sees offline_until_ms
                self.offline_until_ms = self.now_ms + pause
                if self.tracer is not None:
                    self.tracer.instant("preempt", self.now_ms, pid=self._pid,
                                        cat="chaos", args={"pause_ms": pause})
                    self.tracer.complete("preempted", self.now_ms,
                                         self.offline_until_ms,
                                         pid=self._pid, cat="chaos")
                if self.watch is not None:
                    self.watch.note_fault(
                        "preempt", self.now_ms,
                        {"peer": self.peer_id, "pause_ms": pause,
                         "live_rids": self._live_rids()})
                self.now_ms = self.offline_until_ms
                self.preemptions_hit += 1
        if self.watch is not None:
            self.watch.evaluate(self.now_ms)
        return True

    # ---- observability (the reference's events, names and values) ----------
    def _live_rids(self) -> List[int]:
        return sorted(sl.record.request.rid for sl in self.slots.values())

    def _trace_tick(self, t0: float, tick: int, admitted_tokens: int,
                    ctx_rows: int) -> None:
        self.tracer.complete(
            "tick", t0, self.now_ms, pid=self._pid, cat="engine",
            args={"tick": tick, "admitted_tokens": admitted_tokens,
                  "live_slots": len(self.slots), "queued": len(self.waiting)})
        self.tracer.counter(
            "kv_pool", self.now_ms,
            {"utilization": round(self.pool.utilization(), 6),
             "kv_bytes_written": self.kv_bytes_written}, pid=self._pid)
        if ctx_rows:
            self.tracer.counter(
                "decode_analytic", self.now_ms,
                {"hbm_bytes": ctx_rows * self._kv_bytes_per_token,
                 "flops": ctx_rows * self._flops_per_ctx_row}, pid=self._pid)

    def _record_tick(self, cost: float, slow_mult: float,
                     new_ttfts: List[float], admitted_tokens: int,
                     ctx_rows: int) -> None:
        m = self.metrics
        m.histogram("fleet/tick_cost_ms").observe(cost)
        m.gauge("fleet/kv_utilization").set(round(self.pool.utilization(), 6))
        for ttft in new_ttfts:
            m.histogram("fleet/ttft_live_ms").observe(ttft)
        if self.chaos is not None:
            # the live straggler signal: observed / clean tick-cost ratio
            m.gauge("fleet/slowdown").set(slow_mult)
        if admitted_tokens:
            m.counter("fleet/prefill_tokens").inc(admitted_tokens)
        if ctx_rows:
            m.counter("fleet/decode_ctx_rows").inc(ctx_rows)
            m.counter("fleet/analytic_hbm_bytes").inc(
                ctx_rows * self._kv_bytes_per_token)
            m.counter("fleet/analytic_flops").inc(
                ctx_rows * self._flops_per_ctx_row)

    def advance_to(self, t_ms: float) -> None:
        """Run ticks until the clock reaches ``t_ms`` (or work runs dry, in
        which case the clock jumps forward — idle time is free). A dead
        engine only follows the clock."""
        while self.now_ms < t_ms:
            if not self.step():
                if self.dead:
                    self.now_ms = t_ms
                    break
                nxt = self.next_arrival_ms()
                self.now_ms = t_ms if nxt is None else min(
                    t_ms, max(nxt, self.now_ms))
                if nxt is None or nxt > t_ms:
                    break

    def drain(self) -> None:
        while self.slots or self.waiting or self.pending:
            if not self.step():
                if self.dead:
                    break            # the router harvests what is left
                nxt = self.next_arrival_ms()
                if nxt is None:
                    break
                self.now_ms = max(self.now_ms, nxt)

    # ---- chaos lifecycle (not reached on the clean path) --------------------
    def die(self) -> None:
        """Permanent failure: the KV state is gone; records stay attached so
        the router can harvest in-flight work for migration."""
        self.dead = True
        self.died_at_ms = self.now_ms
        if self.tracer is not None:
            self.tracer.instant("die", self.now_ms, pid=self._pid,
                                cat="chaos")
        if self.watch is not None:
            self.watch.note_fault("fail", self.now_ms,
                                  {"peer": self.peer_id,
                                   "live_rids": self._live_rids()})

    def revive(self, t_ms: float, params: Optional[PyTree] = None,
               version: Optional[int] = None) -> None:
        """Rejoin after a permanent failure, from recovered weights. The
        router must have harvested the dead engine first: reviving with
        live slots would resurrect stale KV state."""
        if not self.dead:
            raise RuntimeError("revive() on a live engine")
        if self.slots or self.waiting:
            raise RuntimeError("revive() before harvest(): in-flight work "
                               "would be resurrected")
        self.dead = False
        self.died_at_ms = None
        self.offline_until_ms = 0.0
        self.now_ms = max(self.now_ms, t_ms)
        if params is not None:
            self.set_params(params)
            if version is not None:
                self.weights_version = version
        if self.tracer is not None:
            self.tracer.instant("revive", self.now_ms, pid=self._pid,
                                cat="chaos")

    def harvest(self) -> List[RequestRecord]:
        """Strip every unfinished request (live slots, queued, future) for
        re-routing, freeing their blocks. Deterministic order: slots by slot
        id, then the waiting queue, then pending arrivals."""
        out: List[RequestRecord] = []
        for s in sorted(self.slots):
            sl = self.slots.pop(s)
            self.pool.free_slot(s)
            out.append(sl.record)
        out.extend(self.waiting)
        self.waiting.clear()
        out.extend(self.pending)
        self.pending.clear()
        for rec in out:
            rec.cancelled = True
        return out

    def cancel(self, rec: RequestRecord) -> None:
        """Remove one request wherever it sits (hedge loser / migration), by
        identity: two copies of one hedged request compare equal by value
        and must not alias."""
        self.pending = deque(r for r in self.pending if r is not rec)
        self.waiting = deque(r for r in self.waiting if r is not rec)
        for s, sl in list(self.slots.items()):
            if sl.record is rec:
                del self.slots[s]
                self.pool.free_slot(s)
        rec.cancelled = True
