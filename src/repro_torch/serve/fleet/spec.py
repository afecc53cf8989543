"""Peer-speculative decoding: the fleet drafts for itself.

Codistilled peers converge to near-identical functions, which is what
speculative decoding wants in a draft model. ``SpecEngine`` turns that into
serving speed: a DRAFT peer (by default another replica, ring paired; or a
dedicated peer, or a smaller student model) proposes ``k`` tokens one by one
into a mirrored draft KV pool, and the target peer verifies all ``k`` in ONE
batched forward over its paged pool (``model_exec.build_verify_step``: each
slot expands into k pseudo-slots at per-slot vector positions).

Accept / reject is greedy at temperature 0: position j's verify logits
condition only on the prompt and the drafts ``< j`` (the decode's causal
mask), so the target's argmax at j is the token plain decode would emit
there. The engine accepts the longest matching draft prefix, emits the
target's own token at the first divergence, and restores the rejected
suffix rows of BOTH pools from an undo log (``PagedCachePool.snapshot_rows``
/ ``restore_rows``), so after any round the pools hold what a never-drafted
run's hold. No bonus token on a full accept (at most k tokens a round): the
k+1'th would leave the draft pool a row behind.

On the card the verify and plain decode round alike where their shapes let
them: the verify's decode launch takes the plain tick's split plan, but its
GEMMs run at M = S*k rows, not S; in fp32 with TF32 off the streams agree.

Chaos: a round runs speculatively only when the draft partner is available
(alive, not preempted) and every live slot's draft pool is current. A
plain-decode fallback tick marks every live slot draft-dirty (its draft
pool missed a row), so after an outage the engine decodes plain until the
in-flight slots drain, then speculates again on fresh admissions.

The accept rate is a live codistillation-quality signal (how often the
peers' argmaxes agree on real traffic): ``FleetReport.spec_accept_rate``,
and with a registry the ``fleet/spec_accept`` histogram and the running
``fleet/spec_accept_rate`` gauge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.serve.fleet.batcher import (REQUEST_PID, FleetConfig,
                                             FleetEngine)
from repro_torch.serve.fleet.cache import PagedCachePool
from repro_torch.serve.fleet.model_exec import (build_decode_step,
                                                build_verify_step)

PyTree = Any


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs.

    Simulated cost model: a speculative round costs
    ``k * draft_ms_per_token + verify_ms`` instead of
    ``decode_ms_per_step`` and emits up to k tokens. ``verify_ms`` None
    charges exactly ``decode_ms_per_step``. ``draft_peer`` None ring-pairs
    every peer with its neighbour (all peers serve); an int dedicates that
    peer to drafting (out of the serving rotation).
    """
    k: int = 4
    draft_ms_per_token: float = 0.25
    verify_ms: Optional[float] = None
    draft_peer: Optional[int] = None


@dataclass
class SpecStats:
    """Deterministic per-engine speculation counters (summed per report)."""
    rounds: int = 0
    drafted: int = 0          # k per live slot per speculative round
    accepted: int = 0         # matching draft prefix length
    fallback_ticks: int = 0   # decode ticks that ran plain


class SpecEngine(FleetEngine):
    """A FleetEngine whose decode tick speculates: k draft steps on the
    partner's weights against a mirrored draft pool, one batched k-token
    verify on its own, greedy accept / reject-and-resample. Attention-only
    models (``build_verify_step`` raises on the others)."""

    def __init__(self, model, params: PyTree, config: FleetConfig,
                 spec: SpecConfig, cache_dtype=torch.float32,
                 keep_logits: bool = False, device="cuda", peer_id: int = 0,
                 draft_model=None, draft_params: PyTree = None,
                 tracer=None, metrics=None):
        super().__init__(model, params, config, cache_dtype=cache_dtype,
                         keep_logits=keep_logits, device=device,
                         peer_id=peer_id, tracer=tracer, metrics=metrics)
        self.spec = spec
        self.spec_stats = SpecStats()
        self.partner: Optional[FleetEngine] = None   # ring / dedicated
        self._draft_model = draft_model or model
        self._draft_params_static = draft_params     # student mode when set
        # fails at construction on a recurrent model, not mid-round
        self._verify = build_verify_step(model, spec.k,
                                         config.fused_attention)
        self._draft_decode = build_decode_step(self._draft_model,
                                               config.fused_attention)
        self.draft_pool = PagedCachePool(
            self._draft_model, max_slots=config.max_slots,
            block_size=config.block_size, num_blocks=config.num_blocks,
            max_blocks_per_slot=config.max_blocks_per_slot,
            cache_dtype=cache_dtype, device=self.device)
        dcfg = self._draft_model.cfg
        n_attn = len(self.draft_pool.kv_subs) * self.draft_pool.n_scan
        per_row = (dcfg.num_kv_heads * dcfg.resolved_head_dim
                   * cache_dtype.itemsize)
        if self.draft_pool.quantized:
            per_row += 4
        self._draft_kv_bytes_per_token = int(n_attn * 2 * per_row)
        self._verify_ms = (spec.verify_ms if spec.verify_ms is not None
                           else config.decode_ms_per_step)
        self._draft_dirty: set = set()
        self._last_spec = False

    # ---- pairing -----------------------------------------------------------
    def set_partner(self, engine: FleetEngine) -> None:
        self.partner = engine

    def _partner_available(self) -> bool:
        if self._draft_params_static is not None:
            return True              # static student: always on this host
        p = self.partner
        return (p is not None and not p.dead
                and p.offline_until_ms <= self.now_ms)

    def _draft_params(self) -> PyTree:
        if self._draft_params_static is not None:
            return self._draft_params_static
        return self.partner.params   # read at draft time: refresh-current

    # ---- lifecycle sync: the draft pool mirrors the target pool ------------
    def _admit(self) -> int:
        before = set(self.slots)
        admitted_tokens = super()._admit()
        for s in sorted(set(self.slots) - before):
            req = self.slots[s].record.request
            # mirror the reservation even when the partner is down, so the
            # draft pool's block sequence stays deterministic
            self.draft_pool.allocate(s, req.prompt_len + req.max_new)
            if self._partner_available():
                tokens = torch.as_tensor(req.prompt, dtype=torch.long,
                                         device=self.device)[None, :]
                _, dcache = self._draft_model.prefill(
                    self._draft_params(), tokens, req.prompt_len,
                    cache_dtype=self._prefill_dtype)
                self.draft_pool.insert_prefill(s, dcache, req.prompt_len)
                self.kv_bytes_written += (req.prompt_len
                                          * self._draft_kv_bytes_per_token)
            else:
                self._draft_dirty.add(s)
        return admitted_tokens

    def _sync_draft_free(self) -> None:
        for s in range(self.config.max_slots):
            if s not in self.slots and self.draft_pool.slot_blocks[s]:
                self.draft_pool.free_slot(s)
                self._draft_dirty.discard(s)

    def _evict(self, finish_ms: float) -> None:
        super()._evict(finish_ms)
        self._sync_draft_free()

    def harvest(self) -> List:
        out = super().harvest()
        self._sync_draft_free()
        return out

    def cancel(self, rec) -> None:
        super().cancel(rec)
        self._sync_draft_free()

    def _defrag(self) -> None:
        super()._defrag()
        self.draft_pool.defrag()

    # ---- the speculative decode tick ---------------------------------------
    def _decode_cost_ms(self) -> float:
        if self._last_spec:
            return self._verify_ms + self.spec.k * self.spec.draft_ms_per_token
        return self.config.decode_ms_per_step

    def _decode_tick(self) -> int:
        live = sorted(s for s, sl in self.slots.items() if sl.remaining > 0)
        if not live:
            return 0
        if (not self._partner_available()
                or any(s in self._draft_dirty for s in live)):
            # plain fallback: every live slot's draft pool misses this row
            self._last_spec = False
            self._draft_dirty.update(live)
            self.spec_stats.fallback_ticks += 1
            if self.metrics is not None:
                self.metrics.counter("fleet/spec_fallback_ticks").inc()
            return super()._decode_tick()
        self._last_spec = True
        return self._spec_round(live)

    def _spec_round(self, live: List[int]) -> int:
        k = self.spec.k
        S = self.config.max_slots
        dev = self.device
        active = np.zeros((S,), bool)
        active[live] = True
        base_len = self.pool.lengths.copy()

        def t(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        # --- draft: k one-token steps on the partner's weights against the
        # mirrored draft pool (undo log first)
        d_snaps = {s: self.draft_pool.snapshot_rows(s, int(base_len[s]), k)
                   for s in live}
        d_wslots, d_woffs = self.draft_pool.write_maps_k(active, k)
        dparams = self._draft_params()
        dtable = t(self.draft_pool.table)
        tok = np.zeros((S, 1), np.int64)
        for s in live:
            tok[s, 0] = self.slots[s].next_token
        drafts = np.zeros((S, k), np.int64)
        verify_in = np.zeros((S, k), np.int64)
        for j in range(k):
            verify_in[:, j] = tok[:, 0]
            logits = self._draft_decode(
                dparams, self.draft_pool.kv, dtable,
                t(self.draft_pool.lengths + j), t(d_wslots[j]),
                t(d_woffs[j]), t(tok), self.draft_pool.states)
            drafts[:, j] = torch.argmax(logits, dim=-1).cpu().numpy()
            tok = drafts[:, j:j + 1]

        # --- verify: ONE batched k-token forward on the target pool
        t_snaps = {s: self.pool.snapshot_rows(s, int(base_len[s]), k)
                   for s in live}
        wslots, woffs = self.pool.write_maps_k(active, k)
        vlogits = self._verify(self.params, self.pool.kv, t(self.pool.table),
                               t(base_len), t(wslots), t(woffs),
                               t(verify_in))
        greedy = torch.argmax(vlogits, dim=-1).cpu().numpy()    # (S, k)

        # --- accept the matching prefix, resample the divergence, roll back
        ctx_rows = 0
        total_m = 0
        for s in live:
            sl = self.slots[s]
            m = 0
            while m < k and drafts[s, m] == greedy[s, m]:
                m += 1
            stream = [int(x) for x in drafts[s, :m]]
            if m < k:
                stream.append(int(greedy[s, m]))
            e = min(sl.remaining, len(stream))
            if e < k:
                self.pool.restore_rows(t_snaps[s], start=e)
                self.draft_pool.restore_rows(d_snaps[s], start=e)
            sl.record.tokens.extend(stream[:e])
            sl.next_token = stream[e - 1]
            sl.remaining -= e
            self.pool.lengths[s] += e
            self.draft_pool.lengths[s] = self.pool.lengths[s]
            self.kv_bytes_written += e * (self._kv_bytes_per_token
                                          + self._draft_kv_bytes_per_token)
            ctx_rows += sum(int(base_len[s]) + j + 1 for j in range(k))
            total_m += m
            self.spec_stats.drafted += k
            self.spec_stats.accepted += m
            if self.metrics is not None:
                self.metrics.histogram("fleet/spec_accept").observe(float(m))
            if self.tracer is not None and sl.record.traced:
                self.tracer.instant(
                    "spec_round", self.now_ms, pid=REQUEST_PID,
                    tid=sl.record.request.rid, cat="request",
                    args={"accepted": m, "drafted": k})
        self.spec_stats.rounds += 1
        if self.metrics is not None:
            self._record_round(k, len(live), total_m)
        if self.tracer is not None:
            self._trace_round(k, len(live), total_m)
        return ctx_rows

    def _record_round(self, k: int, n_live: int, total_m: int) -> None:
        m = self.metrics
        m.counter("fleet/spec_rounds").inc()
        m.counter("fleet/spec_drafted_tokens").inc(k * n_live)
        m.counter("fleet/spec_accepted_tokens").inc(total_m)
        # this engine's running accept rate: the live view of the quality
        # canary the accept-collapse rule watches
        m.gauge("fleet/spec_accept_rate").set(
            round(self.spec_stats.accepted
                  / max(1, self.spec_stats.drafted), 6))

    def _trace_round(self, k: int, n_live: int, total_m: int) -> None:
        # the round's draft and verify spans on the simulated clock, the
        # reference's expressions term for term
        d0 = self.now_ms
        d1 = d0 + k * self.spec.draft_ms_per_token
        self.tracer.complete(
            "draft", d0, d1, pid=self._pid, cat="spec",
            args={"k": k, "slots": n_live,
                  "draft_peer": (self.partner.peer_id
                                 if self.partner is not None else -1)})
        self.tracer.complete(
            "verify", d1, d1 + self._verify_ms, pid=self._pid, cat="spec",
            args={"accepted": total_m, "drafted": k * n_live})
