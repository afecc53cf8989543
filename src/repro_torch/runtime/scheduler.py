"""Event-driven scheduler for the asynchronous codistillation runtime.

``AsyncScheduler`` runs N codistilling peers on **independent step clocks**
over one simulated timeline (:mod:`repro_torch.runtime.clock`): at every
tick the set of peers whose clocks are ready (1) publishes its predictions
for the coordinated batch into the :class:`~repro_torch.runtime.mailbox.
Mailbox`, then (2) steps its model with whatever peer payloads the
staleness policy accepts. No peer ever waits for another — a straggler or
preempted peer only degrades the freshness of the targets it feeds the
others (Anil et al., arXiv:1804.03235). Equal-speed fault-free peers tie at
every tick and the publish-then-step order makes staleness 0, so
``staleness_bound=0`` reproduces the synchronous ``PredictionExchange``
trajectory.

``simulate_allreduce`` is the barrier baseline on the same fault schedule:
one data-parallel model whose per-step time is the MAX over the virtual
peers, preemptions stall the whole job, and a permanent failure costs a
restart-from-checkpoint stall.

The reference's scheduler, on the card: every peer's state, the published
wires and the operands live on ``device``; the host holds the clock, the
mailbox's bookkeeping and the histories. Its observability hooks are the
reference's, on the virtual cluster clock (simulated seconds): per-peer
``step`` and ``preempted`` spans, join / recover / die / publish markers,
the mailbox's comm counter, the ``runtime/*`` metrics with live mailbox
staleness gauges, and a Watchtower evaluated once a scheduler round. They
read only host state.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import CodistConfig, TrainConfig
from repro_torch.core.codistillation import compress_targets, init_stacked
from repro_torch.core.exchange import StepPlan
from repro_torch.optim import make_optimizer
from repro_torch.runtime.clock import FaultConfig, FaultSchedule, VirtualClock
from repro_torch.runtime.mailbox import Mailbox
from repro_torch.runtime.peer import PeerRuntime
from repro_torch.train.engine import (AllReduce, AsyncPrediction,
                                      _task_forward, build_train_step)
from repro_torch.train.loop import History
from repro_torch.train.state import TrainState, trainable_params
from repro_torch.tree import tree_map

PyTree = Any
Batches = Callable[[int], Dict]

def join_seed(seed: int, pid: int) -> int:
    """The generator seed of elastic joiner ``pid``'s init (the reference
    folds ``1000 + pid`` into its key): distinct per (seed, pid), and never
    ``seed`` itself, which the initial peers' generator takes."""
    return (seed * 1_000_003 + 1000 + pid) % (2 ** 63)


def _to_device(batch: Dict, dev: torch.device) -> Dict:
    return {k: v.to(dev) for k, v in batch.items()}


@dataclass
class RunReport:
    """What a simulated run produced, for benchmarks and tests."""
    scheme: str
    sim_time: float                       # last surviving peer's finish time
    time_to_first: float                  # earliest deployable model
    completion: Dict[int, float]          # peer -> finish time
    comm_events: int
    comm_bytes: float
    staleness: Dict[str, float] = field(default_factory=dict)
    final_task_loss: Dict[int, float] = field(default_factory=dict)
    histories: Dict[int, History] = field(default_factory=dict)
    states: Dict[int, Any] = field(default_factory=dict)

    def save_histories(self, directory: str) -> None:
        for pid, hist in self.histories.items():
            hist.save(os.path.join(directory, f"peer{pid}.jsonl"))


class AsyncScheduler:
    """Drive one ``AsyncPrediction`` step bundle per peer on independent
    clocks. ``batches(step)`` is the coordinated batch of a local step
    (moved to ``device``)."""

    def __init__(self, model, tc: TrainConfig, codist: CodistConfig,
                 batches: Batches, faults: FaultConfig, *,
                 staleness_bound: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 recover_after: Optional[float] = None,
                 join_burn_in: int = 0,
                 log_every: int = 1,
                 max_sim_time: float = float("inf"),
                 tracer=None, metrics=None, watch=None, device="cuda"):
        self.model, self.tc, self.codist = model, tc, codist
        self.device = resolve_device(device)
        # observability on the virtual cluster clock (None: untouched)
        self.tracer = tracer
        self.metrics = metrics
        self.watch = watch
        self.batches = batches
        self.faults = faults
        self.schedule = FaultSchedule(faults, tc.total_steps)
        self.mailbox = Mailbox(staleness_bound)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.recover_after = recover_after
        self.join_burn_in = join_burn_in or codist.burn_in_steps
        self.log_every = max(1, log_every)
        self.max_sim_time = max_sim_time

        n_slots = max(codist.n_models, faults.n_total)
        self.strategy = AsyncPrediction(codist, n_slots=n_slots)
        self.bundle = build_train_step(model, tc, codist, self.strategy)
        self._pred_cfg = replace(codist, mode="predictions")
        self._opt_init, _ = make_optimizer(tc.optimizer, momentum=tc.momentum,
                                           b1=tc.adam_b1, b2=tc.adam_b2,
                                           dtype=tc.opt_dtype)
        self.peers: Dict[int, PeerRuntime] = {
            p: PeerRuntime(p, self._state(params))
            for p, params in enumerate(self._init_params())}
        if tracer is not None:
            for p in self.peers:
                tracer.name_process(p, f"peer{p}")

        # the wire's shape and dtypes, from a forward's logits shape on the
        # meta device (the reference's eval_shape); one zero wire fills
        # every absent slot and is never written
        example = self._batch(0)
        logits = torch.empty(tuple(example["tokens"].shape)
                             + (model.cfg.padded_vocab,),
                             dtype=torch.float32, device="meta")
        self._zero_wire = tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=self.device),
            compress_targets(codist, logits))
        n_targets = n_slots - 1
        self._zero_vec = torch.zeros((n_targets,), dtype=torch.float32,
                                     device=self.device)
        self.comm_events = 0
        self._failed_once: set = set()  # a machine dies once; the recovered
        # replacement replays through the failure step unharmed

    # ---- init (also the tests' seam for injecting the reference's params) --
    def _init_params(self) -> List[PyTree]:
        """The initial peers' params: one draw of n trees from a generator
        seeded with ``tc.seed`` on the device, exactly as
        ``PredictionExchange.init_state`` draws them, so that
        ``staleness_bound=0`` parity holds down to the bits."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.tc.seed)
        return init_stacked(self.model.init, gen, self.faults.n_peers,
                            device=self.device)

    def _join_params(self, pid: int) -> PyTree:
        """An elastic joiner's params, from a generator seeded with
        ``join_seed(tc.seed, pid)``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(join_seed(self.tc.seed, pid))
        return self.model.init(gen, device=self.device)

    def _state(self, params: PyTree) -> TrainState:
        params = trainable_params(params)
        return TrainState(params, self._opt_init(params), 0)

    def _batch(self, step: int) -> Dict:
        return _to_device(self.batches(step), self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _publish(self, params: PyTree, batch: Dict) -> Dict:
        """The wire a peer posts: its forward's logits, cast to fp32 and
        compressed HERE, on the producer side — the mailbox carries (and
        meters) what would cross the slow links. With gradient
        accumulation the batch leads with the microbatch axis, and so does
        the wire. (Rematerialization is moot without gradients.)"""
        k = max(1, self.tc.microbatch)
        if k > 1:
            logits = torch.stack([
                _task_forward(self.model, params,
                              {n: v[j] for n, v in batch.items()}, False)[0]
                for j in range(k)])
        else:
            logits = _task_forward(self.model, params, batch, False)[0]
        return compress_targets(self.codist, logits.float())

    def _fresh_peer(self, pid: int, joined_at: float) -> PeerRuntime:
        return PeerRuntime(pid, self._state(self._join_params(pid)),
                           burn_in=self.join_burn_in, joined_at=joined_at)

    def _exchange_on(self, peer: PeerRuntime) -> bool:
        plan = StepPlan.for_step(self._pred_cfg, peer.step)
        return plan.distill and peer.distill_ready

    def _off_operand(self, batch: Dict) -> Dict:
        return {"batch": batch,
                "peer_wire": [self._zero_wire] * self._zero_vec.numel(),
                "peer_weight": self._zero_vec,
                "peer_staleness": self._zero_vec}

    def _gather_operand(self, peer: PeerRuntime, batch: Dict
                        ) -> Tuple[Dict, float]:
        senders = sorted(q for q, pr in self.peers.items()
                         if q != peer.pid and pr.alive)
        operand = self._off_operand(batch)
        wires = list(operand["peer_wire"])
        weights = [0.0] * len(wires)
        stale = [0.0] * len(wires)
        wsum = 0.0
        for slot, (s, payload, w) in enumerate(
                self.mailbox.collect(peer.pid, peer.step, senders)):
            if payload is not None:
                wires[slot] = payload.data
                weights[slot] = w
                stale[slot] = max(0.0, float(peer.step - payload.step))
                wsum += w
        operand.update(
            peer_wire=wires,
            peer_weight=torch.tensor(weights, dtype=torch.float32,
                                     device=self.device),
            peer_staleness=torch.tensor(stale, dtype=torch.float32,
                                        device=self.device))
        return operand, wsum

    def _step_peer(self, peer: PeerRuntime, now: float) -> float:
        """Run one local step; returns its simulated duration (incl. any
        preemption pause that follows it)."""
        step = peer.step
        batch = self._batch(step)
        variant = "off"
        operand = self._off_operand(batch)
        if self._exchange_on(peer):
            operand, wsum = self._gather_operand(peer, batch)
            if wsum > 0:
                variant = "on"
                self.comm_events += 1
        state, metrics = self.bundle.variants[variant](peer.state, operand)
        peer.advance(state)
        if step % self.log_every == 0 or peer.step >= self.tc.total_steps:
            peer.hist.log(step, metrics, sim_time=now, peer=peer.pid)
        if (self.checkpoint_dir and self.checkpoint_every
                and peer.step % self.checkpoint_every == 0):
            peer.snapshot(self.checkpoint_dir)
        dur = self.schedule.duration(peer.pid, step)
        pause = self.schedule.pause_after(peer.pid, step)
        if self.tracer is not None:
            self.tracer.complete("step", now, now + dur, pid=peer.pid,
                                 cat="runtime",
                                 args={"step": step, "variant": variant})
            if pause > 0:
                self.tracer.complete("preempted", now + dur,
                                     now + dur + pause, pid=peer.pid,
                                     cat="chaos")
        if self.metrics is not None:
            self.metrics.histogram("runtime/step_s").observe(dur)
            self.metrics.counter("runtime/steps").inc()
        return dur + pause

    # ---- observability -------------------------------------------------
    def _staleness_gauges(self) -> None:
        for k, v in self.mailbox.stats.as_dict().items():
            self.metrics.gauge(f"runtime/mailbox_staleness_{k}").set(v)

    def _observe_publish(self, p: int, step: int, t: float) -> None:
        if self.tracer is not None:
            self.tracer.instant("publish", t, pid=p, cat="runtime",
                                args={"step": step})
            self.tracer.counter(
                "mailbox", t,
                {"bytes_delivered": float(self.mailbox.bytes_delivered)})
        if self.metrics is not None:
            self.metrics.counter("runtime/publishes").inc()
            # the live staleness view for alert rules (the same names and
            # final values as the end-of-run gauges)
            self._staleness_gauges()

    # ------------------------------------------------------------------
    def run(self) -> RunReport:
        clock = VirtualClock()
        for p in self.peers:
            clock.add_peer(p)
        pending_joins: List[Tuple[int, float]] = list(self.schedule.joins)
        pending_recoveries: List[Tuple[int, float]] = []

        while True:
            # jump to pending membership events if no peer is on the clock
            if not clock.ready_at:
                upcoming = pending_joins + pending_recoveries
                if not upcoming:
                    break
                clock.now = min(t for _, t in upcoming)
            else:
                t_next = min(clock.ready_at.values())
                clock.now = max(clock.now, min(
                    [t_next] + [t for _, t in pending_joins]
                    + [t for _, t in pending_recoveries]))

            # membership: elastic joins and checkpoint recoveries due now
            for pid, jt in list(pending_joins):
                if jt <= clock.now + 1e-9:
                    pending_joins.remove((pid, jt))
                    self.peers[pid] = self._fresh_peer(pid, jt)
                    clock.add_peer(pid, at=jt)
                    if self.tracer is not None:
                        self.tracer.name_process(pid, f"peer{pid}")
                        self.tracer.instant("join", jt, pid=pid, cat="chaos")
            for pid, rt in list(pending_recoveries):
                if rt <= clock.now + 1e-9:
                    pending_recoveries.remove((pid, rt))
                    self.peers[pid].restore(self.checkpoint_dir, rt)
                    clock.add_peer(pid, at=rt)
                    if self.tracer is not None:
                        self.tracer.instant("recover", rt, pid=pid,
                                            cat="chaos")
            if not clock.ready_at:
                continue

            t, ready = clock.next_ready()
            if t > self.max_sim_time:
                break
            live = []
            for p in ready:
                peer = self.peers[p]
                fail_step = self.schedule.fails_at(p)
                if (fail_step is not None and peer.step >= fail_step
                        and p not in self._failed_once
                        and peer.alive and not peer.finished):
                    self._failed_once.add(p)
                    peer.die()
                    clock.remove_peer(p)
                    self.mailbox.drop_peer(p)
                    if self.tracer is not None:
                        self.tracer.instant("die", t, pid=p, cat="chaos")
                    if self.watch is not None:
                        self.watch.note_fault("fail", t,
                                              {"peer": p, "step": peer.step})
                    if (self.recover_after is not None
                            and peer.can_recover(self.checkpoint_dir)):
                        pending_recoveries.append(
                            (p, t + self.recover_after))
                    continue
                live.append(p)

            # phase 1: everyone ready publishes BEFORE anyone consumes, so
            # tied clocks see same-step (staleness-0) targets
            for p in live:
                peer = self.peers[p]
                if self._exchange_on(peer):
                    wire = self._publish(peer.state.params,
                                         self._batch(peer.step))
                    self.mailbox.post(p, peer.step, t, wire)
                    self._observe_publish(p, peer.step, t)
            # phase 2: step
            for p in live:
                peer = self.peers[p]
                dur = self._step_peer(peer, t)
                if peer.step >= self.tc.total_steps:
                    peer.finished = True
                    peer.completed_at = t + dur
                    clock.remove_peer(p)
                else:
                    clock.advance(p, dur)
            if self.watch is not None:
                self.watch.evaluate(t)

        if self.metrics is not None:
            m = self.metrics
            m.counter("runtime/comm_events").inc(self.comm_events)
            m.counter("runtime/comm_bytes").inc(
                int(self.mailbox.bytes_delivered))
            self._staleness_gauges()
        completion = {p: pr.completed_at for p, pr in self.peers.items()
                      if pr.completed_at is not None}
        finals = {}
        for p, pr in self.peers.items():
            try:
                finals[p] = pr.hist.last("task_loss")
            except KeyError:
                pass
        return RunReport(
            scheme="codist-async",
            sim_time=max(completion.values()) if completion else clock.now,
            time_to_first=min(completion.values()) if completion
            else float("inf"),
            completion=completion,
            comm_events=self.comm_events,
            comm_bytes=float(self.mailbox.bytes_delivered),
            staleness=self.mailbox.stats.as_dict(),
            final_task_loss=finals,
            histories={p: pr.hist for p, pr in self.peers.items()},
            states={p: pr.state for p, pr in self.peers.items()},
        )


# ----------------------------------------------------------------------------
# the barrier baseline on the same fault schedule
# ----------------------------------------------------------------------------

def simulate_allreduce(model, tc: TrainConfig, batches: Batches,
                       faults: FaultConfig, *,
                       recover_after: Optional[float] = None,
                       log_every: int = 1, device="cuda") -> RunReport:
    """Synchronous data-parallel baseline: one model, but every step's
    simulated duration is the MAX over the virtual peers (the all-reduce
    barrier waits for the slowest replica), a preemption stalls the whole
    job, and a permanent failure costs one restart stall of
    ``recover_after`` simulated seconds (restore from the last checkpoint —
    arXiv:1604.00981's backup-worker problem, without backup workers)."""
    dev = resolve_device(device)
    schedule = FaultSchedule(faults, tc.total_steps)
    strategy = AllReduce()
    bundle = build_train_step(model, tc, None, strategy)
    opt_init, _ = make_optimizer(tc.optimizer, momentum=tc.momentum,
                                 b1=tc.adam_b1, b2=tc.adam_b2,
                                 dtype=tc.opt_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(tc.seed)
    example = _to_device(batches(0), dev)
    state = strategy.init_state(model, tc, gen, opt_init, example, device=dev)
    bytes_per_step = strategy.comm_bytes(model, state, example)
    hist = History()
    now = 0.0
    peers = range(faults.n_peers)
    for k in range(tc.total_steps):
        dur = max(schedule.duration(p, k) for p in peers)
        stall = max(schedule.pause_after(p, k) for p in peers)
        for p in peers:
            if schedule.fails_at(p) == k:
                stall += recover_after if recover_after is not None else 0.0
        batch = example if k == 0 else _to_device(batches(k), dev)
        state, metrics, _ = bundle.apply(state, batch, k)
        now += dur + stall
        if k % max(1, log_every) == 0 or k == tc.total_steps - 1:
            hist.log(k, metrics, sim_time=now)
    return RunReport(
        scheme="allreduce",
        sim_time=now, time_to_first=now, completion={0: now},
        comm_events=tc.total_steps,
        comm_bytes=bytes_per_step * tc.total_steps,
        final_task_loss={0: hist.last("task_loss")},
        histories={0: hist}, states={0: state},
    )
