"""Host training loop: metric logging, plan-driven variant dispatch, comm
event/byte accounting, eval, and the Fig.-7 parameter-distance probe.

Strategy-agnostic, as the reference's: ``strategy.plan(k)`` picks the step
variant and says when an exchange happens, the strategy's
``host_exchange`` does any host-side communication (the checkpoint-mode
stale refresh, inside ``StepBundle.apply``), ``strategy.comm_bytes`` prices
each exchange event. The reference's observability hooks run on the step
clock (one step renders as 1 ms): a ``step`` span a step, an ``exchange``
marker, the ``comm`` counter and the ``train/*`` metrics at the log points,
and a Watchtower evaluated there. They read only what ``History`` already
logged, so they add no host sync.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import CodistConfig, TrainConfig
from repro_torch.core.codistillation import param_distance_from
from repro_torch.train.engine import (AllReduce, ExchangeStrategy,
                                      build_train_step, resolve_strategy)
from repro_torch.tree import tree_map

PyTree = Any

# History JSONL schema (the reference's): a header line
# {"schema_version": 1}, then one record per line
HISTORY_SCHEMA_VERSION = 1


@dataclass
class History:
    records: List[Dict[str, float]] = field(default_factory=list)

    def log(self, step: int, metrics: Dict[str, Any], **extra):
        rec = {"step": step}
        for k, v in metrics.items():
            try:
                arr = torch.as_tensor(v).detach().cpu().double()
            except (TypeError, ValueError, RuntimeError):
                continue
            if arr.dim() == 0:
                rec[k] = float(arr)
            else:
                for i, x in enumerate(arr.reshape(-1).tolist()):
                    rec[f"{k}_{i}"] = float(x)
        rec.update(extra)
        self.records.append(rec)

    def last(self, key: str) -> float:
        for rec in reversed(self.records):
            if key in rec:
                return rec[key]
        raise KeyError(key)

    def series(self, key: str) -> List[float]:
        return [r[key] for r in self.records if key in r]

    def save(self, path: str) -> None:
        """JSONL: a ``{"schema_version": N}`` header line, then one record
        per line."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps({"schema_version": HISTORY_SCHEMA_VERSION})
                    + "\n")
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    @classmethod
    def load(cls, path: str) -> "History":
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        if rows and "schema_version" in rows[0] and "step" not in rows[0]:
            version = rows[0]["schema_version"]
            if version != HISTORY_SCHEMA_VERSION:
                raise ValueError(
                    f"{path}: History schema_version {version} is not "
                    f"supported by this reader (expects "
                    f"{HISTORY_SCHEMA_VERSION}). Re-generate the JSONL with "
                    "this version of the repo, or load it with the matching "
                    "older version.")
            rows = rows[1:]
        return cls(rows)


def _to_device(batch: Dict, dev: torch.device) -> Dict:
    return {k: v.to(dev) for k, v in batch.items()}


def train(model, tc: TrainConfig, batches: Callable[[int], Dict],
          strategy: ExchangeStrategy, codist: Optional[CodistConfig] = None,
          eval_batches: Optional[Callable[[int], Dict]] = None,
          eval_every: int = 0, log_every: int = 10,
          state=None, trainable: Optional[PyTree] = None,
          track_param_distance: bool = False,
          tracer=None, metrics=None, watch=None, device="cuda") -> tuple:
    """Strategy-driven loop. ``batches(step)`` returns the batch of that step
    (with a leading n axis for codist strategies); batches are moved to
    ``device`` (or to the given ``state``'s device). A new state is drawn
    from a ``torch.Generator`` seeded with ``tc.seed`` on ``device``.

    ``tracer`` / ``metrics`` are optional ``repro_torch.obs`` hooks on the
    step clock: per-step spans with exchange markers and comm counters.
    ``watch`` is an optional Watchtower on the same clock, evaluated at each
    log point against the live ``train/task_loss`` gauge."""
    from repro_torch.optim import make_optimizer
    opt_init, _ = make_optimizer(tc.optimizer, momentum=tc.momentum,
                                 b1=tc.adam_b1, b2=tc.adam_b2,
                                 dtype=tc.opt_dtype)
    if state is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(tc.seed)
    else:
        from repro_torch.tree import tree_leaves
        dev = tree_leaves(state.params)[0].device
    example = _to_device(batches(0), dev)
    if state is None:
        state = strategy.init_state(model, tc, gen, opt_init, example,
                                    device=dev)
    else:
        state = strategy.ensure_state(state, model, tc, example)
    bundle = build_train_step(model, tc, codist, strategy, trainable)
    eval_fn = bundle.eval_fn
    params0 = (tree_map(lambda p: p.detach().clone(), state.params)
               if track_param_distance else None)
    bytes_per_event = strategy.comm_bytes(model, state, example, tc.microbatch)
    hist = History()
    comm_events = 0
    mreg = metrics                   # the obs registry; the loop's local
    del metrics                      # ``metrics`` name is the step's dict
    if tracer is not None:
        tracer.name_process(0, "train")
        tracer.name_thread(0, 0, strategy.__class__.__name__)
    for k in range(tc.total_steps):
        batch = example if k == 0 else _to_device(batches(k), dev)
        state, metrics, plan = bundle.apply(state, batch, k)
        if plan.exchange:
            comm_events += 1
        if tracer is not None:
            tracer.complete("step", k, k + 1, cat="train",
                            args={"step": k, "exchange": bool(plan.exchange)})
            if plan.exchange:
                tracer.instant("exchange", k, cat="train")
        if k % log_every == 0 or k == tc.total_steps - 1:
            extra = {"comm_events": comm_events,
                     "comm_bytes": comm_events * bytes_per_event}
            if track_param_distance:
                extra["param_distance"] = float(
                    param_distance_from(state.params, params0))
            if eval_every and eval_batches is not None and (
                    k % eval_every == 0 or k == tc.total_steps - 1):
                metrics = {**metrics, **eval_fn(
                    state.params, _to_device(eval_batches(k), dev))}
            hist.log(k, metrics, **extra)
            if tracer is not None:
                tracer.counter("comm", k, {"events": comm_events,
                                           "bytes": extra["comm_bytes"]})
            if mreg is not None:
                # the live loss stream for alert rules, from the record just
                # logged: "task_loss", or one "task_loss_<i>" a peer,
                # averaged into one gauge
                rec = hist.records[-1]
                losses = [v for name, v in sorted(rec.items())
                          if name == "task_loss"
                          or name.startswith("task_loss_")]
                if losses:
                    mreg.gauge("train/task_loss").set(
                        sum(losses) / len(losses))
            if watch is not None:
                watch.evaluate(k)
    if mreg is not None:
        mreg.counter("train/comm_events").inc(comm_events)
        mreg.counter("train/comm_bytes").inc(comm_events * bytes_per_event)
        mreg.gauge("train/steps").set(tc.total_steps)
        try:
            mreg.gauge("train/final_task_loss").set(hist.last("task_loss"))
        except KeyError:
            pass
    return state, hist


def train_allreduce(model, tc: TrainConfig, batches: Iterator[Dict],
                    eval_batches: Optional[Callable[[int], Dict]] = None,
                    eval_every: int = 0, log_every: int = 10,
                    state=None, trainable: Optional[PyTree] = None,
                    track_param_distance: bool = False,
                    tracer=None, metrics=None, watch=None,
                    device="cuda") -> tuple:
    it = iter(batches)
    return train(model, tc, lambda k: next(it), AllReduce(),
                 eval_batches=eval_batches, eval_every=eval_every,
                 log_every=log_every, state=state, trainable=trainable,
                 track_param_distance=track_param_distance,
                 tracer=tracer, metrics=metrics, watch=watch, device=device)


def train_codist(model, codist: CodistConfig, tc: TrainConfig,
                 batches: Callable[[int], Dict],
                 eval_batches: Optional[Callable[[int], Dict]] = None,
                 eval_every: int = 0, log_every: int = 10,
                 state=None, trainable: Optional[PyTree] = None,
                 track_param_distance: bool = False,
                 strategy: Optional[ExchangeStrategy] = None,
                 tracer=None, metrics=None, watch=None,
                 device="cuda") -> tuple:
    """Codistillation loop; the mechanism comes from ``strategy`` or
    ``resolve_strategy(codist)``."""
    strategy = strategy if strategy is not None else resolve_strategy(codist)
    return train(model, tc, batches, strategy, codist=codist,
                 eval_batches=eval_batches, eval_every=eval_every,
                 log_every=log_every, state=state, trainable=trainable,
                 track_param_distance=track_param_distance,
                 tracer=tracer, metrics=metrics, watch=watch, device=device)


def stack_batches(batch_list: List[Dict]) -> Dict:
    """[batch_i] -> one dict with a leading n axis."""
    return {k: torch.stack([b[k] for b in batch_list])
            for k in batch_list[0]}
