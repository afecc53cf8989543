"""Host training loop: metric logging, plan-driven variant dispatch, comm
event/byte accounting, eval, and the Fig.-7 parameter-distance probe.

Strategy-agnostic, as the reference's: ``strategy.plan(k)`` picks the step
variant and says when an exchange happens, the strategy's
``host_exchange`` does any host-side communication (the checkpoint-mode
stale refresh, inside ``StepBundle.apply``), ``strategy.comm_bytes`` prices
each exchange event. The tracer / metrics / watch hooks of the reference are
the observability port's (ROADMAP Queue 1 item 11): here they must be None.
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
                    f"{HISTORY_SCHEMA_VERSION})")
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
    from a ``torch.Generator`` seeded with ``tc.seed`` on ``device``."""
    if tracer is not None or metrics is not None or watch is not None:
        raise NotImplementedError(
            "tracer / metrics / watch hooks come with the observability port "
            "(ROADMAP Queue 1 item 11)")
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
    for k in range(tc.total_steps):
        batch = example if k == 0 else _to_device(batches(k), dev)
        state, metrics, plan = bundle.apply(state, batch, k)
        if plan.exchange:
            comm_events += 1
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
