"""Execute sweep cells through the port's training entry points.

One cell = one training run. Synchronous modes go through the step engine
(``train_allreduce`` / ``train_codist`` -> ``build_train_step``);
``codist-async`` goes through the :class:`~repro_torch.runtime.
AsyncScheduler` on a clean (fault-free) schedule. Every cell is seeded from
its own ``cell.seed`` — model init, data stream, and fault schedule — so a
cell is a pure function of its :class:`~repro_torch.experiments.spec.Cell`
and its device, and re-running it on the CPU reproduces the trajectory
bit for bit.

Persistence is crash-safe: each cell writes its full per-step
:class:`~repro_torch.train.loop.History` as ``<cell_id>.jsonl`` FIRST, then
an atomic (write-tmp + rename) ``<cell_id>.json`` summary marked
``status: complete``. Resume (``--resume``) skips exactly the cells whose
summary exists and validates against the requested cell + step count, so a
killed sweep restarts where it died and a finished sweep is a no-op. The
files are the reference's, so each side's ``aggregate`` reads the other's
sweep directory.

Cells run on ``device`` (``"cuda"`` by default). On the card the sweep
frees the allocator's cache between cells and logs each cell's peak
memory. With ``trace`` / ``metrics`` / ``alerts`` each cell writes the
reference's observability files next to its result (sync modes on the step
clock, async on the runtime's simulated seconds), and ``alerts`` adds a
sweep-level Watchtower over the codist-vs-baseline loss gap.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.data import MarkovLM, make_lm_batch
from repro_torch.experiments.spec import (ASYNC_MODES, Cell, SweepSpec,
                                          cell_to_dict, spec_to_dict)
from repro_torch.models import build_model
from repro_torch.obs import (MetricsRegistry, Watchtower, default_rules,
                             for_sim_seconds, for_steps, load_rules)
from repro_torch.runtime import AsyncScheduler, FaultConfig
from repro_torch.train import (History, stack_batches, train_allreduce,
                               train_codist)

SCHEMA_VERSION = 1

# ----------------------------------------------------------------------------
# paths + resume validation
# ----------------------------------------------------------------------------

def sweep_dir_for(spec_name: str, out_root: str = "results/sweeps") -> str:
    return os.path.join(out_root, spec_name)


def cell_paths(sweep_dir: str, cell: Cell) -> Tuple[str, str]:
    """(summary .json, history .jsonl) for one cell."""
    return (os.path.join(sweep_dir, f"{cell.cell_id}.json"),
            os.path.join(sweep_dir, f"{cell.cell_id}.jsonl"))


def load_summary(sweep_dir: str, cell: Cell) -> Optional[Dict]:
    path, _ = cell_paths(sweep_dir, cell)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _jsonable_cell(cell: Cell) -> Dict:
    """The cell dict as it reads back from JSON (tuples become lists)."""
    return json.loads(json.dumps(cell_to_dict(cell)))


def summary_is_valid(sweep_dir: str, cell: Cell, steps: int) -> bool:
    """True iff this cell's result can be trusted and skipped on resume:
    the summary parses, is marked complete, matches the FULL requested
    cell (id alone is not enough — a spec edit that keeps axis names but
    changes their values, the arch, seq_len, or model_overrides must
    invalidate stale results) and step count, and its history file has a
    final record at the last step."""
    doc = load_summary(sweep_dir, cell)
    if (not doc or doc.get("status") != "complete"
            or doc.get("schema") != SCHEMA_VERSION
            or doc.get("cell_id") != cell.cell_id
            or doc.get("steps") != steps
            or doc.get("cell") != _jsonable_cell(cell)):
        return False
    _, hist_path = cell_paths(sweep_dir, cell)
    try:
        hist = History.load(hist_path)
        return bool(hist.records) and hist.last("step") == steps - 1
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return False


def _write_atomic(path: str, doc: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


# ----------------------------------------------------------------------------
# one cell
# ----------------------------------------------------------------------------

def _build_cell_setup(cell: Cell):
    """Model + data task for a cell (shared by the sync and async paths).
    The config is ``get_reduced(arch)`` with the spec's overrides, which
    can restore the full config (``chip_smoke.py``'s sweep does)."""
    cfg = get_reduced(cell.arch)
    if cell.overrides:
        cfg = replace(cfg, **dict(cell.overrides))
    model = build_model(cfg)
    vocab = min(cfg.vocab_size, 512)
    task = MarkovLM(vocab=vocab, seed=cell.seed,
                    effective_vocab=min(vocab, 256))
    return model, task


def _train_config(cell: Cell, steps: int) -> TrainConfig:
    return TrainConfig(
        lr=cell.lr.resolve_lr(cell.batch), lr_schedule=cell.lr.kind,
        warmup_steps=max(1, int(round(cell.lr.warmup_frac * steps))),
        total_steps=steps, optimizer=cell.optimizer, seed=cell.seed)


def _codist_config(cell: Cell, steps: int) -> CodistConfig:
    return CodistConfig(
        n_models=cell.peers,
        mode="checkpoints" if cell.mode == "codist-ckpt" else "predictions",
        pipelined=(cell.mode == "codist-pipelined"),
        distill_loss=cell.distill_loss,
        alpha0=cell.alpha.alpha0, alpha_growth=cell.alpha.growth,
        steps_per_epoch=max(1, steps // 10),
        burn_in_steps=int(round(cell.alpha.burn_in_frac * steps)))


def run_cell(cell: Cell, steps: Optional[int] = None, *,
             trace_path: Optional[str] = None,
             metrics_path: Optional[str] = None,
             alerts_path: Optional[str] = None,
             rules: Optional[List] = None, device="cuda"):
    """Train one grid cell on ``device``; returns ``(summary_dict,
    History)``.

    The summary's ``final`` block carries what the aggregator needs: final
    task loss (the paper's quality metric), accuracy, and the Section-3
    communication accounting. ``trace_path`` / ``metrics_path`` enable the
    ``repro_torch.obs`` hooks for this cell and write its Perfetto trace /
    metrics registry there (sync modes trace on the step clock, async on
    the runtime's simulated seconds); ``None`` leaves the run
    uninstrumented. ``alerts_path`` also evaluates a Watchtower (``rules``,
    or the built-in pack) over the cell's live metrics on the same clock
    and writes its alert JSONL there."""
    dev = resolve_device(device)
    steps = int(steps or cell.steps)
    model, task = _build_cell_setup(cell)
    tc = _train_config(cell, steps)
    is_async = cell.mode in ASYNC_MODES
    # alerting needs a live registry even when no metrics file is asked
    # for; the internal registry is then not written out
    metrics = (MetricsRegistry() if metrics_path or alerts_path else None)
    watch = None
    if alerts_path:
        watch = Watchtower(
            metrics, rules if rules is not None else default_rules(),
            unit_us=(1_000_000.0 if is_async else 1000.0),
            clock=("sim_s" if is_async else "steps"))
    tracer = None
    if trace_path:
        tracer = for_sim_seconds() if is_async else for_steps()
    obs = dict(tracer=tracer, metrics=metrics, watch=watch)

    def lm_batch(step, group=None):
        return make_lm_batch(task, cell.batch, cell.seq_len, step, group,
                             seed=cell.seed, device=dev)

    if cell.mode == "allreduce":
        def it():
            s = 0
            while True:
                yield lm_batch(s)
                s += 1
        _, hist = train_allreduce(model, tc, it(), log_every=1, device=dev,
                                  **obs)
        comm = {"comm_events": hist.last("comm_events"),
                "comm_bytes": hist.last("comm_bytes")}
    elif cell.mode in ASYNC_MODES:
        codist = _codist_config(cell, steps)
        faults = FaultConfig(n_peers=cell.peers, seed=cell.seed)
        report = AsyncScheduler(model, tc, codist, lm_batch, faults,
                                log_every=1, device=dev, **obs).run()
        records = sorted(
            (r for h in report.histories.values() for r in h.records),
            key=lambda r: (r["step"], r.get("peer", 0)))
        hist = History(records)
        comm = {"comm_events": report.comm_events,
                "comm_bytes": report.comm_bytes}
    else:
        codist = _codist_config(cell, steps)
        coordinated = codist.mode == "predictions"

        def batches(step):
            return stack_batches([lm_batch(step, None if coordinated else g)
                                  for g in range(cell.peers)])
        _, hist = train_codist(model, codist, tc, batches, log_every=1,
                               device=dev, **obs)
        comm = {"comm_events": hist.last("comm_events"),
                "comm_bytes": hist.last("comm_bytes")}

    def last_mean(key: str) -> float:
        """Final value of a metric; async cells average every peer's LAST
        record (clean schedule: all peers survive) so no single peer's
        final step skews the row."""
        if cell.mode in ASYNC_MODES:
            per_peer: Dict[int, float] = {}
            for rec in hist.records:
                if key in rec:
                    per_peer[rec.get("peer", 0)] = rec[key]
            if not per_peer:
                raise KeyError(key)
            return sum(per_peer.values()) / len(per_peer)
        return hist.last(key)

    final = {"task_loss": last_mean("task_loss"),
             "loss": last_mean("loss"), **comm}
    try:
        final["accuracy"] = last_mean("accuracy")
    except KeyError:
        pass
    summary = {
        "schema": SCHEMA_VERSION,
        "status": "complete",
        "cell_id": cell.cell_id,
        "cell": cell_to_dict(cell),
        "grid_key": list(cell.grid_key),
        "baseline_key": list(cell.baseline_key),
        "steps": steps,
        "final": final,
    }
    if tracer is not None:
        tracer.save(trace_path)
    if metrics is not None and metrics_path:
        metrics.save(metrics_path)
    if watch is not None:
        watch.save(alerts_path)
    return summary, hist


# ----------------------------------------------------------------------------
# the sweep driver
# ----------------------------------------------------------------------------

def _observe_loss_gap(watch, by_key: Dict[tuple, Dict[str, float]],
                      cell: Cell, summary: Dict, idx: int) -> None:
    """Feed one finished cell into the sweep-level loss-gap Watchtower.

    ``by_key`` maps ``baseline_key`` (batch, lr) -> {mode: final task_loss}.
    Whenever a codist cell and its allreduce baseline are both known, the
    ``sweep/loss_gap`` gauge is set to codist - baseline and the watch is
    evaluated at the cell index (one cell renders as 1 ms on the sweep
    clock), so the EWMA-drift rule sees gaps in deterministic cell order.
    """
    final = summary.get("final") or {}
    task_loss = final.get("task_loss")
    if task_loss is None:
        return
    key = tuple(summary.get("baseline_key", cell.baseline_key))
    slot = by_key.setdefault(key, {})
    slot[cell.mode] = float(task_loss)
    base = slot.get("allreduce")
    if base is None:
        return
    if cell.mode == "allreduce":
        # the baseline arrived after its codist partners: flush them in order
        pairs = [(m, v) for m, v in sorted(slot.items()) if m != "allreduce"]
    else:
        pairs = [(cell.mode, slot[cell.mode])]
    for _, loss in pairs:
        watch.registry.gauge("sweep/loss_gap").set(round(loss - base, 6))
        watch.evaluate(idx)


@dataclass
class CellResult:
    cell: Cell
    status: str            # 'ran' | 'skipped' | 'failed'
    seconds: float
    summary: Optional[Dict] = None
    error: str = ""


def run_sweep(spec: SweepSpec, out_root: str = "results/sweeps", *,
              resume: bool = False, max_cells: Optional[int] = None,
              steps: Optional[int] = None, trace: bool = False,
              metrics: bool = False, alerts: bool = False,
              rules_path: Optional[str] = None,
              log: Callable[[str], None] = print,
              device="cuda") -> List[CellResult]:
    """Run (a prefix of) a sweep's cells on ``device``, persisting each as
    it completes.

    A failed cell is recorded and the sweep continues — crash-safety means
    one bad cell never costs the finished ones. The caller decides whether
    failures are fatal (the CLI exits 1 if any cell failed). On the card,
    each cell starts from an emptied allocator cache and its log line
    carries its peak memory.

    ``trace`` / ``metrics`` write per-cell observability files next to each
    result: ``<cell_id>.trace.json`` (Perfetto trace) and
    ``<cell_id>.metrics.json`` (the registry). ``alerts`` adds
    ``<cell_id>.alerts.jsonl`` per cell plus a sweep-level ``alerts.jsonl``
    watching the codist-vs-baseline loss gap across cells (``rules_path``
    overrides the built-in rule pack for both).
    """
    dev = resolve_device(device)
    sweep_dir = sweep_dir_for(spec.name, out_root)
    os.makedirs(sweep_dir, exist_ok=True)
    _write_atomic(os.path.join(sweep_dir, "spec.json"), spec_to_dict(spec))

    cells = spec.cells()
    if max_cells:
        cells = cells[:max_cells]
    eff_steps = int(steps or 0)
    results: List[CellResult] = []
    cell_rules = None
    swatch = None
    by_key: Dict[tuple, Dict[str, float]] = {}
    if alerts:
        cell_rules = load_rules(rules_path) if rules_path else None
        swatch = Watchtower(
            MetricsRegistry(),
            cell_rules if cell_rules is not None else default_rules(),
            unit_us=1000.0, clock="cells")
    for i, cell in enumerate(cells):
        n_steps = eff_steps or cell.steps
        tag = f"[{i + 1}/{len(cells)}] {cell.cell_id}"
        if resume and summary_is_valid(sweep_dir, cell, n_steps):
            log(f"{tag}: skipped (already complete)")
            summary = load_summary(sweep_dir, cell)
            if swatch is not None and summary:
                _observe_loss_gap(swatch, by_key, cell, summary, i)
            results.append(CellResult(cell, "skipped", 0.0, summary))
            continue
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        try:
            summary, hist = run_cell(
                cell, n_steps,
                trace_path=(os.path.join(
                    sweep_dir, f"{cell.cell_id}.trace.json")
                    if trace else None),
                metrics_path=(os.path.join(
                    sweep_dir, f"{cell.cell_id}.metrics.json")
                    if metrics else None),
                alerts_path=(os.path.join(
                    sweep_dir, f"{cell.cell_id}.alerts.jsonl")
                    if alerts else None),
                rules=cell_rules, device=dev)
        except Exception as e:  # noqa: BLE001 - record and keep sweeping
            dt = time.time() - t0
            log(f"{tag}: FAILED after {dt:.1f}s ({type(e).__name__}: {e})")
            results.append(CellResult(cell, "failed", dt,
                                      error=f"{type(e).__name__}: {e}"))
            continue
        summary_path, hist_path = cell_paths(sweep_dir, cell)
        hist.save(hist_path)          # history first...
        _write_atomic(summary_path, summary)  # ...summary marks completion
        if swatch is not None:
            _observe_loss_gap(swatch, by_key, cell, summary, i)
        dt = time.time() - t0
        peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
                "GiB" if dev.type == "cuda" else "")
        log(f"{tag}: final task_loss={summary['final']['task_loss']:.4f} "
            f"in {dt:.1f}s{peak}")
        results.append(CellResult(cell, "ran", dt, summary))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if swatch is not None:
        swatch.save(os.path.join(sweep_dir, "alerts.jsonl"))
        s = swatch.summary()
        log(f"sweep alerts: {s['n_events']} events, still firing: "
            f"{', '.join(s['firing']) or 'none'}")
    counts = {s: sum(1 for r in results if r.status == s)
              for s in ("ran", "skipped", "failed")}
    log(f"sweep {spec.name}: total={len(results)} ran={counts['ran']} "
        f"skipped={counts['skipped']} failed={counts['failed']}")
    return results
