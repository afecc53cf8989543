"""Reduce per-cell sweep results into paper-style tables.

Three artifacts per sweep, written next to the cell results under
``results/sweeps/<name>/``:

* ``SWEEP_<name>.json`` — machine-readable grid: one row per grid cell
  (seed axis collapsed to mean / min / max / range — the paper's error
  bars), the codist-vs-allreduce final-loss gap, and the Section-3
  communication cost to reach fixed quality levels;
* ``SWEEP_<name>.md`` — the same grid as a markdown table;
* return value — the JSON document, for benchmarks and tests.

The reference's aggregator: for the same summaries and histories both
write the same JSON and markdown.

The gap column is the paper's central comparison (Sections 4-5): for every
codistillation cell, ``final_loss - final_loss(allreduce)`` at the SAME
(batch size, LR schedule) coordinates. Quality levels are defined off that
same baseline: ``L* = allreduce mean final task loss`` per (batch, lr)
group, levels at ``factor * L*`` — "bytes to reach quality" is the first
logged step whose task loss crosses the level, priced by the cumulative
``comm_bytes`` the loop metered up to that step.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.experiments.runner import SCHEMA_VERSION, sweep_dir_for
from repro_torch.train.loop import History

#: quality levels as multiples of the matched all-reduce baseline's final loss
QUALITY_FACTORS = (1.5, 1.2, 1.05)


def _mean(xs: List[float]) -> Optional[float]:
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def load_summaries(sweep_dir: str,
                   cell_ids: Optional[set] = None) -> List[Dict]:
    """All valid cell summaries in a sweep directory.

    ``cell_ids`` restricts the load to the given ids — pass the current
    spec expansion's ids so summaries left behind by a PREVIOUS revision
    of a same-named spec (removed axis points, renamed schedules) don't
    pollute the tables. ``None`` loads everything (tests, ad-hoc dirs).
    Results for the SAME cell at different ``--steps`` share an id; the
    aggregator keeps them honest by grouping on step count too.
    """
    out = []
    if not os.path.isdir(sweep_dir):  # never-run sweep: empty, not a crash
        return out
    for fn in sorted(os.listdir(sweep_dir)):
        if not fn.endswith(".json") or fn.startswith(("SWEEP_", "spec")):
            continue
        try:
            with open(os.path.join(sweep_dir, fn)) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if (doc.get("status") == "complete"
                and doc.get("schema") == SCHEMA_VERSION
                and (cell_ids is None or doc.get("cell_id") in cell_ids)):
            out.append(doc)
    return out


def comm_to_quality(history, levels: Dict[str, float]) -> Dict[str, Optional[float]]:
    """First-crossing communication cost: for each quality level, the
    cumulative ``comm_bytes`` at the first logged step whose ``task_loss``
    is at or below the level (None if never reached or the history carries
    no comm metering, e.g. async per-peer records)."""
    out: Dict[str, Optional[float]] = {label: None for label in levels}
    for rec in history.records:
        loss = rec.get("task_loss")
        if loss is None:
            continue
        for label, level in levels.items():
            if out[label] is None and loss <= level:
                out[label] = rec.get("comm_bytes")
    return out


def aggregate(sweep_dir: str, name: Optional[str] = None,
              cell_ids: Optional[set] = None) -> Dict:
    """Collapse the seed axis and compute the paper-style columns."""
    name = name or os.path.basename(os.path.normpath(sweep_dir))
    summaries = load_summaries(sweep_dir, cell_ids)

    # group cells by grid coordinates (minus seed) PLUS step count: results
    # for the same cell id trained for different lengths (--steps override,
    # partial resume of a re-specced sweep) must never be averaged together
    # or compared against each other
    groups: Dict[Tuple, List[Dict]] = {}
    for s in summaries:
        groups.setdefault(tuple(s["grid_key"]) + (s["steps"],),
                          []).append(s)

    # the all-reduce baseline per (batch, lr, steps): mean final task loss
    baselines: Dict[Tuple, float] = {}
    for key, cells in groups.items():
        if key[0] == "allreduce":
            bkey = tuple(cells[0]["baseline_key"]) + (key[-1],)
            baselines[bkey] = _mean(
                [c["final"]["task_loss"] for c in cells])

    levels_by_baseline: Dict[Tuple, Dict[str, float]] = {
        bkey: {f"{f:g}x": f * lstar for f in QUALITY_FACTORS}
        for bkey, lstar in baselines.items()}

    rows: List[Dict] = []
    for key in sorted(groups):
        cells = groups[key]
        mode, batch, lr, alpha, peers = key[:-1]
        steps = key[-1]
        finals = [c["final"]["task_loss"] for c in cells]
        bkey = tuple(cells[0]["baseline_key"]) + (steps,)
        lstar = baselines.get(bkey)
        levels = levels_by_baseline.get(bkey, {})
        per_cell_quality = []
        for c in cells:
            hist_path = os.path.join(sweep_dir, c["cell_id"] + ".jsonl")
            try:
                hist = History.load(hist_path)
            except (OSError, json.JSONDecodeError):
                continue
            per_cell_quality.append(comm_to_quality(hist, levels))
        bytes_to_quality = {
            label: _mean([q[label] for q in per_cell_quality])
            for label in levels}
        row = {
            "mode": mode, "batch": batch, "lr": lr, "alpha": alpha,
            "peers": peers, "steps": steps,
            "seeds": sorted(c["cell"]["seed"] for c in cells),
            "final_loss_mean": _mean(finals),
            "final_loss_min": min(finals),
            "final_loss_max": max(finals),
            "final_loss_range": max(finals) - min(finals),
            "accuracy_mean": _mean(
                [c["final"].get("accuracy") for c in cells]),
            "comm_events_mean": _mean(
                [c["final"].get("comm_events") for c in cells]),
            "comm_bytes_mean": _mean(
                [c["final"].get("comm_bytes") for c in cells]),
            "gap_vs_allreduce": (
                None if mode == "allreduce" or lstar is None
                else _mean(finals) - lstar),
            "bytes_to_quality": bytes_to_quality,
        }
        rows.append(row)

    return {
        "schema": SCHEMA_VERSION,
        "sweep": name,
        "n_cells": len(summaries),
        "quality_factors": list(QUALITY_FACTORS),
        "quality_levels": {
            f"b{bkey[0]}-{bkey[1]}@{bkey[2]}steps": levels
            for bkey, levels in levels_by_baseline.items()},
        "grid": rows,
    }


# ----------------------------------------------------------------------------
# rendering
# ----------------------------------------------------------------------------

def _fmt(x, digits=4) -> str:
    if x is None:
        return "-"
    if isinstance(x, float):
        return f"{x:.{digits}f}"
    return str(x)


def _fmt_bytes(x) -> str:
    if x is None:
        return "-"
    if x >= 1e6:
        return f"{x / 1e6:.2f}MB"
    if x >= 1e3:
        return f"{x / 1e3:.1f}KB"
    return f"{x:.0f}B"


def render_markdown(doc: Dict) -> str:
    q_labels = [f"{f:g}x" for f in doc.get("quality_factors", [])]
    lines = [
        f"# Sweep `{doc['sweep']}`",
        "",
        f"{doc['n_cells']} completed cells. Final loss is the mean over "
        "seeds; +-range is max-min over seeds (the paper's error bars). "
        "`gap` is final loss minus the all-reduce baseline at the same "
        "(batch, LR) coordinates — the paper's central codist-vs-sync "
        "comparison. `bytes->Q` is the cumulative cross-pod communication "
        "until task loss first crossed Q x baseline-final-loss.",
        "",
        "| mode | batch | lr | alpha | peers | steps | final loss | "
        "+-range | gap vs all-reduce | comm bytes |"
        + "".join(f" bytes->{q} |" for q in q_labels),
        "|---|---|---|---|---|---|---|---|---|---|"
        + "---|" * len(q_labels),
    ]
    for r in doc["grid"]:
        cells = [r["mode"], r["batch"], r["lr"], r["alpha"], r["peers"],
                 r["steps"],
                 _fmt(r["final_loss_mean"]), _fmt(r["final_loss_range"]),
                 _fmt(r["gap_vs_allreduce"]),
                 _fmt_bytes(r["comm_bytes_mean"])]
        cells += [_fmt_bytes(r["bytes_to_quality"].get(q)) for q in q_labels]
        lines.append("| " + " | ".join(str(c) for c in cells) + " |")
    lines.append("")
    return "\n".join(lines)


def write_outputs(doc: Dict, sweep_dir: str) -> Tuple[str, str]:
    """Write ``SWEEP_<name>.json`` + ``SWEEP_<name>.md``; returns paths."""
    os.makedirs(sweep_dir, exist_ok=True)
    json_path = os.path.join(sweep_dir, f"SWEEP_{doc['sweep']}.json")
    md_path = os.path.join(sweep_dir, f"SWEEP_{doc['sweep']}.md")
    with open(json_path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    with open(md_path, "w") as f:
        f.write(render_markdown(doc))
    return json_path, md_path


def aggregate_and_write(spec, out_root: str = "results/sweeps"
                        ) -> Tuple[Dict, str, str]:
    """Aggregate a :class:`~repro_torch.experiments.spec.SweepSpec`'s results —
    restricted to the spec's CURRENT cell expansion, so stale results from
    an earlier revision of a same-named spec are ignored."""
    sweep_dir = sweep_dir_for(spec.name, out_root)
    doc = aggregate(sweep_dir, spec.name,
                    {c.cell_id for c in spec.cells()})
    json_path, md_path = write_outputs(doc, sweep_dir)
    return doc, json_path, md_path
