"""Sweep launcher: expand -> run -> aggregate a paper-grid spec, on the
card by default.

    PYTHONPATH=src python -m repro_torch.launch.sweep \\
        --spec experiments/specs/paper_grid_small.yaml \\
        [--out results/sweeps] [--resume] [--max-cells N] [--steps N] \\
        [--list] [--aggregate-only] [--no-aggregate] [--device cuda|cpu] \\
        [--trace] [--metrics] [--alerts] [--rules RULES.json]

The reference launcher's flags, plus ``--device`` (``cpu`` runs the loss
kernels' plain versions). Cells persist individually under
``<out>/<spec.name>/`` as they complete (``<cell_id>.jsonl`` history +
``<cell_id>.json`` summary), so a killed sweep resumes with ``--resume``
(completed cells are validated and skipped — rerunning a finished sweep
with ``--resume`` is a no-op). Aggregation runs after every sweep (and
standalone via ``--aggregate-only``), writing ``SWEEP_<name>.json`` +
``SWEEP_<name>.md`` with the per-cell codist-vs-allreduce gaps.
``--trace`` / ``--metrics`` / ``--alerts`` write each cell's trace, metrics
and alert log next to its result, and ``--alerts`` a sweep-level
``alerts.jsonl`` over the codist-vs-allreduce loss gap; ``--rules`` (with
``--alerts``) overrides the built-in rule pack.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sweep",
        description="Run a declarative paper-grid sweep spec.")
    ap.add_argument("--spec", required=True,
                    help="path to a .yaml/.json SweepSpec")
    ap.add_argument("--out", default="results/sweeps",
                    help="results root; cells land in <out>/<spec.name>/")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose persisted result validates")
    ap.add_argument("--max-cells", type=int, default=0,
                    help="run only the first N cells of the expansion")
    ap.add_argument("--steps", type=int, default=0,
                    help="override the spec's per-cell step count")
    ap.add_argument("--list", action="store_true",
                    help="print the expanded cell ids and exit")
    ap.add_argument("--aggregate-only", action="store_true",
                    help="skip running; aggregate existing results")
    ap.add_argument("--no-aggregate", action="store_true",
                    help="run cells but skip the aggregation pass")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--trace", action="store_true",
                    help="write a per-cell Perfetto trace next to each "
                         "result (<cell_id>.trace.json)")
    ap.add_argument("--metrics", action="store_true",
                    help="write a per-cell metrics dump next to each result "
                         "(<cell_id>.metrics.json)")
    ap.add_argument("--alerts", action="store_true",
                    help="evaluate Watchtower rules per cell "
                         "(<cell_id>.alerts.jsonl) plus a sweep-level "
                         "loss-gap watch (alerts.jsonl)")
    ap.add_argument("--rules", default="",
                    help="JSON rules file overriding the built-in rule pack "
                         "(needs --alerts)")
    args = ap.parse_args(argv)
    if args.rules and not args.alerts:
        ap.error("--rules requires --alerts")

    from repro_torch.experiments import (aggregate_and_write, load_spec,
                                         run_sweep, sweep_dir_for)

    spec = load_spec(args.spec)
    cells = spec.cells()
    if args.list:
        for c in cells:
            print(c.cell_id)
        print(f"# {len(cells)} cells ({spec.name})")
        return 0

    failed = 0
    if not args.aggregate_only:
        results = run_sweep(spec, args.out, resume=args.resume,
                            max_cells=args.max_cells or None,
                            steps=args.steps or None, device=args.device,
                            trace=args.trace, metrics=args.metrics,
                            alerts=args.alerts,
                            rules_path=args.rules or None)
        failed = sum(1 for r in results if r.status == "failed")

    if not args.no_aggregate:
        doc, json_path, md_path = aggregate_and_write(spec, args.out)
        print(f"aggregated {doc['n_cells']} cells -> {json_path}, {md_path}")
        for row in doc["grid"]:
            if row["gap_vs_allreduce"] is not None:
                print(f"  gap[{row['mode']} b{row['batch']} {row['lr']} "
                      f"{row['alpha']} n{row['peers']}] = "
                      f"{row['gap_vs_allreduce']:+.4f}")
        if not doc["n_cells"]:
            print(f"warning: no completed cells under "
                  f"{sweep_dir_for(spec.name, args.out)}", file=sys.stderr)

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
