"""The port's experiment harness (``repro_torch.experiments`` and
``launch/sweep.py``) held against the JAX reference's, on the CPU at the
reduced sizes of ``paper_grid_small.yaml``'s overrides.

* Both committed specs expand to the reference's cell ids, in order.
* One cell of every mode (allreduce, codist, codist-ckpt with its own
  batch per peer, codist-pipelined, codist-async), both sides fed the
  reference's initial params (bridged) and its numpy batches: per-step
  losses within 1e-5 relative of the reference's ``run_cell``, equal
  ``comm_events`` / ``comm_bytes``.
* A cell re-run on the CPU is bit-identical; another seed differs.
* ``--resume`` skips complete cells and re-runs a corrupt one.
* The port's aggregate equals the reference's on the same sweep
  directory (the port's, and a synthetic fixture), JSON and markdown, and
  the reference reads the port's histories.
* The sweep CLI runs ``paper_grid_small.yaml --max-cells 4 --steps 5
  --device cpu``, its ``--resume`` re-run is a no-op; with ``--trace
  --metrics --alerts`` (and a ``--rules`` file) it writes each cell's files
  and the sweep-level alert log, which ``tools/trace_check.py`` passes;
  ``--rules`` without ``--alerts`` exits 2.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.codistillation import init_stacked as jax_init_stacked
from repro.data import make_lm_batch as jax_make_lm_batch
from repro.experiments import aggregate as jax_aggregate
from repro.experiments import load_spec as jax_load_spec
from repro.experiments import render_markdown as jax_render_markdown
from repro.experiments import run_cell as jax_run_cell
from repro.experiments.runner import _build_cell_setup as jax_cell_setup
from repro.train.loop import History as JHistory
from repro_torch.checkpoint import params_from_jax
from repro_torch.experiments import (AlphaPoint, LRPoint, SweepSpec,
                                     TINY_OVERRIDES, aggregate, cell_paths,
                                     load_spec, render_markdown, run_cell,
                                     run_sweep, summary_is_valid,
                                     sweep_dir_for)
from repro_torch.experiments import runner as port_runner

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SPECS = [os.path.join(REPO, "experiments", "specs", f)
         for f in ("paper_grid_small.yaml", "paper_grid.yaml")]


def tiny_spec(**kw) -> SweepSpec:
    base = dict(name="t", seq_len=8, steps=3, batch_sizes=(2,),
                modes=("allreduce", "codist"),
                alpha_schedules=(AlphaPoint("const"),), peers=(2,),
                model_overrides=TINY_OVERRIDES)
    base.update(kw)
    return SweepSpec(**base)


def _close_rel(got, want, tol=1e-5):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.all(np.abs(g - w) <= tol * np.maximum(1.0, np.abs(w))), (g, w)


@pytest.mark.parametrize("path", SPECS)
def test_committed_specs_expand_as_the_reference(path):
    mine, ref = load_spec(path).cells(), jax_load_spec(path).cells()
    assert [c.cell_id for c in mine] == [c.cell_id for c in ref]
    assert len(mine) == {"paper_grid_small": 6, "paper_grid": 888}[
        load_spec(path).name]
    assert [c.grid_key for c in mine] == [c.grid_key for c in ref]
    assert [c.baseline_key for c in mine] == [c.baseline_key for c in ref]


# ----------------------------------------------------------------------------
# one cell of every mode against the reference's run_cell
# ----------------------------------------------------------------------------

def _feed_reference(monkeypatch, cell):
    """Point the port's runner at the reference's batches and initial
    params: ``make_lm_batch`` returns the reference's batch (as tensors),
    and the model's ``init`` hands out, in the order the port draws them,
    the trees the reference draws from ``key(seed)``: one for all-reduce,
    a stacked init of ``peers`` for the rest."""
    jmodel, task = jax_cell_setup(cell)
    key = jax.random.key(cell.seed)
    if cell.mode == "allreduce":
        trees = [jmodel.init(key)]
    else:
        stacked = jax_init_stacked(jmodel.init, key, cell.peers)
        trees = [jax.tree.map(lambda a, i=i: a[i], stacked)
                 for i in range(cell.peers)]
    queue = [jax.tree.map(np.asarray, t) for t in trees]

    def make_lm_batch(task_, batch, seq_len, step, group=None, seed=0,
                      device="cuda"):
        b = jax_make_lm_batch(task, batch, seq_len, step, group, seed=seed)
        return {n: torch.from_numpy(np.array(v)).to(device)
                for n, v in b.items()}

    lm = type(port_runner.build_model(cell_cfg(cell)))

    class Injected(lm):
        def init(self, generator, device="cuda", weight_dtype=None):
            return params_from_jax(queue.pop(0), device=device)

    monkeypatch.setattr(port_runner, "make_lm_batch", make_lm_batch)
    monkeypatch.setattr(port_runner, "build_model", Injected)


def cell_cfg(cell):
    from dataclasses import replace
    from repro_torch.configs import get_reduced
    return replace(get_reduced(cell.arch), **dict(cell.overrides))


MODES = ["allreduce", "codist", "codist-ckpt", "codist-pipelined",
         "codist-async"]


@pytest.mark.parametrize("mode", MODES)
def test_cell_matches_reference(mode, monkeypatch):
    # the prediction exchange under a burn-in alpha (its "off" variant on
    # step 0, then "on"); the other modes under a constant alpha, which
    # compiles one reference step variant each
    alpha = (AlphaPoint("burnin", burn_in_frac=0.25) if mode == "codist"
             else AlphaPoint("const"))
    spec = tiny_spec(modes=(mode,), steps=4, lr_schedules=(
        LRPoint("cos", lr=3e-3, warmup_frac=0.25),), alpha_schedules=(alpha,))
    (cell,) = spec.cells()
    (jcell,) = jax_load_spec_from(spec).cells()
    _feed_reference(monkeypatch, cell)
    mine, mhist = run_cell(cell, device="cpu")
    ref, rhist = jax_run_cell(jcell)
    assert [r["step"] for r in mhist.records] == [r["step"] for r in
                                                 rhist.records]
    assert [r.get("peer") for r in mhist.records] == [
        r.get("peer") for r in rhist.records]
    for key in ("loss", "task_loss"):
        _close_rel(mhist.series(key), rhist.series(key))
    for key in ("comm_events", "comm_bytes"):
        assert mine["final"][key] == ref["final"][key], key
    if mode != "allreduce":
        _close_rel(mhist.series("distill_loss"), rhist.series("distill_loss"))
        assert mine["final"]["comm_bytes"] > 0
    for key in ("task_loss", "loss", "accuracy"):
        _close_rel(mine["final"][key], ref["final"][key])
    assert json.dumps({k: v for k, v in mine.items() if k != "final"}) \
        == json.dumps({k: v for k, v in ref.items() if k != "final"})


def jax_load_spec_from(spec: SweepSpec):
    """The same spec, built by the reference's loader."""
    from repro.experiments import spec_from_dict
    from repro_torch.experiments import spec_to_dict
    return spec_from_dict(json.loads(json.dumps(spec_to_dict(spec))))


# ----------------------------------------------------------------------------
# determinism, resume, aggregate
# ----------------------------------------------------------------------------

def test_cell_rerun_is_bit_identical():
    (cell,) = tiny_spec(modes=("codist",)).cells()
    s1, h1 = run_cell(cell, device="cpu")
    s2, h2 = run_cell(cell, device="cpu")
    assert s1 == s2 and h1.records == h2.records
    (other,) = tiny_spec(modes=("codist",), seeds=(1,)).cells()
    s3, _ = run_cell(other, device="cpu")
    assert s3["final"]["task_loss"] != s1["final"]["task_loss"]


def test_resume_skips_completed_and_reruns_corrupt(tmp_path):
    spec = tiny_spec()
    out = str(tmp_path)
    quiet = dict(log=lambda _m: None, device="cpu")
    first = run_sweep(spec, out, **quiet)
    assert [r.status for r in first] == ["ran", "ran"]
    again = run_sweep(spec, out, resume=True, **quiet)
    assert [r.status for r in again] == ["skipped", "skipped"]
    assert all(r.summary is not None for r in again)
    sweep_dir = sweep_dir_for(spec.name, out)
    victim = again[1].cell
    summary_path, _ = cell_paths(sweep_dir, victim)
    with open(summary_path, "w") as f:
        f.write("{not json")
    assert not summary_is_valid(sweep_dir, victim, victim.steps)
    third = run_sweep(spec, out, resume=True, **quiet)
    assert [r.status for r in third] == ["skipped", "ran"]
    assert not summary_is_valid(sweep_dir, again[0].cell, 99)
    for cell in tiny_spec(lr_schedules=(LRPoint("cos", lr=5e-4),)).cells():
        assert not summary_is_valid(sweep_dir, cell, cell.steps)
    # with the obs flags a resumed sweep skips its cells and writes only
    # the sweep-level alert log; a cell run writes its trace and metrics
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import trace_check
    fourth = run_sweep(spec, out, resume=True, trace=True, alerts=True,
                       **quiet)
    assert [r.status for r in fourth] == ["skipped", "skipped"]
    assert trace_check.main([os.path.join(sweep_dir, "alerts.jsonl")]) == 0
    obs = [str(tmp_path / "c.trace.json"), str(tmp_path / "c.metrics.json")]
    s5, _ = run_cell(victim, trace_path=obs[0], metrics_path=obs[1],
                     device="cpu")
    assert s5 == third[1].summary
    assert trace_check.main(obs) == 0


def _write_cell(sweep_dir, cell_id, mode, batch, lr, alpha, peers, seed,
                final_loss, records):
    os.makedirs(sweep_dir, exist_ok=True)
    with open(os.path.join(sweep_dir, f"{cell_id}.jsonl"), "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    summary = {
        "schema": 1, "status": "complete", "cell_id": cell_id,
        "cell": {"seed": seed},
        "grid_key": [mode, batch, lr, alpha, peers],
        "baseline_key": [batch, lr],
        "steps": records[-1]["step"] + 1,
        "final": {"task_loss": final_loss, "loss": final_loss,
                  "comm_bytes": records[-1].get("comm_bytes", 0),
                  "comm_events": len(records)}}
    with open(os.path.join(sweep_dir, f"{cell_id}.json"), "w") as f:
        json.dump(summary, f)


def _assert_same_aggregate(sweep_dir, name, cell_ids=None):
    mine = aggregate(sweep_dir, name, cell_ids)
    ref = jax_aggregate(sweep_dir, name, cell_ids)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert render_markdown(mine) == jax_render_markdown(ref)
    return mine


def test_aggregate_equals_reference(tmp_path):
    # the reference's synthetic fixture: two seeds a mode, a 3-step codist
    # run with no 3-step baseline, and a stale cell filtered by id
    d = str(tmp_path / "synthetic")
    _write_cell(d, "ar-s0", "allreduce", 2, "cos", "none", 1, 0, 1.0,
                [{"step": 0, "task_loss": 3.0, "comm_bytes": 10},
                 {"step": 1, "task_loss": 1.0, "comm_bytes": 20}])
    _write_cell(d, "ar-s1", "allreduce", 2, "cos", "none", 1, 1, 2.0,
                [{"step": 0, "task_loss": 3.0, "comm_bytes": 20},
                 {"step": 1, "task_loss": 2.0, "comm_bytes": 40}])
    _write_cell(d, "co-s0", "codist", 2, "cos", "const", 2, 0, 2.0,
                [{"step": 0, "task_loss": 3.0, "comm_bytes": 4},
                 {"step": 1, "task_loss": 2.0, "comm_bytes": 8}])
    _write_cell(d, "co-s1", "codist", 2, "cos", "const", 2, 1, 2.5,
                [{"step": 0, "task_loss": 3.0, "comm_bytes": 4},
                 {"step": 1, "task_loss": 2.5, "comm_bytes": 8}])
    _write_cell(d, "co3-s0", "codist", 2, "cos", "const", 2, 0, 1.5,
                [{"step": k, "task_loss": 2.0 - k / 4, "comm_bytes": 4 * k}
                 for k in range(3)])
    doc = _assert_same_aggregate(d, "synthetic")
    co = next(r for r in doc["grid"] if r["mode"] == "codist"
              and r["steps"] == 2)
    assert co["gap_vs_allreduce"] == pytest.approx(0.75)
    assert co["bytes_to_quality"]["1.5x"] == pytest.approx(8.0)
    _assert_same_aggregate(d, "synthetic", {"ar-s0", "co-s1"})
    _assert_same_aggregate(str(tmp_path / "never_ran"), "fresh")

    # a sweep of the port's: both aggregates equal, and the reference
    # reads the port's histories
    spec = tiny_spec(modes=("allreduce", "codist", "codist-async"))
    run_sweep(spec, str(tmp_path), log=lambda _m: None, device="cpu")
    sweep_dir = sweep_dir_for(spec.name, str(tmp_path))
    doc = _assert_same_aggregate(sweep_dir, spec.name,
                                 {c.cell_id for c in spec.cells()})
    assert doc["n_cells"] == 3
    for row in doc["grid"]:
        assert (row["gap_vs_allreduce"] is None) == (row["mode"] == "allreduce")
        assert row["comm_bytes_mean"] > 0
    for cell in spec.cells():
        _, hist_path = cell_paths(sweep_dir, cell)
        assert JHistory.load(hist_path).last("step") == cell.steps - 1


# ----------------------------------------------------------------------------
# the sweep CLI
# ----------------------------------------------------------------------------

def test_sweep_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch.sweep import main
    argv = ["--spec", SPECS[0], "--out", str(tmp_path), "--device", "cpu",
            "--max-cells", "4", "--steps", "5"]
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "ran=4 skipped=0 failed=0" in out and "aggregated 4 cells" in out
    assert out.count("gap[codist") == 2   # b2 const and burnin; b4 baseline
    assert main(argv + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "ran=0 skipped=4 failed=0" in out
    sweep_dir = sweep_dir_for("paper_grid_small", str(tmp_path))
    _assert_same_aggregate(sweep_dir, "paper_grid_small")
    assert os.path.exists(os.path.join(sweep_dir, "SWEEP_paper_grid_small.md"))
    assert main(["--spec", SPECS[0], "--list"]) == 0
    assert "# 6 cells (paper_grid_small)" in capsys.readouterr().out
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps({"rules": [
        {"name": "loss-high", "metric": "train/task_loss",
         "kind": "threshold", "op": ">", "value": 0.0}]}))
    out_obs = str(tmp_path / "obs")
    assert main(argv[:3] + [out_obs] + argv[4:] + [
        "--max-cells", "2", "--trace", "--metrics", "--alerts", "--rules",
        str(rules)]) == 0
    out = capsys.readouterr().out
    assert "ran=2 skipped=0 failed=0" in out and "sweep alerts:" in out
    obs_dir = sweep_dir_for("paper_grid_small", out_obs)
    files = sorted(os.path.join(obs_dir, f) for f in os.listdir(obs_dir)
                   if f.endswith((".trace.json", ".metrics.json",
                                  ".alerts.jsonl")) or f == "alerts.jsonl")
    assert len(files) == 2 * 3 + 1, files
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import trace_check
    assert trace_check.main(files) == 0
    with open([f for f in files if f.endswith(".alerts.jsonl")][0]) as f:
        assert '"rule":"loss-high"' in f.read()
    with pytest.raises(SystemExit) as e:
        main(argv + ["--rules", str(rules)])
    assert e.value.code == 2
