"""The port's observability layer (``repro_torch.obs`` and its hooks) on the
CPU, mirrored from the reference's ``tests/test_obs.py`` and
``tests/test_obs_property.py`` and held against the reference itself.

* The tracer's invariants (nesting, LIFO, monotonic clock, negative times,
  dangling spans, event shapes, async trees, canonical export) and
  ``tools/trace_check.py`` rejecting a corrupted trace; the registry's exact
  percentiles, gauge windows and export; the ``History`` schema header;
  the shared ``to_dict`` path.
* Hypothesis properties: nested spans always validate (calling
  ``trace_check.check_events(events, errors)`` with its two arguments),
  export order, a backwards clock raises, histogram percentiles equal
  numpy's, buckets partition the sample.
* The port alone: tracing does not perturb the ``FleetReport``; two seeded
  chaos runs write the same trace; a migrated request's span tree; the
  sync-train trace on the step clock.
* Against the reference, on bridged weights (its fleet on its scatters'
  jnp oracles, swapped in by ``monkeypatch``): a seeded, defended chaos
  fleet with a preemption, a straggler and hedging writes a byte-equal
  trace, metrics and alert log and the same postmortem bundles; a
  ``codist-async`` run with faults writes a byte-equal trace, metrics and
  alert log; a sync codist sweep cell and an all-reduce one the same trace
  and alert log, metrics equal but for the loss gauges (within 1e-5
  relative); a two-cell sweep with ``--alerts`` the same per-cell files
  and sweep-level alert log. With obs on, the report, the ``History`` and
  the launch counts equal the obs-off run's. ``tools/trace_check.py`` (by
  subprocess) passes every file.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import obs as jobs
from repro.configs import CodistConfig as JCodistConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_reduced as jax_get_reduced
from repro.experiments import run_cell as jax_run_cell
from repro.experiments import run_sweep as jax_run_sweep
from repro.kernels import paged_cache as jax_paged_cache
from repro.models import build_model as jax_build_model
from repro.runtime import AsyncScheduler as JAsyncScheduler
from repro.runtime import FaultConfig as JaxFaultConfig
from repro.runtime import parse_faults as jax_parse_faults
from repro.serve.fleet import ChaosConfig as JaxChaosConfig
from repro.serve.fleet import FleetConfig as JaxFleetConfig
from repro.serve.fleet import FleetDefense as JaxFleetDefense
from repro.serve.fleet import FleetRouter as JaxFleetRouter
from repro.serve.fleet import model_exec as jax_model_exec
from repro_torch import obs
from repro_torch.checkpoint import params_from_jax
from repro_torch.configs import CodistConfig, TrainConfig, get_reduced
from repro_torch.data import MarkovLM, make_lm_batch
from repro_torch.experiments import AlphaPoint, LRPoint, run_cell, run_sweep
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.obs import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                             MetricsRegistry, TraceError, Tracer, for_sim_ms,
                             for_steps)
from repro_torch.runtime import AsyncScheduler, FaultConfig, parse_faults
from repro_torch.serve.fleet import (ChaosConfig, FleetConfig, FleetDefense,
                                     FleetRouter, Request)
from repro_torch.train import stack_batches, train_codist
from repro_torch.train.loop import HISTORY_SCHEMA_VERSION, History
from test_torch_experiments import (_feed_reference, jax_load_spec_from,
                                    tiny_spec)
from test_torch_runtime import _inject_reference_init, _models, _ref_batches, _tc

torch.set_num_threads(2)

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)
import trace_check  # noqa: E402

# loss-derived values differ across frameworks by float rounding
LOSS_GAUGES = ("train/task_loss", "train/final_task_loss", "sweep/loss_gap")


def _close_rel(got, want, tol=1e-5):
    assert abs(got - want) <= tol * max(1.0, abs(want)), (got, want)


# ----------------------------------------------------------------------------
# tracer unit invariants
# ----------------------------------------------------------------------------

class TestTracer:
    def test_sync_spans_nest_and_export(self):
        tr = Tracer(unit_us=1000.0)
        tr.begin("outer", 1.0, pid=0, tid=0)
        tr.begin("inner", 2.0, pid=0, tid=0)
        tr.end("inner", 3.0, pid=0, tid=0)
        tr.end("outer", 4.0, pid=0, tid=0)
        doc = tr.to_dict()
        assert [e["ph"] for e in doc["traceEvents"]] == ["B", "B", "E", "E"]
        assert doc["traceEvents"][0]["ts"] == 1000

    def test_lifo_name_mismatch_raises(self):
        tr = Tracer()
        tr.begin("a", 0.0, pid=0, tid=0)
        with pytest.raises(TraceError, match="does not match"):
            tr.end("b", 1.0, pid=0, tid=0)

    def test_clock_must_be_monotonic_per_track(self):
        tr = Tracer()
        tr.begin("a", 5.0, pid=0, tid=0)
        with pytest.raises(TraceError, match="precedes"):
            tr.end("a", 4.0, pid=0, tid=0)

    def test_negative_time_rejected(self):
        with pytest.raises(TraceError, match="negative"):
            Tracer().instant("x", -1.0, pid=0, tid=0)

    def test_dangling_span_fails_export(self):
        tr = Tracer()
        tr.begin("leak", 0.0, pid=0, tid=0)
        assert tr.open_spans()
        with pytest.raises(TraceError, match="still open"):
            tr.to_dict()

    def test_complete_and_counter_shapes(self):
        tr = Tracer(unit_us=1.0)
        tr.complete("x", 10.0, 14.0, pid=1, tid=2, cat="c", args={"k": 1})
        tr.counter("pool", 12.0, {"util": 0.5}, pid=1)
        evs = tr.to_dict()["traceEvents"]
        x = next(e for e in evs if e["ph"] == "X")
        assert (x["ts"], x["dur"], x["pid"], x["tid"]) == (10, 4, 1, 2)
        assert next(e for e in evs if e["ph"] == "C")["args"] == {"util": 0.5}

    def test_async_span_balanced_per_id(self):
        tr = Tracer()
        tr.async_begin("request", 7, "req", 0.0, pid=0, tid=7)
        tr.async_instant("migrate", 7, "req", 1.0, pid=0, tid=7)
        tr.async_end("request", 7, "req", 2.0, pid=0, tid=7)
        assert [e["ph"] for e in tr.to_dict()["traceEvents"]] == ["b", "n",
                                                                  "e"]

    def test_export_sorted_and_canonical(self):
        tr = for_steps()
        tr.complete("late", 5, 6, pid=0, tid=0)
        tr.complete("early", 1, 2, pid=0, tid=0)
        assert [e["name"] for e in tr.to_dict()["traceEvents"]] == [
            "early", "late"]
        assert "\n" not in tr.to_json() and '", "' not in tr.to_json()

    def test_validator_rejects_corruption(self, tmp_path):
        tr = for_steps()
        tr.complete("ok", 0, 1, pid=0, tid=0)
        doc = json.loads(tr.to_json())
        doc["traceEvents"][0]["dur"] = -5
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps(doc))
        good = tmp_path / "good.json"
        tr.save(str(good))
        assert trace_check.main([str(good)]) == 0
        assert trace_check.main([str(bad)]) == 1


# ----------------------------------------------------------------------------
# metrics registry
# ----------------------------------------------------------------------------

class TestMetrics:
    def test_percentile_matches_numpy_exactly(self):
        vals = [3.0, 1.5, 9.0, 2.2, 7.7, 0.4]
        h = Histogram()
        for v in vals:
            h.observe(v)
        for q in (0, 12.5, 50, 90, 99, 100):
            assert h.percentile(q) == float(np.percentile(np.asarray(vals), q))
        assert h.quantile(0.9) == float(np.quantile(
            np.asarray(vals, np.float64), 0.9))

    def test_empty_histogram_quantile_raises_with_metric_name(self):
        with pytest.raises(ValueError, match="fleet/ttft_ms"):
            Histogram(name="fleet/ttft_ms").percentile(99)
        with pytest.raises(ValueError, match="histogram"):
            Histogram().quantile(0.9)
        assert Histogram(name="x").to_dict()["p50"] == 0.0

    def test_gauge_windowed_min_max(self):
        g = Gauge()
        assert (g.window_min(), g.window_max()) == (0.0, 0.0)
        for v in (3.0, 1.0, 4.0, 1.5):
            g.set(v)
        assert g.window(2) == [4.0, 1.5]
        assert g.window_min() == 1.0 and g.window_max() == 4.0
        assert g.window_min(2) == 1.5 and g.window_max(3) == 4.0
        with pytest.raises(ValueError, match="window"):
            g.window(0)

    def test_registry_get_or_create_and_export(self):
        m = MetricsRegistry()
        m.counter("a").inc(3)
        assert m.counter("a").value == 3
        m.gauge("g").set(1.5)
        m.histogram("h", buckets=(1, 10)).observe(4)
        d = m.to_dict()
        assert d["schema_version"] == 1
        assert (d["counters"]["a"], d["gauges"]["g"]) == (3, 1.5)
        assert d["histograms"]["h"]["count"] == 1

    def test_counter_rejects_negative(self):
        with pytest.raises(ValueError):
            Counter().inc(-1)

    def test_default_buckets_sorted(self):
        assert list(DEFAULT_BUCKETS) == sorted(DEFAULT_BUCKETS)
        assert Gauge().value == 0.0


# ----------------------------------------------------------------------------
# properties (hypothesis)
# ----------------------------------------------------------------------------

S = settings(max_examples=25, deadline=None)


class TestProperties:
    @S
    @given(durs=st.lists(st.floats(0.0, 10.0), min_size=1, max_size=8),
           t0=st.floats(0.0, 100.0))
    def test_nested_spans_always_validate(self, durs, t0):
        tr = Tracer(unit_us=1000.0)
        t = t0
        for i, d in enumerate(durs):
            tr.begin(f"s{i}", t, pid=0, tid=0)
            t += d
        for i in reversed(range(len(durs))):
            tr.end(f"s{i}", t, pid=0, tid=0)
            t += 0.5
        errors = []
        trace_check.check_events(tr.to_dict()["traceEvents"], errors)
        assert errors == [] and not tr.open_spans()

    @S
    @given(ts=st.lists(st.floats(0.0, 1000.0), min_size=2, max_size=16))
    def test_export_order_is_time_sorted(self, ts):
        tr = Tracer(unit_us=1000.0)
        for i, t in enumerate(ts):
            tr.instant(f"e{i}", t, pid=0, tid=0)
        out = [e["ts"] for e in tr.to_dict()["traceEvents"]]
        assert out == sorted(out)

    @S
    @given(back=st.floats(0.001, 50.0), t=st.floats(1.0, 100.0))
    def test_backwards_clock_always_raises(self, back, t):
        tr = Tracer()
        tr.begin("a", t, pid=0, tid=0)
        with pytest.raises(TraceError):
            tr.end("a", t - back, pid=0, tid=0)

    @S
    @given(vals=st.lists(st.floats(0.0, 1e6), min_size=1, max_size=200),
           q=st.floats(0.0, 100.0))
    def test_percentile_matches_numpy_exactly(self, vals, q):
        h = Histogram()
        for v in vals:
            h.observe(v)
        assert h.percentile(q) == float(np.percentile(np.asarray(vals), q))

    @S
    @given(vals=st.lists(st.floats(0.0, 1e4), min_size=0, max_size=100))
    def test_bucket_counts_partition_the_samples(self, vals):
        h = Histogram()
        for v in vals:
            h.observe(v)
        d = h.to_dict()
        assert sum(d["buckets"].values()) == len(vals) == d["count"]
        if vals:
            assert d["sum"] == pytest.approx(sum(vals))


# ----------------------------------------------------------------------------
# History schema, shared serialization
# ----------------------------------------------------------------------------

class TestHistorySchema:
    def test_roundtrip_writes_header(self, tmp_path):
        h = History()
        h.log(0, {"loss": 1.0})
        h.log(1, {"loss": 0.5})
        p = tmp_path / "h.jsonl"
        h.save(str(p))
        assert json.loads(p.read_text().splitlines()[0]) == {
            "schema_version": HISTORY_SCHEMA_VERSION}
        assert History.load(str(p)).records == h.records

    def test_unknown_version_rejected_actionably(self, tmp_path):
        p = tmp_path / "future.jsonl"
        p.write_text(json.dumps({"schema_version": 99}) + "\n"
                     + json.dumps({"step": 0, "loss": 1.0}) + "\n")
        with pytest.raises(ValueError, match=r"schema_version 99.*Re-gen"):
            History.load(str(p))

    def test_legacy_headerless_still_loads(self, tmp_path):
        p = tmp_path / "legacy.jsonl"
        p.write_text(json.dumps({"step": 0, "loss": 2.0}) + "\n")
        assert History.load(str(p)).records == [{"step": 0, "loss": 2.0}]


class TestToDict:
    def test_fleet_report_to_dict_matches_json(self):
        from repro_torch.serve.fleet.router import FleetReport
        rep = FleetReport(
            scenario="custom", router="round_robin", peers=2, seed=0,
            completed=4, rejected=0, p50_ttft_ms=1.0, p99_ttft_ms=2.0,
            p50_e2e_ms=3.0, p99_e2e_ms=4.0, slo_ms=50.0, slo_attainment=1.0,
            sim_tokens_per_s=10.0, generated_tokens=20, kv_bytes_written=64,
            refresh_bytes=0, refreshes=0, refreshes_dropped_stale=0,
            peak_pool_utilization=0.5)
        d = rep.to_dict()
        assert set(d) == set(rep.__dict__)
        assert json.loads(rep.to_json()) == json.loads(
            json.dumps(d, sort_keys=True))

    def test_chaos_stats_to_dict_is_summary(self):
        from repro_torch.serve.fleet.chaos import ChaosStats
        s = ChaosStats()
        s.preemptions = 3
        assert s.to_dict()["preemptions"] == 3
        assert s.summary() == s.to_dict()


# ----------------------------------------------------------------------------
# the fleet: the port alone, then against the reference
# ----------------------------------------------------------------------------

def _tiny_cfg(get):
    return replace(get("qwen1.5-0.5b"), num_layers=2, d_model=64, d_ff=128,
                   vocab_size=64, num_heads=2, num_kv_heads=2, head_dim=32)


class _ListWorkload:
    def __init__(self, requests, scenario="custom", seed=0):
        self.requests = requests
        self.scenario = scenario
        self.seed = seed


def _workload(vocab, lens, gap_ms=4.0, max_new=5):
    rng = np.random.default_rng(0)
    return _ListWorkload([
        Request(i, i * gap_ms, tuple(int(x) for x in
                                     rng.integers(0, vocab, size=n)), max_new)
        for i, n in enumerate(lens)])


def _fc(cls):
    return cls(max_slots=2, block_size=4, num_blocks=32,
               max_blocks_per_slot=8, max_queue=32)


@pytest.fixture(scope="module")
def fleet():
    """The tiny model on both sides, bridged weights, the reference's
    16-request workload."""
    jm = jax_build_model(_tiny_cfg(jax_get_reduced))
    jp = jm.init(jax.random.key(0))
    pm = build_model(_tiny_cfg(get_reduced))
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, pm, pp, _workload(pm.cfg.padded_vocab, [5, 9, 12, 7] * 4)


@pytest.fixture
def oracle_scatters(monkeypatch):
    """The reference fleet on its scatters' jnp oracles."""
    monkeypatch.setattr(jax_model_exec, "paged_scatter",
                        jax_paged_cache.paged_scatter_ref)
    monkeypatch.setattr(jax_model_exec, "paged_scatter_quant",
                        jax_paged_cache.paged_scatter_quant_ref)


_PREEMPT = ((1, 6, 150.0),)


def _preempt_chaos():
    return ChaosConfig(FaultConfig(n_peers=2, seed=0, preemptions=_PREEMPT))


def test_tracing_does_not_perturb_the_fleet(fleet):
    """A traced, metered run's report equals the plain run's; the registry
    mirrors it; the launch counts do not move."""
    _jm, _jp, pm, pp, wl = fleet
    _build.reset_launch_counts()
    plain = FleetRouter(pm, [pp, pp], config=_fc(FleetConfig),
                        device="cpu").run(wl)
    off = dict(_build.launch_counts)
    mreg = MetricsRegistry()
    _build.reset_launch_counts()
    traced = FleetRouter(pm, [pp, pp], config=_fc(FleetConfig), device="cpu",
                         tracer=for_sim_ms(), metrics=mreg).run(wl)
    assert plain.to_json() == traced.to_json()
    assert dict(_build.launch_counts) == off
    assert mreg.to_dict()["gauges"]["report/completed"] == traced.completed


def test_chaos_trace_bit_identical_and_valid(fleet, tmp_path):
    _jm, _jp, pm, pp, wl = fleet
    docs = []
    for _ in range(2):
        tr = for_sim_ms()
        FleetRouter(pm, [pp, pp], config=_fc(FleetConfig), device="cpu",
                    chaos=_preempt_chaos(), defense=FleetDefense(),
                    tracer=tr).run(wl)
        docs.append(tr.to_json())
    assert docs[0] == docs[1]
    path = tmp_path / "chaos.trace.json"
    path.write_text(docs[0] + "\n")
    assert trace_check.main([str(path)]) == 0


def test_migrated_request_span_tree(fleet):
    """A migrated request's tree carries request, queue, admit, prefill,
    decode, migrate, re-prefill and emit; engine and chaos rows exist."""
    _jm, _jp, pm, pp, wl = fleet
    tr = for_sim_ms()
    rep = FleetRouter(pm, [pp, pp], config=_fc(FleetConfig), device="cpu",
                      chaos=_preempt_chaos(), defense=FleetDefense(),
                      tracer=tr).run(wl)
    assert rep.migrations >= 1
    names = {}
    for e in tr.to_dict()["traceEvents"]:
        if e.get("cat") == "request":
            names.setdefault(e["tid"], []).append(e["name"])
    migrated = [tid for tid, ns in names.items() if "migrate" in ns]
    assert migrated, "no migrate annotation in any request tree"
    for stage in ("request", "queue", "admit", "prefill", "decode",
                  "migrate", "re-prefill", "emit"):
        assert stage in names[migrated[0]], stage
    cats = {e.get("cat") for e in tr.to_dict()["traceEvents"]}
    assert "engine" in cats and "chaos" in cats


def _chaos_run(side, fleet, out_dir):
    """The seeded, defended chaos scenario on one side: 6x straggler
    episodes on peer 1 that start and end mid-run, a preemption of peer 0,
    hedging of the larger half of the requests; tracer, registry, the default rules plus a kv rule, and the
    flight recorder. Returns (report, trace, metrics, alerts, bundles)."""
    jm, jp, pm, pp, _ = fleet
    wl = _workload(pm.cfg.padded_vocab, [5, 5, 12, 5, 9, 12, 5, 7, 12, 5,
                                         9, 5, 12, 7, 5, 9], gap_ms=4.0)
    o = obs if side == "port" else jobs
    faults = dict(n_peers=2, seed=0, straggler_peers=(1,),
                  straggler_factor=6.0, straggler_frac=0.5, straggler_len=6,
                  preemptions=((0, 6, 150.0),))
    rules = o.default_rules() + [o.Rule(
        name="kv-busy", metric="fleet/kv_utilization", kind="threshold",
        op=">", value=0.0, signal="window_max", window=2, resolve_after=2)]
    mreg = o.MetricsRegistry()
    watch = o.Watchtower(mreg, rules, unit_us=1000.0, clock="sim_ms")
    tracer = o.for_sim_ms()
    recorder = o.FlightRecorder(out_dir, capacity=32, metrics=mreg)
    tracer.recorder = recorder
    watch.on_alert(recorder.on_alert)
    watch.on_fault(recorder.on_fault)
    defense = dict(hedging=True, hedge_quantile=0.5, hedge_min_samples=3)
    kw = dict(tracer=tracer, metrics=mreg, watch=watch)
    if side == "port":
        router = FleetRouter(
            pm, [pp, pp], config=_fc(FleetConfig), device="cpu",
            chaos=ChaosConfig(FaultConfig(**faults), horizon_ticks=12),
            defense=FleetDefense(**defense), **kw)
    else:
        router = JaxFleetRouter(
            jm, [jp, jp], config=_fc(JaxFleetConfig),
            chaos=JaxChaosConfig(JaxFaultConfig(**faults), horizon_ticks=12),
            defense=JaxFleetDefense(**defense), **kw)
    rep = router.run(wl)
    bundles = {os.path.basename(p): open(p).read() for p in recorder.dumped}
    return rep, tracer.to_json(), mreg.to_json(), watch.to_jsonl(), bundles


def test_chaos_fleet_obs_equals_reference(fleet, oracle_scatters, tmp_path):
    """Byte-equal trace, metrics, alert log and postmortem bundles; the
    scenario migrates, hedges, fires and resolves alerts and dumps on a
    fault and on an alert; every file passes trace_check."""
    ref = _chaos_run("ref", fleet, str(tmp_path / "ref"))
    mine = _chaos_run("port", fleet, str(tmp_path / "port"))
    assert mine[0].to_json() == ref[0].to_json()
    assert mine[1] == ref[1]
    assert mine[2] == ref[2]
    assert mine[3] == ref[3]
    assert mine[4] == ref[4]
    rep = mine[0]
    assert rep.migrations >= 1 and rep.hedges >= 1 and rep.preemptions == 1
    states = {(e["rule"], e["state"]) for e in
              map(json.loads, mine[3].splitlines()[1:])}
    assert ("straggler-slowdown", "firing") in states
    assert ("straggler-slowdown", "resolved") in states
    reasons = [json.loads(doc)["reason"] for doc in mine[4].values()]
    assert any(r.startswith("fault-preempt") for r in reasons)
    assert any(r.startswith("alert-") for r in reasons)
    paths = []
    for name, text in (("t.json", mine[1]), ("m.json", mine[2]),
                       ("a.jsonl", mine[3])):
        (tmp_path / name).write_text(text if name == "a.jsonl"
                                     else text + "\n")
        paths.append(str(tmp_path / name))
    paths += [str(tmp_path / "port" / n) for n in mine[4]]
    out = subprocess.run([sys.executable, os.path.join(TOOLS,
                                                       "trace_check.py"),
                          *paths], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


# ----------------------------------------------------------------------------
# training: the sync loop, the async runtime, sweep cells
# ----------------------------------------------------------------------------

def test_train_trace_bit_identical():
    """Sync-train tracing on the step clock is deterministic; obs on leaves
    the History as obs off."""
    model = build_model(_tiny_cfg(get_reduced))
    task = MarkovLM(vocab=64, seed=0)

    def one_run(traced):
        tc = TrainConfig(lr=1e-3, total_steps=4, warmup_steps=1, seed=0)
        tr = for_steps() if traced else None
        mreg = MetricsRegistry() if traced else None

        def batches(step):
            return stack_batches([make_lm_batch(task, 2, 8, step, None,
                                                seed=0, device="cpu")
                                  for _ in range(2)])
        _, hist = train_codist(model, CodistConfig(n_models=2), tc, batches,
                               log_every=1, tracer=tr, metrics=mreg,
                               device="cpu")
        return hist, (tr.to_json(), mreg.to_json()) if traced else None

    (h1, a), (h2, b), (h0, _) = one_run(True), one_run(True), one_run(False)
    assert a == b and h1.records == h2.records == h0.records
    doc = json.loads(a[0])
    assert len([e for e in doc["traceEvents"]
                if e["ph"] == "X" and e["name"] == "step"]) == 4
    assert json.loads(a[1])["counters"]["train/comm_events"] == 4


def _assert_metrics_equal(got: str, want: str):
    """Equal registry exports, the loss gauges within 1e-5 relative."""
    g, w = json.loads(got), json.loads(want)
    assert set(g["gauges"]) == set(w["gauges"])
    for name in LOSS_GAUGES:
        if name in w["gauges"]:
            _close_rel(g["gauges"].pop(name), w["gauges"].pop(name))
    assert g == w


ASYNC_FAULTS = "straggler=1*3@0.5,preempt=1@2+3,fail=0@4"


def test_async_runtime_obs_equals_reference(monkeypatch, tmp_path):
    """``codist-async`` under a straggler, a preemption, a failure
    recovered from its snapshot and an elastic join, on the reference's
    params and batches, with tracer, registry, the default rules plus a
    publish-count rule and the flight recorder: trace, metrics, alert log
    and bundles byte-equal to the reference's."""
    steps = 6
    jmodel, model = _models()
    _inject_reference_init(monkeypatch, jmodel, seed=0, n=2)
    batches = _ref_batches(steps)
    out = {}
    for side in ("ref", "port"):
        o = jobs if side == "ref" else obs
        rules = o.default_rules() + [o.Rule(
            name="publishing", metric="runtime/publishes", kind="threshold",
            op=">=", value=4.0)]
        mreg = o.MetricsRegistry()
        watch = o.Watchtower(mreg, rules, unit_us=1_000_000.0, clock="sim_s")
        tracer = o.for_sim_seconds()
        rec = o.FlightRecorder(str(tmp_path / side / "pm"), metrics=mreg)
        tracer.recorder = rec
        watch.on_alert(rec.on_alert)
        watch.on_fault(rec.on_fault)
        kw = dict(staleness_bound=1, checkpoint_every=2, recover_after=2.0,
                  join_burn_in=2, checkpoint_dir=str(tmp_path / side / "ck"),
                  tracer=tracer, metrics=mreg, watch=watch)
        ccfg = dict(n_models=2, distill_loss="kl")
        if side == "ref":
            faults = replace(jax_parse_faults(ASYNC_FAULTS, 2, seed=0),
                             joins=((2, 2.5),))
            rep = JAsyncScheduler(
                jmodel, _tc(steps, JTrainConfig), JCodistConfig(**ccfg),
                lambda s: {n: jax.numpy.asarray(v)
                           for n, v in batches[s].items()},
                faults, **kw).run()
        else:
            faults = replace(parse_faults(ASYNC_FAULTS, 2, seed=0),
                             joins=((2, 2.5),))
            rep = AsyncScheduler(
                model, _tc(steps, TrainConfig), CodistConfig(**ccfg),
                lambda s: {n: torch.from_numpy(v)
                           for n, v in batches[s].items()},
                faults, device="cpu", **kw).run()
        out[side] = (rep, tracer.to_json(), mreg.to_json(), watch.to_jsonl(),
                     {os.path.basename(p): open(p).read()
                      for p in rec.dumped})
    ref, mine = out["ref"], out["port"]
    assert mine[0].sim_time == ref[0].sim_time
    assert mine[1] == ref[1]
    assert mine[2] == ref[2]
    assert mine[3] == ref[3]
    assert mine[4] == ref[4] and mine[4]
    events = json.loads(mine[1])["traceEvents"]
    for name in ("step", "preempted", "publish", "die", "recover", "join"):
        assert any(e["name"] == name for e in events), name
    assert '"rule":"publishing"' in mine[3]
    assert any(n.endswith("fault-fail.json") for n in mine[4])


def _cell(mode):
    spec = tiny_spec(modes=(mode,), steps=4, lr_schedules=(
        LRPoint("cos", lr=3e-3, warmup_frac=0.25),),
        alpha_schedules=(AlphaPoint("const"),))
    (cell,) = spec.cells()
    (jcell,) = jax_load_spec_from(spec).cells()
    return cell, jcell


@pytest.mark.parametrize("mode", ["codist", "allreduce"])
def test_sweep_cell_obs_equals_reference(mode, monkeypatch, tmp_path):
    """One sync cell through ``run_cell`` with trace, metrics and alerts on
    the reference's params and batches: trace and alert log byte-equal,
    metrics equal with the loss gauges within 1e-5 relative; obs on leaves
    the cell's summary and History as obs off."""
    cell, jcell = _cell(mode)
    _feed_reference(monkeypatch, cell)
    files = {}
    for side in ("ref", "port"):
        paths = {k: str(tmp_path / f"{side}.{k}")
                 for k in ("trace", "metrics", "alerts")}
        kw = dict(trace_path=paths["trace"], metrics_path=paths["metrics"],
                  alerts_path=paths["alerts"])
        if side == "ref":
            jax_run_cell(jcell, **kw)
        else:
            summary, hist = run_cell(cell, device="cpu", **kw)
        files[side] = {k: open(p).read() for k, p in paths.items()}
        assert trace_check.main(list(paths.values())) == 0
    assert files["port"]["trace"] == files["ref"]["trace"]
    assert files["port"]["alerts"] == files["ref"]["alerts"]
    _assert_metrics_equal(files["port"]["metrics"], files["ref"]["metrics"])
    _feed_reference(monkeypatch, cell)
    plain, plain_hist = run_cell(cell, device="cpu")
    assert plain == summary and plain_hist.records == hist.records


def test_two_cell_sweep_obs_equals_reference(monkeypatch, tmp_path):
    """``run_sweep`` over an all-reduce baseline and its codist cell with
    ``trace``, ``metrics`` and ``alerts``: the per-cell files equal the
    reference's (metrics up to the loss gauges), and so does the
    sweep-level loss-gap alert log up to its loss-derived values."""
    spec = tiny_spec(steps=3)
    jspec = jax_load_spec_from(spec)
    cells = spec.cells()
    assert [c.mode for c in cells] == ["allreduce", "codist"]
    queue = []

    def feed(cell, steps=None, **kw):
        _feed_reference(monkeypatch, cell)
        queue.append(cell.cell_id)
        return port_run_cell(cell, steps, **kw)
    from repro_torch.experiments import runner as port_runner
    port_run_cell = port_runner.run_cell
    monkeypatch.setattr(port_runner, "run_cell", feed)
    quiet = dict(trace=True, metrics=True, alerts=True, log=lambda _m: None)
    run_sweep(spec, str(tmp_path / "port"), device="cpu", **quiet)
    jax_run_sweep(jspec, str(tmp_path / "ref"), **quiet)
    assert queue == [c.cell_id for c in cells]
    port_dir = tmp_path / "port" / spec.name
    ref_dir = tmp_path / "ref" / spec.name
    for cell in cells:
        for ext in ("trace.json", "alerts.jsonl"):
            name = f"{cell.cell_id}.{ext}"
            assert (port_dir / name).read_text() == (ref_dir / name).read_text()
        name = f"{cell.cell_id}.metrics.json"
        _assert_metrics_equal((port_dir / name).read_text(),
                              (ref_dir / name).read_text())
    got, want = [[json.loads(line) for line in (d / "alerts.jsonl")
                  .read_text().splitlines()] for d in (port_dir, ref_dir)]
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        for key in ("value", "context"):
            gv, wv = g.pop(key), w.pop(key)
            if key == "value":
                _close_rel(gv, wv)
            else:
                assert set(gv) == set(wv)
        assert g == w
    obs_files = [str(p) for p in sorted(port_dir.iterdir())
                 if p.name == "alerts.jsonl" or p.name.endswith(
                     (".trace.json", ".metrics.json", ".alerts.jsonl"))]
    assert len(obs_files) == 7
    assert trace_check.main(obs_files) == 0


def test_trace_check_cli_subprocess(tmp_path):
    tr = for_sim_ms()
    tr.complete("tick", 0.0, 1.0, pid=1, tid=0, cat="engine")
    p = tmp_path / "t.json"
    tr.save(str(p))
    out = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "trace_check.py"), str(p)],
        capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
