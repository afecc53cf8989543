"""The port's Watchtower and flight recorder (``repro_torch.obs``) on the
CPU, mirrored from the reference's ``tests/test_watch.py`` and held against
the reference.

* Rule parsing names the offending clause; fire / resolve hysteresis,
  no-data skips, burn rate, EWMA drift, the canonical alert JSONL (which
  ``tools/trace_check.py`` and ``tools/ci_bitcheck.py`` read), negative
  times; the recorder's ring, dump budget, schema and fire-only dumps.
* The port's chaos fleet: two seeded runs write byte-identical alert logs
  and bundles (the straggler alert fires and resolves, a preemption and an
  alert each dump a bundle); alerting and the recorder leave the report
  as the plain run's.
* Speculative serving with a tracer, a registry and a Watchtower, against
  the reference's (its scatters on their jnp oracles): the trace (its
  ``spec_round`` markers, ``draft`` and ``verify`` spans), the metrics (the
  ``fleet/spec_*`` streams) and the alert log byte-equal.
* The serve CLI with ``--alerts --rules FILE --flight-recorder DIR``: two
  seeded runs write the same alert log and bundles.
"""
import json
import os
import sys

import pytest
import torch

from repro import obs as jobs
from repro.serve.fleet import FleetConfig as JaxFleetConfig
from repro.serve.fleet import FleetRouter as JaxFleetRouter
from repro.serve.fleet import SpecConfig as JaxSpecConfig
from repro_torch import obs
from repro_torch.obs import (ALERTS_SCHEMA_VERSION, POSTMORTEM_SCHEMA_VERSION,
                             FlightRecorder, MetricsRegistry, Rule,
                             Watchtower, default_rules, for_sim_ms,
                             load_rules, parse_rules)
from repro_torch.runtime import FaultConfig
from repro_torch.serve.fleet import (ChaosConfig, FleetConfig, FleetDefense,
                                     FleetRouter, SpecConfig)
from test_torch_obs import _fc, fleet, oracle_scatters  # noqa: F401

torch.set_num_threads(2)

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)
import ci_bitcheck  # noqa: E402
import trace_check  # noqa: E402


def _rule(**kw):
    base = dict(name="r", metric="m", kind="threshold", op=">", value=1.0)
    base.update(kw)
    return parse_rules([base])[0]


# ----------------------------------------------------------------------------
# rule parsing
# ----------------------------------------------------------------------------

class TestRuleParsing:
    def test_unknown_key_named(self):
        with pytest.raises(ValueError, match=r"'windoww'"):
            _rule(windoww=4)

    def test_missing_required_key_named(self):
        with pytest.raises(ValueError, match="missing required key 'op'"):
            parse_rules([{"name": "x", "metric": "m", "kind": "threshold",
                          "value": 1.0}])

    def test_bad_name_rejected(self):
        with pytest.raises(ValueError, match=r"'bad\.dot'"):
            _rule(name="bad.dot")

    def test_bad_kind_op_signal_severity(self):
        with pytest.raises(ValueError, match="kind 'spline'"):
            _rule(kind="spline")
        with pytest.raises(ValueError, match="op '~'"):
            _rule(op="~")
        with pytest.raises(ValueError, match="signal 'p17'"):
            _rule(signal="p17")
        with pytest.raises(ValueError, match="severity 'mild'"):
            _rule(severity="mild")

    def test_int_and_unit_interval_bounds(self):
        with pytest.raises(ValueError, match="window 0"):
            _rule(window=0)
        with pytest.raises(ValueError, match="fire_after"):
            _rule(fire_after=-1)
        with pytest.raises(ValueError, match="alpha"):
            _rule(alpha=1.5)
        with pytest.raises(ValueError, match="budget"):
            _rule(budget=0.0)

    def test_duplicate_names_rejected(self):
        spec = dict(name="dup", metric="m", kind="threshold", op=">",
                    value=1.0)
        with pytest.raises(ValueError, match="duplicate"):
            parse_rules([spec, dict(spec)])

    def test_load_rules_both_forms(self, tmp_path):
        specs = [dict(name="a", metric="m", kind="threshold", op=">",
                      value=1.0)]
        bare = tmp_path / "bare.json"
        bare.write_text(json.dumps(specs))
        wrapped = tmp_path / "wrapped.json"
        wrapped.write_text(json.dumps({"rules": specs}))
        assert load_rules(str(bare)) == load_rules(str(wrapped))
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"rule": specs}))
        with pytest.raises(ValueError, match="'rules' key"):
            load_rules(str(bad))

    def test_default_pack_equals_the_reference(self):
        names = {r.name for r in default_rules(slo_ms=25.0)}
        assert {"straggler-slowdown", "spec-accept-collapse",
                "canary-divergence", "mailbox-staleness", "slo-burn-rate",
                "kv-pool-saturation", "loss-gap-drift"} <= names
        assert [r.to_dict() for r in default_rules(slo_ms=25.0)] == [
            r.to_dict() for r in jobs.default_rules(slo_ms=25.0)]


# ----------------------------------------------------------------------------
# engine semantics
# ----------------------------------------------------------------------------

class TestEngine:
    def test_fire_resolve_hysteresis(self):
        m = MetricsRegistry()
        w = Watchtower(m, [_rule(metric="g", fire_after=2, resolve_after=2)],
                       unit_us=1000.0, clock="test")
        events = []
        for t, v in enumerate([5.0, 5.0, 0.0, 5.0, 0.0, 0.0, 0.0]):
            m.gauge("g").set(v)
            events += w.evaluate(t)
        assert [(e["ts"], e["state"]) for e in events] == [
            (1000, "firing"), (5000, "resolved")]
        assert w.firing() == []
        assert w.summary()["counts"] == {"r__firing": 1, "r__resolved": 1}

    def test_no_data_leaves_streaks_untouched(self):
        m = MetricsRegistry()
        w = Watchtower(m, [_rule(metric="absent")])
        assert w.evaluate(0) == [] and w.n_events == 0
        w2 = Watchtower(m, [_rule(metric="h", min_count=3)])
        m.histogram("h").observe(99.0)
        assert w2.evaluate(0) == []

    def test_burn_rate_budget(self):
        m = MetricsRegistry()
        w = Watchtower(m, [_rule(metric="lat", kind="burn_rate", op=">",
                                 value=50.0, window=4, budget=0.5)])
        h = m.histogram("lat")
        for v in (10.0, 60.0, 10.0, 10.0):
            h.observe(v)
        assert w.evaluate(0) == []
        h.observe(70.0)
        ev = w.evaluate(1)
        assert ev and ev[0]["state"] == "firing" and ev[0]["value"] == 0.5

    def test_ewma_drift_watches_change_then_self_resolves(self):
        m = MetricsRegistry()
        w = Watchtower(m, [_rule(metric="g", kind="ewma_drift", op=">",
                                 value=0.5, alpha=0.5)])
        m.gauge("g").set(1.0)
        assert w.evaluate(0) == []
        m.gauge("g").set(3.0)
        assert w.evaluate(1)[0]["state"] == "firing"
        events = []
        for t in range(2, 8):
            events += w.evaluate(t)
        assert [e["state"] for e in events] == ["resolved"]

    def test_jsonl_canonical_and_validates(self, tmp_path):
        m = MetricsRegistry()
        w = Watchtower(m, [_rule(metric="g")])
        m.gauge("g").set(9.0)
        w.evaluate(2)
        path = tmp_path / "alerts.jsonl"
        w.save(str(path))
        head = json.loads(path.read_text().splitlines()[0])
        assert head["schema_version"] == ALERTS_SCHEMA_VERSION
        assert head["kind"] == "alerts"
        assert trace_check.main([str(path)]) == 0
        assert ci_bitcheck.main([str(path), str(path), "--require",
                                 "schema_version",
                                 "--expect", "counts.r__firing>=1"]) == 0

    def test_negative_time_rejected(self):
        w = Watchtower(MetricsRegistry(), [_rule(metric="g")])
        with pytest.raises(ValueError, match="negative"):
            w.evaluate(-1.0)


# ----------------------------------------------------------------------------
# flight recorder
# ----------------------------------------------------------------------------

class TestFlightRecorder:
    def test_ring_bound_enforced(self, tmp_path):
        fr = FlightRecorder(str(tmp_path), capacity=4)
        for i in range(10):
            fr.offer(i, i, {"ts": i, "name": f"e{i}"})
        evs = fr.events()
        assert len(evs) == 4 and evs[0]["ts"] == 6 and evs[-1]["ts"] == 9
        assert fr.n_offered == 10

    def test_dump_budget_and_schema(self, tmp_path):
        fr = FlightRecorder(str(tmp_path), capacity=4, max_dumps=1)
        fr.offer(0, 0, {"ts": 0, "name": "e"})
        p1 = fr.dump("alert-test", 5)
        assert p1 and os.path.exists(p1)
        assert fr.dump("alert-again", 6) is None
        assert len(fr.dumped) == 1
        with open(p1) as f:
            doc = json.load(f)
        assert doc["schema_version"] == POSTMORTEM_SCHEMA_VERSION
        assert doc["kind"] == "postmortem" and doc["n_events_seen"] == 1
        assert trace_check.main([p1]) == 0

    def test_invalid_bounds_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="capacity"):
            FlightRecorder(str(tmp_path), capacity=0)
        with pytest.raises(ValueError, match="max_dumps"):
            FlightRecorder(str(tmp_path), max_dumps=0)

    def test_dumps_on_firing_not_resolve(self, tmp_path):
        fr = FlightRecorder(str(tmp_path))
        assert fr.on_alert({"rule": "x", "state": "resolved", "ts": 1}) \
            is None
        assert fr.on_alert({"rule": "x", "state": "firing", "ts": 2})


# ----------------------------------------------------------------------------
# the chaos fleet (the reference's tiny model and scenario; the ``fleet``
# and ``oracle_scatters`` fixtures and helpers are test_torch_obs.py's)
# ----------------------------------------------------------------------------

# fires while any engine holds live KV (utilization is recorded before
# eviction, so it never reads 0)
_KV_RULE = Rule(name="kv-busy", metric="fleet/kv_utilization",
                kind="threshold", op=">", value=0.0, signal="window_max",
                window=2, resolve_after=2)


def _chaos_watch_run(fleet, out_dir):
    _jm, _jp, pm, pp, wl = fleet
    chaos = ChaosConfig(FaultConfig(n_peers=2, seed=0, straggler_peers=(1,),
                                    straggler_factor=6.0,
                                    straggler_frac=0.9, straggler_len=6,
                                    preemptions=((0, 6, 150.0),)),
                        horizon_ticks=12)
    rules = [r for r in default_rules()
             if r.name == "straggler-slowdown"] + [_KV_RULE]
    mreg = MetricsRegistry()
    watch = Watchtower(mreg, rules, unit_us=1000.0, clock="sim_ms")
    tracer = for_sim_ms()
    recorder = FlightRecorder(out_dir, capacity=32, metrics=mreg)
    tracer.recorder = recorder
    watch.on_alert(recorder.on_alert)
    watch.on_fault(recorder.on_fault)
    rep = FleetRouter(pm, [pp, pp], config=_fc(FleetConfig), device="cpu",
                      chaos=chaos, defense=FleetDefense(), tracer=tracer,
                      metrics=mreg, watch=watch).run(wl)
    bundles = []
    for p in recorder.dumped:
        with open(p) as f:
            bundles.append(f.read())
    return rep, watch, bundles


def test_chaos_alert_log_bit_identical(fleet, tmp_path):
    a = _chaos_watch_run(fleet, str(tmp_path / "a"))
    b = _chaos_watch_run(fleet, str(tmp_path / "b"))
    assert a[1].to_jsonl() == b[1].to_jsonl()
    assert a[2] == b[2] and a[2], "no postmortem bundles dumped"
    counts = a[1].summary()["counts"]
    assert counts.get("kv-busy__firing", 0) >= 1
    assert counts.get("straggler-slowdown__firing", 0) >= 1
    assert counts.get("straggler-slowdown__resolved", 0) >= 1
    reasons = [json.loads(doc)["reason"] for doc in a[2]]
    assert any(r.startswith("fault-preempt") for r in reasons)
    assert any(r.startswith("alert-") for r in reasons)
    path = tmp_path / "alerts.jsonl"
    a[1].save(str(path))
    assert trace_check.main([str(path)]) == 0


def test_watchtower_does_not_perturb_the_fleet(fleet, tmp_path):
    _jm, _jp, pm, pp, wl = fleet
    plain = FleetRouter(pm, [pp, pp], config=_fc(FleetConfig),
                        device="cpu").run(wl)
    mreg = MetricsRegistry()
    watch = Watchtower(mreg, default_rules(), unit_us=1000.0)
    recorder = FlightRecorder(str(tmp_path), metrics=mreg)
    watch.on_alert(recorder.on_alert)
    watch.on_fault(recorder.on_fault)
    instrumented = FleetRouter(pm, [pp, pp], config=_fc(FleetConfig),
                               device="cpu", metrics=mreg,
                               watch=watch).run(wl)
    assert plain.to_json() == instrumented.to_json()


def test_speculative_obs_equals_reference(fleet, oracle_scatters):
    """Ring-paired speculation (k = 3) on identical peers with a tracer, a
    registry and the default rules: trace, metrics and alert log equal the
    reference's byte for byte."""
    jm, jp, pm, pp, wl = fleet
    out = {}
    for side in ("ref", "port"):
        o = jobs if side == "ref" else obs
        mreg = o.MetricsRegistry()
        tracer = o.for_sim_ms()
        watch = o.Watchtower(mreg, o.default_rules(), unit_us=1000.0,
                             clock="sim_ms")
        kw = dict(policy="speculative", tracer=tracer, metrics=mreg,
                  watch=watch)
        if side == "ref":
            router = JaxFleetRouter(jm, [jp, jp], config=_fc(JaxFleetConfig),
                                    spec=JaxSpecConfig(k=3), **kw)
        else:
            router = FleetRouter(pm, [pp, pp], config=_fc(FleetConfig),
                                 spec=SpecConfig(k=3), device="cpu", **kw)
        rep = router.run(wl)
        out[side] = (rep.to_json(), tracer.to_json(), mreg.to_json(),
                     watch.to_jsonl())
    assert out["port"] == out["ref"]
    doc = json.loads(out["port"][1])
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"spec_round", "draft", "verify"} <= names
    counters = json.loads(out["port"][2])["counters"]
    assert counters["fleet/spec_rounds"] > 0
    assert json.loads(out["port"][0])["spec_accept_rate"] == 1.0


def test_serve_cli_alert_log_and_bundles_reproducible(tmp_path, capsys):
    from repro_torch.launch.serve import main
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps([
        {"name": "kv-busy", "metric": "fleet/kv_utilization",
         "kind": "threshold", "op": ">", "value": 0.0, "resolve_after": 2},
        {"name": "straggler-slowdown", "metric": "fleet/slowdown",
         "kind": "threshold", "signal": "window_max", "op": ">",
         "value": 2.0, "window": 8, "resolve_after": 2}]))
    runs = []
    for run in ("a", "b"):
        d = tmp_path / run
        main(["--device", "cpu", "--arch", "qwen2-7b", "--requests", "6",
              "--max-new", "3", "--max-prompt", "8", "--slots", "2",
              "--faults", "straggler=1*4@0.5,preempt=0@2+40", "--alerts",
              str(d / "alerts.jsonl"), "--rules", str(rules),
              "--flight-recorder", str(d / "pm")])
        assert "flight recorder:" in capsys.readouterr().out
        files = sorted((d / "pm").iterdir())
        runs.append([(d / "alerts.jsonl").read_text()]
                    + [(f.name, f.read_text()) for f in files])
        assert trace_check.main([str(d / "alerts.jsonl"),
                                 *map(str, files)]) == 0
    assert runs[0] == runs[1] and len(runs[0]) > 1
    assert '"rule":"kv-busy"' in runs[0][0]
