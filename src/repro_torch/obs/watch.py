"""Watchtower: deterministic alerting over the metrics registry.

The obs layer made every run emit byte-identical traces and
metrics — but they were write-only. The Watchtower closes the loop: it
evaluates **declarative rules** over the live ``MetricsRegistry`` streams
on the same simulated clock the subsystems tick on, firing and resolving
alerts as a canonical JSONL log that is bit-identical per seed and
therefore CI-gateable exactly like the SLO reports (the
``obs-watch-smoke`` job byte-compares two seeded chaos runs).

Three rule kinds:

* ``threshold``   — compare one signal of the watched stream against a
                    bound (``fleet/kv_utilization >= 0.95``)
* ``burn_rate``   — the fraction of the last ``window`` samples breaching
                    the bound must stay under ``budget`` (the SLO-burn
                    idiom: "more than half the recent TTFTs over the SLO")
* ``ewma_drift``  — compare the signal's deviation from its own
                    exponentially-weighted baseline (catches the paper's
                    codist-vs-baseline loss-gap drifting after it had
                    converged, without hardcoding an absolute loss level)

Hysteresis is explicit: a rule must breach ``fire_after`` consecutive
evaluations to fire and recover ``resolve_after`` consecutive evaluations
to resolve, so a single straggler tick does not flap the alert log.

Everything is a pure function of the observation stream: no wall clock,
no randomness, and — critically — evaluation only *reads* metrics through
the registry's non-creating ``peek``, so a run with alerting enabled
exports byte-identical metrics/trace/report artifacts to one without
(pinned by ``tests/test_watch.py`` and the overhead-off chaos gate).
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.fsio import atomic_write_text
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry

ALERTS_SCHEMA_VERSION = 1

KINDS = ("threshold", "burn_rate", "ewma_drift")
SIGNALS = ("value", "count", "window_mean", "window_min", "window_max",
           "p50", "p90", "p99")
OPS = (">", "<", ">=", "<=")
SEVERITIES = ("info", "warning", "critical")

# rule names key the alert log and CI `--expect counts.<rule>__firing>=1`
# clauses, whose dotted-path grammar allows [A-Za-z0-9_-] segments — so no
# dots (or anything else) here
_NAME_RE = re.compile(r"^[A-Za-z0-9_-]+$")

_OP_FN: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
}


@dataclass(frozen=True)
class Rule:
    """One declarative alert rule (see module docstring for semantics)."""

    name: str
    metric: str
    kind: str                  # threshold | burn_rate | ewma_drift
    op: str                    # > | < | >= | <=
    value: float               # the bound (threshold / per-sample / drift)
    signal: str = "value"      # which view of the stream to compare
    window: int = 8            # samples for window_* / p* / burn_rate
    fire_after: int = 1        # consecutive breaches before firing
    resolve_after: int = 1     # consecutive recoveries before resolving
    severity: str = "warning"
    alpha: float = 0.25        # EWMA smoothing (ewma_drift only)
    budget: float = 0.5        # breach fraction that fires (burn_rate only)
    min_count: int = 1         # samples required before evaluating at all

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "metric": self.metric, "kind": self.kind,
            "op": self.op, "value": self.value, "signal": self.signal,
            "window": self.window, "fire_after": self.fire_after,
            "resolve_after": self.resolve_after, "severity": self.severity,
            "alpha": self.alpha, "budget": self.budget,
            "min_count": self.min_count,
        }


_RULE_KEYS = frozenset(Rule(name="x", metric="x", kind="threshold", op=">",
                            value=0.0).to_dict())


def parse_rule(spec: Dict[str, Any], where: str = "") -> Rule:
    """Validate one rule spec dict; errors name the offending clause in
    the style of ``parse_faults`` so a typo'd rules file is a one-line
    fix, not a stack trace."""
    label = where or repr(spec.get("name", spec))

    def err(msg: str) -> ValueError:
        return ValueError(f"alert rule {label}: {msg}")

    if not isinstance(spec, dict):
        raise err(f"expected a mapping, got {type(spec).__name__}")
    unknown = sorted(set(spec) - _RULE_KEYS)
    if unknown:
        raise err(f"unknown key(s) {unknown} (known: {sorted(_RULE_KEYS)})")
    for key in ("name", "metric", "kind", "op", "value"):
        if key not in spec:
            raise err(f"missing required key {key!r}")
    name = spec["name"]
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise err(f"name {name!r} must match {_NAME_RE.pattern} "
                  "(it keys the alert log and CI expect-clauses)")
    if not isinstance(spec["metric"], str) or not spec["metric"]:
        raise err(f"metric {spec['metric']!r} must be a non-empty string")
    if spec["kind"] not in KINDS:
        raise err(f"kind {spec['kind']!r} not one of {KINDS}")
    if spec["op"] not in OPS:
        raise err(f"op {spec['op']!r} not one of {OPS}")
    if not isinstance(spec["value"], (int, float)) \
            or isinstance(spec["value"], bool):
        raise err(f"value {spec['value']!r} must be a number")
    if spec.get("signal", "value") not in SIGNALS:
        raise err(f"signal {spec.get('signal')!r} not one of {SIGNALS}")
    if spec.get("severity", "warning") not in SEVERITIES:
        raise err(f"severity {spec.get('severity')!r} not one of "
                  f"{SEVERITIES}")
    for key, lo in (("window", 1), ("fire_after", 1), ("resolve_after", 1),
                    ("min_count", 0)):
        v = spec.get(key, lo if lo else 1)
        if not isinstance(v, int) or isinstance(v, bool) or v < lo:
            raise err(f"{key} {v!r} must be an integer >= {lo}")
    for key in ("alpha", "budget"):
        v = spec.get(key, 0.5)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not 0.0 < float(v) <= 1.0:
            raise err(f"{key} {v!r} must be in (0, 1]")
    return Rule(
        name=name, metric=spec["metric"], kind=spec["kind"], op=spec["op"],
        value=float(spec["value"]), signal=spec.get("signal", "value"),
        window=spec.get("window", 8),
        fire_after=spec.get("fire_after", 1),
        resolve_after=spec.get("resolve_after", 1),
        severity=spec.get("severity", "warning"),
        alpha=float(spec.get("alpha", 0.25)),
        budget=float(spec.get("budget", 0.5)),
        min_count=spec.get("min_count", 1))


def parse_rules(specs: Sequence[Dict[str, Any]]) -> List[Rule]:
    if not isinstance(specs, (list, tuple)):
        raise ValueError(
            f"alert rules: expected a list of rule mappings, got "
            f"{type(specs).__name__}")
    rules: List[Rule] = []
    seen: set = set()
    for i, spec in enumerate(specs):
        where = (repr(spec["name"])
                 if isinstance(spec, dict) and isinstance(
                     spec.get("name"), str)
                 else f"#{i}")
        rule = parse_rule(spec, where=where)
        if rule.name in seen:
            raise ValueError(f"alert rule {rule.name!r}: duplicate name")
        seen.add(rule.name)
        rules.append(rule)
    return rules


def load_rules(path: str) -> List[Rule]:
    """Load rules from a JSON file: either a bare list of rule mappings
    or ``{"rules": [...]}``."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        if "rules" not in doc:
            raise ValueError(
                f"alert rules file {path!r}: mapping form must have a "
                f"'rules' key (got keys {sorted(doc)})")
        doc = doc["rules"]
    return parse_rules(doc)


def default_rules(slo_ms: float = 50.0) -> List[Rule]:
    """The built-in rule pack over the codistillation-specific signals the
    repo already emits (docs/observability.md has the catalog)."""
    return parse_rules([
        # chaos straggler: the engine publishes its chaos slowdown
        # multiplier every tick; any recent tick over 2x means a peer is
        # visibly degraded. resolve_after=2 so the episode must genuinely
        # end, not dip for one tick.
        {"name": "straggler-slowdown", "metric": "fleet/slowdown",
         "kind": "threshold", "signal": "window_max", "op": ">",
         "value": 2.0, "window": 8, "fire_after": 1, "resolve_after": 2,
         "severity": "warning"},
        # speculative accept-rate collapse — the label-free quality
        # canary: mean accepted-prefix length under 1 token means the
        # drafter and verifier have diverged
        {"name": "spec-accept-collapse", "metric": "fleet/spec_accept",
         "kind": "threshold", "signal": "window_mean", "op": "<",
         "value": 1.0, "window": 16, "min_count": 16,
         "severity": "critical"},
        # distill_pair canary divergence (end-of-run report gauge)
        {"name": "canary-divergence", "metric": "report/canary_mean_mse",
         "kind": "threshold", "op": ">", "value": 1.0,
         "severity": "critical"},
        # async-runtime mailbox staleness breach
        {"name": "mailbox-staleness", "metric": "runtime/mailbox_staleness_mean",
         "kind": "threshold", "op": ">", "value": 4.0,
         "severity": "warning"},
        # SLO burn rate: more than half the last 16 first-token latencies
        # over the SLO
        {"name": "slo-burn-rate", "metric": "fleet/ttft_live_ms",
         "kind": "burn_rate", "op": ">", "value": float(slo_ms),
         "window": 16, "budget": 0.5, "min_count": 4,
         "severity": "critical"},
        # KV pool occupancy saturation: sustained >= 95% means admission
        # is about to stall
        {"name": "kv-pool-saturation", "metric": "fleet/kv_utilization",
         "kind": "threshold", "op": ">=", "value": 0.95, "fire_after": 3,
         "resolve_after": 2, "severity": "warning"},
        # codist-vs-baseline loss gap drifting above its own EWMA baseline
        # in sweeps (the paper's "properly accounted for" caveat)
        {"name": "loss-gap-drift", "metric": "sweep/loss_gap",
         "kind": "ewma_drift", "op": ">", "value": 0.5, "alpha": 0.25,
         "severity": "warning"},
    ])


class _RuleState:
    __slots__ = ("streak_bad", "streak_ok", "firing", "ewma")

    def __init__(self) -> None:
        self.streak_bad = 0
        self.streak_ok = 0
        self.firing = False
        self.ewma: Optional[float] = None


class Watchtower:
    """Evaluates rules against a registry on a simulated clock.

    Call ``evaluate(t)`` at natural points of the simulated timeline (the
    fleet calls it once per decode tick, the runtime once per virtual-time
    step, the trainer at log points). ``unit_us`` quantizes ``t`` to
    integer microseconds at record time, the same discipline as the
    tracer, so the alert log sorts and serializes identically on every
    machine.
    """

    def __init__(self, registry: MetricsRegistry, rules: Sequence[Rule],
                 unit_us: float = 1000.0, clock: str = "sim_ms"):
        if unit_us <= 0:
            raise ValueError(f"unit_us={unit_us} must be > 0")
        self.registry = registry
        self.rules = list(rules)
        self.unit_us = float(unit_us)
        self.clock = clock
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._events: List[Dict[str, Any]] = []
        self._seq = 0
        self._alert_cbs: List[Callable[[Dict[str, Any]], None]] = []
        self._fault_cbs: List[Callable[[Dict[str, Any]], None]] = []

    # ---- callbacks (the flight recorder hooks in here) ---------------------
    def on_alert(self, cb: Callable[[Dict[str, Any]], None]) -> None:
        self._alert_cbs.append(cb)

    def on_fault(self, cb: Callable[[Dict[str, Any]], None]) -> None:
        self._fault_cbs.append(cb)

    def note_fault(self, kind: str, t: float,
                   context: Optional[Dict[str, Any]] = None) -> None:
        """An injected fault (preempt/fail/straggle) happened: notify the
        fault callbacks so the flight recorder can dump a bundle. Faults
        are *not* alert events — they are causes, recorded in the
        postmortem, while the alert log records observed symptoms."""
        ev = {"kind": kind, "ts": self._ts(t), "context": context or {}}
        for cb in self._fault_cbs:
            cb(ev)

    # ---- signal resolution -------------------------------------------------
    def _ts(self, t: float) -> int:
        ts = int(round(float(t) * self.unit_us))
        if ts < 0:
            raise ValueError(f"negative timestamp {t} on a simulated clock")
        return ts

    @staticmethod
    def _samples(stream: Any, window: int) -> Optional[List[float]]:
        if isinstance(stream, Histogram):
            return [float(v) for v in stream.values[-window:]]
        if isinstance(stream, Gauge):
            return stream.window(window)
        if isinstance(stream, Counter):
            return [float(stream.value)]
        return None

    def _signal(self, rule: Rule, stream: Any) -> Optional[float]:
        """The rule's view of the stream, or None when there is not enough
        data to evaluate (streaks are left untouched in that case)."""
        window = self._samples(stream, rule.window)
        if window is None:
            return None
        n_total = (stream.count if isinstance(stream, Histogram)
                   else len(window))
        if n_total < rule.min_count or not window:
            return None
        sig = rule.signal
        if sig == "value":
            if isinstance(stream, (Counter, Gauge)):
                return float(stream.value)
            return window[-1]
        if sig == "count":
            return float(stream.count if isinstance(stream, Histogram)
                         else len(window))
        if sig == "window_mean":
            return float(sum(window) / len(window))
        if sig == "window_min":
            return float(min(window))
        if sig == "window_max":
            return float(max(window))
        q = {"p50": 50.0, "p90": 90.0, "p99": 99.0}[sig]
        return float(np.percentile(np.asarray(window, np.float64), q))

    def _breach(self, rule: Rule, stream: Any) -> Optional[Dict[str, Any]]:
        """None = not enough data; otherwise {"bad": bool, "value": float}
        plus kind-specific context."""
        op = _OP_FN[rule.op]
        if rule.kind == "burn_rate":
            window = self._samples(stream, rule.window)
            if window is None:
                return None
            n_total = (stream.count if isinstance(stream, Histogram)
                       else len(window))
            if n_total < rule.min_count or not window:
                return None
            breaching = sum(1 for v in window if op(v, rule.value))
            frac = breaching / len(window)
            return {"bad": frac >= rule.budget, "value": float(frac),
                    "n": len(window)}
        sig = self._signal(rule, stream)
        if sig is None:
            return None
        if rule.kind == "threshold":
            return {"bad": op(sig, rule.value), "value": sig}
        # ewma_drift: deviation of the signal from its own EWMA baseline.
        # The baseline seeds on the first sample (no drift by definition)
        # and updates every evaluation, breaching or not — a sustained
        # breach therefore self-resolves once the new level becomes the
        # baseline, which is the point: this rule watches *change*.
        st = self._state[rule.name]
        if st.ewma is None:
            st.ewma = sig
            return {"bad": False, "value": 0.0, "ewma": sig}
        drift = sig - st.ewma
        st.ewma = st.ewma + rule.alpha * (sig - st.ewma)
        return {"bad": op(drift, rule.value), "value": float(drift),
                "ewma": float(st.ewma)}

    # ---- evaluation --------------------------------------------------------
    def evaluate(self, t: float) -> List[Dict[str, Any]]:
        """Evaluate every rule at simulated time ``t``; returns the alert
        events emitted by this call (also appended to the log)."""
        ts = self._ts(t)
        emitted: List[Dict[str, Any]] = []
        for rule in self.rules:
            stream = self.registry.peek(rule.metric)
            if stream is None:
                continue
            res = self._breach(rule, stream)
            if res is None:
                continue
            st = self._state[rule.name]
            if res["bad"]:
                st.streak_bad += 1
                st.streak_ok = 0
            else:
                st.streak_ok += 1
                st.streak_bad = 0
            new_state: Optional[str] = None
            if not st.firing and st.streak_bad >= rule.fire_after:
                st.firing = True
                new_state = "firing"
            elif st.firing and st.streak_ok >= rule.resolve_after:
                st.firing = False
                new_state = "resolved"
            if new_state is None:
                continue
            context = {k: v for k, v in res.items()
                       if k not in ("bad", "value")}
            context["signal"] = rule.signal
            context["window"] = rule.window
            ev = {"ts": ts, "seq": self._seq, "rule": rule.name,
                  "state": new_state, "value": res["value"],
                  "threshold": rule.value, "op": rule.op,
                  "metric": rule.metric, "kind": rule.kind,
                  "severity": rule.severity, "context": context}
            self._seq += 1
            self._events.append(ev)
            emitted.append(ev)
            for cb in self._alert_cbs:
                cb(ev)
        return emitted

    # ---- introspection / export --------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self._events)

    def firing(self) -> List[str]:
        """Names of rules currently in the firing state, sorted."""
        return sorted(n for n, st in self._state.items() if st.firing)

    def summary(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {}
        for ev in self._events:
            key = f"{ev['rule']}__{ev['state']}"
            counts[key] = counts.get(key, 0) + 1
        return {"n_events": len(self._events),
                "counts": dict(sorted(counts.items())),
                "firing": self.firing()}

    def to_jsonl(self) -> str:
        """Header line + one canonical JSON line per alert event, sorted
        by (ts, seq) — byte-identical per seed, the CI gate's whole
        contract."""
        header = {"schema_version": ALERTS_SCHEMA_VERSION, "kind": "alerts",
                  "clock": self.clock, "unit_us": self.unit_us,
                  "n_rules": len(self.rules)}
        lines = [json.dumps(header, sort_keys=True, separators=(",", ":"))]
        for ev in sorted(self._events, key=lambda e: (e["ts"], e["seq"])):
            lines.append(json.dumps(ev, sort_keys=True,
                                    separators=(",", ":")))
        return "\n".join(lines) + "\n"

    def save(self, path: str) -> None:
        atomic_write_text(path, self.to_jsonl())
