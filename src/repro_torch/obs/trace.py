"""Deterministic span/event tracer over the repo's *simulated* clocks.

Every subsystem in this codebase already runs on a deterministic virtual
timeline — the async runtime's virtual cluster clock (simulated seconds),
the serving fleet's decode-tick cost model (simulated milliseconds), and
the training loop's step counter. The tracer records spans, instants and
counter samples against those clocks and exports **Chrome trace-event
JSON** (the ``traceEvents`` array format), which Perfetto and
``chrome://tracing`` load directly. Because timestamps come from the
simulated clocks and the export is canonically ordered and serialized,
the trace file for a seeded run is **bit-identical across machines and
reruns** — traces are CI-gateable artifacts, exactly like the SLO reports
(``tools/trace_check.py`` validates structure; the ``trace-smoke`` CI job
diffs two runs byte-for-byte).

Event kinds (the Chrome ``ph`` phases used — see docs/observability.md for
the span taxonomy):

  * ``X`` complete spans  — engine ticks, peer steps (both endpoints known)
  * ``B``/``E`` begin/end — host-side scoped spans; nesting is enforced
  * ``b``/``e``/``n``     — nestable *async* spans keyed by ``(cat, id)``:
                            the per-request span trees, which survive
                            migration across peers (the id is the request
                            id, not the placement)
  * ``i`` instants        — publish / die / revive / preempt markers
  * ``C`` counters        — KV-pool occupancy, analytic decode HBM bytes
                            and FLOPs, mailbox staleness, comm bytes
  * ``M`` metadata        — process/thread naming for the UI

Times passed to the API are floats in the tracer's clock domain and are
quantized to integer microseconds via ``unit_us`` at record time (Chrome
``ts`` is microseconds): quantizing at record time, not export time, keeps
ordering and arithmetic integer-exact and therefore reproducible.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.fsio import atomic_write_text

TRACE_SCHEMA_VERSION = 1

# the ph phases this tracer emits (and tools/trace_check.py validates)
PHASES = ("X", "B", "E", "b", "e", "n", "i", "C", "M")


class TraceError(ValueError):
    """A recorded event violates a trace invariant (unbalanced span,
    non-monotonic clock, negative duration)."""


class Tracer:
    """Deterministic trace-event recorder on one simulated clock.

    ``unit_us`` converts the caller's clock domain into Chrome's
    microsecond ``ts``: 1000 for simulated milliseconds (the fleet),
    1_000_000 for simulated seconds (the async runtime), 1000 for training
    steps (one step renders as 1 ms). ``clock`` names the domain in the
    exported file so readers know what a microsecond means.
    """

    def __init__(self, unit_us: float = 1000.0, clock: str = "sim_ms"):
        if unit_us <= 0:
            raise TraceError(f"unit_us={unit_us} must be > 0")
        self.unit_us = float(unit_us)
        self.clock = clock
        self._events: List[Tuple[int, int, Dict[str, Any]]] = []  # (ts,seq,ev)
        self._seq = 0
        # (pid, tid) -> stack of (name, ts) for B/E balance + monotonicity
        self._open: Dict[Tuple[int, int], List[Tuple[str, int]]] = {}
        # (cat, id) -> stack of names for nestable-async balance
        self._open_async: Dict[Tuple[str, int], List[str]] = {}
        self._named: set = set()     # (kind, pid[, tid]) metadata emitted
        # optional FlightRecorder (obs/recorder.py): offered every event as
        # it is recorded so postmortem bundles can carry the last-N events
        # even while spans are still open (to_dict() refuses dangling spans)
        self.recorder: Optional[Any] = None

    # ---- helpers -----------------------------------------------------------
    def _ts(self, t: float) -> int:
        ts = int(round(float(t) * self.unit_us))
        if ts < 0:
            raise TraceError(f"negative timestamp {t} on a simulated clock")
        return ts

    def _push(self, ev: Dict[str, Any]) -> None:
        self._events.append((ev["ts"], self._seq, ev))
        if self.recorder is not None:
            self.recorder.offer(ev["ts"], self._seq, ev)
        self._seq += 1

    @staticmethod
    def _base(name: str, ph: str, ts: int, pid: int, tid: int,
              cat: str, args: Optional[Dict]) -> Dict[str, Any]:
        ev: Dict[str, Any] = {"name": name, "ph": ph, "ts": ts,
                              "pid": int(pid), "tid": int(tid), "cat": cat}
        if args:
            ev["args"] = args
        return ev

    # ---- naming metadata ---------------------------------------------------
    def name_process(self, pid: int, name: str) -> None:
        if ("p", pid) in self._named:
            return
        self._named.add(("p", pid))
        self._push({"name": "process_name", "ph": "M", "ts": 0,
                    "pid": int(pid), "tid": 0, "cat": "__metadata",
                    "args": {"name": name}})

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        if ("t", pid, tid) in self._named:
            return
        self._named.add(("t", pid, tid))
        self._push({"name": "thread_name", "ph": "M", "ts": 0,
                    "pid": int(pid), "tid": int(tid), "cat": "__metadata",
                    "args": {"name": name}})

    # ---- synchronous spans -------------------------------------------------
    def begin(self, name: str, t: float, *, pid: int = 0, tid: int = 0,
              cat: str = "span", args: Optional[Dict] = None) -> None:
        ts = self._ts(t)
        stack = self._open.setdefault((pid, tid), [])
        if stack and ts < stack[-1][1]:
            raise TraceError(
                f"begin({name!r}) at ts={ts} precedes its enclosing span "
                f"{stack[-1][0]!r} opened at ts={stack[-1][1]} "
                f"(track pid={pid} tid={tid}): simulated clocks are "
                "monotonic")
        stack.append((name, ts))
        self._push(self._base(name, "B", ts, pid, tid, cat, args))

    def end(self, name: str, t: float, *, pid: int = 0, tid: int = 0,
            cat: str = "span", args: Optional[Dict] = None) -> None:
        ts = self._ts(t)
        stack = self._open.get((pid, tid))
        if not stack:
            raise TraceError(f"end({name!r}) with no open span on track "
                             f"pid={pid} tid={tid}")
        top, ts0 = stack[-1]
        if top != name:
            raise TraceError(f"end({name!r}) does not match the innermost "
                             f"open span {top!r} (spans must nest)")
        if ts < ts0:
            raise TraceError(f"end({name!r}) at ts={ts} precedes its "
                             f"begin at ts={ts0}")
        stack.pop()
        self._push(self._base(name, "E", ts, pid, tid, cat, args))

    def complete(self, name: str, t0: float, t1: float, *, pid: int = 0,
                 tid: int = 0, cat: str = "span",
                 args: Optional[Dict] = None) -> None:
        ts0, ts1 = self._ts(t0), self._ts(t1)
        if ts1 < ts0:
            raise TraceError(f"complete({name!r}) duration is negative "
                             f"({ts0} -> {ts1})")
        ev = self._base(name, "X", ts0, pid, tid, cat, args)
        ev["dur"] = ts1 - ts0
        self._push(ev)

    def instant(self, name: str, t: float, *, pid: int = 0, tid: int = 0,
                cat: str = "span", args: Optional[Dict] = None) -> None:
        ev = self._base(name, "i", self._ts(t), pid, tid, cat, args)
        ev["s"] = "t"                # thread-scoped instant
        self._push(ev)

    # ---- nestable async spans (the per-request trees) ----------------------
    def async_begin(self, cat: str, aid: int, name: str, t: float, *,
                    pid: int = 0, tid: int = 0,
                    args: Optional[Dict] = None) -> None:
        self._open_async.setdefault((cat, aid), []).append(name)
        ev = self._base(name, "b", self._ts(t), pid, tid, cat, args)
        ev["id"] = int(aid)
        self._push(ev)

    def async_end(self, cat: str, aid: int, name: str, t: float, *,
                  pid: int = 0, tid: int = 0,
                  args: Optional[Dict] = None) -> None:
        stack = self._open_async.get((cat, aid))
        if not stack:
            raise TraceError(f"async_end({name!r}) with no open async span "
                             f"for (cat={cat!r}, id={aid})")
        if stack[-1] != name:
            raise TraceError(f"async_end({name!r}) does not match the "
                             f"innermost open async span {stack[-1]!r} for "
                             f"(cat={cat!r}, id={aid})")
        stack.pop()
        ev = self._base(name, "e", self._ts(t), pid, tid, cat, args)
        ev["id"] = int(aid)
        self._push(ev)

    def async_span(self, cat: str, aid: int, name: str, t0: float,
                   t1: float, *, pid: int = 0, tid: int = 0,
                   args: Optional[Dict] = None) -> None:
        """A closed child span of an async tree (both endpoints known)."""
        self.async_begin(cat, aid, name, t0, pid=pid, tid=tid, args=args)
        self.async_end(cat, aid, name, max(t0, t1), pid=pid, tid=tid)

    def async_instant(self, cat: str, aid: int, name: str, t: float, *,
                      pid: int = 0, tid: int = 0,
                      args: Optional[Dict] = None) -> None:
        ev = self._base(name, "n", self._ts(t), pid, tid, cat, args)
        ev["id"] = int(aid)
        self._push(ev)

    # ---- counter streams ---------------------------------------------------
    def counter(self, name: str, t: float, values: Dict[str, float], *,
                pid: int = 0, tid: int = 0, cat: str = "counter") -> None:
        self._push(self._base(name, "C", self._ts(t), pid, tid, cat,
                              dict(values)))

    # ---- export ------------------------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self._events)

    def open_spans(self) -> List[str]:
        """Names of spans begun but not yet ended (sync and async)."""
        out = [name for stack in self._open.values() for name, _ in stack]
        out.extend(name for stack in self._open_async.values()
                   for name in stack)
        return out

    def to_dict(self) -> Dict[str, Any]:
        dangling = self.open_spans()
        if dangling:
            raise TraceError("export with unbalanced spans still open: "
                             + ", ".join(sorted(dangling)))
        # canonical order: by quantized ts, then recording sequence — so a
        # begin always precedes the matching end at equal timestamps and the
        # exported array is sorted (tools/trace_check.py enforces this)
        events = [ev for _, _, ev in sorted(self._events,
                                            key=lambda e: (e[0], e[1]))]
        return {
            "displayTimeUnit": "ms",
            "otherData": {"clock": self.clock,
                          "schema_version": TRACE_SCHEMA_VERSION,
                          "unit_us": self.unit_us},
            "traceEvents": events,
        }

    def to_json(self) -> str:
        # sort_keys + fixed separators: byte-identical serialization for
        # identical event streams (the trace-smoke CI gate)
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def save(self, path: str) -> None:
        atomic_write_text(path, self.to_json() + "\n")


def for_sim_ms() -> Tracer:
    """Tracer on the serving fleet's simulated-millisecond clock."""
    return Tracer(unit_us=1000.0, clock="sim_ms")


def for_sim_seconds() -> Tracer:
    """Tracer on the async runtime's simulated-seconds clock."""
    return Tracer(unit_us=1_000_000.0, clock="sim_s")


def for_steps() -> Tracer:
    """Tracer on a step-counter clock (synchronous training): one step
    renders as one millisecond."""
    return Tracer(unit_us=1000.0, clock="steps")
