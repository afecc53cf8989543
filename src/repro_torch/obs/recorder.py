"""Flight recorder: a bounded ring of recent trace events + postmortem
bundle dumps.

A chaos run that trips an alert deep into a sweep is useless to debug
from a 50k-event trace — what you want is *what the system was doing
right then*. The ``FlightRecorder`` keeps the last ``capacity`` trace
events in a ``deque`` ring (attached to a ``Tracer`` via its
``recorder`` hook, so it sees events as they are recorded, even while
spans are still open), and on an alert or injected fault dumps a
**postmortem bundle**: the ring contents, a full metric snapshot, the
triggering alert/fault context, and whatever run context the host wires
in (live request ids, peer states).

Determinism contract: bundles are pure functions of the simulated event
stream (canonical ordering + serialization), so two seeded runs dump
byte-identical bundles — they are CI-gated alongside the alert log. The
recorder only *reads* (the ring is a copy of events the tracer records
anyway; the metric snapshot is ``to_dict``), so enabling it perturbs
nothing.
"""
from __future__ import annotations

import json
import os
import re
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.obs.fsio import atomic_write_text
from repro_torch.obs.metrics import MetricsRegistry

POSTMORTEM_SCHEMA_VERSION = 1

_SLUG_RE = re.compile(r"[^A-Za-z0-9_-]+")


def _slug(text: str) -> str:
    return _SLUG_RE.sub("-", text).strip("-") or "event"


class FlightRecorder:
    """Bounded ring of ``(ts, seq, event)`` plus postmortem dumping.

    ``capacity`` bounds the ring (oldest events fall off — enforced by
    ``tests/test_watch.py``); ``max_dumps`` bounds how many bundles one
    run may write, so a pathological alert storm cannot fill a disk.
    ``context_fn`` is an optional zero-arg callable returning a
    JSON-serializable dict of live run state (offending request/peer
    ids) captured at dump time.
    """

    def __init__(self, out_dir: str, capacity: int = 256,
                 max_dumps: int = 8,
                 metrics: Optional[MetricsRegistry] = None,
                 context_fn: Optional[Callable[[], Dict[str, Any]]] = None):
        if capacity <= 0:
            raise ValueError(f"flight recorder capacity {capacity} must be "
                             "positive")
        if max_dumps <= 0:
            raise ValueError(f"flight recorder max_dumps {max_dumps} must "
                             "be positive")
        self.out_dir = out_dir
        self.capacity = capacity
        self.max_dumps = max_dumps
        self.metrics = metrics
        self.context_fn = context_fn
        self._ring: Deque[Tuple[int, int, Dict[str, Any]]] = deque(
            maxlen=capacity)
        self.n_offered = 0
        self.dumped: List[str] = []

    # ---- tracer hook -------------------------------------------------------
    def offer(self, ts: int, seq: int, ev: Dict[str, Any]) -> None:
        """Called by ``Tracer._push`` for every recorded event."""
        self._ring.append((int(ts), int(seq), ev))
        self.n_offered += 1

    def events(self) -> List[Dict[str, Any]]:
        """Ring contents in canonical (ts, seq) order."""
        return [ev for _, _, ev in sorted(self._ring,
                                          key=lambda e: (e[0], e[1]))]

    # ---- watchtower hooks --------------------------------------------------
    def on_alert(self, alert: Dict[str, Any]) -> Optional[str]:
        """Watchtower ``on_alert`` callback: dump on newly-firing alerts
        (resolutions are logged, not dumped — the interesting state is at
        fire time)."""
        if alert.get("state") != "firing":
            return None
        return self.dump(f"alert-{alert['rule']}", alert["ts"], alert=alert)

    def on_fault(self, fault: Dict[str, Any]) -> Optional[str]:
        """Watchtower ``on_fault`` callback: dump on injected faults."""
        return self.dump(f"fault-{fault['kind']}", fault["ts"],
                         alert=None, extra=fault.get("context"))

    # ---- bundles -----------------------------------------------------------
    def bundle(self, reason: str, ts: int,
               alert: Optional[Dict[str, Any]] = None,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        context: Dict[str, Any] = dict(extra or {})
        if self.context_fn is not None:
            context.update(self.context_fn())
        return {
            "schema_version": POSTMORTEM_SCHEMA_VERSION,
            "kind": "postmortem",
            "reason": reason,
            "ts": int(ts),
            "alert": alert,
            "context": context,
            "events": self.events(),
            "n_events_seen": self.n_offered,
            "metrics": (self.metrics.to_dict()
                        if self.metrics is not None else None),
        }

    def dump(self, reason: str, ts: int,
             alert: Optional[Dict[str, Any]] = None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write a postmortem bundle; returns its path, or None once the
        ``max_dumps`` budget is spent."""
        if len(self.dumped) >= self.max_dumps:
            return None
        name = (f"postmortem_{len(self.dumped):03d}_"
                f"{_slug(reason)}.json")
        path = os.path.join(self.out_dir, name)
        doc = self.bundle(reason, ts, alert=alert, extra=extra)
        atomic_write_text(path, json.dumps(
            doc, sort_keys=True, separators=(",", ":")) + "\n")
        self.dumped.append(path)
        return path
