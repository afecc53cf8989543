"""Deterministic observability: simulated-clock tracing + metrics +
alerting.

    trace.py     span/event tracer keyed to the simulated clocks; exports
                 Chrome/Perfetto trace-event JSON, bit-identical per seed
    metrics.py   counters / gauges / fixed-bucket histograms with exact
                 quantiles — the one percentile implementation in the repo
    watch.py     Watchtower: declarative alert rules (threshold /
                 burn-rate / EWMA-drift) evaluated over the registry on
                 the simulated clock; bit-identical alert JSONL per seed
    recorder.py  FlightRecorder: bounded ring of recent trace events,
                 dumps postmortem bundles on alert or injected fault
    fsio.py      atomic artifact writes (tmp + fsync + os.replace)

Instrumented subsystems (all hooks are no-ops when no tracer/registry is
attached — the hot paths are untouched on the default path):

    runtime/scheduler.py   per-peer step/publish/recover spans, mailbox
                           staleness + comm counters
    train/loop.py          per-step spans, exchange markers, comm counters
    serve/fleet/           per-request span trees (admit→queue→prefill→
                           decode→…→emit, surviving migration), per-tick
                           engine spans, KV-pool occupancy and analytic
                           decode HBM/FLOP counter streams

Surfaced as ``--trace out.json --metrics out-metrics.json`` on
``repro_torch.launch.train``, ``repro_torch.launch.serve`` and
``repro_torch.launch.sweep``; ``tools/trace_check.py`` validates exported
traces in CI. See docs/observability.md.

The port's copy of the reference's ``repro.obs``: pure Python, the same
code apart from its import paths, so a port run and a reference run on the
same simulated clocks export byte-identical traces, metrics and alert logs.
Hooks convert every value they record to a plain Python number, and read
nothing from the device that the run path does not already read.
"""
from repro_torch.obs.fsio import atomic_write_text  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS, GAUGE_WINDOW, METRICS_SCHEMA_VERSION, Counter, Gauge,
    Histogram, MetricsRegistry)
from repro_torch.obs.recorder import (  # noqa: F401
    POSTMORTEM_SCHEMA_VERSION, FlightRecorder)
from repro_torch.obs.trace import (  # noqa: F401
    TRACE_SCHEMA_VERSION, TraceError, Tracer, for_sim_ms, for_sim_seconds,
    for_steps)
from repro_torch.obs.watch import (  # noqa: F401
    ALERTS_SCHEMA_VERSION, Rule, Watchtower, default_rules, load_rules,
    parse_rules)
