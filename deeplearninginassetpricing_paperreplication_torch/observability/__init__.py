"""Run telemetry and model-health observability, copied from the JAX
package's ``observability/``. Nothing here imports torch at module level:

  * :mod:`.events`       — the append-only ``events.jsonl`` writer (spans,
    counters, gauges), feeding a live :class:`MetricsRegistry`;
  * :mod:`.metrics`      — counters, gauges and latency histograms with the
    Prometheus text exposition of ``/metrics?format=prom``;
  * :mod:`.tracecontext` — W3C ``traceparent`` parsing and sampling;
  * :mod:`.heartbeat`    — phase-tagged liveness (``heartbeat.json``);
  * :mod:`.manifest`     — ``manifest.json``: config hash, versions, the
    CUDA devices, git sha;
  * :mod:`.report`       — the latency percentiles ``/metrics`` reports;
  * :mod:`.drift`        — reference profiles of a panel and PSI/KS drift
    scores against them (numpy only);
  * :mod:`.modelhealth`  — ``health.json``, the gate's health thresholds and
    the candidate diagnostics (torch loaded lazily).
"""

from .events import EventLog, new_run_id
from .heartbeat import Heartbeat, read_state, write_state
from .manifest import (
    build_manifest,
    config_hash,
    load_manifest,
    update_manifest,
    write_manifest,
)
from .metrics import (
    PROM_CONTENT_TYPE,
    MetricsRegistry,
    feed_event,
    parse_prom_exemplars,
    parse_prom_text,
    process_stats,
    prom_name,
    render_process_prom,
)
from .tracecontext import (
    TraceContext,
    format_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
    trace_sampled,
)

__all__ = [
    "EventLog",
    "Heartbeat",
    "MetricsRegistry",
    "PROM_CONTENT_TYPE",
    "TraceContext",
    "build_manifest",
    "config_hash",
    "feed_event",
    "format_traceparent",
    "load_manifest",
    "new_run_id",
    "new_span_id",
    "new_trace_id",
    "parse_prom_exemplars",
    "parse_prom_text",
    "parse_traceparent",
    "process_stats",
    "prom_name",
    "read_state",
    "render_process_prom",
    "trace_sampled",
    "update_manifest",
    "write_manifest",
    "write_state",
]
