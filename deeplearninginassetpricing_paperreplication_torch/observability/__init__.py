"""Run telemetry and model-health observability, copied from the JAX
package's ``observability/``. Nothing here imports torch at module level:

  * :mod:`.events`       — the append-only ``events.jsonl`` writer (spans,
    counters, gauges), feeding a live :class:`MetricsRegistry`;
  * :mod:`.metrics`      — counters, gauges and latency histograms with the
    Prometheus text exposition of ``/metrics?format=prom``, and the
    read-only :class:`MetricsSidecar` behind the train CLI's
    ``--metrics_port``;
  * :mod:`.tracecontext` — W3C ``traceparent`` parsing and sampling;
  * :mod:`.heartbeat`    — phase-tagged liveness (``heartbeat.json``), with
    the device-memory snapshot of :mod:`.memory`
    (``torch.cuda.memory_stats`` over the visible devices);
  * :mod:`.logging`      — the process-0-gated :class:`RunLogger`, mirrored
    into ``events.jsonl``;
  * :mod:`.programs`     — each kernel's launch plan as the card holds it
    (``kernel_programs`` in ``manifest.json``; ``xla.py``'s counterpart);
  * :mod:`.manifest`     — ``manifest.json``: config hash, versions, the
    CUDA devices, git sha;
  * :mod:`.report`       — the report CLI over a run dir's artifacts
    (``python -m ...report``: phases, startup, serving, reliability,
    elastic, promotion, model health, kernel plans) and the latency
    percentiles ``/metrics`` reports;
  * :mod:`.trace`        — a run dir's event-file family assembled into one
    Chrome trace (``report --trace``);
  * :mod:`.budgets`      — declarative perf budgets checked against
    ``BENCH_*.json`` files and run summaries (``report --budget``);
  * :mod:`.drift`        — reference profiles of a panel and PSI/KS drift
    scores against them (numpy only);
  * :mod:`.modelhealth`  — ``health.json``, the gate's health thresholds and
    the candidate diagnostics (torch loaded lazily).
"""

from .budgets import check_budgets, format_budget_report
from .events import EventLog, new_run_id
from .heartbeat import Heartbeat, read_state, write_state
from .logging import RunLogger, get_run_logger, set_run_logger
from .manifest import (
    build_manifest,
    config_hash,
    load_manifest,
    update_manifest,
    write_manifest,
)
from .memory import device_memory_snapshot, log_memory
from .metrics import (
    PROM_CONTENT_TYPE,
    MetricsRegistry,
    MetricsSidecar,
    feed_event,
    parse_prom_exemplars,
    parse_prom_text,
    process_stats,
    prom_name,
    render_process_prom,
)
from .trace import assemble_trace, write_trace
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
    "MetricsSidecar",
    "PROM_CONTENT_TYPE",
    "RunLogger",
    "TraceContext",
    "assemble_trace",
    "build_manifest",
    "check_budgets",
    "config_hash",
    "device_memory_snapshot",
    "feed_event",
    "format_budget_report",
    "format_traceparent",
    "get_run_logger",
    "load_manifest",
    "log_memory",
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
    "set_run_logger",
    "trace_sampled",
    "update_manifest",
    "write_manifest",
    "write_state",
    "write_trace",
]
