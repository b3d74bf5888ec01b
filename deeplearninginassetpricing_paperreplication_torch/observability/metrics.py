"""In-process streaming metrics: counters, gauges, latency histograms and
Prometheus text exposition — the port's copy of the JAX package's
``observability/metrics.py``.

The :class:`~.events.EventLog` feeds a :class:`MetricsRegistry` from the
SAME ``counter``/``gauge``/``span_end`` call sites that write
``events.jsonl`` — instrumented code emits once and both sinks agree by
construction. The registry is the LIVE view (scrapeable while a server
runs); the event log stays the post-hoc ground truth. Exposure paths:

  * the serving server answers ``GET /metrics?format=prom`` with the
    Prometheus text format (the JSON ``/metrics`` body is unchanged);
  * a final snapshot lands in the run dir as ``metrics.prom`` on clean
    serving shutdown;
  * :class:`MetricsSidecar` serves ``/metrics`` (Prometheus text) and
    ``/healthz`` for CLIs that are not servers (``train --metrics_port``).

Metric naming: event names map deterministically — counters
``a/b`` → ``dlap_a_b_total``, gauges → ``dlap_a_b``, span durations →
``dlap_span_a_b_seconds`` (a fixed-bucket histogram with derived
p50/p95/p99 gauges ``..._p50``/``..._p95``/``..._p99``). A bounded label
whitelist (:data:`LABEL_KEYS`) keeps cardinality finite no matter what a
call site passes.

Module level stays stdlib-only (like ``heartbeat.py`` and ``faults.py``).
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

PROM_PREFIX = "dlap"
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Fixed latency buckets (seconds): sub-ms serving dispatches through
# multi-minute training phases. An overflow (+Inf) bucket is implicit.
DEFAULT_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

# Event attrs promoted to Prometheus labels — a closed set, so arbitrary
# call-site attrs (paths, digests, month indices) can never explode series
# cardinality.
LABEL_KEYS = (
    "endpoint", "status", "phase", "site", "action", "section",
    "worker", "replica", "program", "split", "level", "outcome",
    "priority", "reason", "direction", "objective", "window",
    "severity", "target",
)

DERIVED_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(event_name: str, kind: str = "counter") -> str:
    """Deterministic event-name → metric-name mapping (see module doc)."""
    base = _NAME_RE.sub("_", str(event_name)).strip("_") or "unnamed"
    if kind == "counter":
        return f"{PROM_PREFIX}_{base}_total"
    if kind == "span":
        return f"{PROM_PREFIX}_span_{base}_seconds"
    return f"{PROM_PREFIX}_{base}"


def _label_str(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k])
        v = v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class _Histogram:
    """One label-set's fixed-bucket histogram (+ sum/count/max).

    ``exemplars``: per-bucket most-recent exemplar ``(value, trace_id)`` —
    OpenMetrics-style evidence linking a latency bucket back to a concrete
    request trace (the p99 bucket names a trace id a human can pull up in
    the merged flow trace). Bounded by construction: at most one exemplar
    per bucket per label set."""

    __slots__ = ("bounds", "counts", "sum", "count", "max", "exemplars")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.max = 0.0
        self.exemplars: Dict[int, Tuple[float, str]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        self.sum += value
        self.count += 1
        if value > self.max:
            self.max = value
        for i, b in enumerate(self.bounds):
            if value <= b:
                self.counts[i] += 1
                if exemplar:
                    self.exemplars[i] = (value, str(exemplar))
                return
        self.counts[-1] += 1
        if exemplar:
            self.exemplars[len(self.bounds)] = (value, str(exemplar))

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile from the bucket counts: the UPPER bound
        of the bucket holding the rank-th observation (the max observed for
        the overflow bucket). Bucket-resolution by design — the exact value
        lies within (previous bound, returned bound]."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max


class MetricsRegistry:
    """Thread-safe counters/gauges/histograms with Prometheus rendering.

    One registry per :class:`~.events.EventLog` by default (construction is
    cheap), so concurrent runs in one process — tests, replicated engines —
    never cross-contaminate each other's series.
    """

    def __init__(self, buckets_s: Sequence[float] = DEFAULT_BUCKETS_S):
        self._lock = threading.Lock()
        self._buckets = tuple(buckets_s)
        self._counters: Dict[str, Dict[Tuple, float]] = {}
        self._gauges: Dict[str, Dict[Tuple, float]] = {}
        self._hists: Dict[str, Dict[Tuple, _Histogram]] = {}

    # -- write side ----------------------------------------------------------

    @staticmethod
    def _key(labels: Optional[Dict[str, Any]]) -> Tuple:
        if not labels:
            return ()
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def counter(self, name: str, value: float = 1,
                labels: Optional[Dict[str, Any]] = None) -> None:
        key = self._key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + float(value)

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, Any]] = None) -> None:
        key = self._key(labels)
        with self._lock:
            self._gauges.setdefault(name, {})[key] = float(value)

    def observe(self, name: str, value_s: float,
                labels: Optional[Dict[str, Any]] = None,
                exemplar: Optional[str] = None) -> None:
        """``exemplar``: a trace id attached to the bucket this observation
        lands in (rendered OpenMetrics-style after the bucket sample)."""
        key = self._key(labels)
        with self._lock:
            series = self._hists.setdefault(name, {})
            hist = series.get(key)
            if hist is None:
                hist = series[key] = _Histogram(self._buckets)
            hist.observe(float(value_s), exemplar=exemplar)

    # -- read side -----------------------------------------------------------

    def counter_total(self, name: str) -> float:
        """Sum of one counter family over every label set."""
        with self._lock:
            return sum((self._counters.get(name) or {}).values())

    def _merged_hist(self, series: Dict[Any, "_Histogram"]) -> "_Histogram":
        """One histogram family's label sets folded into a single
        _Histogram — THE merge semantics for every fleet-wide percentile
        (callers hold self._lock)."""
        merged = _Histogram(self._buckets)
        for h in series.values():
            merged.sum += h.sum
            merged.count += h.count
            merged.max = max(merged.max, h.max)
            for i, c in enumerate(h.counts):
                merged.counts[i] += c
        return merged

    def histogram_quantile(self, name: str, q: float) -> Optional[float]:
        """Derived percentile over one histogram family, all label sets
        merged (what 'the p99 of serve/request spans' means fleet-wide)."""
        with self._lock:
            series = self._hists.get(name)
            if not series:
                return None
            merged = self._merged_hist(series)
        return merged.quantile(q)

    def render_prom(self, exemplars: bool = True) -> str:
        """The Prometheus text exposition (format 0.0.4), deterministically
        ordered so two renders of the same state are byte-identical.
        ``exemplars=False`` drops the OpenMetrics exemplar suffixes —
        strictly-classic parsers reject the `` # {...} v`` token, so a
        scraper that cannot handle them asks for a clean exposition
        (``/metrics?format=prom&exemplars=0``)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._counters):
                lines.append(f"# TYPE {name} counter")
                series = self._counters[name]
                for key in sorted(series):
                    lines.append(
                        f"{name}{_label_str(dict(key))} {_fmt(series[key])}")
            for name in sorted(self._gauges):
                lines.append(f"# TYPE {name} gauge")
                series = self._gauges[name]
                for key in sorted(series):
                    lines.append(
                        f"{name}{_label_str(dict(key))} {_fmt(series[key])}")
            for name in sorted(self._hists):
                lines.append(f"# TYPE {name} histogram")
                series = self._hists[name]
                for key in sorted(series):
                    h = series[key]
                    labels = dict(key)
                    ex = h.exemplars if exemplars else {}
                    cum = 0
                    for i, b in enumerate(h.bounds):
                        cum += h.counts[i]
                        ls = _label_str({**labels, "le": _fmt(b)})
                        lines.append(f"{name}_bucket{ls} {cum}"
                                     + _exemplar_str(ex.get(i)))
                    ls = _label_str({**labels, "le": "+Inf"})
                    lines.append(
                        f"{name}_bucket{ls} {h.count}"
                        + _exemplar_str(ex.get(len(h.bounds))))
                    ls = _label_str(labels)
                    lines.append(f"{name}_sum{ls} {_fmt(h.sum)}")
                    lines.append(f"{name}_count{ls} {h.count}")
                # derived percentiles, merged over label sets: gauges a
                # scraper can alert on without server-side quantile math
                merged = self._merged_hist(series)
                for suffix, q in DERIVED_QUANTILES:
                    v = merged.quantile(q)
                    if v is not None:
                        lines.append(f"# TYPE {name}_{suffix} gauge")
                        lines.append(f"{name}_{suffix} {_fmt(v)}")
        return "\n".join(lines) + "\n" if lines else ""


def _fmt(v: float) -> str:
    """Shortest exact-ish float rendering (ints stay ints)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _exemplar_str(ex: Optional[Tuple[float, str]]) -> str:
    """OpenMetrics exemplar suffix for one bucket sample line:
    `` # {trace_id="…"} value`` (no timestamp — renders stay
    byte-deterministic for identical registry state)."""
    if ex is None:
        return ""
    value, trace_id = ex
    return f' # {{trace_id="{trace_id}"}} {_fmt(value)}'


def feed_event(registry: MetricsRegistry, kind: str, name: str,
               row: Dict[str, Any]) -> None:
    """EventLog → registry bridge: one event row updates the live metrics.

    Counters/gauges map by kind; ``span_end`` rows feed the duration
    histogram of their span name; ``request`` rows (the per-request trace
    record) feed the SAME histogram family as the span_end they replace,
    attaching their trace id as the bucket's exemplar — so sampling a
    request on or off never changes the latency histogram, only whether
    its bucket names a trace. Must never raise — telemetry cannot be the
    reason instrumented code fails."""
    try:
        labels = {k: row[k] for k in LABEL_KEYS
                  if row.get(k) is not None}
        if kind == "counter":
            value = row.get("value", 1)
            registry.counter(prom_name(name, "counter"),
                             value if isinstance(value, (int, float)) else 1,
                             labels)
        elif kind == "gauge":
            value = row.get("value")
            if isinstance(value, (int, float)):
                registry.gauge(prom_name(name, "gauge"), value, labels)
        elif kind in ("span_end", "request"):
            dur = row.get("duration_s")
            if isinstance(dur, (int, float)):
                registry.observe(prom_name(name, "span"), dur, labels,
                                 exemplar=row.get("trace_id"))
        elif kind in ("alert", "probe"):
            # durable incident rows (SLO transitions, probe failures):
            # each one is also a countable event on the metrics plane
            registry.counter(prom_name(name, "counter"), 1, labels)
    except Exception:
        pass


# -- host-process gauges (dlap_process_*) ------------------------------------


def process_stats() -> Dict[str, Optional[float]]:
    """This process's host-resource posture: peak/current RSS, cumulative
    CPU seconds, open fds, thread count — from ``resource.getrusage`` and
    ``/proc/self`` (each field None where the platform lacks the source).
    Resource-exhaustion alerts (fd leaks, RSS creep toward the OOM
    killer) need these."""
    out: Dict[str, Optional[float]] = {
        "peak_rss_bytes": None, "rss_bytes": None, "cpu_seconds": None,
        "open_fds": None, "threads": None,
    }
    try:
        import resource
        import sys as _sys

        ru = resource.getrusage(resource.RUSAGE_SELF)
        # ru_maxrss is KiB on Linux, bytes on macOS
        scale = 1 if _sys.platform == "darwin" else 1024
        out["peak_rss_bytes"] = float(ru.ru_maxrss) * scale
        out["cpu_seconds"] = round(ru.ru_utime + ru.ru_stime, 3)
    except Exception:
        pass
    try:
        for line in open("/proc/self/status"):
            if line.startswith("VmRSS:"):
                out["rss_bytes"] = float(line.split()[1]) * 1024
            elif line.startswith("Threads:"):
                out["threads"] = float(line.split()[1])
    except OSError:
        out["threads"] = float(threading.active_count())
    try:
        import os as _os

        out["open_fds"] = float(len(_os.listdir("/proc/self/fd")))
    except OSError:
        pass
    return out


def render_process_prom() -> str:
    """The ``dlap_process_*`` gauge block appended to every ``/metrics``
    scrape (both serving front ends), deterministic field order."""
    lines: List[str] = []
    stats = process_stats()
    for key in sorted(stats):
        v = stats[key]
        if v is None:
            continue
        name = f"{PROM_PREFIX}_process_{key}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(v)}")
    return "\n".join(lines) + "\n" if lines else ""


# -- scrape parsing (tests + report cross-checks) ----------------------------


# one sample line, with an optional OpenMetrics exemplar suffix
# (`` # {labels} value [ts]``) after the sample value
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*?)\})?\s+(\S+)"
    r"(?:\s+#\s+\{(.*?)\}\s+(\S+)(?:\s+\S+)?)?$")


def _parse_labelblob(labelblob: Optional[str]) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    if labelblob:
        for lm in re.finditer(
                r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"',
                labelblob):
            k, v = lm.group(1), lm.group(2)
            # single-pass unescape: sequential .replace() would corrupt
            # a literal backslash followed by 'n' (r'\\n' → '\' + LF)
            labels[k] = re.sub(
                r"\\(.)",
                lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), v)
    return labels


def parse_prom_text(text: str) -> Dict[str, Dict[Tuple, float]]:
    """Parse Prometheus text format back into
    ``{metric_name: {sorted-label-tuple: value}}`` — how a client reads a
    scrape. Tolerant of
    comments/blank lines and OpenMetrics exemplar suffixes (see
    :func:`parse_prom_exemplars` to read those back); raises ValueError on
    a malformed sample line."""
    out: Dict[str, Dict[Tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed prometheus sample line: {line!r}")
        name, _, labelblob, value = m.groups()[:4]
        out.setdefault(name, {})[
            tuple(sorted(_parse_labelblob(labelblob).items()))] = float(value)
    return out


def parse_prom_exemplars(
        text: str) -> Dict[Tuple[str, Tuple], Dict[str, Any]]:
    """The exemplars of a scrape, keyed like :func:`parse_prom_text`:
    ``{(metric_name, sorted-label-tuple): {"labels": {...}, "value": v}}``
    — a p99 bucket's trace id survives the wire.
    Lines without an exemplar are skipped; malformed sample lines raise
    like parse_prom_text."""
    out: Dict[Tuple[str, Tuple], Dict[str, Any]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed prometheus sample line: {line!r}")
        name, _, labelblob, _value, ex_labels, ex_value = m.groups()
        if ex_value is None:
            continue
        key = (name, tuple(sorted(_parse_labelblob(labelblob).items())))
        out[key] = {"labels": _parse_labelblob(ex_labels),
                    "value": float(ex_value)}
    return out


# -- the read-only scrape sidecar --------------------------------------------


class MetricsSidecar:
    """Stdlib HTTP thread serving ``/metrics`` (Prometheus text) and
    ``/healthz`` from one or more registries — the scrape endpoint for
    CLIs that are not servers (``train --metrics_port``). Strictly
    read-only: GET only, no mutation path.
    """

    def __init__(self, registries: Iterable[MetricsRegistry],
                 host: str = "127.0.0.1", port: int = 0):
        self.registries = list(registries)
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None

    def start(self) -> int:
        """Bind + serve on a daemon thread; returns the bound port (port 0
        picks a free one)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sidecar = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    body = ("".join(
                        r.render_prom() for r in sidecar.registries)
                        + render_process_prom()).encode()
                    ctype = PROM_CONTENT_TYPE
                elif path == "/healthz":
                    body = json.dumps({"ok": True}).encode()
                    ctype = "application/json"
                else:
                    body = b"not found"
                    ctype = "text/plain"
                status = 200 if path in ("/metrics", "/healthz") else 404
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # scrapes are not news
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics-sidecar")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
