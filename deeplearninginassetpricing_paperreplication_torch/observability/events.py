"""Append-only structured event log: spans, counters, gauges.

One ``EventLog`` per process per run directory. Every row is a single JSON
object with a monotonically increasing ``seq``, a wall-clock ``ts``
(``time.time``), a monotonic ``mono`` (``time.monotonic`` — durations are
computed from this clock, never from wall time), the run id, and the
process's rank. Spans write a ``span_begin`` row at entry and a ``span_end``
row (with ``duration_s``) at exit; nesting is tracked per thread so the
trainer's concurrent compile pool gets correct depth/parent attribution.

The log degrades to a measuring no-op when constructed without a run
directory: ``span(...)`` still times its block (the trainer fills
``compile_seconds`` / ``phase_seconds`` from ``sp.seconds``), but nothing
touches the filesystem. Library code can therefore instrument
unconditionally and let the CLI decide whether a sink exists.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

try:
    from .metrics import MetricsRegistry, feed_event
except ImportError:
    # loaded OUTSIDE the package (the supervisor path-loads this file);
    # metrics.py is stdlib-only by contract and sits next to us
    import importlib.util as _ilu

    _spec = _ilu.spec_from_file_location(
        "_dlap_metrics", Path(__file__).resolve().parent / "metrics.py")
    _metrics = _ilu.module_from_spec(_spec)
    _spec.loader.exec_module(_metrics)
    MetricsRegistry = _metrics.MetricsRegistry
    feed_event = _metrics.feed_event

SCHEMA_VERSION = 1

# Durability policy for the event file: span_end/counter/request rows
# carry the evidence a post-mortem reads, so they are fsync'd at most once
# per this many seconds (0 = every such row). A SIGKILLed process then
# loses at most one window of tail rows instead of an arbitrary buffer.
# Negative disables fsync entirely (rows still flush to the OS per line —
# SIGKILL-safe, power-loss-unsafe). "alert" (SLO firing/resolved
# transitions) and "probe" (blackbox probe failures) are in the set for the
# same reason: they are exactly the rows written moments before a process
# dies, and a SIGKILL must cost at most one flush window of that evidence.
ENV_FSYNC = "DLAP_EVENTS_FSYNC_S"
DEFAULT_FSYNC_INTERVAL_S = 0.5
_DURABLE_KINDS = ("span_end", "counter", "request", "alert", "probe")


def new_run_id() -> str:
    """Sortable, collision-safe run identifier (UTC timestamp + random)."""
    return (
        time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        + "-"
        + uuid.uuid4().hex[:8]
    )


def _process_index() -> int:
    """This process's rank: ``torch.distributed``'s when a process group is
    initialised, else the ``RANK`` environment variable, else 0. Never
    imports torch itself (report-only tooling must not load it) and never
    initialises a device."""
    import sys

    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    try:
        return int(os.environ.get("RANK", 0))
    except ValueError:
        return 0


class EventLog:
    """Writer for one process's ``events.jsonl`` (or a silent measurer).

    Process 0 writes ``events.jsonl``; worker processes write their own
    ``events.proc{p}.jsonl`` in the same run directory, so a multihost run
    leaves one file per process with no cross-process write contention.
    """

    def __init__(
        self,
        run_dir: Optional[os.PathLike] = None,
        run_id: Optional[str] = None,
        process_index: Optional[int] = None,
        filename: Optional[str] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.run_id = run_id or new_run_id()
        self._pidx = process_index
        self._lock = threading.RLock()
        self._tls = threading.local()
        self._seq = 0
        self._f = None
        # the live metrics twin: every counter/gauge/span_end row also
        # updates this registry, so a scrape endpoint and the event file
        # can never disagree about what the process did
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # small per-log thread ids (0 = first thread seen): raw get_ident()
        # values are neither small nor stable across runs
        self._tids: Dict[int, int] = {}
        try:
            fsync_s = float(os.environ.get(ENV_FSYNC,
                                           DEFAULT_FSYNC_INTERVAL_S))
        except ValueError:
            fsync_s = DEFAULT_FSYNC_INTERVAL_S
        self._fsync_interval = fsync_s
        self._last_fsync = 0.0
        self.path: Optional[Path] = None
        if run_dir is not None:
            pidx = self.process_index
            if filename is None:
                filename = (
                    "events.jsonl" if pidx == 0 else f"events.proc{pidx}.jsonl"
                )
            run_dir = Path(run_dir)
            run_dir.mkdir(parents=True, exist_ok=True)
            self.path = run_dir / filename
            # append-only: a crash keeps everything logged so far, a resumed
            # run appends under its own run_id (readers group by run_id)
            self._f = open(self.path, "a", buffering=1)

    @property
    def process_index(self) -> int:
        if self._pidx is None:
            self._pidx = _process_index()
        return self._pidx

    @property
    def enabled(self) -> bool:
        return self._f is not None

    # -- core emit -----------------------------------------------------------

    def emit(self, kind: str, name: str, **fields: Any) -> Dict[str, Any]:
        """Write one event row; returns it (even when the sink is off).

        The identity/clock fields are written LAST so a caller attr named
        ``run_id``/``seq``/``ts``/... can never corrupt a row's identity
        (report scoping depends on it) — telemetry must not be breakable
        from a call site."""
        fsync_fd = None
        with self._lock:
            self._seq += 1
            ident = threading.get_ident()
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            row = dict(fields)
            row.update(
                schema=SCHEMA_VERSION,
                kind=kind,
                name=name,
                run_id=self.run_id,
                process_index=self.process_index,
                tid=tid,
                seq=self._seq,
                ts=round(time.time(), 6),
                mono=round(time.monotonic(), 6),
            )
            if self._f is not None:
                self._f.write(json.dumps(row) + "\n")
                if kind in _DURABLE_KINDS and self._fsync_interval >= 0:
                    # crash consistency: span_end/counter rows reach disk at
                    # most one interval late, so a SIGKILLed process's tail
                    # survives
                    now = time.monotonic()
                    if now - self._last_fsync >= self._fsync_interval:
                        self._last_fsync = now
                        try:
                            self._f.flush()
                            fsync_fd = self._f.fileno()
                        except (OSError, ValueError):
                            pass
            feed_event(self.metrics, kind, name, row)
        if fsync_fd is not None:
            # fsync OUTSIDE the emit lock: the disk write-back (which can
            # take tens of ms on a loaded disk) must not stall every other
            # thread's emits — only the buffer flush needs the lock
            try:
                os.fsync(fsync_fd)
            except OSError:
                pass  # a concurrently closed log must not fail the emitter
        return row

    # -- the span/counter/gauge API ------------------------------------------

    def span(self, name: str, **attrs: Any) -> "Span":
        """Context manager timing a block: ``with log.span("compile/p1") as
        sp: ...`` — ``sp.seconds`` holds the monotonic duration at exit."""
        return Span(self, name, attrs)

    def counter(self, name: str, value: float = 1, **attrs: Any) -> None:
        self.emit("counter", name, value=value, **attrs)

    def gauge(self, name: str, value: float, **attrs: Any) -> None:
        self.emit("gauge", name, value=value, **attrs)

    def log(self, message: str, level: str = "info", **attrs: Any) -> None:
        self.emit("log", level, message=message, **attrs)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                # the "at most one fsync window of tail rows lost" promise
                # must also cover rows emitted AFTER the last periodic sync:
                # close() is the final chance to push them past the page cache
                if self._fsync_interval >= 0:
                    try:
                        self._f.flush()
                        os.fsync(self._f.fileno())
                    except (OSError, ValueError):
                        pass
                self._f.close()
                self._f = None

    # per-thread span stack (depth/parent attribution under thread pools)
    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st


class Span:
    """One timed block; measures even when the log has no sink."""

    def __init__(self, log: EventLog, name: str, attrs: Dict[str, Any]):
        self._log = log
        self.name = name
        self.attrs = attrs
        self.seconds: float = 0.0
        self._t0: float = 0.0

    def __enter__(self) -> "Span":
        stack = self._log._stack()
        self.depth = len(stack)
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        # attrs first, span fields last: an attr colliding with a span
        # field (e.g. `depth`) is overridden, never a TypeError — a bad
        # call site must not be able to crash an instrumented run
        fields = dict(self.attrs)
        fields.update(depth=self.depth, parent=self.parent)
        self._log.emit("span_begin", self.name, **fields)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.monotonic() - self._t0
        stack = self._log._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        fields = dict(self.attrs)
        fields.update(
            duration_s=round(self.seconds, 6),
            depth=self.depth, parent=self.parent, status="ok",
        )
        if exc_type is not None:
            fields.update(status="error", error=exc_type.__name__)
        self._log.emit("span_end", self.name, **fields)
