"""Crash flight recorder: the last moments of a serving process, kept in
memory, dumped on trouble (the port's copy of the JAX package's
``serving/flight.py``).

When a server 5xx-bursts, is SIGTERMed, or is killed mid-flight, the
post-hoc evidence (events.jsonl tail, metrics snapshot) says *that*
something died but not *what was in the air*. The :class:`FlightRecorder`
keeps two bounded rings — the last N completed request records (trace id,
status, segment timings, flush id) and the last K flushes — plus the set
of requests currently IN FLIGHT, and dumps all of it atomically to
``flightrecorder.json`` in the run dir when triggered:

  * **error burst** — ≥ ``burst_threshold`` 5xx or shed-429 responses (or
    drift alerts, :meth:`FlightRecorder.note_alert`) inside
    ``burst_window_s``, rate-limited to one dump per ``cooldown_s`` — an
    overload storm counts as trouble, and the dump carries the
    autoscaler's last decisions (:meth:`FlightRecorder.record_decision`)
    so it shows *why* the fleet was shedding, and the SLO engine's last
    alert transitions (:meth:`FlightRecorder.record_alert`);
  * **SIGTERM / clean shutdown** — the serving CLI's close path;
  * **the flare** — SIGUSR1 to the serving CLI (a watchdog's pre-kill
    signal) dumps best-effort from a fresh thread;
  * **an injected kill** — the fault injector's pre-death hook;
  * **on demand** — ``POST /v1/debug/flightrecorder`` on the private admin
    port.

The dump is a tmp+``os.replace`` atomic write, so a reader (or a second
trigger racing the first) always sees a complete JSON document. Ring
mutation is O(1) per request with one small dict append — cheap enough to
run unconditionally on the hot path. Stdlib-only: the recorder must work
inside a signal handler's thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional

DEFAULT_REQUESTS = 256
DEFAULT_FLUSHES = 64
FILENAME = "flightrecorder.json"
# one-deep rotation: a NEW process incarnation moves its predecessor's
# last dump here before writing its own — a supervised restart's routine
# autosaves/shutdown dumps can never clobber the crash evidence
FILENAME_PREV = "flightrecorder.prev.json"

# background autosave cadence (seconds; 0 disables): a replica SIGKILLed
# with no chance to dump (real OOM kill) leaves a snapshot at most one
# interval stale on disk
ENV_AUTOSAVE = "DLAP_FLIGHT_AUTOSAVE_S"
DEFAULT_AUTOSAVE_S = 1.0


class FlightRecorder:
    """Bounded in-memory rings + atomic dump (see module doc)."""

    def __init__(
        self,
        run_dir=None,
        replica: Optional[str] = None,
        max_requests: int = DEFAULT_REQUESTS,
        max_flushes: int = DEFAULT_FLUSHES,
        burst_threshold: int = 8,
        burst_window_s: float = 5.0,
        cooldown_s: float = 30.0,
        events: Any = None,
    ):
        self.path = (Path(run_dir) / FILENAME) if run_dir else None
        if self.path is not None and self.path.exists():
            # rotate the previous incarnation's dump (see FILENAME_PREV):
            # a killed server's in-flight evidence survives its restart
            try:
                os.replace(self.path, self.path.with_name(FILENAME_PREV))
            except OSError:
                pass
        self.replica = replica
        self.events = events
        self._lock = threading.Lock()
        self._requests: deque = deque(maxlen=max_requests)
        self._flushes: deque = deque(maxlen=max_flushes)
        # token -> begin record of a request currently being served; a
        # process killed mid-flight leaves these as the "what was in the
        # air" evidence
        self._in_flight: Dict[int, Dict[str, Any]] = {}
        self._next_token = 0
        # the autoscaler's last decisions (signals + actions): an overload
        # dump then shows WHY the fleet was shedding, not just that it was
        self._decisions: deque = deque(maxlen=64)
        # the SLO engine's last alert transitions: a crash dump carries
        # which budgets were burning when the process died
        self._alerts: deque = deque(maxlen=64)
        self.burst_threshold = int(burst_threshold)
        self.burst_window_s = float(burst_window_s)
        self.cooldown_s = float(cooldown_s)
        self._recent_errors: deque = deque(maxlen=max(self.burst_threshold,
                                                      1))
        self._last_burst_mono = -float("inf")
        self.dumps = 0
        # mutation sequence: the autosave thread only rewrites the file
        # when something actually changed since the last write
        self._seq = 0
        self._saved_seq = 0
        self._stop = threading.Event()
        self._autosave_thread: Optional[threading.Thread] = None

    # -- hot-path recording --------------------------------------------------

    def begin_request(self, trace_id: Optional[str], endpoint: str) -> int:
        """Mark a request in flight; returns the token for end_request."""
        rec = {"trace_id": trace_id, "endpoint": endpoint,
               "ts": round(time.time(), 6)}
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._in_flight[token] = rec
            self._seq += 1
        return token

    def end_request(self, token: int, record: Dict[str, Any]) -> None:
        """Retire an in-flight request into the completed ring; a 5xx or a
        shed 429 outcome also feeds the burst detector — an admission-
        control storm is exactly the moment the rings are evidence."""
        with self._lock:
            begin = self._in_flight.pop(token, None)
            if begin is not None and "ts" not in record:
                record = dict(record, ts=begin["ts"])
            self._requests.append(record)
            self._seq += 1
            status = record.get("status")
            if isinstance(status, int) and (status >= 500 or status == 429):
                self._recent_errors.append(time.monotonic())

    def note_alert(self) -> None:
        """Feed a non-HTTP alert (e.g. a model drift alert) into the SAME
        burst detector 5xx/429 responses arm: a storm of drift alerts
        triggers one rate-limited flight dump, exactly like an error
        burst."""
        with self._lock:
            self._recent_errors.append(time.monotonic())

    def record_flush(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._flushes.append(record)
            self._seq += 1

    def record_decision(self, record: Dict[str, Any]) -> None:
        """Append one autoscaler decision (signals + action) to the
        bounded ring the dump carries."""
        with self._lock:
            self._decisions.append(record)
            self._seq += 1

    def record_alert(self, record: Dict[str, Any]) -> None:
        """Append one SLO alert transition (firing/resolved) to the
        bounded ring the dump carries."""
        with self._lock:
            self._alerts.append(record)
            self._seq += 1

    def error_burst(self) -> bool:
        """True when the last ``burst_threshold`` 5xx responses all landed
        inside ``burst_window_s`` — arming the per-``cooldown_s`` rate
        limit as a side effect, so one burst produces one dump."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_burst_mono < self.cooldown_s:
                return False
            if len(self._recent_errors) < self.burst_threshold:
                return False
            if now - self._recent_errors[0] > self.burst_window_s:
                return False
            self._last_burst_mono = now
            return True

    # -- the dump ------------------------------------------------------------

    def snapshot(self, reason: str) -> Dict[str, Any]:
        with self._lock:
            return {
                "reason": reason,
                "replica": self.replica,
                "ts": round(time.time(), 6),
                "pid": os.getpid(),
                "n_requests": len(self._requests),
                "n_flushes": len(self._flushes),
                "in_flight": sorted(
                    self._in_flight.values(),
                    key=lambda r: (r.get("ts") or 0,
                                   str(r.get("trace_id")))),
                "in_flight_trace_ids": sorted(
                    str(r["trace_id"]) for r in self._in_flight.values()
                    if r.get("trace_id")),
                "requests": list(self._requests),
                "flushes": list(self._flushes),
                "autoscaler_decisions": list(self._decisions),
                "alerts": list(self._alerts),
            }

    def dump(self, reason: str) -> Optional[Path]:
        """Atomic write of the current snapshot; returns the path (None
        when the recorder has no run dir). Never raises — a full disk must
        not turn a trigger into a second failure."""
        if self.path is None:
            return None
        snap = self.snapshot(reason)
        with self._lock:
            self.dumps += 1
            self._saved_seq = self._seq
        tmp = self.path.with_suffix(f".tmp.{os.getpid()}")
        try:
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            return None
        if self.events is not None and reason != "autosave":
            # the periodic autosave is housekeeping, not an incident — only
            # triggered dumps leave an event row
            try:
                self.events.counter(
                    "serve/flightrecorder", reason=reason,
                    replica=self.replica,
                    in_flight=len(snap["in_flight"]))
            except Exception:
                pass  # telemetry must not fail the dump path
        return self.path

    # -- background autosave --------------------------------------------------

    def start_autosave(self, interval_s: Optional[float] = None) -> None:
        """Persist the rings every ``interval_s`` while they change
        (``DLAP_FLIGHT_AUTOSAVE_S``, default 1.0; <= 0 disables): a
        process SIGKILLed with no last words leaves a snapshot at most one
        interval stale."""
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(ENV_AUTOSAVE,
                                                  DEFAULT_AUTOSAVE_S))
            except ValueError:
                interval_s = DEFAULT_AUTOSAVE_S
        if interval_s <= 0 or self.path is None \
                or self._autosave_thread is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                with self._lock:
                    dirty = self._seq != self._saved_seq
                if dirty:
                    self.dump("autosave")

        self._autosave_thread = threading.Thread(
            target=loop, daemon=True, name="flight-autosave")
        self._autosave_thread.start()

    def stop_autosave(self) -> None:
        self._stop.set()
        if self._autosave_thread is not None:
            self._autosave_thread.join(timeout=2)
            self._autosave_thread = None


def load_flightrecorder(run_dir,
                        prev: bool = False) -> Optional[Dict[str, Any]]:
    """Read a run dir's ``flightrecorder.json`` (``prev=True``: the
    rotated previous-incarnation dump — where a killed server's last
    snapshot lands after its restart). Tolerant: missing or torn → None.
    The atomic dump makes torn documents unreachable in practice; this
    guard covers manual copies."""
    path = Path(run_dir) / (FILENAME_PREV if prev else FILENAME)
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def slowest_requests(records: List[Dict[str, Any]],
                     n: int = 5) -> List[Dict[str, Any]]:
    """The slowest-N request records by total duration, deterministically
    ordered (duration desc, then trace id) — for reading a recorder's
    tail latency."""
    keyed = [r for r in records
             if isinstance(r.get("duration_s"), (int, float))]
    keyed.sort(key=lambda r: (-r["duration_s"], str(r.get("trace_id"))))
    return keyed[:n]
