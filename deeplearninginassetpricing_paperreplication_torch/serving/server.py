"""HTTP serving: the transport-agnostic :class:`ServingService` JSON API over
the :class:`~.engine.InferenceEngine`, with two front ends — the asyncio
server (:mod:`.aserver`, continuous batching; the default) and the
deprecated stdlib ``ThreadingHTTPServer`` (``--server threaded``). The
port's counterpart of the JAX package's ``serving/server.py``.

Endpoints::

    POST /v1/weights  {"individual": [[...]], "mask": [...]?, "month": t?}
                      → {"weights": [...], "month": t, "n": N, ...}
    POST /v1/sdf      same + {"returns": [...]} → {"sdf": F, "member_sdf": [..]}
    POST /v1/macro    {"macro": [...], "raw": false?} — O(1) incremental
                      macro-state advance → {"month": new index}
    POST /v1/reload   hot-swap params: from an explicit
                      {"checkpoint_dirs": [...]} payload, from the
                      configured promotion pointer (--pointer: re-read,
                      digest-verified, and each member's on-disk bytes
                      checked against the digests the gate recorded — a
                      member torn after promotion fails the reload whole),
                      or from the engine's current dirs; the last served
                      requests are replayed across the swap (the canary)
                      and a swap whose replayed outputs are non-finite is
                      reverted and answered 5xx
                      → {"params_fingerprint", "params_generation",
                         "swapped", "canary"?, "pointer_generation"?,
                         "converged"?}
    POST /v1/drain    (admin port only) stop accepting, flush, close
    POST /v1/debug/flightrecorder  (admin port only) dump the recorder
    POST /v1/debug/profile  (admin port only) {"action": "start"|"stop"}: a
                      torch.profiler capture into RUN/profile/capture<n>/,
                      written as a Chrome trace on stop
    GET  /v1/models   ensemble manifest (members, config hash, buckets, ...)
    GET  /healthz     liveness; mirrors the run dir's heartbeat.json
    GET  /metrics     request counts, latency percentiles, cache,
                      coalescing, batcher, model health and engine stats;
                      ``?format=prom`` for the Prometheus text exposition

Three wires reach ``/v1/weights`` (the last two also ``/v1/sdf``):

* JSON lists (above);
* base64: ``"individual_b64"`` (row-major float32 bytes) plus optional
  ``"mask_b64"``/``"returns_b64"``, and ``"encoding": "b64"`` answers
  ``weights_b64``/``member_sdf_b64`` the same way;
* raw f32 (``Content-Type: application/x-dlap-f32``, ``/v1/weights``
  only): body ``[i32 month][u32 n][n·F f32 row-major]``, answer ``[n f32
  weights]`` — no JSON anywhere.

All three decode to the same float32 arrays and ride the same batcher, so
they answer bit for bit alike. Results are cached in an LRU keyed by
(config hash, params fingerprint, request fingerprint), so a hot swap can
never serve a stale entry; concurrent identical queries share one
dispatch (single-flight coalescing, async mode). A full queue is HTTP 503,
shed work 429 with ``Retry-After``.

    python -m deeplearninginassetpricing_paperreplication_torch.serving.server \\
        --checkpoint_dirs ref_runs/w500 ref_runs/mid2000 --data_dir DATA --port 8787

The server runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import binascii
import functools
import hashlib
import json
import struct
import sys
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..observability import (
    EventLog,
    Heartbeat,
    read_state,
    write_manifest,
)
from ..observability.metrics import PROM_CONTENT_TYPE, render_process_prom
from ..observability.tracecontext import TraceContext
from ..reliability import faults
from .batcher import ContinuousBatcher, MicroBatcher, QueueFull, Shed
from .engine import (
    DEFAULT_STOCK_BUCKETS,
    InferenceEngine,
    InferenceRequest,
    bucket_for,
)
from .flight import FlightRecorder

HEARTBEAT_INTERVAL_S = 5.0
DISPATCH_TIMEOUT_S = 30.0
# the JSON-free hot wire for /v1/weights: request body is
# [i32 month][u32 n][n*F f32 row-major characteristics], response body is
# [n f32 weights] — no JSON parse, no base64, no per-float boxing
BINARY_CONTENT_TYPE = "application/x-dlap-f32"

# priority-lane request contract (batcher.PRIORITIES): the header wins,
# the path decides the default — single-month weight/SDF queries are
# interactive; grid-shaped endpoints default bulk
PRIORITY_HEADER = "x-dlap-priority"
DEADLINE_HEADER = "x-dlap-deadline-ms"
BULK_DEFAULT_PREFIXES = ("/v1/scenarios", "/v1/bulk")


def priority_for(endpoint: str, header: Optional[str]) -> str:
    """Resolve a request's priority class: a valid ``x-dlap-priority``
    header value wins; otherwise the path-based default (bulk for
    ``BULK_DEFAULT_PREFIXES``, interactive for everything else). Unknown
    header values fall back to the path default — a typo must not turn a
    bulk sweep into interactive traffic."""
    if header:
        value = header.strip().lower()
        if value in ("interactive", "bulk"):
            return value
    if any(endpoint.startswith(p) for p in BULK_DEFAULT_PREFIXES):
        return "bulk"
    return "interactive"


def deadline_from_header(header: Optional[str],
                         t0: float) -> Optional[float]:
    """``x-dlap-deadline-ms`` (a client latency budget in milliseconds)
    → an absolute ``time.monotonic()`` deadline anchored at request
    arrival ``t0``. Malformed or non-positive values mean no deadline —
    a bad header must not shed the request."""
    if not header:
        return None
    try:
        budget_ms = float(header)
    except (TypeError, ValueError):
        return None
    if budget_ms <= 0:
        return None
    return t0 + budget_ms / 1e3


class BadRequest(ValueError):
    """Client-side payload problem → HTTP 400."""


class LRUCache:
    """Tiny thread-safe LRU for response dicts."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key, value) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self):
        with self._lock:
            return len(self._d)


def request_fingerprint(endpoint: str, payload: Dict[str, Any]) -> str:
    """Canonical-JSON sha256 of one request — the cache key's second half."""
    blob = json.dumps([endpoint, payload], sort_keys=True,
                      separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


class _ProfileCapture:
    """One ``torch.profiler`` capture on a thread of its own: the profiler
    is started and stopped on the same thread whichever request threads
    ask for it, and records the device's kernels process-wide."""

    def __init__(self, trace_dir: Path, cuda: bool):
        self.trace_dir = Path(trace_dir)
        self.cuda = cuda
        self._started = threading.Event()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._trace: Optional[Path] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-profile")

    def _run(self) -> None:
        import torch

        try:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — answered as a 501
            self._error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            path = self.trace_dir / "trace.json"
            prof.export_chrome_trace(str(path))
            self._trace = path
        except Exception as e:  # noqa: BLE001 — answered as a 501
            self._error = e

    def start(self, timeout: float = 60.0) -> None:
        self._thread.start()
        if not self._started.wait(timeout):
            raise TimeoutError("the profiler did not start")
        if self._error is not None:
            raise self._error

    def stop(self, timeout: float = 300.0) -> Path:
        self._stop.set()
        self._thread.join(timeout)
        if self._error is not None:
            raise self._error
        if self._trace is None:
            raise TimeoutError("the profiler did not write its trace")
        return self._trace


class ServingService:
    """Engine + batcher + LRU cache + telemetry, transport-agnostic.

    The HTTP front ends are thin shims over :meth:`handle` (threaded),
    :meth:`handle_async` and :meth:`handle_binary_async` (async); tests
    drive the service directly."""

    def __init__(
        self,
        engine: InferenceEngine,
        run_dir: Optional[str] = None,
        max_batch: Optional[int] = None,
        max_delay_s: float = 0.002,
        max_queue: int = 256,
        cache_size: int = 256,
        events: Optional[EventLog] = None,
        mode: str = "threaded",
        replica_id: Optional[int] = None,
        pointer_root: Optional[str] = None,
        coalesce: bool = True,
        bulk_threshold: float = 0.5,
        reference_profile: Optional[Any] = None,
        drift_every: int = 64,
        drift_psi_threshold: float = 0.25,
        canary_size: int = 4,
    ):
        if mode not in ("threaded", "async"):
            raise ValueError(f"mode must be threaded|async: {mode!r}")
        self.engine = engine
        self.mode = mode
        self.replica_id = replica_id
        # promotion control plane: when set, /v1/reload with no explicit
        # dirs re-reads this pointer and hot-swaps to ITS generation (the
        # rolling-update path, serving/fleet.RollingUpdater)
        self.pointer_root = Path(pointer_root) if pointer_root else None
        self.replica_label = (f"replica{replica_id}"
                              if replica_id is not None else None)
        if events is not None:
            self.events = events
        elif run_dir is not None:
            # a run dir implies a sink; rebind the engine too so its
            # capture/dispatch telemetry lands in the same events.jsonl
            self.events = EventLog(run_dir)
        else:
            self.events = engine.events
        engine.events = self.events
        self.run_dir = Path(run_dir) if run_dir else None
        self.heartbeat: Optional[Heartbeat] = None
        if self.run_dir is not None:
            self.heartbeat = Heartbeat(
                self.run_dir / "heartbeat.json", events=self.events)
            write_manifest(
                self.run_dir, "serve", events=self.events,
                config=engine.cfg,
                extra={
                    "checkpoint_dirs": engine.checkpoint_dirs,
                    "stock_buckets": list(engine.stock_buckets),
                    "batch_buckets": list(engine.batch_buckets),
                    "device": str(engine.device),
                    "compute_dtype": engine.exec_cfg.compute_dtype,
                    "mesh": engine.stats().get("mesh"),
                    "mesh_devices": engine.stats().get("mesh_devices"),
                },
            )
            self.heartbeat.beat("serve/start")
        self.cache = LRUCache(cache_size)
        # the crash flight recorder: bounded rings of the last requests /
        # flushes + the in-flight set, dumped on error bursts, shutdown,
        # the SIGUSR1 flare, injected deaths and the admin endpoint (plus a
        # background autosave)
        self.flight = FlightRecorder(
            run_dir=run_dir, replica=self.replica_label, events=self.events)
        self.flight.start_autosave()
        faults.add_pre_death_hook(self._fault_last_words)
        self._shutdown_reason = "shutdown"
        self._max_batch = (max(engine.batch_buckets) if max_batch is None
                           else max_batch)
        self._max_queue = max_queue
        self._bulk_threshold = bulk_threshold
        # single-flight request coalescing (async mode): concurrent
        # IDENTICAL queries — same (config hash, params fingerprint,
        # endpoint, month, payload digest, priority) — share ONE in-flight
        # dispatch. Event-loop-local state: no lock needed, and a hot swap
        # rotates the fingerprint so a post-swap twin never joins a
        # pre-swap flight. Futures hold (ok, value) pairs, never raw
        # exceptions — an owner error with zero waiters must not log an
        # "exception was never retrieved" at GC.
        self.coalesce = bool(coalesce)
        self._inflight: Dict[Any, Any] = {}
        self.coalesce_hits = 0
        self.coalesce_dispatches = 0
        # model health (observability/drift.py + the engine's generation
        # quality → the dlap_model_* gauges on /metrics):
        #   * reference_profile: the training panel's distribution sketch;
        #     every drift_every-th inference request's characteristics are
        #     PSI-scored against it, alerts past drift_psi_threshold count
        #     into dlap_model_drift_alerts_total and feed the flight
        #     recorder's burst trigger;
        #   * canary ring: the last canary_size served request inputs,
        #     replayed across every /v1/reload hot swap — the divergence
        #     lands in events.jsonl (serve/canary) and a swap whose
        #     replayed outputs are non-finite is REVERTED and 5xx'd.
        self._profile: Optional[Dict[str, Any]] = None
        if reference_profile is not None:
            if isinstance(reference_profile, dict):
                self._profile = reference_profile
            else:
                from ..observability.drift import read_profile

                self._profile = read_profile(reference_profile)
        self.drift_every = max(1, int(drift_every))
        self.drift_psi_threshold = float(drift_psi_threshold)
        self.drift_alerts = 0
        self.drift_scored = 0
        self._drift_psi_last: Optional[float] = None
        self._obs_counter = 0
        self._canary: deque = deque(maxlen=max(0, int(canary_size)))
        # drain support (admin /v1/drain): the async front end installs a
        # hook that closes the public listener while queued work flushes
        self.draining = False
        self._drain_hook: Optional[Any] = None
        self.cbatcher: Optional[ContinuousBatcher] = None
        self.batcher: Optional[MicroBatcher] = None
        if mode == "threaded":
            self.batcher = MicroBatcher(
                self._handle_batch,
                max_batch=self._max_batch,
                max_delay_s=max_delay_s,
                max_queue=max_queue,
            )
        self.accepting = False  # set by the front end once the socket is up
        self._lock = threading.Lock()
        self._profile_lock = threading.Lock()  # /v1/debug/profile state
        self._profiler: Optional[Any] = None
        self._profile_dir: Optional[Path] = None
        self._profile_seq = 0
        self._latencies: deque = deque(maxlen=4096)  # seconds
        self._requests: Dict[Tuple[str, str], int] = {}
        self._started = time.monotonic()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if self.heartbeat is not None:
            self._hb_thread = threading.Thread(
                target=self._hb_loop, daemon=True, name="serving-heartbeat")
            self._hb_thread.start()

    # -- lifecycle -----------------------------------------------------------

    def _hb_loop(self):
        while not self._hb_stop.wait(HEARTBEAT_INTERVAL_S):
            # the steady section mirrors the lifecycle state: a fleet
            # readiness check matches on a PERSISTENT "serve/accepting",
            # not a one-shot beat an idle beat could overwrite; a draining
            # replica advertises that too (the autoscaler's scale-down
            # watches for it before stopping the process)
            if self.draining:
                section = "serve/draining"
            elif self.accepting:
                section = "serve/accepting"
            else:
                section = "serve/idle"
            self.heartbeat.beat(section)

    def start_async(self) -> None:
        """Create the continuous batcher on the RUNNING event loop (async
        mode only; the aserver front end calls this once at startup)."""
        if self.mode != "async":
            raise RuntimeError("start_async() requires mode='async'")
        if self.cbatcher is None:
            self.cbatcher = ContinuousBatcher(
                self._handle_batch,
                max_batch=self._max_batch,
                max_queue=self._max_queue,
                events=self.events,
                label=self.replica_label,
                flight=self.flight,
                bulk_threshold=self._bulk_threshold,
            )

    def warmup(self) -> int:
        n = self.engine.warmup()
        if self.heartbeat is not None:
            self.heartbeat.beat("serve/ready")
        return n

    def close(self):
        self._hb_stop.set()
        faults.remove_pre_death_hook(self._fault_last_words)
        self.flight.stop_autosave()
        # the final flight snapshot: "sigterm" when main() saw the signal,
        # plain "shutdown" otherwise
        self.flight.dump(self._shutdown_reason)
        if self.batcher is not None:
            self.batcher.close()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
        steady = self.engine.stats().get("steady_state_captures")
        if steady is not None:
            self.events.gauge("serve/steady_state_captures", steady)
        if self.run_dir is not None:
            try:
                (self.run_dir / "metrics.prom").write_text(
                    self.events.metrics.render_prom())
            except OSError:
                pass  # a snapshot must not turn shutdown into a failure
        if self.heartbeat is not None:
            self.heartbeat.beat("serve/stopped")

    # -- request plumbing ----------------------------------------------------

    def _handle_batch(self, bucket, items: List[InferenceRequest]):
        b = self.cbatcher if self.cbatcher is not None else self.batcher
        # the flush id rides into the engine's serve/dispatch span, so the
        # trace links request rows → flush → device dispatch by one id
        return self.engine.infer(
            items, flush=None if b is None else b.current_flush)

    def _fault_last_words(self, site: str, action: str) -> None:
        """faults.py pre-death hook: an injected kill leaves the same
        flight-recorder evidence a flare does."""
        self.flight.dump(f"fault:{site}")

    def _record(self, endpoint: str, status: int, seconds: float) -> None:
        with self._lock:
            key = (endpoint, str(status))
            self._requests[key] = self._requests.get(key, 0) + 1
            if status == 200:
                self._latencies.append(seconds)
        self.events.counter("serve/requests", endpoint=endpoint,
                            status=status, replica=self.replica_label)

    def _begin_rec(self, rec: Optional[Dict[str, Any]],
                   trace: Optional[TraceContext], endpoint: str,
                   method: str, t0: float) -> Tuple[Dict[str, Any], bool]:
        """Start one request's trace record; returns (rec, own) where
        ``own`` means THIS call must emit the row (no transport-side
        caller will add serialize/write segments and emit it)."""
        own = rec is None
        if rec is None:
            rec = {}
        if trace is None:
            trace = TraceContext.from_header(None)
        rec.update(trace=trace, endpoint=endpoint, method=method, t0=t0,
                   meta={}, token=self.flight.begin_request(
                       trace.trace_id, endpoint))
        return rec, own

    def emit_request(self, rec: Dict[str, Any],
                     serialize_s: float = 0.0,
                     write_s: Optional[float] = None) -> None:
        """Finish one request's trace record: retire it from the flight
        recorder, emit the compact ``request`` event row (sampled) or the
        aggregate ``span_end`` twin (unsampled), and dump the flight
        recorder on a 5xx burst. ``serialize_s``/``write_s``: transport-
        side segments measured after the handler returned. Never raises:
        telemetry must not fail a request that was already served."""
        rec["_finished"] = True
        try:
            self._emit_request(rec, serialize_s, write_s)
        except Exception:
            pass

    def _emit_request(self, rec: Dict[str, Any], serialize_s: float,
                      write_s: Optional[float]) -> None:
        trace: TraceContext = rec["trace"]
        meta = rec.get("meta") or {}
        status = rec.get("status", 500)
        seconds = rec.get("seconds", 0.0)
        serialize_total = float(meta.get("serialize_s") or 0.0) + serialize_s
        total = seconds + serialize_s + (write_s or 0.0)
        fields: Dict[str, Any] = {
            "endpoint": rec["endpoint"], "method": rec["method"],
            "status": status, "duration_s": round(total, 6),
        }
        if self.replica_label is not None:
            fields["replica"] = self.replica_label
        if rec.get("wire"):
            fields["wire"] = rec["wire"]
        t0 = rec["t0"]
        if "t_parsed" in meta:
            fields["parse_s"] = round(
                meta["t_parsed"] - t0 + rec.get("pre_parse_s", 0.0), 6)
        for flag in ("cached", "coalesced"):
            if meta.get(flag):
                fields[flag] = True
        if meta.get("priority"):
            fields["priority"] = meta["priority"]
        if rec.get("shed_reason"):
            fields["shed_reason"] = rec["shed_reason"]
        if "t_enq" in meta and "t_take" in meta:
            fields["queue_s"] = round(meta["t_take"] - meta["t_enq"], 6)
        if "t_take" in meta and "t_dispatch" in meta:
            fields["batch_s"] = round(
                meta["t_dispatch"] - meta["t_take"], 6)
        if "dispatch_s" in meta:
            fields["dispatch_s"] = round(meta["dispatch_s"], 6)
            fields["dispatch_share_s"] = round(
                meta["dispatch_s"] / max(1, meta.get("occupancy", 1)), 6)
        if "flush" in meta:
            fields["flush"] = meta["flush"]
            fields["occupancy"] = meta.get("occupancy")
        if serialize_total:
            fields["serialize_s"] = round(serialize_total, 6)
        if write_s is not None:
            fields["write_s"] = round(write_s, 6)
        self.flight.end_request(rec["token"], dict(
            fields, trace_id=trace.trace_id))
        if trace.sampled:
            self.events.emit("request", "serve/request",
                             trace_id=trace.trace_id,
                             span_id=trace.span_id,
                             parent_id=trace.parent_id, **fields)
        else:
            # the aggregate twin: the SAME label-relevant fields (the
            # replica and wire too — a partial sampling rate must not split
            # the histogram into different label sets), no per-request
            # identity
            twin = {k: fields[k] for k in
                    ("endpoint", "method", "status", "duration_s",
                     "replica", "wire", "priority") if k in fields}
            self.events.emit("span_end", "serve/request", **twin)
        if isinstance(status, int) and (status >= 500 or status == 429) \
                and self.flight.error_burst():
            self.flight.dump("error_burst")

    def abort_request(self, rec: Dict[str, Any]) -> None:
        """Retire a request whose transport died before emit_request ran
        (client disconnect mid-write)."""
        token = rec.get("token")
        if token is None or rec.get("_finished"):
            return
        rec["_finished"] = True
        trace = rec.get("trace")
        self.flight.end_request(token, {
            "trace_id": trace.trace_id if trace is not None else None,
            "endpoint": rec.get("endpoint"), "status": "aborted"})

    def _error_status(self, e: Exception,
                      rec: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """A request's exception → (HTTP status, body), shared by both
        handle paths: 400 a bad payload, 429 shed, 503 a full queue, 500
        anything else (a bad request must not kill the server)."""
        if isinstance(e, BadRequest):
            return 400, {"error": str(e)}
        if isinstance(e, Shed):
            return 429, self._shed_body(e, rec)
        if isinstance(e, QueueFull):
            rec["retry_after"] = 1
            return 503, {"error": f"overloaded: {e}", "_retry_after": 1}
        return 500, {"error": f"{type(e).__name__}: {e}"}

    def _finish(self, rec: Dict[str, Any], endpoint: str, status: int,
                t0: float, own: bool) -> None:
        seconds = time.monotonic() - t0
        rec.update(status=status, seconds=seconds)
        self._record(endpoint, status, seconds)
        if own:
            self.emit_request(rec)

    def handle(self, method: str, path: str,
               payload: Optional[Dict[str, Any]],
               raw_body: Optional[bytes] = None,
               trace: Optional[TraceContext] = None,
               admin: bool = False) -> Tuple[int, Dict]:
        """One request → (http status, response dict). Never raises.
        `raw_body`: the undecoded request bytes when the caller has them —
        the cache then fingerprints those instead of re-serializing the
        payload. ``trace``: the request's :class:`TraceContext` when the
        transport parsed a ``traceparent`` header."""
        t0 = time.monotonic()
        endpoint = path.split("?", 1)[0].rstrip("/") or "/"
        query = path.partition("?")[2]
        rec, _ = self._begin_rec(None, trace, endpoint, method, t0)
        try:
            status, body = self._route(method, endpoint, payload,
                                       raw_body, query=query, admin=admin,
                                       meta=rec["meta"])
        except Exception as e:
            status, body = self._error_status(e, rec)
        self._finish(rec, endpoint, status, t0, own=True)
        return status, body

    async def handle_async(self, method: str, path: str,
                           payload: Optional[Dict[str, Any]],
                           raw_body: Optional[bytes] = None,
                           trace: Optional[TraceContext] = None,
                           rec: Optional[Dict[str, Any]] = None,
                           admin: bool = False,
                           priority: Optional[str] = None,
                           deadline_ms: Optional[str] = None
                           ) -> Tuple[int, Dict]:
        """The event-loop twin of :meth:`handle`: inference awaits the
        continuous batcher instead of blocking a handler thread; blocking
        work (reload, macro step, drain, flight dump) runs in the loop's
        executor; everything else inline. ``rec``: a caller-owned record
        dict; when given, emission is DEFERRED to the caller's
        :meth:`emit_request` so the transport's serialize/write segments
        land on the same row. ``priority``/``deadline_ms``: the raw
        ``x-dlap-priority``/``x-dlap-deadline-ms`` header values."""
        t0 = time.monotonic()
        endpoint = path.split("?", 1)[0].rstrip("/") or "/"
        query = path.partition("?")[2]
        rec, own = self._begin_rec(rec, trace, endpoint, method, t0)
        try:
            if endpoint in ("/v1/weights", "/v1/sdf") and method == "POST":
                rec["wire"] = ("b64" if "individual_b64" in (payload or {})
                               else "json")
                status, body = 200, await self._infer_endpoint_async(
                    endpoint, payload or {}, raw_body, meta=rec["meta"],
                    priority=priority_for(endpoint, priority),
                    deadline=deadline_from_header(deadline_ms, t0))
            elif ((endpoint in ("/v1/reload", "/v1/macro", "/v1/drain")
                   or endpoint.startswith("/v1/debug/"))
                    and method == "POST"):
                status, body = await asyncio.get_running_loop(
                ).run_in_executor(None, functools.partial(
                    self._route, method, endpoint, payload, raw_body,
                    query=query, admin=admin))
            else:
                status, body = self._route(method, endpoint, payload,
                                           raw_body, query=query,
                                           admin=admin)
        except Exception as e:
            status, body = self._error_status(e, rec)
        self._finish(rec, endpoint, status, t0, own)
        return status, body

    def _shed_rec(self, e: Shed, rec: Dict[str, Any]) -> int:
        """Fill one shed request's record (Retry-After whole seconds,
        reason) — the one place the 429 retry policy lives."""
        retry_after = max(1, int(round(e.retry_after_s))) \
            if e.retry_after_s > 0 else 1
        rec["retry_after"] = retry_after
        rec["shed_reason"] = e.reason
        return retry_after

    def _shed_body(self, e: Shed, rec: Dict[str, Any]) -> Dict[str, Any]:
        retry_after = self._shed_rec(e, rec)
        return {"error": f"shed: {e}", "reason": e.reason,
                "retry_after_s": retry_after, "_retry_after": retry_after}

    def _route(self, method, endpoint, payload, raw_body,
               query: str = "", admin: bool = False,
               meta: Optional[Dict[str, Any]] = None) -> Tuple[int, Dict]:
        if endpoint == "/healthz":
            return 200, self.healthz()
        if endpoint == "/metrics":
            from urllib.parse import parse_qs

            q = parse_qs(query)
            if q.get("format", [""])[-1] == "prom":
                with_ex = q.get("exemplars", ["1"])[-1] not in ("0",
                                                                "false")
                return 200, {"_raw_text": self.metrics_prom(
                                 exemplars=with_ex),
                             "_content_type": PROM_CONTENT_TYPE}
            return 200, self.metrics()
        if endpoint == "/v1/models":
            return 200, self.models_info()
        if endpoint in ("/v1/weights", "/v1/sdf"):
            if method != "POST":
                return 405, {"error": "POST required"}
            return 200, self._infer_endpoint(endpoint, payload or {},
                                             raw_body, meta=meta)
        if endpoint == "/v1/macro":
            if method != "POST":
                return 405, {"error": "POST required"}
            return 200, self._macro_endpoint(payload or {})
        if endpoint == "/v1/reload":
            if method != "POST":
                return 405, {"error": "POST required"}
            return 200, self._reload_endpoint(payload)
        # the operational controls exist only on the private admin port;
        # the public socket answers 404
        if endpoint == "/v1/drain" and admin:
            if method != "POST":
                return 405, {"error": "POST required"}
            return self._drain_endpoint(payload or {})
        if endpoint == "/v1/debug/flightrecorder" and admin:
            if method != "POST":
                return 405, {"error": "POST required"}
            path = self.flight.dump("admin")
            if path is None:
                return 400, {"error": "flight recorder has no run dir to "
                                      "dump into (start the server with "
                                      "--run_dir)"}
            return 200, {"dumped": True, "path": str(path),
                         "in_flight": len(
                             self.flight.snapshot("")["in_flight"]),
                         "dumps": self.flight.dumps}
        if endpoint == "/v1/debug/profile" and admin:
            if method != "POST":
                return 405, {"error": "POST required"}
            return self._profile_endpoint(payload or {})
        return 404, {"error": f"unknown endpoint {endpoint}"}

    def _drain_endpoint(self, payload: Dict[str, Any]) -> Tuple[int, Dict]:
        """Graceful drain: flag the server draining (heartbeat section
        ``serve/draining``), wait up to ``timeout_s`` for the queued lanes
        to flush, answer, and THEN let the front end's drain hook close the
        public listener (~0.5 s after this response, so the answer reaches
        the caller first); the listener close unwinds the serve loop
        cleanly. Runs off the event loop (the executor branch of
        handle_async), so the wait cannot stall the flushes it waits for."""
        try:
            timeout_s = float(payload.get("timeout_s", 10.0))
        except (TypeError, ValueError):
            raise BadRequest("timeout_s must be a number") from None
        self.draining = True
        self.accepting = False
        if self.heartbeat is not None:
            self.heartbeat.beat("serve/draining")
        b = self.cbatcher if self.cbatcher is not None else self.batcher
        deadline = time.monotonic() + max(0.0, timeout_s)
        while b is not None and b.pending() > 0 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        pending = 0 if b is None else b.pending()
        self.events.counter("serve/drain", pending=pending,
                            replica=self.replica_label)
        hook = self._drain_hook
        if hook is not None:
            try:
                hook()
            except Exception:
                pass  # listener already closed / loop shutting down
        return 200, {"draining": True, "pending": pending,
                     "drained": pending == 0}

    def _profile_endpoint(self, payload: Dict[str, Any]) -> Tuple[int, Dict]:
        """A ``torch.profiler`` capture on a live server: ``{"action":
        "start"}`` begins one into the run dir (``profile/capture<n>/``),
        ``{"action": "stop"}`` ends it, writes ``trace.json`` (a Chrome
        trace: the host's ops and, on a CUDA device, the kernels on the
        device lanes — CUDA-graph replays included) and answers with its
        path. Guarded: admin port only, one capture at a time, always
        inside the run dir (no caller-controlled paths), and a profiler
        that cannot start or stop answers 501 with the reason instead of
        taking the server down."""
        action = payload.get("action")
        if action not in ("start", "stop"):
            raise BadRequest("payload requires \"action\": \"start\"|"
                             "\"stop\"")
        if self.run_dir is None:
            return 400, {"error": "profiling requires --run_dir (the "
                                  "capture is written into the run dir)"}
        # a DEDICATED lock: the hot-path self._lock (taken by _record on
        # every request) must not be held across profiler start/stop
        with self._profile_lock:
            active = self._profile_dir
            if action == "start":
                if active is not None:
                    return 409, {"error": f"a capture is already running "
                                          f"into {active}"}
                n = self._profile_seq
                self._profile_seq = n + 1
                trace_dir = self.run_dir / "profile" / f"capture{n}"
                trace_dir.mkdir(parents=True, exist_ok=True)
                capture = _ProfileCapture(
                    trace_dir, cuda=self.engine.device.type == "cuda")
                try:
                    capture.start()
                except Exception as e:
                    return 501, {"error": "torch.profiler unavailable: "
                                          f"{type(e).__name__}: {e}"}
                self._profiler = capture
                self._profile_dir = trace_dir
                self.events.counter("serve/profile", action="start",
                                    replica=self.replica_label)
                return 200, {"profiling": True,
                             "trace_dir": str(trace_dir)}
            if active is None:
                return 400, {"error": "no capture is running"}
            capture, self._profiler = self._profiler, None
            self._profile_dir = None
            try:
                trace = capture.stop()
            except Exception as e:
                return 501, {"error": "torch.profiler stop failed: "
                                      f"{type(e).__name__}: {e}"}
            self.events.counter("serve/profile", action="stop",
                                replica=self.replica_label)
        return 200, {"profiling": False, "trace_dir": str(active),
                     "trace": str(trace),
                     "non_empty": trace.stat().st_size > 0}

    # -- endpoints -----------------------------------------------------------

    def _b64_array(self, payload, key) -> Optional[np.ndarray]:
        """Decode a ``*_b64`` field (base64 of row-major float32 bytes).
        binascii rejects malformed padding; a wrong SIZE is caught by the
        shape checks of the caller."""
        blob = payload.get(key)
        if blob is None:
            return None
        try:
            return np.frombuffer(base64.b64decode(blob), np.float32)
        except (binascii.Error, TypeError, ValueError) as e:
            raise BadRequest(f"bad '{key}': {e}") from e

    def _parse_request(self, endpoint, payload) -> InferenceRequest:
        f = self.engine.cfg.individual_feature_dim
        flat = self._b64_array(payload, "individual_b64")
        if flat is not None:
            # compact wire format: float32 bytes, [N, F] row-major
            if flat.size == 0 or flat.size % f:
                raise BadRequest(
                    f"'individual_b64' must decode to N*{f} float32s; got "
                    f"{flat.size}")
            individual = flat.reshape(-1, f)
        elif "individual" in payload:
            try:
                individual = np.asarray(payload["individual"], np.float32)
            except (TypeError, ValueError) as e:
                raise BadRequest(f"bad 'individual': {e}") from e
            if individual.ndim != 2 or individual.shape[1] != f:
                raise BadRequest(
                    f"'individual' must be [N, {f}]; got "
                    f"{list(individual.shape)}")
        else:
            raise BadRequest("payload requires 'individual' ([N, F] floats) "
                             "or 'individual_b64' (base64 float32 bytes)")
        n = individual.shape[0]
        try:
            mask = self._b64_array(payload, "mask_b64")
            if mask is None and payload.get("mask") is not None:
                mask = np.asarray(payload["mask"], np.float32)
            returns = self._b64_array(payload, "returns_b64")
            if returns is None and payload.get("returns") is not None:
                returns = np.asarray(payload["returns"], np.float32)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad 'mask'/'returns': {e}") from e
        if mask is not None and mask.shape != (n,):
            raise BadRequest("'mask' must be [N]")
        if endpoint == "/v1/sdf" and returns is None:
            raise BadRequest("/v1/sdf requires 'returns' ([N] floats)")
        if returns is not None and returns.shape != (n,):
            raise BadRequest("'returns' must be [N]")
        try:
            month = int(payload.get("month", -1))
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad 'month': {e}") from e
        return InferenceRequest(individual=individual, mask=mask,
                                returns=returns, month=month)

    def _resolve_month(self, month: int) -> int:
        """A relative month against the engine's current macro months (a
        400 outside them)."""
        if self.engine.state_dim == 0:
            return month
        months = self.engine.months
        resolved = month if month >= 0 else months + month
        if not 0 <= resolved < months:
            raise BadRequest(f"month {month} outside the engine's {months} "
                             "macro months")
        return resolved

    def _stock_bucket(self, n: int) -> int:
        try:
            return bucket_for(n, self.engine.stock_buckets)
        except ValueError as e:
            raise BadRequest(str(e)) from e

    def _observe_request(self, req: InferenceRequest,
                         endpoint: str) -> None:
        """Model-health observation of one validated inference request:
        feed the canary ring (the inputs every hot swap is replayed
        against) and, every ``drift_every``-th request when a reference
        profile is configured, PSI-score its characteristics against it.
        Never raises — observation must not fail serving."""
        try:
            if self._canary.maxlen:
                # by reference: the parsed arrays are fresh per request and
                # the engine copies into its own staging
                self._canary.append(req)
            if self._profile is None:
                return
            with self._lock:
                self._obs_counter += 1
                due = self._obs_counter % self.drift_every == 1 \
                    or self.drift_every == 1
            if not due:
                return
            from ..observability.drift import score_request

            report = score_request(self._profile, req.individual, req.mask)
            psi = report["max_psi"]
            if psi is None:
                return
            with self._lock:
                self.drift_scored += 1
                self._drift_psi_last = psi
            self.events.gauge("model/drift_psi", round(psi, 6),
                              endpoint=endpoint,
                              replica=self.replica_label)
            if psi > self.drift_psi_threshold:
                with self._lock:
                    self.drift_alerts += 1
                self.events.counter(
                    "model/drift_alert", psi=round(psi, 6),
                    threshold=self.drift_psi_threshold, endpoint=endpoint,
                    replica=self.replica_label)
                # a drift storm dumps the same evidence an error burst does
                self.flight.note_alert()
                if self.flight.error_burst():
                    self.flight.dump("drift_burst")
        except Exception:  # noqa: BLE001 — observation must not fail serving
            pass

    def _infer_prepare(self, endpoint, payload, raw_body):
        """Parse + cache lookup; returns (key, bucket, req, cached_body) —
        ``cached_body`` short-circuits the dispatch when not None."""
        req = self._parse_request(endpoint, payload)
        # resolve a relative month BEFORE building the cache key: a cached
        # month=-1 answer must not outlive a /v1/macro append, and the
        # engine is handed the resolved index so key and computation agree
        req.month = self._resolve_month(req.month)
        bucket = self._stock_bucket(req.individual.shape[0])
        # only fully validated requests feed the canary ring and the drift
        # monitor
        self._observe_request(req, endpoint)
        key = None
        if self.cache.capacity > 0 or self.coalesce:
            fp = (hashlib.sha256(raw_body).hexdigest()
                  if raw_body is not None
                  else request_fingerprint(endpoint, payload))
            # the params fingerprint is in the key: a hot swap rotates it,
            # so the cache never serves pre-swap weights and a post-swap
            # twin never joins a pre-swap flight
            key = (self.engine.config_hash, self.engine.params_fingerprint,
                   endpoint, req.month, fp)
        if self.cache.capacity > 0:
            cached = self.cache.get(key)
            self.events.counter("serve/cache", hit=cached is not None,
                                endpoint=endpoint)
            if cached is not None:
                return key, None, req, dict(cached, cached=True)
        return key, bucket, req, None

    def _infer_finish(self, endpoint, payload, key, res) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "month": res.month, "n": res.n, "bucket": res.bucket,
            "batch_bucket": res.batch_bucket,
            "n_members": self.engine.n_members,
            "config_hash": self.engine.config_hash,
        }
        if self.replica_label is not None:
            body["replica"] = self.replica_label
        b64_out = payload.get("encoding") == "b64"
        if endpoint == "/v1/weights":
            w = np.asarray(res.weights, np.float32)
            if b64_out:
                body["weights_b64"] = base64.b64encode(w.tobytes()).decode()
            else:
                body["weights"] = w.astype(np.float64).tolist()
        else:
            body["sdf"] = res.sdf
            m = np.asarray(res.member_sdf, np.float32)
            if b64_out:
                body["member_sdf_b64"] = base64.b64encode(
                    m.tobytes()).decode()
            else:
                body["member_sdf"] = m.astype(np.float64).tolist()
        if key is not None:
            self.cache.put(key, body)
        return dict(body, cached=False)

    def _infer_endpoint(self, endpoint, payload, raw_body=None,
                        meta: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
        meta = {} if meta is None else meta
        key, bucket, req, cached = self._infer_prepare(endpoint, payload,
                                                       raw_body)
        meta["t_parsed"] = time.monotonic()
        if cached is not None:
            meta["cached"] = True
            return cached
        if self.batcher is not None:
            res = self.batcher.submit_wait(bucket, req,
                                           timeout=DISPATCH_TIMEOUT_S,
                                           meta=meta)
        else:
            # no thread batcher (async mode driven synchronously, e.g.
            # tests): one-at-a-time dispatch
            res = self.engine.infer([req])[0]
        t_res = time.monotonic()
        out = self._infer_finish(endpoint, payload, key, res)
        meta["serialize_s"] = time.monotonic() - t_res
        return out

    async def _single_flight(self, key, dispatch,
                             meta: Optional[Dict[str, Any]] = None):
        """Single-flight request coalescing: concurrent IDENTICAL queries
        (same ``key``) collapse onto ONE in-flight dispatch; every waiter
        shares the owner's result. The entry is removed the moment the
        flight completes, so this is NOT a cache: only genuinely concurrent
        twins share. Owner failures are shared too — EXCEPT admission
        sheds: an owner 429'd on its own deadline does not speak for its
        waiters, who re-dispatch under their own admission identity."""
        if not self.coalesce or key is None:
            return await dispatch()
        entry = self._inflight.get(key)
        if entry is not None:
            fut, owner_meta = entry
            self.coalesce_hits += 1
            if meta is not None:
                meta["coalesced"] = True
            try:
                self.events.counter("serve/coalesce", hit=True,
                                    replica=self.replica_label)
            except Exception:
                pass  # telemetry must never fail the request path
            # shield: one waiter's death must not cancel the shared flight
            ok, value = await asyncio.shield(fut)
            if ok:
                if meta is not None and owner_meta is not None:
                    for k in ("flush", "occupancy", "dispatch_s"):
                        if k in owner_meta:
                            meta[k] = owner_meta[k]
                return value
            if isinstance(value, Shed):
                return await dispatch()
            raise value
        # fault site: the dispatch-owner path
        faults.inject("serve/coalesce", path=self.replica_label or "")
        fut = asyncio.get_running_loop().create_future()
        self._inflight[key] = (fut, meta)
        self.coalesce_dispatches += 1
        try:
            try:
                self.events.counter("serve/coalesce", hit=False,
                                    replica=self.replica_label)
            except Exception:
                pass  # the finally below owns the cleanup either way
            res = await dispatch()
        except BaseException as e:
            if not fut.done():
                fut.set_result((False, e))
            raise
        else:
            if not fut.done():
                fut.set_result((True, res))
            return res
        finally:
            entry = self._inflight.get(key)
            if entry is not None and entry[0] is fut:
                del self._inflight[key]

    async def _infer_endpoint_async(self, endpoint, payload, raw_body=None,
                                    meta: Optional[Dict[str, Any]] = None,
                                    priority: str = "interactive",
                                    deadline: Optional[float] = None
                                    ) -> Dict[str, Any]:
        meta = {} if meta is None else meta
        key, bucket, req, cached = self._infer_prepare(endpoint, payload,
                                                       raw_body)
        meta["t_parsed"] = time.monotonic()
        if cached is not None:
            meta["cached"] = True
            return cached
        # priority rides the single-flight key: an interactive query never
        # coalesces onto a bulk flight
        res = await self._single_flight(
            key if key is None else key + (priority,),
            lambda: self.cbatcher.submit(
                bucket, req, meta=meta, priority=priority,
                deadline=deadline),
            meta=meta)
        t_res = time.monotonic()
        out = self._infer_finish(endpoint, payload, key, res)
        meta["serialize_s"] = time.monotonic() - t_res
        return out

    async def handle_binary_async(self, body: bytes,
                                  trace: Optional[TraceContext] = None,
                                  rec: Optional[Dict[str, Any]] = None,
                                  priority: Optional[str] = None,
                                  deadline_ms: Optional[str] = None
                                  ) -> Tuple[int, bytes]:
        """``/v1/weights`` over the raw-f32 wire (BINARY_CONTENT_TYPE):
        body = [i32 month][u32 n][n*F f32], response = [n f32 weights].
        Decodes with two ``np.frombuffer`` views — no JSON, no base64 —
        and rides the same continuous batcher, so the weights are bit for
        bit every other wire's. Uncached by design (the fingerprint hash
        would cost more than the lookup saves), but single-flight
        COALESCING applies (``coalesce=False`` restores the pure hot
        path). ``trace``/``rec``/``priority``/``deadline_ms``: as
        :meth:`handle_async`."""
        t0 = time.monotonic()
        rec, own = self._begin_rec(rec, trace, "/v1/weights", "POST", t0)
        rec["wire"] = "binary"
        meta = rec["meta"]
        status, out = 500, b"internal"
        try:
            f = self.engine.cfg.individual_feature_dim
            if len(body) < 8:
                raise BadRequest("body requires [i32 month][u32 n] header")
            month, n = struct.unpack_from("<iI", body)
            if n == 0 or len(body) != 8 + 4 * n * f:
                raise BadRequest(f"body must be 8 + 4*n*{f} bytes for n={n}")
            individual = np.frombuffer(
                body, np.float32, offset=8).reshape(n, f)
            month = self._resolve_month(month)
            req = InferenceRequest(individual=individual, month=month)
            bucket = self._stock_bucket(n)
            self._observe_request(req, "/v1/weights")
            pri = priority_for("/v1/weights", priority)
            key = None
            if self.coalesce:
                # month is inside the body bytes, so the body digest alone
                # identifies (month, universe); config + params fingerprint
                # pin the generation like every other key
                key = (self.engine.config_hash,
                       self.engine.params_fingerprint, "/v1/weights:bin",
                       month, hashlib.sha256(body).hexdigest(), pri)
            meta["t_parsed"] = time.monotonic()
            res = await self._single_flight(
                key, lambda: self.cbatcher.submit(
                    bucket, req, meta=meta, priority=pri,
                    deadline=deadline_from_header(deadline_ms, t0)),
                meta=meta)
            t_res = time.monotonic()
            status = 200
            out = np.ascontiguousarray(res.weights, np.float32).tobytes()
            meta["serialize_s"] = time.monotonic() - t_res
        except Shed as e:
            self._shed_rec(e, rec)
            status, out = 429, f"shed ({e.reason}): {e}".encode()
        except QueueFull as e:
            rec["retry_after"] = 1
            status, out = 503, f"overloaded: {e}".encode()
        except (BadRequest, ValueError) as e:
            status, out = 400, str(e).encode()
        except Exception as e:  # a bad request must not kill the server
            status, out = 500, f"{type(e).__name__}: {e}".encode()
        self._finish(rec, "/v1/weights", status, t0, own)
        return status, out

    def _macro_endpoint(self, payload) -> Dict[str, Any]:
        if "macro" not in payload:
            raise BadRequest("payload requires 'macro' ([M] floats)")
        try:
            month = self.engine.append_month(
                np.asarray(payload["macro"], np.float32),
                raw=bool(payload.get("raw", False)))
        except ValueError as e:
            raise BadRequest(str(e)) from e
        if self.heartbeat is not None:
            self.heartbeat.beat("serve/macro_append")
        return {"month": month, "months": self.engine.months}

    def _replay_canary(self, canary: List[InferenceRequest]
                       ) -> List[Optional[Any]]:
        """Serve the canary set against the CURRENT generation (direct
        engine dispatch, no batcher; ``observe=False`` so synthetic replays
        never pollute the live-traffic gauges). Per-item failures record
        as None instead of failing the reload."""
        results: List[Optional[Any]] = []
        for req in canary:
            try:
                results.append(self.engine.infer_one(req, observe=False))
            except Exception:  # noqa: BLE001 — canary must not 5xx a reload
                results.append(None)
        return results

    def _canary_divergence(self, canary: List[InferenceRequest],
                           baseline: List[Optional[Any]],
                           reload_out: Dict[str, Any]) -> Dict[str, Any]:
        """Replay the canary set against the NEW generation and measure
        the divergence from the pre-swap baseline; emits one
        ``serve/canary`` event row. ``finite`` False ⇒ the caller reverts
        the swap. A replay that ERRORS counts into ``errors``, not into
        ``finite``: a transient failure is not evidence the new weights
        are degenerate."""
        after = self._replay_canary(canary)
        replayed = errors = 0
        max_w = max_sdf = 0.0
        finite = True
        for pre, post in zip(baseline, after):
            if post is None:
                errors += 1
                continue
            replayed += 1
            w = np.asarray(post.weights, np.float64)
            if not np.isfinite(w).all():
                finite = False
            if post.sdf is not None and not np.isfinite(post.sdf):
                finite = False
            if pre is not None:
                w0 = np.asarray(pre.weights, np.float64)
                if w0.shape == w.shape and w0.size:
                    delta = np.abs(w - w0)
                    max_w = max(max_w, float(
                        delta[np.isfinite(delta)].max(initial=0.0)))
                if pre.sdf is not None and post.sdf is not None \
                        and np.isfinite(pre.sdf) and np.isfinite(post.sdf):
                    max_sdf = max(max_sdf, abs(post.sdf - pre.sdf))
        divergence = {
            "replayed": replayed,
            "errors": errors,
            "max_weight_delta": round(max_w, 8),
            "max_sdf_delta": round(max_sdf, 8),
            "finite": finite,
        }
        self.events.counter(
            "serve/canary", replica=self.replica_label,
            generation=reload_out.get("params_generation"),
            fingerprint=str(reload_out.get("params_fingerprint"))[:16],
            **divergence)
        return divergence

    def _reload_endpoint(self, payload: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        """Hot-swap params. Source precedence: an explicit
        ``checkpoint_dirs`` payload, else the configured promotion pointer
        (re-read and digest-verified; each member's on-disk bytes must
        match the digests the gate recorded — a mismatch fails the WHOLE
        reload and the engine keeps serving its current generation), else
        the engine's current dirs. The cache needs no flush: its keys
        carry the params fingerprint."""
        payload = payload or {}
        # fault site: a kill here dies mid-hot-swap; the supervisor
        # restarts the replica and it converges to the pointer on boot
        faults.inject("serve/reload", path=self.replica_label or "")
        dirs = payload.get("checkpoint_dirs")
        pointer = None
        if dirs is None and self.pointer_root is not None:
            from ..reliability.promotion import (
                read_pointer,
                verify_pointer_members,
            )

            pointer = read_pointer(self.pointer_root)
            if pointer is None:
                raise BadRequest(
                    f"no promotion pointer under {self.pointer_root}")
            mismatches = verify_pointer_members(pointer)
            if mismatches:
                raise RuntimeError(
                    "promotion pointer member digest mismatch — refusing "
                    "to swap a torn candidate: " + "; ".join(mismatches))
            dirs = pointer["checkpoint_dirs"]
        # the post-reload canary: replay the last served inputs across the
        # swap; a generation whose replayed outputs are non-finite is
        # swapped BACK from the held in-memory snapshot (an in-place reload
        # has no old bytes left on disk) and the reload 5xx'd. A pointer
        # reload whose members already hash to the serving fingerprint is
        # a guaranteed no-op and skips the baseline replay.
        noop = (pointer is not None
                and pointer.get("params_fingerprint")
                == self.engine.params_fingerprint)
        snapshot = None if noop else self.engine.snapshot_params()
        canary = [] if noop else list(self._canary)
        baseline = self._replay_canary(canary)
        out = self.engine.reload(checkpoint_dirs=dirs)
        if out.get("swapped"):
            divergence = self._canary_divergence(canary, baseline, out)
            out["canary"] = divergence
            if divergence["finite"] is False and snapshot is not None:
                self.engine.restore_params(snapshot)
                raise RuntimeError(
                    "post-reload canary produced non-finite outputs "
                    f"(replayed {divergence['replayed']} requests); "
                    "reverted to the previous generation")
        if pointer is not None:
            out["pointer_generation"] = pointer["generation"]
            out["converged"] = bool(
                out["params_fingerprint"]
                == pointer.get("params_fingerprint"))
        self.events.counter(
            "serve/generation", replica=self.replica_label,
            fingerprint=out["params_fingerprint"][:16],
            generation=out["params_generation"],
            pointer_generation=(pointer or {}).get("generation"),
            swapped=out.get("swapped"))
        if self.heartbeat is not None:
            self.heartbeat.beat("serve/reload")
        return out

    def models_info(self) -> Dict[str, Any]:
        return {
            "n_members": self.engine.n_members,
            "checkpoint_dirs": self.engine.checkpoint_dirs,
            "config_hash": self.engine.config_hash,
            "config": self.engine.cfg.to_dict(),
            "months": self.engine.months,
            "engine": self.engine.stats(),
        }

    def healthz(self) -> Dict[str, Any]:
        """Liveness + the run dir's on-disk heartbeat."""
        out: Dict[str, Any] = {
            "ok": True,
            "uptime_s": round(time.monotonic() - self._started, 3),
            "run_id": self.events.run_id,
            "device": str(self.engine.device),
            "months": self.engine.months,
        }
        if self.replica_label is not None:
            out["replica"] = self.replica_label
        if self.heartbeat is not None:
            out["heartbeat"] = (
                read_state(self.heartbeat.path).get("heartbeat"))
        return out

    def metrics_prom(self, exemplars: bool = True) -> str:
        """Prometheus text from the EventLog's live registry — request
        counts, latency histograms with derived p50/p95/p99, cache/
        capture/flush counters — plus the engine's steady-state gauges,
        the model-health gauges (``dlap_model_*``) and the host's
        ``dlap_process_*`` gauges. Fed from the SAME emit calls as
        events.jsonl, so a scrape and the event file agree on every
        count."""
        extra = []
        stats = self.engine.stats()
        steady = stats.get("steady_state_captures")
        if steady is not None:
            extra.append("# TYPE dlap_serve_steady_state_captures gauge")
            extra.append(f"dlap_serve_steady_state_captures {steady}")
        extra.append("# TYPE dlap_serve_dispatches_total counter")
        extra.append(f"dlap_serve_dispatches_total {stats['dispatches']}")
        extra.append("# TYPE dlap_serve_graph_replays_total counter")
        extra.append(f"dlap_serve_graph_replays_total {stats['replays']}")
        extra.append("# TYPE dlap_serve_coalesce_hits_total counter")
        extra.append(f"dlap_serve_coalesce_hits_total {self.coalesce_hits}")
        extra.append("# TYPE dlap_serve_coalesce_dispatches_total counter")
        extra.append("dlap_serve_coalesce_dispatches_total "
                     f"{self.coalesce_dispatches}")
        quality = self.engine.generation_quality()
        extra.append("# TYPE dlap_model_generation gauge")
        extra.append(f"dlap_model_generation {quality['generation']}")
        extra.append("# TYPE dlap_model_outputs_total counter")
        extra.append(f"dlap_model_outputs_total {quality['outputs']}")
        extra.append("# TYPE dlap_model_finite_fraction gauge")
        extra.append(
            f"dlap_model_finite_fraction {quality['finite_fraction']}")
        for key, name in (("weight_norm_mean", "dlap_model_weight_norm"),
                          ("weight_max_abs", "dlap_model_weight_max_abs"),
                          ("sdf_mean", "dlap_model_sdf_mean"),
                          ("sdf_vol", "dlap_model_sdf_vol")):
            if quality.get(key) is not None:
                extra.append(f"# TYPE {name} gauge")
                extra.append(f"{name} {quality[key]}")
        with self._lock:
            alerts = self.drift_alerts
            scored = self.drift_scored
            psi_last = self._drift_psi_last
        extra.append("# TYPE dlap_model_drift_alerts_total counter")
        extra.append(f"dlap_model_drift_alerts_total {alerts}")
        extra.append("# TYPE dlap_model_drift_scored_total counter")
        extra.append(f"dlap_model_drift_scored_total {scored}")
        if psi_last is not None:
            extra.append("# TYPE dlap_model_drift_psi gauge")
            extra.append(f"dlap_model_drift_psi {round(psi_last, 6)}")
        return (self.events.metrics.render_prom(exemplars=exemplars)
                + "\n".join(extra) + "\n" + render_process_prom())

    def metrics(self) -> Dict[str, Any]:
        from ..observability.report import latency_percentiles_ms

        with self._lock:
            lat = list(self._latencies)
            requests = {f"{ep} {st}": n
                        for (ep, st), n in sorted(self._requests.items())}
        latency = latency_percentiles_ms(lat)
        if latency is not None:
            latency["mean_ms"] = round(sum(lat) / len(lat) * 1e3, 3)
        b = self.cbatcher if self.cbatcher is not None else self.batcher
        batcher: Dict[str, Any] = {"mode": self.mode}
        if b is not None:
            batcher.update(flushes=b.flushes, rejected=b.rejected,
                           pending=b.pending())
        if self.cbatcher is not None:
            mean_depth = self.cbatcher.mean_queue_depth()
            batcher.update(
                occupancy_hist={str(k): v for k, v in sorted(
                    self.cbatcher.occupancy_hist.items())},
                mean_queue_depth=(round(mean_depth, 3)
                                  if mean_depth is not None else None),
                items_flushed=self.cbatcher.items_flushed,
                shed=dict(sorted(self.cbatcher.shed.items())),
                pending_by_priority=self.cbatcher.pending_by_priority(),
                bulk_max=self.cbatcher.bulk_max,
                max_queue=self.cbatcher.max_queue,
            )
        with self._lock:
            model_health = {
                "generation_quality": self.engine.generation_quality(),
                "drift": {
                    "enabled": self._profile is not None,
                    "alerts": self.drift_alerts,
                    "scored": self.drift_scored,
                    "psi_last": self._drift_psi_last,
                    "threshold": self.drift_psi_threshold,
                },
                "canary_size": len(self._canary),
            }
        out = {
            "requests": requests,
            "latency": latency,
            "cache": {"hits": self.cache.hits, "misses": self.cache.misses,
                      "size": len(self.cache)},
            "coalesce": {"enabled": self.coalesce,
                         "hits": self.coalesce_hits,
                         "dispatches": self.coalesce_dispatches},
            "model_health": model_health,
            "batcher": batcher,
            "draining": self.draining,
            "engine": self.engine.stats(),
        }
        if self.replica_label is not None:
            out["replica"] = self.replica_label
        return out


# -- HTTP shim (the deprecated threaded front end) ---------------------------


class _Handler(BaseHTTPRequestHandler):
    # the service is attached to the server object by make_server()
    protocol_version = "HTTP/1.1"

    def _respond(self, status: int, body: Dict) -> None:
        retry_after = None
        if isinstance(body, dict) and "_raw_text" in body:
            # non-JSON response (Prometheus text exposition)
            data = body["_raw_text"].encode()
            ctype = body.get("_content_type", "text/plain")
        else:
            if isinstance(body, dict):
                retry_after = body.pop("_retry_after", None)
            data = json.dumps(body).encode()
            ctype = "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        if retry_after is not None:
            self.send_header("Retry-After", str(int(retry_after)))
        self.end_headers()
        self.wfile.write(data)

    def _dispatch(self, method: str) -> None:
        payload = raw = None
        if method == "POST":
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                raw = self.rfile.read(length)
                try:
                    payload = json.loads(raw)
                except json.JSONDecodeError:
                    self._respond(400, {"error": "request body is not "
                                                 "valid JSON"})
                    return
        status, body = self.server.service.handle(
            method, self.path, payload, raw_body=raw,
            trace=TraceContext.from_header(
                self.headers.get("traceparent")))
        self._respond(status, body)

    def do_GET(self):  # noqa: N802 (stdlib handler API)
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def log_message(self, fmt, *args):  # stdout silence; events.jsonl has it
        pass


def make_server(service: ServingService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer for `service` (``mode="threaded"``:
    requests go through its MicroBatcher); port 0 picks a free port
    (``server.server_address[1]`` has the real one). The caller runs
    ``serve_forever()`` (typically on a thread) and ``shutdown()``s."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.service = service
    return httpd


# -- CLI ---------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    from ..evaluate_ensemble import add_execution_args

    p = argparse.ArgumentParser(
        description="Serve an SDF checkpoint ensemble over HTTP")
    p.add_argument("--checkpoint_dirs", type=str, nargs="+", default=None,
                   help="member run dirs (config.json + best_model_sharpe.pt)"
                        "; required unless --pointer names a promotion "
                        "pointer to serve from")
    p.add_argument("--pointer", type=str, default=None,
                   help="promotion control-plane root (or the "
                        "serving_current.json file itself): boot from the "
                        "pointer's current generation, and /v1/reload with "
                        "no body re-reads it (member digests verified)")
    p.add_argument("--admin_port", type=int, default=None, metavar="PORT",
                   help="also serve this replica's API on a PRIVATE "
                        "127.0.0.1 port (not SO_REUSEPORT-shared) that "
                        "unlocks /v1/drain and /v1/debug/{flightrecorder,"
                        "profile}: the rolling-update path targets one "
                        "replica's /v1/reload and /metrics through it (0 "
                        "picks a free port, printed at startup; async "
                        "server only; a fleet gives replica i PORT + i)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="panel dir; the serving macro history comes from "
                        "--macro_split (normalized with train stats)")
    p.add_argument("--macro_split", type=str, default="test",
                   choices=("train", "valid", "test"))
    p.add_argument("--macro_npy", type=str, default=None,
                   help="alternative to --data_dir: a .npy [T, M] macro "
                        "history, ALREADY normalized with train stats")
    p.add_argument("--server", type=str, default="async",
                   choices=("async", "threaded"),
                   help="'async' (default): asyncio event loop + "
                        "continuous batcher. 'threaded': DEPRECATED "
                        "thread-per-request ThreadingHTTPServer + deadline "
                        "micro-batcher")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve from R supervisor-managed replica processes "
                        "sharing one SO_REUSEPORT socket (async only); a "
                        "crashed replica is restarted and degrades "
                        "capacity, not availability")
    p.add_argument("--replica_id", type=int, default=None,
                   help="internal: this process's index in a replica fleet")
    p.add_argument("--autoscale", action="store_true",
                   help="load-adaptive fleet (requires --replicas mode): a "
                        "control thread scrapes per-replica metrics and "
                        "grows/shrinks the SO_REUSEPORT replica set "
                        "between --min_replicas and --max_replicas with "
                        "hysteresis + cooldown; every scale event rewrites "
                        "fleet.json atomically")
    p.add_argument("--min_replicas", type=int, default=None,
                   help="autoscale floor (default: 1)")
    p.add_argument("--max_replicas", type=int, default=None,
                   help="autoscale ceiling (default: max(4, --replicas))")
    p.add_argument("--autoscale_up_depth", type=float, default=8.0,
                   help="scale up when mean pending per replica reaches "
                        "this for --autoscale_up_hysteresis ticks")
    p.add_argument("--autoscale_down_depth", type=float, default=1.0,
                   help="scale down when mean pending per replica stays "
                        "at/below this (and nothing is shed) for "
                        "--autoscale_down_hysteresis ticks")
    p.add_argument("--autoscale_up_hysteresis", type=int, default=2)
    p.add_argument("--autoscale_down_hysteresis", type=int, default=8)
    p.add_argument("--autoscale_poll_s", type=float, default=0.5)
    p.add_argument("--autoscale_cooldown_s", type=float, default=5.0,
                   help="minimum seconds between scale events (anti-flap, "
                        "with hysteresis)")
    p.add_argument("--reuse_port", action="store_true",
                   help="bind with SO_REUSEPORT (replica fleets share the "
                        "port)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--run_dir", type=str, default=None,
                   help="telemetry dir (manifest, events, heartbeat, "
                        "flight recorder, metrics.prom at shutdown)")
    p.add_argument("--stock_buckets", type=str, default=None,
                   help="comma-separated stock-bucket ladder override "
                        "(default: powers of two capped at the panel size)")
    p.add_argument("--batch_buckets", type=str, default=None,
                   help="comma-separated batch-bucket ladder override")
    p.add_argument("--mesh", type=str, default=None, metavar="SPEC",
                   help="serve from a mesh of this process's devices instead "
                        "of one: a partition.parse_mesh_spec string "
                        "('stocks=4', 'stocks=-1' to fill every device, "
                        "'members=2,stocks=4', or a bare integer for the "
                        "stock axis). Each stock bucket is cut into spans "
                        "along 'stocks' (and the members along 'members'), "
                        "a CUDA graph per span; a spec needing more devices "
                        "than the host has is an error")
    p.add_argument("--mesh_slices", type=int, default=None, metavar="N",
                   help="fleet mode: cut the local devices into N disjoint "
                        "contiguous slices (partition.slice_devices) and "
                        "give replica i the slice i %% N, so co-hosted "
                        "replicas never share a device; requires --mesh "
                        "whose axes fit one slice")
    p.add_argument("--mesh_slice", type=str, default=None, metavar="I:N",
                   help="internal: lay this replica's --mesh over device "
                        "slice I of N (written by the fleet parent from "
                        "--mesh_slices)")
    p.add_argument("--max_batch", type=int, default=None,
                   help="max requests per flush (default: largest batch "
                        "bucket)")
    p.add_argument("--max_queue", type=int, default=256,
                   help="bounded backpressure: pending requests beyond "
                        "this are rejected with HTTP 503")
    p.add_argument("--bulk_threshold", type=float, default=0.5,
                   help="bulk-priority requests are shed with HTTP 429 + "
                        "Retry-After once pending reaches this fraction "
                        "of --max_queue")
    p.add_argument("--no_coalesce", action="store_true",
                   help="disable single-flight request coalescing")
    p.add_argument("--cache_size", type=int, default=256)
    p.add_argument("--reference_profile", type=str, default=None,
                   help="reference_profile.json to drift-score inference "
                        "requests against; default: the first serving "
                        "member dir carrying one. 'off' disables drift "
                        "scoring")
    p.add_argument("--drift_every", type=int, default=64,
                   help="PSI-score every K-th inference request's "
                        "characteristics against the reference profile")
    p.add_argument("--drift_psi_threshold", type=float, default=0.25,
                   help="PSI above this counts a drift alert "
                        "(dlap_model_drift_alerts_total)")
    p.add_argument("--max_delay_s", type=float, default=0.002,
                   help="deadline of the DEPRECATED threaded micro-batcher "
                        "(the continuous batcher flushes the moment the "
                        "device frees up)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip capturing every bucket before accepting "
                        "traffic (first requests then pay the captures)")
    add_execution_args(p)
    return p


def _parse_buckets(spec: Optional[str]) -> Optional[Tuple[int, ...]]:
    if not spec:
        return None
    return tuple(int(x) for x in spec.split(",") if x.strip())


def _load_macro(args):
    """(macro_history, macro_stats, n_stocks_cap) from --data_dir or
    --macro_npy (already normalized; no stats, no stock cap)."""
    if args.data_dir:
        # the chunked panel reader: bit for bit load_splits, shard-verified
        from ..data.pipeline import load_splits_chunked

        splits = dict(zip(("train", "valid", "test"),
                          load_splits_chunked(args.data_dir)))
        train = splits["train"]
        return (splits[args.macro_split].macro,
                (train.mean_macro, train.std_macro),
                max(s.N for s in splits.values()))
    if args.macro_npy:
        return np.load(args.macro_npy), None, None
    return None, None, None


def mesh_config(spec: str, mesh_slice: Optional[str], device: str):
    """``--mesh`` over the route's local devices or, with ``--mesh_slice
    I:N`` (stamped by the fleet parent from ``--mesh_slices``), over slice
    I of N of them: the lease contract the sweep's workers share, so
    co-hosted replicas never touch one device. Raises ``ValueError`` for a
    malformed slice or one the host cannot hold."""
    from ..parallel import partition

    devices = partition.local_devices(device)
    if mesh_slice:
        try:
            idx, n_slices = (int(x) for x in mesh_slice.split(":", 1))
        except ValueError:
            raise ValueError(f"--mesh_slice must be I:N, got "
                             f"{mesh_slice!r}") from None
        devices = partition.slice_devices(idx, n_slices, devices=devices)
    return partition.parse_mesh_spec(spec, devices)


def build_service(args: argparse.Namespace,
                  events: Optional[EventLog] = None) -> ServingService:
    """Everything ``main`` serves, from parsed CLI arguments: the macro
    history, the ensemble (from ``--checkpoint_dirs`` or the promotion
    pointer's current generation), the drift profile and the service, with
    every bucket warmed unless ``--no_warmup``. The stock-bucket ladder is
    capped at the panel's stock count, so warmup captures only buckets this
    deployment can hit. Raises ``ValueError`` for an unusable argument set."""
    from ..evaluate_ensemble import execution_config

    exec_cfg = execution_config(args)  # fails before any loading
    if not args.checkpoint_dirs and not args.pointer:
        raise ValueError("pass --checkpoint_dirs or --pointer")
    if events is None:
        events = EventLog(args.run_dir) if args.run_dir else EventLog()
    macro_history, macro_stats, n_max = _load_macro(args)
    checkpoint_dirs = args.checkpoint_dirs
    boot_pointer = None
    if args.pointer and not checkpoint_dirs:
        # boot from the pointer's current generation (strict member-digest
        # enforcement belongs to /v1/reload, where an incumbent serves)
        from ..reliability.promotion import read_pointer

        boot_pointer = read_pointer(args.pointer)
        if boot_pointer is None:
            raise ValueError(f"no promotion pointer under {args.pointer}")
        checkpoint_dirs = boot_pointer["checkpoint_dirs"]
    kwargs: Dict[str, Any] = dict(macro_history=macro_history,
                                  macro_stats=macro_stats, events=events)
    stock_buckets = _parse_buckets(args.stock_buckets)
    if stock_buckets is None and n_max is not None:
        top = bucket_for(n_max, DEFAULT_STOCK_BUCKETS)
        stock_buckets = tuple(b for b in DEFAULT_STOCK_BUCKETS if b <= top)
    if stock_buckets is not None:
        kwargs["stock_buckets"] = stock_buckets
    batch_buckets = _parse_buckets(args.batch_buckets)
    if batch_buckets is not None:
        kwargs["batch_buckets"] = batch_buckets
    if args.mesh:
        kwargs["mesh"] = mesh_config(args.mesh, args.mesh_slice,
                                     exec_cfg.device)
    engine = InferenceEngine(checkpoint_dirs, exec_cfg=exec_cfg, **kwargs)
    # the drift reference profile: an explicit path wins; 'off' disables;
    # default = the first serving member dir carrying one
    from ..observability.drift import read_profile

    reference_profile = None
    if args.reference_profile not in (None, "off"):
        reference_profile = read_profile(args.reference_profile)
        if reference_profile is None:
            raise ValueError(f"--reference_profile {args.reference_profile}"
                             " is missing or unreadable")
    elif args.reference_profile is None:
        for d in checkpoint_dirs:
            reference_profile = read_profile(d)
            if reference_profile is not None:
                break
    service = ServingService(
        engine, run_dir=args.run_dir, max_batch=args.max_batch,
        max_delay_s=args.max_delay_s, max_queue=args.max_queue,
        cache_size=args.cache_size, events=events, mode=args.server,
        replica_id=args.replica_id, pointer_root=args.pointer,
        coalesce=not args.no_coalesce,
        bulk_threshold=args.bulk_threshold,
        reference_profile=reference_profile,
        drift_every=args.drift_every,
        drift_psi_threshold=args.drift_psi_threshold)
    if boot_pointer is not None:
        # the boot row of the convergence timeline: this replica came up
        # serving the pointer's generation (a replica that died
        # mid-promotion re-enters here and converges without a reload)
        events.counter(
            "serve/generation", replica=service.replica_label,
            fingerprint=engine.params_fingerprint[:16],
            generation=engine.params_generation,
            pointer_generation=boot_pointer["generation"],
            swapped=None, boot=True)
    if not args.no_warmup:
        n = service.warmup()
        print(f"warmed {n} buckets (stock buckets "
              f"{list(engine.stock_buckets)}, batch buckets "
              f"{list(engine.batch_buckets)}; {engine.stats()['captures']} "
              f"CUDA graphs) on {engine.device}", flush=True)
    return service


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    if not args.checkpoint_dirs and not args.pointer:
        print("serving.server: pass --checkpoint_dirs or --pointer",
              file=sys.stderr)
        return 2
    if args.replicas > 1 or args.autoscale:
        # the fleet parent never touches the device: it only spawns and
        # supervises replica children (each a fresh `--replica_id i` run of
        # this CLI on a shared SO_REUSEPORT socket, with the parent's
        # --device, --kernel and --compute_dtype), so only the children
        # hold a CUDA context. --autoscale implies fleet mode even at
        # --replicas 1: a fleet of one that can grow
        from .fleet import main_from_server_args

        return main_from_server_args(args)
    # SIGTERM is a CLEAN shutdown (the close path writes metrics.prom, the
    # flight-recorder dump and the last heartbeat): it raises
    # KeyboardInterrupt like Ctrl-C. SIGUSR1 is the flare: dump the flight
    # recorder from a FRESH thread (the handler interrupts the main thread
    # mid-bytecode, which may hold the recorder's non-reentrant lock)
    import signal

    holder: Dict[str, Any] = {}

    def on_sigterm(signum, frame):  # noqa: ARG001 — signal-handler shape
        svc = holder.get("service")
        if svc is not None:
            svc._shutdown_reason = "sigterm"
        raise KeyboardInterrupt

    def on_flare(signum, frame):  # noqa: ARG001 — signal-handler shape
        svc = holder.get("service")
        if svc is not None:
            threading.Thread(target=svc.flight.dump, args=("watchdog",),
                             daemon=True, name="flare-dump").start()

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGUSR1, on_flare)
    events = EventLog(args.run_dir) if args.run_dir else EventLog()
    try:
        service = build_service(args, events)
    except ValueError as e:
        print(f"serving.server: {e}", file=sys.stderr)
        return 2
    holder["service"] = service
    engine = service.engine
    try:
        if args.server == "threaded":
            print("WARNING: --server threaded is DEPRECATED (thread-per-"
                  "request + deadline micro-batching); use --server async",
                  file=sys.stderr, flush=True)
            httpd = make_server(service, args.host, args.port)
            host, port = httpd.server_address[:2]
            service.accepting = True
            if service.heartbeat is not None:
                service.heartbeat.beat("serve/accepting")
            print(f"serving {engine.n_members} members on "
                  f"http://{host}:{port} (threaded, config "
                  f"{engine.config_hash[:12]}, {engine.device}, "
                  f"{engine.exec_cfg.compute_dtype})", flush=True)
            try:
                httpd.serve_forever()
            finally:
                httpd.server_close()
        else:
            from .aserver import run_async_server

            run_async_server(service, args.host, args.port,
                             reuse_port=args.reuse_port,
                             admin_port=args.admin_port)
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
        events.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
