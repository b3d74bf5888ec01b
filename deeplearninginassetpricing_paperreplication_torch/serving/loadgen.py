"""Load generator for the serving stack: open/closed-loop, loopback-first
(the port's copy of the JAX package's ``serving/loadgen.py``).

Closed loop: ``concurrency`` workers issue back-to-back requests over
KEEP-ALIVE connections — measures the service's sustainable throughput and
the latency AT that throughput. Open loop: requests are launched on a
fixed-rate schedule regardless of completions (the arrival process real
traffic has), drained by a worker pool — latency then includes queueing
delay, and a rate above capacity shows up as a growing p99 (and eventually
503s) rather than a politely slowed client. :func:`run_ladder` sweeps a
rate ladder with per-step warmup/measure windows. Every run reports
p50/p95/p99/mean/max latency, sustained throughput, and an ALWAYS-present
error accounting (non-2xx by status, timeouts, connection failures) plus
retry counts — with ``retries > 0`` a dropped connection (e.g. a replica
killed mid-flight) is retried on a fresh connection, which a
``SO_REUSEPORT`` fleet routes to a surviving replica.

The bench functions (``bench_serving``: the deprecated threaded server;
``bench_serving_async``: the production path, a supervised replica fleet
on one shared port, closed-loop at c=32 and up a rate ladder over every
wire; ``bench_rolling_reload``, ``bench_loadadapt``, ``bench_slo``,
``bench_tracing_overhead``, ``bench_meshserve``) return the JAX package's result dicts, key for
key, but for "steady-state recompiles", which on the port are CUDA-graph
captures after warmup (``steady_state_captures``). They write no file.
The replicas run on the CUDA device unless the caller passes
``device="cpu"``; they build the members from the port's seeded
``torch.Generator`` and save them through the verified checkpoint IO.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import threading
import time
import urllib.parse
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from ..observability.tracecontext import (
    new_span_id,
    new_trace_id,
    trace_sampled,
)

Payload = Union[Dict[str, Any], bytes, Callable[[int], Any]]

# bounded per-run trace-id evidence lists: enough to cross-check every
# retry/error of a fault-matrix run without letting a pathological run
# grow the result dict unboundedly
MAX_TRACE_IDS = 512


def _post_json(url: str, payload: Dict[str, Any],
               timeout: float = 30.0) -> Dict[str, Any]:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class KeepAliveClient:
    """One persistent raw-socket HTTP/1.1 connection to a POST endpoint.

    Raw sockets instead of ``http.client``: at hundreds of rps the
    stdlib's per-request header formatting and response object machinery
    costs ~3 CPU-ms — 3× the entire serving path — so the loadgen would
    measure itself. Here a request is one prebuilt header + ``sendall``
    and a response parse is two reads. ``post`` returns (status, body
    bytes); any transport failure closes the connection so the next call
    reconnects — against an SO_REUSEPORT fleet that lands on a (possibly
    different) live replica.
    """

    def __init__(self, url: str, timeout_s: float = 30.0,
                 content_type: str = "application/json"):
        u = urllib.parse.urlsplit(url)
        self.host, self.port = u.hostname, u.port or 80
        self.path = u.path or "/"
        self.timeout_s = timeout_s
        self._header = (
            f"POST {self.path} HTTP/1.1\r\nHost: {self.host}\r\n"
            f"Content-Type: {content_type}\r\nContent-Length: "
        ).encode()
        self._sock: Optional[socket.socket] = None
        self._rfile = None

    def post(self, body: bytes, extra_headers: bytes = b""):
        """``extra_headers``: pre-encoded ``Name: value\\r\\n`` lines
        appended after Content-Length (the loadgen's per-request
        ``traceparent`` rides here without re-building the base header)."""
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s)
            self._sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._rfile = self._sock.makefile("rb")
        try:
            self._sock.sendall(
                self._header + str(len(body)).encode() + b"\r\n"
                + extra_headers + b"\r\n" + body)
            line = self._rfile.readline()
            if not line:
                raise ConnectionError("server closed the connection")
            status = int(line.split()[1])
            length = 0
            server_closes = line.startswith(b"HTTP/1.0")
            while True:
                h = self._rfile.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                hl = h.lower()
                if hl.startswith(b"content-length:"):
                    length = int(h.split(b":", 1)[1])
                elif hl.startswith(b"connection:") and b"close" in hl:
                    server_closes = True
            data = self._rfile.read(length) if length else b""
            if server_closes:
                # one-response connection (e.g. an HTTP/1.0 server):
                # reconnect on the next post instead of writing into a
                # socket the peer is closing
                self.close()
            return status, data
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._rfile.close()
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._rfile = None


def _percentiles(latencies_s: List[float]) -> Optional[Dict[str, float]]:
    # the shared nearest-rank summary (observability.report) so loadgen,
    # /metrics, and the report CLI agree numerically; mean/max ride along
    from ..observability.report import latency_percentiles_ms

    out = latency_percentiles_ms(latencies_s)
    if out is not None:
        out["mean_ms"] = round(sum(latencies_s) / len(latencies_s) * 1e3, 3)
        out["max_ms"] = round(max(latencies_s) * 1e3, 3)
    return out


def _encode_payload(p) -> bytes:
    return p if isinstance(p, (bytes, bytearray)) else json.dumps(p).encode()


def run_loadgen(
    url: str,
    payload: Payload,
    mode: str = "closed",
    concurrency: int = 4,
    n_requests: int = 200,
    rate_rps: Optional[float] = None,
    warmup_requests: int = 4,
    timeout_s: float = 30.0,
    retries: int = 0,
    retry_backoff_s: float = 0.05,
    open_workers: int = 32,
    content_type: str = "application/json",
    reconnect_every: int = 0,
    trace: bool = True,
    events: Any = None,
    rates_schedule: Optional[List[Any]] = None,
    class_of: Optional[Callable[[int], str]] = None,
    extra_headers_of: Optional[Callable[[int], bytes]] = None,
) -> Dict[str, Any]:
    """Drive `url` (a POST endpoint) and report the latency distribution.

    `payload` is one dict (or pre-encoded ``bytes``) reused for every
    request, or a callable ``i -> dict | bytes`` for varied traffic. Closed
    loop: `concurrency` workers × back-to-back requests, each worker on one
    keep-alive connection. Open loop (`mode="open"`): requests are due at
    ``i / rate_rps``; an ``open_workers``-thread pool issues each at its
    due time (late issues are counted, not silently absorbed).

    ``retries``: transport failures (dropped connection — e.g. a replica
    dying mid-request) and 503s are retried up to this many times, on a
    fresh connection, with ``retry_backoff_s`` between attempts; the
    request's latency then spans all attempts. Errors are ALWAYS reported
    as a (possibly empty) dict: non-2xx counts by status, timeouts and
    connection failures by exception name.

    ``reconnect_every``: close each worker's connection every N requests.
    Against an SO_REUSEPORT fleet a long-lived connection is pinned to one
    replica for its whole life; periodic reconnects re-randomize the
    assignment so a skewed initial spread cannot dominate the tail.

    ``trace``: send a W3C ``traceparent`` header per request, generated at
    THIS edge and REUSED across retries — a request killed on one replica
    and retried on another is one trace in the merged ``report --trace``.
    The sampled flag follows ``DLAP_TRACE_SAMPLE`` deterministically, so
    client and servers agree per trace id. Retried and failed requests'
    trace ids are returned (``retried_trace_ids`` / ``error_trace_ids``,
    bounded) so the report's retry section can be cross-checked against
    the trace. ``events``: an ``observability.EventLog`` — when given,
    every finished request emits one ``client/request`` row (trace id,
    attempts, status, latency), the client half of the merged flow trace.

    ``rates_schedule``: a list of ``(rate_rps, duration_s)`` steps —
    open-loop arrival times swing THROUGH the schedule mid-run on the
    SAME worker pool and keep-alive connections (no reconnect between
    steps; ``mode="open"`` implied, ``n_requests``/``rate_rps`` derived).
    The result then carries a per-step breakdown (``steps``).
    ``class_of``: maps a request index to its priority class
    (``interactive``/``bulk``) — the class rides the request as an
    ``x-dlap-priority`` header AND the result gains per-class latency /
    error / shed accounting (``by_class``). ``extra_headers_of``: raw
    pre-encoded ``Name: value\\r\\n`` lines per request index (e.g. a
    deadline header).
    """
    if rates_schedule:
        mode = "open"
        rate_rps = rate_rps or rates_schedule[0][0]
    if mode not in ("closed", "open"):
        raise ValueError(f"mode must be closed|open: {mode!r}")
    if mode == "open" and not rate_rps:
        raise ValueError("open-loop mode requires rate_rps")
    make = payload if callable(payload) else (lambda i: payload)
    endpoint = urllib.parse.urlsplit(url).path or "/"

    # schedule → per-index due offsets + step ids; one worker pool rides
    # the whole swing (the rate changes, the connections do not)
    due_offsets: Optional[List[float]] = None
    step_of: Optional[List[int]] = None
    step_meta: List[Dict[str, Any]] = []
    if rates_schedule:
        due_offsets, step_of = [], []
        t_off = 0.0
        for s, (rate, duration) in enumerate(rates_schedule):
            rate = float(rate)
            if rate <= 0 or duration <= 0:
                raise ValueError(
                    f"rates_schedule step {s} needs rate > 0 and "
                    f"duration > 0: ({rate}, {duration})")
            n_step = max(1, int(rate * duration))
            for k in range(n_step):
                due_offsets.append(t_off + k / rate)
                step_of.append(s)
            step_meta.append({"offered_rate_rps": rate,
                              "duration_s": duration,
                              "n_requests": n_step})
            t_off += duration
        n_requests = len(due_offsets)

    # compile warmth, untimed; indices beyond the measured range so a
    # result cache in front of the server cannot pre-absorb measured traffic
    warm_client = KeepAliveClient(url, timeout_s=timeout_s)
    for i in range(warmup_requests):
        try:
            warm_client.post(_encode_payload(make(n_requests + i)))
        except Exception:
            pass
    warm_client.close()

    lock = threading.Lock()
    latencies: List[float] = []
    errors: Dict[str, int] = {}
    error_trace_ids: Dict[str, List[str]] = {}
    retried_trace_ids: List[str] = []
    stats = {"retried": 0, "late": 0, "max_lag_s": 0.0}
    # per-priority-class and per-schedule-step accounting sinks
    class_acc: Dict[str, Dict[str, Any]] = {}
    step_acc: List[Dict[str, Any]] = [
        {"lat": [], "errors": {}} for _ in step_meta]
    local = threading.local()

    def client() -> KeepAliveClient:
        c = getattr(local, "client", None)
        if c is None:
            c = local.client = KeepAliveClient(
                url, timeout_s=timeout_s, content_type=content_type)
        return c

    def _class_bucket(i: int) -> Optional[Dict[str, Any]]:
        if class_of is None:
            return None
        cls = class_of(i)
        return class_acc.setdefault(cls, {"lat": [], "errors": {},
                                          "n_requests": 0})

    def record_ok(i: int, dt: float) -> None:
        with lock:
            latencies.append(dt)
            cb = _class_bucket(i)
            if cb is not None:
                cb["lat"].append(dt)
            if step_of is not None:
                step_acc[step_of[i]]["lat"].append(dt)

    def record_error(key: str, trace_id: Optional[str],
                     i: Optional[int] = None) -> None:
        with lock:
            errors[key] = errors.get(key, 0) + 1
            if trace_id is not None:
                ids = error_trace_ids.setdefault(key, [])
                if len(ids) < MAX_TRACE_IDS:
                    ids.append(trace_id)
            if i is not None:
                cb = _class_bucket(i)
                if cb is not None:
                    cb["errors"][key] = cb["errors"].get(key, 0) + 1
                if step_of is not None:
                    se = step_acc[step_of[i]]["errors"]
                    se[key] = se.get(key, 0) + 1

    def emit_client_row(trace_id, sampled, status, dt, attempt) -> None:
        if events is None or not sampled:
            return
        events.emit("request", "client/request", trace_id=trace_id,
                    endpoint=endpoint, status=status,
                    duration_s=round(dt, 6), attempts=attempt + 1,
                    retried=attempt > 0)

    def one(i: int) -> None:
        body = _encode_payload(make(i))
        # ONE trace id for the request's whole life — every retry reuses
        # it (fresh span id per attempt), so the merged trace shows one
        # request spanning every replica that touched it
        trace_id = new_trace_id() if trace else None
        sampled = trace and trace_sampled(trace_id)
        base_hdr = b""
        if class_of is not None:
            cls = class_of(i)
            base_hdr += f"x-dlap-priority: {cls}\r\n".encode()
            with lock:
                _class_bucket(i)["n_requests"] += 1
        if extra_headers_of is not None:
            base_hdr += extra_headers_of(i)
        t0 = time.monotonic()
        attempt = 0
        while True:
            hdr = base_hdr
            if trace_id is not None:
                hdr = hdr + (
                    f"traceparent: 00-{trace_id}-{new_span_id()}-"
                    f"{'01' if sampled else '00'}\r\n").encode()
            try:
                status, _ = client().post(body, extra_headers=hdr)
            except socket.timeout:
                record_error("timeout", trace_id, i)
                emit_client_row(trace_id, sampled, "timeout",
                                time.monotonic() - t0, attempt)
                return
            except (OSError, ValueError, IndexError) as e:
                # OSError: transport death. ValueError/IndexError: a
                # garbled status line from a dying peer — same remedy
                # (KeepAliveClient closed itself; retry reconnects), and
                # the worker must survive either way or the run silently
                # loses concurrency
                if attempt < retries:
                    attempt += 1
                    with lock:
                        stats["retried"] += 1
                        if (trace_id is not None
                                and len(retried_trace_ids) < MAX_TRACE_IDS):
                            retried_trace_ids.append(trace_id)
                    time.sleep(retry_backoff_s)
                    continue
                record_error(type(e).__name__, trace_id, i)
                emit_client_row(trace_id, sampled, type(e).__name__,
                                time.monotonic() - t0, attempt)
                return
            if 200 <= status < 300:
                dt = time.monotonic() - t0
                record_ok(i, dt)
                emit_client_row(trace_id, sampled, status, dt, attempt)
                return
            if status == 503 and attempt < retries:
                attempt += 1
                with lock:
                    stats["retried"] += 1
                    if (trace_id is not None
                            and len(retried_trace_ids) < MAX_TRACE_IDS):
                        retried_trace_ids.append(trace_id)
                time.sleep(retry_backoff_s)
                continue
            # 429 (shed) is NOT retried even with retries set: the server
            # deliberately chose to drop it and said when to come back —
            # it lands in the error accounting as its own status
            record_error(str(status), trace_id, i)
            emit_client_row(trace_id, sampled, status,
                            time.monotonic() - t0, attempt)
            return

    t_start = time.monotonic()
    counter = {"next": 0}

    def next_index() -> Optional[int]:
        with lock:
            i = counter["next"]
            if i >= n_requests:
                return None
            counter["next"] = i + 1
            return i

    def maybe_reconnect(done: int) -> None:
        if reconnect_every and done % reconnect_every == 0:
            client().close()

    if mode == "closed":
        def worker():
            done = 0
            while True:
                i = next_index()
                if i is None:
                    return
                one(i)
                done += 1
                maybe_reconnect(done)

        n_workers = concurrency
    else:
        period = 1.0 / rate_rps

        def worker():
            done = 0
            while True:
                i = next_index()
                if i is None:
                    return
                target = t_start + (due_offsets[i]
                                    if due_offsets is not None
                                    else i * period)
                lag = time.monotonic() - target
                if lag < 0:
                    time.sleep(-lag)
                elif lag > 0.001:
                    # all workers busy past this slot's due time: the
                    # client is saturated — visible, not absorbed
                    with lock:
                        stats["late"] += 1
                        stats["max_lag_s"] = max(stats["max_lag_s"], lag)
                one(i)
                done += 1
                maybe_reconnect(done)

        n_workers = open_workers
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.monotonic() - t_start

    n_ok = len(latencies)
    out = {
        "mode": mode,
        "url": url,
        "concurrency": concurrency if mode == "closed" else None,
        "rate_rps": rate_rps if mode == "open" else None,
        "n_requests": n_requests,
        "n_ok": n_ok,
        "errors": errors,
        "error_trace_ids": error_trace_ids,
        "retried_trace_ids": retried_trace_ids,
        "n_retried": stats["retried"],
        "wall_s": round(wall_s, 3),
        "throughput_rps": round(n_ok / wall_s, 2) if wall_s > 0 else None,
        "latency": _percentiles(latencies),
    }
    if mode == "open":
        out["late_sends"] = stats["late"]
        out["max_send_lag_ms"] = round(stats["max_lag_s"] * 1e3, 3)
    if class_of is not None:
        out["by_class"] = {
            cls: {
                "n_requests": acc["n_requests"],
                "n_ok": len(acc["lat"]),
                "dropped": acc["n_requests"] - len(acc["lat"]),
                "n_shed_429": acc["errors"].get("429", 0),
                "errors": dict(sorted(acc["errors"].items())),
                "latency": _percentiles(acc["lat"]),
            }
            for cls, acc in sorted(class_acc.items())
        }
    if rates_schedule:
        out["rates_schedule"] = [[r, d] for r, d in rates_schedule]
        out["steps"] = [
            dict(meta,
                 n_ok=len(acc["lat"]),
                 errors=dict(sorted(acc["errors"].items())),
                 latency=_percentiles(acc["lat"]))
            for meta, acc in zip(step_meta, step_acc)
        ]
    return out


def run_ladder(
    url: str,
    payload: Payload,
    rates: List[float],
    warmup_s: float = 1.0,
    measure_s: float = 4.0,
    timeout_s: float = 30.0,
    retries: int = 0,
    open_workers: int = 32,
    stop_error_rate: float = 0.5,
    content_type: str = "application/json",
    trace: bool = True,
    events: Any = None,
    durations: Optional[List[float]] = None,
    class_of: Optional[Callable[[int], str]] = None,
    extra_headers_of: Optional[Callable[[int], bytes]] = None,
) -> Dict[str, Any]:
    """Open-loop rate ladder: for each rate, an UNTIMED warmup window then
    a measured window, both issuing at that fixed rate. The ladder stops
    early once a step's error rate exceeds ``stop_error_rate`` (the service
    is past saturation; higher rates would only time out the client).
    Returns the per-step results plus ``max_clean_rate_rps`` — the highest
    offered rate served with zero errors. ``events`` (client-side
    ``client/request`` rows) covers the MEASURED windows only.

    ``durations``: SWING mode — one ``(rates[s], durations[s])`` schedule
    driven as a single continuous run on one persistent worker pool (no
    reconnect, no warmup windows between steps: the offered rate swings
    mid-run, which is exactly what the autoscaler must track). Per-step
    results come from the schedule accounting; ``max_clean_rate_rps`` is
    the highest rate whose step finished error-free. ``class_of``/
    ``extra_headers_of`` ride through to :func:`run_loadgen` (per-
    priority-class accounting + admission headers), in both modes."""
    if durations is not None:
        if len(durations) != len(rates):
            raise ValueError(
                f"durations ({len(durations)}) must match rates "
                f"({len(rates)})")
        run = run_loadgen(
            url, payload, rates_schedule=list(zip(rates, durations)),
            warmup_requests=0, timeout_s=timeout_s, retries=retries,
            open_workers=open_workers, content_type=content_type,
            trace=trace, events=events, class_of=class_of,
            extra_headers_of=extra_headers_of)
        max_clean = None
        for step in run["steps"]:
            if not step["errors"]:
                max_clean = max(max_clean or 0.0,
                                step["offered_rate_rps"])
        return {"steps": run["steps"], "swing": True, "run": run,
                "max_clean_rate_rps": max_clean}
    steps: List[Dict[str, Any]] = []
    max_clean = None
    for rate in rates:
        n_warm = max(1, int(rate * warmup_s))
        run_loadgen(url, payload, mode="open", rate_rps=rate,
                    n_requests=n_warm, warmup_requests=0,
                    timeout_s=timeout_s, retries=retries,
                    open_workers=open_workers, content_type=content_type,
                    trace=trace, extra_headers_of=extra_headers_of)
        n_meas = max(1, int(rate * measure_s))
        step = run_loadgen(url, payload, mode="open", rate_rps=rate,
                           n_requests=n_meas, warmup_requests=0,
                           timeout_s=timeout_s, retries=retries,
                           open_workers=open_workers,
                           content_type=content_type,
                           trace=trace, events=events, class_of=class_of,
                           extra_headers_of=extra_headers_of)
        step["offered_rate_rps"] = rate
        steps.append(step)
        n_err = step["n_requests"] - step["n_ok"]
        if not n_err:
            max_clean = rate
        if step["n_requests"] and n_err / step["n_requests"] > stop_error_rate:
            step["ladder_stopped"] = (
                f"error rate {n_err}/{step['n_requests']} exceeds "
                f"{stop_error_rate:.0%}; not driving higher rates")
            break
    return {"steps": steps, "max_clean_rate_rps": max_clean,
            "warmup_s": warmup_s, "measure_s": measure_s}


# -- the bench functions ------------------------------------------------------


def _make_member_dirs(root, cfg, seeds):
    """Random-init member checkpoints: the port's ``GAN`` parameters drawn
    from a seeded ``torch.Generator`` per member, saved through the
    verified checkpoint IO (``.pt`` + ``.sha256`` sidecar). Serving
    latency/throughput depend on shapes, not trained values, so a bench
    needs no training run."""
    import torch

    from ..models.gan import GAN
    from ..models.networks import init_params
    from ..training.checkpoint import save_state_dict

    dirs = []
    for s in seeds:
        d = root / f"seed_{s}"
        d.mkdir(parents=True, exist_ok=True)
        cfg.save(d / "config.json")
        gan = GAN(cfg)
        init_params(gan.module, torch.Generator().manual_seed(int(s)))
        save_state_dict(d / "best_model_sharpe.pt", gan.module.state_dict())
        dirs.append(str(d))
    return dirs


def _server_args(run_dir, device: str, compute_dtype: str, *argv: str):
    """The parsed ``serving.server`` arguments a bench fleet's replicas are
    built from (``fleet.server_child_argv``): ``argv`` plus the run dir and
    the execution flags every replica inherits."""
    from .server import build_arg_parser

    return build_arg_parser().parse_args([
        *argv, "--run_dir", str(run_dir), "--device", device,
        "--compute_dtype", compute_dtype])


def _warmup_captures(device: str, n_buckets: int) -> int:
    """CUDA graphs one replica incarnation captures in its warmup: one per
    (stock bucket, batch bucket) on a CUDA device, none on the CPU."""
    return n_buckets if device == "cuda" else 0


def bench_serving(
    n_stocks: int = 500,
    n_features: int = 46,
    n_macro: int = 8,
    n_members: int = 4,
    months: int = 60,
    n_requests: int = 200,
    seed: int = 42,
    device: str = "cuda",
    compute_dtype: str = "float32",
) -> Dict[str, Any]:
    """End-to-end loopback serving benchmark: random-init K-member ensemble,
    graph-warmed engine, HTTP loopback (the deprecated threaded server),
    closed loop at c=1/c=4 plus an open loop near the measured capacity.
    Returns one JSON-able dict."""
    import tempfile
    from pathlib import Path

    from ..utils.config import ExecutionConfig, GANConfig
    from .engine import InferenceEngine, bucket_for
    from .server import ServingService, make_server

    rng = np.random.default_rng(seed)
    cfg = GANConfig(macro_feature_dim=n_macro,
                    individual_feature_dim=n_features)
    macro = rng.standard_normal((months, n_macro)).astype(np.float32)

    with tempfile.TemporaryDirectory(prefix="dlap_serving_bench_") as td:
        td = Path(td)
        dirs = _make_member_dirs(td / "ckpts", cfg, range(1, n_members + 1))
        t0 = time.monotonic()
        stock_bucket = bucket_for(n_stocks, [64 * 2**i for i in range(9)])
        engine = InferenceEngine(
            dirs, macro_history=macro, stock_buckets=(stock_bucket,),
            exec_cfg=ExecutionConfig(device=device,
                                     compute_dtype=compute_dtype))
        load_s = time.monotonic() - t0
        service = ServingService(engine, run_dir=str(td / "serve_run"))
        t0 = time.monotonic()
        service.warmup()
        warmup_s = time.monotonic() - t0
        httpd = make_server(service)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        host, port = httpd.server_address[:2]
        url = f"http://{host}:{port}/v1/weights"

        def make_payload(offset: int) -> Callable[[int], Dict[str, Any]]:
            # every request of every loop is a distinct payload — the LRU
            # cache must not absorb any of the measured traffic
            def payload(i: int) -> Dict[str, Any]:
                r = np.random.default_rng(seed + 1 + offset + i)
                return {
                    "individual": r.standard_normal(
                        (n_stocks, n_features)).astype(np.float32).tolist(),
                    "month": int(i % months),
                }

            return payload

        try:
            closed_1 = run_loadgen(url, make_payload(0), mode="closed",
                                   concurrency=1, n_requests=n_requests)
            closed_4 = run_loadgen(url, make_payload(10**6), mode="closed",
                                   concurrency=4, n_requests=n_requests)
            cap = closed_4["throughput_rps"] or 1.0
            open_loop = run_loadgen(
                url, make_payload(2 * 10**6), mode="open",
                rate_rps=max(1.0, 0.8 * cap),
                n_requests=min(n_requests, int(cap * 5) or n_requests))
            stats = engine.stats()
            metrics = service.metrics()
        finally:
            httpd.shutdown()
            service.close()

    return {
        "shape": f"N={n_stocks} F={n_features} M={n_macro} "
                 f"K={n_members} months={months}",
        "stock_bucket": stock_bucket,
        "engine_load_s": round(load_s, 3),
        "warmup_capture_s": round(warmup_s, 3),
        "closed_loop_c1": closed_1,
        "closed_loop_c4": closed_4,
        "open_loop_0.8cap": open_loop,
        "captures": stats["captures"],
        "steady_state_captures": stats["steady_state_captures"],
        "dispatches": stats["dispatches"],
        "batcher_flushes": metrics["batcher"]["flushes"],
        "note": "HTTP loopback, random-init members (latency depends on "
                "shapes, not trained values); captures must not grow "
                "after warmup — steady state captures no CUDA graph",
    }


# -- the replicated async benchmark -------------------------------------------


def compact_payload_bytes(individual: np.ndarray, month: int,
                          b64_response: bool = True) -> bytes:
    """One pre-encoded compact-wire request body: base64 float32
    characteristics (+ ``encoding: b64`` for a compact response)."""
    import base64

    a = np.ascontiguousarray(individual, np.float32)
    d: Dict[str, Any] = {
        "individual_b64": base64.b64encode(a.tobytes()).decode(),
        "month": int(month),
    }
    if b64_response:
        d["encoding"] = "b64"
    return json.dumps(d).encode()


def binary_payload_bytes(individual: np.ndarray, month: int) -> bytes:
    """One raw-f32-wire request body (``server.BINARY_CONTENT_TYPE``):
    [i32 month][u32 n][n*F f32 row-major characteristics]."""
    import struct

    a = np.ascontiguousarray(individual, np.float32)
    return struct.pack("<iI", int(month), a.shape[0]) + a.tobytes()




def bench_serving_async(
    n_stocks: int = 500,
    n_features: int = 46,
    n_macro: int = 8,
    n_members: int = 4,
    months: int = 60,
    replicas: int = 2,
    n_requests: int = 320,
    ladder_rates=(100.0, 200.0, 300.0, 400.0, 500.0),
    seed: int = 42,
    device: str = "cuda",
    compute_dtype: str = "float32",
) -> Dict[str, Any]:
    """The production-path benchmark: a supervised R-replica fleet on one
    SO_REUSEPORT port (each replica its own process: engine, continuous
    batcher, cache shard), driven closed-loop at c=32 and c=4 plus an
    open-loop rate ladder, over both wire formats. Result caching is
    DISABLED (--cache_size 0): every measured request reaches an engine.
    Captures after warmup are read per replica and must be zero."""
    import tempfile
    from pathlib import Path

    from ..utils.config import GANConfig
    from .aserver import pick_free_port
    from .engine import bucket_for
    from .fleet import ReplicaFleet, server_child_argv
    from .server import BINARY_CONTENT_TYPE

    rng = np.random.default_rng(seed)
    cfg = GANConfig(macro_feature_dim=n_macro,
                    individual_feature_dim=n_features)
    # cap flushes at 8: two 8-deep flushes give a 16-deep flush's
    # throughput with half its head-of-line block
    batch_buckets = (1, 2, 4, 8)
    with tempfile.TemporaryDirectory(prefix="dlap_serving_async_") as td:
        td = Path(td)
        dirs = _make_member_dirs(td / "ckpts", cfg, range(1, n_members + 1))
        macro = rng.standard_normal((months, n_macro)).astype(np.float32)
        np.save(td / "macro.npy", macro)
        stock_bucket = bucket_for(n_stocks, [64 * 2**i for i in range(9)])
        run_dir = td / "fleet_run"
        args = _server_args(
            run_dir, device, compute_dtype,
            "--checkpoint_dirs", *dirs,
            "--macro_npy", str(td / "macro.npy"),
            "--stock_buckets", str(stock_bucket),
            "--batch_buckets", ",".join(str(b) for b in batch_buckets),
            "--max_queue", "512",
            "--cache_size", "0")
        port = pick_free_port()
        argvs = [server_child_argv(args, i, run_dir / f"replica{i}", port)
                 for i in range(replicas)]
        fleet = ReplicaFleet(argvs, run_dir)
        url = f"http://127.0.0.1:{port}/v1/weights"

        # pre-encoded request bodies (more than any replica could cache —
        # and caching is off anyway): the client's per-payload json.dumps
        # must not be measured as server latency
        n_payloads = 64

        def bodies(wire: str) -> List[bytes]:
            out = []
            for i in range(n_payloads):
                r = np.random.default_rng(seed + 1 + i)
                a = r.standard_normal(
                    (n_stocks, n_features)).astype(np.float32)
                if wire == "binary":
                    out.append(binary_payload_bytes(a, i % months))
                elif wire == "b64":
                    out.append(compact_payload_bytes(a, i % months))
                else:
                    out.append(json.dumps(
                        {"individual": a.tolist(),
                         "month": int(i % months)}).encode())
            return out

        bin_bodies = bodies("binary")
        b64_bodies = bodies("b64")
        json_bodies = bodies("json")

        def make(pool):
            return lambda i: pool[i % len(pool)]

        def best_of(n_trials, **kwargs):
            # a shared host's CPU quota throttles in bursts; best-of-N
            # isolates the serving stack from the neighbors, and every
            # trial's numbers stay in `trials`
            runs = [run_loadgen(url, **kwargs) for _ in range(n_trials)]
            best = max(runs, key=lambda r: r["throughput_rps"] or 0)
            best = dict(best)
            best["trials"] = [
                {"throughput_rps": r["throughput_rps"],
                 "p99_ms": (r["latency"] or {}).get("p99_ms")}
                for r in runs]
            return best

        try:
            # start INSIDE the try: a replica that crash-loops during
            # startup must not leak live children past the bench
            t0 = time.monotonic()
            fleet.start()
            fleet.wait_ready(timeout=600.0)
            startup_s = time.monotonic() - t0
            # warm every batch-bucket shape's first execution before the
            # measured windows
            run_loadgen(url, make(bin_bodies), mode="closed",
                        concurrency=32, n_requests=4 * n_payloads,
                        warmup_requests=4,
                        content_type=BINARY_CONTENT_TYPE)
            closed_32_bin = best_of(
                3, payload=make(bin_bodies), mode="closed", concurrency=32,
                n_requests=n_requests, warmup_requests=0, retries=2,
                content_type=BINARY_CONTENT_TYPE)
            closed_16_bin = best_of(
                3, payload=make(bin_bodies), mode="closed", concurrency=16,
                n_requests=n_requests, warmup_requests=0, retries=2,
                content_type=BINARY_CONTENT_TYPE)
            closed_32_b64 = run_loadgen(
                url, make(b64_bodies), mode="closed", concurrency=32,
                n_requests=n_requests, warmup_requests=4, retries=2)
            closed_32_json = run_loadgen(
                url, make(json_bodies), mode="closed", concurrency=32,
                n_requests=max(64, n_requests // 2), warmup_requests=4,
                retries=2)
            closed_4_json = run_loadgen(
                url, make(json_bodies), mode="closed", concurrency=4,
                n_requests=max(64, n_requests // 2), warmup_requests=4,
                retries=2)
            ladder = run_ladder(
                url, make(bin_bodies), rates=list(ladder_rates),
                warmup_s=1.0, measure_s=3.0, retries=2,
                content_type=BINARY_CONTENT_TYPE)

            # per-replica engine metrics: each fresh connection lands on
            # some live replica; poll until every id has answered
            per_replica: Dict[str, Any] = {}
            for _ in range(40 * replicas):
                if len(per_replica) >= replicas:
                    break
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/metrics",
                            timeout=10) as r:
                        m = json.loads(r.read())
                    per_replica.setdefault(str(m.get("replica")), m)
                except OSError:
                    time.sleep(0.1)
        finally:
            summaries = fleet.stop()

    # each replica's own count of captures past its warmup marker
    steady_state_captures = {
        r: m["engine"]["steady_state_captures"]
        for r, m in sorted(per_replica.items())
    }
    return {
        "shape": f"N={n_stocks} F={n_features} M={n_macro} "
                 f"K={n_members} months={months}",
        "replicas": replicas,
        "stock_bucket": stock_bucket,
        "batch_buckets": list(batch_buckets),
        "fleet_startup_s": round(startup_s, 3),
        "closed_loop_c32_bin": closed_32_bin,
        "closed_loop_c16_bin": closed_16_bin,
        "closed_loop_c32_b64": closed_32_b64,
        "closed_loop_c32_json": closed_32_json,
        "closed_loop_c4_json": closed_4_json,
        "open_loop_ladder_bin": ladder,
        "steady_state_captures": steady_state_captures,
        "dispatches": {r: m["engine"]["dispatches"]
                       for r, m in sorted(per_replica.items())},
        "batcher": {r: m["batcher"] for r, m in sorted(per_replica.items())},
        "replica_restarts": [
            (s or {}).get("restarts", 0) for s in summaries],
        "note": "supervised SO_REUSEPORT replica fleet, HTTP loopback "
                "keep-alive, result cache DISABLED (every request reaches "
                "an engine), random-init members; *_bin = raw-f32 wire "
                "(application/x-dlap-f32), *_b64 = base64 float32 JSON "
                "envelope, *_json = plain JSON lists; "
                "steady_state_captures must be all zero",
    }


# -- the rolling-reload benchmark ---------------------------------------------


def bench_rolling_reload(
    n_stocks: int = 500,
    n_features: int = 46,
    n_macro: int = 8,
    n_members: int = 2,
    months: int = 60,
    replicas: int = 2,
    rate_rps: float = 40.0,
    load_seconds: float = 12.0,
    seed: int = 42,
    device: str = "cuda",
    compute_dtype: str = "float32",
) -> Dict[str, Any]:
    """The promotion control plane's acceptance benchmark: a supervised
    R-replica fleet boots from the promotion pointer, an OPEN-loop load
    runs the whole time, and mid-load a new candidate is promoted and
    rolled across the fleet one replica at a time
    (``fleet.RollingUpdater``: per-replica admin endpoints, post-reload
    health window). The bars:

      * ``dropped_requests == 0`` — the hot-swap dropped no traffic;
      * per-replica ``steady_state_captures == 0`` — a reload copies the
        params into the tensors the CUDA graphs read and NEVER captures;
      * both replicas converged on the promoted fingerprint.
    """
    import tempfile
    from pathlib import Path

    from ..reliability.promotion import promote
    from ..utils.config import ExecutionConfig, GANConfig
    from .aserver import pick_free_port
    from .engine import bucket_for
    from .fleet import ReplicaFleet, RollingUpdater, server_child_argv
    from .server import BINARY_CONTENT_TYPE

    rng = np.random.default_rng(seed)
    cfg = GANConfig(macro_feature_dim=n_macro,
                    individual_feature_dim=n_features)
    with tempfile.TemporaryDirectory(prefix="dlap_rolling_reload_") as td:
        td = Path(td)
        v1 = _make_member_dirs(td / "v1", cfg, range(1, n_members + 1))
        v2 = _make_member_dirs(td / "v2", cfg,
                               range(101, 101 + n_members))
        macro = rng.standard_normal((months, n_macro)).astype(np.float32)
        np.save(td / "macro.npy", macro)
        ctl = td / "ctl"
        # the gate stacks the candidates on the replicas' device
        gate_cfg = ExecutionConfig(device=device,
                                   compute_dtype=compute_dtype)
        incumbent = promote(ctl, v1, source="bench_v1", exec_cfg=gate_cfg)

        stock_bucket = bucket_for(n_stocks, [64 * 2**i for i in range(9)])
        run_dir = td / "fleet_run"
        args = _server_args(
            run_dir, device, compute_dtype,
            "--pointer", str(ctl),
            "--macro_npy", str(td / "macro.npy"),
            "--stock_buckets", str(stock_bucket),
            "--batch_buckets", "1,2,4,8",
            "--max_queue", "512",
            "--cache_size", "0")
        port = pick_free_port()
        admin_ports = []
        for _ in range(replicas):
            ap = pick_free_port()
            while ap in admin_ports or ap == port:
                ap = pick_free_port()
            admin_ports.append(ap)
        argvs = [server_child_argv(args, i, run_dir / f"replica{i}", port,
                                   admin_port=admin_ports[i])
                 for i in range(replicas)]
        admin_urls = [f"http://127.0.0.1:{ap}" for ap in admin_ports]
        fleet = ReplicaFleet(argvs, run_dir)
        url = f"http://127.0.0.1:{port}/v1/weights"
        bodies = []
        for i in range(64):
            r = np.random.default_rng(seed + 1 + i)
            bodies.append(binary_payload_bytes(
                r.standard_normal(
                    (n_stocks, n_features)).astype(np.float32),
                i % months))

        n_requests = int(rate_rps * load_seconds)
        load_out: Dict[str, Any] = {}

        def _drive():
            load_out.update(run_loadgen(
                url, lambda i: bodies[i % len(bodies)], mode="open",
                rate_rps=rate_rps, n_requests=n_requests,
                warmup_requests=0, retries=2, timeout_s=30.0,
                open_workers=8, content_type=BINARY_CONTENT_TYPE))

        try:
            t0 = time.monotonic()
            fleet.start()
            fleet.wait_ready(timeout=600.0)
            startup_s = time.monotonic() - t0
            # warm every batch-bucket shape before the measured window
            run_loadgen(url, lambda i: bodies[i % len(bodies)],
                        mode="closed", concurrency=16, n_requests=128,
                        warmup_requests=4,
                        content_type=BINARY_CONTENT_TYPE)
            loader = threading.Thread(target=_drive, name="bench-load")
            loader.start()
            time.sleep(min(2.0, load_seconds / 4))
            promoted = promote(ctl, v2, source="bench_v2",
                               exec_cfg=gate_cfg)
            t0 = time.monotonic()
            roll = RollingUpdater(admin_urls, ctl).roll()
            roll_s = time.monotonic() - t0
            loader.join()

            per_replica: Dict[str, Any] = {}
            for u in admin_urls:
                with urllib.request.urlopen(u + "/metrics", timeout=10) as r:
                    m = json.loads(r.read())
                per_replica[str(m.get("replica"))] = m
        finally:
            summaries = fleet.stop()

    target_fp = str(promoted["params_fingerprint"])[:16]
    return {
        "shape": f"N={n_stocks} F={n_features} M={n_macro} "
                 f"K={n_members} months={months}",
        "replicas": replicas,
        "rate_rps": rate_rps,
        "fleet_startup_s": round(startup_s, 3),
        "roll_s": round(roll_s, 3),
        "roll_status": roll["status"],
        "incumbent_generation": incumbent["generation"],
        "promoted_generation": promoted["generation"],
        "n_requests": load_out.get("n_requests"),
        "n_ok": load_out.get("n_ok"),
        "dropped_requests": (
            int(load_out["n_requests"]) - int(load_out["n_ok"])),
        "errors": load_out.get("errors"),
        "n_retried": load_out.get("n_retried"),
        "throughput_rps": load_out.get("throughput_rps"),
        "latency": load_out.get("latency"),
        "steady_state_captures": {
            r: m["engine"]["steady_state_captures"]
            for r, m in sorted(per_replica.items())},
        "serving_fingerprints": {
            r: m["engine"]["params_fingerprint"]
            for r, m in sorted(per_replica.items())},
        "converged": all(
            m["engine"]["params_fingerprint"] == target_fp
            for m in per_replica.values()),
        "generations": {
            r: m["engine"]["params_generation"]
            for r, m in sorted(per_replica.items())},
        "replica_restarts": [
            (s or {}).get("restarts", 0) for s in summaries],
        "note": "supervised SO_REUSEPORT fleet boots from the promotion "
                "pointer; open-loop raw-f32 load runs across promote → "
                "health-gated rolling reload (RollingUpdater over the "
                "per-replica admin endpoints); dropped_requests and every "
                "replica's steady_state_captures must be 0 and both "
                "replicas must converge on the promoted fingerprint",
    }


# -- the load-adaptive fleet benchmark ----------------------------------------


def bench_loadadapt(
    n_stocks: int = 1000,
    n_features: int = 46,
    n_macro: int = 8,
    n_members: int = 2,
    months: int = 60,
    max_replicas: int = 2,
    n_distinct: int = 48,
    bulk_every: int = 4,
    phase_s=(5.0, 14.0, 8.0),
    surge_factor: float = 1.3,
    settle_timeout_s: float = 60.0,
    seed: int = 42,
    device: str = "cuda",
    compute_dtype: str = "float32",
) -> Dict[str, Any]:
    """The load-adaptive fleet's acceptance benchmark: a supervised fleet
    boots at ONE replica with the autoscaler live, and the loadgen drives
    a 10× mid-run rate swing (base → 10×base → base, one worker pool, no
    reconnect) of mixed-priority traffic — every ``bulk_every``-th request
    is bulk, the rest interactive — drawn from ``n_distinct`` distinct
    payloads so concurrent twins exercise single-flight coalescing. The
    surge rate is calibrated to ``surge_factor ×`` the single replica's
    measured closed-loop capacity over DISTINCT payloads (coalescing
    cannot absorb it for free — the calibration must measure real
    dispatch capacity), so the surge genuinely exceeds what the boot
    fleet can serve. A dedicated duplicate-heavy closed-loop burst after
    the swing measures the pure coalescing lever. The bars:

      * ``dropped_interactive == 0`` — interactive traffic survives the
        surge (DAGOR-style shedding turns the overload onto bulk, client
        retries cover replica churn);
      * ``shed_bulk_429 >= 1`` — bulk was deliberately shed with 429s;
      * ``autoscale.scale_ups >= 1`` and ``scale_downs >= 1`` — the
        replica count demonstrably tracked the swing up AND back down;
      * ``coalesce_burst.dispatch_ratio`` ≪ 1 — concurrent identical
        queries collapsed onto shared dispatches (O(users) →
        O(distinct));
      * ``steady_state_captures_max == 0`` — per replica incarnation,
        measured from each replica's own events.
    """
    import tempfile
    from pathlib import Path

    from ..observability.events import EventLog
    from ..observability.trace import read_jsonl
    from ..utils.config import GANConfig
    from .aserver import pick_free_port
    from .autoscale import AutoscalePolicy, Autoscaler, FleetController
    from .engine import bucket_for
    from .fleet import ReplicaFleet, read_fleet_json, server_child_argv
    from .flight import FlightRecorder
    from .server import BINARY_CONTENT_TYPE

    rng = np.random.default_rng(seed)
    cfg = GANConfig(macro_feature_dim=n_macro,
                    individual_feature_dim=n_features)
    batch_buckets = (1, 2, 4, 8)
    with tempfile.TemporaryDirectory(prefix="dlap_loadadapt_") as td:
        td = Path(td)
        dirs = _make_member_dirs(td / "ckpts", cfg, range(1, n_members + 1))
        macro = rng.standard_normal((months, n_macro)).astype(np.float32)
        np.save(td / "macro.npy", macro)
        stock_bucket = bucket_for(n_stocks, [64 * 2**i for i in range(9)])
        run_dir = td / "fleet_run"
        args = _server_args(
            run_dir, device, compute_dtype,
            "--checkpoint_dirs", *dirs,
            "--macro_npy", str(td / "macro.npy"),
            "--stock_buckets", str(stock_bucket),
            "--batch_buckets", ",".join(str(b) for b in batch_buckets),
            "--max_queue", "32",           # small queue → visible shedding
            "--bulk_threshold", "0.5",
            "--cache_size", "0")           # coalescing, not the LRU, dedups
        # distinct calibration bodies: every request its own payload, so
        # the measured closed-loop rps is true DISPATCH capacity, not the
        # coalescer absorbing duplicates
        cal_bodies = []
        for i in range(512):
            r = np.random.default_rng(seed + 10_000 + i)
            cal_bodies.append(binary_payload_bytes(
                r.standard_normal(
                    (n_stocks, n_features)).astype(np.float32),
                i % months))
        host, port = "127.0.0.1", pick_free_port()
        admin0 = pick_free_port()
        while admin0 == port:
            admin0 = pick_free_port()

        def make_argv(replica_id: int, admin_port: int):
            return server_child_argv(
                args, replica_id, run_dir / f"replica{replica_id}", port,
                admin_port=admin_port)

        fleet = ReplicaFleet([make_argv(0, admin0)], run_dir)
        events = EventLog(run_dir, process_index=0,
                          filename="events.autoscaler.jsonl")
        flight = FlightRecorder(run_dir=run_dir, events=events)
        controller = FleetController(
            fleet, make_argv, host, port, admin_ports={0: admin0})
        policy = AutoscalePolicy(
            min_replicas=1, max_replicas=max_replicas,
            poll_s=0.25, up_queue_depth=6.0, up_shed_rate=0.02,
            down_queue_depth=1.0, up_hysteresis=2, down_hysteresis=12,
            cooldown_s=3.0, drain_timeout_s=8.0)
        autoscaler = Autoscaler(controller, policy, events=events,
                                flight=flight)
        url = f"http://{host}:{port}/v1/weights"
        bodies = []
        for i in range(n_distinct):
            r = np.random.default_rng(seed + 1 + i)
            bodies.append(binary_payload_bytes(
                r.standard_normal(
                    (n_stocks, n_features)).astype(np.float32),
                i % months))

        def payload(i: int) -> bytes:
            return bodies[i % len(bodies)]

        def class_of(i: int) -> str:
            return "bulk" if i % bulk_every == 0 else "interactive"

        try:
            t0 = time.monotonic()
            fleet.start()
            fleet.wait_ready(timeout=600.0)
            controller.publish_layout()
            startup_s = time.monotonic() - t0
            # warm every batch-bucket shape, then calibrate and swing (the
            # autoscaler starts after the calibration: its burst must not
            # trigger a scale-up)
            run_loadgen(url, lambda i: cal_bodies[i % len(cal_bodies)],
                        mode="closed", concurrency=16,
                        n_requests=96, warmup_requests=4,
                        content_type=BINARY_CONTENT_TYPE)
            sw = loadadapt_swing(
                url, payload, lambda i: cal_bodies[i % len(cal_bodies)],
                class_of, phase_s=phase_s, surge_factor=surge_factor,
                content_type=BINARY_CONTENT_TYPE,
                before_swing=autoscaler.start)
            capacity_rps = sw["capacity_rps"]
            surge_rate, base_rate = sw["surge_rate"], sw["base_rate"]
            swing = sw["swing"]
            # settle: the trailing quiet phase must bring the fleet back
            # down to min_replicas (scale-down drain included)
            deadline = time.monotonic() + settle_timeout_s
            while time.monotonic() < deadline:
                if len(fleet.live_ids()) <= policy.min_replicas \
                        and autoscaler.scale_downs >= 1:
                    break
                time.sleep(0.5)
            settle_live = list(fleet.live_ids())
            # the pure coalescing lever, measured in isolation: a closed-
            # loop burst of 16 concurrent clients over TWO distinct
            # payloads — O(users) requests must become O(distinct)
            # dispatches
            pre = [controller.metrics(rid) for rid in settle_live]
            burst = run_loadgen(
                url, lambda i: bodies[i % 2], mode="closed",
                concurrency=16, n_requests=480, warmup_requests=0,
                content_type=BINARY_CONTENT_TYPE)
            post = [controller.metrics(rid) for rid in settle_live]

            def _co(ms):
                h = sum((m or {}).get("coalesce", {}).get("hits", 0)
                        for m in ms)
                d = sum((m or {}).get("coalesce", {}).get("dispatches", 0)
                        for m in ms)
                return h, d

            (h0, d0), (h1, d1) = _co(pre), _co(post)
            burst_hits, burst_disp = h1 - h0, d1 - d0
            # live replicas' own view (steady-state gauge cross-check)
            live_metrics = {
                rid: controller.metrics(rid) for rid in settle_live}
        finally:
            autoscaler.stop()
            summaries = fleet.stop()
            events.close()

        # per-replica evidence from each incarnation's OWN events (drained
        # replicas included — their files outlive the processes)
        expected_warmup = _warmup_captures(device, len(batch_buckets))
        captures: Dict[str, int] = {}
        shed_by_reason: Dict[str, int] = {}
        coalesce_hits = coalesce_dispatches = 0
        for rdir in sorted(run_dir.glob("replica*")):
            if not rdir.is_dir():
                continue
            by_run: Dict[str, int] = {}
            for row in read_jsonl(rdir / "events.jsonl"):
                if row.get("kind") != "counter":
                    continue
                name = row.get("name")
                if name == "serve/capture":
                    rid = str(row.get("run_id"))
                    by_run[rid] = by_run.get(rid, 0) + 1
                elif name == "serve/shed":
                    reason = str(row.get("reason"))
                    shed_by_reason[reason] = (
                        shed_by_reason.get(reason, 0) + 1)
                elif name == "serve/coalesce":
                    if row.get("hit"):
                        coalesce_hits += 1
                    else:
                        coalesce_dispatches += 1
            for j, rid in enumerate(sorted(by_run)):
                captures[f"{rdir.name}.gen{j}"] = (
                    by_run[rid] - expected_warmup)
        fleet_layout = read_fleet_json(run_dir)

    by_class = swing["run"]["by_class"]
    interactive = by_class.get("interactive") or {}
    bulk = by_class.get("bulk") or {}
    lookups = coalesce_hits + coalesce_dispatches
    return {
        "shape": f"N={n_stocks} F={n_features} M={n_macro} "
                 f"K={n_members} months={months}",
        "fleet_startup_s": round(startup_s, 3),
        "calibration_closed_c8_rps": capacity_rps,
        "base_rate_rps": base_rate,
        "surge_rate_rps": surge_rate,
        "swing_factor": round(surge_rate / base_rate, 2),
        "phases_s": list(phase_s),
        "steps": swing["steps"],
        "by_class": by_class,
        "n_requests": swing["run"]["n_requests"],
        "n_ok": swing["run"]["n_ok"],
        "n_retried": swing["run"]["n_retried"],
        "dropped_interactive": interactive.get("dropped"),
        "interactive_requests": interactive.get("n_requests"),
        "shed_bulk_429": bulk.get("n_shed_429"),
        "shed_by_reason_server": dict(sorted(shed_by_reason.items())),
        "coalesce": {
            "hits": coalesce_hits,
            "dispatches": coalesce_dispatches,
            "dispatch_ratio": (round(coalesce_dispatches / lookups, 4)
                               if lookups else None),
        },
        "coalesce_burst": {
            "n_requests": burst["n_requests"],
            "n_ok": burst["n_ok"],
            "hits": burst_hits,
            "dispatches": burst_disp,
            "dispatch_ratio": (round(
                burst_disp / (burst_hits + burst_disp), 4)
                if (burst_hits + burst_disp) else None),
            "throughput_rps": burst["throughput_rps"],
        },
        "autoscale": {
            "scale_ups": autoscaler.scale_ups,
            "scale_downs": autoscaler.scale_downs,
            "peak_replicas": fleet.replicas,
            "final_live_replicas": len(settle_live),
            "decisions_tail": list(autoscaler.decisions)[-8:],
        },
        "steady_state_captures": dict(sorted(captures.items())),
        "steady_state_captures_max": (max(captures.values())
                                      if captures else 0),
        "fleet_json_final": fleet_layout,
        "live_engine_fingerprints": {
            str(rid): ((m or {}).get("engine") or {}).get(
                "params_fingerprint")
            for rid, m in sorted(live_metrics.items())},
        "replica_summaries": [
            {"outcome": (s or {}).get("outcome"),
             "restarts": (s or {}).get("restarts")} for s in summaries],
        "note": "supervised SO_REUSEPORT fleet boots at 1 replica with "
                "the autoscaler live; open-loop mixed-priority traffic "
                "(every Nth request bulk) swings base -> 10x base -> "
                "base on one persistent worker pool; surge is calibrated "
                "above single-replica capacity so the fleet MUST shed "
                "bulk (429 + Retry-After) and scale up, then drain back "
                "to 1 replica in the quiet tail; distinct-payload pool "
                "of size n_distinct makes concurrent twins coalesce — "
                "dispatch_ratio is dispatches / coalesce-eligible "
                "requests; dropped_interactive and every replica's "
                "captures after warmup must be 0",
    }


def loadadapt_swing(url: str, payload: Payload, cal_payload: Payload,
                    class_of: Callable[[int], str],
                    phase_s=(5.0, 14.0, 8.0), surge_factor: float = 1.3,
                    cal_concurrency: int = 8, cal_requests: int = 160,
                    content_type: str = "application/json",
                    before_swing: Optional[Callable[[], Any]] = None,
                    capacity_rps: Optional[float] = None,
                    ) -> Dict[str, Any]:
    """:func:`bench_loadadapt`'s swing against a live fleet: calibrate the
    fleet's closed-loop DISPATCH capacity over distinct payloads
    (``cal_payload``, ``cal_concurrency`` clients; skipped when the caller
    measured it and passes ``capacity_rps``), then drive the 10× open-loop
    swing base → surge → base (``phase_s`` seconds each) on one worker
    pool, the surge at ``surge_factor ×`` that capacity, with ``class_of``
    choosing each request's priority class and 6 retries.
    ``before_swing`` runs between the two (e.g. an autoscaler's start).
    Returns ``{"capacity_rps", "base_rate", "surge_rate", "swing"}``."""
    if capacity_rps is None:
        cal = run_loadgen(url, cal_payload, mode="closed",
                          concurrency=cal_concurrency,
                          n_requests=cal_requests, warmup_requests=0,
                          content_type=content_type)
        capacity_rps = cal["throughput_rps"] or 50.0
    surge_rate = max(10.0, round(surge_factor * capacity_rps, 1))
    base_rate = round(surge_rate / 10.0, 2)  # THE 10x swing
    if before_swing is not None:
        before_swing()
    swing = run_ladder(
        url, payload, rates=[base_rate, surge_rate, base_rate],
        durations=list(phase_s), retries=6, open_workers=64,
        timeout_s=30.0, content_type=content_type, class_of=class_of)
    return {"capacity_rps": capacity_rps, "base_rate": base_rate,
            "surge_rate": surge_rate, "swing": swing}


# -- the SLO detection drill and probe overhead -------------------------------


def bench_slo(
    n_stocks: int = 500,
    n_features: int = 46,
    n_macro: int = 8,
    n_members: int = 2,
    months: int = 60,
    n_distinct: int = 64,
    probe_interval_s: float = 0.25,
    overhead_probe_interval_s: float = 1.0,
    probe_timeout_s: float = 1.0,
    engine_poll_s: float = 0.1,
    restart_backoff_s: float = 3.0,
    firing_timeout_s: float = 30.0,
    resolve_timeout_s: float = 120.0,
    seed: int = 42,
    device: str = "cuda",
    compute_dtype: str = "float32",
) -> Dict[str, Any]:
    """The SLO plane's acceptance benchmark: a supervised 2-replica fleet
    under the live blackbox prober + burn-rate engine, with two detection
    drills and a probe-overhead measurement. The bars:

      * ``probe_overhead.rps_ratio >= 0.95`` — the prober's fixture
        traffic at the production cadence costs at most 5% of closed-loop
        throughput (interleaved best-of-3, prober on vs off);
      * ``kill_drill.detection_s`` / ``wedge_drill.detection_s`` under
        budget — a replica SIGKILLed (dead: connections refused) and,
        separately, SIGSTOPped (wedged-but-accepting: the kernel backlog
        accepts, nothing answers — invisible to whitebox metrics and
        between autoscaler polls) produces a FIRING availability alert
        within seconds;
      * ``steady_state_captures_max == 0`` — per replica incarnation
        (the restarted incarnation's warmup captures are budgeted), probe
        traffic included: the fixture rides existing buckets.

    Both drills also prove the resolve path: the supervisor restarts the
    killed replica (the wedged one is SIGCONTed), probes recover, and the
    alert RESOLVES once the long window's burn drops back under
    threshold.
    """
    import dataclasses
    import os as _os
    import signal as _signal
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    from ..observability.events import EventLog
    from ..observability.slo import FileAlertSink, SLOEngine, drill_spec
    from ..observability.trace import read_jsonl
    from ..utils.config import GANConfig
    from .aserver import pick_free_port
    from .engine import bucket_for
    from .fleet import REPLICA_POLICY, ReplicaFleet, server_child_argv
    from .flight import FlightRecorder
    from .probe import Prober, fixture_payload
    from .server import BINARY_CONTENT_TYPE

    rng = np.random.default_rng(seed)
    cfg = GANConfig(macro_feature_dim=n_macro,
                    individual_feature_dim=n_features)
    batch_buckets = (1, 2, 4, 8)
    with tempfile.TemporaryDirectory(prefix="dlap_slo_") as td:
        td = Path(td)
        dirs = _make_member_dirs(td / "ckpts", cfg, range(1, n_members + 1))
        macro = rng.standard_normal((months, n_macro)).astype(np.float32)
        np.save(td / "macro.npy", macro)
        stock_bucket = bucket_for(
            max(n_stocks, 64), [64 * 2**i for i in range(9)])
        run_dir = td / "fleet_run"
        args = _server_args(
            run_dir, device, compute_dtype,
            "--checkpoint_dirs", *dirs,
            "--macro_npy", str(td / "macro.npy"),
            "--stock_buckets", str(stock_bucket),
            "--batch_buckets", ",".join(str(b) for b in batch_buckets),
            "--max_queue", "64", "--cache_size", "0")
        host, port = "127.0.0.1", pick_free_port()
        admin_ports = {}
        for i in range(2):
            p = pick_free_port()
            while p == port or p in admin_ports.values():
                p = pick_free_port()
            admin_ports[i] = p
        # the drill must own the restart timing: a killed replica stays
        # down for ~restart_backoff_s (long enough to measure detection),
        # then comes back for the resolve leg
        policy = dataclasses.replace(
            REPLICA_POLICY, backoff_base_s=restart_backoff_s,
            backoff_max_s=restart_backoff_s, jitter_frac=0.0,
            min_uptime_s=0.5, poll_s=0.2)

        def make_argv(rid, admin_port):
            return server_child_argv(
                args, rid, run_dir / f"replica{rid}", port,
                admin_port=admin_port)

        fleet = ReplicaFleet(
            [make_argv(i, admin_ports[i]) for i in range(2)],
            run_dir, policy=policy)
        from .autoscale import FleetController

        controller = FleetController(
            fleet, make_argv, host, port, admin_ports=dict(admin_ports))
        url = f"http://{host}:{port}/v1/weights"
        bodies = []
        for i in range(n_distinct):
            r = np.random.default_rng(seed + 1 + i)
            bodies.append(binary_payload_bytes(
                r.standard_normal(
                    (n_stocks, n_features)).astype(np.float32),
                i % months))
        events = EventLog(run_dir, process_index=0,
                          filename="events.probe.jsonl")
        flight = FlightRecorder(run_dir=run_dir, events=events)
        prober = Prober(
            events, public_url=f"http://{host}:{port}",
            fixture=fixture_payload(n_features, month=0),
            fleet_dir=run_dir, interval_s=probe_interval_s,
            timeout_s=probe_timeout_s)
        spec = drill_spec()
        engine = SLOEngine(
            spec, {"probe": prober.counts}, events=events, flight=flight,
            sinks=(FileAlertSink(run_dir / "alerts.jsonl"),),
            poll_s=engine_poll_s)

        def measure() -> float:
            out = run_loadgen(
                url, lambda i: bodies[i % len(bodies)], mode="closed",
                concurrency=8, n_requests=160, warmup_requests=0,
                content_type=BINARY_CONTENT_TYPE)
            return out["throughput_rps"] or 0.0

        def wait_for(predicate, timeout_s: float) -> Optional[float]:
            t0 = time.monotonic()
            deadline = t0 + timeout_s
            while time.monotonic() < deadline:
                if predicate():
                    return time.monotonic() - t0
                time.sleep(0.05)
            return None

        def firing() -> bool:
            return bool(engine.firing())

        try:
            fleet.start()
            fleet.wait_ready(timeout=600.0)
            controller.publish_layout()
            # warmup: every batch bucket + the fixture shape
            run_loadgen(url, lambda i: bodies[i % len(bodies)],
                        mode="closed", concurrency=16, n_requests=96,
                        warmup_requests=4,
                        content_type=BINARY_CONTENT_TYPE)
            prober.probe_once()
            # -- probe overhead: interleaved best-of-3, prober off vs on.
            # The "on" prober is the standalone CLI in its OWN process —
            # exactly how a deployment runs it — so the measurement is the
            # server-side cost of probe traffic, not GIL contention
            # between prober threads and this process's loadgen workers
            pkg = __name__.rsplit(".", 2)[0]
            cli_dir = run_dir / "probe_cli"
            probe_cmd = [
                sys.executable, "-m", f"{pkg}.serving.probe",
                "--url", f"http://{host}:{port}",
                "--fleet_dir", str(run_dir), "--run_dir", str(cli_dir),
                "--n_features", str(n_features),
                "--interval", str(overhead_probe_interval_s),
                "--timeout", str(probe_timeout_s)]
            off_rps, on_rps = [], []
            for _rep in range(3):
                off_rps.append(measure())
                # the "on" window must actually contain THIS rep's probe
                # traffic: the CLI's EventLog appends, so "file exists"
                # is satisfied by a previous rep — wait for GROWTH past
                # the pre-spawn size instead
                cli_events = cli_dir / "events.probe.jsonl"
                size_before = (cli_events.stat().st_size
                               if cli_events.exists() else 0)
                proc = subprocess.Popen(
                    probe_cmd, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)
                try:
                    deadline = time.monotonic() + 30.0
                    while time.monotonic() < deadline:
                        if (cli_events.exists()
                                and cli_events.stat().st_size
                                > size_before):
                            break
                        time.sleep(0.1)
                    time.sleep(overhead_probe_interval_s)
                    on_rps.append(measure())
                finally:
                    proc.terminate()
                    proc.wait(timeout=30)
            prober.start()
            engine.start()
            # settle: the engine needs one long window of clean probes
            # before a drill (otherwise the first window has no far edge)
            settle = wait_for(
                lambda: engine.ticks > 0
                and prober.counts()[1] >= 8, timeout_s=30.0)
            time.sleep(spec["objectives"][0]["windows"][0]["short_s"])
            # clean baseline (a transient startup blip may fire once on a
            # loaded host — give it one window to resolve, then insist)
            wait_for(lambda: not firing(), timeout_s=30.0)
            assert not firing(), (
                "availability alert firing before any drill: "
                f"{engine.state()}")

            # -- drill 1: SIGKILL (dead replica: connections refused)
            pid0 = fleet.replica_pid(0)
            assert pid0 is not None
            _os.kill(pid0, _signal.SIGKILL)
            kill_detection_s = wait_for(firing, firing_timeout_s)
            kill_alert = list(engine.alerts)[-1] if engine.alerts else None
            # resolve: the supervisor restarts it; probes go clean again
            kill_resolve_s = wait_for(
                lambda: not firing(), resolve_timeout_s)

            # -- drill 2: SIGSTOP (wedged-but-accepting: backlog accepts,
            # nothing answers — the whitebox planes see a healthy process)
            pid1 = fleet.replica_pid(1)
            assert pid1 is not None
            _os.kill(pid1, _signal.SIGSTOP)
            try:
                wedge_detection_s = wait_for(firing, firing_timeout_s)
            finally:
                _os.kill(pid1, _signal.SIGCONT)
            wedge_resolve_s = wait_for(
                lambda: not firing(), resolve_timeout_s)
            probe_stats = prober.stats()
            engine_state = engine.state()
        finally:
            engine.stop()
            prober.stop()
            summaries = fleet.stop()
            events.close()

        # per-incarnation capture evidence: a restarted replica pays its
        # warmup captures again under a fresh run_id — steady state within
        # EVERY incarnation must stay at zero
        expected_warmup = _warmup_captures(device, len(batch_buckets))
        captures: Dict[str, int] = {}
        for rdir in sorted(run_dir.glob("replica*")):
            if not rdir.is_dir():
                continue
            by_run: Dict[str, int] = {}
            for row in read_jsonl(rdir / "events.jsonl"):
                if (row.get("kind") == "counter"
                        and row.get("name") == "serve/capture"):
                    rid = str(row.get("run_id"))
                    by_run[rid] = by_run.get(rid, 0) + 1
            for j, rid in enumerate(sorted(by_run)):
                captures[f"{rdir.name}.gen{j}"] = (
                    by_run[rid] - expected_warmup)
        alerts_file = [
            json.loads(line) for line in
            (run_dir / "alerts.jsonl").read_text().splitlines()
        ] if (run_dir / "alerts.jsonl").exists() else []

    best_off = max(off_rps) if off_rps else None
    best_on = max(on_rps) if on_rps else None
    return {
        "shape": f"N={n_stocks} F={n_features} M={n_macro} "
                 f"K={n_members} months={months} replicas=2",
        "slo_spec": spec,
        "probe": {
            "interval_s": probe_interval_s,
            "timeout_s": probe_timeout_s,
            **probe_stats,
        },
        "probe_overhead": {
            "closed_c8_rps_prober_off": off_rps,
            "closed_c8_rps_prober_on": on_rps,
            "rps_off": best_off,
            "rps_on": best_on,
            "rps_ratio": (round(best_on / best_off, 4)
                          if best_off else None),
        },
        "settle_s": settle,
        "kill_drill": {
            "detection_s": (round(kill_detection_s, 3)
                            if kill_detection_s is not None else None),
            "resolve_s": (round(kill_resolve_s, 3)
                          if kill_resolve_s is not None else None),
            "alert": kill_alert,
        },
        "wedge_drill": {
            "detection_s": (round(wedge_detection_s, 3)
                            if wedge_detection_s is not None else None),
            "resolve_s": (round(wedge_resolve_s, 3)
                          if wedge_resolve_s is not None else None),
        },
        "alerts_file_transitions": len(alerts_file),
        "engine": engine_state,
        "steady_state_captures": dict(sorted(captures.items())),
        "steady_state_captures_max": (max(captures.values())
                                      if captures else 0),
        "replica_summaries": [
            {"outcome": (s or {}).get("outcome"),
             "restarts": (s or {}).get("restarts")} for s in summaries],
        "note": "supervised 2-replica SO_REUSEPORT fleet under the live "
                "blackbox prober (fixture /v1/weights on the raw-f32 "
                "wire + per-replica admin /healthz + /metrics from "
                "fleet.json) and the burn-rate SLOEngine (drill spec: "
                "probe-success availability, one "
                "long/short window pair). Drill 1 SIGKILLs replica0 "
                "(dead: refused connections); drill 2 SIGSTOPs replica1 "
                "(wedged-but-accepting: kernel backlog accepts, nothing "
                "answers — invisible to whitebox metrics, between "
                "autoscaler polls). detection_s is seconds from the "
                "signal to the FIRING availability alert; both drills "
                "then RESOLVE (supervised restart / SIGCONT). "
                "probe_overhead interleaves closed-loop c8 throughput "
                "prober-off vs prober-on at the production probe cadence "
                "(overhead_probe_interval_s), best of 3 each; the drills "
                "run the prober at the hotter drill cadence "
                "(probe_interval_s) the seconds-scale windows need. "
                "steady_state_captures is per replica INCARNATION "
                "(warmup captures budgeted per run_id).",
    }


# -- the tracing-overhead benchmark -------------------------------------------


def bench_tracing_overhead(
    n_stocks: int = 500,
    n_features: int = 46,
    n_macro: int = 8,
    n_members: int = 4,
    months: int = 60,
    n_requests: int = 320,
    concurrency: int = 8,
    trials: int = 3,
    seed: int = 42,
    device: str = "cuda",
    compute_dtype: str = "float32",
) -> Dict[str, Any]:
    """Closed-loop throughput with request tracing fully ON
    (``DLAP_TRACE_SAMPLE=1``: every request emits its segment-timed
    ``request`` row) vs fully OFF (``=0``: only the aggregate span_end
    twin) against ONE in-process async server — no fleet, no supervisor,
    so the measured delta is the tracing hot-path cost alone. Trials
    interleave on/off (best-of-N each) to ride out CPU-quota bursts. The
    bar: ``rps_ratio_on_off >= 0.95`` — tracing may cost at most 5% of
    closed-loop throughput."""
    import os
    import tempfile
    from pathlib import Path

    from ..observability.tracecontext import ENV_SAMPLE
    from ..utils.config import ExecutionConfig, GANConfig
    from .aserver import AsyncServerThread
    from .engine import InferenceEngine, bucket_for
    from .server import BINARY_CONTENT_TYPE, ServingService

    rng = np.random.default_rng(seed)
    cfg = GANConfig(macro_feature_dim=n_macro,
                    individual_feature_dim=n_features)
    macro = rng.standard_normal((months, n_macro)).astype(np.float32)
    with tempfile.TemporaryDirectory(prefix="dlap_tracing_bench_") as td:
        td = Path(td)
        dirs = _make_member_dirs(td / "ckpts", cfg, range(1, n_members + 1))
        stock_bucket = bucket_for(n_stocks, [64 * 2**i for i in range(9)])
        engine = InferenceEngine(
            dirs, macro_history=macro, stock_buckets=(stock_bucket,),
            batch_buckets=(1, 2, 4, 8),
            exec_cfg=ExecutionConfig(device=device,
                                     compute_dtype=compute_dtype))
        service = ServingService(engine, run_dir=str(td / "serve_run"),
                                 mode="async", cache_size=0)
        service.warmup()
        server = AsyncServerThread(service)
        port = server.start()
        url = f"http://127.0.0.1:{port}/v1/weights"
        bodies = []
        for i in range(64):
            r = np.random.default_rng(seed + 1 + i)
            bodies.append(binary_payload_bytes(
                r.standard_normal(
                    (n_stocks, n_features)).astype(np.float32),
                i % months))

        def run_once():
            return run_loadgen(
                url, lambda i: bodies[i % len(bodies)], mode="closed",
                concurrency=concurrency, n_requests=n_requests,
                warmup_requests=8, content_type=BINARY_CONTENT_TYPE)

        prev = os.environ.get(ENV_SAMPLE)
        runs: Dict[str, List[Dict[str, Any]]] = {"off": [], "on": []}
        try:
            run_once()  # warm every batch-bucket shape off the clock
            for _ in range(max(1, trials)):
                for mode, sample in (("off", "0"), ("on", "1")):
                    os.environ[ENV_SAMPLE] = sample
                    runs[mode].append(run_once())
        finally:
            if prev is None:
                os.environ.pop(ENV_SAMPLE, None)
            else:
                os.environ[ENV_SAMPLE] = prev
            server.stop()
            service.close()

    def best(mode):
        return max(runs[mode], key=lambda r: r["throughput_rps"] or 0)

    b_off, b_on = best("off"), best("on")
    ratio = (b_on["throughput_rps"] / b_off["throughput_rps"]
             if b_off["throughput_rps"] else None)
    return {
        "shape": f"N={n_stocks} F={n_features} M={n_macro} "
                 f"K={n_members} months={months}",
        "concurrency": concurrency,
        "n_requests": n_requests,
        "trials": trials,
        "rps_tracing_off": b_off["throughput_rps"],
        "rps_tracing_on": b_on["throughput_rps"],
        "rps_ratio_on_off": round(ratio, 4) if ratio is not None else None,
        "p99_ms_tracing_off": (b_off["latency"] or {}).get("p99_ms"),
        "p99_ms_tracing_on": (b_on["latency"] or {}).get("p99_ms"),
        "all_trials": {
            mode: [{"throughput_rps": r["throughput_rps"],
                    "p99_ms": (r["latency"] or {}).get("p99_ms")}
                   for r in rs]
            for mode, rs in runs.items()},
        "note": "one in-process async server, raw-f32 wire, cache off, "
                "closed loop, trials interleaved on/off and best-of-N "
                "each; DLAP_TRACE_SAMPLE=1 emits a full segment-timed "
                "request row per request, =0 only the aggregate span_end "
                "twin; the bar requires the ratio >= 0.95 "
                "(tracing overhead <= 5% of closed-loop rps)",
    }


# -- the mesh-serving benchmark -------------------------------------------------


def _span_mesh(device: str, spec: Optional[str]):
    """The sharded engine's mesh: `spec` over the route's local devices (the
    CLI's rule: more devices than the host has is an error), or by default
    ``stocks=S`` with S the device count but at least 2, laid over the
    devices in turn (on one device, two spans of it)."""
    from ..parallel import partition

    devices = partition.local_devices(device)
    if spec is not None:
        return partition.parse_mesh_spec(spec, devices)
    n = max(2, len(devices))
    return partition.MeshConfig(((partition.STOCK_AXIS, n),),
                                tuple(devices[i % len(devices)]
                                      for i in range(n)))


def bench_meshserve(
    n_stocks: int = 10_240,
    n_features: int = 46,
    n_macro: int = 8,
    n_members: int = 3,
    months: int = 24,
    n_pairs: int = 24,
    mesh_spec: Optional[str] = None,
    tol: float = 1e-5,
    fleet_stocks: int = 512,
    fleet_rate_rps: float = 30.0,
    fleet_seconds: float = 10.0,
    seed: int = 42,
    device: str = "cuda",
    compute_dtype: str = "float32",
) -> Dict[str, Any]:
    """The mesh-serving benchmark, three legs, as the JAX package's:

      * identity: the one-device engine against a degenerate ``stocks=1``
        mesh (bit for bit: placement only) and against the sharded engine
        (`mesh_spec` over the local devices; by default one span per
        device, at least two, so one card runs the span path too), paired
        requests in alternating order. The sharded engine gathers the
        members' weights onto its first position and runs the
        cross-section there; ``sharded_max_abs_diff`` must stay within
        `tol`. A hot swap of a rewritten member mid-run re-checks it
        against a fresh one-device engine of the new weights.
      * invariants: captures after warmup (the port's counterpart of the
        JAX engine's recompiles) are 0 on every engine and every replica
        incarnation; the engines warm the same buckets.
      * fault matrix: a supervised 2-replica fleet, ``--mesh stocks=-1
        --mesh_slices`` the device count (at most 2; one card: both on its
        one slice), under open-loop load with retries; replica 0 is
        SIGKILLed mid-load and restarted. ``dropped_requests`` must be 0.

    Writes no file outside its temporary directory; the replicas run on
    `device`."""
    import os as _os
    import signal as _signal
    import tempfile
    from pathlib import Path

    from ..parallel import partition
    from ..utils.config import ExecutionConfig, GANConfig
    from .aserver import pick_free_port
    from .engine import InferenceEngine, InferenceRequest
    from .fleet import ReplicaFleet, server_child_argv
    from .server import BINARY_CONTENT_TYPE

    n_devices = len(partition.local_devices(device))
    exec_cfg = ExecutionConfig(device=device, compute_dtype=compute_dtype)
    rng = np.random.default_rng(seed)
    cfg = GANConfig(macro_feature_dim=n_macro,
                    individual_feature_dim=n_features)
    macro = rng.standard_normal((months, n_macro)).astype(np.float32)

    def _requests(n, stocks, offset=0):
        out = []
        for i in range(n):
            r = np.random.default_rng(seed + 1 + offset + i)
            out.append(InferenceRequest(
                individual=r.standard_normal(
                    (stocks, n_features)).astype(np.float32),
                mask=(r.random(stocks) > 0.1).astype(np.float32),
                returns=(r.standard_normal(stocks) * 0.05).astype(
                    np.float32),
                month=int(i % months)))
        return out

    def _identity(a, b):
        """(bitwise, max_abs_diff) over a pair of results."""
        d = 0.0
        if a.weights.size:
            d = float(np.max(np.abs(a.weights - b.weights)))
        if a.sdf is not None and b.sdf is not None:
            d = max(d, abs(float(a.sdf) - float(b.sdf)))
        return (np.array_equal(a.weights, b.weights) and a.sdf == b.sdf), d

    def _engine(dirs, mesh=None):
        return InferenceEngine(dirs, macro_history=macro,
                               stock_buckets=(n_stocks,), batch_buckets=(1,),
                               exec_cfg=exec_cfg, mesh=mesh)

    n_slices = min(2, n_devices)
    with tempfile.TemporaryDirectory(prefix="dlap_meshserve_") as td:
        td = Path(td)
        dirs = _make_member_dirs(td / "v1", cfg, range(1, n_members + 1))

        t0 = time.monotonic()
        single = _engine(dirs)
        single_load_s = time.monotonic() - t0
        t0 = time.monotonic()
        sharded = _engine(dirs, _span_mesh(device, mesh_spec))
        sharded_load_s = time.monotonic() - t0
        degenerate = _engine(dirs, "stocks=1")

        t0 = time.monotonic()
        warmed_single = single.warmup()
        single_warmup_s = time.monotonic() - t0
        t0 = time.monotonic()
        warmed_sharded = sharded.warmup()
        sharded_warmup_s = time.monotonic() - t0
        degenerate.warmup()

        # paired at the paper stock shape: the same request through both
        # engines, the order alternated per pair
        pair_single_s: List[float] = []
        pair_sharded_s: List[float] = []
        bitwise_all = degenerate_bitwise = True
        max_diff = 0.0
        for i, req in enumerate(_requests(n_pairs, n_stocks)):
            order = ((single, pair_single_s), (sharded, pair_sharded_s))
            if i % 2:
                order = order[::-1]
            results = {}
            for eng, walls in order:
                t0 = time.monotonic()
                results[id(eng)] = eng.infer_one(req)
                walls.append(time.monotonic() - t0)
            bit, d = _identity(results[id(single)], results[id(sharded)])
            bitwise_all = bitwise_all and bit
            max_diff = max(max_diff, d)
            dbit, _ = _identity(results[id(single)],
                                degenerate.infer_one(req))
            degenerate_bitwise = degenerate_bitwise and dbit

        # the hot swap: member 0 rewritten on disk, the sharded engine
        # reloads (every position's tensors, no capture) and must hold the
        # same identity against a fresh one-device engine of the new params
        swap_src = Path(_make_member_dirs(td / "v2", cfg, (101,))[0])
        for f in swap_src.iterdir():
            (Path(dirs[0]) / f.name).write_bytes(f.read_bytes())
        t0 = time.monotonic()
        reload_out = sharded.reload()
        reload_s = time.monotonic() - t0
        single2 = _engine(dirs)
        single2.warmup()
        swap_bitwise = True
        swap_max_diff = 0.0
        for req in _requests(4, n_stocks, offset=10**6):
            bit, d = _identity(single2.infer_one(req),
                               sharded.infer_one(req))
            swap_bitwise = swap_bitwise and bit
            swap_max_diff = max(swap_max_diff, d)
        stats_single = single.stats()
        stats_sharded = sharded.stats()

        # -- fault matrix: a 2-replica fleet on device slices ----------------
        np.save(td / "macro.npy", macro)
        run_dir = td / "fleet_run"
        args = _server_args(
            run_dir, device, compute_dtype,
            "--checkpoint_dirs", *dirs,
            "--macro_npy", str(td / "macro.npy"),
            "--stock_buckets", str(fleet_stocks),
            "--batch_buckets", "1,2,4",
            "--mesh", "stocks=-1", "--mesh_slices", str(n_slices),
            "--max_queue", "512",
            "--cache_size", "0")
        port = pick_free_port()
        admin_ports: List[int] = []
        for _ in range(2):
            ap = pick_free_port()
            while ap in admin_ports or ap == port:
                ap = pick_free_port()
            admin_ports.append(ap)
        argvs = [server_child_argv(args, i, run_dir / f"replica{i}", port,
                                   admin_port=admin_ports[i])
                 for i in range(2)]
        fleet = ReplicaFleet(argvs, run_dir)
        url = f"http://127.0.0.1:{port}/v1/weights"
        bodies = []
        for i in range(64):
            r = np.random.default_rng(seed + 1 + i)
            bodies.append(binary_payload_bytes(
                r.standard_normal(
                    (fleet_stocks, n_features)).astype(np.float32),
                i % months))
        n_requests = int(fleet_rate_rps * fleet_seconds)
        load_out: Dict[str, Any] = {}

        def _drive():
            load_out.update(run_loadgen(
                url, lambda i: bodies[i % len(bodies)], mode="open",
                rate_rps=fleet_rate_rps, n_requests=n_requests,
                warmup_requests=0, retries=2, timeout_s=30.0,
                open_workers=8, content_type=BINARY_CONTENT_TYPE))

        try:
            t0 = time.monotonic()
            fleet.start()
            fleet.wait_ready(timeout=600.0)
            startup_s = time.monotonic() - t0
            # every batch-bucket shape served once before the measured load
            run_loadgen(url, lambda i: bodies[i % len(bodies)],
                        mode="closed", concurrency=8, n_requests=64,
                        warmup_requests=4,
                        content_type=BINARY_CONTENT_TYPE)
            loader = threading.Thread(target=_drive, name="meshserve-load")
            loader.start()
            time.sleep(min(2.0, fleet_seconds / 4))
            pid0 = fleet.replica_pid(0)
            if pid0 is None:
                raise RuntimeError("replica 0 has no live process to kill")
            _os.kill(pid0, _signal.SIGKILL)
            loader.join()
            # the restarted incarnation must accept before its scrape (the
            # invariants read its post-restart counters)
            fleet.wait_ready(timeout=600.0)
            per_replica: Dict[str, Any] = {}
            for ap in admin_ports:
                deadline = time.monotonic() + 120.0
                while True:
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{ap}/metrics",
                                timeout=10) as r:
                            m = json.loads(r.read())
                        break
                    except OSError:
                        if time.monotonic() >= deadline:
                            raise
                        time.sleep(0.5)
                per_replica[str(m.get("replica"))] = m
        finally:
            summaries = fleet.stop()

    med_single = float(np.median(pair_single_s)) if pair_single_s else None
    med_sharded = (float(np.median(pair_sharded_s))
                   if pair_sharded_s else None)
    captures = {
        "single": stats_single["steady_state_captures"],
        "sharded": stats_sharded["steady_state_captures"],
        **{str(r): m["engine"]["steady_state_captures"]
           for r, m in sorted(per_replica.items())},
    }
    return {
        "shape": f"N={n_stocks} F={n_features} M={n_macro} "
                 f"K={n_members} months={months}",
        "devices": n_devices,
        "mesh": mesh_spec,
        "sharded_mesh": stats_sharded["mesh"],
        "sharded_positions": stats_sharded["mesh_devices"],
        "stock_shards": stats_sharded["stock_shards"],
        "n_pairs": n_pairs,
        "engine_load_s": {"single": round(single_load_s, 3),
                          "sharded": round(sharded_load_s, 3)},
        "warmup_capture_s": {"single": round(single_warmup_s, 3),
                             "sharded": round(sharded_warmup_s, 3)},
        "warmed_programs": {"single": warmed_single,
                            "sharded": warmed_sharded},
        "median_infer_ms": {
            "single": (round(med_single * 1e3, 3)
                       if med_single is not None else None),
            "sharded": (round(med_sharded * 1e3, 3)
                        if med_sharded is not None else None)},
        "paired_median_ratio_single_over_sharded": (
            round(med_single / med_sharded, 4)
            if med_single and med_sharded else None),
        "bit_identical": int(degenerate_bitwise and max_diff <= tol
                             and swap_max_diff <= tol),
        "bitwise_equal_sharded": int(bitwise_all),
        "degenerate_bitwise": int(degenerate_bitwise),
        "sharded_max_abs_diff": max_diff,
        "tolerance": tol,
        "hot_swap": {
            "swapped": reload_out.get("swapped"),
            "reload_s": round(reload_s, 3),
            "max_abs_diff": swap_max_diff,
            "bitwise_equal": int(swap_bitwise)},
        "dispatches": {"single": stats_single["dispatches"],
                       "sharded": stats_sharded["dispatches"]},
        "captures": {"single": stats_single["captures"],
                     "sharded": stats_sharded["captures"]},
        "steady_state_captures": captures,
        "steady_state_captures_max": max(captures.values()),
        "fault_matrix": {
            "replicas": 2,
            "mesh": f"stocks=-1 over {n_slices} slice(s)",
            "fleet_stocks": fleet_stocks,
            "rate_rps": fleet_rate_rps,
            "fleet_startup_s": round(startup_s, 3),
            "n_requests": load_out.get("n_requests"),
            "n_ok": load_out.get("n_ok"),
            "dropped_requests": (int(load_out["n_requests"])
                                 - int(load_out["n_ok"])),
            "n_retried": load_out.get("n_retried"),
            "errors": load_out.get("errors"),
            "latency": load_out.get("latency"),
            "replica_meshes": {
                r: m["engine"]["mesh"]
                for r, m in sorted(per_replica.items())},
            "replica_devices": {
                r: m["engine"]["device"]
                for r, m in sorted(per_replica.items())},
            "replica_restarts": [
                (s or {}).get("restarts", 0) for s in summaries],
        },
        "note": "bit_identical = the degenerate stocks=1 mesh bit for bit "
                "the one-device engine AND the sharded engine within "
                "`tolerance` of it, across the hot swap. Steady-state "
                "captures must be 0 everywhere. Fault matrix: replica 0 "
                "SIGKILLed mid-load and restarted under supervision; "
                "retries reach the survivor, so dropped_requests must be "
                "0. Several spans on one device share its compute: a "
                "paired ratio there measures the span path's overhead, "
                "not a speedup.",
    }


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Serving load generator / loopback benchmark")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("bench",
                       help="self-contained loopback benchmark "
                            "(DEPRECATED threaded server baseline)")
    b.add_argument("--n_stocks", type=int, default=500)
    b.add_argument("--n_members", type=int, default=4)
    b.add_argument("--n_requests", type=int, default=200)
    a = sub.add_parser("bench_async",
                       help="replicated async-fleet loopback benchmark")
    a.add_argument("--n_stocks", type=int, default=500)
    a.add_argument("--n_members", type=int, default=4)
    a.add_argument("--n_requests", type=int, default=320)
    a.add_argument("--replicas", type=int, default=2)
    la = sub.add_parser("bench_loadadapt",
                        help="load-adaptive fleet: autoscaler + priority "
                             "shedding + coalescing under a 10x rate swing")
    la.add_argument("--n_stocks", type=int, default=500)
    la.add_argument("--n_members", type=int, default=2)
    la.add_argument("--max_replicas", type=int, default=2)
    r = sub.add_parser("bench_rolling_reload",
                       help="promotion control plane: open-loop load "
                            "across a health-gated rolling hot-swap")
    r.add_argument("--n_stocks", type=int, default=500)
    r.add_argument("--n_members", type=int, default=2)
    r.add_argument("--replicas", type=int, default=2)
    r.add_argument("--rate_rps", type=float, default=40.0)
    r.add_argument("--load_seconds", type=float, default=12.0)
    for sp in (b, a, la, r):
        sp.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"),
                        help="the replicas' device (default: the CUDA "
                             "device; an error without one)")
        sp.add_argument("--compute_dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"))
    d = sub.add_parser("drive", help="drive an already-running server")
    d.add_argument("--url", type=str, required=True)
    d.add_argument("--payload_json", type=str, required=True,
                   help="path to one JSON request payload")
    d.add_argument("--mode", type=str, default="closed",
                   choices=("closed", "open"))
    d.add_argument("--concurrency", type=int, default=4)
    d.add_argument("--rate_rps", type=float, default=None)
    d.add_argument("--rate_ladder", type=str, default=None,
                   help="comma-separated open-loop rate ladder (rps); "
                        "overrides --rate_rps/--mode")
    d.add_argument("--n_requests", type=int, default=200)
    d.add_argument("--retries", type=int, default=0)
    args = p.parse_args(argv)

    if args.cmd != "drive":
        from ..utils.config import resolve_device

        try:
            resolve_device(args.device)  # the device check, before any boot
        except RuntimeError as e:
            print(f"serving.loadgen: {e}", file=sys.stderr)
            return 2
        dev = dict(device=args.device, compute_dtype=args.compute_dtype)
    if args.cmd == "bench":
        out = bench_serving(n_stocks=args.n_stocks,
                            n_members=args.n_members,
                            n_requests=args.n_requests, **dev)
    elif args.cmd == "bench_async":
        out = bench_serving_async(n_stocks=args.n_stocks,
                                  n_members=args.n_members,
                                  n_requests=args.n_requests,
                                  replicas=args.replicas, **dev)
    elif args.cmd == "bench_loadadapt":
        out = bench_loadadapt(n_stocks=args.n_stocks,
                              n_members=args.n_members,
                              max_replicas=args.max_replicas, **dev)
    elif args.cmd == "bench_rolling_reload":
        out = bench_rolling_reload(n_stocks=args.n_stocks,
                                   n_members=args.n_members,
                                   replicas=args.replicas,
                                   rate_rps=args.rate_rps,
                                   load_seconds=args.load_seconds, **dev)
    else:
        payload = json.loads(open(args.payload_json).read())
        if args.rate_ladder:
            rates = [float(x) for x in args.rate_ladder.split(",")]
            out = run_ladder(args.url, payload, rates=rates,
                             retries=args.retries)
        else:
            out = run_loadgen(args.url, payload, mode=args.mode,
                              concurrency=args.concurrency,
                              rate_rps=args.rate_rps,
                              n_requests=args.n_requests,
                              retries=args.retries)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
