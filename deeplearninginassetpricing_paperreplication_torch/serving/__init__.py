"""Online SDF inference: run-dir checkpoints → a low-latency service (the
port's counterpart of the JAX package's ``serving/``).

  * :mod:`.engine`  — ``InferenceEngine``: K stacked checkpoints, one CUDA
    graph per (stock bucket, batch bucket) over pinned staging (zero
    steady-state captures and host allocations), incremental O(1) macro
    LSTM state, ``reload()`` hot swap with snapshot/restore;
  * :mod:`.batcher` — ``ContinuousBatcher`` (asyncio, flushes fold
    in-flight arrivals) and the deprecated deadline ``MicroBatcher``,
    both with per-bucket lanes and bounded backpressure;
  * :mod:`.server`  — the transport-agnostic ``ServingService``
    (``/v1/weights``, ``/v1/sdf``, ``/v1/macro``, ``/v1/reload``,
    ``/v1/models``, ``/healthz``, ``/metrics``; JSON / base64 / raw-f32
    wires) with events, heartbeats, the LRU result cache keyed on the
    params fingerprint, single-flight coalescing, drift scoring and the
    reload canary;
  * :mod:`.aserver` — the asyncio HTTP front end (keep-alive,
    ``SO_REUSEPORT``, admin listener, drain);
  * :mod:`.fleet`   — supervisor-managed replica processes on one
    shared port, as a DYNAMIC set (a dead replica degrades capacity,
    not availability; ``fleet.json`` atomically tracks the live layout),
    and the health-gated ``RollingUpdater`` onto a promotion pointer;
  * :mod:`.autoscale` — the load-adaptive control loop: per-replica
    metrics → queue-depth/shed-rate/p99 signals → hysteresis+cooldown →
    grow/shrink the replica set live (graceful ``/v1/drain``
    scale-down);
  * :mod:`.loadgen` — open/closed-loop load generator (keep-alive raw
    sockets, retries, rate ladder, error accounting) and the bench
    functions;
  * :mod:`.probe`   — the blackbox prober and fleet scraper behind the
    SLO engine;
  * :mod:`.flight`  — the crash flight recorder.

Importing this package loads torch (the engine); nothing here imports it
at module level besides :mod:`.engine`.
"""

from .aserver import AsyncServerThread, pick_free_port, run_async_server
from .autoscale import AutoscalePolicy, Autoscaler, FleetController
from .batcher import ContinuousBatcher, MicroBatcher, QueueFull, Shed
from .engine import (
    InferenceEngine,
    InferenceRequest,
    InferenceResult,
    bucket_for,
    params_digest,
)
from .fleet import (
    REPLICA_POLICY,
    ReplicaFleet,
    read_fleet_json,
    server_child_argv,
    write_fleet_json,
)
from .flight import FlightRecorder, load_flightrecorder
from .loadgen import (
    bench_serving,
    bench_tracing_overhead,
    run_ladder,
    run_loadgen,
)
from .server import LRUCache, ServingService, make_server, priority_for

__all__ = [
    "AsyncServerThread",
    "AutoscalePolicy",
    "Autoscaler",
    "ContinuousBatcher",
    "FleetController",
    "FlightRecorder",
    "InferenceEngine",
    "InferenceRequest",
    "InferenceResult",
    "LRUCache",
    "MicroBatcher",
    "QueueFull",
    "REPLICA_POLICY",
    "ReplicaFleet",
    "ServingService",
    "Shed",
    "bench_serving",
    "bench_tracing_overhead",
    "load_flightrecorder",
    "bucket_for",
    "make_server",
    "params_digest",
    "pick_free_port",
    "priority_for",
    "read_fleet_json",
    "run_async_server",
    "run_ladder",
    "run_loadgen",
    "server_child_argv",
    "write_fleet_json",
]
