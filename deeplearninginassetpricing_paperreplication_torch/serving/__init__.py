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
  * :mod:`.aserver` — the asyncio HTTP front end (keep-alive, admin
    listener, drain);
  * :mod:`.flight`  — the crash flight recorder.

Importing this package loads torch (the engine); nothing here imports it
at module level besides :mod:`.engine`.
"""

from .aserver import AsyncServerThread, pick_free_port, run_async_server
from .batcher import ContinuousBatcher, MicroBatcher, QueueFull, Shed
from .engine import (
    InferenceEngine,
    InferenceRequest,
    InferenceResult,
    bucket_for,
    params_digest,
)
from .flight import FlightRecorder, load_flightrecorder
from .server import LRUCache, ServingService, make_server, priority_for

__all__ = [
    "AsyncServerThread",
    "ContinuousBatcher",
    "FlightRecorder",
    "InferenceEngine",
    "InferenceRequest",
    "InferenceResult",
    "LRUCache",
    "MicroBatcher",
    "QueueFull",
    "ServingService",
    "Shed",
    "bucket_for",
    "load_flightrecorder",
    "make_server",
    "params_digest",
    "pick_free_port",
    "priority_for",
    "run_async_server",
]
