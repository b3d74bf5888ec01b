"""Device-memory snapshots aggregated over every visible CUDA device.

The port's counterpart of the JAX package's ``observability/memory.py``,
on ``torch.cuda.memory_stats`` (the caching allocator's counters, a
host-side read: never a ``synchronize``, never a device query). The
aggregation rule is the JAX one: byte/allocation counts SUM across
devices; ``peak``, ``largest`` and ``limit`` counters take the MAX (a
per-device high-water mark or capacity is not additive evidence of
pressure).

Only the allocator's pool-wide counters (``*.all.*``) and its event
counts (``num_*``) are kept, plus the JAX names ``bytes_in_use``,
``peak_bytes_in_use`` and ``bytes_limit`` (the device's total memory) so
one reader serves both packages' state files. A process that has not
initialised CUDA (a CPU run) reports no devices: the snapshot never
creates a context to read counters that would all be zero.

Module level stays stdlib-only: torch loads inside the snapshot.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

from .events import EventLog

# keys that are per-device high-water marks or capacities — aggregate by max
_MAX_KEYS = ("peak", "largest", "limit")


def _empty() -> Dict[str, Any]:
    return {"n_devices": 0, "totals": {}, "per_device": []}


def _device_stats(torch, d: int) -> Dict[str, int]:
    raw = torch.cuda.memory_stats(d)
    stats = {k: int(v) for k, v in raw.items()
             if ".all." in k or k.startswith("num_")}
    stats["bytes_in_use"] = int(raw.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(raw.get("allocated_bytes.all.peak", 0))
    stats["bytes_limit"] = int(torch.cuda.get_device_properties(d)
                               .total_memory)
    return stats


def device_memory_snapshot() -> Dict[str, Any]:
    """``{"n_devices", "totals", "per_device"}`` over the visible CUDA
    devices: ``totals`` sums count-like stats and maxes peak/limit-like
    ones; ``per_device`` keeps every device's counters (tagged with the
    device string). No CUDA context in this process: no devices."""
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return _empty()
        n = torch.cuda.device_count()
    except Exception:
        return _empty()
    per_device = []
    totals: Dict[str, int] = {}
    for d in range(n):
        try:
            stats = _device_stats(torch, d)
        except Exception:
            stats = {}
        per_device.append({"device": f"cuda:{d}", **stats})
        for k, v in stats.items():
            if any(tag in k for tag in _MAX_KEYS):
                totals[k] = max(totals.get(k, 0), v)
            else:
                totals[k] = totals.get(k, 0) + v
    return {"n_devices": n, "totals": totals, "per_device": per_device}


def log_memory(events: Optional[EventLog], name: str = "device_memory",
               **attrs: Any) -> Dict[str, Any]:
    """Snapshot + emit one ``memory`` event (phase/segment boundaries
    only)."""
    snap = device_memory_snapshot()
    if events is not None:
        events.emit("memory", name, **snap, **attrs)
    return snap
