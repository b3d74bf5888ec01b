"""Phase-tagged liveness files in the JAX package's state-file format.

The child writes ``{"heartbeat": {"section": <str>, "ts": <float>}}`` into
an atomically-replaced JSON state file at every section entry; a watchdog
times sections against it, kills hangs, and attributes any death mode
(raise, OOM-kill, hang) to the section the last heartbeat names. The port's
copy of the JAX package's ``observability/heartbeat.py`` — the same format,
so one watchdog supervises either package's processes.

Module level stays stdlib-only: a thin parent can load this file by path
without torch.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:
    from .events import EventLog


def read_state(path) -> Dict[str, Any]:
    """Tolerant read: missing/partial files are an empty state, never a
    raise (the supervisor polls while the child may be mid-write)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def write_state(path, state: Dict[str, Any]) -> None:
    """Atomic tmp+rename: a polling reader never sees a partial write."""
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(state))
    os.replace(tmp, path)


def beat(path, state: Dict[str, Any], section: str) -> Dict[str, Any]:
    """Stamp ``state["heartbeat"]`` for `section` and persist; returns the
    (mutated) state — the protocol a watchdog parses."""
    state["heartbeat"] = {"section": section, "ts": time.time()}
    write_state(path, state)
    return state


def last_beat(state: Dict[str, Any]) -> tuple:
    """(section, ts) of the last heartbeat in a state dict, or (None, None).
    Tolerant of malformed heartbeats (a supervisor must never crash on what
    a dying child managed to write)."""
    hb = (state or {}).get("heartbeat")
    if not isinstance(hb, dict):
        return None, None
    section = hb.get("section")
    try:
        ts = float(hb["ts"])
    except (KeyError, TypeError, ValueError):
        ts = None
    return section, ts


def staleness_s(state: Dict[str, Any], now: Optional[float] = None,
                floor_ts: Optional[float] = None) -> Optional[float]:
    """Seconds since the last beat — the supervisor's hang signal.

    `floor_ts` (typically the child's spawn time) bounds the age from below:
    a stale heartbeat inherited from a killed predecessor must not get a
    fresh child SIGKILLed before it can write its own. Returns None only when there is neither
    a heartbeat nor a floor to time against.
    """
    _, ts = last_beat(state)
    candidates = [t for t in (ts, floor_ts) if t is not None]
    if not candidates:
        return None
    if now is None:
        now = time.time()
    return max(0.0, now - max(candidates))


def is_stale(state: Dict[str, Any], timeout_s: float,
             now: Optional[float] = None,
             floor_ts: Optional[float] = None) -> bool:
    """True when the heartbeat is older than `timeout_s` (False when no age
    can be computed at all — absence of evidence is not a hang)."""
    age = staleness_s(state, now=now, floor_ts=floor_ts)
    return age is not None and age > timeout_s


class Heartbeat:
    """Periodic liveness writer for one run.

    Owns its state dict (merged over any existing file so a respawned
    process keeps prior keys) and optionally mirrors each beat — plus a
    device-memory snapshot — into an :class:`EventLog`.
    """

    def __init__(self, path, events: Optional[EventLog] = None):
        self.path = Path(path)
        self.events = events
        self.state = read_state(self.path)

    def beat(self, section: str, memory: bool = False, **extra: Any) -> None:
        """Record liveness in `section` (plus any `extra` state keys);
        ``memory=True`` additionally snapshots aggregated device memory
        into the state file (``device_memory``) and the event log (a
        ``memory`` event): host-side counter reads only, no device sync."""
        if extra:
            self.state.update(extra)
        if memory:
            from .memory import log_memory  # deferred: see module docstring

            snap = log_memory(self.events, section=section)
            self.state["device_memory"] = {
                "n_devices": snap["n_devices"], "totals": snap["totals"],
            }
        beat(self.path, self.state, section)
        if self.events is not None:
            self.events.emit("heartbeat", section)

    @property
    def section(self) -> Optional[str]:
        return (self.state.get("heartbeat") or {}).get("section")
