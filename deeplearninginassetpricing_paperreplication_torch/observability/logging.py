"""Process-aware structured logging: one human stream, N event streams.

The port's copy of the JAX package's ``observability/logging.py``. On a
multi-process run every worker printing the same progress line turns
stdout into noise; the contract here is that only ``process_index == 0``
emits human-readable lines, while EVERY process records the same message as
a structured ``log`` event in its own ``events.jsonl``. Library code asks
for the active logger (:func:`get_run_logger`) instead of calling
``print`` — the CLI decides once, at startup, where the sink lives
(:func:`set_run_logger`).

Module level stays stdlib-only.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Optional

from .events import EventLog


class RunLogger:
    """info/warning logger gated to process 0, mirrored into an EventLog."""

    def __init__(self, events: Optional[EventLog] = None, verbose: bool = True):
        self.events = events if events is not None else EventLog()
        self.verbose = verbose

    @property
    def is_primary(self) -> bool:
        return self.events.process_index == 0

    def info(self, msg: str, verbose: Optional[bool] = None, **fields: Any):
        self.events.log(msg, level="info", **fields)
        if (self.verbose if verbose is None else verbose) and self.is_primary:
            print(msg, flush=True)

    def warning(self, msg: str, **fields: Any):
        # warnings print regardless of verbosity (still process-0 only);
        # worker processes keep theirs in their own events file
        self.events.log(msg, level="warning", **fields)
        if self.is_primary:
            print(f"WARNING: {msg}", file=sys.stderr, flush=True)


_lock = threading.Lock()
_active: Optional[RunLogger] = None


def get_run_logger() -> RunLogger:
    """The process-wide active logger (a sinkless process-0-gated printer
    until a CLI installs a real one)."""
    global _active
    with _lock:
        if _active is None:
            _active = RunLogger()
        return _active


def set_run_logger(logger: RunLogger) -> RunLogger:
    """Install the active logger (CLI startup); returns it for chaining."""
    global _active
    with _lock:
        _active = logger
    return logger
