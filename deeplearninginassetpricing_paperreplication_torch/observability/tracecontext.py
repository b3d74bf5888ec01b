"""W3C-style request trace context for the serving plane.

One request gets ONE 128-bit trace id for its whole life — generated at
the edge (the load generator, or the server when a client sends nothing)
and carried in the standard ``traceparent`` header::

    traceparent: 00-<32 hex trace id>-<16 hex parent span id>-<2 hex flags>

The id is REUSED across retries: a request killed with one replica and
retried against another is one trace with two server-side spans. Each hop
mints a fresh 64-bit span id; the previous hop's span id rides along as
``parent_id``.

Sampling: ``DLAP_TRACE_SAMPLE`` (a ratio in [0, 1], default 1.0) decides
whether a request emits its full ``request`` event row (segment timings,
trace ids — the per-request truth) or only the pre-existing aggregate
``span_end`` row. The decision is DETERMINISTIC in the trace id
(trace-id-ratio sampling), so every retry of one request — and every
replica that serves it — agrees on whether it is traced, and the client's
flag (``01`` sampled / ``00`` not) is honored when a header arrives.

Malformed headers are never an error: :func:`parse_traceparent` returns
``None`` and the server starts a fresh context — a bad client header must
not be able to 500 the hot path.

Stdlib-only by contract (like ``metrics.py``/``heartbeat.py``). The
port's copy of the JAX package's ``observability/tracecontext.py``: both
parse and format one header identically.
"""

from __future__ import annotations

import os
import re
import secrets
from typing import Optional, Tuple

ENV_SAMPLE = "DLAP_TRACE_SAMPLE"

TRACEPARENT_HEADER = "traceparent"

# version "00" only; future versions parse tolerantly (trailing fields
# ignored) per the W3C spec's forward-compatibility rule
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})"
    r"(?:-[^\s]*)?$")

FLAG_SAMPLED = 0x01


def new_trace_id() -> str:
    """128 random bits, lowercase hex. The all-zero id is invalid per
    spec; secrets.token_hex cannot realistically produce it, but guard
    anyway — a zero id would be dropped by every parser downstream."""
    tid = secrets.token_hex(16)
    return tid if int(tid, 16) else new_trace_id()


def new_span_id() -> str:
    sid = secrets.token_hex(8)
    return sid if int(sid, 16) else new_span_id()


def parse_traceparent(header) -> Optional[Tuple[str, str, int]]:
    """``(trace_id, parent_span_id, flags)`` from a ``traceparent`` header
    value, or ``None`` for anything malformed (wrong shape, uppercase hex,
    all-zero ids, non-string): the caller starts a fresh context."""
    if not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip())
    if m is None:
        return None
    version, trace_id, span_id, flags = m.groups()
    if version == "ff":  # forbidden version per spec
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return trace_id, span_id, int(flags, 16)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{FLAG_SAMPLED if sampled else 0:02x}"


def sample_rate() -> float:
    """The configured trace sampling ratio, clamped to [0, 1]."""
    try:
        rate = float(os.environ.get(ENV_SAMPLE, "1.0"))
    except ValueError:
        return 1.0
    return min(1.0, max(0.0, rate))


def trace_sampled(trace_id: str, rate: Optional[float] = None) -> bool:
    """Deterministic trace-id-ratio decision: the top 8 hex digits as a
    fraction of 2^32 against the rate — every process (and every retry)
    computes the same answer for the same trace id."""
    if rate is None:
        rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        return int(trace_id[:8], 16) / 2**32 < rate
    except (ValueError, TypeError):
        return False


class TraceContext:
    """One request's identity at one hop: trace id + this hop's span id +
    the upstream span id (when a header arrived) + the sampling verdict."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled

    @classmethod
    def from_header(cls, header,
                    rate: Optional[float] = None) -> "TraceContext":
        """Continue the client's context, or start a fresh edge context
        when the header is absent/malformed (never raises)."""
        parsed = parse_traceparent(header)
        if parsed is None:
            trace_id = new_trace_id()
            return cls(trace_id, new_span_id(), None,
                       trace_sampled(trace_id, rate))
        trace_id, parent_id, flags = parsed
        # honor an explicit client decision; a client that did not set the
        # sampled flag still gets the deterministic ratio decision so a
        # rate of 1.0 traces everything regardless of client flags
        sampled = bool(flags & FLAG_SAMPLED) or trace_sampled(trace_id, rate)
        return cls(trace_id, new_span_id(), parent_id, sampled)

    def header(self) -> str:
        return format_traceparent(self.trace_id, self.span_id, self.sampled)
