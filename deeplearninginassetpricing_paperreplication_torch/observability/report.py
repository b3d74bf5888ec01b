"""Run-report helpers. The port holds only the latency summary that the
serving ``/metrics`` endpoint uses, copied from the JAX package's
``observability/report.py``; the rest of that report CLI is not ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict


def latency_percentiles_ms(latencies_s, pcts=(50, 95, 99)) -> Any:
    """Nearest-rank percentiles in milliseconds — the one latency summary
    of the serving ``/metrics`` endpoint. Pure stdlib. Returns None for an
    empty series."""
    if not latencies_s:
        return None
    s = sorted(latencies_s)
    out: Dict[str, Any] = {"count": len(s)}
    for p in pcts:
        idx = min(len(s) - 1, max(0, math.ceil(p / 100 * len(s)) - 1))
        out[f"p{p}_ms"] = round(s[idx] * 1e3, 3)
    return out
