"""Model-health artifacts: ``health.json`` per run dir and the gate's
threshold classification.

The counterpart of the JAX package's ``observability/modelhealth.py``. The
diagnostics themselves live in :mod:`ops.diagnostics` (member-stacked
torch functions); this module is the host-side plumbing around them:

  * :func:`compute_health` — one diagnostics pass over (params, batch) →
    the plain-float health document (per-moment violation norms, SDF
    series stats, portfolio concentration and turnover, adversarial gap,
    the last in-training readings);
  * :func:`write_health` / :func:`read_health` — the verified
    ``health.json`` every training run dir carries (atomic write + sha256
    sidecar; a run dir without one reads as None);
  * :func:`candidate_diagnostics` — one S-member diagnostics call reduced
    to the worst case over members, which the promotion gate thresholds
    (``moment_violation``);
  * :class:`HealthThresholds` — the configurable bars, with
    :meth:`~HealthThresholds.classify` returning stable reason slugs.

``guard_trips`` and ``divergence_trips`` come from the trainer's divergence
guard (``reliability/guard.py``): the count and the (phase, start epoch,
end epoch) segments it rolled back. The JAX package's
``bench_health_overhead`` waits for the port's bench.

Module level stays stdlib-only: the gate and thin readers load
``health.json`` without importing torch; torch loads inside the compute
functions.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

HEALTH_FILENAME = "health.json"

# default gate bars. moment_tolerance is deliberately generous: the point of
# the default is catching DEGENERATE candidates (NaN/Inf violations or
# order-of-magnitude blowups), not re-litigating the loss the trainer
# already minimized
DEFAULT_MOMENT_TOLERANCE = 1.0
DEFAULT_MIN_FINITE_FRACTION = 1.0


def _finite_or_none(x: Any) -> Optional[float]:
    try:
        v = float(x)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


@dataclasses.dataclass(frozen=True)
class HealthThresholds:
    """The promotion gate's model-health bars: the worst per-moment
    violation and the SDF series' finite fraction. (The JAX package's HHI
    and turnover bars wait for the port's report tooling.)"""

    moment_tolerance: float = DEFAULT_MOMENT_TOLERANCE
    min_sdf_finite_fraction: float = DEFAULT_MIN_FINITE_FRACTION

    def classify(self, diagnostics: Dict[str, Any]) -> List[str]:
        """Stable violation slugs for one diagnostics dict (empty =
        healthy). Non-finite values always violate."""
        reasons: List[str] = []
        mv = diagnostics.get("moment_violation_max")
        if _finite_or_none(mv) is None or float(mv) > self.moment_tolerance:
            reasons.append("moment_violation")
        frac = diagnostics.get("sdf_finite_frac")
        if (_finite_or_none(frac) is None
                or float(frac) < self.min_sdf_finite_fraction):
            if "moment_violation" not in reasons:
                reasons.append("moment_violation")
        return reasons


# -- computing health (lazy torch) -------------------------------------------


def _member_diagnostics(gan, stacked, batch) -> Dict[str, Any]:
    """:func:`ops.diagnostics.diagnostics_members` of member-stacked params,
    as NumPy arrays ([S] scalars, [S, K] violations)."""
    from ..ops.diagnostics import diagnostics_members

    out = diagnostics_members(gan, stacked, batch)
    return {k: v.cpu().numpy() for k, v in out.items()}


def compute_diagnostics_host(gan, params, batch) -> Dict[str, Any]:
    """One diagnostics pass over one model's ``state_dict`` `params` →
    plain Python floats (``moment_violations`` as a list)."""
    host = _member_diagnostics(gan, {k: v[None] for k, v in params.items()},
                               batch)
    result: Dict[str, Any] = {k: float(v[0]) for k, v in host.items()
                              if v.ndim == 1}
    result["moment_violations"] = [
        float(x) for x in host["moment_violations"][0]]
    return result


def candidate_diagnostics(gan, vparams, batch) -> Dict[str, Any]:
    """Diagnostics of a member-stacked candidate ensemble [S, ...] in one
    S-member call, reduced to the WORST case over members (the gate must
    reject if any member is degenerate): per-moment violations max over
    members, min finite fraction, max HHI and turnover. Adds
    ``per_member_violation_max`` for the audit trail."""
    host = _member_diagnostics(gan, vparams, batch)
    worst_max = ("moment_violation_max", "unc_violation", "adv_gap",
                 "weight_hhi", "weight_max_abs", "short_fraction",
                 "turnover", "loss_unc", "loss_cond", "sdf_vol")
    out: Dict[str, Any] = {}
    for k in worst_max:
        out[k] = float(host[k].max())
    out["sdf_finite_frac"] = float(host["sdf_finite_frac"].min())
    out["sdf_mean"] = float(host["sdf_mean"].mean())
    out["sdf_min"] = float(host["sdf_min"].min())
    out["moment_violations"] = [
        float(x) for x in host["moment_violations"].max(axis=0)]
    out["per_member_violation_max"] = [
        float(x) for x in host["moment_violation_max"]]
    return out


def compute_health(
    gan,
    params,
    batch,
    history: Optional[Dict[str, Any]] = None,
    guard_trips: Optional[List] = None,
    split: str = "valid",
    diag_stride: Optional[int] = None,
) -> Dict[str, Any]:
    """The ``health.json`` document (schema 1) of one trained model: final
    diagnostics of the ``state_dict`` `params` on `batch`, plus the run's
    health counters (divergence-guard trips, and the last in-training
    diagnostic readings when the run trained with ``diag_stride``)."""
    import numpy as np

    diagnostics = compute_diagnostics_host(gan, params, batch)
    finite = all(
        v is not None and math.isfinite(v)
        for v in diagnostics.values() if isinstance(v, float)
    ) and all(math.isfinite(x) for x in diagnostics["moment_violations"])
    doc: Dict[str, Any] = {
        "kind": "model_health",
        "schema": 1,
        "written_at": round(time.time(), 3),
        "split": split,
        "diag_stride": diag_stride,
        "diagnostics": diagnostics,
        "finite": bool(finite),
        "guard_trips": len(guard_trips or []),
        "divergence_trips": [[int(p), int(s), int(e)]
                             for p, s, e in (guard_trips or [])],
    }
    if history and "diag_computed" in history:
        # ONE history row for every series: the last stride epoch that
        # computed (the diag_computed sentinel; a value field can be 0.0
        # there). Rows cover phases 1 and 3 only, so a phase-3 row's
        # absolute epoch is row + num_epochs_moment
        computed = np.nonzero(
            np.asarray(history["diag_computed"], np.float64))[0]
        if computed.size:
            idx = int(computed[-1])
            last: Dict[str, Any] = {"history_row": idx}
            for key, series in history.items():
                if (not key.startswith("diag_")
                        or key in ("diag_moment_violations",
                                   "diag_computed")):
                    continue
                arr = np.asarray(series, np.float64)
                if arr.ndim == 1 and arr.size > idx:
                    last[key] = float(arr[idx])
            doc["history_last"] = last
    return doc


# -- artifact IO -------------------------------------------------------------


def write_health(run_dir: Union[str, Path],
                 health: Dict[str, Any]) -> Path:
    """Verified write of ``health.json`` (non-finite floats as null: the
    artifact stays strict JSON)."""
    from ..reliability.verified import write_verified

    def sanitize(obj):
        if isinstance(obj, float) and not math.isfinite(obj):
            return None
        if isinstance(obj, dict):
            return {k: sanitize(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [sanitize(v) for v in obj]
        return obj

    path = Path(run_dir) / HEALTH_FILENAME
    write_verified(path, json.dumps(sanitize(health), indent=1).encode())
    return path


def read_health(run_dir: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """Digest-verified read of a run dir's ``health.json`` (a plain file
    without a sidecar is parsed as it is); None when absent or unusable."""
    from ..reliability.verified import load_verified, verified_exists

    path = Path(run_dir) / HEALTH_FILENAME
    if not verified_exists(path):
        return None
    try:
        doc, _ = load_verified(path, lambda b: json.loads(b.decode()))
    except (ValueError, OSError):
        return None
    return doc if isinstance(doc, dict) else None
