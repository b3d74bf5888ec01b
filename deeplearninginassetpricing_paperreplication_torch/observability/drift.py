"""Data-drift detection: reference profiles + PSI/KS scoring.

The port's copy of the JAX package's numpy-only ``observability/drift.py``
(the same profile document, so either package's profile scores the
other's panels). A **reference profile** is a compact per-series sketch of
the panel a model was estimated on: for every firm characteristic
(mask-weighted over the [T, N] panel) and every macro series, moments plus
a fixed-probability quantile sketch. The train CLI writes it into the run
dir before training (``reference_profile.json``, through the port's
:mod:`reliability.verified`), so every candidate the promotion gate sees
carries the fingerprint of the data it learned from.

Later panels are scored against the profile with the **population
stability index** (PSI, on the profile's own quantile bins, expected mass
uniform by construction) and a quantile-sketch **KS** statistic. The
standard PSI reading applies: < 0.1 stable, 0.1–0.25 moderate shift,
> 0.25 drifted; 0.25 is the default rejection threshold of the promotion
gate's ``data_drift``.

numpy only (no torch, no device).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

PROFILE_FILENAME = "reference_profile.json"
N_QUANTILES = 16  # interior quantile edges → N_QUANTILES + 1 PSI bins
DEFAULT_PSI_THRESHOLD = 0.25  # the standard "significant shift" PSI bar
# below this many scored samples PSI/KS are statistically meaningless
# (PSI sampling noise ≈ χ²(bins−1)/n even with zero drift) — the series
# scores as None and drops out of the aggregates instead of alerting on
# noise (e.g. a 3-month refit window's macro series)
MIN_SAMPLES = 32
_EPS = 1e-6


def series_profile(values: np.ndarray) -> Dict[str, Any]:
    """Sketch one series: moments + interior quantile edges. Non-finite
    entries are dropped (and counted via ``finite_fraction``); an empty or
    constant series degrades gracefully (edges collapse; PSI then scores
    any mass off the single point)."""
    v = np.asarray(values, np.float64).ravel()
    finite = v[np.isfinite(v)]
    frac = float(finite.size / v.size) if v.size else 0.0
    if finite.size == 0:
        return {"n": 0, "finite_fraction": frac, "mean": None, "std": None,
                "min": None, "max": None, "quantiles": []}
    probs = np.linspace(0.0, 1.0, N_QUANTILES + 1)[1:-1]
    return {
        "n": int(finite.size),
        "finite_fraction": round(frac, 6),
        "mean": float(finite.mean()),
        "std": float(finite.std()),
        "min": float(finite.min()),
        "max": float(finite.max()),
        "quantiles": [float(q) for q in np.quantile(finite, probs)],
    }


def reference_profile(panel: Dict[str, Any],
                      source: Optional[str] = None) -> Dict[str, Any]:
    """Profile a panel dict (``individual`` [T, N, F] + ``mask`` [T, N],
    optional ``macro`` [T, M]) into the JSON-serializable reference
    document. Characteristic j's sketch covers only mask-valid entries —
    padded stocks must not flatten the distribution."""
    individual = np.asarray(panel["individual"], np.float64)
    mask = np.asarray(panel.get("mask"), np.float64) \
        if panel.get("mask") is not None else np.ones(individual.shape[:2])
    valid = mask > 0
    features = [series_profile(individual[..., j][valid])
                for j in range(individual.shape[-1])]
    macro = []
    if panel.get("macro") is not None:
        m = np.asarray(panel["macro"], np.float64)
        macro = [series_profile(m[:, j]) for j in range(m.shape[1])]
    return {
        "kind": "reference_profile",
        "schema": 1,
        "written_at": round(time.time(), 3),
        "source": source,
        "n_periods": int(individual.shape[0]),
        "n_stocks": int(individual.shape[1]),
        "individual": features,
        "macro": macro,
    }


def _bin_edges(entry: Dict[str, Any]) -> Optional[np.ndarray]:
    q = entry.get("quantiles") or []
    if not q:
        return None
    return np.asarray(q, np.float64)


def psi(entry: Dict[str, Any], values: np.ndarray) -> Optional[float]:
    """Population stability index of ``values`` against one series
    sketch. Bins are the sketch's quantile edges (open-ended outer bins),
    so the expected mass per bin is uniform by construction; duplicate
    edges (near-constant reference series) merge, with their expected
    mass. None when either side has no data."""
    edges = _bin_edges(entry)
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if edges is None or v.size < MIN_SAMPLES:
        return None
    if entry.get("min") == entry.get("max"):
        # degenerate (constant) reference series: quantile bins cannot
        # discriminate, so score the mass that moved OFF the point
        # through the same eps-clamped PSI formula (0 when the series is
        # still constant at that value, large when it moved)
        ref = float(entry["mean"])
        tol = 1e-9 * max(1.0, abs(ref))
        off = float(np.mean(np.abs(v - ref) > tol))
        a = np.clip(np.asarray([1.0 - off, off]), _EPS, None)
        e = np.clip(np.asarray([1.0, 0.0]), _EPS, None)
        return float(((a - e) * np.log(a / e)).sum())
    # adapt the bin count to the scored sample: PSI over b bins has
    # sampling noise ≈ χ²(b−1)/n even with zero drift, so a single serving
    # request's ~few-hundred-stock cross-section is scored on a coarser
    # subset of the quantile edges (≥ ~32 samples per bin, floor 4 bins) —
    # a full panel still scores at the sketch's full resolution
    n_bins = edges.size + 1
    target = max(4, min(n_bins, v.size // 32))
    if target < n_bins:
        keep = np.round(np.arange(1, target) * n_bins / target).astype(int)
        edges_used = edges[np.clip(keep - 1, 0, edges.size - 1)]
    else:
        edges_used = edges
    # merge duplicate edges (near-constant reference series): the expected
    # CDF at each unique edge pools the uniform mass of every degenerate
    # bin that collapsed onto it
    uniq = np.unique(edges_used)
    cdf = np.searchsorted(edges, uniq, side="right") / n_bins
    expected = np.diff(np.concatenate(([0.0], cdf, [1.0])))
    # actual histogram over (-inf, uniq[0]], (uniq[0], uniq[1]], ..., +inf)
    idx = np.searchsorted(uniq, v, side="right")
    actual = np.bincount(idx, minlength=uniq.size + 1) / v.size
    a = np.clip(actual, _EPS, None)
    e = np.clip(expected, _EPS, None)
    return float(((a - e) * np.log(a / e)).sum())


def ks_stat(entry: Dict[str, Any], values: np.ndarray) -> Optional[float]:
    """Quantile-sketch Kolmogorov–Smirnov statistic: the max gap between
    the values' empirical CDF at the sketch's quantile edges and the
    reference CDF those edges encode (i/(n_bins) by construction)."""
    edges = _bin_edges(entry)
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if edges is None or v.size == 0:
        return None
    if v.size < MIN_SAMPLES:
        return None
    uniq = np.unique(edges)
    n_bins = edges.size + 1
    ref_cdf = np.searchsorted(edges, uniq, side="right") / n_bins
    emp_cdf = np.searchsorted(np.sort(v), uniq, side="right") / v.size
    return float(np.abs(emp_cdf - ref_cdf).max())


def drift_report(profile: Dict[str, Any],
                 panel: Dict[str, Any]) -> Dict[str, Any]:
    """Score a whole panel against a reference profile: per-feature and
    per-macro-series PSI + KS, with the max/mean aggregates the gate and
    the serving monitors threshold on."""
    individual = np.asarray(panel["individual"], np.float64)
    mask = np.asarray(panel.get("mask"), np.float64) \
        if panel.get("mask") is not None else np.ones(individual.shape[:2])
    valid = mask > 0
    per: Dict[str, Dict[str, Any]] = {}
    for j, entry in enumerate(profile.get("individual") or []):
        if j >= individual.shape[-1]:
            break
        vals = individual[..., j][valid]
        per[f"char{j}"] = {"psi": psi(entry, vals),
                           "ks": ks_stat(entry, vals)}
    if panel.get("macro") is not None:
        m = np.asarray(panel["macro"], np.float64)
        for j, entry in enumerate(profile.get("macro") or []):
            if j >= m.shape[1]:
                break
            per[f"macro{j}"] = {"psi": psi(entry, m[:, j]),
                                "ks": ks_stat(entry, m[:, j])}
    psis = [d["psi"] for d in per.values() if d["psi"] is not None]
    kss = [d["ks"] for d in per.values() if d["ks"] is not None]
    return {
        "per_series": per,
        "n_series": len(per),
        "max_psi": round(max(psis), 6) if psis else None,
        "mean_psi": round(sum(psis) / len(psis), 6) if psis else None,
        "max_ks": round(max(kss), 6) if kss else None,
    }


def score_request(profile: Dict[str, Any], individual: np.ndarray,
                  mask: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Score ONE serving request's [N, F] characteristics matrix against
    the profile — the serving-time drift monitor's unit of work."""
    ind = np.asarray(individual, np.float64)
    m = (np.ones(ind.shape[0]) if mask is None
         else np.asarray(mask, np.float64))
    return drift_report(profile, {"individual": ind[None],
                                  "mask": m[None]})


# -- artifact IO (reliability.verified; tolerant reads) ----------------------


def write_profile(run_dir: Union[str, Path],
                  profile: Dict[str, Any]) -> Path:
    """Verified write of ``reference_profile.json`` into a run dir."""
    from ..reliability.verified import write_verified

    path = Path(run_dir) / PROFILE_FILENAME
    write_verified(path, json.dumps(profile, indent=1).encode())
    return path


def read_profile(run_dir: Union[str, Path]) -> Optional[Dict[str, Any]]:
    """Digest-verified read (generation fallback included); also accepts a
    direct path to the JSON file. None when absent or unusable — a missing
    profile disables drift scoring, it must never fail a run."""
    from ..reliability.verified import load_verified, verified_exists

    root = Path(run_dir)
    path = root if root.suffix == ".json" else root / PROFILE_FILENAME
    if not verified_exists(path):
        # tolerate a plain (sidecar-less) file: externally produced profiles
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            return None
    try:
        profile, _ = load_verified(path, lambda b: json.loads(b.decode()))
    except (ValueError, OSError):
        return None
    return profile if isinstance(profile, dict) else None
