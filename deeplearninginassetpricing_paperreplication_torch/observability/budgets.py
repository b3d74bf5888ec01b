"""Declarative perf budgets: the machine-enforced guard over BENCH_*.

Copied from the JAX package's ``observability/budgets.py``; the schema,
the bounds and the failure rules are that module's.

A budget file (the repo ships ``budgets.json``) declares per-metric bounds
with tolerances::

    {
      "schema": 1,
      "budgets": [
        {"name": "serving_async_c32_rps",
         "file": "BENCH_SERVING.json",
         "metric": "async_replicated.closed_loop_c32_bin.throughput_rps",
         "min": 457.77, "tolerance": 0.20},
        {"name": "serving_recompiles",
         "file": "BENCH_SERVING.json",
         "metric": "async_replicated.steady_state_recompiles.replica0",
         "equals": 0},
        {"name": "train_epochs_per_s",
         "metric": "phases.phase3_conditional.epochs_per_s",
         "min": 2.0, "tolerance": 0.25}
      ]
    }

Each entry names a dotted ``metric`` path (list indices allowed:
``trials.0.p99_ms``) into either a JSON artifact (``file``, resolved
relative to the budget file — the checked-in ``BENCH_*.json`` trajectory)
or, when ``file`` is absent, the report CLI's run-dir summary. Bounds:

  * ``min``: pass when ``value >= min * (1 - tolerance)``;
  * ``max``: pass when ``value <= max * (1 + tolerance)``;
  * ``equals``: pass when ``abs(value - equals) <= tolerance`` (absolute —
    the canonical use is ``steady_state_recompiles == 0``, where a
    relative band around zero would be vacuous).

A missing file, unresolvable metric path, or non-numeric value FAILS the
entry — a regression gate that can silently skip is not a gate. Exposed as
``report --budget budgets.json [run_dirs...]`` (exit non-zero on any
failure) and wrapped by ``tools/check_budgets.py`` for tier-1.

Pure stdlib; no torch import anywhere on this path.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

BUDGET_SCHEMA_VERSION = 1


class BudgetSpecError(ValueError):
    """The budget file itself is malformed (a broken gate must fail loudly,
    not pass vacuously)."""


def load_budgets(path) -> Dict[str, Any]:
    """Read + validate a budget file; raises :class:`BudgetSpecError` on
    any malformation."""
    path = Path(path)
    try:
        spec = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise BudgetSpecError(f"budget file unreadable: {path}: {e}") from e
    entries = spec.get("budgets")
    if not isinstance(entries, list) or not entries:
        raise BudgetSpecError(
            f"{path}: 'budgets' must be a non-empty list of entries")
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise BudgetSpecError(f"{path}: budgets[{i}] is not an object")
        where = f"{path}: budgets[{i}] ({e.get('name', '?')})"
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise BudgetSpecError(f"{where}: requires a 'name'")
        if not isinstance(e.get("metric"), str) or not e["metric"]:
            raise BudgetSpecError(f"{where}: requires a 'metric' path")
        bounds = [k for k in ("min", "max", "equals") if k in e]
        if not bounds:
            raise BudgetSpecError(
                f"{where}: requires at least one of min/max/equals")
        for k in bounds:
            if not isinstance(e[k], (int, float)):
                raise BudgetSpecError(f"{where}: '{k}' must be a number")
        tol = e.get("tolerance", 0)
        if not isinstance(tol, (int, float)) or tol < 0:
            raise BudgetSpecError(
                f"{where}: 'tolerance' must be a non-negative number")
    return spec


def resolve_metric(doc: Any, dotted: str) -> Any:
    """Walk a dotted path (dict keys / list indices) through a JSON doc.
    Raises KeyError naming the first segment that fails to resolve."""
    cur = doc
    walked: List[str] = []
    for seg in dotted.split("."):
        walked.append(seg)
        if isinstance(cur, dict) and seg in cur:
            cur = cur[seg]
        elif isinstance(cur, list) and seg.lstrip("-").isdigit() \
                and -len(cur) <= int(seg) < len(cur):
            cur = cur[int(seg)]
        else:
            raise KeyError(
                f"metric path {dotted!r} failed at {'.'.join(walked)!r}")
    return cur


def check_entry(entry: Dict[str, Any], doc: Any,
                source: str) -> Dict[str, Any]:
    """One budget entry against one metric document → the check record."""
    out: Dict[str, Any] = {
        "name": entry["name"], "metric": entry["metric"], "source": source,
    }
    tol = float(entry.get("tolerance", 0))
    try:
        value = resolve_metric(doc, entry["metric"])
    except KeyError as e:
        out.update(ok=False, reason=f"missing metric: {e.args[0]}")
        return out
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        out.update(ok=False,
                   reason=f"metric is not a number: {value!r}")
        return out
    value = float(value)
    out["value"] = value
    ok = True
    reasons: List[str] = []
    if "min" in entry:
        floor = float(entry["min"]) * (1.0 - tol)
        out["min_allowed"] = round(floor, 6)
        if value < floor:
            ok = False
            reasons.append(
                f"{value:g} < min {entry['min']:g} (tolerance {tol:g} "
                f"-> floor {floor:g})")
    if "max" in entry:
        ceil = float(entry["max"]) * (1.0 + tol)
        out["max_allowed"] = round(ceil, 6)
        if value > ceil:
            ok = False
            reasons.append(
                f"{value:g} > max {entry['max']:g} (tolerance {tol:g} "
                f"-> ceiling {ceil:g})")
    if "equals" in entry:
        target = float(entry["equals"])
        if abs(value - target) > tol:
            ok = False
            reasons.append(
                f"{value:g} != {target:g} (abs tolerance {tol:g})")
    out["ok"] = ok
    if reasons:
        out["reason"] = "; ".join(reasons)
    return out


def check_budgets(
    budget_path,
    run_summaries: Optional[Dict[str, Dict[str, Any]]] = None,
    file_overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Run the whole gate: ``file`` entries against their JSON artifacts
    (relative to the budget file), run-scoped entries against every run
    summary given. ``file_overrides`` maps a budget entry's ``file`` name
    to an actual path — how ``bench.py --check_budgets --out X`` gates the
    artifact it JUST wrote instead of the checked-in copy. Returns
    ``{"ok": bool, "checks": [...]}`` — ``ok`` only when EVERY check
    passed; run-scoped entries with no run dir to check against fail (the
    gate never silently skips)."""
    budget_path = Path(budget_path)
    spec = load_budgets(budget_path)
    run_summaries = run_summaries or {}
    file_overrides = file_overrides or {}
    checks: List[Dict[str, Any]] = []
    file_docs: Dict[str, Any] = {}
    for entry in spec["budgets"]:
        file_rel = entry.get("file")
        if file_rel:
            if file_rel not in file_docs:
                fpath = Path(file_overrides.get(
                    file_rel, budget_path.parent / file_rel))
                try:
                    file_docs[file_rel] = json.loads(fpath.read_text())
                except (OSError, json.JSONDecodeError) as e:
                    file_docs[file_rel] = BudgetSpecError(
                        f"artifact unreadable: {fpath}: {e}")
            doc = file_docs[file_rel]
            if isinstance(doc, BudgetSpecError):
                checks.append({
                    "name": entry["name"], "metric": entry["metric"],
                    "source": file_rel, "ok": False, "reason": str(doc),
                })
            else:
                checks.append(check_entry(entry, doc, file_rel))
        elif run_summaries:
            for run_dir, summary in sorted(run_summaries.items()):
                checks.append(check_entry(entry, summary, run_dir))
        else:
            checks.append({
                "name": entry["name"], "metric": entry["metric"],
                "source": "<run dir>", "ok": False,
                "reason": "run-scoped budget but no run dir was given",
            })
    return {"ok": all(c["ok"] for c in checks),
            "budget_file": str(budget_path),
            "checks": checks}


def format_budget_report(result: Dict[str, Any]) -> str:
    """Human-readable gate output, one line per check."""
    lines = [f"budget gate: {result['budget_file']} — "
             + ("PASS" if result["ok"] else "REGRESSION")]
    for c in result["checks"]:
        status = "ok  " if c["ok"] else "FAIL"
        value = f"{c['value']:g}" if "value" in c else "n/a"
        line = (f"  [{status}] {c['name']}: {c['source']}:{c['metric']}"
                f" = {value}")
        if not c["ok"]:
            line += f"  ({c.get('reason', 'failed')})"
        lines.append(line)
    return "\n".join(lines)
