"""Cross-plane ops console: one view over pointer, fleet, autoscaler,
ledger, model health, probes, and SLO alerts (the port's copy of the JAX
package's ``observability/statusboard.py``).

Every plane reports through its own artifact family — the promotion
pointer, ``fleet.json`` + autoscaler events, the refit ledger,
health/drift counters, probe/alert rows. During an
incident nobody has time to join six files by hand; ``python -m ….ops``
does the join:

  * ``status`` — the CURRENT posture: pointer head + per-replica serving
    generation, fleet layout, autoscaler scale counts, refit/ledger
    coverage, health/drift/canary counters, SLO budget burn and firing
    alerts, probe totals.
  * ``timeline`` — the recent HISTORY: promotions, rollbacks, scale
    events, hot-swaps, canary verdicts, probe failures, and alert
    transitions from the run dir's whole event-file family, merged on the
    trace clock alignment (per-(file, run_id) ``median(ts - mono)``
    anchors), so cross-process order is wall-true.

Both commands are BYTE-DETERMINISTIC: they read only on-disk artifacts
(event files, ``fleet.json``, the pointer, heartbeat files — raw recorded
timestamps, never ages against "now"), so two invocations over the same
run dir print identical bytes, and ``--json`` emits a machine document a
pager bot can diff. Strictly read-only file access — no live scrapes, no
device init (the package import itself is the only weight) — so it is
safe to point at a LIVE run dir from any box with the filesystem mounted.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

from .heartbeat import read_state
from .trace import _aligned_ts, _group_offsets, read_jsonl, trace_file_paths

# counter-row names that belong on the operations timeline (kind "alert"
# and kind "probe" rows are always included)
TIMELINE_COUNTERS = frozenset({
    "promote/advance",
    "promote/reject",
    "promote/rollback",
    "promote/fleet_rollback",
    "promote/fleet_rollback_failed",
    "promote/fleet_converged",
    "fleet/scale",
    "supervise/death",
    "supervise/restart",
    "supervise/outcome",
    "serve/generation",
    "serve/canary",
    "serve/drain",
    "serve/flightrecorder",
    "sweep/lease_takeover",
    "sweep/quarantine",
    "guard/trip",
    "fault/injected",
    "model/drift_alert",
    "probe/digest_change",
    "probe/layout_unreadable",
})

# bounded per-row detail: the keys worth a timeline column, in render order
_DETAIL_KEYS = (
    "objective", "window", "severity", "state", "burn_long", "burn_short",
    "target", "error", "consecutive", "direction", "reason", "replica",
    "generation", "pointer_generation", "fingerprint", "swapped", "site",
    "action", "section", "rc", "outcome", "max_weight_delta",
    "max_sdf_delta", "finite", "month",
)


def _fmt_val(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _detail(row: Dict[str, Any]) -> str:
    parts = [f"{k}={_fmt_val(row[k])}" for k in _DETAIL_KEYS
             if row.get(k) is not None]
    return " ".join(parts)


# -- the SLO-posture scan (shared with report._slo_summary) ------------------


def scan_slo_rows(rows) -> Dict[str, Any]:
    """ONE walk over event rows extracting the SLO plane's posture: the
    last alert transition per (objective, window) (which decides
    firing/resolved), transition totals, the last burn-rate /
    budget-remaining gauge per key, and the probe counters. The ops
    console and the report CLI both render from THIS scan, so the two
    can never drift on what the rows mean."""
    out: Dict[str, Any] = {
        "last_state": {}, "burn": {}, "budget": {},
        "firings": 0, "resolves": 0,
        "probe_checks": 0, "probe_failures": 0, "digest_changes": 0,
        "layout_unreadable": 0, "failure_targets": {},
    }
    for r in rows:
        kind = r.get("kind")
        name = str(r.get("name", ""))
        if kind == "alert":
            key = (str(r.get("objective")), str(r.get("window")))
            out["last_state"][key] = r
            if name == "alert/firing":
                out["firings"] += 1
            elif name == "alert/resolved":
                out["resolves"] += 1
        elif kind == "probe" and name == "probe/failure":
            out["probe_failures"] += 1
            t = str(r.get("target"))
            out["failure_targets"][t] = (
                out["failure_targets"].get(t, 0) + 1)
        elif kind == "counter":
            if name == "probe/check":
                out["probe_checks"] += int(r.get("value") or 0)
            elif name == "probe/digest_change":
                out["digest_changes"] += int(r.get("value") or 0)
            elif name == "probe/layout_unreadable":
                out["layout_unreadable"] += int(r.get("value") or 0)
        elif kind == "gauge":
            key = (str(r.get("objective")), str(r.get("window")))
            if name == "alert/burn_rate":
                out["burn"][key] = r.get("value")
            elif name == "alert/budget_remaining":
                out["budget"][key] = r.get("value")
    return out


# -- timeline ----------------------------------------------------------------


def gather_timeline(run_dir, limit: Optional[int] = None
                    ) -> List[Dict[str, Any]]:
    """The run dir's operations timeline: selected rows from the whole
    event-file family, wall-aligned (the trace's anchors), deterministically
    ordered (aligned µs, file, seq). ``limit`` keeps only the newest N."""
    run_dir = Path(run_dir)
    rows_out: List[Dict[str, Any]] = []
    t0: Optional[float] = None
    collected = []
    for path in trace_file_paths(run_dir):
        rows = read_jsonl(path)
        offsets = _group_offsets(rows)
        label = str(path.relative_to(run_dir))
        for row in rows:
            kind = row.get("kind")
            name = str(row.get("name", ""))
            if kind in ("alert", "probe"):
                pass
            elif kind == "counter" and name in TIMELINE_COUNTERS:
                pass
            else:
                continue
            at = _aligned_ts(row, offsets)
            if at is None:
                continue
            t0 = at if t0 is None else min(t0, at)
            collected.append((at, label, int(row.get("seq") or 0),
                              kind, name, row))
    collected.sort(key=lambda r: (int(round(r[0] * 1e6)), r[1], r[2],
                                  r[4]))
    for at, label, seq, kind, name, row in collected:
        rows_out.append({
            "t_s": round(int(round((at - t0) * 1e6)) / 1e6, 6),
            "file": label,
            "kind": kind,
            "name": name,
            "detail": _detail(row),
        })
    if limit is not None and limit > 0:
        rows_out = rows_out[-limit:]
    return rows_out


def format_timeline(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return "timeline: (no operations events)"
    lines = [f"timeline ({len(rows)} events, t=0 at first event):"]
    for r in rows:
        detail = f"  {r['detail']}" if r["detail"] else ""
        lines.append(
            f"  +{r['t_s']:12.6f}s  {r['name']:<28} [{r['file']}]{detail}")
    return "\n".join(lines)


# -- status ------------------------------------------------------------------


def _pointer_status(pointer_root) -> Optional[Dict[str, Any]]:
    from ..reliability.promotion import read_pointer

    try:
        pointer = read_pointer(pointer_root)
    except Exception:
        return {"error": "unreadable pointer"}
    if not pointer:
        return None
    return {
        "generation": pointer.get("generation"),
        "params_fingerprint": str(
            pointer.get("params_fingerprint") or "")[:16],
        "source": pointer.get("source"),
        "promoted_at": pointer.get("promoted_at"),
        "members": len(pointer.get("members") or []),
        "history": len(pointer.get("history") or []),
        "rolled_back_from": pointer.get("rolled_back_from"),
    }


def _ledger_status(run_dir: Path,
                   pointer_root) -> Optional[Dict[str, Any]]:
    """Refit/ledger coverage: completed bucket records (and quarantines)
    under a ``sweep_ledger`` next to the run dir or the pointer root."""
    candidates = [run_dir / "sweep_ledger"]
    if pointer_root:
        root = Path(pointer_root)
        if root.name.endswith(".json"):
            root = root.parent
        candidates.append(root / "sweep_ledger")
    for ledger_dir in candidates:
        records = ledger_dir / "records"
        if not records.is_dir():
            continue
        done = sorted(p.name for p in records.glob("*.json")
                      if not p.name.endswith(".sha256"))
        quarantined = sorted(
            p.name for p in ledger_dir.glob("quarantine/*.json"))
        return {"dir": ledger_dir.name, "records": len(done),
                "quarantined": len(quarantined)}
    return None


def _replica_status(run_dir: Path) -> List[Dict[str, Any]]:
    out = []
    for rdir in sorted(run_dir.glob("replica*")):
        if not rdir.is_dir():
            continue
        rows = read_jsonl(rdir / "events.jsonl")
        generation = fingerprint = None
        for row in rows:
            if (row.get("kind") == "counter"
                    and row.get("name") == "serve/generation"):
                generation = row.get("generation")
                fingerprint = row.get("fingerprint")
        hb = read_state(rdir / "heartbeat.json").get("heartbeat") or {}
        sup = read_jsonl(
            run_dir / f"events.supervisor.{rdir.name}.jsonl")
        restarts = sum(1 for r in sup
                       if r.get("kind") == "counter"
                       and r.get("name") == "supervise/restart")
        out.append({
            "replica": rdir.name,
            "generation": generation,
            "fingerprint": fingerprint,
            "heartbeat_section": hb.get("section"),
            "heartbeat_ts": hb.get("ts"),
            "restarts": restarts,
        })
    return out


def _count(rows, kind: str, name: str) -> int:
    return sum(1 for r in rows
               if r.get("kind") == kind and r.get("name") == name)


def gather_status(run_dir, pointer_root=None) -> Dict[str, Any]:
    """The current cross-plane posture of one fleet/serving run dir,
    derived ONLY from on-disk artifacts (byte-deterministic)."""
    run_dir = Path(run_dir)
    from ..serving.fleet import read_fleet_json

    fleet = read_fleet_json(run_dir)
    if pointer_root is None and fleet:
        pointer_root = fleet.get("pointer")
    rows: List[Dict[str, Any]] = []
    for path in trace_file_paths(run_dir):
        rows.extend(read_jsonl(path))

    scale_ups = scale_downs = scale_failed = 0
    replicas_gauge = None
    for r in rows:
        if r.get("name") == "fleet/scale" and r.get("kind") == "counter":
            d = str(r.get("direction") or "")
            if d == "up":
                scale_ups += 1
            elif d == "down":
                scale_downs += 1
            else:
                scale_failed += 1
        elif (r.get("name") == "fleet/replicas"
                and r.get("kind") == "gauge"):
            replicas_gauge = r.get("value")

    # SLO posture from the durable alert rows: the last transition per
    # (objective, window) decides firing/resolved; burn gauges report the
    # last recorded value per (objective, window)
    scan = scan_slo_rows(rows)
    firing = []
    resolved = 0
    for (objective, window), row in sorted(scan["last_state"].items()):
        if row.get("name") == "alert/firing":
            firing.append({
                "objective": objective, "window": window,
                "severity": row.get("severity"),
                "burn_long": row.get("burn_long"),
                "ts": row.get("ts"),
            })
        else:
            resolved += 1
    slo = None
    if (scan["last_state"] or scan["burn"] or scan["probe_checks"]
            or scan["probe_failures"] or scan["layout_unreadable"]):
        slo = {
            "firing": firing,
            "alerts_resolved": resolved,
            "burn_rates": {
                f"{o} {w}": v
                for (o, w), v in sorted(scan["burn"].items())},
            "budget_remaining": {
                f"{o} {w}": v
                for (o, w), v in sorted(scan["budget"].items())},
            "probe": {
                "checks": scan["probe_checks"],
                "failures": scan["probe_failures"],
                "digest_changes": scan["digest_changes"],
                "layout_unreadable": scan["layout_unreadable"],
            },
        }

    health = None
    drift_alerts = _count(rows, "counter", "model/drift_alert")
    canaries = [r for r in rows
                if r.get("kind") == "counter"
                and r.get("name") == "serve/canary"]
    guard_trips = _count(rows, "counter", "guard/trip")
    if drift_alerts or canaries or guard_trips:
        last = canaries[-1] if canaries else {}
        health = {
            "drift_alerts": drift_alerts,
            "canary_swaps": len(canaries),
            "last_canary": {
                k: last.get(k) for k in
                ("max_weight_delta", "max_sdf_delta", "finite")
                if last.get(k) is not None} or None,
            "guard_trips": guard_trips,
        }

    return {
        "run_dir": str(run_dir),
        "fleet": fleet,
        "pointer": (_pointer_status(pointer_root)
                    if pointer_root else None),
        "replicas": _replica_status(run_dir),
        "autoscaler": ({
            "scale_ups": scale_ups, "scale_downs": scale_downs,
            "scale_failed": scale_failed,
            "replicas_gauge": replicas_gauge,
        } if (scale_ups or scale_downs or scale_failed
              or replicas_gauge is not None) else None),
        "ledger": _ledger_status(run_dir, pointer_root),
        "model_health": health,
        "slo": slo,
        "promotions": {
            "advances": _count(rows, "counter", "promote/advance"),
            "rejections": _count(rows, "counter", "promote/reject"),
            "rollbacks": (_count(rows, "counter", "promote/rollback")
                          + _count(rows, "counter",
                                   "promote/fleet_rollback")),
        },
    }


def format_status(s: Dict[str, Any]) -> str:
    lines = [f"ops status: {s['run_dir']}"]
    fleet = s.get("fleet")
    if fleet:
        ids = ",".join(str(i) for i in fleet.get("replica_ids") or [])
        lines.append(
            f"  fleet: {fleet.get('replicas')} live (ids {ids or '-'}) "
            f"on {fleet.get('host')}:{fleet.get('port')}  "
            f"ever={fleet.get('total_replicas_ever')}")
    else:
        lines.append("  fleet: (no fleet.json)")
    ptr = s.get("pointer")
    if ptr:
        if ptr.get("error"):
            lines.append(f"  pointer: {ptr['error']}")
        else:
            rb = (f"  rolled_back_from={ptr['rolled_back_from']}"
                  if ptr.get("rolled_back_from") is not None else "")
            lines.append(
                f"  pointer: generation {ptr.get('generation')} "
                f"fp {ptr.get('params_fingerprint')} "
                f"members={ptr.get('members')} "
                f"history={ptr.get('history')}{rb}")
    for rep in s.get("replicas") or []:
        lines.append(
            f"  {rep['replica']}: generation={rep.get('generation')} "
            f"fp={rep.get('fingerprint')} "
            f"hb={rep.get('heartbeat_section')} "
            f"restarts={rep.get('restarts')}")
    auto = s.get("autoscaler")
    if auto:
        lines.append(
            f"  autoscaler: ups={auto['scale_ups']} "
            f"downs={auto['scale_downs']} failed={auto['scale_failed']} "
            f"replicas_gauge={auto.get('replicas_gauge')}")
    ledger = s.get("ledger")
    if ledger:
        lines.append(
            f"  ledger: {ledger['records']} records "
            f"({ledger['quarantined']} quarantined) [{ledger['dir']}]")
    health = s.get("model_health")
    if health:
        lines.append(
            f"  model health: drift_alerts={health['drift_alerts']} "
            f"canary_swaps={health['canary_swaps']} "
            f"guard_trips={health['guard_trips']}")
    promos = s.get("promotions") or {}
    if any(promos.values()):
        lines.append(
            f"  promotions: advances={promos['advances']} "
            f"rejections={promos['rejections']} "
            f"rollbacks={promos['rollbacks']}")
    slo = s.get("slo")
    if slo:
        if slo["firing"]:
            for a in slo["firing"]:
                burn = (f" burn={a['burn_long']:.4g}"
                        if isinstance(a.get("burn_long"),
                                      (int, float)) else "")
                lines.append(
                    f"  ALERT FIRING: {a['objective']} [{a['window']}] "
                    f"severity={a['severity']}{burn}")
        else:
            lines.append(
                f"  slo: no firing alerts "
                f"({slo['alerts_resolved']} resolved)")
        for key, v in (slo.get("budget_remaining") or {}).items():
            if isinstance(v, (int, float)):
                lines.append(f"    budget remaining {key}: {v:.4g}")
        probe = slo.get("probe") or {}
        lines.append(
            f"  probe: {probe.get('checks', 0)} checks, "
            f"{probe.get('failures', 0)} failures, "
            f"{probe.get('digest_changes', 0)} digest changes")
    elif slo is None:
        lines.append("  slo: (no probe/alert telemetry)")
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearninginassetpricing_paperreplication_torch"
             ".ops",
        description="Cross-plane ops console over one serving/fleet run "
                    "dir (read-only, byte-deterministic)")
    sub = p.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("status", help="current cross-plane posture")
    st.add_argument("run_dir")
    st.add_argument("--pointer", type=str, default=None,
                    help="promotion pointer root (default: the one "
                         "fleet.json records)")
    st.add_argument("--json", action="store_true", dest="as_json")
    tl = sub.add_parser("timeline", help="merged operations timeline")
    tl.add_argument("run_dir")
    tl.add_argument("--limit", type=int, default=None,
                    help="only the newest N events")
    tl.add_argument("--json", action="store_true", dest="as_json")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if not Path(args.run_dir).is_dir():
        print(f"ops: no such run dir: {args.run_dir}", file=sys.stderr)
        return 2
    if args.cmd == "status":
        s = gather_status(args.run_dir, pointer_root=args.pointer)
        if args.as_json:
            print(json.dumps(s, indent=2, sort_keys=True))
        else:
            print(format_status(s))
        return 0
    rows = gather_timeline(args.run_dir, limit=args.limit)
    if args.as_json:
        print(json.dumps(rows, indent=2, sort_keys=True))
    else:
        print(format_timeline(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
