"""Post-hoc run aggregation: ``python -m ...paperreplication_torch.report``.

Reads what a run directory already contains — ``manifest.json``,
``events.jsonl`` (plus the worker, supervisor, fault and replica event
files), ``metrics.jsonl``, ``final_metrics.json`` — and prints where the
wall clock went (per phase, and the startup pipeline's stages), how fast
each phase ran (epochs/s), how much device memory the run touched, the
serving, reliability, elastic, promotion and model-health stories, and
(optionally) how the final Sharpes compare to a ``PARITY_*.json``
baseline. The counterpart of the JAX package's ``observability/report.py``,
function for function, on the same run-dir layout and event rows, with one
difference: the JAX package's AOT-program section (``xla_programs``: XLA's
cost and memory analysis of each compiled program) is the port's
kernel-plans section (``kernel_programs``): each hand-written kernel's
launch plan as the card holds it, from ``manifest.json``'s
``kernel_programs`` (the train CLI and the sweep workers write it) or the
``program`` rows that ``observability/programs.py::record_program`` emits.

Pure file reading: nothing here touches a device, so it works on live,
finished or crashed run dirs alike. The module's top level is stdlib only;
the model-health section loads the numpy-side readers inside its function.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Tuple

# ONE definition of the event-file family and the tolerant reader, shared
# with trace assembly — when the file family grows, trace and report can
# never disagree about which processes exist
from .trace import read_jsonl as _read_jsonl
from .trace import trace_file_paths

# the --parity moment-violation column's own tolerance (the 0.02 Sharpe
# bar is a different quantity at a different scale): the run's worst
# per-moment violation may exceed the baseline's by at most this relative
# factor, plus an absolute floor absorbing seed noise near zero
MOMENT_REL_BAR = 0.5
MOMENT_ABS_FLOOR = 1e-3

# metrics.jsonl phase tags → the trainer's phase span/timing labels
PHASE_LABELS = {
    "unc": "phase1_unconditional",
    "moment": "phase2_moment",
    "cond": "phase3_conditional",
}


def _latest_run_rows(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Scope one file's rows to its most recent run: appended re-runs (and
    resumes) write under a fresh run_id, and only the last run's rows
    describe the run the directory currently holds. Files with no run_id
    anywhere (pre-telemetry writers) are kept whole; once any row carries a
    run_id, id-less legacy rows are dropped too — mixing them back in
    would double-count epochs against the scoped spans."""
    if not rows:
        return rows
    last_id = next(
        (r["run_id"] for r in reversed(rows) if r.get("run_id")), None)
    if last_id is None:
        return rows
    return [r for r in rows if r.get("run_id") == last_id]


def load_run(run_dir) -> Dict[str, Any]:
    """All of one run dir's telemetry artifacts, tolerantly parsed."""
    run_dir = Path(run_dir)
    manifest = None
    mpath = run_dir / "manifest.json"
    if mpath.exists():
        try:
            manifest = json.loads(mpath.read_text())
        except json.JSONDecodeError:
            manifest = None
    # per-file latest-run scoping (NOT a global manifest-run_id filter):
    # multihost workers' events.proc{p}.jsonl rows carry their own run ids,
    # and a manifest-wide filter would silently drop every worker row
    events: List[Dict[str, Any]] = []
    events_all: List[Dict[str, Any]] = []
    # replica*/ subdirs: a replicated serving fleet keeps one run dir per
    # replica under the fleet run dir — the fleet report spans all of them
    for p in trace_file_paths(run_dir):
        rows = _read_jsonl(p)
        events.extend(_latest_run_rows(rows))
        # UNscoped rows feed the reliability summary: a supervised run's
        # children each write under a fresh run_id, and restarts/faults/
        # guard trips must count across ALL of them, not just the last
        # child's (events.supervisor.jsonl and events.faults.jsonl ride the
        # same glob)
        events_all.extend(rows)
    final_metrics = None
    fpath = run_dir / "final_metrics.json"
    if fpath.exists():
        try:
            final_metrics = json.loads(fpath.read_text())
        except json.JSONDecodeError:
            final_metrics = None
    return {
        "run_dir": str(run_dir),
        "manifest": manifest,
        "events": events,
        "events_all": events_all,
        # same latest-run scoping: epoch counts must match the span
        # durations they are divided by (a resumed run reports the resumed
        # segment's throughput, not a mixed-run average)
        "metrics": _latest_run_rows(_read_jsonl(run_dir / "metrics.jsonl")),
        "final_metrics": final_metrics,
    }


def _span_ends(events, prefix: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for e in events:
        if e.get("kind") == "span_end" and str(e.get("name", "")).startswith(prefix):
            name = e["name"][len(prefix):]
            out[name] = out.get(name, 0.0) + float(e.get("duration_s") or 0.0)
    return out


def _compile_wall_seconds(events) -> Any:
    """Wall-clock of the compile stage: earliest compile span begin →
    latest end, per process, max over processes. The trainer compiles
    phase programs CONCURRENTLY (Trainer.precompile), so summing the
    per-program durations would overstate compile wall time ~3×; the
    per-process window uses each process's own monotonic clock (mono
    values are not comparable across processes)."""
    windows: Dict[int, list] = {}
    for e in events:
        if not str(e.get("name", "")).startswith("compile/"):
            continue
        mono = e.get("mono")
        if mono is None:
            continue
        w = windows.setdefault(int(e.get("process_index") or 0), [mono, mono])
        if e.get("kind") == "span_begin":
            w[0] = min(w[0], mono)
        elif e.get("kind") == "span_end":
            w[1] = max(w[1], mono)
    spans = [max(0.0, b - a) for a, b in windows.values()]
    return round(max(spans), 3) if spans else None


def _startup_summary(events) -> Any:
    """The startup pipeline's stage breakdown, when a run carries
    ``startup/*`` spans (data/pipeline.py): per-stage span-duration sums
    plus the OVERLAP-ADJUSTED wall window (earliest begin → latest end per
    process, max over processes — the same logic as the compile wall: the
    stages run concurrently, so summing their durations would overstate the
    startup cost ~3×). Cache hit/miss counts ride along from the
    ``panel_cache`` counters. Runs on the sharded data plane additionally
    carry ``startup/shard_*`` events (data/pipeline.py chunked reader +
    per-shard transfer); those aggregate into a ``dataplane`` subsection:
    shards owned / loaded-from-cache / re-decoded, per-shard transfer span
    count + summed dispatch window, and the peak host RSS gauge. The gauge
    fires on every pipeline run, so unsharded runs report it standalone
    (top-level ``peak_rss_bytes``) with no dataplane subsection. None when
    the run predates the pipeline."""
    stages: Dict[str, float] = {}
    windows: Dict[int, list] = {}
    hits = misses = 0
    shards_owned = shards_loaded = shards_redecoded = 0
    shard_transfers = 0
    shard_transfer_s = 0.0
    peak_rss = None
    for e in events:
        name = str(e.get("name", ""))
        kind = e.get("kind")
        if kind == "counter" and name == "panel_cache":
            if e.get("hit"):
                hits += int(e.get("value") or 0)
            else:
                misses += int(e.get("value") or 0)
            continue
        if not name.startswith("startup/"):
            continue
        if kind == "counter":
            v = int(e.get("value") or 0)
            if name == "startup/shard_owned":
                shards_owned += v
            elif name == "startup/shard_loaded":
                shards_loaded += v
            elif name == "startup/shard_redecode":
                shards_redecoded += v
            continue
        if kind == "gauge" and name == "startup/peak_rss":
            v = e.get("value")
            if v is not None:
                peak_rss = max(peak_rss or 0, int(v))
            continue
        if kind == "span_end":
            stage = name[len("startup/"):]
            stages[stage] = stages.get(stage, 0.0) + float(
                e.get("duration_s") or 0.0)
            if stage == "shard_transfer":
                shard_transfers += 1
                shard_transfer_s += float(e.get("duration_s") or 0.0)
        if kind in ("span_begin", "span_end"):
            mono = e.get("mono")
            if mono is None:
                continue
            w = windows.setdefault(
                int(e.get("process_index") or 0), [mono, mono])
            w[0] = min(w[0], mono)
            w[1] = max(w[1], mono)
    if not stages and not shards_owned:
        return None
    walls = [max(0.0, b - a) for a, b in windows.values()]
    # the subsection asserts the run used the chunked store / shard-local
    # loading, so it only appears when shards were actually in play; the
    # peak-RSS gauge fires on every pipeline run and reports standalone
    dataplane = None
    if shards_owned or shard_transfers:
        dataplane = {
            "shards_owned": shards_owned,
            "shards_loaded": shards_loaded,
            "shards_redecoded": shards_redecoded,
            "shard_transfers": shard_transfers,
            "shard_transfer_s": round(shard_transfer_s, 3),
            "peak_rss_bytes": peak_rss,
        }
    return {
        "wall_s": round(max(walls), 3) if walls else None,
        "stages": {k: round(v, 3) for k, v in sorted(stages.items())},
        "cache": ({"hits": hits, "misses": misses}
                  if (hits or misses) else None),
        "dataplane": dataplane,
        "peak_rss_bytes": peak_rss,
    }


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


def _serving_summary(events) -> Any:
    """A serving run's request-path breakdown, when the run carries
    ``serve/*`` events (serving/server.py + engine.py + batcher.py):
    request counts per endpoint/status (and per replica for a fleet),
    latency percentiles from the ``serve/request`` span durations, cache
    hit rate, dispatch count, continuous-batching occupancy/queue-depth
    aggregates, the 503 rate, and — the steady-state guarantee — the
    recompile count. None for non-serving runs."""
    latencies: List[float] = []
    requests: Dict[str, int] = {}
    by_replica: Dict[str, int] = {}
    occupancy: Dict[str, int] = {}
    traced_rows: List[Dict[str, Any]] = []
    flight_dumps: Dict[str, int] = {}
    cache_hits = cache_misses = 0
    recompiles = dispatches = macro_appends = reloads = 0
    flushes = 0
    n_503 = 0
    queue_depth_sum = 0
    # load-adaptive plane tallies: admission shedding, single-flight
    # coalescing, autoscaler scale events, graceful drains
    shed_by_reason: Dict[str, int] = {}
    shed_by_priority: Dict[str, int] = {}
    coalesce_hits = coalesce_misses = 0
    scale_events: List[Dict[str, Any]] = []
    replicas_gauge: Any = None
    drains = 0
    lat_by_priority: Dict[str, List[float]] = {}
    for e in events:
        name = str(e.get("name", ""))
        kind = e.get("kind")
        if kind in ("span_end", "request") and name == "serve/request" \
                and e.get("priority") is not None:
            lat_by_priority.setdefault(str(e["priority"]), []).append(
                float(e.get("duration_s") or 0.0))
        if kind == "span_end" and name == "serve/request":
            latencies.append(float(e.get("duration_s") or 0.0))
        elif kind == "request" and name == "serve/request":
            # the sampled per-request trace record: same latency stream as
            # the span_end twin, plus segment evidence for the tail section
            latencies.append(float(e.get("duration_s") or 0.0))
            traced_rows.append(e)
        elif kind == "counter" and name == "serve/shed":
            value = int(e.get("value") or 1)
            reason = str(e.get("reason") or "unknown")
            shed_by_reason[reason] = shed_by_reason.get(reason, 0) + value
            pri = str(e.get("priority") or "unknown")
            shed_by_priority[pri] = shed_by_priority.get(pri, 0) + value
        elif kind == "counter" and name == "serve/coalesce":
            if e.get("hit"):
                coalesce_hits += int(e.get("value") or 1)
            else:
                coalesce_misses += int(e.get("value") or 1)
        elif kind == "counter" and name == "fleet/scale":
            scale_events.append({
                "action": e.get("action") or e.get("direction"),
                "replica": e.get("replica"),
                "replicas": e.get("replicas"),
                "reason": e.get("reason"),
                "queue_depth": e.get("queue_depth"),
                "shed_rate": e.get("shed_rate"),
            })
        elif kind == "gauge" and name == "fleet/replicas":
            replicas_gauge = e.get("value")
        elif kind == "counter" and name == "serve/drain":
            drains += int(e.get("value") or 1)
        elif kind == "counter" and name == "serve/flightrecorder":
            reason = str(e.get("reason") or "unknown")
            flight_dumps[reason] = (
                flight_dumps.get(reason, 0) + int(e.get("value") or 1))
        elif kind == "span_end" and name == "serve/dispatch":
            dispatches += 1
        elif kind == "counter" and name == "serve/requests":
            key = f"{e.get('endpoint')} {e.get('status')}"
            value = int(e.get("value") or 0)
            requests[key] = requests.get(key, 0) + value
            if e.get("replica") is not None:
                rep = str(e.get("replica"))
                by_replica[rep] = by_replica.get(rep, 0) + value
            if int(e.get("status") or 0) == 503:
                n_503 += value
        elif kind == "counter" and name == "serve/cache":
            if e.get("hit"):
                cache_hits += int(e.get("value") or 0)
            else:
                cache_misses += int(e.get("value") or 0)
        elif kind == "counter" and name == "serve/recompile":
            recompiles += int(e.get("value") or 0)
        elif kind == "counter" and name == "serve/macro_append":
            macro_appends += int(e.get("value") or 0)
        elif kind == "counter" and name == "serve/reload":
            reloads += int(e.get("value") or 0)
        elif kind == "counter" and name == "serve/flush":
            flushes += 1
            occ = str(e.get("occupancy"))
            occupancy[occ] = occupancy.get(occ, 0) + 1
            queue_depth_sum += int(e.get("queue_depth") or 0)
    if not (latencies or requests or recompiles):
        return None
    lat = latency_percentiles_ms(latencies)
    lookups = cache_hits + cache_misses
    total = sum(requests.values())
    out = {
        "requests": dict(sorted(requests.items())),
        "total_requests": total,
        "latency": lat,
        "cache": ({"hits": cache_hits, "misses": cache_misses,
                   "hit_rate": round(cache_hits / lookups, 4)}
                  if lookups else None),
        "recompiles": recompiles,
        "dispatches": dispatches,
        "macro_appends": macro_appends,
        "rate_503": round(n_503 / total, 4) if total else None,
    }
    if reloads:
        out["reloads"] = reloads
    if by_replica:
        out["requests_by_replica"] = dict(sorted(by_replica.items()))
    if traced_rows:
        out["traced_requests"] = len(traced_rows)
        out["tail_latency"] = _tail_latency(traced_rows)
    if flight_dumps:
        out["flightrecorder_dumps"] = dict(sorted(flight_dumps.items()))
    if shed_by_reason:
        # admission-control evidence: who was deliberately turned away
        out["shed"] = {
            "total": sum(shed_by_reason.values()),
            "by_reason": dict(sorted(shed_by_reason.items())),
            "by_priority": dict(sorted(shed_by_priority.items())),
        }
    if coalesce_hits or coalesce_misses:
        lookups = coalesce_hits + coalesce_misses
        out["coalesce"] = {
            "hits": coalesce_hits,
            "dispatches": coalesce_misses,
            "hit_rate": round(coalesce_hits / lookups, 4),
            # the O(users) → O(distinct queries) ratio: dispatches per
            # coalesce-eligible request (≪ 1 under duplicate-heavy load)
            "dispatch_ratio": round(coalesce_misses / lookups, 4),
        }
    if lat_by_priority:
        out["latency_by_priority"] = {
            p: latency_percentiles_ms(ls)
            for p, ls in sorted(lat_by_priority.items())}
    if scale_events or replicas_gauge is not None:
        ups = sum(1 for s in scale_events if s["action"] == "up")
        downs = sum(1 for s in scale_events if s["action"] == "down")
        out["autoscale"] = {
            "scale_ups": ups,
            "scale_downs": downs,
            "failed": sum(1 for s in scale_events
                          if str(s["action"]).endswith("_failed")),
            "replicas_final": replicas_gauge,
            "events": scale_events[-10:],
        }
    if drains:
        out["drains"] = drains
    if flushes:
        # continuous-batching evidence: how full the device programs ran
        # and how much queueing pressure stood behind each flush
        out["batching"] = {
            "flushes": flushes,
            "occupancy_hist": {
                k: occupancy[k]
                for k in sorted(occupancy, key=lambda s: int(s))},
            "mean_queue_depth": round(queue_depth_sum / flushes, 3),
        }
    return out


# request-row segment fields, in pipeline order, → tail-attribution ms keys
_SEGMENT_FIELDS = (
    ("parse_s", "parse"), ("queue_s", "queue_wait"),
    ("batch_s", "batch_wait"), ("dispatch_share_s", "dispatch_share"),
    ("serialize_s", "serialize"), ("write_s", "write"),
)


def _tail_latency(traced_rows: List[Dict[str, Any]],
                  n: int = 5) -> List[Dict[str, Any]]:
    """The slowest-N traced requests, attributed segment by segment — WHERE
    each slow request spent its time (batcher lane, flush wait, dispatch
    share, serialization, socket write). Deterministic order: duration
    desc, then trace id."""
    rows = sorted(
        traced_rows,
        key=lambda r: (-(float(r.get("duration_s") or 0.0)),
                       str(r.get("trace_id"))))[:n]
    out = []
    for r in rows:
        entry: Dict[str, Any] = {
            "trace_id": r.get("trace_id"),
            "endpoint": r.get("endpoint"),
            "status": r.get("status"),
            "total_ms": round(float(r.get("duration_s") or 0.0) * 1e3, 3),
            "segments_ms": {
                label: round(float(r[field]) * 1e3, 3)
                for field, label in _SEGMENT_FIELDS
                if isinstance(r.get(field), (int, float))
            },
        }
        for key in ("flush", "occupancy", "replica", "wire", "cached"):
            if r.get(key) is not None:
                entry[key] = r[key]
        out.append(entry)
    return out


def _fmt_segments(segments_ms: Dict[str, float]) -> str:
    return "  ".join(f"{k}={v:.2f}" for k, v in segments_ms.items())


def _reliability_summary(events) -> Any:
    """A supervised/fault-injected run's recovery story, when the run
    carries reliability events: deaths with per-section attribution
    (``supervise/death``) and actual restarts (``supervise/restart`` —
    a terminal death is not a restart, so the two can differ by one), the
    supervisor's final outcome, faults injected per site/action
    (``fault/injected``, from the injector's DLAP_FAULT_EVENTS file),
    divergence-guard trips (``guard/trip``), and verified-checkpoint
    generation fallbacks (``checkpoint/fallback`` / ``checkpoint/unusable``).
    Counts run over ALL rows (not latest-run scoped): each restarted child
    logs under its own run_id and every one of them is part of the story.
    None for runs with no reliability events."""
    restarts = hang_kills = guard_trips = fallbacks = unusable = 0
    deaths: Dict[str, int] = {}
    faults: Dict[str, int] = {}
    outcome = None
    for e in events:
        if e.get("kind") != "counter":
            continue
        name = str(e.get("name", ""))
        value = int(e.get("value") or 1)
        if name == "supervise/death":
            section = str(e.get("section") or "setup")
            deaths[section] = deaths.get(section, 0) + value
            if e.get("hang"):
                hang_kills += value
        elif name == "supervise/restart":
            restarts += value
        elif name == "supervise/outcome":
            outcome = {
                "outcome": e.get("outcome"),
                "restarts": e.get("restarts"),
                "returncode": e.get("returncode"),
            }
        elif name == "fault/injected":
            key = f"{e.get('site')}:{e.get('action')}"
            faults[key] = faults.get(key, 0) + value
        elif name == "guard/trip":
            guard_trips += value
        elif name == "checkpoint/fallback":
            fallbacks += value
        elif name == "checkpoint/unusable":
            unusable += value
    if not (restarts or deaths or faults or guard_trips or fallbacks
            or unusable or outcome):
        return None
    return {
        "restarts": restarts,
        "hang_kills": hang_kills,
        "deaths_by_section": dict(sorted(deaths.items())),
        "outcome": outcome,
        "faults_injected": dict(sorted(faults.items())),
        "guard_trips": guard_trips,
        "checkpoint_fallbacks": fallbacks,
        "checkpoint_unusable": unusable,
    }


def _elastic_summary(events, run_dir) -> Any:
    """An elastic sweep's fleet story, when the run carries ``sweep/*``
    elastic events (reliability/scheduler.py + parallel/sweep.py) or a
    ledger directory: buckets completed / retried / quarantined, ledger
    hits (resumed-from-ledger evidence: completed buckets NOT re-trained),
    lease takeovers, per-worker claim and completion counts, and quorum
    drops. Counts run over ALL rows (workers and restarted children each
    log under their own run_id — like the reliability section). The ledger
    directory, when present, supplies the authoritative bucket totals; a
    run with neither returns None."""
    claims_by_worker: Dict[str, int] = {}
    done_by_worker: Dict[str, int] = {}
    hits = writes = retries = takeovers = quarantines = 0
    quorum_drops: List[Dict[str, Any]] = []
    seen_any = False
    for e in events:
        if e.get("kind") != "counter":
            continue
        name = str(e.get("name", ""))
        value = int(e.get("value") or 1)
        if name == "sweep/claim":
            worker = str(e.get("worker") or "?")
            claims_by_worker[worker] = claims_by_worker.get(worker, 0) + value
        elif name == "sweep/ledger_write":
            worker = str(e.get("worker") or "inline")
            done_by_worker[worker] = done_by_worker.get(worker, 0) + value
            writes += value
        elif name == "sweep/ledger_hit":
            hits += value
        elif name == "sweep/retry":
            retries += value
        elif name == "sweep/lease_takeover":
            takeovers += value
        elif name == "sweep/quarantine":
            quarantines += value
        elif name == "sweep/quorum_drop":
            quorum_drops.append(
                {"rank": e.get("rank"), "seed": e.get("seed")})
        else:
            continue
        seen_any = True
    # the ledger dir (stdlib-only module) is the authoritative tally of
    # what the run dir HOLDS — events say what this run DID
    ledger_counts = None
    ledger_root = Path(run_dir) / "sweep_ledger"
    if (ledger_root / "queue.json").exists():
        from ..reliability.ledger import SweepLedger

        ledger = SweepLedger(ledger_root)
        try:
            manifest = json.loads((ledger_root / "queue.json").read_text())
            total = len(manifest.get("items", []))
        except (OSError, json.JSONDecodeError):
            total = None
        ledger_counts = {
            "total_buckets": total,
            "records": len(ledger.keys()),
            "quarantined": len(ledger.quarantined()),
        }
    if not seen_any and ledger_counts is None:
        return None
    return {
        "buckets_completed": writes,
        "ledger_hits": hits,
        "retries": retries,
        "lease_takeovers": takeovers,
        "quarantined": quarantines,
        "claims_by_worker": dict(sorted(claims_by_worker.items())),
        "completed_by_worker": dict(sorted(done_by_worker.items())),
        "quorum_drops": quorum_drops,
        "ledger": ledger_counts,
    }


def _promotion_summary(events, run_dir) -> Any:
    """The promotion control plane's story, when the run carries
    ``promote/*`` or ``serve/generation``/``serve/reload`` events
    (reliability/promotion.py + serving/fleet.RollingUpdater +
    serving/server.py): generations promoted and rolled back, gate
    rejections bucketed by reason, reload swap/no-op counts, and the
    per-replica serving-generation convergence timeline (every
    ``serve/generation`` row is one "replica R began serving fingerprint F"
    transition — boot rows included, so a replica that died mid-promotion
    and converged on restart shows its whole path). Counts run over ALL
    rows (restarted replicas and the refit coordinator each log under
    their own run_id). The pointer file, when the run dir holds one, adds
    the authoritative head. None when the run has no promotion events."""
    promotions = pointer_rollbacks = fleet_rollbacks = fleet_converged = 0
    reloads_swapped = reloads_noop = 0
    rejections: Dict[str, int] = {}
    timeline: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("kind") != "counter":
            continue
        name = str(e.get("name", ""))
        value = int(e.get("value") or 1)
        if name == "promote/advance":
            promotions += value
        elif name == "promote/reject":
            reason = str(e.get("reason") or "unknown")
            rejections[reason] = rejections.get(reason, 0) + value
        elif name == "promote/rollback":
            pointer_rollbacks += value
        elif name == "promote/fleet_rollback":
            fleet_rollbacks += value
        elif name == "promote/fleet_converged":
            fleet_converged += value
        elif name == "serve/reload":
            if e.get("swapped") is False:
                reloads_noop += value
            else:
                reloads_swapped += value
        elif name == "serve/generation":
            replica = str(e.get("replica") or "?")
            timeline.setdefault(replica, []).append({
                "ts": e.get("ts"),
                "generation": e.get("generation"),
                "fingerprint": e.get("fingerprint"),
                "pointer_generation": e.get("pointer_generation"),
                "boot": bool(e.get("boot")),
            })
    if not (promotions or rejections or pointer_rollbacks or fleet_rollbacks
            or fleet_converged or reloads_swapped or reloads_noop
            or timeline):
        return None
    for rows in timeline.values():
        rows.sort(key=lambda r: (r["ts"] is None, r["ts"]))
    serving = {r: rows[-1]["fingerprint"] for r, rows in timeline.items()}
    out = {
        "promotions": promotions,
        "pointer_rollbacks": pointer_rollbacks,
        "fleet_rollbacks": fleet_rollbacks,
        "fleet_converged": fleet_converged,
        "rejections_by_reason": dict(sorted(rejections.items())),
        "reloads": {"swapped": reloads_swapped, "noop": reloads_noop},
        "replica_timeline": {r: rows for r, rows in sorted(timeline.items())},
        "serving_fingerprints": dict(sorted(serving.items())),
        "converged": (len(set(serving.values())) == 1 if serving else None),
    }
    # the pointer artifact (stdlib read) is the authoritative CURRENT head
    pointer_path = Path(run_dir) / "serving_current.json"
    if pointer_path.exists():
        try:
            from ..reliability.promotion import read_pointer

            head = read_pointer(pointer_path)
        except (ValueError, OSError):
            head = None
        if head is not None:
            out["pointer"] = {
                "generation": head.get("generation"),
                "fingerprint": str(
                    head.get("params_fingerprint") or "")[:16],
                "source": head.get("source"),
                "valid_sharpe": head.get("valid_sharpe"),
                "history": len(head.get("history") or []),
                "rolled_back_from": head.get("rolled_back_from"),
            }
    return out


def _model_health_summary(run_dir, events) -> Any:
    """The model-health story of one run dir: the verified ``health.json``
    artifact (written by the trainer — per-moment violation norms, SDF /
    portfolio diagnostics, divergence-guard trips), the reference-profile
    presence, and the serving drift monitor's event counters. None when
    the run predates the health plane (no health.json, no drift/health
    events) — old run dirs summarize byte-stably with the section absent
    and the text report printing its "(no health data)" placeholder."""
    from .drift import PROFILE_FILENAME
    from .modelhealth import read_health

    health = read_health(run_dir)
    drift_alerts = drift_scored = canary_swaps = 0
    last_psi = None
    canary_max_delta = None
    for e in events:
        name = str(e.get("name", ""))
        kind = e.get("kind")
        if kind == "counter" and name == "model/drift_alert":
            drift_alerts += int(e.get("value") or 1)
        elif kind == "gauge" and name == "model/drift_psi":
            last_psi = e.get("value")
            drift_scored += 1
        elif kind == "counter" and name == "serve/canary":
            canary_swaps += 1
            d = e.get("max_weight_delta")
            if d is not None:
                canary_max_delta = max(canary_max_delta or 0.0, float(d))
    has_profile = (Path(run_dir) / PROFILE_FILENAME).exists()
    if health is None and not (drift_alerts or drift_scored or canary_swaps
                               or has_profile):
        return None
    out: Dict[str, Any] = {
        "reference_profile": has_profile,
    }
    if health is not None:
        diag = health.get("diagnostics") or {}
        out.update({
            "finite": health.get("finite"),
            "split": health.get("split"),
            "guard_trips": health.get("guard_trips", 0),
            "moment_violation_max": diag.get("moment_violation_max"),
            "moment_violations": diag.get("moment_violations"),
            "unc_violation": diag.get("unc_violation"),
            "adv_gap": diag.get("adv_gap"),
            "sdf": {k: diag.get(k) for k in
                    ("sdf_mean", "sdf_vol", "sdf_min", "sdf_finite_frac")},
            "portfolio": {k: diag.get(k) for k in
                          ("weight_hhi", "weight_max_abs",
                           "short_fraction", "turnover")},
        })
    if drift_scored or drift_alerts:
        out["drift"] = {"scored": drift_scored, "alerts": drift_alerts,
                        "psi_last": last_psi}
    if canary_swaps:
        out["canary"] = {"hot_swaps": canary_swaps,
                         "max_weight_delta": canary_max_delta}
    return out


def _slo_summary(events) -> Any:
    """The SLO/alerting story of one run dir: probe totals (blackbox
    checks, failures, digest changes), alert transitions, and the
    current firing set + last burn-rate/budget gauges. The row semantics
    live in ONE place — ``statusboard.scan_slo_rows`` — shared with the
    ops console, so the report CLI and ``ops status`` can never disagree
    about what the durable ``alert``/``probe`` rows mean. None when the
    run predates the plane (section absent, text report byte-stable)."""
    from .statusboard import scan_slo_rows

    scan = scan_slo_rows(events)
    # the SAME presence gate as statusboard.gather_status: a prober that
    # only ever recorded layout_unreadable (blind on a dead fleet dir)
    # must surface in the report exactly as it does in `ops status`
    if not (scan["last_state"] or scan["burn"] or scan["probe_checks"]
            or scan["probe_failures"] or scan["layout_unreadable"]):
        return None
    firing_now = sorted(
        f"{o} [{w}]" for (o, w), row in scan["last_state"].items()
        if row.get("name") == "alert/firing")
    return {
        "probe": {
            "checks": scan["probe_checks"],
            "failures": scan["probe_failures"],
            "digest_changes": scan["digest_changes"],
            "layout_unreadable": scan["layout_unreadable"],
            "failures_by_target": dict(
                sorted(scan["failure_targets"].items())),
        },
        "alerts": {"firings": scan["firings"],
                   "resolves": scan["resolves"],
                   "firing_now": firing_now},
        "burn_rates": {f"{o} {w}": v
                       for (o, w), v in sorted(scan["burn"].items())},
        "budget_remaining": {
            f"{o} {w}": v
            for (o, w), v in sorted(scan["budget"].items())},
    }


def programs_from_events(events_rows) -> Dict[str, Dict[str, Any]]:
    """The kernel plans a run recorded as ``program`` event rows
    (``observability/programs.py::record_program``), by name: the
    fallback for a run whose manifest holds no ``kernel_programs`` (a
    sweep coordinator's, or a CLI that died before writing it)."""
    out: Dict[str, Dict[str, Any]] = {}
    for row in events_rows:
        if row.get("kind") != "program":
            continue
        analysis = row.get("analysis")
        name = row.get("name")
        if isinstance(name, str) and isinstance(analysis, dict):
            out[name] = analysis
    return out


def _kernel_programs_summary(manifest, events) -> Any:
    """The run's kernel launch plans as the card held them: the port's
    counterpart of the JAX report's AOT-program table. ``manifest.json``'s
    ``kernel_programs`` (written by the train CLI and the sweep workers),
    falling back to the ``program`` event rows. None when the run planned
    no kernel (the plain route, a CPU device, an old run dir): the section
    stays absent."""
    progs = (manifest or {}).get("kernel_programs")
    if isinstance(progs, dict) and progs:
        return progs
    return programs_from_events(events) or None


def _metrics_crosscheck(run_dir, events) -> Any:
    """Cross-check the run dir's final metrics snapshot (``metrics.prom``,
    written by the serving service at clean shutdown) against the events
    plane: request/recompile totals must agree, and the steady-state
    recompile gauge — the zero-recompile guarantee measured by the METRICS
    plane, not just events — must be zero. The snapshot holds only the
    FINAL process incarnation's registry (a supervised restart starts a
    fresh one), so the events side is scoped to the last run_id that
    served — an unscoped comparison would flag every restarted run as
    disagreeing. None when the run left no snapshot (old run dirs: the
    section stays absent)."""
    path = Path(run_dir) / "metrics.prom"
    if not path.exists():
        return None
    from .metrics import parse_prom_text

    try:
        metrics = parse_prom_text(path.read_text())
    except (OSError, ValueError) as e:
        return {"error": f"metrics.prom unreadable: {e}"}
    out: Dict[str, Any] = {
        "requests": int(sum(
            (metrics.get("dlap_serve_requests_total") or {}).values())),
        "recompiles": int(sum(
            (metrics.get("dlap_serve_recompile_total") or {}).values())),
    }
    steady = metrics.get("dlap_serve_steady_state_recompiles")
    if steady:
        n = int(sum(steady.values()))
        out["steady_state_recompiles"] = n
        out["steady_state_ok"] = n == 0
    last_rid = None
    for e in events:
        if str(e.get("name", "")).startswith("serve/"):
            last_rid = e.get("run_id")
    if last_rid is not None:
        ev_requests = ev_recompiles = 0
        for e in events:
            if e.get("run_id") != last_rid or e.get("kind") != "counter":
                continue
            name = e.get("name")
            if name == "serve/requests":
                ev_requests += int(e.get("value") or 0)
            elif name == "serve/recompile":
                ev_recompiles += int(e.get("value") or 0)
        out["requests_agree"] = out["requests"] == ev_requests
        out["recompiles_agree"] = out["recompiles"] == ev_recompiles
    return out


def summarize_run(run: Dict[str, Any]) -> Dict[str, Any]:
    """One run dir → the compile/execute/throughput/memory summary dict."""
    events = run["events"]
    fm = run["final_metrics"] or {}

    compile_s = _span_ends(events, "compile/")
    compile_wall = _compile_wall_seconds(events)
    if not compile_s and fm.get("compile_seconds"):
        compile_s = {k: float(v) for k, v in fm["compile_seconds"].items()}

    phase_s = _span_ends(events, "phase/")
    if not phase_s and fm.get("phase_execute_seconds"):
        phase_s = {k: float(v) for k, v in fm["phase_execute_seconds"].items()}

    # epochs EXECUTED under the measured span, best evidence first:
    #   1. the trainer's `epochs_dispatched` counters — exact for budget
    #      stops (span attrs only know the PLANNED count) and resumes;
    #   2. span attrs (epochs - start_epoch) — planned count of the
    #      measured segment;
    #   3. metrics.jsonl row counts — whole-phase history rows.
    epochs_by_counter: Dict[str, int] = {}
    epochs_by_span: Dict[str, int] = {}
    for e in events:
        if e.get("kind") == "counter" and e.get("name") == "epochs_dispatched":
            label = e.get("phase")
            if label:
                epochs_by_counter[label] = (
                    epochs_by_counter.get(label, 0) + int(e.get("value") or 0))
        elif (e.get("kind") == "span_end"
                and str(e.get("name", "")).startswith("phase/")
                and e.get("epochs") is not None):
            label = e["name"][len("phase/"):]
            n = int(e["epochs"]) - int(e.get("start_epoch") or 0)
            epochs_by_span[label] = epochs_by_span.get(label, 0) + max(n, 0)
    epochs_by_label: Dict[str, int] = {}
    for row in run["metrics"]:
        label = PHASE_LABELS.get(row.get("phase"))
        if label:
            epochs_by_label[label] = epochs_by_label.get(label, 0) + 1
    phases = {}
    for label in sorted(set(phase_s) | set(epochs_by_counter)
                        | set(epochs_by_span) | set(epochs_by_label)):
        secs = phase_s.get(label)
        epochs = epochs_by_counter.get(
            label, epochs_by_span.get(label, epochs_by_label.get(label)))
        phases[label] = {
            "execute_s": round(secs, 3) if secs is not None else None,
            "epochs": epochs,
            "epochs_per_s": (
                round(epochs / secs, 2)
                if secs and epochs is not None else None
            ),
        }

    peak_in_use = 0
    peak_peak = 0
    n_mem_events = 0
    for e in events:
        if e.get("kind") != "memory":
            continue
        totals = e.get("totals") or {}
        n_mem_events += 1
        peak_in_use = max(peak_in_use, int(totals.get("bytes_in_use", 0)))
        peak_peak = max(peak_peak, int(totals.get("peak_bytes_in_use", 0)))
    dm = fm.get("device_memory") or {}
    totals = dm.get("totals", dm if isinstance(dm, dict) else {})
    if isinstance(totals, dict):
        peak_in_use = max(peak_in_use, int(totals.get("bytes_in_use") or 0))
        peak_peak = max(peak_peak, int(totals.get("peak_bytes_in_use") or 0))

    # wall window when span events exist (compiles run concurrently);
    # fall back to the sum only when final_metrics durations are all we have
    total_compile = compile_wall
    if total_compile is None and compile_s:
        total_compile = round(sum(compile_s.values()), 3)
    total_execute = round(sum(phase_s.values()), 3) if phase_s else None
    manifest = run["manifest"] or {}
    serving = _serving_summary(run.get("events_all") or events)
    sharpe = {
        split: fm[split]["sharpe"]
        for split in ("train", "valid", "test")
        if isinstance(fm.get(split), dict)
        and isinstance(fm[split].get("sharpe"), (int, float))
    }
    out = {
        "run_dir": run["run_dir"],
        "run_id": manifest.get("run_id"),
        "kind": manifest.get("kind"),
        "config_hash": manifest.get("config_hash"),
        "git_sha": manifest.get("git_sha"),
        "backend": (manifest.get("devices") or {}).get("backend"),
        "n_devices": (manifest.get("devices") or {}).get("device_count"),
        "wall_clock_s": fm.get("wall_clock_s"),
        "startup": _startup_summary(events),
        # unscoped like reliability: a restarted fleet replica logs under a
        # fresh run_id, and its pre-restart requests are part of the story
        "serving": serving,
        "reliability": _reliability_summary(
            run.get("events_all") or events),
        # unscoped like reliability: every worker and restarted child logs
        # under its own run_id, and the fleet story spans all of them
        "elastic": _elastic_summary(
            run.get("events_all") or events, run["run_dir"]),
        # unscoped too: the convergence timeline must span every replica
        # restart and the promoting coordinator alike
        "promotion": _promotion_summary(
            run.get("events_all") or events, run["run_dir"]),
        "compile_seconds": {k: round(v, 3) for k, v in sorted(compile_s.items())},
        "total_compile_s": total_compile,
        "phases": phases,
        "total_execute_s": total_execute,
        "peak_bytes_in_use": peak_in_use or None,
        "peak_peak_bytes_in_use": peak_peak or None,
        "n_memory_events": n_mem_events,
        "n_events": len(events),
        "sharpe": sharpe or None,
    }
    # new-plane sections only when their artifacts exist: summaries (and
    # the text report) of pre-telemetry run dirs stay byte-stable
    model_health = _model_health_summary(
        run["run_dir"], run.get("events_all") or events)
    if model_health:
        out["model_health"] = model_health
    # unscoped: probe/alert evidence spans prober + engine + replica
    # restarts alike
    slo = _slo_summary(run.get("events_all") or events)
    if slo:
        out["slo"] = slo
    kernel_programs = _kernel_programs_summary(
        manifest, run.get("events_all") or events)
    if kernel_programs:
        out["kernel_programs"] = kernel_programs
    metrics_check = _metrics_crosscheck(
        run["run_dir"], run.get("events_all") or events)
    if metrics_check:
        out["metrics_check"] = metrics_check
    return out


def compare_parity(summary: Dict[str, Any], parity_path,
                   bar: float = 0.02) -> Dict[str, Any]:
    """Final Sharpes vs a ``PARITY_*.json`` baseline's reference numbers
    (the 0.02 bar is the repo's established parity criterion).

    Never silently absent: an unreadable baseline or a run with no final
    Sharpes returns ``{"error": ...}`` so a CI gate using ``--parity``
    fails loudly instead of passing vacuously (main() exits nonzero)."""
    parity_path = Path(parity_path)
    out: Dict[str, Any] = {"baseline": str(parity_path), "bar": bar}
    try:
        parity = json.loads(parity_path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        out["error"] = f"baseline unreadable: {e}"
        return out
    ref = (parity.get("reference") or {}).get("sharpe") or {}
    sharpe = summary.get("sharpe") or {}
    splits = {}
    for split in ("train", "valid", "test"):
        if split in sharpe and split in ref:
            delta = abs(float(sharpe[split]) - float(ref[split]))
            # the repo's parity criterion gates valid/test only: train-split
            # deltas of 0.07-1.8 are documented selection-equivalence noise
            # (README "training parity"; PARITY.json passes with
            # abs_delta_sharpe.train=0.0827), so train is informational
            gated = split != "train"
            splits[split] = {
                "run": round(float(sharpe[split]), 4),
                "reference": float(ref[split]),
                "abs_delta": round(delta, 4),
                "within_bar": (delta <= bar) if gated else None,
            }
    if not splits:
        out["error"] = ("no overlapping final Sharpes between the run "
                        "(final_metrics.json) and the baseline's "
                        "reference.sharpe")
        return out
    out["splits"] = splits
    # the moment-violation column: a PARITY_* run can be checked for
    # moment-CONDITION health, not just loss/Sharpe agreement. The run
    # side comes from health.json (summary.model_health); baselines that
    # record reference.moment_violation_max additionally get a gated
    # comparison, older baselines an informational reading. The gate uses
    # its OWN tolerance — violation norms live at ~1e-2 scales the 0.02
    # Sharpe bar was never calibrated for: the run's worst violation may
    # exceed the reference's by at most 50% (plus a small absolute floor
    # absorbing seed noise near zero); improvement is always within.
    mh = summary.get("model_health") or {}
    run_mv = mh.get("moment_violation_max")
    ref_mv = (parity.get("reference") or {}).get("moment_violation_max")
    if run_mv is not None or ref_mv is not None:
        entry: Dict[str, Any] = {
            "run": run_mv,
            "reference": ref_mv,
            "finite": (bool(mh.get("finite"))
                       if run_mv is not None else None),
        }
        if run_mv is not None and ref_mv is not None:
            entry["abs_delta"] = round(abs(run_mv - ref_mv), 6)
            entry["rel_bar"] = MOMENT_REL_BAR
            entry["within_bar"] = (
                run_mv <= ref_mv * (1.0 + MOMENT_REL_BAR)
                + MOMENT_ABS_FLOOR)
        else:
            entry["within_bar"] = None
        out["moment_violation"] = entry
    else:
        out["moment_violation"] = None
    return out


def _cell(v, width: int) -> str:
    return f"{v:>{width}}" if v is not None else f"{'n/a':>{width}}"


def _gib(n) -> str:
    return f"{n / (1 << 30):.3f} GiB" if n else "n/a"


def format_summary(summary: Dict[str, Any]) -> str:
    """Human-readable report for one run."""
    lines = [f"run dir: {summary['run_dir']}"]
    ident = [
        f"kind={summary['kind']}" if summary.get("kind") else None,
        f"run_id={summary['run_id']}" if summary.get("run_id") else None,
        f"backend={summary['backend']}" if summary.get("backend") else None,
        (f"devices={summary['n_devices']}"
         if summary.get("n_devices") is not None else None),
        (f"config={summary['config_hash'][:12]}"
         if summary.get("config_hash") else None),
        (f"git={summary['git_sha'][:12]}" if summary.get("git_sha") else None),
    ]
    ident = [x for x in ident if x]
    if ident:
        lines.append("  " + "  ".join(ident))
    if summary.get("wall_clock_s") is not None:
        lines.append(f"  wall clock: {summary['wall_clock_s']:.1f}s")

    if summary.get("startup"):
        st = summary["startup"]
        wall = (f"{st['wall_s']:.2f}s" if st.get("wall_s") is not None
                else "n/a")
        lines.append("  startup breakdown (stages overlap; wall is the "
                     "begin→end window):")
        lines.append(f"    wall window: {wall}")
        for stage, secs in st["stages"].items():
            lines.append(f"      {stage}: {secs:.2f}s")
        if st.get("cache"):
            c = st["cache"]
            lines.append(f"    panel cache: {c['hits']} hits, "
                         f"{c['misses']} misses")
        if st.get("dataplane"):
            dp = st["dataplane"]
            lines.append("    dataplane (chunked store, shard-local):")
            lines.append(
                f"      shards: {dp['shards_owned']} owned, "
                f"{dp['shards_loaded']} loaded from cache, "
                f"{dp['shards_redecoded']} re-decoded")
            lines.append(
                f"      per-shard transfers: {dp['shard_transfers']} "
                f"({dp['shard_transfer_s']:.2f}s dispatch window)")
            if dp.get("peak_rss_bytes"):
                lines.append(
                    f"      peak host RSS: {_gib(dp['peak_rss_bytes'])}")
        elif st.get("peak_rss_bytes"):
            lines.append(f"    peak host RSS: {_gib(st['peak_rss_bytes'])}")

    if summary.get("serving"):
        sv = summary["serving"]
        lines.append("  serving:")
        lines.append(f"    requests: {sv['total_requests']}")
        for key, n in sv["requests"].items():
            lines.append(f"      {key}: {n}")
        if sv.get("latency"):
            la = sv["latency"]
            lines.append(
                f"    latency: p50 {la['p50_ms']:.3f} ms  "
                f"p95 {la['p95_ms']:.3f} ms  p99 {la['p99_ms']:.3f} ms  "
                f"({la['count']} requests)")
        if sv.get("cache"):
            c = sv["cache"]
            lines.append(f"    result cache: {c['hits']} hits, "
                         f"{c['misses']} misses "
                         f"(hit rate {c['hit_rate']:.1%})")
        if sv.get("requests_by_replica"):
            parts = "  ".join(f"{r}={n}"
                              for r, n in sv["requests_by_replica"].items())
            lines.append(f"    requests by replica: {parts}")
        if sv.get("rate_503"):
            lines.append(f"    503 rate: {sv['rate_503']:.2%}")
        if sv.get("shed"):
            sh = sv["shed"]
            reasons = "  ".join(f"{k}:{v}"
                                for k, v in sh["by_reason"].items())
            pris = "  ".join(f"{k}:{v}"
                             for k, v in sh["by_priority"].items())
            lines.append(f"    shed (429): {sh['total']} "
                         f"[{reasons}] by priority [{pris}]")
        if sv.get("latency_by_priority"):
            for pri, la in sv["latency_by_priority"].items():
                if la:
                    lines.append(
                        f"    latency[{pri}]: p50 {la['p50_ms']:.3f} ms  "
                        f"p99 {la['p99_ms']:.3f} ms  "
                        f"({la['count']} requests)")
        if sv.get("coalesce"):
            co = sv["coalesce"]
            lines.append(
                f"    coalescing: {co['hits']} hits / "
                f"{co['dispatches']} dispatches "
                f"(hit rate {co['hit_rate']:.1%}, dispatch ratio "
                f"{co['dispatch_ratio']:.3f})")
        if sv.get("autoscale"):
            au = sv["autoscale"]
            lines.append(
                f"    autoscale: {au['scale_ups']} up / "
                f"{au['scale_downs']} down"
                + (f" / {au['failed']} failed" if au["failed"] else "")
                + (f"  (replicas now {au['replicas_final']})"
                   if au["replicas_final"] is not None else ""))
            for ev in au["events"]:
                why = f" ({ev['reason']})" if ev.get("reason") else ""
                lines.append(
                    f"      {ev['action']} replica{ev['replica']}"
                    f" -> {ev['replicas']} live{why}")
        if sv.get("drains"):
            lines.append(f"    graceful drains: {sv['drains']}")
        if sv.get("batching"):
            bt = sv["batching"]
            hist = "  ".join(f"{k}:{v}"
                             for k, v in bt["occupancy_hist"].items())
            lines.append(f"    continuous batching: {bt['flushes']} flushes, "
                         f"mean queue depth {bt['mean_queue_depth']:.2f}")
            lines.append(f"      occupancy histogram: {hist}")
        if sv.get("tail_latency"):
            lines.append(
                f"    tail latency attribution "
                f"({sv['traced_requests']} traced requests, slowest "
                f"{len(sv['tail_latency'])}):")
            for t in sv["tail_latency"]:
                where = (f" flush={t['flush']}" if "flush" in t else "")
                lines.append(
                    f"      {str(t['trace_id'])[:16]}… {t['endpoint']} "
                    f"{t['total_ms']:.2f} ms{where}")
                if t["segments_ms"]:
                    lines.append(
                        f"        {_fmt_segments(t['segments_ms'])} (ms)")
        if sv.get("flightrecorder_dumps"):
            dumps = "  ".join(f"{k}:{v}" for k, v in
                              sv["flightrecorder_dumps"].items())
            lines.append(f"    flight recorder dumps: {dumps}")
        lines.append(f"    dispatches: {sv['dispatches']}  "
                     f"recompiles: {sv['recompiles']}  "
                     f"macro appends: {sv['macro_appends']}"
                     + (f"  reloads: {sv['reloads']}"
                        if sv.get("reloads") else ""))

    if summary.get("metrics_check"):
        mc = summary["metrics_check"]
        lines.append("  metrics cross-check (metrics.prom vs events):")
        if mc.get("error"):
            lines.append(f"    ERROR: {mc['error']}")
        else:
            if "requests_agree" not in mc:
                # no serve/ event rows at all (e.g. a zero-request run):
                # nothing was compared, which must not read as a regression
                verdict = "(no serve events to compare)"
            elif mc["requests_agree"] and mc.get("recompiles_agree"):
                verdict = "(agrees with events)"
            else:
                verdict = "(DISAGREES with events)"
            lines.append(
                f"    requests: {mc['requests']}  recompiles: "
                f"{mc['recompiles']}  " + verdict)
            if "steady_state_recompiles" in mc:
                ok = "OK" if mc["steady_state_ok"] else "VIOLATED"
                lines.append(
                    "    steady-state recompiles (from metrics): "
                    f"{mc['steady_state_recompiles']}  [{ok}]")

    if summary.get("reliability"):
        rel = summary["reliability"]
        lines.append("  reliability:")
        out = rel.get("outcome") or {}
        if out:
            lines.append(f"    outcome: {out.get('outcome')} "
                         f"(restarts={out.get('restarts')}, "
                         f"rc={out.get('returncode')})")
        lines.append(f"    restarts: {rel['restarts']}  "
                     f"(hang kills: {rel['hang_kills']})")
        for section, n in rel["deaths_by_section"].items():
            lines.append(f"      died in {section}: {n}")
        if rel["faults_injected"]:
            lines.append("    faults injected:")
            for key, n in rel["faults_injected"].items():
                lines.append(f"      {key}: {n}")
        lines.append(f"    guard trips: {rel['guard_trips']}  "
                     f"checkpoint fallbacks: {rel['checkpoint_fallbacks']}"
                     + (f"  unusable: {rel['checkpoint_unusable']}"
                        if rel["checkpoint_unusable"] else ""))

    if summary.get("elastic"):
        el = summary["elastic"]
        lines.append("  elastic sweep:")
        led = el.get("ledger")
        if led:
            total = (str(led["total_buckets"])
                     if led.get("total_buckets") is not None else "?")
            lines.append(f"    ledger: {led['records']}/{total} buckets "
                         f"recorded, {led['quarantined']} quarantined")
        lines.append(f"    buckets completed: {el['buckets_completed']}  "
                     f"ledger hits (not re-trained): {el['ledger_hits']}")
        lines.append(f"    retries: {el['retries']}  lease takeovers: "
                     f"{el['lease_takeovers']}  quarantined: "
                     f"{el['quarantined']}")
        for worker, n in el["claims_by_worker"].items():
            done = el["completed_by_worker"].get(worker, 0)
            lines.append(f"      {worker}: {n} claims, {done} completed")
        inline = el["completed_by_worker"].get("inline")
        if inline and "inline" not in el["claims_by_worker"]:
            lines.append(f"      inline (single-process): {inline} completed")
        if el["quorum_drops"]:
            drops = ", ".join(
                f"rank{d.get('rank')}:seed{d.get('seed')}"
                for d in el["quorum_drops"])
            lines.append(f"    quorum drops: {drops}")

    if summary.get("promotion"):
        pm = summary["promotion"]
        lines.append("  promotion:")
        head = pm.get("pointer")
        if head:
            sharpe = head.get("valid_sharpe")
            lines.append(
                f"    pointer: generation {head['generation']} "
                f"({head['fingerprint']}…, source={head.get('source')}, "
                f"valid Sharpe "
                f"{sharpe if sharpe is not None else 'n/a'}, "
                f"{head['history']} retained)"
                + (f" ROLLED BACK from g{head['rolled_back_from']}"
                   if head.get("rolled_back_from") is not None else ""))
        lines.append(
            f"    promoted: {pm['promotions']}  rolled back: "
            f"{pm['pointer_rollbacks']} pointer / {pm['fleet_rollbacks']} "
            f"fleet  fleet converged: {pm['fleet_converged']}")
        if pm["rejections_by_reason"]:
            rej = "  ".join(f"{k}:{v}" for k, v
                            in pm["rejections_by_reason"].items())
            lines.append(f"    gate rejections: {rej}")
        rl = pm["reloads"]
        lines.append(f"    reloads: {rl['swapped']} swapped, "
                     f"{rl['noop']} no-op")
        for replica, rows in pm["replica_timeline"].items():
            path = " -> ".join(
                f"{'boot:' if r['boot'] else ''}g{r['generation']}"
                f"({str(r['fingerprint'])[:8]})" for r in rows)
            lines.append(f"      {replica}: {path}")
        if pm.get("converged") is not None:
            fps = set(pm["serving_fingerprints"].values())
            lines.append(
                "    replicas CONVERGED on one generation"
                if pm["converged"]
                else f"    replicas DIVERGED: {sorted(fps)}")

    mh = summary.get("model_health")
    if not mh:
        # deliberate placeholder (not silence): a pre-health-plane run dir
        # renders deterministically with the section present but empty
        lines.append("  model health: (no health data)")
    else:
        lines.append("  model health:")
        if mh.get("moment_violation_max") is not None:
            finite = "finite" if mh.get("finite") else "NON-FINITE"
            lines.append(
                f"    moment violations ({mh.get('split')}): max "
                f"{mh['moment_violation_max']:.6f}  unconditional "
                f"{(mh.get('unc_violation') or 0):.6f}  [{finite}]")
            per = mh.get("moment_violations") or []
            if per:
                vals = "  ".join(f"h{j}={v:.4f}" if v is not None else
                                 f"h{j}=n/a" for j, v in enumerate(per))
                lines.append(f"      per moment: {vals}")
            if mh.get("adv_gap") is not None:
                lines.append(
                    f"    adversarial gap (cond − unc loss): "
                    f"{mh['adv_gap']:.6g}")
            sdf = mh.get("sdf") or {}
            if sdf.get("sdf_mean") is not None:
                lines.append(
                    f"    SDF series: mean {sdf['sdf_mean']:.4f}  vol "
                    f"{(sdf.get('sdf_vol') or 0):.4f}  min "
                    f"{(sdf.get('sdf_min') or 0):.4f}  finite "
                    f"{(sdf.get('sdf_finite_frac') or 0):.1%}")
            pf = mh.get("portfolio") or {}
            if pf.get("weight_hhi") is not None:
                lines.append(
                    f"    portfolio: HHI {pf['weight_hhi']:.4f}  max|w| "
                    f"{(pf.get('weight_max_abs') or 0):.4f}  short "
                    f"{(pf.get('short_fraction') or 0):.1%}  turnover "
                    f"{(pf.get('turnover') or 0):.4f}")
            if mh.get("guard_trips"):
                lines.append(
                    f"    divergence-guard trips: {mh['guard_trips']}")
        if mh.get("reference_profile"):
            lines.append("    reference profile: present")
        if mh.get("drift"):
            dr = mh["drift"]
            psi = (f"{dr['psi_last']:.4f}"
                   if dr.get("psi_last") is not None else "n/a")
            lines.append(f"    drift monitor: {dr['scored']} scored, "
                         f"{dr['alerts']} alerts (last PSI {psi})")
        if mh.get("canary"):
            ca = mh["canary"]
            delta = (f"{ca['max_weight_delta']:.6f}"
                     if ca.get("max_weight_delta") is not None else "n/a")
            lines.append(f"    reload canary: {ca['hot_swaps']} hot-swaps "
                         f"replayed (max |Δw| {delta})")

    slo = summary.get("slo")
    if slo:
        lines.append("  slo:")
        al = slo.get("alerts") or {}
        if al.get("firing_now"):
            for a in al["firing_now"]:
                lines.append(f"    ALERT FIRING: {a}")
        lines.append(
            f"    alerts: {al.get('firings', 0)} fired, "
            f"{al.get('resolves', 0)} resolved")
        for key, v in (slo.get("budget_remaining") or {}).items():
            if isinstance(v, (int, float)):
                lines.append(f"    budget remaining {key}: {v:.4g}")
        pr = slo.get("probe") or {}
        lines.append(
            f"    probes: {pr.get('checks', 0)} checks, "
            f"{pr.get('failures', 0)} failures, "
            f"{pr.get('digest_changes', 0)} digest changes")
        for target, n in (pr.get("failures_by_target") or {}).items():
            lines.append(f"      {target}: {n} failures")

    lines.append("  compile vs execute:")
    tc, te = summary.get("total_compile_s"), summary.get("total_execute_s")
    lines.append(f"    compile total (wall): {tc:.2f}s" if tc is not None
                 else "    compile total (wall): n/a")
    # per-program latencies; they sum past the wall when compiles overlap
    for name, secs in (summary.get("compile_seconds") or {}).items():
        lines.append(f"      {name}: {secs:.2f}s")
    lines.append(f"    execute total: {te:.2f}s" if te is not None
                 else "    execute total: n/a")

    if summary.get("kernel_programs"):
        lines.append("  kernel launch plans (as the card holds them):")
        lines.append("    program                            S     T       N"
                     "  dtype      blocks/SM  regs  local B")
        for name, a in sorted(summary["kernel_programs"].items()):
            held = a.get("held") or {}
            lines.append(
                f"    {name:<32} {_cell(a.get('S'), 3)} {_cell(a.get('T'), 5)}"
                f" {_cell(a.get('N'), 7)}  "
                f"{str(a.get('compute_dtype') or '?'):<9}"
                f" {_cell(held.get('blocks_per_sm'), 9)} "
                f"{_cell(held.get('registers'), 5)} "
                f"{_cell(held.get('local_bytes'), 8)}")

    if summary.get("phases"):
        lines.append("  per-phase throughput:")
        for label, p in summary["phases"].items():
            secs = f"{p['execute_s']:.2f}s" if p["execute_s"] is not None else "n/a"
            eps = (f"{p['epochs_per_s']:.2f} epochs/s"
                   if p["epochs_per_s"] is not None else "n/a")
            epochs = p["epochs"] if p["epochs"] is not None else "?"
            lines.append(f"    {label}: {epochs} epochs in {secs} ({eps})")

    lines.append("  device memory (aggregated over local devices):")
    lines.append(f"    peak bytes in use: {_gib(summary.get('peak_bytes_in_use'))}")
    lines.append(
        f"    peak high-water:   {_gib(summary.get('peak_peak_bytes_in_use'))}"
        f"  ({summary.get('n_memory_events', 0)} snapshots)")

    if summary.get("sharpe"):
        parts = "  ".join(f"{k}={v:.4f}" for k, v in summary["sharpe"].items())
        lines.append(f"  final sharpe: {parts}")
    if summary.get("parity"):
        par = summary["parity"]
        lines.append(f"  parity vs {par['baseline']} (bar {par['bar']}):")
        if par.get("error"):
            lines.append(f"    PARITY COMPARISON FAILED: {par['error']}")
        else:
            for split, d in par["splits"].items():
                if d["within_bar"] is None:
                    ok = "(informational; train is not gated)"
                else:
                    ok = "OK" if d["within_bar"] else "EXCEEDS BAR"
                lines.append(
                    f"    {split}: run {d['run']:+.4f} vs ref "
                    f"{d['reference']:+.4f}  |d|={d['abs_delta']:.4f}  {ok}")
            mv = par.get("moment_violation")
            if mv is None:
                lines.append(
                    "    moment violation: (no moment-condition data)")
            else:
                run = (f"{mv['run']:.6f}" if mv.get("run") is not None
                       else "n/a")
                ref = (f"{mv['reference']:.6f}"
                       if mv.get("reference") is not None else "n/a")
                if mv.get("within_bar") is None:
                    ok = ("(informational; baseline records no "
                          "moment reference)")
                else:
                    ok = "OK" if mv["within_bar"] else "EXCEEDS BAR"
                finite = ("" if mv.get("finite") in (None, True)
                          else "  NON-FINITE")
                lines.append(
                    f"    moment violation: run {run} vs ref {ref}  "
                    f"{ok}{finite}")
    return "\n".join(lines)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearninginassetpricing_paperreplication_torch.report",
        description="Aggregate run-dir telemetry (manifest.json + "
                    "events.jsonl + metrics.jsonl) into a compile/execute/"
                    "memory report",
    )
    p.add_argument("run_dirs", nargs="*", help="Run directories (optional "
                   "when --budget checks only file-scoped entries)")
    p.add_argument("--parity", type=str, default=None, metavar="JSON",
                   help="PARITY_*.json baseline to compare final Sharpes "
                        "against (0.02 bar)")
    p.add_argument("--trace", type=str, default=None, metavar="OUT.json",
                   help="Assemble the run dirs' full event-file families "
                        "(events.jsonl + proc/supervisor/worker/replica "
                        "files) into ONE Chrome trace JSON with request "
                        "flow arrows — open in Perfetto or "
                        "chrome://tracing. Multiple run dirs merge into "
                        "one timeline (e.g. the loadgen client dir next "
                        "to the fleet dir: every retried request is one "
                        "arrowed trace across replicas)")
    p.add_argument("--budget", type=str, default=None, metavar="JSON",
                   help="Check declarative perf budgets (observability/"
                        "budgets.py schema): file-scoped entries against "
                        "their BENCH_*.json artifacts, run-scoped entries "
                        "against each run dir's summary; exits non-zero on "
                        "any regression or missing metric")
    p.add_argument("--bench-trend", type=str, default=None,
                   dest="bench_trend", nargs="?", const="benches/"
                   "history.jsonl", metavar="HISTORY.jsonl",
                   help="Render the checked-in bench trajectory from an "
                        "append-only benches/history.jsonl (written by "
                        "tools/bench_history.py); run dirs optional")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="Emit the machine-readable summary instead of text")
    return p


def _render_bench_trend(history_path) -> Tuple[int, str]:
    """Load tools/bench_history.py (one source of truth for the history
    format) from the repo the history file lives in and render the
    trajectory; returns (rc, text)."""
    import importlib.util

    history_path = Path(history_path)
    tool = history_path.resolve().parent.parent / "tools" / \
        "bench_history.py"
    if not tool.exists():
        return 2, (f"bench-trend: no tools/bench_history.py next to "
                   f"{history_path} (expected {tool})")
    spec = importlib.util.spec_from_file_location("_dlap_bench_history",
                                                  tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # stdlib-only module
    rows = mod.read_history(history_path)
    return 0, mod.format_trend(rows)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if not args.run_dirs and not args.budget and not args.bench_trend:
        print("report: at least one run dir is required (except with "
              "--budget / --bench-trend)", file=sys.stderr)
        return 2
    if args.trace and not args.run_dirs:
        print("report: --trace requires at least one run dir",
              file=sys.stderr)
        return 2
    summaries = []
    rc = 0
    for d in args.run_dirs:
        summary = summarize_run(load_run(d))
        if args.parity:
            summary["parity"] = compare_parity(summary, args.parity)
            if summary["parity"].get("error"):
                # an impossible comparison must not look like a pass
                print(f"warning: {d}: parity comparison failed: "
                      f"{summary['parity']['error']}", file=sys.stderr)
                rc = 1
        summaries.append(summary)

    budget_result = None
    if args.budget:
        from .budgets import BudgetSpecError, check_budgets

        try:
            budget_result = check_budgets(
                args.budget,
                {s["run_dir"]: s for s in summaries})
        except BudgetSpecError as e:
            print(f"budget gate: {e}", file=sys.stderr)
            return 2
        if not budget_result["ok"]:
            rc = 1

    trend_text = None
    if args.bench_trend:
        trend_rc, trend_text = _render_bench_trend(args.bench_trend)
        if trend_rc:
            print(trend_text, file=sys.stderr)
            return trend_rc

    if args.trace:
        from .trace import write_trace

        try:
            info = write_trace(args.run_dirs, args.trace)
        except FileNotFoundError as e:
            print(f"trace: {e}", file=sys.stderr)
            return 2
        print(f"trace written to {args.trace}: {info['n_files']} event "
              f"files, {info['n_span_events']} spans "
              f"({info['n_synthesized_ends']} synthesized ends), "
              f"{info['n_instant_events']} instants, "
              f"{info['n_request_events']} request rows in "
              f"{info['n_traces']} traces "
              f"({info['n_flow_events']} flow events)",
              # --json owns stdout (a consumer pipes it to a parser); the
              # human-facing status line must not corrupt the document
              file=sys.stderr if args.as_json else sys.stdout)

    if args.as_json:
        out: Any = summaries if len(summaries) > 1 else (
            summaries[0] if summaries else [])
        if budget_result is not None:
            out = {"runs": summaries, "budget": budget_result}
        if trend_text is not None:
            # the human-facing trend stays off the JSON document
            print(trend_text, file=sys.stderr)
        print(json.dumps(out, indent=2))
        return rc
    if trend_text is not None:
        print(trend_text)
        if summaries:
            print()
    for i, s in enumerate(summaries):
        if i:
            print()
        print(format_summary(s))
    if len(summaries) > 1:
        print("\ncomparison (headline numbers):")
        for s in summaries:
            wall = (f"{s['wall_clock_s']:.1f}s"
                    if s.get("wall_clock_s") is not None else "n/a")
            tc = (f"{s['total_compile_s']:.1f}s"
                  if s.get("total_compile_s") is not None else "n/a")
            te = (f"{s['total_execute_s']:.1f}s"
                  if s.get("total_execute_s") is not None else "n/a")
            test = (s.get("sharpe") or {}).get("test")
            test = f"{test:.4f}" if test is not None else "n/a"
            print(f"  {s['run_dir']}: wall={wall} compile={tc} "
                  f"execute={te} test_sharpe={test}")
    if budget_result is not None:
        from .budgets import format_budget_report

        if summaries:
            print()
        print(format_budget_report(budget_result))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
