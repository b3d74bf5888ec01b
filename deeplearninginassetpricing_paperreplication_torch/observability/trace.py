"""Cross-process trace assembly: one run dir → one Chrome trace JSON.

Copied from the JAX package's ``observability/trace.py``: the port's event
rows (``events.py``) are that package's format, so the assembly is the
same, row for row.

A supervised fleet leaves a FAMILY of event files behind — ``events.jsonl``
(process 0), ``events.proc{p}.jsonl`` (multihost workers),
``events.{wid}.jsonl`` (sweep workers), ``events.supervisor*.jsonl``,
``events.faults.jsonl``, and ``replica{i}/events*.jsonl`` (serving
replicas). :func:`assemble_trace` merges them all into a single Chrome
trace-event JSON openable in Perfetto or ``chrome://tracing``:

  * span begin/end pairs → complete (``"X"``) duration events, laned per
    (file, thread) — the ``tid`` each row carries (0 for pre-telemetry
    rows) keeps a thread pool's concurrent compiles on separate tracks;
  * counters → cumulative counter (``"C"``) tracks; gauges → instantaneous
    counter tracks; device-memory snapshots → a bytes-in-use track;
  * fault/restart/takeover/guard rows → instant (``"i"``) events, so a
    SIGKILL or lease takeover is a visible mark on its process's lane;
  * a ``span_begin`` whose end never made it to disk (the writer was
    SIGKILLed mid-span) is **synthesized**: a duration event from the
    begin to the last timestamp its process logged, tagged
    ``{"synthesized_end": true}`` — a crash leaves a truncated bar, not a
    missing one.

Request-scoped flow: ``request`` rows (the serving plane's per-request
trace records, and the load generator's ``client/request`` rows) become
``"X"`` slices carrying their trace id and segment timings, and every
trace id's slices are chained with Chrome flow events (``"s"``/``"t"``/
``"f"``) — client send → each replica's request lane (retries included:
the client reuses one trace id across retries) → the ``serve/flush_
dispatch`` slice of the flush that served it (linked by flush id within
the serving process). One killed-and-retried request reads as ONE arrowed
trace spanning both replicas.

Clock alignment: ``mono`` timestamps are monotonic but per-process (and
reset across supervised restarts), so rows are grouped by (file, run_id)
and each group's monotonic clock is anchored to wall time via the median
of ``ts - mono`` over the group — cross-process ordering comes from wall
clocks (NTP-grade alignment) while within-process durations keep their
monotonic precision. Rows with no ``mono`` (fault-injector appends) use
``ts`` directly.

Multiple run dirs merge into one trace (``report --trace`` accepts the
client's run dir next to the fleet's): each dir contributes its full
event-file family, process lanes are prefixed with the dir name, and the
same wall-clock alignment orders everything globally.

Determinism: output depends only on file contents — files are walked in
sorted order, events sorted by a total key, and timestamps quantized to
integer microseconds — so two invocations over the same run dir(s) emit
byte-identical JSON (asserted in tier-1).

Pure stdlib file reading: no torch, no device, works on live or crashed
run dirs. Exposed as ``report --trace out.json``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

# counter rows rendered as instant marks (one visible tick per incident)
# instead of cumulative counter tracks
INSTANT_NAMES = frozenset({
    "fault/injected",
    "supervise/death",
    "supervise/restart",
    "supervise/outcome",
    "sweep/lease_takeover",
    "sweep/quarantine",
    "guard/trip",
    "checkpoint/fallback",
    "checkpoint/unusable",
    # SLO/probe incidents (also emitted as DURABLE kind-"alert"/"probe"
    # rows; either representation renders as one visible mark)
    "alert/firing",
    "alert/resolved",
    "probe/failure",
})

# row attrs copied into instant-event args (bounded; paths/digests stay in
# the event file)
_INSTANT_ARG_KEYS = (
    "site", "action", "section", "rc", "hang", "outcome", "worker",
    "attempt", "phase", "bucket", "seed", "rank",
    "objective", "window", "severity", "target", "error",
    "burn_long", "burn_short", "consecutive",
)

# request-row attrs copied into the X slice's args: the trace identity,
# the segment breakdown, and the flush link
_REQUEST_ARG_KEYS = (
    "trace_id", "span_id", "parent_id", "endpoint", "method", "status",
    "wire", "replica", "cached", "attempts", "retried",
    "parse_s", "queue_s", "batch_s", "dispatch_s", "dispatch_share_s",
    "serialize_s", "write_s", "flush", "occupancy",
)


def trace_file_paths(run_dir) -> List[Path]:
    """The run dir's full event-file family, deterministically ordered
    (the same glob set the report CLI reads, so trace and report can never
    disagree about which processes exist)."""
    run_dir = Path(run_dir)
    return (sorted(run_dir.glob("events*.jsonl"))
            + sorted(run_dir.glob("replica*/events*.jsonl")))


def read_jsonl(path: Path) -> List[Dict[str, Any]]:
    """Tolerant JSONL reader shared with the report CLI: a missing file or
    a torn tail line (crashed writer) yields fewer rows, never an error."""
    rows: List[Dict[str, Any]] = []
    try:
        text = Path(path).read_text()
    except OSError:
        return rows
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn tail line from a crashed writer
        if isinstance(row, dict):
            rows.append(row)
    return rows


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _group_offsets(rows: List[Dict[str, Any]]) -> Dict[Any, float]:
    """Per-run_id wall-clock anchor for one file's monotonic clock:
    ``median(ts - mono)`` over the rows that carry both. The median (not
    the first row) rides out scheduler jitter between the two clock reads
    and any mid-run NTP step."""
    samples: Dict[Any, List[float]] = {}
    for r in rows:
        ts, mono = r.get("ts"), r.get("mono")
        if isinstance(ts, (int, float)) and isinstance(mono, (int, float)):
            samples.setdefault(r.get("run_id"), []).append(ts - mono)
    return {rid: _median(v) for rid, v in samples.items()}


def _aligned_ts(row: Dict[str, Any], offsets: Dict[Any, float]
                ) -> Optional[float]:
    """One row's wall-aligned timestamp (seconds), or None when the row
    carries no usable clock at all."""
    mono = row.get("mono")
    if isinstance(mono, (int, float)):
        off = offsets.get(row.get("run_id"))
        if off is not None:
            return mono + off
    ts = row.get("ts")
    if isinstance(ts, (int, float)):
        return ts
    return None


def assemble_trace(run_dirs) -> Dict[str, Any]:
    """Build the Chrome trace dict for one run dir — or a LIST of run
    dirs merged into one timeline (client + fleet: the flow arrows then
    span both sides of every request). Raises FileNotFoundError when any
    directory holds no event files — an empty contribution must not look
    like a successful export."""
    if isinstance(run_dirs, (str, os.PathLike)):
        run_dirs = [run_dirs]
    run_dirs = [Path(d) for d in run_dirs]
    multi = len(run_dirs) > 1
    dir_paths: List[Tuple[Path, Path]] = []  # (run_dir, event file)
    for run_dir in run_dirs:
        paths = trace_file_paths(run_dir)
        if not paths:
            raise FileNotFoundError(
                f"no events*.jsonl files under {run_dir} — nothing to "
                "trace")
        dir_paths.extend((run_dir, p) for p in paths)

    # pass 1: read + align every file, find the global origin
    files: List[Tuple[str, List[Dict], Dict[Any, float]]] = []
    t0: Optional[float] = None
    for run_dir, path in dir_paths:
        rows = read_jsonl(path)
        offsets = _group_offsets(rows)
        rel = str(path.relative_to(run_dir))
        label = f"{run_dir.name}/{rel}" if multi else rel
        files.append((label, rows, offsets))
        for r in rows:
            at = _aligned_ts(r, offsets)
            if at is not None:
                t0 = at if t0 is None else min(t0, at)
    if t0 is None:
        raise FileNotFoundError(
            "event files under "
            + ", ".join(str(d) for d in run_dirs)
            + " contain no timestamped rows")

    def us(aligned: float) -> int:
        return int(round((aligned - t0) * 1e6))

    events: List[Dict[str, Any]] = []
    n_spans = n_synthesized = n_instants = n_requests = 0
    # trace_id -> [(start_us, pid, tid), ...] slice anchors for flow chains
    request_slices: Dict[str, List[Tuple[int, int, int]]] = {}
    # (pid, run_id, flush_id) -> (start_us, pid, tid) flush-dispatch slices
    flush_slices: Dict[Tuple[int, Any, Any], Tuple[int, int, int]] = {}
    # trace_id -> [(pid, run_id, flush_id), ...] flush links seen on rows
    flush_links: Dict[str, List[Tuple[int, Any, Any]]] = {}
    for pid, (label, rows, offsets) in enumerate(files):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                       "tid": 0, "args": {"sort_index": pid}})
        # per-(run_id, tid) open-span stacks for dangling-begin synthesis;
        # last timestamp per run_id bounds what a dead writer's clock saw
        open_spans: Dict[Tuple[Any, int], List[Tuple[str, int, Dict]]] = {}
        last_ts: Dict[Any, int] = {}
        counters: Dict[str, float] = {}
        for row in rows:
            at = _aligned_ts(row, offsets)
            if at is None:
                continue
            t = us(at)
            rid = row.get("run_id")
            last_ts[rid] = max(last_ts.get(rid, t), t)
            kind = row.get("kind")
            name = str(row.get("name", ""))
            tid = row.get("tid")
            tid = int(tid) if isinstance(tid, (int, float)) else 0
            if kind == "span_begin":
                open_spans.setdefault((rid, tid), []).append((name, t, row))
            elif kind == "request":
                # one per-request trace record → one slice on its lane,
                # anchored for the trace-id flow chain
                dur = row.get("duration_s")
                dur_us = (int(round(float(dur) * 1e6))
                          if isinstance(dur, (int, float)) else 0)
                args = {k: row[k] for k in _REQUEST_ARG_KEYS
                        if row.get(k) is not None}
                start = t - dur_us
                events.append({
                    "ph": "X", "name": name, "cat": "request",
                    "pid": pid, "tid": tid,
                    "ts": start, "dur": dur_us, "args": args,
                })
                n_requests += 1
                trace_id = row.get("trace_id")
                if isinstance(trace_id, str) and trace_id:
                    request_slices.setdefault(trace_id, []).append(
                        (start, pid, tid))
                    if row.get("flush") is not None:
                        flush_links.setdefault(trace_id, []).append(
                            (pid, rid, row["flush"]))
            elif kind == "span_end":
                dur = row.get("duration_s")
                dur_us = (int(round(float(dur) * 1e6))
                          if isinstance(dur, (int, float)) else 0)
                args: Dict[str, Any] = {}
                if row.get("status") and row["status"] != "ok":
                    args["status"] = row["status"]
                    if row.get("error"):
                        args["error"] = row["error"]
                if name == "serve/flush_dispatch":
                    # a flow-arrow target: requests reference this flush
                    # by id within the same process incarnation
                    if row.get("flush") is not None:
                        args["flush"] = row["flush"]
                        flush_slices.setdefault(
                            (pid, rid, row["flush"]),
                            (t - dur_us, pid, tid))
                events.append({
                    "ph": "X", "name": name, "cat": "span",
                    "pid": pid, "tid": tid,
                    "ts": t - dur_us, "dur": dur_us, "args": args,
                })
                n_spans += 1
                # retire the matching begin (topmost with this name) so it
                # is not synthesized at EOF
                stack = open_spans.get((rid, tid))
                if stack:
                    for i in range(len(stack) - 1, -1, -1):
                        if stack[i][0] == name:
                            stack.pop(i)
                            break
            elif (kind in ("alert", "probe")
                  or (kind == "counter" and name in INSTANT_NAMES)):
                # SLO transitions and probe failures are their own durable
                # kinds; they mark the timeline exactly like the counter-
                # shaped incidents
                args = {k: row[k] for k in _INSTANT_ARG_KEYS
                        if row.get(k) is not None}
                events.append({
                    "ph": "i", "name": name, "cat": "incident", "s": "p",
                    "pid": pid, "tid": tid, "ts": t, "args": args,
                })
                n_instants += 1
            elif kind == "counter":
                value = row.get("value")
                inc = float(value) if isinstance(value, (int, float)) else 1.0
                counters[name] = counters.get(name, 0.0) + inc
                events.append({
                    "ph": "C", "name": name, "pid": pid, "tid": 0, "ts": t,
                    "args": {"total": counters[name]},
                })
            elif kind == "gauge":
                value = row.get("value")
                if isinstance(value, (int, float)):
                    events.append({
                        "ph": "C", "name": name, "pid": pid, "tid": 0,
                        "ts": t, "args": {"value": float(value)},
                    })
            elif kind == "memory":
                totals = row.get("totals") or {}
                in_use = totals.get("bytes_in_use")
                if isinstance(in_use, (int, float)):
                    events.append({
                        "ph": "C", "name": "device_memory", "pid": pid,
                        "tid": 0, "ts": t,
                        "args": {"bytes_in_use": float(in_use)},
                    })
        # EOF: every still-open span lost its end row (crash / SIGKILL /
        # torn tail) — synthesize a truncated bar to the last timestamp its
        # run logged so the work is visible, not vanished
        for (rid, tid), stack in sorted(
                open_spans.items(),
                key=lambda kv: (str(kv[0][0]), kv[0][1])):
            for name, t_begin, row in stack:
                t_end = max(last_ts.get(rid, t_begin), t_begin)
                events.append({
                    "ph": "X", "name": name, "cat": "span",
                    "pid": pid, "tid": tid,
                    "ts": t_begin, "dur": t_end - t_begin,
                    "args": {"synthesized_end": True},
                })
                n_synthesized += 1

    # flow chains: every trace id's slices — client send, each server
    # attempt (retries reuse the id), then the flush dispatch(es) that
    # served it — arrowed s → t → … → f in wall-time order. Chains of one
    # slice draw no arrow.
    n_flows = 0
    for trace_id in sorted(request_slices):
        anchors = list(request_slices[trace_id])
        for link in flush_links.get(trace_id, ()):
            slice_ = flush_slices.get(link)
            if slice_ is not None:
                anchors.append(slice_)
        # dedup (a retried request could reference one flush twice), then
        # total order by time/lane
        anchors = sorted(set(anchors))
        if len(anchors) < 2:
            continue
        for i, (ts, pid, tid) in enumerate(anchors):
            ph = "s" if i == 0 else ("f" if i == len(anchors) - 1 else "t")
            ev = {"ph": ph, "id": trace_id, "name": "request_flow",
                  "cat": "flow", "pid": pid, "tid": tid, "ts": ts}
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice, not the next
            events.append(ev)
            n_flows += 1

    # total deterministic order: metadata first, then by time/lane/name
    def sort_key(e: Dict[str, Any]):
        return (0 if e["ph"] == "M" else 1, e.get("ts", -1), e["pid"],
                e.get("tid", 0), e["ph"], e["name"], str(e.get("id", "")),
                json.dumps(e.get("args", {}), sort_keys=True))

    events.sort(key=sort_key)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "run_dir": run_dirs[0].name,
            "run_dirs": [d.name for d in run_dirs],
            "n_files": len(files),
            "n_span_events": n_spans,
            "n_synthesized_ends": n_synthesized,
            "n_instant_events": n_instants,
            "n_request_events": n_requests,
            "n_flow_events": n_flows,
            "n_traces": len(request_slices),
        },
    }


def write_trace(run_dirs, out_path) -> Dict[str, Any]:
    """Assemble + write the trace JSON (one run dir or a list — client +
    fleet merge into one timeline); returns the ``otherData`` summary.
    Deterministic serialization (sorted keys, fixed separators) so two
    invocations over the same run dir(s) produce byte-identical files."""
    trace = assemble_trace(run_dirs)
    out_path = Path(out_path)
    out_path.write_text(
        json.dumps(trace, sort_keys=True, separators=(",", ":")))
    return trace["otherData"]
