"""SLO & alerting plane: error-budget burn-rate engine over the metrics
plane, with a firing/resolved alert state machine and pluggable sinks (the
port's copy of the JAX package's ``observability/slo.py``; the two read
and write the same ``slo.json`` and the same ``alert`` rows).

The serving stack is autonomous (refit → promotion gate → rolling hot-swap
→ load-adaptive fleet), which is only safe if the system can tell a human,
fast, when it stops meeting its objectives. This module supplies the
*definition* of "meeting its objectives" (a verified ``slo.json`` spec) and
the *detector* (:class:`SLOEngine`):

  * **Spec** — ``slo.json`` declares objectives over named metric
    *sources*. Two kinds:

      - ``ratio``: an error-budget objective (availability, probe success,
        drift-alert rate). The source yields CUMULATIVE ``(bad, total)``
        counts; the engine differences them over sliding windows and
        evaluates classic multi-window multi-burn-rate alerts — a window
        pair fires when the burn rate (``bad_fraction / (1 - target)``)
        exceeds its threshold over BOTH the long and the short window, so
        a brief blip (short only) or a slow bleed already absorbed
        (long only) does not page.
      - ``value``: a threshold objective (p99 latency, serving freshness =
        months since the last promoted refit). The source yields an
        instantaneous value; the alert fires when every sample inside
        ``sustain_s`` breached ``max`` and the window has real coverage.

    :func:`load_slo` validates the document field by field (unknown kinds,
    non-(0,1) targets, short >= long windows are spec errors, never
    silently ignored) and digest-verifies an adjacent ``.sha256`` sidecar
    when present; :func:`write_slo` writes atomically with the sidecar.

  * **Engine** — :meth:`SLOEngine.tick` samples every source, updates the
    bounded per-objective sample rings, evaluates every window, and drives
    the per-(objective, window) state machine. Transitions emit DURABLE
    ``alert/*`` event rows (kind ``alert`` joins the events fsync set — a
    SIGKILLed process loses at most one flush window of alert evidence),
    land in every configured sink, and ride the
    :class:`~..serving.flight.FlightRecorder` alert ring. Every tick also
    refreshes the ``dlap_alert_*`` gauges (firing / burn rate / budget
    remaining) in the live metrics registry, so every ``/metrics`` scrape
    carries the current alert posture.

  * **Sinks** — :class:`FileAlertSink` (append-only ``alerts.jsonl``) and
    :class:`WebhookAlertSink` (JSON POST; failures are counted, never
    raised — a dead receiver must not take down the detector).

Stdlib-only by contract (like :mod:`.metrics` and
:mod:`..reliability.promotion` at import): the engine runs in thin fleet
parents and ops tooling that never touch the device.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1
SLO_FILENAME = "slo.json"

# objective kinds and the alert severities the spec may declare
KINDS = ("ratio", "value")
SEVERITIES = ("page", "ticket", "info")

# sources the standard wiring (serving.probe.build_sources) provides; a
# spec may name others when the caller wires its own callables
KNOWN_SOURCES = (
    "probe", "requests", "drift", "latency_p99_ms", "freshness_months",
)


class SLOSpecError(ValueError):
    """Malformed slo.json — names the offending field."""


# -- the spec ----------------------------------------------------------------


def default_slo() -> Dict[str, Any]:
    """The shipped production spec (repo-root ``slo.json`` mirrors this):
    availability + probe success as multi-window burn rates, p99 latency
    and serving freshness as sustained thresholds, drift-alert rate as a
    slow-burn budget."""
    return {
        "schema": SCHEMA_VERSION,
        "objectives": [
            {
                "name": "availability",
                "kind": "ratio",
                "source": "requests",
                "target": 0.999,
                "windows": [
                    {"long_s": 3600.0, "short_s": 300.0,
                     "burn_rate": 14.4, "severity": "page"},
                    {"long_s": 21600.0, "short_s": 1800.0,
                     "burn_rate": 6.0, "severity": "ticket"},
                ],
            },
            {
                "name": "probe_success",
                "kind": "ratio",
                "source": "probe",
                "target": 0.99,
                "windows": [
                    {"long_s": 600.0, "short_s": 60.0,
                     "burn_rate": 6.0, "severity": "page"},
                ],
            },
            {
                "name": "p99_latency",
                "kind": "value",
                "source": "latency_p99_ms",
                "max": 250.0,
                "sustain_s": 120.0,
                "severity": "ticket",
            },
            {
                "name": "serving_freshness",
                "kind": "value",
                "source": "freshness_months",
                "max": 2.0,
                "sustain_s": 3600.0,
                "severity": "ticket",
            },
            {
                "name": "drift_alert_rate",
                "kind": "ratio",
                "source": "drift",
                "target": 0.95,
                "windows": [
                    {"long_s": 3600.0, "short_s": 600.0,
                     "burn_rate": 4.0, "severity": "ticket"},
                ],
            },
        ],
    }


def drill_spec(long_s: float = 8.0, short_s: float = 2.0,
               burn_rate: float = 6.0) -> Dict[str, Any]:
    """A seconds-scale availability spec for detection drills and benches:
    one probe-success objective whose window pair fires within a few
    seconds of a replica dying under the prober."""
    return {
        "schema": SCHEMA_VERSION,
        "objectives": [
            {
                "name": "availability",
                "kind": "ratio",
                "source": "probe",
                "target": 0.99,
                "windows": [
                    {"long_s": float(long_s), "short_s": float(short_s),
                     "burn_rate": float(burn_rate), "severity": "page"},
                ],
            },
        ],
    }


def validate_slo(doc: Any) -> Dict[str, Any]:
    """Field-by-field spec validation; returns the document. Raises
    :class:`SLOSpecError` naming the offending field — an SLO that cannot
    be evaluated as written must fail loudly, not silently not-alert."""
    if not isinstance(doc, dict):
        raise SLOSpecError("slo spec must be a JSON object")
    if doc.get("schema") != SCHEMA_VERSION:
        raise SLOSpecError(
            f"slo spec schema must be {SCHEMA_VERSION}, "
            f"got {doc.get('schema')!r}")
    objectives = doc.get("objectives")
    if not isinstance(objectives, list) or not objectives:
        raise SLOSpecError("slo spec needs a non-empty 'objectives' list")
    seen: set = set()
    for i, obj in enumerate(objectives):
        where = f"objectives[{i}]"
        if not isinstance(obj, dict):
            raise SLOSpecError(f"{where} must be an object")
        name = obj.get("name")
        if not isinstance(name, str) or not name:
            raise SLOSpecError(f"{where}.name must be a non-empty string")
        if name in seen:
            raise SLOSpecError(f"duplicate objective name {name!r}")
        seen.add(name)
        kind = obj.get("kind")
        if kind not in KINDS:
            raise SLOSpecError(
                f"{where}.kind must be one of {KINDS}, got {kind!r}")
        source = obj.get("source")
        if not isinstance(source, str) or not source:
            raise SLOSpecError(f"{where}.source must be a non-empty string")
        if kind == "ratio":
            target = obj.get("target")
            if not isinstance(target, (int, float)) or not 0 < target < 1:
                raise SLOSpecError(
                    f"{where}.target must be in (0, 1), got {target!r}")
            windows = obj.get("windows")
            if not isinstance(windows, list) or not windows:
                raise SLOSpecError(
                    f"{where}.windows must be a non-empty list")
            for j, w in enumerate(windows):
                ww = f"{where}.windows[{j}]"
                if not isinstance(w, dict):
                    raise SLOSpecError(f"{ww} must be an object")
                for key in ("long_s", "short_s", "burn_rate"):
                    v = w.get(key)
                    if not isinstance(v, (int, float)) or v <= 0:
                        raise SLOSpecError(
                            f"{ww}.{key} must be a positive number, "
                            f"got {v!r}")
                if w["short_s"] >= w["long_s"]:
                    raise SLOSpecError(
                        f"{ww}: short_s ({w['short_s']}) must be < "
                        f"long_s ({w['long_s']})")
                sev = w.get("severity", "page")
                if sev not in SEVERITIES:
                    raise SLOSpecError(
                        f"{ww}.severity must be one of {SEVERITIES}, "
                        f"got {sev!r}")
        else:  # value
            mx = obj.get("max")
            if not isinstance(mx, (int, float)) or mx <= 0:
                raise SLOSpecError(
                    f"{where}.max must be a positive number, got {mx!r}")
            sustain = obj.get("sustain_s")
            if not isinstance(sustain, (int, float)) or sustain <= 0:
                raise SLOSpecError(
                    f"{where}.sustain_s must be a positive number, "
                    f"got {sustain!r}")
            sev = obj.get("severity", "page")
            if sev not in SEVERITIES:
                raise SLOSpecError(
                    f"{where}.severity must be one of {SEVERITIES}, "
                    f"got {sev!r}")
    return doc


def write_slo(path, doc: Dict[str, Any]) -> Path:
    """Validate + atomically write a spec with its ``.sha256`` sidecar
    (the same verified-artifact shape as checkpoints/pointers)."""
    validate_slo(doc)
    path = Path(path)
    data = (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()
    tmp = path.with_suffix(f".tmp.{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)
    sidecar = path.with_name(path.name + ".sha256")
    tmp = sidecar.with_suffix(f".tmp.{os.getpid()}")
    tmp.write_text(json.dumps(
        {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}))
    os.replace(tmp, sidecar)
    return path


def load_slo(path) -> Dict[str, Any]:
    """Read + digest-verify (when the sidecar exists) + validate a spec.
    A torn or tampered file raises :class:`SLOSpecError` naming it."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError as e:
        raise SLOSpecError(f"cannot read slo spec {path}: {e}") from e
    sidecar = path.with_name(path.name + ".sha256")
    if sidecar.exists():
        try:
            meta = json.loads(sidecar.read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise SLOSpecError(
                f"unreadable slo sidecar {sidecar}: {e}") from e
        digest = hashlib.sha256(data).hexdigest()
        if meta.get("sha256") != digest:
            raise SLOSpecError(
                f"slo spec {path} does not match its sha256 sidecar "
                f"(file {digest[:12]}…, sidecar "
                f"{str(meta.get('sha256'))[:12]}…)")
    try:
        doc = json.loads(data)
    except json.JSONDecodeError as e:
        raise SLOSpecError(f"slo spec {path} is not valid JSON: {e}") from e
    return validate_slo(doc)


# -- alert sinks -------------------------------------------------------------


class AlertSink:
    """One delivery channel; ``deliver`` must never raise (failures are
    tallied on the sink so the report/console can surface them)."""

    def __init__(self):
        self.delivered = 0
        self.failed = 0

    def deliver(self, alert: Dict[str, Any]) -> None:
        try:
            self._deliver(alert)
        except Exception:
            self.failed += 1
        else:
            self.delivered += 1

    def _deliver(self, alert: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError


class FileAlertSink(AlertSink):
    """Append-only JSONL file (one alert transition per line)."""

    def __init__(self, path):
        super().__init__()
        self.path = Path(path)

    def _deliver(self, alert: Dict[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(alert, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())


class WebhookAlertSink(AlertSink):
    """JSON POST to an HTTP endpoint (PagerDuty/Slack-shaped receivers);
    short timeout so a dead receiver cannot stall the engine thread."""

    def __init__(self, url: str, timeout_s: float = 5.0):
        super().__init__()
        self.url = str(url)
        self.timeout_s = float(timeout_s)

    def _deliver(self, alert: Dict[str, Any]) -> None:
        import urllib.request

        req = urllib.request.Request(
            self.url, data=json.dumps(alert, sort_keys=True).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s):
            pass


# -- sample series -----------------------------------------------------------


class _Series:
    """Bounded ring of (mono_ts, a, b) samples. For ratio objectives the
    payload is CUMULATIVE (bad, total); for value objectives it is
    (value, breached).

    ``maxlen`` must be sized for the window it serves: a ring that holds
    fewer samples than the longest window's span silently shrinks the
    window (the far edge becomes the ring's oldest sample), turning a
    6-hour budget into a minutes-long one. The engine sizes it from the
    objective horizon and its own poll cadence."""

    def __init__(self, max_age_s: float, maxlen: int = 4096):
        self.max_age_s = float(max_age_s)
        self._ring: deque = deque(maxlen=maxlen)

    def append(self, now: float, a: float, b: float) -> None:
        self._ring.append((now, a, b))
        while self._ring and now - self._ring[0][0] > self.max_age_s:
            self._ring.popleft()

    def window_ratio(self, now: float,
                     window_s: float) -> Optional[float]:
        """Bad fraction over the trailing window from cumulative (bad,
        total) samples; None when the window holds no traffic (no new
        totals) or fewer than two samples — no data must mean no alert
        decision, never a spurious 0% or 100%."""
        oldest = None
        newest = None
        for ts, bad, total in self._ring:
            if ts < now - window_s:
                continue
            if oldest is None:
                oldest = (ts, bad, total)
            newest = (ts, bad, total)
        if oldest is None or newest is None or newest is oldest:
            return None
        d_total = newest[2] - oldest[2]
        d_bad = newest[1] - oldest[1]
        if d_total <= 0:
            return None
        return min(1.0, max(0.0, d_bad / d_total))

    def sustained_breach(self, now: float, sustain_s: float
                         ) -> Optional[bool]:
        """True when every sample in the trailing ``sustain_s`` breached
        and the window has coverage from its far edge (>= half the window
        old); None with no samples in the window."""
        samples = [(ts, breached) for ts, _v, breached in self._ring
                   if ts >= now - sustain_s]
        if not samples:
            return None
        if now - samples[0][0] < sustain_s * 0.5:
            return None  # not enough history to call it sustained
        return all(breached for _ts, breached in samples)

    def last_value(self) -> Optional[float]:
        if not self._ring:
            return None
        return self._ring[-1][1]


# -- the engine --------------------------------------------------------------


class SLOEngine:
    """Burn-rate evaluation + alert state machine over pluggable sources.

    ``sources``: ``{source_name: callable}`` where a ratio source returns
    cumulative ``(bad, total)`` (or None while unavailable) and a value
    source returns a float (or None). :meth:`tick` is one full evaluation,
    exposed so tests and the drill drive the engine deterministically;
    :meth:`start` runs it on a supervised daemon thread.
    """

    def __init__(
        self,
        spec: Dict[str, Any],
        sources: Dict[str, Callable[[], Any]],
        events: Any = None,
        flight: Any = None,
        sinks: Tuple[AlertSink, ...] = (),
        poll_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.spec = validate_slo(spec)
        self.sources = dict(sources)
        self.events = events
        self.flight = flight
        self.sinks = list(sinks)
        self.poll_s = float(poll_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}
        # (objective, window_idx) -> {"firing": bool, "since_mono": float,
        #                             "since_ts": float}
        self._states: Dict[Tuple[str, int], Dict[str, Any]] = {}
        # the bounded transition ring the flight recorder dump rides
        self.alerts: deque = deque(maxlen=64)
        self.ticks = 0
        self.source_errors = 0
        # last emitted value per gauge key: rows are written ON CHANGE
        # only, so a quiescent deployment's engine does not grow the
        # event log by ~17 identical rows per tick forever (the metrics
        # registry retains the last value for scrapes, and the console
        # reads "last recorded value" — both unaffected by skipping
        # repeats)
        self._gauge_last: Dict[Tuple[str, Tuple], float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        missing = sorted({obj["source"] for obj in self.spec["objectives"]
                          if obj["source"] not in self.sources})
        if missing:
            # the spec's fail-loud contract extends to the wiring: an
            # objective whose source is not provided would silently
            # never evaluate — no gauge, no alert, ever. Callers that
            # deliberately run a subset must filter the spec first
            # (the probe CLI does, with a printed warning per drop).
            raise SLOSpecError(
                "objectives reference sources with no wired callable: "
                + ", ".join(missing)
                + f" (wired: {sorted(self.sources) or 'none'})")
        for obj in self.spec["objectives"]:
            if obj["kind"] == "ratio":
                horizon = max(w["long_s"] for w in obj["windows"])
            else:
                horizon = obj["sustain_s"]
            # keep one extra window of history so the far edge of the
            # longest window always has a sample to difference against —
            # and size the ring to HOLD that horizon at this poll
            # cadence (a capacity-trimmed ring would silently shrink the
            # window to ring-age), bounded for pathological poll rates
            maxlen = int(horizon * 2.0 / max(self.poll_s, 0.05)) + 16
            self._series[obj["name"]] = _Series(
                max_age_s=horizon * 2.0, maxlen=min(maxlen, 500_000))

    # -- evaluation ----------------------------------------------------------

    def _append(self, obj: Dict[str, Any], sample: Any,
                now: float) -> None:
        if sample is None:
            return
        series = self._series[obj["name"]]
        if obj["kind"] == "ratio":
            bad, total = sample
            series.append(now, float(bad), float(total))
        else:
            value = float(sample)
            series.append(now, value, value > float(obj["max"]))

    def _evaluate_ratio(self, obj: Dict[str, Any], now: float
                        ) -> List[Dict[str, Any]]:
        series = self._series[obj["name"]]
        budget = 1.0 - float(obj["target"])
        out = []
        for idx, w in enumerate(obj["windows"]):
            ratio_long = series.window_ratio(now, w["long_s"])
            ratio_short = series.window_ratio(now, w["short_s"])
            burn_long = (ratio_long / budget
                         if ratio_long is not None else None)
            burn_short = (ratio_short / budget
                          if ratio_short is not None else None)
            should_fire = (burn_long is not None
                           and burn_short is not None
                           and burn_long >= w["burn_rate"]
                           and burn_short >= w["burn_rate"])
            should_resolve = (burn_long is not None
                              and burn_short is not None
                              and burn_long < w["burn_rate"]
                              and burn_short < w["burn_rate"])
            out.append({
                "objective": obj["name"], "window_idx": idx,
                "window": f"{w['long_s']:g}s/{w['short_s']:g}s",
                "severity": w.get("severity", "page"),
                "burn_threshold": w["burn_rate"],
                "burn_long": burn_long, "burn_short": burn_short,
                "ratio_long": ratio_long,
                "budget_remaining": (
                    max(0.0, 1.0 - ratio_long / budget)
                    if ratio_long is not None else None),
                "should_fire": should_fire,
                "should_resolve": should_resolve,
            })
        return out

    def _evaluate_value(self, obj: Dict[str, Any], now: float
                        ) -> List[Dict[str, Any]]:
        series = self._series[obj["name"]]
        breached = series.sustained_breach(now, float(obj["sustain_s"]))
        last = series.last_value()
        return [{
            "objective": obj["name"], "window_idx": 0,
            "window": f"sustain {obj['sustain_s']:g}s",
            "severity": obj.get("severity", "page"),
            "value": last, "max": float(obj["max"]),
            # burn analogue for the gauges: how far past the threshold
            "burn_long": (last / float(obj["max"])
                          if last is not None else None),
            "burn_short": None,
            "budget_remaining": (
                max(0.0, 1.0 - last / float(obj["max"]))
                if last is not None else None),
            "should_fire": breached is True,
            "should_resolve": (breached is False
                               and last is not None
                               and last <= float(obj["max"])),
        }]

    def tick(self) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the alert TRANSITIONS it caused
        (empty on a quiet tick). Gauges refresh every tick regardless."""
        now = self.clock()
        transitions: List[Dict[str, Any]] = []
        # sample every source OUTSIDE the engine lock: a fleet scrape can
        # block for seconds on a wedged replica's timeout, and that must
        # not stall every concurrent firing()/state() reader — exactly
        # the moment those calls matter
        raw: Dict[str, Any] = {}
        errors = 0
        for obj in self.spec["objectives"]:
            try:
                raw[obj["name"]] = self.sources[obj["source"]]()
            except Exception:
                errors += 1
        with self._lock:
            self.ticks += 1
            self.source_errors += errors
            for obj in self.spec["objectives"]:
                self._append(obj, raw.get(obj["name"]), now)
            for obj in self.spec["objectives"]:
                if obj["kind"] == "ratio":
                    verdicts = self._evaluate_ratio(obj, now)
                else:
                    verdicts = self._evaluate_value(obj, now)
                firing_any = False
                for v in verdicts:
                    key = (v["objective"], v["window_idx"])
                    state = self._states.setdefault(
                        key, {"firing": False, "since_mono": None,
                              "since_ts": None})
                    if v["should_fire"] and not state["firing"]:
                        state.update(firing=True, since_mono=now,
                                     since_ts=time.time())
                        transitions.append(self._transition(
                            "firing", v, state))
                    elif v["should_resolve"] and state["firing"]:
                        duration = (now - state["since_mono"]
                                    if state["since_mono"] is not None
                                    else None)
                        state.update(firing=False, since_mono=None,
                                     since_ts=None)
                        t = self._transition("resolved", v, state)
                        if duration is not None:
                            t["firing_duration_s"] = round(duration, 3)
                        transitions.append(t)
                    firing_any = firing_any or state["firing"]
                    self._gauge("alert/burn_rate",
                                v.get("burn_long"),
                                objective=v["objective"],
                                window=v["window"])
                    self._gauge("alert/budget_remaining",
                                v.get("budget_remaining"),
                                objective=v["objective"],
                                window=v["window"])
                self._gauge("alert/firing", float(firing_any),
                            objective=obj["name"])
        for t in transitions:
            self._emit(t)
        return transitions

    def _transition(self, what: str, verdict: Dict[str, Any],
                    state: Dict[str, Any]) -> Dict[str, Any]:
        t = {
            "state": what,
            "objective": verdict["objective"],
            "window": verdict["window"],
            "severity": verdict["severity"],
            "ts": round(time.time(), 6),
        }
        for key in ("burn_long", "burn_short", "burn_threshold",
                    "ratio_long", "value", "max", "budget_remaining"):
            if verdict.get(key) is not None:
                v = verdict[key]
                t[key] = round(v, 6) if isinstance(v, float) else v
        return t

    def _emit(self, transition: Dict[str, Any]) -> None:
        """One state change → the durable event row, every sink, and the
        flight-recorder ring. Never raises: alert delivery failing must
        not stop the detector from detecting."""
        self.alerts.append(transition)
        if self.events is not None:
            try:
                fields = {k: v for k, v in transition.items()
                          if k not in ("state", "ts")}
                # kind "alert" is in events._DURABLE_KINDS: the row
                # fsyncs within one flush window of the transition
                self.events.emit(
                    "alert", f"alert/{transition['state']}", **fields)
            except Exception:
                pass
        if self.flight is not None:
            try:
                self.flight.record_alert(dict(transition))
                if transition["state"] == "firing":
                    # a firing alert is an incident: arm the same burst
                    # trigger 5xx storms use, so the evidence rings dump
                    self.flight.note_alert()
            except Exception:
                pass
        for sink in self.sinks:
            sink.deliver(transition)

    def _gauge(self, name: str, value: Optional[float], **labels) -> None:
        if value is None or self.events is None:
            return
        rounded = round(float(value), 6)
        key = (name, tuple(sorted(labels.items())))
        if self._gauge_last.get(key) == rounded:
            return  # unchanged: no new row (see _gauge_last)
        self._gauge_last[key] = rounded
        try:
            self.events.gauge(name, rounded, **labels)
        except Exception:
            pass

    # -- introspection -------------------------------------------------------

    def firing(self) -> List[Dict[str, Any]]:
        """Currently-firing (objective, window) states, deterministic
        order."""
        with self._lock:
            out = []
            for (objective, idx), state in sorted(self._states.items()):
                if state["firing"]:
                    out.append({"objective": objective, "window_idx": idx,
                                "since_ts": state["since_ts"]})
            return out

    def state(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "ticks": self.ticks,
                "source_errors": self.source_errors,
                "firing": [
                    {"objective": obj, "window_idx": idx,
                     "since_ts": st["since_ts"]}
                    for (obj, idx), st in sorted(self._states.items())
                    if st["firing"]],
                "alerts_tail": list(self.alerts)[-8:],
                "sinks": [
                    {"kind": type(s).__name__, "delivered": s.delivered,
                     "failed": s.failed} for s in self.sinks],
            }

    # -- thread lifecycle ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.tick()
                except Exception:
                    pass  # the detector outlives a bad tick

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-engine")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
