"""Blackbox synthetic prober: availability measured from OUTSIDE, even at
zero organic traffic (the port's copy of the JAX package's
``serving/probe.py``).

The metrics plane is whitebox — it reports what the serving
processes say about themselves, which is exactly nothing when a replica is
wedged, SIGSTOPped, or dead. The :class:`Prober` is the traffic-
independent counterpart: a supervised thread (or standalone CLI) that
every ``interval_s`` fires known-good fixture requests

  * at the PUBLIC port — a ``/v1/weights`` request in the same shape the
    serving canary ring replays (a fixed characteristics matrix + month, on
    the raw-f32 wire), so the probe exercises the full parse → batch →
    dispatch → serialize path a real client pays; the response bytes are
    sha256-digested and digest CHANGES are counted (``probe/digest_change``)
    — a hot-swap legitimately moves the digest once, a flapping one does
    not;
  * at every replica's private admin ``/healthz`` and ``/metrics``,
    discovered from the live ``fleet.json`` layout each cycle — so a
    wedged-but-accepting replica (socket accepts, loop never answers) is
    caught by the probe TIMEOUT between autoscaler polls, and a scaled
    fleet is re-discovered without restarts.

Every check lands in the metrics plane (``dlap_probe_*``: per-target
success gauge, latency gauge, check counters by outcome) and the event
log; FAILURES are additionally emitted as kind-``probe`` rows
(``probe/failure``) — a DURABLE event kind, fsync'd within one flush
window — and render as instant marks in ``report --trace``. A missing or
torn ``fleet.json`` is itself recorded (``probe/layout_unreadable``) and
the prober carries on with its last-known layout: the layout file dying
must not blind the prober exactly when the fleet is in trouble.

:func:`build_sources` wires prober counts + fleet scrapes + the promotion
pointer into the named sources an :class:`~..observability.slo.SLOEngine`
spec references. The CLI (``python -m ….serving.probe``) runs prober +
engine together against a fleet run dir.

Stdlib + numpy only (the fixture payload); never imports torch — the
prober runs in thin parents and ops boxes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import signal
import sys
import threading
import time
import urllib.request
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..observability.events import EventLog
from .fleet import read_fleet_json

DEFAULT_INTERVAL_S = 1.0
DEFAULT_TIMEOUT_S = 2.0
# fixture shape: small enough to cost microseconds per dispatch, real
# enough to ride the production wire end to end
FIXTURE_STOCKS = 32
# server.BINARY_CONTENT_TYPE, duplicated as a literal so the standalone
# probe CLI never imports the serving engine (and with it torch) just for
# a header string; a test holds the two equal
BINARY_CONTENT_TYPE = "application/x-dlap-f32"


def fixture_payload(n_features: int, month: int = 0,
                    n_stocks: int = FIXTURE_STOCKS,
                    seed: int = 1234) -> bytes:
    """The known-good probe body: a deterministic characteristics matrix
    on the raw-f32 wire — the same request shape the serving canary ring
    replays across hot-swaps, so a probe is indistinguishable from a
    (tiny) real query to every layer it crosses."""
    from .loadgen import binary_payload_bytes

    rng = np.random.default_rng(seed)
    individual = rng.standard_normal(
        (n_stocks, n_features)).astype(np.float32)
    return binary_payload_bytes(individual, month)


class ProbeTarget:
    """One probed endpoint: ``kind`` is ``fixture`` (POST the known-good
    body to the public port) or ``get`` (GET an admin path)."""

    __slots__ = ("name", "kind", "url", "body", "content_type")

    def __init__(self, name: str, kind: str, url: str,
                 body: Optional[bytes] = None,
                 content_type: Optional[str] = None):
        self.name = name
        self.kind = kind
        self.url = url
        self.body = body
        self.content_type = content_type


class Prober:
    """The supervised probe loop (see module doc). ``probe_once()`` is one
    sweep over the current target set, exposed for deterministic tests;
    ``start()`` runs it on a daemon thread every ``interval_s``."""

    def __init__(
        self,
        events: EventLog,
        public_url: Optional[str] = None,
        fixture: Optional[bytes] = None,
        fleet_dir=None,
        replica_paths: Tuple[str, ...] = ("/healthz", "/metrics"),
        interval_s: float = DEFAULT_INTERVAL_S,
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ):
        self.events = events
        self.public_url = (public_url.rstrip("/") if public_url else None)
        self.fixture = fixture
        self.fixture_content_type = BINARY_CONTENT_TYPE
        self.fleet_dir = Path(fleet_dir) if fleet_dir else None
        self.replica_paths = tuple(replica_paths)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self.checks = 0
        self.failures = 0
        self.digest_changes = 0
        self.layout_unreadable = 0
        self.cycles = 0
        self._last_layout: Optional[Dict[str, Any]] = None
        self._last_digest: Optional[str] = None
        self._consecutive: Dict[str, int] = {}
        self._pool: Any = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- target discovery ----------------------------------------------------

    def targets(self) -> List[ProbeTarget]:
        """The current probe set: the public fixture target plus two admin
        targets per live replica from ``fleet.json``. A missing/torn
        layout is counted and the LAST-KNOWN layout keeps the replica
        targets alive — tooling losing a file must not read as the fleet
        being healthy."""
        out: List[ProbeTarget] = []
        if self.public_url and self.fixture is not None:
            out.append(ProbeTarget(
                "public", "fixture", self.public_url + "/v1/weights",
                body=self.fixture, content_type=self.fixture_content_type))
        if self.fleet_dir is not None:
            layout = read_fleet_json(self.fleet_dir)
            if layout is None:
                with self._lock:
                    self.layout_unreadable += 1
                self.events.counter("probe/layout_unreadable")
                layout = self._last_layout
            else:
                self._last_layout = layout
            for rid in sorted((layout or {}).get("admin_ports") or {},
                              key=lambda r: int(r)):
                port = layout["admin_ports"][rid]
                for path in self.replica_paths:
                    slug = path.strip("/").replace("/", "_")
                    out.append(ProbeTarget(
                        f"replica{rid}_{slug}", "get",
                        f"http://127.0.0.1:{port}{path}"))
        return out

    # -- one probe -----------------------------------------------------------

    def _check(self, target: ProbeTarget) -> Dict[str, Any]:
        t0 = time.monotonic()
        error = None
        body = b""
        try:
            if target.kind == "fixture":
                req = urllib.request.Request(
                    target.url, data=target.body,
                    headers={"Content-Type": target.content_type},
                    method="POST")
            else:
                req = urllib.request.Request(target.url, method="GET")
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as r:
                body = r.read()
                if r.status != 200:
                    error = f"http_{r.status}"
        except Exception as e:  # noqa: BLE001 — every failure mode counts
            error = type(e).__name__
        latency_s = time.monotonic() - t0
        rec: Dict[str, Any] = {
            "target": target.name, "ok": error is None,
            "latency_s": round(latency_s, 6), "error": error,
        }
        if error is None and target.kind == "fixture":
            rec["digest"] = hashlib.sha256(body).hexdigest()[:16]
        return rec

    def probe_once(self) -> List[Dict[str, Any]]:
        """One sweep over the current targets — CONCURRENT, so a wedged
        target costs one timeout, not one timeout per target in the sweep
        (the cycle cadence survives half the fleet hanging); records every
        result in the event log / metrics registry and returns the result
        list (deterministic target order)."""
        targets = self.targets()
        if self._pool is None:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="probe")
        results = list(self._pool.map(self._check, targets))
        for target, rec in zip(targets, results):
            with self._lock:
                self.checks += 1
                if rec["ok"]:
                    self._consecutive[target.name] = 0
                else:
                    self.failures += 1
                    self._consecutive[target.name] = (
                        self._consecutive.get(target.name, 0) + 1)
                consecutive = self._consecutive[target.name]
            outcome = "ok" if rec["ok"] else str(rec["error"])[:40]
            self.events.counter("probe/check", target=target.name,
                                outcome=outcome)
            self.events.gauge("probe/success", float(rec["ok"]),
                              target=target.name)
            self.events.gauge("probe/latency_ms",
                              round(rec["latency_s"] * 1e3, 3),
                              target=target.name)
            if not rec["ok"]:
                # DURABLE row (kind "probe" rides the events fsync set):
                # the evidence a SIGKILLed prober host may never get to
                # flush twice
                self.events.emit(
                    "probe", "probe/failure", target=target.name,
                    error=rec["error"],
                    latency_ms=round(rec["latency_s"] * 1e3, 3),
                    consecutive=consecutive)
            digest = rec.get("digest")
            if digest is not None:
                with self._lock:
                    changed = (self._last_digest is not None
                               and digest != self._last_digest)
                    self._last_digest = digest
                    if changed:
                        self.digest_changes += 1
                if changed:
                    self.events.counter("probe/digest_change",
                                        target=target.name)
        with self._lock:
            self.cycles += 1
        return results

    # -- SLO source + stats --------------------------------------------------

    def counts(self) -> Tuple[int, int]:
        """Cumulative ``(failures, checks)`` — the ratio source an
        availability/probe-success SLO objective differences."""
        with self._lock:
            return self.failures, self.checks

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cycles": self.cycles,
                "checks": self.checks,
                "failures": self.failures,
                "digest_changes": self.digest_changes,
                "layout_unreadable": self.layout_unreadable,
                "consecutive_failures": {
                    k: v for k, v in sorted(self._consecutive.items())
                    if v},
            }

    # -- thread lifecycle ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        # restartable: the overhead bench toggles the prober off and on
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.probe_once()
                except Exception:
                    pass  # the prober outlives a bad cycle

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="blackbox-prober")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


# -- fleet scraping + SLO source wiring --------------------------------------


class FleetScraper:
    """Cumulative whitebox signals from every live replica's admin JSON
    ``/metrics`` (the same endpoints the autoscaler polls), re-discovered
    from ``fleet.json`` each call.

    The summed ``requests``/``drift`` series must stay MONOTONE or the
    burn-rate windows break exactly during incidents: a replica whose
    scrape times out (wedged, mid-restart) must not drop its LIFETIME
    counts from the sum, and a supervised restart resetting its counters
    to zero must not make the sum dip. Per-replica state carries each
    admin URL's last-seen counts across dropouts and folds pre-restart
    totals into a base offset on reset — the same per-replica merge the
    autoscaler needed for its shed-rate deltas. An unreachable
    replica therefore contributes its last-seen counts (the sum goes
    flat → the window reads "no new data", never "recovered")."""

    def __init__(self, fleet_dir, timeout_s: float = 2.0):
        self.fleet_dir = Path(fleet_dir)
        self.timeout_s = float(timeout_s)
        # admin url -> {base_*: folded pre-restart totals, last_*: the
        # incarnation's last-seen cumulative counts}
        self._state: Dict[str, Dict[str, float]] = {}

    def _scrape(self, url: str) -> Optional[Dict[str, Any]]:
        try:
            with urllib.request.urlopen(
                    url.rstrip("/") + "/metrics",
                    timeout=self.timeout_s) as r:
                return json.loads(r.read())
        except (OSError, ValueError):
            return None

    def sample(self) -> Optional[Dict[str, Any]]:
        layout = read_fleet_json(self.fleet_dir)
        if layout is None and not self._state:
            return None
        urls = list((layout or {}).get("admin_urls") or self._state)
        p99s: List[float] = []
        reached = 0
        for url in urls:
            m = self._scrape(url)
            if m is None:
                continue  # held state keeps its last-seen contribution
            reached += 1
            cur = {"bad": 0.0, "total": 0.0,
                   "drift_alerts": 0.0, "drift_scored": 0.0}
            for key, n in (m.get("requests") or {}).items():
                status = key.rsplit(" ", 1)[-1]
                if status.isdigit():
                    cur["total"] += int(n)
                    if int(status) >= 500:
                        cur["bad"] += int(n)
            drift = (m.get("model_health") or {}).get("drift") or {}
            cur["drift_alerts"] = float(drift.get("alerts") or 0)
            cur["drift_scored"] = float(drift.get("scored") or 0)
            st = self._state.setdefault(url, {
                "base_bad": 0.0, "base_total": 0.0,
                "base_drift_alerts": 0.0, "base_drift_scored": 0.0,
                "last_bad": 0.0, "last_total": 0.0,
                "last_drift_alerts": 0.0, "last_drift_scored": 0.0})
            if cur["total"] < st["last_total"]:
                # counter reset (supervised restart): fold the previous
                # incarnation's totals into the base so the sum never dips
                for k in ("bad", "total", "drift_alerts", "drift_scored"):
                    st[f"base_{k}"] += st[f"last_{k}"]
            for k in ("bad", "total", "drift_alerts", "drift_scored"):
                st[f"last_{k}"] = cur[k]
            p99 = (m.get("latency") or {}).get("p99_ms")
            if isinstance(p99, (int, float)):
                p99s.append(float(p99))
        if not self._state and reached == 0:
            return None
        sums = {k: sum(st[f"base_{k}"] + st[f"last_{k}"]
                       for st in self._state.values())
                for k in ("bad", "total", "drift_alerts", "drift_scored")}
        return {
            "requests": (sums["bad"], sums["total"]),
            "latency_p99_ms": (max(p99s) if p99s else None),
            "drift": (sums["drift_alerts"],
                      max(sums["drift_scored"], sums["drift_alerts"])),
        }


def pointer_freshness_months(pointer_root) -> Optional[float]:
    """Months since the promotion pointer last advanced (the serving-
    freshness SLO source): ``promoted_at`` age / the mean Gregorian month.
    None when there is no pointer — no refit plane means no freshness
    objective, not a firing one."""
    from ..reliability.promotion import read_pointer

    try:
        pointer = read_pointer(pointer_root)
    except Exception:
        return None
    if not pointer:
        return None
    promoted_at = pointer.get("promoted_at")
    if not isinstance(promoted_at, (int, float)):
        return None
    return max(0.0, (time.time() - promoted_at) / (30.44 * 86400.0))


def build_sources(
    prober: Optional[Prober] = None,
    scraper: Optional[FleetScraper] = None,
    pointer_root=None,
) -> Dict[str, Callable[[], Any]]:
    """The named SLO sources (:data:`~..observability.slo.KNOWN_SOURCES`)
    for one deployment: prober counts (blackbox), fleet scrapes
    (whitebox), pointer freshness. Each fleet-scrape tick samples the
    scraper ONCE and the per-source callables read the shared snapshot."""
    sources: Dict[str, Callable[[], Any]] = {}
    if prober is not None:
        sources["probe"] = prober.counts
    if scraper is not None:
        snapshot: Dict[str, Any] = {}
        lock = threading.Lock()
        # one urllib sweep per engine tick would triple-poll the fleet;
        # instead the first-read source scrapes and the rest reuse the
        # snapshot for the next 50 ms
        state: Dict[str, Any] = {"tick": None}

        def shared(key: str):
            def get():
                with lock:
                    now = time.monotonic()
                    if state["tick"] is None or now - state["tick"] > 0.05:
                        state["tick"] = now
                        sample = scraper.sample()
                        snapshot.clear()
                        if sample:
                            snapshot.update(sample)
                return snapshot.get(key)
            return get

        sources["requests"] = shared("requests")
        sources["latency_p99_ms"] = shared("latency_p99_ms")
        sources["drift"] = shared("drift")
    if pointer_root is not None:
        sources["freshness_months"] = (
            lambda: pointer_freshness_months(pointer_root))
    return sources


# -- CLI ---------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Blackbox synthetic prober (+ optional SLO engine) "
                    "for a serving fleet")
    p.add_argument("--url", type=str, default=None,
                   help="public serving URL (e.g. http://127.0.0.1:8787) "
                        "to fire fixture /v1/weights probes at")
    p.add_argument("--fleet_dir", type=str, default=None,
                   help="fleet run dir: fleet.json supplies the per-"
                        "replica admin /healthz + /metrics targets")
    p.add_argument("--run_dir", type=str, required=True,
                   help="telemetry dir: probe/alert events land in "
                        "events.probe.jsonl here")
    p.add_argument("--n_features", type=int, default=46,
                   help="fixture characteristics width (must match the "
                        "served config's individual_feature_dim)")
    p.add_argument("--fixture_month", type=int, default=0)
    p.add_argument("--interval", type=float, default=DEFAULT_INTERVAL_S)
    p.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    p.add_argument("--slo", type=str, default=None,
                   help="slo.json spec: also run the burn-rate SLOEngine "
                        "over the probe + fleet sources")
    p.add_argument("--pointer", type=str, default=None,
                   help="promotion pointer root for the serving-freshness "
                        "source")
    p.add_argument("--alerts_out", type=str, default=None,
                   help="append alert transitions to this JSONL file "
                        "(default: RUN_DIR/alerts.jsonl when --slo is "
                        "given)")
    p.add_argument("--webhook", type=str, default=None,
                   help="also POST alert transitions to this URL")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve the prober's own /metrics (dlap_probe_*, "
                        "dlap_alert_*) on this port")
    return p


def main(argv=None) -> int:
    from ..observability.metrics import MetricsSidecar
    from ..observability.slo import (
        FileAlertSink,
        SLOEngine,
        WebhookAlertSink,
        load_slo,
    )

    args = build_arg_parser().parse_args(argv)
    if not args.url and not args.fleet_dir:
        print("probe: need --url and/or --fleet_dir", file=sys.stderr)
        return 2
    run_dir = Path(args.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    events = EventLog(run_dir, process_index=0,
                      filename="events.probe.jsonl")
    fixture = (fixture_payload(args.n_features, args.fixture_month)
               if args.url else None)
    prober = Prober(events, public_url=args.url, fixture=fixture,
                    fleet_dir=args.fleet_dir,
                    interval_s=args.interval, timeout_s=args.timeout)
    engine = None
    if args.slo:
        spec = load_slo(args.slo)
        sinks: list = [FileAlertSink(
            args.alerts_out or run_dir / "alerts.jsonl")]
        if args.webhook:
            sinks.append(WebhookAlertSink(args.webhook))
        scraper = (FleetScraper(args.fleet_dir)
                   if args.fleet_dir else None)
        sources = build_sources(prober=prober, scraper=scraper,
                                pointer_root=args.pointer)
        # the engine refuses a spec with unwired sources (fail-loud
        # contract); running a deliberate subset is the operator's
        # choice, so each dropped objective is named on stderr
        wired = [o for o in spec["objectives"]
                 if o["source"] in sources]
        for o in spec["objectives"]:
            if o["source"] not in sources:
                print(f"probe: WARNING — objective {o['name']!r} "
                      f"DROPPED: source {o['source']!r} is not wired "
                      f"here (needs --fleet_dir and/or --pointer); it "
                      f"will NOT be monitored", file=sys.stderr)
        if not wired:
            print("probe: no objective in the spec has a wired source "
                  "— nothing to monitor", file=sys.stderr)
            return 2
        engine = SLOEngine(
            dict(spec, objectives=wired), sources,
            events=events, sinks=tuple(sinks),
            poll_s=max(args.interval, 0.25))
    sidecar = None
    if args.metrics_port is not None:
        sidecar = MetricsSidecar([events.metrics], port=args.metrics_port)
        port = sidecar.start()
        print(f"probe metrics on http://127.0.0.1:{port}/metrics",
              flush=True)
    stop = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001 — signal-handler shape
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    prober.start()
    if engine is not None:
        engine.start()
    print(f"prober live: {len(prober.targets())} targets every "
          f"{args.interval:g}s"
          + (", SLO engine armed" if engine is not None else ""),
          flush=True)
    try:
        while not stop.is_set():
            stop.wait(1.0)
    finally:
        prober.stop()
        if engine is not None:
            engine.stop()
        if sidecar is not None:
            sidecar.stop()
        events.close()
        print(json.dumps({"probe": prober.stats(),
                          "slo": engine.state() if engine else None}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
