"""Replicated serving: R supervised engine processes on one shared port (the
port's copy of the JAX package's ``serving/fleet.py``).

Each replica is a full ``serving.server --server async`` process — its own
engine, CUDA graphs, continuous batcher, and per-process result-cache
shard — bound to the SAME (host, port) via ``SO_REUSEPORT``: the kernel
spreads incoming connections across live listeners, so R replicas give R×
the GIL-bound parse/dispatch capacity with no userspace load balancer. Each
replica runs under its own :class:`~..reliability.supervisor.Supervisor`
(one watch thread per replica in this parent): a crash or hang is detected
by heartbeat staleness, the process group is killed, and the replica is
restarted with backoff — during which the fleet keeps serving at R-1
capacity (clients see dropped connections, retry onto survivors, and zero
requests go unserved).

Artifact layout under the fleet run dir::

    run_dir/
      replica0/  heartbeat.json, events.jsonl, manifest.json, supervised.log
      replica1/  ...
      events.supervisor.replica{i}.jsonl   (supervise/* spans + counters)

The report CLI aggregates across all of these (per-replica request counts,
occupancy, restarts) from the one fleet run dir. ``fleet.json`` has the
JAX package's layout, key for key, so either package reads the other's.

Module level stays stdlib-only: the fleet parent never imports torch's
device side, so it holds no CUDA context — only the replicas do.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from ..observability.events import EventLog
from ..observability.heartbeat import read_state
from ..reliability.faults import ENV_EVENTS, ENV_PLAN, ENV_STATE
from ..reliability.supervisor import RestartPolicy, Supervisor

_ROOT_PKG = __name__.rsplit(".", 2)[0]

# serving replicas restart much faster than training jobs: there is no
# resume state to protect, and every second down is lost capacity. The
# watchdog flare (SIGUSR1 before SIGKILL) gives a stale replica one grace
# window to dump its flight recorder — the server CLI installs the handler
REPLICA_POLICY = RestartPolicy(
    heartbeat_timeout_s=120.0,
    poll_s=0.5,
    max_restarts=5,
    min_uptime_s=10.0,
    backoff_base_s=0.5,
    backoff_max_s=10.0,
    prekill_signal=signal.SIGUSR1,
    prekill_grace_s=0.75,
)


def server_child_argv(args, replica_id: int, replica_run_dir,
                      port: int, admin_port: Optional[int] = None
                      ) -> List[str]:
    """The ``serving.server`` command line for one replica, rebuilt from
    the parsed parent args (explicit field-by-field: the parent's
    ``--replicas`` and ``--run_dir`` must not leak through).

    ``admin_port``: the replica's PRIVATE per-replica endpoint (the
    rolling-update path targets it); the shared ``port`` stays the
    SO_REUSEPORT serving socket. With a ``--pointer`` the replica boots
    from the promotion pointer instead of a fixed ``--checkpoint_dirs``
    list — so a replica restarted mid-promotion converges to the
    pointer's generation on its own. Every replica runs with the parent's
    ``--device``, ``--kernel`` and ``--compute_dtype``, and the parent's
    ``--mesh`` over its device slice (``--mesh_slice i % N:N`` from
    ``--mesh_slices N``)."""
    argv = [sys.executable, "-m", f"{_ROOT_PKG}.serving.server",
            "--server", "async",
            "--host", args.host, "--port", str(port), "--reuse_port",
            "--replica_id", str(replica_id),
            "--run_dir", str(replica_run_dir),
            "--max_queue", str(args.max_queue),
            "--bulk_threshold", str(getattr(args, "bulk_threshold", 0.5)),
            "--cache_size", str(args.cache_size),
            "--device", args.device,
            "--kernel", args.kernel,
            "--compute_dtype", args.compute_dtype]
    if getattr(args, "no_coalesce", False):
        argv += ["--no_coalesce"]
    if getattr(args, "pointer", None):
        argv += ["--pointer", str(args.pointer)]
    else:
        argv += ["--checkpoint_dirs", *args.checkpoint_dirs]
    if admin_port is not None:
        argv += ["--admin_port", str(admin_port)]
    if args.data_dir:
        argv += ["--data_dir", args.data_dir,
                 "--macro_split", args.macro_split]
    if args.macro_npy:
        argv += ["--macro_npy", args.macro_npy]
    if args.stock_buckets:
        argv += ["--stock_buckets", args.stock_buckets]
    if args.batch_buckets:
        argv += ["--batch_buckets", args.batch_buckets]
    if getattr(args, "mesh", None):
        argv += ["--mesh", args.mesh]
        n_slices = getattr(args, "mesh_slices", None)
        if n_slices:
            # the replica↔device-slice lease: replica i of a co-hosted fleet
            # lays its mesh over disjoint contiguous slice i % N. The parent
            # never touches a device, so it stamps the INDEX and the replica
            # resolves its own devices (partition.slice_devices)
            argv += ["--mesh_slice", f"{replica_id % n_slices}:{n_slices}"]
    if args.max_batch is not None:
        argv += ["--max_batch", str(args.max_batch)]
    if args.no_warmup:
        argv += ["--no_warmup"]
    if getattr(args, "reference_profile", None):
        argv += ["--reference_profile", str(args.reference_profile)]
    if getattr(args, "drift_every", None) is not None:
        argv += ["--drift_every", str(args.drift_every)]
    if getattr(args, "drift_psi_threshold", None) is not None:
        argv += ["--drift_psi_threshold", str(args.drift_psi_threshold)]
    return argv


def write_fleet_json(run_dir, layout: Dict[str, Any]) -> Path:
    """Atomically (tmp + ``os.replace``) rewrite the fleet run dir's
    ``fleet.json`` live-layout record. The autoscaler rewrites it on every
    scale event, so tooling and the report CLI always read a complete
    document describing the CURRENT replica set — never a torn one."""
    path = Path(run_dir) / "fleet.json"
    tmp = path.with_suffix(f".tmp.{os.getpid()}")
    tmp.write_text(json.dumps(layout, indent=2))
    os.replace(tmp, path)
    return path


def read_fleet_json(run_dir) -> Optional[Dict[str, Any]]:
    """Read a fleet run dir's live layout; missing/torn → None (the
    atomic writer makes torn unreachable in practice)."""
    try:
        return json.loads((Path(run_dir) / "fleet.json").read_text())
    except (OSError, json.JSONDecodeError):
        return None


class ReplicaFleet:
    """Supervised replica processes + their watch threads — a DYNAMIC set.

    Boots with the construction-time argvs; :meth:`add_replica` grows the
    set live (the autoscaler's scale-up) and :meth:`stop_replica` stops
    one member (scale-down — graceful when the replica already drained
    itself to a clean exit, SIGKILL otherwise). Replica ids are never
    reused within one fleet object: a scaled-down slot keeps its summary,
    and the next scale-up gets a fresh id — so per-replica run dirs and
    event files stay attributable."""

    def __init__(
        self,
        child_argvs: Sequence[Sequence[str]],
        run_dir,
        policy: Optional[RestartPolicy] = None,
        env: Optional[Dict[str, str]] = None,
    ):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.policy = policy if policy is not None else REPLICA_POLICY
        # fault-plan plumbing (same default as the supervise CLI): a plan
        # without persistent state would re-kill a restarted replica at the
        # same site forever; one fleet-shared state file makes a kill fire
        # exactly once ACROSS the fleet
        self.env = dict(os.environ if env is None else env)
        if self.env.get(ENV_PLAN):
            self.env.setdefault(
                ENV_STATE, str(self.run_dir / "fault_state.json"))
            self.env.setdefault(
                ENV_EVENTS, str(self.run_dir / "events.faults.jsonl"))
        self.replica_dirs: List[Path] = []
        self.supervisors: List[Supervisor] = []
        self._events: List[EventLog] = []
        self._threads: List[Optional[threading.Thread]] = []
        self.summaries: List[Optional[Dict[str, Any]]] = []
        self._started = False
        self._lock = threading.Lock()
        for argv in child_argvs:
            self.add_replica(argv)

    @property
    def replicas(self) -> int:
        return len(self.supervisors)

    def add_replica(self, argv: Sequence[str]) -> int:
        """Register one more supervised replica (id = the next slot); when
        the fleet is already running, its watch thread starts immediately
        (the autoscaler's scale-up path). Returns the replica id."""
        with self._lock:
            i = len(self.supervisors)
            rdir = self.run_dir / f"replica{i}"
            rdir.mkdir(parents=True, exist_ok=True)
            events = EventLog(
                self.run_dir, process_index=0,
                filename=f"events.supervisor.replica{i}.jsonl")
            sup = Supervisor(
                list(argv),
                heartbeat_path=rdir / "heartbeat.json",
                policy=self.policy,
                events=events,
                log_path=rdir / "supervised.log",
                env=self.env,
            )
            self.replica_dirs.append(rdir)
            self.supervisors.append(sup)
            self._events.append(events)
            self._threads.append(None)
            self.summaries.append(None)
            if self._started:
                self._start_one(i)
        return i

    def _start_one(self, i: int) -> None:
        sup = self.supervisors[i]

        def run(i=i, sup=sup):
            self.summaries[i] = sup.run()

        t = threading.Thread(target=run, daemon=True,
                             name=f"supervise-replica{i}")
        t.start()
        self._threads[i] = t

    def start(self) -> None:
        self._started = True
        for i in range(len(self.supervisors)):
            if self._threads[i] is None:
                self._start_one(i)

    def live_ids(self) -> List[int]:
        """Replica ids whose watch thread is still running (the replica is
        being served/supervised — not drained, crash-looped, or stopped)."""
        return [i for i, t in enumerate(self._threads)
                if t is not None and t.is_alive()]

    def replica_pid(self, i: int) -> Optional[int]:
        """Replica ``i``'s live child pid (None between incarnations) —
        the SLO detection drill signals a replica directly (SIGKILL for
        dead, SIGSTOP for wedged-but-accepting) and measures seconds to
        the firing alert."""
        return self.supervisors[i].child_pid

    def wait_ready(self, timeout: float = 300.0,
                   section: str = "serve/accepting",
                   indices: Optional[Sequence[int]] = None) -> None:
        """Block until every replica in ``indices`` (default: all live
        slots) reaches heartbeat `section` (written once its socket
        accepts). Raises on timeout or a crash-looped replica, with the
        dead replica's log tail in the message."""
        deadline = time.monotonic() + timeout
        pending = set(range(self.replicas) if indices is None
                      else indices)
        while pending:
            for i in sorted(pending):
                hb = read_state(
                    self.replica_dirs[i] / "heartbeat.json"
                ).get("heartbeat") or {}
                if hb.get("section") == section:
                    pending.discard(i)
                    continue
                summary = self.summaries[i]
                if summary is not None:
                    raise RuntimeError(
                        f"replica{i} ended during startup "
                        f"({summary.get('outcome')}): "
                        + self._log_tail(i))
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"replicas {sorted(pending)} not ready after "
                    f"{timeout:.0f}s: " + self._log_tail(min(pending)))
            if pending:
                time.sleep(0.1)

    def _log_tail(self, i: int, n: int = 12) -> str:
        try:
            lines = (self.replica_dirs[i] / "supervised.log").read_text(
                errors="replace").splitlines()
            return "\n".join(lines[-n:])
        except OSError:
            return "(no log)"

    def stop_replica(self, i: int, timeout: float = 30.0
                     ) -> Optional[Dict[str, Any]]:
        """Stop supervising replica ``i`` and end its process. When the
        replica already exited cleanly (a graceful drain: rc 0 →
        supervisor outcome ``success``), this just joins the watch
        thread; otherwise the supervisor SIGKILLs the process group.
        Closes the slot's supervisor EventLog too — a long-running
        autoscaled fleet must not leak one open fd per scale cycle
        (``close()`` is idempotent, so a later ``stop()`` is safe)."""
        t = self._threads[i]
        if t is not None and t.is_alive():
            self.supervisors[i].request_stop()
            t.join(timeout=timeout)
        self._events[i].close()
        return self.summaries[i]

    def stop(self, timeout: float = 30.0) -> List[Optional[Dict[str, Any]]]:
        for sup in self.supervisors:
            sup.request_stop()
        for t in self._threads:
            if t is not None:
                t.join(timeout=timeout)
        for ev in self._events:
            ev.close()
        return self.summaries


class RollingUpdater:
    """Health-gated rolling hot-swap of a replica fleet to the promotion
    pointer's current generation, with automatic rollback.

    Replicas are reloaded ONE at a time through their private admin
    endpoints (``--admin_port``): the fleet never drops below R-1
    serving capacity, and a request in flight during a swap lands either
    fully pre-swap or fully post-swap (the engine swaps under its
    dispatch lock). After each reload the replica must pass a health
    window over its OWN ``/metrics``:

      * its params fingerprint matches the pointer's (a torn candidate
        whose reload fell back — or errored — fails here);
      * ``steady_state_captures`` stayed 0 (a hot swap copies into the
        tensors the CUDA graphs read and must never capture);
      * no new 5xx responses beyond the pre-swap baseline;
      * p99 latency under ``p99_budget_ms`` when configured.

    Any failed or regressed swap triggers automatic rollback: the pointer
    reverts (``reliability.promotion.rollback``) and every
    already-swapped replica is re-reloaded — converging the fleet back
    on the incumbent generation. A replica that DIES mid-reload (the
    ``serve/reload`` kill site) is restarted by its supervisor and boots
    from the pointer; the updater polls its admin endpoint until the
    fingerprint converges instead of failing the roll.

    Stdlib-only (urllib over the loopback admin ports): the updater runs
    in thin parents that never touch the device.
    """

    def __init__(
        self,
        admin_urls: Sequence[str],
        pointer_root,
        events: Optional[EventLog] = None,
        health_polls: int = 4,
        health_interval_s: float = 0.25,
        p99_budget_ms: Optional[float] = None,
        reload_timeout_s: float = 120.0,
        http_timeout_s: float = 30.0,
    ):
        self.admin_urls = [u.rstrip("/") for u in admin_urls]
        self.pointer_root = pointer_root
        self.events = events
        self.health_polls = int(health_polls)
        self.health_interval_s = float(health_interval_s)
        self.p99_budget_ms = p99_budget_ms
        self.reload_timeout_s = float(reload_timeout_s)
        self.http_timeout_s = float(http_timeout_s)

    # -- tiny loopback HTTP (stdlib; admin ports are local) ------------------

    def _get_json(self, url: str, path: str):
        import json as _json
        import urllib.request

        with urllib.request.urlopen(url + path,
                                    timeout=self.http_timeout_s) as r:
            return _json.loads(r.read())

    def _post_json(self, url: str, path: str, payload):
        import json as _json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            url + path, data=_json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.http_timeout_s) as r:
                return r.status, _json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, _json.loads(e.read())
            except (ValueError, OSError):
                return e.code, {"error": "unreadable error body"}

    def _try_metrics(self, url: str):
        try:
            return self._get_json(url, "/metrics")
        except (OSError, ValueError):
            return None  # replica down / mid-restart

    @staticmethod
    def _count_5xx(metrics) -> int:
        n = 0
        for key, value in (metrics or {}).get("requests", {}).items():
            status = key.rsplit(" ", 1)[-1]
            if status.isdigit() and int(status) >= 500:
                n += int(value)
        return n

    def _counter(self, name: str, **attrs) -> None:
        if self.events is not None:
            self.events.counter(name, **attrs)

    # -- the roll ------------------------------------------------------------

    def roll(self) -> Dict[str, Any]:
        """Read the pointer, swap every replica one at a time, health-gate
        each; rollback on the first failure. Returns
        ``{"status": "promoted"|"rolled_back", ...}``."""
        from ..reliability.promotion import read_pointer
        from ..reliability.promotion import rollback as pointer_rollback

        pointer = read_pointer(self.pointer_root)
        if pointer is None:
            raise ValueError(f"no promotion pointer under "
                             f"{self.pointer_root}")
        target_fp = str(pointer.get("params_fingerprint") or "")[:16]
        replicas: List[Dict[str, Any]] = []
        swapped: List[str] = []
        for url in self.admin_urls:
            verdict = self._swap_one(url, pointer, target_fp)
            replicas.append(verdict)
            if verdict["ok"]:
                swapped.append(url)
                continue
            # rollback: revert the pointer FIRST (so restarting replicas
            # boot onto the incumbent), then re-reload everyone already
            # swapped — and the failed replica, in case it half-advanced
            from ..reliability.promotion import PromotionError

            try:
                reverted = pointer_rollback(
                    self.pointer_root, reason=verdict["reason"],
                    events=self.events)
            except PromotionError as e:
                # nothing to revert to (the first-ever promoted
                # generation failed its roll): the pointer stays put —
                # re-reloading swapped replicas would just re-swap them
                # onto the same failed generation, so report the
                # divergence instead of masking it
                self._counter("promote/fleet_rollback_failed",
                              reason=verdict["reason"], error=str(e))
                return {"status": "rollback_failed",
                        "reason": verdict["reason"],
                        "failed_replica": url, "replicas": replicas,
                        "rollback_error": str(e),
                        "swapped": list(swapped)}
            rolled: List[str] = []
            for u in swapped + [url]:
                status, _body = self._reload_until_converged(
                    u, str(reverted.get("params_fingerprint") or "")[:16])
                rolled.append(f"{u}: {status}")
            self._counter("promote/fleet_rollback",
                          reason=verdict["reason"],
                          generation=reverted["generation"])
            return {"status": "rolled_back", "reason": verdict["reason"],
                    "failed_replica": url, "replicas": replicas,
                    "pointer_generation": reverted["generation"],
                    "rolled": rolled}
        self._counter("promote/fleet_converged",
                      generation=pointer["generation"],
                      fingerprint=target_fp, replicas=len(self.admin_urls))
        return {"status": "promoted",
                "pointer_generation": pointer["generation"],
                "fingerprint": target_fp, "replicas": replicas}

    def _reload_until_converged(self, url: str, target_fp: str):
        """POST /v1/reload; if the replica dies mid-reload (connection
        drop), poll its admin endpoint until the supervisor's restart
        converges it to the pointer on boot. Returns (status, body) —
        status "converged"/"reloaded"/HTTP code/"timeout"."""
        deadline = time.monotonic() + self.reload_timeout_s
        while time.monotonic() < deadline:
            try:
                status, body = self._post_json(url, "/v1/reload", {})
            except (OSError, ValueError):
                # died mid-reload (or still restarting): give the
                # supervisor time, then check whether the boot already
                # converged to the pointer's generation
                time.sleep(0.5)
                m = self._try_metrics(url)
                fp = ((m or {}).get("engine") or {}).get(
                    "params_fingerprint")
                if fp is not None and fp == target_fp:
                    return "converged", m
                continue
            if status == 200:
                return "reloaded", body
            return status, body
        return "timeout", None

    def _swap_one(self, url: str, pointer, target_fp: str
                  ) -> Dict[str, Any]:
        baseline = self._try_metrics(url)
        errors_before = self._count_5xx(baseline)
        status, body = self._reload_until_converged(url, target_fp)
        verdict: Dict[str, Any] = {"replica": url, "reload": str(status),
                                   "ok": False}
        if status == "timeout":
            verdict["reason"] = "reload_timeout"
            return verdict
        if status not in ("reloaded", "converged"):
            verdict["reason"] = (
                f"reload_error_{status}: "
                f"{(body or {}).get('error', '')}"[:300])
            return verdict
        # post-reload health window over THIS replica's own metrics
        checks: Dict[str, Any] = {}
        metrics = None
        for _ in range(max(1, self.health_polls)):
            time.sleep(self.health_interval_s)
            metrics = self._try_metrics(url) or metrics
        if metrics is None:
            verdict["reason"] = "health_unreachable"
            return verdict
        engine = metrics.get("engine") or {}
        checks["fingerprint"] = engine.get("params_fingerprint") == target_fp
        steady = engine.get("steady_state_captures")
        checks["steady_state_captures"] = steady in (0, None)
        new_5xx = max(0, self._count_5xx(metrics) - errors_before)
        checks["no_new_5xx"] = new_5xx == 0
        if self.p99_budget_ms is not None:
            p99 = (metrics.get("latency") or {}).get("p99_ms")
            checks["p99_under_budget"] = (
                p99 is None or p99 <= self.p99_budget_ms)
        verdict["checks"] = checks
        verdict["new_5xx"] = new_5xx
        failed = [k for k, v in checks.items() if not v]
        if failed:
            verdict["reason"] = "health_" + ",".join(failed)
            return verdict
        verdict["ok"] = True
        return verdict


def main_from_server_args(args) -> int:
    """The ``serving.server --replicas R`` parent: spawn, supervise, park.

    Never creates a CUDA context — replicas do all the serving; the
    parent only watches heartbeats and restarts the dead.
    """
    from .aserver import pick_free_port

    if not args.run_dir:
        print("--replicas requires --run_dir (per-replica heartbeats and "
              "supervision live there)", file=sys.stderr)
        return 2
    if args.server != "async":
        print("--replicas requires --server async (the threaded path is "
              "deprecated and single-process only)", file=sys.stderr)
        return 2
    run_dir = Path(args.run_dir)
    port = args.port if args.port else pick_free_port(args.host)
    # every replica gets a private admin endpoint: the rolling-update
    # path must be able to target ONE replica, which the shared
    # SO_REUSEPORT port cannot do. Explicit --admin_port P → P, P+1, …;
    # default → free ports. Recorded in fleet.json for tooling.
    if args.admin_port:
        admin_ports = [args.admin_port + i for i in range(args.replicas)]
    else:
        admin_ports = []
        for _ in range(args.replicas):
            p = pick_free_port()
            while p in admin_ports or p == port:
                p = pick_free_port()
            admin_ports.append(p)
    argvs = [
        server_child_argv(args, i, run_dir / f"replica{i}", port,
                          admin_port=admin_ports[i])
        for i in range(args.replicas)
    ]
    fleet = ReplicaFleet(argvs, run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)

    def make_argv(replica_id: int, admin_port: int) -> List[str]:
        # the autoscaler's scale-up path: one more child on the SAME
        # shared port, its own run dir + private admin endpoint
        return server_child_argv(args, replica_id,
                                 run_dir / f"replica{replica_id}", port,
                                 admin_port=admin_port)

    from .autoscale import FleetController

    controller = FleetController(
        fleet, make_argv, args.host, port,
        admin_ports={i: p for i, p in enumerate(admin_ports)},
        pointer=getattr(args, "pointer", None),
        mesh=getattr(args, "mesh", None),
        mesh_slices=getattr(args, "mesh_slices", None))
    # the CONFIGURED layout, on disk before any replica is up: a slow or
    # wedged boot is still inspectable (port + admin endpoints); the
    # post-ready publish below and every scale event rewrite it live
    controller.publish_layout(replica_ids=range(args.replicas))
    autoscaler = None
    events = None
    flight = None
    if getattr(args, "autoscale", False):
        from ..observability.events import EventLog
        from .autoscale import AutoscalePolicy, Autoscaler
        from .flight import FlightRecorder

        events = EventLog(run_dir, process_index=0,
                          filename="events.autoscaler.jsonl")
        # the parent's own recorder: the decision ring must actually
        # reach disk — autosave while dirty, final dump at shutdown —
        # so an overload post-mortem shows WHY the fleet was shedding
        flight = FlightRecorder(run_dir=run_dir, events=events)
        flight.start_autosave()
        policy = AutoscalePolicy(
            min_replicas=args.min_replicas or 1,
            max_replicas=args.max_replicas or max(4, args.replicas),
            poll_s=args.autoscale_poll_s,
            up_queue_depth=args.autoscale_up_depth,
            down_queue_depth=args.autoscale_down_depth,
            up_hysteresis=args.autoscale_up_hysteresis,
            down_hysteresis=args.autoscale_down_hysteresis,
            cooldown_s=args.autoscale_cooldown_s,
        )
        autoscaler = Autoscaler(controller, policy, events=events,
                                flight=flight)
    stop = threading.Event()

    def _on_signal(signum, frame):  # noqa: ARG001 — signal-handler shape
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        fleet.start()
        fleet.wait_ready()
        # the boot layout, published once every replica accepts (live ids
        # are only meaningful after start); every scale event rewrites it
        controller.publish_layout()
        if autoscaler is not None:
            autoscaler.start()
            print(f"autoscaler live: {autoscaler.policy.min_replicas}.."
                  f"{autoscaler.policy.max_replicas} replicas, "
                  f"poll {autoscaler.policy.poll_s}s", flush=True)
        print(f"fleet of {fleet.replicas} replicas serving on "
              f"http://{args.host}:{port} (SO_REUSEPORT)", flush=True)
        while not stop.is_set():
            stop.wait(1.0)
    finally:
        if autoscaler is not None:
            autoscaler.stop()
        if flight is not None:
            flight.stop_autosave()
            flight.dump("shutdown")
        fleet.stop()
        if events is not None:
            events.close()
    return 0
