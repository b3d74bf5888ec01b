"""Load-adaptive autoscaling: the closed loop from the metrics plane to
the replica set (the port's copy of the JAX package's
``serving/autoscale.py``).

Everything reactive already existed as parts — per-replica metrics
(queue depth, occupancy, latency percentiles, 503/429 tallies), a
supervisor that restarts, a fleet that spawns — but the replica count was
fixed at boot. The :class:`Autoscaler` closes the loop: a control thread
scrapes every live replica's private admin ``/metrics`` endpoint, derives
three pressure signals —

  * **queue depth** — mean pending requests per replica (the same
    ``batcher.pending`` the DAGOR-style admission layer sheds on);
  * **shed/reject rate** — the per-tick delta of 429 + 503 responses over
    the per-tick delta of requests (load the fleet is already refusing);
  * **p99 latency** — the replicas' own served-latency percentiles;

— and grows or shrinks the ``SO_REUSEPORT`` replica set live through
:class:`~.fleet.ReplicaFleet`. Scale-up spawns one supervised replica and
blocks on its ``wait_ready`` heartbeat; scale-down POSTs ``/v1/drain`` to
the victim's admin endpoint (it stops accepting, flushes its lanes, and
exits rc 0 — the supervisor records *success*, not a death) with a
SIGKILL fallback for a replica too wedged to drain. **Hysteresis** (N
consecutive over/under-threshold ticks) plus a post-scale **cooldown**
keep the loop from flapping on a noisy signal, and every scale event
atomically rewrites the fleet run dir's ``fleet.json`` so tooling and the
report CLI always see the live layout.

Decisions are evidence: every tick appends to a bounded ring that the
parent's :class:`~.flight.FlightRecorder` includes in crash dumps (an
overload dump shows *why* the fleet was shedding), and scale actions emit
``fleet/scale`` counters + a ``fleet/replicas`` gauge into the events
plane the report CLI aggregates.

The module is deliberately thin on imports (events + faults only): it
runs inside the fleet PARENT, which supervises replicas but never creates
a CUDA context.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.request
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..observability.events import EventLog
from ..reliability.faults import inject


@dataclasses.dataclass
class AutoscalePolicy:
    """Everything the control loop decides from.

    Scale **up** when ANY pressure signal stays tripped for
    ``up_hysteresis`` consecutive ticks: mean queue depth per replica at or
    above ``up_queue_depth``, shed/reject rate (429+503 per request, per
    tick) at or above ``up_shed_rate``, or p99 above ``up_p99_ms`` (when
    set). Scale **down** when the fleet has been quiet — depth at or below
    ``down_queue_depth`` AND zero sheds — for ``down_hysteresis``
    consecutive ticks. ``cooldown_s`` after any scale event gates the next
    one, so spawn/drain transients can never feed back into the signal
    they changed (the anti-flap guarantee, with hysteresis the second
    half)."""

    min_replicas: int = 1
    max_replicas: int = 4
    poll_s: float = 0.5
    up_queue_depth: float = 8.0
    up_shed_rate: float = 0.02
    up_p99_ms: Optional[float] = None
    down_queue_depth: float = 1.0
    up_hysteresis: int = 2
    down_hysteresis: int = 8
    cooldown_s: float = 5.0
    drain_timeout_s: float = 10.0
    ready_timeout_s: float = 300.0


class FleetController:
    """The Autoscaler's levers over a live :class:`~.fleet.ReplicaFleet`.

    Scrapes per-replica JSON ``/metrics`` over the private admin ports,
    spawns supervised replicas (``make_argv(replica_id, admin_port)``
    builds the child command line), drains victims through ``/v1/drain``,
    and atomically republishes ``fleet.json`` after every change. Split
    from :class:`Autoscaler` so the control loop is unit-testable against
    a fake controller with no processes."""

    def __init__(
        self,
        fleet,
        make_argv: Callable[[int, int], Sequence[str]],
        host: str,
        port: int,
        admin_ports: Optional[Dict[int, int]] = None,
        pointer: Optional[str] = None,
        http_timeout_s: float = 10.0,
        metrics_timeout_s: float = 2.0,
        mesh: Optional[str] = None,
        mesh_slices: Optional[int] = None,
    ):
        self.fleet = fleet
        self.make_argv = make_argv
        self.host, self.port = host, port
        self.admin_ports: Dict[int, int] = dict(admin_ports or {})
        self.pointer = pointer
        # the mesh-serving record for fleet.json: the --mesh spec every
        # replica serves with and the slice count (replica i serves from
        # disjoint contiguous slice i % mesh_slices)
        self.mesh = mesh
        self.mesh_slices = mesh_slices
        self.http_timeout_s = float(http_timeout_s)
        # the per-tick scrape gets its own SHORT timeout: one wedged-but-
        # accepting replica must not stall the control loop 10 s per poll
        # exactly when the overload needs a fast scale-up (drain/scale
        # operations keep the longer http_timeout_s)
        self.metrics_timeout_s = float(metrics_timeout_s)

    def admin_url(self, rid: int) -> str:
        return f"http://127.0.0.1:{self.admin_ports[rid]}"

    def replica_ids(self) -> List[int]:
        return self.fleet.live_ids()

    def metrics(self, rid: int) -> Optional[Dict[str, Any]]:
        """One replica's JSON ``/metrics`` — None while it is down or
        mid-restart (the loop treats an unreachable replica as
        contributing no signal, not as pressure)."""
        try:
            with urllib.request.urlopen(
                    self.admin_url(rid) + "/metrics",
                    timeout=self.metrics_timeout_s) as r:
                return json.loads(r.read())
        except (OSError, ValueError, KeyError):
            return None

    def scale_up(self, ready_timeout_s: float = 300.0) -> int:
        """Spawn one supervised replica on the shared port and block until
        its heartbeat reaches ``serve/accepting``. Returns the replica id."""
        from .aserver import pick_free_port

        rid = self.fleet.replicas  # ids are never reused
        admin_port = pick_free_port()
        while admin_port in self.admin_ports.values() \
                or admin_port == self.port:
            admin_port = pick_free_port()
        got = self.fleet.add_replica(self.make_argv(rid, admin_port))
        assert got == rid, f"replica id drifted: {got} != {rid}"
        self.admin_ports[rid] = admin_port
        try:
            self.fleet.wait_ready(timeout=ready_timeout_s, indices=[rid])
        except Exception:
            # a replica that cannot come up must not linger half-started
            # (nor keep a stale admin port in the layout)
            self.fleet.stop_replica(rid)
            self.admin_ports.pop(rid, None)
            self.publish_layout()
            raise
        self.publish_layout()
        return rid

    def scale_down(self, rid: int,
                   drain_timeout_s: float = 10.0) -> str:
        """Gracefully remove one replica: POST ``/v1/drain`` (it stops
        accepting, flushes queued lanes, exits rc 0 → supervisor outcome
        ``success``), wait for the clean exit, SIGKILL via the supervisor
        if it never comes. Returns the drain outcome string."""
        outcome = "drained"
        try:
            req = urllib.request.Request(
                self.admin_url(rid) + "/v1/drain",
                data=json.dumps({"timeout_s": drain_timeout_s}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(
                    req, timeout=drain_timeout_s + self.http_timeout_s
                    ) as r:
                json.loads(r.read())
        except (OSError, ValueError):
            outcome = "drain_unreachable"
        # the drained replica closes its listener ~0.5 s after answering
        # and exits; give it that window before falling back to the kill
        deadline = time.monotonic() + drain_timeout_s + 5.0
        while rid in self.fleet.live_ids() \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        if rid in self.fleet.live_ids():
            outcome = "killed"
        self.fleet.stop_replica(rid)
        self.admin_ports.pop(rid, None)
        self.publish_layout()
        return outcome

    def publish_layout(self,
                       replica_ids: Optional[Sequence[int]] = None) -> None:
        """Atomic ``fleet.json`` rewrite: the LIVE layout (current replica
        ids and their admin endpoints). ``replica_ids`` overrides the
        live set for the BOOT publish — the configured layout must be on
        disk (port, admin endpoints) while replicas are still loading, so
        tooling can inspect a slow or wedged startup."""
        from .fleet import write_fleet_json

        live = (self.fleet.live_ids() if replica_ids is None
                else list(replica_ids))
        write_fleet_json(self.fleet.run_dir, {
            "host": self.host, "port": self.port,
            "replicas": len(live),
            "replica_ids": live,
            "admin_ports": {str(r): self.admin_ports[r] for r in live
                            if r in self.admin_ports},
            "admin_urls": [f"http://127.0.0.1:{self.admin_ports[r]}"
                           for r in live if r in self.admin_ports],
            "pointer": str(self.pointer) if self.pointer else None,
            # the JAX package's mesh-serving keys (null without --mesh):
            # the layout stays key for key the JAX package's, so either
            # package reads the other's
            "mesh": self.mesh,
            "mesh_slices": self.mesh_slices,
            "mesh_slice_by_replica": (
                {str(r): f"{r % self.mesh_slices}:{self.mesh_slices}"
                 for r in live}
                if self.mesh and self.mesh_slices else None),
            "total_replicas_ever": self.fleet.replicas,
        })


class Autoscaler:
    """The control loop (see module doc): scrape → signals → hysteresis →
    scale through a :class:`FleetController` (or any object with its
    ``replica_ids``/``metrics``/``scale_up``/``scale_down`` surface).

    ``tick()`` is one full evaluation — exposed so tests drive the loop
    deterministically without the thread."""

    def __init__(
        self,
        controller,
        policy: Optional[AutoscalePolicy] = None,
        events: Optional[EventLog] = None,
        flight: Any = None,
        max_decisions: int = 64,
    ):
        self.controller = controller
        self.policy = policy if policy is not None else AutoscalePolicy()
        self.events = events
        self.flight = flight  # FlightRecorder: decisions ride its dumps
        self.decisions: deque = deque(maxlen=max_decisions)
        self.scale_ups = 0
        self.scale_downs = 0
        self._over_streak = 0
        self._under_streak = 0
        self._last_scale_mono = -float("inf")
        # rid -> (total requests, shed 429+503 total) at the last tick:
        # rates are per-tick deltas, not lifetime averages
        self._last_counts: Dict[int, Any] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal extraction ----------------------------------------------------

    @staticmethod
    def _totals(metrics: Dict[str, Any]) -> Any:
        """(total responses, shed 429+503 responses) from a replica's
        ``requests`` tally ({"endpoint status": count})."""
        total = shed = 0
        for key, n in (metrics.get("requests") or {}).items():
            status = key.rsplit(" ", 1)[-1]
            if not status.isdigit():
                continue
            total += int(n)
            if int(status) in (429, 503):
                shed += int(n)
        return total, shed

    def signals(self) -> Dict[str, Any]:
        """One scrape across the live fleet → the tick's pressure
        signals. Unreachable replicas are skipped (they contribute no
        signal); per-replica request/shed counters are differenced
        against the previous tick."""
        rids = list(self.controller.replica_ids())
        depths: List[float] = []
        p99s: List[float] = []
        d_req = d_shed = 0
        scraped = 0
        for rid in rids:
            m = self.controller.metrics(rid)
            if m is None:
                continue
            scraped += 1
            batcher = m.get("batcher") or {}
            depths.append(float(batcher.get("pending") or 0))
            p99 = (m.get("latency") or {}).get("p99_ms")
            if isinstance(p99, (int, float)):
                p99s.append(float(p99))
            total, shed = self._totals(m)
            prev = self._last_counts.get(rid)
            # merge, don't replace: a replica that misses ONE scrape must
            # not re-contribute its lifetime totals as a single tick's
            # delta when it reappears. A first-seen replica (boot, or the
            # autoscaler starting against a warm fleet) contributes its
            # baseline, not its history.
            if prev is not None:
                # a restarted replica resets its counters: clamp at 0 so
                # the wrap never reads as negative load
                d_req += max(0, total - prev[0])
                d_shed += max(0, shed - prev[1])
            self._last_counts[rid] = (total, shed)
        return {
            "replicas": len(rids),
            "scraped": scraped,
            "mean_queue_depth": (round(sum(depths) / len(depths), 3)
                                 if depths else 0.0),
            "shed_delta": d_shed,
            "request_delta": d_req,
            "shed_rate": (round(d_shed / d_req, 4) if d_req else
                          (1.0 if d_shed else 0.0)),
            "p99_ms": max(p99s) if p99s else None,
        }

    # -- one evaluation -------------------------------------------------------

    def tick(self) -> Dict[str, Any]:
        pol = self.policy
        sig = self.signals()
        p99_tripped = (pol.up_p99_ms is not None
                       and sig["p99_ms"] is not None
                       and sig["p99_ms"] > pol.up_p99_ms)
        over = sig["scraped"] > 0 and (
            sig["mean_queue_depth"] >= pol.up_queue_depth
            or sig["shed_rate"] >= pol.up_shed_rate
            or p99_tripped)
        # `under` also requires p99 back below the threshold: the replica's
        # p99 is a sliding request window, which goes STALE when traffic
        # stops — without this guard a frozen over-threshold p99 would let
        # over and under trip on alternating branches and flap the fleet
        # up/down once per cooldown forever (conservative: the fleet holds
        # its size until fresh traffic refreshes the window)
        under = (sig["scraped"] > 0
                 and sig["mean_queue_depth"] <= pol.down_queue_depth
                 and sig["shed_delta"] == 0
                 and not p99_tripped)
        self._over_streak = self._over_streak + 1 if over else 0
        self._under_streak = self._under_streak + 1 if under else 0
        now = time.monotonic()
        in_cooldown = now - self._last_scale_mono < pol.cooldown_s
        decision = dict(sig, ts=round(time.time(), 3), action="hold")
        n = sig["replicas"]
        if not in_cooldown and self._over_streak >= pol.up_hysteresis \
                and n < pol.max_replicas:
            decision.update(action="up", reason=self._reason(sig, pol))
            self._act(decision)
        elif not in_cooldown \
                and self._under_streak >= pol.down_hysteresis \
                and n > pol.min_replicas:
            decision.update(action="down", reason="quiet")
            self._act(decision)
        elif in_cooldown:
            decision["cooldown"] = True
        self._record(decision)
        return decision

    @staticmethod
    def _reason(sig: Dict[str, Any], pol: AutoscalePolicy) -> str:
        if sig["mean_queue_depth"] >= pol.up_queue_depth:
            return f"queue_depth {sig['mean_queue_depth']}"
        if sig["shed_rate"] >= pol.up_shed_rate:
            return f"shed_rate {sig['shed_rate']}"
        return f"p99_ms {sig['p99_ms']}"

    def _act(self, decision: Dict[str, Any]) -> None:
        pol = self.policy
        direction = decision["action"]
        try:
            # fault site: a plan can raise/kill exactly as a scale event
            # is about to mutate the fleet — a `raise` fails THIS event
            # (recorded as {direction}_failed), never the control loop
            inject("fleet/scale", direction=direction,
                   path=f"replicas{decision['replicas']}")
            if direction == "up":
                rid = self.controller.scale_up(
                    ready_timeout_s=pol.ready_timeout_s)
                decision["replica"] = rid
                self.scale_ups += 1
            else:
                victim = max(self.controller.replica_ids())
                decision["replica"] = victim
                decision["outcome"] = self.controller.scale_down(
                    victim, drain_timeout_s=pol.drain_timeout_s)
                self.scale_downs += 1
        except Exception as e:
            # a failed spawn/drain must not kill the control loop: record
            # it, stay at current size, let the next tick retry after
            # cooldown
            decision["action"] = f"{direction}_failed"
            decision["error"] = f"{type(e).__name__}: {e}"
        self._over_streak = self._under_streak = 0
        self._last_scale_mono = time.monotonic()
        if self.events is not None:
            live = list(self.controller.replica_ids())
            self.events.counter(
                "fleet/scale", direction=direction,
                action=decision["action"],
                replica=decision.get("replica"),
                replicas=len(live),
                reason=decision.get("reason"),
                queue_depth=decision.get("mean_queue_depth"),
                shed_rate=decision.get("shed_rate"),
                error=decision.get("error"))
            self.events.gauge("fleet/replicas", len(live))

    def _record(self, decision: Dict[str, Any]) -> None:
        self.decisions.append(decision)
        if self.flight is not None:
            try:
                self.flight.record_decision(decision)
            except Exception:
                pass  # evidence, never a failure path

    # -- the control thread ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.policy.poll_s):
                try:
                    self.tick()
                except Exception:
                    # one bad scrape (replica mid-restart, torn JSON) must
                    # not end autoscaling for the fleet's whole life
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
