"""Leased multi-worker execution of a sweep's bucket queue.

The port's copy of the JAX package's ``reliability/scheduler.py``; queue
manifests, leases, attempt files and quarantine markers are the JAX
package's, so a queue written by either package opens in the other.
Classic elastic-training shape (TorchElastic-style leased work queues;
PAPERS.md): N independent worker processes claim buckets from a shared
file-backed queue under heartbeat-stamped leases. Every queue transition
(claim, renew, complete, fail) runs under an ``fcntl.flock`` on one lock
file, so concurrent workers on one host can never double-claim; a worker
that dies or hangs simply stops renewing, its lease expires, and the bucket
is re-claimed by any surviving worker (a **takeover**). A bucket whose
claims keep dying — it killed K consecutive workers — is **quarantined** as
poison instead of crash-looping the fleet, and per-bucket retry delay
follows the supervisor's exponential-backoff policy
(:class:`reliability.supervisor.RestartPolicy`), the same curve a restarted
child gets.

State lives beside the ledger under ``<run_dir>/sweep_ledger/``:

    queue.json            — the ordered work manifest (see ledger.py)
                            with the fleet settings every worker must
                            agree on (lease timeout, attempts, backoff)
    leases/<key>.json     — ``{"worker", "ts"}``, atomically replaced on
                            renewal; staleness past ``lease_timeout_s``
                            makes the bucket claimable again
    attempts/<key>.json   — ``{"count", "next_eligible_ts", "history"}``;
                            the count is incremented AT CLAIM TIME so a
                            worker the bucket kills still leaves evidence
    slices/slice<i>.json  — DEVICE-SLICE leases: ``{"worker", "ts"}`` for
                            disjoint device slices; a worker holds exactly
                            one slice while training and renews it with
                            its bucket lease, so two live workers never
                            train on the same devices. No entry point
                            leases slices yet: they serve the mesh-packed
                            sweep, which the port has not got

Fault sites: ``sweep/claim`` fires after a lease is written (a
kill there leaves an orphan lease → exercises expiry + takeover),
``sweep/lease_renew`` fires on every renewal.

Module level stays stdlib-only: the coordinating parent (and tests)
drive fleets without importing torch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

try:
    import fcntl
except ImportError:  # non-POSIX: queue transitions fall back to atomicity only
    fcntl = None

from .faults import inject
from .ledger import QUEUE_FILENAME, SweepLedger
from .supervisor import RestartPolicy, Supervisor
from .verified import load_verified, write_verified


class LeaseLost(RuntimeError):
    """A renewal found the lease owned by someone else: the bucket was
    taken over (this worker was presumed dead). Abandon the bucket —
    the new owner's result is the one the ledger will record."""


def _read_json(path: Path) -> Optional[Dict[str, Any]]:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


def _atomic_write_json(path: Path, obj: Any) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


class WorkQueue:
    """The file-locked bucket queue one sweep's workers claim from.

    ``events`` (an ``observability.EventLog`` or anything with a
    ``counter(name, **attrs)`` method) receives the elastic telemetry the
    report CLI aggregates: ``sweep/claim``, ``sweep/retry``,
    ``sweep/lease_takeover``, ``sweep/quarantine``.
    """

    def __init__(
        self,
        root: Union[str, Path],
        ledger: Optional[SweepLedger] = None,
        lease_timeout_s: float = 60.0,
        max_attempts: int = 3,
        backoff: Optional[RestartPolicy] = None,
        events=None,
        self_reclaim_grace_s: float = 1.0,
    ):
        self.root = Path(root)
        self.ledger = ledger if ledger is not None else SweepLedger(self.root)
        self.lease_timeout_s = float(lease_timeout_s)
        # how long the PREVIOUS owner of an expired lease defers before
        # re-claiming its own bucket (see claim() for why)
        self.self_reclaim_grace_s = float(self_reclaim_grace_s)
        self.max_attempts = int(max_attempts)
        self.backoff = backoff if backoff is not None else RestartPolicy(
            backoff_base_s=1.0, backoff_max_s=30.0)
        self.events = events
        self.leases_dir = self.root / "leases"
        self.attempts_dir = self.root / "attempts"
        self.slices_dir = self.root / "slices"
        self._lock_path = self.root / "queue.lock"
        self._items: Optional[List[Dict[str, Any]]] = None

    # -- the work manifest ----------------------------------------------------

    def queue_path(self) -> Path:
        return self.root / QUEUE_FILENAME

    def write_manifest(self, items: Sequence[Dict[str, Any]],
                       meta: Optional[Dict[str, Any]] = None) -> None:
        """Verified write of the ordered work manifest. Every item needs a
        ``key`` (ledger.bucket_key); workers derive ALL work from this file
        so coordinator and fleet can never disagree on the bucket list."""
        manifest = dict(meta or {})
        manifest["items"] = list(items)
        write_verified(self.queue_path(),
                       json.dumps(manifest, indent=2).encode())
        self._items = list(items)

    def load_manifest(self) -> Dict[str, Any]:
        path = self.queue_path()

        def parse(data: bytes) -> Dict[str, Any]:
            try:
                return json.loads(data.decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"corrupt sweep queue manifest {path}: {e}") from e

        manifest, _ = load_verified(path, parse)
        self._items = list(manifest["items"])
        return manifest

    def items(self) -> List[Dict[str, Any]]:
        if self._items is None:
            self.load_manifest()
        return self._items

    # -- locking --------------------------------------------------------------

    @contextmanager
    def _locked(self):
        """Exclusive inter-process lock over every queue transition. Held
        only for small file reads/writes — never across training. A dying
        holder's lock is released by the kernel with its fd (the property
        that makes kill-at-``sweep/claim`` recoverable)."""
        self.root.mkdir(parents=True, exist_ok=True)
        with open(self._lock_path, "w") as f:
            if fcntl is not None:
                fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                if fcntl is not None:
                    fcntl.flock(f, fcntl.LOCK_UN)

    # -- lease / attempt files ------------------------------------------------

    def lease_path(self, key: str) -> Path:
        return self.leases_dir / f"{key}.json"

    def attempts_path(self, key: str) -> Path:
        return self.attempts_dir / f"{key}.json"

    def _lease_state(self, key: str, now: float) -> Tuple[Optional[str], bool]:
        """(owner, live) for a bucket's lease; (None, False) when unleased."""
        lease = _read_json(self.lease_path(key))
        if not lease:
            return None, False
        try:
            age = now - float(lease.get("ts", 0.0))
        except (TypeError, ValueError):
            return str(lease.get("worker")), False
        return str(lease.get("worker")), age <= self.lease_timeout_s

    def _counter(self, name: str, **attrs: Any) -> None:
        if self.events is not None:
            self.events.counter(name, **attrs)

    def next_wake_delay(self, default_s: float = 0.5,
                        min_s: float = 0.01,
                        worker: Optional[str] = None) -> float:
        """How long a ``"wait"``-ing worker should sleep before re-polling:
        the time to the NEAREST recovery deadline — a live lease's expiry,
        a retry-backoff window's end, or (for `worker`'s own expired
        leases) the end of its self-reclaim grace — capped at `default_s`.

        An idle worker then wakes within milliseconds of an orphaned lease
        expiring instead of up to a poll interval later, so lease-takeover
        latency is bounded by the claim scan, not the poll cadence — and
        the idle survivor reliably beats the dead owner's restarting
        process (which pays interpreter + data-load startup) to the
        expired lease."""
        now = time.time()
        deadline = None
        for item in self.items():
            key = item["key"]
            if self.ledger.has(key) or self.ledger.is_quarantined(key):
                continue
            lease = _read_json(self.lease_path(key))
            if lease:
                try:
                    exp = float(lease.get("ts", 0.0)) + self.lease_timeout_s
                except (TypeError, ValueError):
                    exp = now
                if exp <= now and worker is not None and (
                        str(lease.get("worker")) == worker):
                    # our own expired lease: claim() defers it until the
                    # self-reclaim grace elapses — that IS our deadline
                    exp = exp + self.self_reclaim_grace_s
                if exp > now:
                    deadline = exp if deadline is None else min(deadline, exp)
                    continue
            att = _read_json(self.attempts_path(key)) or {}
            try:
                ne = float(att.get("next_eligible_ts") or 0.0)
            except (TypeError, ValueError):
                ne = 0.0
            if ne > now:
                deadline = ne if deadline is None else min(deadline, ne)
        if deadline is None:
            return default_s
        return max(min_s, min(default_s, deadline - now + min_s))

    # -- the claim protocol ---------------------------------------------------

    def claim(self, worker: str) -> Tuple[str, Optional[Dict[str, Any]]]:
        """Try to claim the next runnable bucket for `worker`.

        Returns ``(status, item)`` where status is one of

          * ``"claimed"`` — `item` is the bucket to train (its lease is
            held; keep it renewed via :class:`LeaseKeeper`);
          * ``"wait"``    — nothing claimable NOW but live leases or
            backoff windows remain: poll again (a leased bucket may yet
            expire back into the pool);
          * ``"drained"`` — every bucket is completed or quarantined:
            exit cleanly.
        """
        now = time.time()
        with self._locked():
            pending = False
            for item in self.items():
                key = item["key"]
                if self.ledger.has(key) or self.ledger.is_quarantined(key):
                    continue
                owner, live = self._lease_state(key, now)
                if live:
                    pending = True
                    continue
                if owner is not None and owner == worker:
                    # the lease expired in THIS worker's hands — it died
                    # (and was restarted) or stalled past the timeout while
                    # holding the bucket. Defer one grace window past the
                    # expiry so a LIVE sibling takes the orphan over first:
                    # a crash-looping owner must not win the re-claim race
                    # against healthy workers simply because its restart
                    # lands at the expiry instant (the takeover path is the
                    # one that makes fleet progress when a bucket kills its
                    # owner deterministically). With no sibling interested,
                    # the owner claims as soon as the grace elapses.
                    lease = _read_json(self.lease_path(key)) or {}
                    try:
                        exp = float(lease.get("ts", 0.0)) + self.lease_timeout_s
                    except (TypeError, ValueError):
                        exp = now
                    if now < exp + self.self_reclaim_grace_s:
                        pending = True
                        continue
                att = _read_json(self.attempts_path(key)) or {
                    "count": 0, "next_eligible_ts": 0.0, "history": []}
                if int(att["count"]) >= self.max_attempts:
                    # this bucket has now consumed max_attempts claims
                    # without ever completing — poison: quarantine it so
                    # the fleet finishes degraded instead of crash-looping
                    self.ledger.quarantine(key, {
                        "index": item.get("index"),
                        "attempts": int(att["count"]),
                        "history": att.get("history", []),
                    })
                    self._counter("sweep/quarantine", path=key,
                                  bucket=item.get("index"),
                                  attempts=int(att["count"]))
                    continue
                if now < float(att.get("next_eligible_ts") or 0.0):
                    pending = True  # in its retry-backoff window
                    continue
                takeover = owner is not None and owner != worker
                attempt = int(att["count"]) + 1
                # stamp the attempt BEFORE the lease: a worker this bucket
                # kills mid-claim still leaves the evidence quarantine needs
                att["count"] = attempt
                att["next_eligible_ts"] = now + self.backoff.backoff_s(
                    attempt, rng=lambda: 0.0)
                att.setdefault("history", []).append({
                    "worker": worker, "ts": round(now, 3),
                    "takeover": takeover,
                })
                _atomic_write_json(self.attempts_path(key), att)
                _atomic_write_json(self.lease_path(key), {
                    "worker": worker, "ts": now, "attempt": attempt,
                })
                if takeover:
                    self._counter("sweep/lease_takeover", path=key,
                                  bucket=item.get("index"),
                                  from_worker=owner, worker=worker)
                if attempt > 1:
                    self._counter("sweep/retry", path=key,
                                  bucket=item.get("index"), attempt=attempt,
                                  worker=worker)
                self._counter("sweep/claim", path=key,
                              bucket=item.get("index"), worker=worker,
                              attempt=attempt)
                # the fault site fires WITH the lease already on disk: a
                # kill here orphans the lease, which must expire and be
                # taken over — the exact recovery path worth exercising
                inject("sweep/claim", path=key, worker=worker,
                       attempt=attempt)
                return "claimed", dict(item, attempt=attempt)
        return ("wait", None) if pending else ("drained", None)

    def renew(self, key: str, worker: str) -> None:
        """Refresh the lease heartbeat; raises :class:`LeaseLost` when the
        lease is gone or owned by another worker (takeover happened)."""
        inject("sweep/lease_renew", path=key, worker=worker)
        with self._locked():
            lease = _read_json(self.lease_path(key))
            if not lease or str(lease.get("worker")) != worker:
                raise LeaseLost(
                    f"bucket {key[:12]}… lease no longer held by {worker} "
                    f"(now {lease.get('worker') if lease else 'released'})"
                )
            lease["ts"] = time.time()
            _atomic_write_json(self.lease_path(key), lease)

    def complete(self, key: str, worker: str) -> None:
        """Release the lease after the ledger record landed. The attempts
        file is cleared — a completed bucket's history lives in its
        record, and stale failure counts must not poison a future resume."""
        with self._locked():
            lease = _read_json(self.lease_path(key))
            if lease and str(lease.get("worker")) == worker:
                self.lease_path(key).unlink(missing_ok=True)
            self.attempts_path(key).unlink(missing_ok=True)

    def fail(self, key: str, worker: str, error: str = "") -> None:
        """Release a failed claim: the bucket returns to the pool after its
        backoff window, and the error joins its history. The window is
        re-stamped HERE, from the failure time — the claim-time stamp
        (which covers workers that die without reaching fail()) has usually
        already elapsed by the time a slow failure surfaces, and the
        documented exponential retry delay must count from the failure."""
        now = time.time()
        with self._locked():
            lease = _read_json(self.lease_path(key))
            if lease and str(lease.get("worker")) == worker:
                self.lease_path(key).unlink(missing_ok=True)
            att = _read_json(self.attempts_path(key))
            if att is not None:
                hist = att.setdefault("history", [])
                if hist:
                    hist[-1]["error"] = error[:500]
                att["next_eligible_ts"] = now + self.backoff.backoff_s(
                    int(att.get("count") or 1), rng=lambda: 0.0)
                _atomic_write_json(self.attempts_path(key), att)

    # -- device-slice leases ----------------------------------------------------

    def slice_path(self, index: int) -> Path:
        return self.slices_dir / f"slice{int(index)}.json"

    def claim_device_slice(self, worker: str,
                           n_slices: int) -> Optional[int]:
        """Lease one of `n_slices` disjoint device slices for `worker`.

        A worker trains on the devices of its leased slice, so holding the
        lease IS the exclusivity guarantee. Preference order under the queue lock:
        a slice already leased to this worker (a restarted worker reclaims
        its own slice — device state is per-process, so self-reclaim is
        safe here, unlike bucket leases), then the first free or expired
        slice (an expired takeover emits ``sweep/slice_takeover``).
        Returns the slice index, or ``None`` when every slice is held by a
        live worker — poll again; a dying fleet member frees one."""
        now = time.time()
        with self._locked():
            for idx in range(int(n_slices)):
                lease = _read_json(self.slice_path(idx))
                if lease and str(lease.get("worker")) == worker:
                    _atomic_write_json(self.slice_path(idx),
                                       {"worker": worker, "ts": now})
                    return idx
            for idx in range(int(n_slices)):
                lease = _read_json(self.slice_path(idx))
                if lease:
                    try:
                        live = (now - float(lease.get("ts", 0.0))
                                <= self.lease_timeout_s)
                    except (TypeError, ValueError):
                        live = False
                    if live:
                        continue
                    self._counter("sweep/slice_takeover", slice=idx,
                                  from_worker=str(lease.get("worker")),
                                  worker=worker)
                _atomic_write_json(self.slice_path(idx),
                                   {"worker": worker, "ts": now})
                self._counter("sweep/slice_claim", slice=idx, worker=worker)
                return idx
        return None

    def renew_device_slice(self, index: int, worker: str) -> None:
        """Refresh the slice lease; :class:`LeaseLost` when another worker
        took it over (this worker was presumed dead — it must stop
        dispatching onto the slice's devices and re-claim)."""
        with self._locked():
            lease = _read_json(self.slice_path(index))
            if not lease or str(lease.get("worker")) != worker:
                raise LeaseLost(
                    f"device slice {index} no longer held by {worker} "
                    f"(now {lease.get('worker') if lease else 'released'})")
            lease["ts"] = time.time()
            _atomic_write_json(self.slice_path(index), lease)

    def release_device_slice(self, index: int, worker: str) -> None:
        with self._locked():
            lease = _read_json(self.slice_path(index))
            if lease and str(lease.get("worker")) == worker:
                self.slice_path(index).unlink(missing_ok=True)

    # -- fleet-level status ---------------------------------------------------

    def status(self) -> Dict[str, Any]:
        done = quarantined = leased = pending = 0
        now = time.time()
        for item in self.items():
            key = item["key"]
            if self.ledger.has(key):
                done += 1
            elif self.ledger.is_quarantined(key):
                quarantined += 1
            elif self._lease_state(key, now)[1]:
                leased += 1
            else:
                pending += 1
        return {"total": len(self.items()), "completed": done,
                "quarantined": quarantined, "leased": leased,
                "pending": pending}


class LeaseKeeper:
    """Background renewal thread for one claimed bucket.

    Training a bucket is one blocking call that can far outlive the lease
    timeout, so renewal cannot come from the training thread.
    The keeper renews every ``lease_timeout_s / 3``; on :class:`LeaseLost`
    it stops and flags ``lost`` for the worker to check. A SIGKILLed worker
    takes its keeper with it (same process) — renewals stop, the lease
    expires, and the bucket is taken over: exactly the recovery path.

    `heartbeat` (an ``observability.Heartbeat``): beaten after every
    successful renewal, so a supervising watchdog sees liveness THROUGH a
    bucket whose single dispatch outlives the heartbeat timeout — without
    it, a healthy worker training a long bucket would be hang-killed, its
    re-claims would burn the bucket's attempt budget, and a perfectly good
    bucket would quarantine. `max_lifetime_s` bounds that trust: past the
    per-bucket wall budget the keeper stops renewing AND beating, both
    signals go stale, and the supervisor/lease machinery reclaims the
    bucket — the only way a host can tell a long dispatch from a hung one.
    """

    def __init__(self, queue: WorkQueue, key: str, worker: str,
                 heartbeat=None, heartbeat_section: str = "sweep_bucket",
                 max_lifetime_s: Optional[float] = None,
                 slice_index: Optional[int] = None):
        self.queue = queue
        self.key = key
        self.worker = worker
        self.heartbeat = heartbeat
        self.heartbeat_section = heartbeat_section
        self.max_lifetime_s = max_lifetime_s
        # device-slice lease renewed alongside the bucket lease: a bucket's
        # single dispatch can outlive lease_timeout_s, and the slice must
        # stay held for exactly as long as the devices are in use
        self.slice_index = slice_index
        self.lost = False
        self.slice_lost = False
        self.expired = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"lease-{worker}", daemon=True)

    def _run(self) -> None:
        interval = max(0.05, self.queue.lease_timeout_s / 3.0)
        started = time.time()
        while not self._stop.wait(interval):
            if (self.max_lifetime_s is not None
                    and time.time() - started > self.max_lifetime_s):
                # bucket budget exhausted: presumed hung. Go silent so the
                # watchdog kills this worker and the lease expires.
                self.expired = True
                return
            try:
                self.queue.renew(self.key, self.worker)
            except LeaseLost:
                self.lost = True
                return
            except OSError:
                continue  # transient FS hiccup: retry next tick
            if self.slice_index is not None:
                try:
                    self.queue.renew_device_slice(self.slice_index,
                                                  self.worker)
                except LeaseLost:
                    # the slice was taken over (this worker was presumed
                    # dead). ONLY the slice is gone: the bucket lease is
                    # still validly held and the in-flight dispatch's
                    # result stays bit-identical (placement never changes
                    # values), so keep renewing the bucket lease and
                    # beating the heartbeat — stopping here would let a
                    # sibling re-train the bucket and the watchdog
                    # hang-kill a healthy worker. The worker must lease a
                    # fresh slice before its next bucket.
                    self.slice_lost = True
                    self.slice_index = None
                except OSError:
                    pass  # transient; next tick retries
            if self.heartbeat is not None:
                try:
                    self.heartbeat.beat(self.heartbeat_section)
                except OSError:
                    pass  # liveness reporting must not kill the lease

    def __enter__(self) -> "LeaseKeeper":
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def run_supervised_workers(
    run_dir: Union[str, Path],
    worker_cmds: Dict[str, List[str]],
    policy: Optional[RestartPolicy] = None,
    env: Optional[Dict[str, str]] = None,
    events_filename: str = "events.supervisor.{worker}.jsonl",
) -> Dict[str, Dict[str, Any]]:
    """Run one :class:`Supervisor` per worker command, concurrently, and
    return each worker's supervise summary.

    This is the "supervise-wrapped children" layer of the elastic sweep:
    each worker process gets the full watchdog treatment — heartbeat hang
    detection against ``heartbeat.<worker>.json``, SIGKILL of its process
    group, restart with backoff and automatic ``--resume-from-ledger``
    (the supervisor detects the run dir's ledger), crash-loop policy — and
    its own ``events.supervisor.<worker>.jsonl`` so the report CLI counts
    restarts per worker. The fleet outlives any single worker: a
    crash-looped worker ends with outcome ``crash-loop`` while the others
    drain the queue.
    """
    from ..observability.events import EventLog

    run_dir = Path(run_dir)
    summaries: Dict[str, Dict[str, Any]] = {}
    threads = []
    for worker, cmd in worker_cmds.items():
        events = EventLog(run_dir, process_index=0,
                          filename=events_filename.format(worker=worker))
        sup = Supervisor(
            cmd,
            heartbeat_path=run_dir / f"heartbeat.{worker}.json",
            policy=policy,
            events=events,
            log_path=run_dir / f"supervised.{worker}.log",
            env=env,
        )

        def _run(worker=worker, sup=sup, events=events):
            try:
                summaries[worker] = sup.run()
            finally:
                events.close()

        t = threading.Thread(target=_run, name=f"supervise-{worker}")
        threads.append(t)
        t.start()
    for t in threads:
        t.join()
    return summaries
