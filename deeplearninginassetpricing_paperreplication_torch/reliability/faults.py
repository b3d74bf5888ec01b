"""Deterministic, plan-driven fault injection.

The port's copy of the JAX package's ``reliability/faults.py`` (stdlib
only; the two packages share the plan format and the ``DLAP_FAULT_PLAN``,
``DLAP_FAULT_STATE`` and ``DLAP_FAULT_EVENTS`` variables, so one plan
drives either). The paper's protocol is a long
multi-run pipeline (three GAN phases × a hyperparameter sweep × a 9-member
ensemble), exactly the shape that dies to preemptions, OOM kills and NaN
blowups hours in. Named injection sites sit in the port's verified file IO
(``checkpoint/save``, ``checkpoint/saved``, ``checkpoint/load``), the
trainer's segment loop and phase boundaries (``trainer/epoch_loop``,
``trainer/phase_boundary``), the data plane (``pipeline/decode``,
``pipeline/transfer``, ``data/shard_read``), the sweep and its work queue
(``sweep/bucket``, ``sweep/claim``, ``sweep/lease_renew``,
``sweep/ledger_write``), the promotion gate
(``promote/validate``, ``promote/write``) and the serving path
(``serving/infer``, ``serve/accept``, ``serve/admit``, ``serve/flush``,
``serve/coalesce``, ``serve/reload``), and a JSON *fault plan* decides
which site hits fire which fault.

Plan format (``DLAP_FAULT_PLAN`` env: inline JSON, or a path to a JSON
file) — a list of entries (a single object is accepted too)::

    [{"site": "sweep/bucket", "trigger_count": 2, "action": "kill"},
     {"site": "checkpoint/saved", "action": "truncate_file",
      "match": "sweep_ranking", "trigger_count": 1}]

  * ``site``          — the injection-site name (see SITES below);
  * ``action``        — one of ``raise`` (RuntimeError), ``kill`` (SIGKILL
                        self: the OOM-kill / preemption death mode), ``hang``
                        (sleep forever: the wedged-call death mode the
                        supervisor's stale-heartbeat check exists for),
                        ``truncate_file`` (corrupt the file named by the
                        site's ``path`` context — a torn write),
                        ``nan_loss`` (cooperative: :func:`inject` returns
                        the token and the trainer poisons the segment it
                        just ran — the divergence guard's exercise path);
  * ``trigger_count`` — fire on the Nth matching hit of the site (1-based,
                        default 1); each entry counts independently;
  * ``match``         — optional substring filter on the site's ``path``
                        context (so ``checkpoint/saved`` entries can target
                        one artifact);
  * ``persistent``    — fire on EVERY matching hit from the Nth on (a
                        poison bucket: the fault follows the work item
                        whichever worker claims it), instead of exactly on
                        the Nth.

Determinism across restarts AND across a worker fleet: when
``DLAP_FAULT_STATE`` names a file, the per-entry hit counters persist
through it (written atomically BEFORE a fault executes), so a ``kill``
fires exactly once ever — the supervised restart does not re-die at the
same site. Counter updates re-read the file under an ``fcntl`` lock, so N
concurrent sweep workers sharing one state file see ONE fleet-wide hit
stream ("the 3rd claim anywhere dies"), not N private ones. Without a
state file counters are per process.

When ``DLAP_FAULT_EVENTS`` names a file, every fired fault appends one JSON
line (``{"kind": "counter", "name": "fault/injected", ...}``).

Overhead contract: with no plan in the environment, :func:`inject` is a
module-global read plus a ``None`` check — zero filesystem traffic, zero
behavior change.

Module level stays stdlib-only: a thin parent can load this file by path,
without importing torch.
"""

from __future__ import annotations

import json
import os
import signal
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

ENV_PLAN = "DLAP_FAULT_PLAN"
ENV_STATE = "DLAP_FAULT_STATE"
ENV_EVENTS = "DLAP_FAULT_EVENTS"

ACTIONS = ("raise", "kill", "hang", "truncate_file", "nan_loss")

# the named injection sites threaded through the port (documentation —
# the injector fires for any site string a plan names)
SITES = (
    "checkpoint/save",         # before a verified write (ctx: path)
    "checkpoint/saved",        # after data + digest land (ctx: path)
    "checkpoint/load",         # before a verified read (ctx: path)
    "trainer/epoch_loop",      # after each training segment (ctx: phase,
                               #   epochs_done; `nan_loss` poisons it)
    "trainer/phase_boundary",  # after each phase's boundary save (ctx:
                               #   phase); phase 3's fires before the
                               #   resume state clears
    "pipeline/decode",         # per split, before its decode (ctx: split)
    "pipeline/transfer",       # per split, before its transfer (ctx: split)
    "data/shard_read",         # per chunked-store shard, before its digest
                               #   check (ctx: path, split, shard)
    "sweep/bucket",            # per sweep bucket trained (ctx: bucket,
                               #   n_buckets, path=the bucket's ledger key)
    "sweep/claim",             # after a worker's lease lands (ctx:
                               #   path=key, worker, attempt — a kill
                               #   orphans the lease: expiry + takeover)
    "sweep/lease_renew",       # per lease renewal (ctx: path=key, worker)
    "sweep/ledger_write",      # before a bucket record lands (ctx: path)
    "promote/validate",        # a candidate enters the gate (ctx: path =
                               #   the source, n_members)
    "promote/write",           # before the pointer advances (ctx: path,
                               #   generation)
    "serving/infer",           # per served micro-batch (ctx: n_requests)
    "serve/accept",            # per accepted connection
    "serve/admit",             # per batcher admission decision (ctx:
                               #   priority, queue_depth — `raise` rejects
                               #   exactly one request as it is admitted)
    "serve/flush",             # per continuous-batch flush (ctx: occupancy;
                               #   `raise` → that flush 5xxs)
    "serve/coalesce",          # per single-flight dispatch-OWNER entry (a
                               #   kill here dies with coalesced waiters
                               #   sharing the doomed flight)
    "serve/reload",            # per /v1/reload request
)


class FaultInjected(RuntimeError):
    """The ``raise`` action: a synthetic, attributable failure."""


class FaultPlanError(ValueError):
    """The plan itself is malformed (bad action, missing site)."""


def _atomic_write_json(path: Path, obj: Any) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


class FaultInjector:
    """Executes one parsed fault plan against named site hits."""

    def __init__(
        self,
        plan: Union[Dict[str, Any], List[Dict[str, Any]]],
        state_path: Optional[Union[str, Path]] = None,
        events_path: Optional[Union[str, Path]] = None,
    ):
        if isinstance(plan, dict):
            plan = [plan]
        self.plan: List[Dict[str, Any]] = []
        for i, entry in enumerate(plan):
            site = entry.get("site")
            action = entry.get("action")
            if not site:
                raise FaultPlanError(f"plan entry {i} has no 'site'")
            if action not in ACTIONS:
                raise FaultPlanError(
                    f"plan entry {i} ({site}) has unknown action {action!r}; "
                    f"expected one of {ACTIONS}"
                )
            self.plan.append({
                "site": str(site),
                "action": action,
                "trigger_count": int(entry.get("trigger_count", 1)),
                "persistent": bool(entry.get("persistent", False)),
                "match": entry.get("match"),
                "path": entry.get("path"),
                "keep_bytes": entry.get("keep_bytes"),
            })
        self.state_path = Path(state_path) if state_path else None
        self.events_path = Path(events_path) if events_path else None
        # per-ENTRY hit counters (not per-site): two entries on one site with
        # trigger_count 1 and 2 see the same hit stream but fire separately
        self.counts: List[int] = [0] * len(self.plan)
        if self.state_path is not None and self.state_path.exists():
            self._reload_counts()

    # -- the hot path ---------------------------------------------------------

    def _locked_state(self):
        """Exclusive inter-process lock over the state file (a ``.lock``
        sibling): N concurrent workers sharing DLAP_FAULT_STATE must see one
        fleet-wide hit stream, not clobber each other's counter writes. A
        no-op context without a state file (or on non-POSIX hosts)."""
        from contextlib import contextmanager, nullcontext

        if self.state_path is None:
            return nullcontext()
        try:
            import fcntl
        except ImportError:
            return nullcontext()

        @contextmanager
        def lock():
            lp = self.state_path.with_name(self.state_path.name + ".lock")
            with open(lp, "w") as f:
                fcntl.flock(f, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(f, fcntl.LOCK_UN)

        return lock()

    def _reload_counts(self) -> None:
        """Adopt the state file's counters (the fleet-wide truth): another
        process may have advanced them since this injector loaded. An
        unreadable file leaves the counters as they are."""
        try:
            saved = json.loads(self.state_path.read_text()).get("counts", [])
        except (OSError, ValueError):
            return
        for i, c in enumerate(saved[: len(self.counts)]):
            self.counts[i] = int(c)

    def fire(self, site: str, **ctx: Any) -> Optional[str]:
        """Record one hit of `site`; execute any entry whose trigger is
        reached. Returns a cooperative-action token (``"nan_loss"``) for the
        caller to apply, else None. ``raise``/``kill``/``hang`` never
        return; ``truncate_file`` corrupts and returns None."""
        matching = [
            i for i, f in enumerate(self.plan)
            if f["site"] == site
            and not (f["match"] and f["match"] not in str(ctx.get("path", "")))
        ]
        if not matching:
            return None
        pending = []
        with self._locked_state():
            if self.state_path is not None:
                self._reload_counts()
            for i in matching:  # count every entry's hit before any fires
                self.counts[i] += 1
                f = self.plan[i]
                if self.counts[i] == f["trigger_count"] or (
                        f["persistent"]
                        and self.counts[i] >= f["trigger_count"]):
                    pending.append(f)
            if self.state_path is not None:
                # persist BEFORE executing: a kill/hang must not re-fire
                # after a supervised restart replays the run to this site
                _atomic_write_json(self.state_path, {"counts": self.counts})
        token = None
        for f in pending:
            out = self._execute(f, site, ctx)
            if out is not None:
                token = out
        return token

    # -- actions --------------------------------------------------------------

    def _execute(self, fault: Dict[str, Any], site: str,
                 ctx: Dict[str, Any]) -> Optional[str]:
        action = fault["action"]
        self._log(site, action, ctx)
        if action == "nan_loss":
            return "nan_loss"  # cooperative: the site poisons its own output
        if action == "raise":
            raise FaultInjected(f"injected raise at {site} (ctx={ctx})")
        if action in ("kill", "hang"):
            # last words first: the serving plane dumps its flight recorder
            # here, so an injected death leaves the in-flight evidence
            for hook in list(_pre_death_hooks):
                try:
                    hook(site, action)
                except Exception:
                    pass  # a hook must never change the death mode
        if action == "kill":
            # the OOM-kill / preemption death mode: no cleanup, no excepthook
            os.kill(os.getpid(), signal.SIGKILL)
            while True:  # pragma: no cover — unreachable after SIGKILL lands
                time.sleep(1)
        if action == "hang":
            while True:  # the wedged-call death mode: never returns
                time.sleep(3600)
        if action == "truncate_file":
            target = fault.get("path") or ctx.get("path")
            if target:
                p = Path(target)
                if p.exists():
                    size = p.stat().st_size
                    keep = fault.get("keep_bytes")
                    keep = (size // 2) if keep is None else int(keep)
                    with open(p, "r+b") as f:
                        f.truncate(keep)
        return None

    def _log(self, site: str, action: str, ctx: Dict[str, Any]) -> None:
        if self.events_path is None:
            return
        row = {
            "kind": "counter", "name": "fault/injected", "value": 1,
            "site": site, "action": action, "ts": round(time.time(), 6),
        }
        for k, v in ctx.items():
            if isinstance(v, (str, int, float, bool)) or v is None:
                row.setdefault(k, v)
        try:
            with open(self.events_path, "a") as f:
                f.write(json.dumps(row) + "\n")
        except OSError:
            pass  # fault logging must never be a new failure mode

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultInjector"]:
        """The injector the environment describes, or None (no plan set)."""
        env = os.environ if environ is None else environ
        spec = (env.get(ENV_PLAN) or "").strip()
        if not spec:
            return None
        if spec.startswith("[") or spec.startswith("{"):
            plan = json.loads(spec)
        else:
            plan = json.loads(Path(spec).read_text())
        return cls(
            plan,
            state_path=env.get(ENV_STATE) or None,
            events_path=env.get(ENV_EVENTS) or None,
        )


# -- module-level singleton (the form the injection sites call) --------------

_UNRESOLVED = ()  # sentinel: environment not yet inspected
_injector: Any = _UNRESOLVED
# callables (site, action) → None run before a kill/hang executes
_pre_death_hooks: List[Any] = []


def add_pre_death_hook(fn) -> None:
    """Register a last-words callback run before a ``kill``/``hang`` fault
    executes (the serving flight recorder's dump). Callbacks must be fast and must
    not raise; exceptions are swallowed."""
    if fn not in _pre_death_hooks:
        _pre_death_hooks.append(fn)


def remove_pre_death_hook(fn) -> None:
    try:
        _pre_death_hooks.remove(fn)
    except ValueError:
        pass


def get_injector() -> Optional[FaultInjector]:
    global _injector
    if _injector is _UNRESOLVED:
        _injector = FaultInjector.from_env()
    return _injector


def inject(site: str, **ctx: Any) -> Optional[str]:
    """The one call every injection site makes; returns the fired
    cooperative action's name (``"nan_loss"``), else None. With no plan
    configured this is a global read + None check — zero overhead, zero
    side effects."""
    inj = _injector
    if inj is _UNRESOLVED:
        inj = get_injector()
    if inj is None:
        return None
    return inj.fire(site, **ctx)


def reset_injector() -> None:
    """Forget the cached environment decision (tests re-point the plan)."""
    global _injector
    _injector = _UNRESOLVED
