"""Deterministic, plan-driven fault injection.

The port's copy of the JAX package's ``reliability/faults.py``, the part
the port's sites use (stdlib only; the two packages share the plan format
and the ``DLAP_FAULT_PLAN`` variable, so one plan drives either, where it
names only the actions below). The paper's protocol is a long
multi-run pipeline (three GAN phases × a hyperparameter sweep × a 9-member
ensemble), exactly the shape that dies to preemptions, OOM kills and NaN
blowups hours in. Named injection sites sit in the port's verified file IO
(``checkpoint/save``, ``checkpoint/saved``, ``checkpoint/load``), the
trainer's segment loop (``trainer/epoch_loop``), the data plane
(``pipeline/decode``, ``pipeline/transfer``, ``data/shard_read``), the
sweep (``sweep/bucket``, ``sweep/ledger_write``), the promotion gate
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
                        self: the OOM-kill / preemption death mode),
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
  * ``persistent``    — fire on EVERY matching hit from the Nth on, instead
                        of exactly on the Nth.

Hit counters are per process. The JAX package's cross-process counter
file (``DLAP_FAULT_STATE``), its fault events log (``DLAP_FAULT_EVENTS``)
and the ``hang`` action serve its supervisor and elastic sweep, which the
port does not have yet; a plan that names ``hang`` is refused here.

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

ACTIONS = ("raise", "kill", "truncate_file", "nan_loss")

# the named injection sites threaded through the port (documentation —
# the injector fires for any site string a plan names)
SITES = (
    "checkpoint/save",         # before a verified write (ctx: path)
    "checkpoint/saved",        # after data + digest land (ctx: path)
    "checkpoint/load",         # before a verified read (ctx: path)
    "trainer/epoch_loop",      # after each training segment (ctx: phase,
                               #   epochs_done; `nan_loss` poisons it)
    "pipeline/decode",         # per split, before its decode (ctx: split)
    "pipeline/transfer",       # per split, before its transfer (ctx: split)
    "data/shard_read",         # per chunked-store shard, before its digest
                               #   check (ctx: path, split, shard)
    "sweep/bucket",            # per sweep bucket trained (ctx: bucket,
                               #   n_buckets, path=the bucket's ledger key)
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


class FaultInjector:
    """Executes one parsed fault plan against named site hits."""

    def __init__(self, plan: Union[Dict[str, Any], List[Dict[str, Any]]]):
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
        # per-ENTRY hit counters (not per-site): two entries on one site with
        # trigger_count 1 and 2 see the same hit stream but fire separately
        self.counts: List[int] = [0] * len(self.plan)

    # -- the hot path ---------------------------------------------------------

    def fire(self, site: str, **ctx: Any) -> Optional[str]:
        """Record one hit of `site`; execute any entry whose trigger is
        reached. Returns a cooperative-action token (``"nan_loss"``) for the
        caller to apply, else None. ``raise``/``kill`` never return;
        ``truncate_file`` corrupts and returns None."""
        matching = [
            i for i, f in enumerate(self.plan)
            if f["site"] == site
            and not (f["match"] and f["match"] not in str(ctx.get("path", "")))
        ]
        pending = []
        for i in matching:  # count every entry's hit before any fires
            self.counts[i] += 1
            f = self.plan[i]
            if self.counts[i] == f["trigger_count"] or (
                    f["persistent"] and self.counts[i] >= f["trigger_count"]):
                pending.append(f)
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
        if action == "nan_loss":
            return "nan_loss"  # cooperative: the site poisons its own output
        if action == "raise":
            raise FaultInjected(f"injected raise at {site} (ctx={ctx})")
        if action == "kill":
            # last words first: the serving plane dumps its flight recorder
            # here, so an injected SIGKILL leaves the in-flight evidence
            for hook in list(_pre_death_hooks):
                try:
                    hook(site, action)
                except Exception:
                    pass  # a hook must never change the death mode
            # the OOM-kill / preemption death mode: no cleanup, no excepthook
            os.kill(os.getpid(), signal.SIGKILL)
            while True:  # pragma: no cover — unreachable after SIGKILL lands
                time.sleep(1)
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
        return cls(plan)


# -- module-level singleton (the form the injection sites call) --------------

_UNRESOLVED = ()  # sentinel: environment not yet inspected
_injector: Any = _UNRESOLVED
# callables (site, action) → None run before a kill executes
_pre_death_hooks: List[Any] = []


def add_pre_death_hook(fn) -> None:
    """Register a last-words callback run before a ``kill`` fault executes
    (the serving flight recorder's dump). Callbacks must be fast and must
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
