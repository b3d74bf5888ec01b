"""Reliability pieces the port's trainer, sweep, supervisor and promotion
gate stand on, copied from the JAX package's ``reliability/`` (module
level stdlib only, no torch):

  * :mod:`.faults`   — the plan-driven fault injector (``DLAP_FAULT_PLAN``)
    behind named sites; zero overhead with no plan set;
  * :mod:`.guard`    — the trainer's divergence guard: the non-finite
    segment check and :class:`DivergenceError`;
  * :mod:`.verified` — atomic + sha256-verified + generational file IO;
  * :mod:`.ledger`   — the durable sweep ledger: one verified record per
    completed architecture bucket, keyed by content, and quarantine
    markers for poison buckets;
  * :mod:`.supervisor` — supervised execution: hang detection from a stale
    heartbeat, restart with ``--resume``/``--resume-from-ledger``,
    crash-loop policy (``python -m ...supervise``);
  * :mod:`.scheduler` — the leased, file-locked work queue an elastic
    sweep's workers claim buckets from, and the supervised worker fleet;
  * :mod:`.promotion` — the gated serving pointer (``serving_current.json``)
    and its ``promote``/``rollback``/``show`` CLI.
"""

from .guard import GUARD_KEYS, DivergenceError, segment_nonfinite

__all__ = ["GUARD_KEYS", "DivergenceError", "segment_nonfinite"]
