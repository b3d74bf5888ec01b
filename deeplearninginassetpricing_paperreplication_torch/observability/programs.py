"""Kernel launch plans as the card holds them: the port's counterpart of
the JAX package's ``observability/xla.py``.

The JAX package AOT-compiles its hot-path programs and records each one's
XLA cost and memory analysis (``xla_programs`` in ``manifest.json``).
Eager PyTorch compiles no programs; what the card holds instead is each
hand-written kernel's launch plan: route, tile, threads, shared memory
and grid, worked out for the card's SM count and the library's register
counts (``ops/sdf_ffn.py::card_fwd_plan``/``card_bwd_plan``,
``ops/cond_em.py::card_cem_plan``), and what the card makes of it —
resident blocks per SM, registers and local (spill) bytes per thread
(``fwd_plan_info``, ``bwd_plan_info``, ``cond_em.plan_info``). The
startup pipeline's ``trainer_precompile_fn`` plans every kernel of the
model's route; each plan goes through :func:`record_program`, which
emits it as a ``program`` event row and collects it for the CLI to fold
into ``manifest.json`` as ``kernel_programs``.

Module level stays stdlib-only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


def plan_fields(plan) -> Dict[str, Any]:
    """A launch plan (a dataclass or a NamedTuple) as a JSON-able dict."""
    if dataclasses.is_dataclass(plan):
        d = dataclasses.asdict(plan)
    else:
        d = dict(plan._asdict())
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in d.items()}


def record_program(events, name: str, plan, held: Dict[str, int],
                   analyses_out: Optional[Dict[str, Dict]] = None,
                   **attrs: Any) -> Dict[str, Any]:
    """One kernel's plan and what the card holds of it (`held`:
    ``blocks_per_sm``, ``registers``, ``local_bytes``) as one record: emit
    the ``program`` event row and (when given) collect it into
    `analyses_out` keyed by `name` — the dict a CLI folds into
    ``manifest.json`` as ``kernel_programs``."""
    record = {**attrs, "plan": plan_fields(plan),
              "held": {k: int(v) for k, v in held.items()}}
    if analyses_out is not None:
        analyses_out[name] = record
    if events is not None:
        events.emit("program", name, analysis=record)
    return record

