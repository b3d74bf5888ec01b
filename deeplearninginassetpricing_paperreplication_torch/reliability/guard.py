"""Trainer divergence guard: detect non-finite segments, abort before they
reach a checkpoint.

The port's copy of the JAX package's ``reliability/guard.py``. A blown-up
loss at epoch 300 silently poisons every later epoch, the best trackers
(NaN comparisons are False, so the *pre-divergence* best survives, masking
the blowup), and ultimately the written checkpoints. The guard closes that
hole at the trainer's segment boundaries: after each segment it checks the
segment's per-epoch loss/grad series (already on the host, read in each
epoch's one sync) for non-finite values, and on a trip the trainer copies
the pre-segment snapshot back into the live tensors and retries; after
``guard_max_trips`` CONSECUTIVE trips it raises :class:`DivergenceError`
instead of writing NaN checkpoints.

Numbers are unchanged: the check reads series the epochs already produce,
so a guarded run's outputs are bit for bit an unguarded one's.

Module level stays stdlib-only (the JAX copy reads the series through
numpy): the reliability package loads without numpy.
"""

from __future__ import annotations

import math
from typing import Any, Dict

# the per-epoch series the check reads, whichever of them a phase produces
GUARD_KEYS = ("train_loss", "train_loss_cond", "grad_norm")


class DivergenceError(RuntimeError):
    """Non-finite loss/grads persisted across the guard's retry budget."""


def segment_nonfinite(hist: Dict[str, Any]) -> bool:
    """True when any guarded per-epoch series (a 1-D array or sequence)
    in one segment's stacked history contains a non-finite value."""
    return any(not math.isfinite(float(v))
               for k in GUARD_KEYS if k in hist for v in hist[k])
