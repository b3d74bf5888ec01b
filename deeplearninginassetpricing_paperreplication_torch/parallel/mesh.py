"""Device mesh + panel sharding: the call-site façade over
``parallel.partition``.

The counterpart of the JAX package's ``parallel/mesh.py``. There GSPMD
shards the [T, N, F] panel's stock axis over a 1-D mesh and inserts the
``psum``s of the masked cross-sectional reductions; here a mesh is a grid
over the ranks of a ``torch.distributed`` process group, each rank holds
its own contiguous stock span (:func:`shard_batch` returns the rank's
local batch), and the sums over stocks are all-reduced where the losses
form them (``parallel.collectives.stock_sum``). Parameters and the macro
series are tiny and replicated on every rank.

Axes:
    'stocks'  — shards N (panel data parallelism; the big arrays)
    'batch'   — legacy name of the member axis; new code uses
                partition.MEMBER_AXIS / partition.GRID_AXIS
"""

from __future__ import annotations

from .partition import (  # noqa: F401 — re-exported call-site API
    BATCH_AXIS,
    STOCK_AXIS,
    batch_shardings,
    create_2d_mesh,
    create_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "BATCH_AXIS", "STOCK_AXIS", "batch_shardings", "create_2d_mesh",
    "create_mesh", "replicated", "shard_batch",
]
