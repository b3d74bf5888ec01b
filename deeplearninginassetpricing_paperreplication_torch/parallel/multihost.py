"""Multi-process distribution: joining a ``torch.distributed`` process
group, and the member-outer / stock-inner hybrid mesh over its ranks.

The counterpart of the JAX package's ``parallel/multihost.py``. There each
host initializes the JAX distributed runtime once and GSPMD places the
collectives on one global mesh; here every process is a rank of a
``torch.distributed`` group driving one device, and the mesh is a grid over
the group's ranks (``parallel.partition.Mesh``). For this workload:

* the ensemble/sweep member axis ('batch') goes OUTER: members are
  independent (no gradient traffic), so the slow hops between granules
  carry nothing while they train;
* the panel's stock axis ('stocks') goes INNER: the masked stock sums of
  the losses all-reduce every step, over the ranks of one granule.

**The granule.** In JAX the slow (DCN) granule is a TPU slice, else the
owning process, and one process drives several devices. A torch rank
drives one device, so the port's granule is the **node**: under
``torch.distributed.run`` (torchrun) the node index it exports,
``GROUP_RANK``; without it each process is its own granule, as in JAX.
Ranks of one node share its fast links (NVLink, shared memory); the links
between nodes are the slow ones.

Without a process group the world is one rank: the mesh is 1 × 1 over
rank 0, and no collective runs.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import choose_backend, join_process_group
from .partition import (
    BATCH_AXIS,
    STOCK_AXIS,
    Mesh,
    create_2d_mesh,
    rank,
    world_size,
)

GRANULE_ENV = "GROUP_RANK"  # torchrun's node index
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
# the join and every collective of an explicitly joined rank: a rank whose
# peer died raises within it instead of waiting torch's default 30 minutes
JOIN_TIMEOUT = datetime.timedelta(seconds=300)


def _default_device(device) -> torch.device:
    """`device`, or this process's current card where there is one, else
    the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """Idempotent ``dist.init_process_group`` wrapper. Returns True when
    this process is (now) a rank of a process group.

    A group that already exists returns True at once. With explicit
    arguments the process joins ``tcp://<coordinator_address>`` as rank
    `process_id` of `num_processes`, on the backend
    ``collectives.choose_backend`` picks for `device` (this rank's device;
    the current card by default, else the CPU): NCCL where each rank of the
    host (``LOCAL_WORLD_SIZE``, else `num_processes`) has a card of its
    own, gloo where ranks share one; the join and its collectives time out
    after ``JOIN_TIMEOUT``. With no arguments it joins only where
    the environment is torchrun's (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``; ``collectives.join_process_group``), and otherwise
    returns False: a single process has nothing to join.

    A configured environment that fails to join raises: a run never falls
    back to one rank."""
    if dist.is_available() and dist.is_initialized():
        return True
    explicit = (coordinator_address, num_processes, process_id)
    if all(a is None for a in explicit):
        if not all(k in os.environ for k in TORCHRUN_ENV):
            return False
        join_process_group(_default_device(device))
        return True
    if any(a is None for a in explicit):
        raise ValueError("initialize_distributed: give coordinator_address, "
                         "num_processes and process_id together")
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    dev = _default_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dist.init_process_group(choose_backend(dev, local_world),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=JOIN_TIMEOUT)
    return True


def node_index() -> int:
    """This process's granule: torchrun's ``GROUP_RANK``, else its rank
    (each process its own granule)."""
    value = os.environ.get(GRANULE_ENV)
    return int(value) if value is not None else rank()


def rank_granules() -> List[int]:
    """Every rank's granule (:func:`node_index`), rank by rank: one
    all_reduce(SUM) of a zero-filled buffer whose entry r rank r fills,
    on the card under NCCL, else on the CPU. [node_index()] without a
    group."""
    world = world_size()
    if world == 1:
        return [node_index()]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = torch.zeros(world, dtype=torch.int64, device=dev)
    buf[rank()] = node_index()
    dist.all_reduce(buf)
    return buf.cpu().tolist()


def create_hybrid_mesh(members_per_host_group: Optional[int] = None,
                       axis_names: Tuple[str, str] = (BATCH_AXIS, STOCK_AXIS),
                       devices: Optional[Sequence] = None,
                       granules: Optional[Sequence[int]] = None) -> Mesh:
    """('batch', 'stocks') mesh laid out granule-outer / granule-inner.

    `devices` are the group's ranks by default, their `granules` gathered
    (:func:`rank_granules`). Explicit `devices` (stand-in ranks, or one
    process's ``torch.device``s) lie in one granule unless `granules`
    names each one's.

    `members_per_host_group` is the size of the batch axis, by default the
    number of granules; the devices must split into that many member
    groups. With more than one granule the devices are ordered
    granule-major (then by their place in `devices`), so that each member
    row lies within a granule where the rows align with granules, and the
    stock axis is at least contiguous within each granule where they do
    not. With one granule the grid is ``create_2d_mesh``'s contiguous
    one. (JAX also has a TPU-slice branch through ``mesh_utils``; slice
    metadata has no torch counterpart, so there is none here.)"""
    if devices is None:
        devices = list(range(world_size()))
        if granules is None:
            granules = rank_granules()
    devices = list(devices)
    n = len(devices)
    granules = [0] * n if granules is None else [int(g) for g in granules]
    if len(granules) != n:
        raise ValueError(f"{len(granules)} granules for {n} devices")
    n_slices = len(set(granules))
    n_batch = members_per_host_group or max(n_slices, 1)
    if n % n_batch != 0:
        raise ValueError(f"{n} devices do not split into {n_batch} member "
                         "groups")
    axis_names = tuple(axis_names)
    if n_slices > 1:
        order = sorted(range(n), key=lambda i: (granules[i], i))
        return _grid([devices[i] for i in order], n_batch, axis_names)
    if axis_names == (BATCH_AXIS, STOCK_AXIS):
        return create_2d_mesh(n_batch, n // n_batch, devices=devices)
    return _grid(devices, n_batch, axis_names)


def _grid(devices: Sequence, n_batch: int, axis_names) -> Mesh:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = list(devices)
    return Mesh(grid.reshape(n_batch, len(devices) // n_batch), axis_names)


def process_local_summary(device=None) -> dict:
    """Small observability dict for logs, with the JAX package's keys: this
    rank and the world size, the devices the rank drives (one) and the
    world's, and the platform of `device` (this rank's; the current card
    by default, else the CPU): "gpu" or "cpu"."""
    dev = _default_device(device)
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": 1,
        "global_devices": world_size(),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
    }
