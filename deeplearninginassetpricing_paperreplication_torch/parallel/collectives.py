"""The collectives of stock-sharded training: every sum over the stock axis,
written out.

In the JAX package GSPMD inserts a ``psum`` wherever a masked reduction
crosses the sharded stock axis, and the transposes of those ``psum``s and
of the per-device kernels give the replicated parameters their summed
cotangents. PyTorch has no such pass, so the port writes each one:

* :class:`StockShard` is one rank's place in a 1-D stock mesh: its
  contiguous span ``[start, stop)`` of the padded global stock axis of
  ``n_global`` stocks, the world size and the process group. It travels in
  ``ExecutionConfig.shard`` (as JAX's ``shard_mesh``/``shard_axis`` do);
  None, or a world of 1, is the unsharded route;
* :func:`stock_sum` is the sum over the stock axis of every rank's local
  stocks: the local sum, then ``all_reduce(SUM)``. Its backward is
  ``all_reduce(SUM)`` of the incoming cotangent, not the identity. Every
  rank computes the replicated values (F, the losses) in full, so the
  cotangent a rank holds for one of them is only its own stocks' share:
  the loss is a stock sum of terms in F, and F is itself a stock sum, so a
  rank's cotangent of F covers its own stocks' terms. The stocks behind F
  on rank r need the whole cotangent, the sum over ranks;
* a replicated value's cotangent summed over ranks is its true cotangent
  only if the loss's own seed sums to one over the ranks. Every rank seeds
  1, so every cotangent is `world` times the true one (the trap of
  ``torch.distributed.nn.functional.all_reduce`` alone);
  :func:`all_reduce_grads` all-reduces the parameters' gradients as one
  flattened bucket once per step and divides by `world`, a power of two in
  practice, so the division is exact. (Not DDP: it averages per-rank
  losses, and this loss is no mean of per-rank losses.)

At world size 1 no collective runs and every function is the plain local
reduction, so the unsharded route stays bit for bit.

The backend: NCCL where every rank has a card of its own, gloo where ranks
share one (NCCL refuses two ranks on one device). gloo implements only
``all_reduce`` and ``broadcast`` on CUDA tensors, so those are the only
collectives used on card tensors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class StockShard:
    """Rank `rank` of `world` holds the stocks ``[start, stop)`` of the
    padded global axis of `n_global`; `group` is the process group (None:
    the default one)."""

    rank: int
    world: int
    start: int
    stop: int
    n_global: int
    group: Any = None

    @property
    def span(self):
        return self.start, self.stop


def is_sharded(shard: Optional[StockShard]) -> bool:
    return shard is not None and shard.world > 1


def shard_of(n_global: int, group=None) -> StockShard:
    """This rank's :class:`StockShard` of a padded stock axis of
    `n_global` over the default process group (or `group`); world size 1
    without one. The axis must divide evenly."""
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size(group)
        r = dist.get_rank(group)
    else:
        world, r = 1, 0
    if n_global % world:
        raise ValueError(f"stock axis {n_global} not divisible by world "
                         f"size {world}; pad with PanelDataset.pad_stocks()")
    w = n_global // world
    return StockShard(r, world, r * w, (r + 1) * w, n_global, group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _StockSum(torch.autograd.Function):
    """Forward: the local sum over `dim`, then all_reduce(SUM); backward:
    all_reduce(SUM) of the cotangent, broadcast back over `dim`."""

    @staticmethod
    def forward(ctx, x, dim, keepdim, group):
        ctx.dim, ctx.keepdim, ctx.group = dim, keepdim, group
        ctx.size = x.shape[dim]
        return _all_reduce(x.sum(dim=dim, keepdim=keepdim), group)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        if not ctx.keepdim:
            g = g.unsqueeze(ctx.dim)
        shape = list(g.shape)
        shape[ctx.dim] = ctx.size
        return g.expand(shape), None, None, None


def stock_sum(x: torch.Tensor, dim: int = -1,
              shard: Optional[StockShard] = None,
              keepdim: bool = False) -> torch.Tensor:
    """Σ over the stock dimension `dim` of every rank's stocks; the plain
    ``x.sum(dim)`` without a shard or at world size 1."""
    if not is_sharded(shard):
        return x.sum(dim=dim, keepdim=keepdim)
    dim = dim % x.dim()
    return _StockSum.apply(x, dim, keepdim, shard.group)


def stock_amax(x: torch.Tensor, dim, shard: Optional[StockShard] = None
               ) -> torch.Tensor:
    """max over `dim` (the stock dimension among them) of every rank's
    stocks, without a gradient (the diagnostics' largest weight)."""
    out = x.amax(dim=dim)
    if is_sharded(shard):
        out = _all_reduce(out.detach(), shard.group, dist.ReduceOp.MAX)
    return out


def all_reduce_grads(grads: Sequence[torch.Tensor],
                     shard: Optional[StockShard]) -> List[torch.Tensor]:
    """The true gradients of the replicated parameters from every rank's
    share (see the module docstring): one all_reduce(SUM) of the flattened
    bucket, divided by the world size. The identity at world size 1."""
    grads = list(grads)
    if not is_sharded(shard) or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=shard.group)
    flat = flat / shard.world
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


def barrier(shard: Optional[StockShard]) -> None:
    """Wait for every rank (nothing at world size 1)."""
    if is_sharded(shard):
        dist.barrier(group=shard.group)


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL where each local rank has a card of its own, else gloo (ranks
    sharing a card, or the CPU)."""
    if (device.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def gather_ints(values: Sequence[int], shard: Optional[StockShard],
                device) -> List[List[int]]:
    """Every rank's `values` (the same count on each), rank by rank: an
    all_reduce(SUM) of a zero-filled [world, k] buffer whose row r rank r
    fills, on `device` (gloo's collectives on card tensors are all_reduce
    and broadcast only). [values] at world size 1."""
    if not is_sharded(shard):
        return [list(values)]
    buf = torch.zeros(shard.world, len(values), dtype=torch.int64,
                      device=device)
    buf[shard.rank] = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(buf, group=shard.group)
    return buf.cpu().tolist()


def join_process_group(device: torch.device
                       ) -> Tuple[torch.device, Optional[str]]:
    """Join the process group that ``torch.distributed.run`` (torchrun)
    describes in the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Returns (this
    rank's device, the backend): a CUDA `device` becomes ``cuda:LOCAL_RANK
    % device_count``, the CPU stays the CPU. Without those variables there
    is no group: (`device`, None), world size 1. A backend that fails to
    initialize raises; nothing carries on with one rank."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device, None
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = choose_backend(device, local_world)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return device, backend


def leave_process_group() -> None:
    """Destroy the default process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
