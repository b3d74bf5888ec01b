"""Sequence (context) parallelism: the LSTM recurrence over a time-sharded
mesh.

The counterpart of the JAX package's ``parallel/sequence.py``. The
reference consumes its whole macro history in one ``nn.LSTM`` call on one
device; this module cuts the time axis into contiguous chunks over a 1-D
mesh axis (``TIME_AXIS``) and runs the recurrence as a pipeline over the
positions, the recurrent counterpart of ring sequence parallelism (here the
sequential state is an LSTM carry instead of KV blocks):

* the input projection ``x_d @ W_ihᵀ + (b_ih + b_hh)``, all the large
  products, runs on each position's own [T/D, I] chunk; every position's
  projection is issued on its device before the recurrence starts, so the
  devices compute them side by side;
* the recurrence runs as D stages in order: stage d scans its projected
  chunk from the carry it was handed (``models.recurrent.lstm_recur``, the
  loop of ``lstm_scan``), then copies the [H] carry (h, c) to position
  d + 1's device, the only traffic between positions;
* inputs, projections and outputs stay on their positions: memory per
  device is O(T/D).

The mesh is a single-process mesh of ``torch.device``s
(``parallel.partition``: ``MeshConfig(((TIME_AXIS, D),), devices)``), where
one device may hold several positions (a CPU test, or spans of one card).
JAX runs the same pipeline under ``shard_map`` with ``ppermute`` hand-offs;
the values are the one-device LSTM's up to the projection's summation
order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

from ..models.recurrent import lstm_project, lstm_recur
from .partition import Mesh, position_device

TIME_AXIS = "time"

Chunks = Tuple[torch.Tensor, ...]


def _time_devices(mesh: Mesh, axis_name: str) -> List[torch.device]:
    """The device of each position along `axis_name`, the mesh's one
    axis."""
    if tuple(mesh.shape) != (axis_name,):
        raise ValueError(f"sequence parallelism runs over a 1-D mesh of axis "
                         f"{axis_name!r}; got axes {tuple(mesh.shape)}")
    return [position_device(entry) for _, entry in mesh.positions()]


def _check_divides(T: int, D: int, axis_name: str) -> None:
    if T % D:
        raise ValueError(f"sequence length {T} must divide over mesh axis "
                         f"{axis_name!r} (size {D}); pad the sequence")


def shard_sequence(x: torch.Tensor, mesh: Mesh,
                   axis_name: str = TIME_AXIS) -> Chunks:
    """x [T, ...] cut into the positions' contiguous [T/D, ...] chunks,
    each on its position's device."""
    devices = _time_devices(mesh, axis_name)
    T, D = x.shape[0], len(devices)
    _check_divides(T, D, axis_name)
    return tuple(chunk.to(dev)
                 for chunk, dev in zip(x.split(T // D), devices))


def sequence_sharded_lstm(params: Dict[str, torch.Tensor],
                          x: Union[torch.Tensor, Sequence[torch.Tensor]],
                          mesh: Mesh, axis_name: str = TIME_AXIS) -> Chunks:
    """One LSTM layer over a time-sharded sequence: x [T, I] (or
    :func:`shard_sequence`'s chunks) → the chunks of h [T, H], each
    [T/D, H] on its position's device.

    `params` uses the torch layout of ``nn.LSTM`` (w_ih [4H, I], w_hh
    [4H, H], b_ih, b_hh), on any device; each position reads its own
    copy."""
    devices = _time_devices(mesh, axis_name)
    D = len(devices)
    if isinstance(x, torch.Tensor):
        chunks = shard_sequence(x, mesh, axis_name)
    else:
        chunks = tuple(x)
        if len(chunks) != D:
            raise ValueError(f"{len(chunks)} chunks for mesh axis "
                             f"{axis_name!r} of size {D}")
        _check_divides(sum(c.shape[0] for c in chunks), D, axis_name)
        if len({c.shape[0] for c in chunks}) != 1:
            raise ValueError("the chunks must be of one length: "
                             f"{[c.shape[0] for c in chunks]}")
        chunks = tuple(c.to(dev) for c, dev in zip(chunks, devices))
    copies = {}
    for dev in devices:
        if dev not in copies:
            copies[dev] = {k: v.to(dev) for k, v in params.items()}
    local = [copies[dev] for dev in devices]
    # the parallel part: every position's projection, issued before the
    # recurrence so the devices compute them side by side
    zx = [lstm_project(p, c) for p, c in zip(local, chunks)]
    H = params["w_hh"].shape[-1]
    carry = (zx[0].new_zeros(H), zx[0].new_zeros(H))
    out = []
    for d, dev in enumerate(devices):
        # the hand-off: 2·H floats from the previous position
        carry = (carry[0].to(dev), carry[1].to(dev))
        ys, carry = lstm_recur(local[d], zx[d], carry)
        out.append(ys)
    return tuple(out)
