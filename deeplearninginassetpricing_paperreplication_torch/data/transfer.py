"""Mask-aware host→device panel transfer.

The panel batch is mostly zeros: the loader zero-fills every masked entry
of `individual` [T, N, F] and `returns` [T, N], and coverage is about 35-60%
of the (t, i) cells. A dense copy ships every masked zero over the link.

`device_put_batch(packed=True)` ships only the valid rows plus their flat
int32 indices and scatters them into zeros on the device (``index_copy_``):
bit for bit :meth:`..panel.PanelDataset.to_batch` by construction, at
`coverage + 1/(F+1)` of the bytes. `packed="auto"` packs when the coverage
is below :data:`AUTO_PACK_THRESHOLD`. The port's counterpart of the JAX
package's ``data/transfer.py``.

On a CUDA device the wire payload is staged in pinned host memory and
copied without blocking on a copy stream of its own; the scatter runs on
that stream too, and the caller's stream waits for it, so the batch is
ordered before any later work there. :func:`sync_batch` blocks the host
until the copies are done. On the CPU the same code runs with plain host
tensors and no streams (the tests' route).

The JAX package's ``warm_scatter`` and ``_upcast_f32`` exist to compile XLA
programs ahead of a timed transfer; eager PyTorch compiles nothing, so they
have no counterpart here.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils.config import resolve_device

# Below this valid-entry fraction the packed route ships fewer bytes once
# the int32 index is paid: packed ≈ c·(F+1)·4 + c·4 bytes per cell against
# dense (F+1)·4 — the index adds ~1/(F+1), negligible at F = 46.
AUTO_PACK_THRESHOLD = 0.85

Batch = Dict[str, np.ndarray]

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def pack_rows(
    mask: np.ndarray, individual: np.ndarray, returns: np.ndarray
) -> tuple:
    """The packed valid-rows wire representation: flat indices [V] int32,
    valid feature rows [V, F] f32, valid returns [V] f32.

    THE definition of the repack: `device_put_batch`, the decoded-panel
    disk cache (``data/diskcache.py`` stores these arrays, so a cache hit
    skips the flatnonzero/gather) and the streamed transfer
    (``data/pipeline.stream_batch``) all ship exactly these bytes."""
    mask = np.asarray(mask, np.float32)
    t, n = mask.shape
    f = int(individual.shape[-1])
    idx = np.flatnonzero(mask.reshape(-1)).astype(np.int32)
    rows = np.ascontiguousarray(
        np.asarray(individual).reshape(t * n, f)[idx]
    )
    ret = np.ascontiguousarray(
        np.asarray(returns, np.float32).reshape(t * n)[idx]
    )
    return idx, rows, ret


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every host→device panel copy on `device` runs on."""
    with _streams_lock:
        if device not in _streams:
            _streams[device] = torch.cuda.Stream(device)
        return _streams[device]


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over `a`'s memory (no copy when it is contiguous). A
    read-only array (a cache hit's memmap) is only read from here."""
    a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # non-writable buffer
        return torch.from_numpy(a)


class PinnedSlabs:
    """Two host slabs that stage the chunks of a host→device copy: pinned
    on a CUDA device, plain memory on the CPU.

    Chunk i fills slab i % 2. A non-blocking copy from pinned memory
    returns before its DMA is done, so a slab is refilled only after the
    CUDA event recorded behind its previous copy has fired: that is what
    lets the fill of chunk k + 1 overlap the DMA of chunk k without ever
    overwriting bytes still on the wire. Allocate one per pipeline and pass
    it to every :func:`..pipeline.stream_batch` call: pinning is paid once.
    """

    def __init__(self, device: Union[str, torch.device], slab_bytes: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.slab_bytes = int(slab_bytes)
        # allocated at first use: a one-chunk copy pins one slab
        self.slabs: List[Optional[torch.Tensor]] = [None, None]
        self.events = ([torch.cuda.Event() for _ in range(2)] if self.cuda
                       else [None, None])
        self.reuses = 0  # fills of a slab that had been filled before

    def fill(self, i: int, src: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
        """Copy `src` (cast to `dtype`, round to nearest even for bf16)
        into slab i % 2 once its previous copy is done; returns the view."""
        k = i % 2
        if self.slabs[k] is None:
            self.slabs[k] = torch.empty(self.slab_bytes, dtype=torch.uint8,
                                        pin_memory=self.cuda)
        else:
            self.reuses += 1
            if self.cuda:
                self.events[k].synchronize()
        n = src.numel() * torch.empty((), dtype=dtype).element_size()
        if n > self.slab_bytes:
            raise ValueError(f"chunk of {n} bytes exceeds the slab "
                             f"({self.slab_bytes})")
        view = self.slabs[k][:n].view(dtype).view(src.shape)
        view.copy_(src)
        return view

    def copied(self, i: int, stream) -> None:
        """Record that slab i % 2's copy was enqueued on `stream`."""
        if self.cuda:
            self.events[i % 2].record(stream)


def _chunk_bounds(n: int, per_chunk: int) -> List[Tuple[int, int]]:
    per_chunk = max(1, per_chunk)
    return [(a, min(a + per_chunk, n)) for a in range(0, max(n, 1), per_chunk)]


def _ship_rows(n_rows: int, f: int, rows_of: Callable[[int, int], np.ndarray],
               wire: torch.dtype, dev: torch.device, slabs: PinnedSlabs,
               chunk_rows: int, stream, stats: Dict[str, Any]
               ) -> torch.Tensor:
    """[n_rows, F] rows, `rows_of(a, b)` on the host, as a `wire` tensor on
    `dev`: chunk by chunk through `slabs`, each chunk's copy enqueued on
    `stream` without blocking while the host prepares the next one."""
    out = torch.empty((n_rows, f), dtype=wire, device=dev)
    bounds = _chunk_bounds(n_rows, chunk_rows)
    for i, (a, b) in enumerate(bounds):
        t0 = time.perf_counter()
        staged = slabs.fill(i, _host_tensor(rows_of(a, b)), wire)
        stats["host_ms"] += (time.perf_counter() - t0) * 1e3
        out[a:b].copy_(staged, non_blocking=True)
        slabs.copied(i, stream)
    stats["chunks"] += len(bounds)
    stats["wire_bytes"] += out.numel() * out.element_size()
    return out


def _put_small(a, dev: torch.device, stats: Dict[str, Any],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    t = torch.tensor(np.asarray(a), dtype=dtype)  # a copy: `a` may be read-only
    stats["wire_bytes"] += t.numel() * t.element_size()
    return t.to(dev)


def ship_batch(
    batch: Batch,
    packed: Union[bool, str] = "auto",
    device=None,
    bf16_wire: bool = False,
    packed_rep: Optional[tuple] = None,
    chunk_bytes: Optional[int] = None,
    slabs: Optional[PinnedSlabs] = None,
    stream=None,
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """The one transfer both :func:`device_put_batch` (`chunk_bytes` None:
    the whole payload in one staged copy) and
    :func:`..pipeline.stream_batch` (slabs of `chunk_bytes`) run.

    `packed_rep`: a precomputed (idx, rows, ret) triple (a disk-cache
    hit's memmaps); else the valid rows are gathered chunk by chunk from
    `individual`, the same bytes as :func:`pack_rows`. `stream`: the stream
    the batch is ordered before (default: the calling thread's current
    stream on the device). `stats`, when given, receives the bytes shipped
    (`wire_bytes`), the host ms spent packing and filling slabs
    (`host_ms`), the chunk count and the route."""
    mask = np.asarray(batch["mask"], np.float32)
    t, n = mask.shape
    ind = np.asarray(batch["individual"])
    if ind.dtype != np.float32:
        raise TypeError(
            "device_put_batch expects a float32 panel (loader contract); "
            f"got individual dtype {ind.dtype}"
        )
    f = int(ind.shape[-1])
    if packed == "auto":
        packed = float(mask.mean()) < AUTO_PACK_THRESHOLD
    dev = resolve_device("cuda" if device is None else device)
    cuda = dev.type == "cuda"
    wire = torch.bfloat16 if bf16_wire else torch.float32
    esize = 2 if bf16_wire else 4
    st = stats if stats is not None else {}
    st.update(wire_bytes=0, host_ms=0.0, chunks=0, packed=bool(packed))
    consumer = None
    if cuda:
        consumer = stream if stream is not None else torch.cuda.current_stream(dev)
        side = copy_stream(dev)
    else:
        side = None

    def run() -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        if packed:
            t0 = time.perf_counter()
            if packed_rep is None:
                idx = np.flatnonzero(mask.reshape(-1)).astype(np.int32)
                flat = ind.reshape(t * n, f)
                rows_of = lambda a, b: flat[idx[a:b]]  # noqa: E731
                ret = np.asarray(batch["returns"], np.float32).reshape(-1)[idx]
            else:
                idx, rows_rep, ret = packed_rep
                rows_of = lambda a, b: rows_rep[a:b]  # noqa: E731
            st["host_ms"] += (time.perf_counter() - t0) * 1e3
            n_rows = int(np.asarray(idx).shape[0])
            # the small arrays first: a copy from pageable memory waits for
            # the stream, which then holds no slab copy yet
            idx_d = _put_small(idx, dev, st, torch.int32).long()
            ret_d = _put_small(ret, dev, st)
        else:
            n_rows = t * n
            flat = ind.reshape(n_rows, f)
            rows_of = lambda a, b: flat[a:b]  # noqa: E731
            for k in ("returns", "mask"):
                out[k] = _put_small(batch[k], dev, st)
        per = (max(n_rows, 1) if chunk_bytes is None
               else max(1, chunk_bytes // max(1, f * esize)))
        stage = slabs if slabs is not None else PinnedSlabs(
            dev, min(per, max(n_rows, 1)) * f * esize)
        rows_d = _ship_rows(n_rows, f, rows_of, wire, dev, stage, per, side,
                            st)
        rows_d = rows_d.float() if bf16_wire else rows_d
        if not packed:
            out["individual"] = rows_d.view(t, n, f)
        else:
            ind_d = torch.zeros((t * n, f), dtype=torch.float32, device=dev)
            ind_d.index_copy_(0, idx_d, rows_d)
            out["individual"] = ind_d.view(t, n, f)
            out["returns"] = torch.zeros(
                t * n, dtype=torch.float32, device=dev).index_copy_(
                0, idx_d, ret_d).view(t, n)
            out["mask"] = torch.zeros(
                t * n, dtype=torch.float32, device=dev).index_fill_(
                0, idx_d, 1.0).view(t, n)
        for k, v in batch.items():
            if k not in out:
                out[k] = _put_small(v, dev, st)
        return out

    if not cuda:
        return run()
    with torch.cuda.device(dev), torch.cuda.stream(side):
        out = run()
    consumer.wait_stream(side)
    for v in out.values():
        v.record_stream(consumer)  # allocated on the side stream
    return out


def device_put_batch(
    batch: Batch,
    packed: Union[bool, str] = "auto",
    device=None,
    bf16_wire: bool = False,
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Transfer a full-panel batch dict to `device` (default cuda),
    optionally mask-packed: float32 tensors, bit for bit
    :meth:`..panel.PanelDataset.to_batch` on the f32 wire.

    `packed`: True / False / "auto" (pack when coverage < 0.85). Packing
    relies on the loader's guarantee that masked entries are exactly zero
    and rebuilds the mask from the indices. Extra keys (``macro``,
    ``n_assets``) pass through a plain copy.

    `bf16_wire`: ship `individual` (F× the bytes of returns and mask) as
    bfloat16, cast on the host round-to-nearest-even as JAX's
    ``astype(bfloat16)``; it lands float32 with bf16-rounded values. Only
    where every consumer of the panel rounds it to bf16 anyway
    (``ExecutionConfig.bf16_wire_ok``). `returns` and `mask` always travel
    f32.

    The f32 input contract is checked: a float64 panel from a custom loader
    would otherwise be coerced differently by the packed and dense routes.
    """
    return ship_batch(batch, packed, device, bf16_wire, stats=stats)


def sync_batch(batch: Dict[str, torch.Tensor]) -> None:
    """Block until every tensor of the batch is resident: wait for the copy
    stream of each CUDA device the batch lives on."""
    for dev in {v.device for v in batch.values()
                if isinstance(v, torch.Tensor) and v.is_cuda}:
        copy_stream(dev).synchronize()
