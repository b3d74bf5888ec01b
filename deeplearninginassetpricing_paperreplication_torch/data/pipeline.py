"""Overlapped startup pipeline: cache-aware decode → streamed transfer →
early kernel build.

The port's counterpart of the JAX package's ``data/pipeline.py`` (without
the mesh). Before the first training step a run must decode the panel,
copy it to the card and have the kernels its route launches built and
planned. The three have no dependency beyond "the build needs shapes" and
"the transfer needs decoded bytes", so they run as a pipeline:

  1. **decode** (thread pool, train split first): per split, hit the
     decoded-panel disk cache (:mod:`.diskcache`: memmapped arrays plus the
     packed valid-rows triple, skipping npz decompress, mask build and the
     flatnonzero/gather repack) or decode with :func:`..panel.load_panel`
     and store for next time;
  2. **transfer** (one thread): as each split's decode lands, in
     train/valid/test order, ship it with :func:`stream_batch`, which cuts
     the dominant payload into slabs staged through two pinned buffers
     (:class:`..transfer.PinnedSlabs`), so the host's fill of slab k + 1
     overlaps slab k's DMA. Bit for bit
     :func:`..transfer.device_put_batch` on every route (dense, packed,
     bf16 wire);
  3. **compile** (worker thread, t≈0): :func:`probe_split_shapes` reads the
     npz headers without touching payload bytes, so the kernel libraries
     the model's route will launch are built (``nvcc``, at first use) and
     planned for those shapes at once (:func:`trainer_precompile_fn`),
     under the load and transfer window instead of inside the first epoch.

Every stage emits ``startup/*`` spans and counters into the run's EventLog.

The chunked store (:mod:`.diskcache` ``store_chunked``/``load_chunked``):
:func:`load_splits_chunked` reads a split through per-shard digests over
the stock axis (``columns=`` restricts it to a span), re-decoding only a
torn shard from its npz. The sweep, ensemble and serving CLIs load through
it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import queue
import shutil
import threading
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..observability.events import EventLog
from ..reliability.faults import inject
from ..utils.config import resolve_device
from . import diskcache
from .panel import (
    PanelDataset,
    load_panel,
    macro_train_stats,
    normalize_macro_with,
)
from .transfer import AUTO_PACK_THRESHOLD, PinnedSlabs, pack_rows, ship_batch

SPLITS = ("train", "valid", "test")

# transfer slab size: big enough to amortize each copy's overhead, small
# enough that the fill (and cast) of slab k+1 overlaps slab k's DMA
DEFAULT_CHUNK_BYTES = 64 << 20


def split_paths(
    data_dir: Union[str, Path], split: str
) -> Tuple[Path, Optional[Path]]:
    """(char npz, macro npz or None) for one split in the reference layout."""
    data_dir = Path(data_dir)
    char = data_dir / "char" / f"Char_{split}.npz"
    macro = data_dir / "macro" / f"macro_{split}.npz"
    return char, (macro if macro.exists() else None)


# --------------------------------------------------------------------------
# stage 3 input: shape probe from npz headers (no payload bytes)
# --------------------------------------------------------------------------

def npz_member_shape(path: Union[str, Path], member: str = "data"):
    """(shape, dtype) of one .npz member from its .npy header alone: reads
    a few hundred bytes, never the (possibly ~0.5 GB) payload."""
    with zipfile.ZipFile(path) as z:
        with z.open(member + ".npy") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, _, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"unsupported .npy format version {version}")
    return shape, dtype


def probe_split_shapes(data_dir: Union[str, Path]
                       ) -> Dict[str, Dict[str, tuple]]:
    """Device-batch shapes per split, from headers only::

        {"train": {"individual": (T, N, F), "returns": (T, N),
                   "mask": (T, N), "macro": (T, M)}, ...}

    Everything the kernel plans need, available at t≈0. (A ``macro_idx``
    selection shrinks M: callers using one must adjust.)
    """
    shapes: Dict[str, Dict[str, tuple]] = {}
    for split in SPLITS:
        char, macro = split_paths(data_dir, split)
        (t, n, c), _ = npz_member_shape(char)
        entry = {
            "individual": (t, n, c - 1),
            "returns": (t, n),
            "mask": (t, n),
        }
        if macro is not None:
            (_, m), _ = npz_member_shape(macro)
            entry["macro"] = (t, m)
        shapes[split] = entry
    return shapes


# --------------------------------------------------------------------------
# stage 1: cache-aware decode
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _RawSplit:
    """One split fresh off stage 1: macro still RAW (normalization needs the
    train split's stats), packed rep present when the coverage packs."""

    ds: PanelDataset
    packed: Optional[tuple]  # (idx [V] i32, rows [V, F] f32, ret [V] f32)
    cache_hit: bool


def _load_split_raw(
    char_path: Path,
    macro_path: Optional[Path],
    use_cache: bool = True,
) -> _RawSplit:
    if use_cache:
        entry = diskcache.load(char_path, macro_path)
        if entry is not None:
            ds = PanelDataset(
                returns=entry.returns,
                individual=entry.individual,
                mask=entry.mask,
                macro=entry.macro,
                dates=entry.dates,
                variable_names=entry.variable_names,
            )
            packed = (
                (entry.idx, entry.rows, entry.ret_packed)
                if entry.idx is not None else None
            )
            return _RawSplit(ds, packed, True)
    ds = load_panel(char_path, macro_path, normalize_macro=False)
    packed = _pack_and_store_monolithic(char_path, macro_path, ds, use_cache)
    return _RawSplit(ds, packed, False)


def _pack_and_store_monolithic(
    char_path: Path,
    macro_path: Optional[Path],
    ds: PanelDataset,
    use_cache: bool,
) -> Optional[tuple]:
    """Pack (when sparse) and persist one freshly decoded split in the
    MONOLITHIC cache format: the one store call of the raw path and of a
    full-span chunked miss, so every later full-span consumer memmaps
    instead of re-deriving. Returns the packed (idx, rows, ret) triple (None
    at dense coverage)."""
    mask_f = ds.mask.astype(np.float32)
    coverage = float(mask_f.mean())
    packed = None
    if coverage < AUTO_PACK_THRESHOLD:
        # pay the repack once, here, so every later run memmaps it instead
        packed = pack_rows(mask_f, ds.individual, ds.returns)
    if use_cache:
        diskcache.store(
            char_path, macro_path,
            {
                "returns": ds.returns,
                "individual": ds.individual,
                "mask": ds.mask,
                "dates": ds.dates,
                "variable_names": ds.variable_names,
                "macro": ds.macro,
                "idx": packed[0] if packed else None,
                "rows": packed[1] if packed else None,
                "ret_packed": packed[2] if packed else None,
            },
            extra_meta={"coverage": coverage},
        )
    return packed


def _finalize_macro(ds: PanelDataset, macro_idx, stats=None):
    """Apply macro_idx selection + z-scoring to one RAW split in place, with
    :func:`..panel.macro_train_stats` / `normalize_macro_with`, so the
    result is bit for bit `load_splits`'. Returns the (mean, std) used, or
    None when the split has no macro."""
    if ds.macro is None:
        return None
    macro = np.asarray(ds.macro)
    if macro_idx is not None:
        macro = macro[:, list(macro_idx)]
    if stats is None:
        mean, std = macro_train_stats(macro)
    else:
        mean, std = stats
    ds.macro = normalize_macro_with(macro, mean, std)
    ds.mean_macro, ds.std_macro = mean, std
    return mean, std


def load_splits_cached(
    data_dir: Union[str, Path],
    macro_idx: Optional[Sequence[int]] = None,
    events: Optional[EventLog] = None,
) -> Tuple[PanelDataset, PanelDataset, PanelDataset]:
    """Drop-in for :func:`..panel.load_splits` with the decoded-panel disk
    cache in front of the npz decode: bit for bit either way.

    Big arrays of a cache-hit dataset are read-only memmaps; every consumer
    (full_batch, subsample, pad_stocks, the transfers) copies where it
    mutates, so the distinction is invisible downstream.
    """
    ev = events if events is not None else EventLog()
    use_cache = diskcache.cache_enabled()

    def job(split: str) -> _RawSplit:
        char, macro = split_paths(data_dir, split)
        inject("pipeline/decode", split=split)
        with ev.span(f"startup/load/{split}"):
            raw = _load_split_raw(char, macro, use_cache)
        ev.counter("panel_cache", value=1, split=split, hit=raw.cache_hit)
        return raw

    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = {split: ex.submit(job, split) for split in SPLITS}
        raw = {split: futs[split].result() for split in SPLITS}
    stats = _finalize_macro(raw["train"].ds, macro_idx)
    for split in ("valid", "test"):
        if stats is not None:
            _finalize_macro(raw[split].ds, macro_idx, stats)
    return raw["train"].ds, raw["valid"].ds, raw["test"].ds


# --------------------------------------------------------------------------
# stage 1b: the chunked store and shard-local loading
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _ChunkedSplit:
    """One split off the chunked reader: `ds` covers only `columns` (the
    full split when None); shard accounting feeds the startup/shard_*
    counters."""

    ds: PanelDataset
    cache_hit: bool
    shards_owned: int
    shards_loaded: int      # served straight from verified cache shards
    shards_redecoded: int   # failed the digest check → npz re-decode
    columns: Optional[Tuple[int, int]]
    monolithic: bool = False  # full-span hit served from a monolithic entry


def _slice_columns(ds: PanelDataset, columns) -> PanelDataset:
    if columns is None:
        return ds
    a, b = columns
    return PanelDataset(
        returns=ds.returns[:, a:b],
        individual=ds.individual[:, a:b, :],
        mask=ds.mask[:, a:b],
        macro=ds.macro,
        dates=ds.dates,
        variable_names=ds.variable_names,
    )


def _load_split_chunked(
    char_path: Path,
    macro_path: Optional[Path],
    columns: Optional[Tuple[int, int]] = None,
    use_cache: bool = True,
    shard_width: Optional[int] = None,
    events: Optional[EventLog] = None,
    split: str = "",
) -> _ChunkedSplit:
    """Load one split through the CHUNKED panel store, touching only the
    stock shards intersecting `columns` ([a, b) span; None = all).

    Every shard read fires the ``data/shard_read`` fault site and is
    digest-verified against the entry manifest; a torn shard is re-decoded
    from the source npz and re-stored in place, and no other shard is
    re-decoded. A corrupt manifest or global array invalidates the whole
    entry and falls back to a fresh decode + store. On a miss the npz is
    decoded once in full (a deflate member cannot be column-sliced) and the
    chunked entry written for later runs to read shard-locally.

    Width-agnostic FULL-span reads (columns None, no explicit width: the
    sweep, ensemble and serving CLIs) serve an existing MONOLITHIC entry
    first, memmapped with no payload hashing; on a miss they store both
    formats from the one decode, so the chunked read (per-shard verify and
    one concatenation) is never on a full-span consumer's warm path.
    """
    ev = events if events is not None else EventLog()
    width = diskcache.shard_width(shard_width)
    decoded: List[Optional[PanelDataset]] = [None]

    def full_decode() -> PanelDataset:
        if decoded[0] is None:
            decoded[0] = load_panel(char_path, macro_path,
                                    normalize_macro=False)
        return decoded[0]

    # an EXPLICIT width is a chunked-store request and must create/serve the
    # width-specific entry, never short-circuit past it
    width_agnostic = columns is None and shard_width is None
    if use_cache and width_agnostic:
        mono = diskcache.load(char_path, macro_path)
        if mono is not None:
            ds = PanelDataset(
                returns=mono.returns,
                individual=mono.individual,
                mask=mono.mask,
                macro=mono.macro,
                dates=mono.dates,
                variable_names=mono.variable_names,
            )
            return _ChunkedSplit(ds, True, 0, 0, 0, None, monolithic=True)

    entry = (diskcache.load_chunked(char_path, macro_path, width)
             if use_cache else None)
    if entry is not None:
        try:
            out = _read_chunked_entry(entry, columns, full_decode, ev, split)
            if out is not None:
                return out
        except MemoryError:
            raise  # transient pressure: never evict a healthy entry for it
        except Exception:  # noqa: BLE001 — any unusable entry is re-stored
            pass
        # unusable entry (bad manifest/global, or a shard restore that no
        # longer reproduces the recorded digests): evict and re-store fresh
        shutil.rmtree(entry.dir, ignore_errors=True)

    ds_full = full_decode()
    if use_cache:
        diskcache.store_chunked(
            char_path, macro_path,
            {
                "returns": ds_full.returns,
                "individual": ds_full.individual,
                "mask": ds_full.mask,
                "dates": ds_full.dates,
                "variable_names": ds_full.variable_names,
                "macro": ds_full.macro,
            },
            width=width,
            extra_meta={"coverage": float(ds_full.mask.mean())},
        )
        if width_agnostic:
            # a full-span consumer also leaves the MONOLITHIC entry behind:
            # its own warm rerun, and any later train, memmaps it
            _pack_and_store_monolithic(char_path, macro_path, ds_full,
                                       use_cache=True)
    bounds = diskcache.shard_bounds(ds_full.returns.shape[1], width)
    owned = (len(bounds) if columns is None else
             sum(1 for lo, hi in bounds
                 if hi > columns[0] and lo < columns[1]))
    ev.counter("startup/shard_owned", value=owned, split=split)
    return _ChunkedSplit(_slice_columns(ds_full, columns), False,
                         owned, 0, 0, columns)


def _read_chunked_entry(
    entry, columns, full_decode, ev: EventLog, split: str
) -> Optional[_ChunkedSplit]:
    """Serve one split from a chunked entry: verify + memmap each owned
    shard, re-decoding (and repairing) the ones that fail. Returns None when
    a repair cannot reproduce the manifest digests (the entry is stale).

    Shard digests run on a small thread pool (hashlib releases the GIL, so
    two shards hash on two cores while the in-order consumer assembles
    earlier ones). The ``data/shard_read`` fault site fires inside each
    shard's check, before that shard's digest is read."""
    bounds = entry.bounds()
    needed = entry.shards_for(columns)
    parts: Dict[str, list] = {name: [] for name in diskcache.SHARD_ARRAYS}
    n_loaded = n_redecoded = 0

    def check(i):
        inject("data/shard_read",
               path=str(entry.shard_path(i, "individual")),
               split=split, shard=i)
        return entry.verify_shard(i)

    pool = concurrent.futures.ThreadPoolExecutor(min(2, max(1, len(needed))))
    checks = {i: pool.submit(check, i) for i in needed}
    pool.shutdown(wait=False)
    for i in needed:
        ok, why = checks[i].result()
        if ok:
            arrs = entry.load_shard(i)
            n_loaded += 1
        else:
            ds_full = full_decode()
            full_arrays = {"returns": ds_full.returns,
                           "individual": ds_full.individual,
                           "mask": ds_full.mask}
            if not entry.restore_shard(i, full_arrays):
                return None  # the decode no longer matches the manifest
            a, b = bounds[i]
            arrs = {k: v[:, a:b] for k, v in full_arrays.items()}
            n_redecoded += 1
            ev.counter("startup/shard_redecode", split=split, shard=i,
                       reason=why)
        a, b = bounds[i]
        lo = a if columns is None else max(a, columns[0])
        hi = b if columns is None else min(b, columns[1])
        for name in diskcache.SHARD_ARRAYS:
            parts[name].append(arrs[name][:, lo - a:hi - a])
    assembled = {
        name: (parts[name][0] if len(parts[name]) == 1
               else np.concatenate(parts[name], axis=1))
        for name in diskcache.SHARD_ARRAYS
    }
    ds = PanelDataset(
        returns=assembled["returns"],
        individual=assembled["individual"],
        mask=assembled["mask"],
        macro=entry.load_global("macro"),
        dates=entry.load_global("dates"),
        variable_names=entry.load_global("variable_names"),
    )
    ev.counter("startup/shard_owned", value=len(needed), split=split)
    if n_loaded:
        ev.counter("startup/shard_loaded", value=n_loaded, split=split)
    return _ChunkedSplit(ds, True, len(needed), n_loaded, n_redecoded,
                         columns)


def load_splits_chunked(
    data_dir: Union[str, Path],
    macro_idx: Optional[Sequence[int]] = None,
    events: Optional[EventLog] = None,
    columns: Optional[Tuple[int, int]] = None,
    shard_width: Optional[int] = None,
) -> Tuple[PanelDataset, PanelDataset, PanelDataset]:
    """Drop-in for :func:`..panel.load_splits` through the CHUNKED panel
    store: bit for bit over the same stock span.

    `columns=(a, b)` restricts every split to that stock span (macro and
    dates stay global: they are tiny, and the TRAIN macro stats must not
    depend on the span). The sweep, evaluate_ensemble and serving CLIs read
    the full span through it.
    """
    ev = events if events is not None else EventLog()
    use_cache = diskcache.cache_enabled()

    def job(split: str) -> _ChunkedSplit:
        char, macro = split_paths(data_dir, split)
        inject("pipeline/decode", split=split)
        with ev.span(f"startup/load/{split}"):
            raw = _load_split_chunked(
                char, macro, columns=columns, use_cache=use_cache,
                shard_width=shard_width, events=ev, split=split)
        ev.counter("panel_cache", value=1, split=split, hit=raw.cache_hit,
                   chunked=not raw.monolithic)
        return raw

    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = {split: ex.submit(job, split) for split in SPLITS}
        raw = {split: futs[split].result() for split in SPLITS}
    stats = _finalize_macro(raw["train"].ds, macro_idx)
    for split in ("valid", "test"):
        if stats is not None:
            _finalize_macro(raw[split].ds, macro_idx, stats)
    return raw["train"].ds, raw["valid"].ds, raw["test"].ds


# --------------------------------------------------------------------------
# stage 2: streamed transfer
# --------------------------------------------------------------------------

def buffered_puts(n_chunks: int, make_chunk: Callable[[int], Any],
                  put: Callable[[Any], Any]) -> list:
    """Put `n_chunks` host chunks with one-chunk-ahead preparation: a
    producer thread prepares chunk k+1 while `put` handles chunk k, through
    a bounded queue (at most two prepared chunks resident). Results come
    back in chunk order; a producer error is re-raised here. For a `put`
    that blocks the host (:func:`stream_batch`'s copies do not: they are
    enqueued, and its slabs give the same overlap in one thread)."""
    if n_chunks <= 1:
        return [put(make_chunk(0))]
    q: "queue.Queue" = queue.Queue(maxsize=2)

    def producer():
        try:
            for i in range(n_chunks):
                q.put(("chunk", make_chunk(i)))
        except BaseException as e:  # re-raised on the consumer side
            q.put(("error", e))
        else:
            q.put(("done", None))

    threading.Thread(
        target=producer, daemon=True, name="panel-transfer-prep"
    ).start()
    out = []
    while True:
        kind, payload = q.get()
        if kind == "done":
            return out
        if kind == "error":
            raise payload
        out.append(put(payload))


def stream_batch(
    batch: Dict[str, np.ndarray],
    packed: Union[bool, str] = "auto",
    device=None,
    bf16_wire: bool = False,
    packed_rep: Optional[tuple] = None,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    slabs: Optional[PinnedSlabs] = None,
    stream=None,
    stats: Optional[Dict[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """:func:`..transfer.device_put_batch`, streamed: the same routing
    decision, wire dtypes and scatter, bit for bit the same tensors, but
    the dominant payload (`individual` rows dense, or the packed valid
    rows) ships in `chunk_bytes` slabs through `slabs` (two pinned buffers,
    each refilled only after its previous copy's CUDA event fired), so the
    host's gather and cast of one slab overlap the previous slab's DMA and
    no buffer the size of a split is ever pinned.

    `packed_rep`: a precomputed (idx, rows, ret) triple; on a disk-cache
    hit these are memmapped from the cache entry and the dense `individual`
    is never read. `stream`: the stream the batch is ordered before
    (default: the calling thread's current stream). `slabs` (default: two
    new slabs of `chunk_bytes`): pass one :class:`..transfer.PinnedSlabs`
    to every call of a pipeline.
    """
    dev = resolve_device("cuda" if device is None else device)
    if slabs is None:
        slabs = PinnedSlabs(dev, chunk_bytes)
    return ship_batch(batch, packed, dev, bf16_wire, packed_rep=packed_rep,
                      chunk_bytes=chunk_bytes, slabs=slabs, stream=stream,
                      stats=stats)


def _peak_rss_bytes() -> Optional[int]:
    """This process's high-water RSS (Linux ru_maxrss is KiB)."""
    try:
        import resource
    except ImportError:  # pragma: no cover — non-POSIX host
        return None
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


# --------------------------------------------------------------------------
# the pipeline orchestrator
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineResult:
    """Everything `StartupPipeline.result()` hands back."""

    datasets: Tuple[PanelDataset, PanelDataset, PanelDataset]
    batches: Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]
    compiled: Any  # compile_fn's return value
    cache_hits: Dict[str, bool]


class StartupPipeline:
    """Run decode, transfer, and compile as three overlapped stages.

    Usage::

        pipe = StartupPipeline(data_dir, bf16_wire=..., events=events,
                               compile_fn=trainer_precompile_fn(...)).start()
        ...                       # anything else the CLI wants to do
        res = pipe.result()       # blocks until batches + compile are done

    `compile_fn(shapes)`, optional, is called on a worker thread at t≈0
    with :func:`probe_split_shapes`'s output; its return value comes back as
    ``PipelineResult.compiled``. The batches are float32 tensors on
    `device` (default cuda), ordered before later work on the stream that
    was current when :meth:`start` ran. An exception from any stage is
    re-raised by ``result()``.
    """

    def __init__(
        self,
        data_dir: Union[str, Path],
        *,
        macro_idx: Optional[Sequence[int]] = None,
        packed: Union[bool, str] = "auto",
        bf16_wire: bool = False,
        device=None,
        events: Optional[EventLog] = None,
        compile_fn: Optional[Callable[[Dict], Any]] = None,
        shapes: Optional[Dict] = None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        cache: Optional[bool] = None,
    ):
        self.data_dir = Path(data_dir)
        self.macro_idx = macro_idx
        self.packed = packed
        self.bf16_wire = bf16_wire
        self.device = resolve_device("cuda" if device is None else device)
        self.events = events if events is not None else EventLog()
        self.compile_fn = compile_fn
        self.shapes = shapes
        self.chunk_bytes = chunk_bytes
        self.use_cache = diskcache.cache_enabled() if cache is None else cache
        self._started = False
        self._stream = None
        self._compile_thread: Optional[threading.Thread] = None
        self._transfer_thread: Optional[threading.Thread] = None
        self._decode_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._decode_futures: Dict[str, concurrent.futures.Future] = {}
        self._compiled: Any = None
        self._compile_error: Optional[BaseException] = None
        self._transfer_error: Optional[BaseException] = None
        self._datasets: Dict[str, PanelDataset] = {}
        self._batches: Dict[str, Dict[str, Any]] = {}
        self._cache_hits: Dict[str, bool] = {}

    def _device_context(self):
        """CUDA calls from a worker thread name their device explicitly."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    # -- stage bodies --------------------------------------------------------

    def _run_compile(self):
        try:
            with self._device_context(), self.events.span("startup/compile"):
                self._compiled = self.compile_fn(self.shapes)
        except BaseException as e:  # re-raised by result()
            self._compile_error = e

    def _decode_one(self, split: str) -> _RawSplit:
        char, macro = split_paths(self.data_dir, split)
        inject("pipeline/decode", split=split)
        with self.events.span(f"startup/load/{split}"):
            raw = _load_split_raw(char, macro, self.use_cache)
        self.events.counter("panel_cache", value=1, split=split,
                            hit=raw.cache_hit)
        return raw

    def _run_transfers(self):
        try:
            with self._device_context():
                slabs = PinnedSlabs(self.device, self.chunk_bytes)
                stats = None
                for split in SPLITS:
                    raw = self._decode_futures[split].result()
                    self._cache_hits[split] = raw.cache_hit
                    if split == "train":
                        stats = _finalize_macro(raw.ds, self.macro_idx)
                    elif stats is not None:
                        _finalize_macro(raw.ds, self.macro_idx, stats)
                    self._datasets[split] = raw.ds
                    inject("pipeline/transfer", split=split)
                    with self.events.span(f"startup/transfer/{split}"):
                        self._batches[split] = stream_batch(
                            raw.ds.full_batch(),
                            packed=self.packed,
                            device=self.device,
                            bf16_wire=self.bf16_wire,
                            packed_rep=raw.packed,
                            chunk_bytes=self.chunk_bytes,
                            slabs=slabs,
                            stream=self._stream,
                        )
            rss = _peak_rss_bytes()
            if rss is not None:
                self.events.gauge("startup/peak_rss", value=rss)
        except BaseException as e:  # re-raised by result()
            self._transfer_error = e

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "StartupPipeline":
        if self._started:
            raise RuntimeError("pipeline already started")
        self._started = True
        if self.device.type == "cuda":
            # the consumer: the stream current in the thread that starts us
            self._stream = torch.cuda.current_stream(self.device)
        if self.compile_fn is not None:
            if self.shapes is None:
                with self.events.span("startup/probe"):
                    self.shapes = probe_split_shapes(self.data_dir)
            self._compile_thread = threading.Thread(
                target=self._run_compile, daemon=True, name="startup-compile"
            )
            self._compile_thread.start()
        # train submitted first so its decode (and therefore its transfer,
        # the one the first phase waits on) leads the queue
        self._decode_pool = concurrent.futures.ThreadPoolExecutor(
            3, thread_name_prefix="panel-decode"
        )
        for split in SPLITS:
            self._decode_futures[split] = self._decode_pool.submit(
                self._decode_one, split
            )
        self._transfer_thread = threading.Thread(
            target=self._run_transfers, daemon=True, name="startup-transfer"
        )
        self._transfer_thread.start()
        return self

    def result(self) -> PipelineResult:
        """Block until every stage completes; re-raise the first failure."""
        if not self._started:
            self.start()
        self._transfer_thread.join()
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=True)
        if self._compile_thread is not None:
            self._compile_thread.join()
        if self._transfer_error is not None:
            raise self._transfer_error
        if self._compile_error is not None:
            raise self._compile_error
        return PipelineResult(
            datasets=tuple(self._datasets[s] for s in SPLITS),
            batches=tuple(self._batches[s] for s in SPLITS),
            compiled=self._compiled,
            cache_hits=dict(self._cache_hits),
        )


# --------------------------------------------------------------------------
# stage 3 helper: build and plan the kernels of the model's route early
# --------------------------------------------------------------------------

def trainer_precompile_fn(cfg, exec_cfg=None, events=None, members: int = 1,
                          name_prefix: str = "") -> Callable[[Dict], Any]:
    """A `compile_fn` for :class:`StartupPipeline`: the port's counterpart
    of compiling the trainer's programs under the load window. Eager
    PyTorch has no programs to compile; what a first epoch would otherwise
    wait on is building (``nvcc``, at first use) and loading the CUDA
    libraries the model's route launches, and working out their launch
    plans on the card. This does both, for the probed shapes of every split
    given (``train`` among them) and `members` stacked models (one: the
    train CLI's; a sweep bucket's grid: ``parallel.sweep``), and returns
    what it prepared (each program named ``<name_prefix><kernel>/<split>``)::

        {"device": "cuda:0", "libraries": [...], "plans": n,
         "programs": {name: record}}

    Each plan is recorded with what the card holds of it (resident blocks
    per SM, registers, local bytes) through
    ``observability.programs.record_program``: a ``program`` row in
    `events` and a ``programs`` entry, which the train CLI folds into
    ``manifest.json`` as ``kernel_programs``. On the plain route (a CPU
    device, ``kernel="off"``) nothing is built: the libraries list and the
    programs are empty.
    """
    from ..observability.programs import record_program
    from ..utils.config import ExecutionConfig

    exec_cfg = exec_cfg or ExecutionConfig()

    def compile_fn(shapes: Dict[str, Dict[str, tuple]]):
        from ..ops import cond_em, sdf_ffn

        dev = resolve_device(exec_cfg.device)
        out = {"device": str(dev), "libraries": [], "plans": 0,
               "programs": {}}
        if dev.type != "cuda" or exec_cfg.kernel == "off":
            return out
        cd = exec_cfg.compute_dtype
        F = cfg.individual_feature_dim

        S = int(members)
        splits = [split for split in SPLITS if split in shapes]

        def record(name, plan, held, T, N):
            record_program(events, name_prefix + name, plan, held,
                           out["programs"], S=S, T=T, N=N, compute_dtype=cd)
            out["plans"] += 1

        with torch.cuda.device(dev):
            if cfg.hidden_dim:
                lay = sdf_ffn.ffn_layout(F, cfg.hidden_dim)
                w = sdf_ffn.width_bound(cfg.hidden_dim)
                for split in splits:
                    t, n = shapes[split]["returns"]
                    plan = sdf_ffn.card_fwd_plan(lay, dev, S, t, n, cd)
                    record(f"sdf_ffn_fwd/{split}", plan,
                           sdf_ffn.fwd_plan_info(lay, S, plan), t, n)
                t, n = shapes["train"]["returns"]
                plan = sdf_ffn.card_bwd_plan(lay, dev, S, t, n)
                record("sdf_ffn_bwd/train", plan,
                       sdf_ffn.bwd_plan_info(lay, plan), t, n)
                out["libraries"] += [f"sdf_ffn_fwd_w{w}", f"sdf_ffn_bwd_w{w}"]
            if not cfg.hidden_dim_moment and "macro" in shapes["train"]:
                K = cfg.num_condition_moment
                for split in splits:
                    t, n = shapes[split]["returns"]
                    plans = cond_em.card_cem_plan(dev, S, t, n, F, K, cd)
                    kinds = (("fwd", "bwd") if split == "train"
                             else ("fwd",))
                    for kind in kinds:
                        plan = getattr(plans, kind)
                        record(f"cond_em_{kind}/{split}", plan,
                               cond_em.plan_info(plan, S, t, n, F, K, cd),
                               t, n)
                out["libraries"].append("cond_em")
        return out

    return compile_fn
