"""Decoded-panel disk cache: skip npz decompress + mask build on re-runs.

The port's copy of the JAX package's ``data/diskcache.py`` (numpy and the
stdlib only): the same ``CACHE_VERSION``, key derivation and on-disk
layout, so an entry either package writes loads in the other, bit for bit.

The paper workload loads the SAME ~1.2 GB npz panel on every run, then pays
the same decompress, mask build (`panel._build_mask`), zero-fill, and
host-side `flatnonzero`/gather repack (`transfer.pack_rows`) before a single
byte ships to the device. All of that is a pure function of the source file
bytes, so after the first decode this module persists the results as raw
``.npy`` files that later runs ``np.load(mmap_mode="r")`` straight into the
transfer path — no decompress, no mask build, no repack.

Layout: one directory per cache entry under :func:`cache_root`::

    <root>/<key>/meta.json       entry descriptor (version, fingerprints,
                                 shapes, coverage)
    <root>/<key>/returns.npy     [T, N]    float32, zero-filled
    <root>/<key>/individual.npy  [T, N, F] float32, zero-filled
    <root>/<key>/mask.npy        [T, N]    bool
    <root>/<key>/macro.npy       [T, M]    float32 RAW (un-normalized —
                                 normalization depends on the TRAIN split's
                                 stats, so it is applied at load time and the
                                 entry stays keyed by its OWN source files)
    <root>/<key>/dates.npy, variable_names.npy
    <root>/<key>/idx.npy         [V]    int32   ─┐ the packed valid-rows rep
    <root>/<key>/rows.npy        [V, F] float32  ├ transfer.py ships (stored
    <root>/<key>/ret_packed.npy  [V]    float32 ─┘ only when coverage packs)

``<key>`` digests (CACHE_VERSION, char fingerprint, macro fingerprint); a
fingerprint is (resolved path, size, mtime_ns, sha256 of the npz member
directory — names, sizes, CRCs — read from the zip central directory without
touching payload bytes). Any source change (mtime, size, header) therefore
MISSES to a fresh key; :func:`store` evicts superseded entries for the same
source path so the root does not accumulate stale gigabytes.

Stores are atomic (write into a tmp dir, ``os.rename`` into place) and loads
are paranoid: a missing file, a shape mismatch against meta.json, or any
parse error deletes the entry and returns None — the caller falls back to
the npz decode path, never crashes on a corrupt cache.

**Chunked entries** (the sharded data plane): alongside the monolithic
layout above, :func:`store_chunked` persists a split with the STOCK axis cut
into fixed-width shards, so a mesh slot can load (and digest-verify) only
the shards it owns instead of materializing the whole panel::

    <root>/<key>/meta.json            chunk manifest (shard width, bounds,
                                      per-file sha256 — written LAST, via
                                      reliability.verified, so its presence
                                      marks a complete entry)
    <root>/<key>/shards/s00000.returns.npy     [T, W]    float32
    <root>/<key>/shards/s00000.individual.npy  [T, W, F] float32
    <root>/<key>/shards/s00000.mask.npy        [T, W]    bool
    <root>/<key>/shards/s00001.*               ... (last shard may be ragged)
    <root>/<key>/{macro,dates,variable_names}.npy   global (un-sharded)

Every file is written through :mod:`..reliability.verified` (atomic tmp +
``os.replace``, sha256 sidecar), and the manifest records each file's digest
independently, binding the shard SET together: a torn or truncated shard
fails :meth:`ChunkedEntry.verify_shard` and the loader re-decodes (and
re-stores) JUST that shard from the source npz — never the whole entry.
The chunked key digests the shard width too, so changing
``DLAP_PANEL_SHARD_WIDTH`` misses to a fresh entry instead of mis-slicing
an old one.

Location: ``$DLAP_PANEL_CACHE_DIR``, else ``$XDG_CACHE_HOME/dlap/panel_cache``,
else ``~/.cache/dlap/panel_cache``. ``DLAP_PANEL_CACHE=0`` disables entirely.
Clear with ``python -m ...data.diskcache --clear`` (or just delete the dir).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import shutil
import tempfile
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..reliability.verified import compute_digest, load_verified, write_verified

CACHE_VERSION = 1

# entry arrays: filename -> (meta shape key, required). macro/variable_names
# and the packed triple are optional (absent macro / high-coverage panels).
_REQUIRED = ("returns", "individual", "mask", "dates")
_OPTIONAL = ("macro", "variable_names", "idx", "rows", "ret_packed")

# chunked-entry layout: the stock-axis-sharded arrays vs the global ones
SHARD_ARRAYS = ("returns", "individual", "mask")
GLOBAL_ARRAYS = ("dates", "macro", "variable_names")
SHARD_DIRNAME = "shards"
ENV_SHARD_WIDTH = "DLAP_PANEL_SHARD_WIDTH"
DEFAULT_SHARD_WIDTH = 2048


def cache_enabled() -> bool:
    return os.environ.get("DLAP_PANEL_CACHE", "1") not in ("0", "false", "off")


def cache_root() -> Path:
    override = os.environ.get("DLAP_PANEL_CACHE_DIR")
    if override:
        return Path(override)
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = Path(xdg) if xdg else Path.home() / ".cache"
    return base / "dlap" / "panel_cache"


def npz_fingerprint(path: Union[str, Path]) -> Dict[str, Any]:
    """Cheap content identity for one .npz: stat fields + a digest of the
    zip central directory (member names, sizes, CRC-32s) — real content
    evidence without reading any payload bytes."""
    path = Path(path)
    st = path.stat()
    h = hashlib.sha256()
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            h.update(f"{info.filename}:{info.file_size}:{info.CRC};".encode())
    return {
        "path": str(path.resolve()),
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "header_sha": h.hexdigest(),
    }


def entry_key(
    char_path: Union[str, Path],
    macro_path: Optional[Union[str, Path]] = None,
) -> Tuple[str, Dict[str, Any]]:
    """(cache key, the fingerprints that produced it). Any change to either
    source file — or the cache format version — changes the key."""
    fps = {
        "version": CACHE_VERSION,
        "char": npz_fingerprint(char_path),
        "macro": npz_fingerprint(macro_path) if macro_path is not None else None,
    }
    digest = hashlib.sha256(
        json.dumps(fps, sort_keys=True).encode()
    ).hexdigest()[:20]
    return digest, fps


@dataclasses.dataclass
class CacheEntry:
    """One split's decoded arrays, memmapped read-only from the cache.

    ``macro`` is RAW (un-normalized); ``idx``/``rows``/``ret_packed`` are the
    packed valid-rows representation (None when the entry's coverage was
    above the packing threshold at store time)."""

    returns: np.ndarray
    individual: np.ndarray
    mask: np.ndarray
    dates: np.ndarray
    macro: Optional[np.ndarray]
    variable_names: Optional[np.ndarray]
    idx: Optional[np.ndarray]
    rows: Optional[np.ndarray]
    ret_packed: Optional[np.ndarray]
    meta: Dict[str, Any]


def _entry_dir(key: str) -> Path:
    return cache_root() / key


def load(
    char_path: Union[str, Path],
    macro_path: Optional[Union[str, Path]] = None,
) -> Optional[CacheEntry]:
    """Memmap a cache hit for (char_path, macro_path), or None on miss.

    Corruption of any flavor — unreadable meta, missing array file, shape
    drift against meta — deletes the entry and reports a miss so the caller
    re-decodes from the npz."""
    if not cache_enabled():
        return None
    try:
        key, _ = entry_key(char_path, macro_path)
    except (OSError, zipfile.BadZipFile):
        return None  # unreadable SOURCE: let the npz path raise its own error
    d = _entry_dir(key)
    meta_path = d / "meta.json"
    if not meta_path.exists():
        return None
    try:
        meta = json.loads(meta_path.read_text())
        if meta.get("version") != CACHE_VERSION:
            raise ValueError(f"cache version {meta.get('version')}")
        arrays: Dict[str, Optional[np.ndarray]] = {}
        for name in _REQUIRED + _OPTIONAL:
            f = d / f"{name}.npy"
            if not f.exists():
                if name in _REQUIRED or name in meta["shapes"]:
                    raise FileNotFoundError(f.name)
                arrays[name] = None
                continue
            a = np.load(f, mmap_mode="r")
            expect = meta["shapes"].get(name)
            if expect is None or tuple(a.shape) != tuple(expect):
                raise ValueError(
                    f"{name}.npy shape {a.shape} != meta {expect}"
                )
            arrays[name] = a
        return CacheEntry(meta=meta, **arrays)  # type: ignore[arg-type]
    except Exception:
        shutil.rmtree(d, ignore_errors=True)
        return None


def store(
    char_path: Union[str, Path],
    macro_path: Optional[Union[str, Path]],
    arrays: Dict[str, Optional[np.ndarray]],
    extra_meta: Optional[Dict[str, Any]] = None,
) -> Optional[Path]:
    """Persist one split's decoded arrays; returns the entry dir (None when
    caching is disabled or the write fails — a cache must never take down a
    load that already succeeded).

    `arrays` uses the :class:`CacheEntry` field names; missing/None optional
    entries are simply not written. The write is atomic (tmp dir + rename)
    and evicts any older entry recorded for the same source char path."""
    if not cache_enabled():
        return None
    try:
        key, fps = entry_key(char_path, macro_path)
        root = cache_root()
        root.mkdir(parents=True, exist_ok=True)
        final = root / key
        if (final / "meta.json").exists():
            return final  # concurrent writer beat us; entry is complete
        shapes = {}
        tmp = Path(tempfile.mkdtemp(dir=root, prefix=f".{key}."))
        try:
            for name in _REQUIRED + _OPTIONAL:
                a = arrays.get(name)
                if a is None:
                    continue
                a = np.asarray(a)
                np.save(tmp / f"{name}.npy", a, allow_pickle=False)
                shapes[name] = list(a.shape)
            meta = {
                "version": CACHE_VERSION,
                "fingerprints": fps,
                "shapes": shapes,
                **(extra_meta or {}),
            }
            # meta.json is written LAST: its presence marks a complete entry
            (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
            _evict_stale(root, fps["char"], keep=key)
            os.rename(tmp, final)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return final
    except Exception:
        return None


def _evict_stale(root: Path, char_fp: Dict[str, Any], keep: str) -> None:
    """Remove superseded entries recorded for the same source file (a
    re-generated npz would otherwise leave its old decode behind forever).

    `char_fp` is the CURRENT char fingerprint dict: an entry for the same
    path whose recorded fingerprint still matches is a live sibling (e.g. a
    chunked entry next to a monolithic one, or another shard width) and is
    kept; only entries whose recorded source fingerprint DIFFERS — a stale
    decode of a superseded file — are evicted."""
    for d in root.iterdir():
        if not d.is_dir() or d.name == keep or d.name.startswith("."):
            continue
        try:
            meta = json.loads((d / "meta.json").read_text())
            recorded = meta["fingerprints"]["char"]
            if recorded["path"] == char_fp["path"] and recorded != char_fp:
                shutil.rmtree(d, ignore_errors=True)
        except Exception:
            continue  # unreadable sibling: not ours to judge


# --------------------------------------------------------------------------
# chunked entries: the stock axis cut into fixed-width, verified shards
# --------------------------------------------------------------------------

def shard_width(override: Optional[int] = None) -> int:
    """The stock-shard width: explicit override > $DLAP_PANEL_SHARD_WIDTH >
    DEFAULT_SHARD_WIDTH. Part of the chunked cache key — changing it can
    never mis-slice an existing entry, it just misses to a fresh one."""
    if override is not None:
        return int(override)
    env = os.environ.get(ENV_SHARD_WIDTH, "").strip()
    return int(env) if env else DEFAULT_SHARD_WIDTH


def shard_bounds(n: int, width: int) -> List[Tuple[int, int]]:
    """Fixed-width [start, stop) column spans covering the stock axis; the
    last shard is ragged when `width` does not divide N."""
    width = max(1, int(width))
    return [(a, min(a + width, n)) for a in range(0, max(n, 1), width)]


def chunked_entry_key(
    char_path: Union[str, Path],
    macro_path: Optional[Union[str, Path]] = None,
    width: Optional[int] = None,
) -> Tuple[str, Dict[str, Any]]:
    """Like :func:`entry_key` but for the chunked layout: the digest also
    covers the shard width, so monolithic / differently-sharded entries for
    the same source never collide."""
    fps = {
        "version": CACHE_VERSION,
        "kind": "chunked",
        "shard_width": shard_width(width),
        "char": npz_fingerprint(char_path),
        "macro": npz_fingerprint(macro_path) if macro_path is not None else None,
    }
    digest = hashlib.sha256(
        json.dumps(fps, sort_keys=True).encode()
    ).hexdigest()[:20]
    return digest, fps


def _npy_bytes(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return buf.getvalue()


_SINGLE_SHOT_DIGEST_BYTES = 1 << 28  # 256 MiB


def _file_sha256(path: Path, blocksize: int = 1 << 25) -> str:
    """File digest. Normal shards (≲20 MB at the default width) hash in
    ONE read + one hashlib call — the block-looped path runs at roughly
    half the hash throughput (Python-loop overhead on the read side) and
    the verify pass is on the shard-local load's critical path. Only
    oversized files fall back to streaming so the heap never holds more
    than `blocksize` of a pathological multi-GB shard."""
    try:
        if path.stat().st_size <= _SINGLE_SHOT_DIGEST_BYTES:
            return hashlib.sha256(path.read_bytes()).hexdigest()
    except OSError:
        pass  # stat raced a writer: the streamed path reports it
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(blocksize)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


@dataclasses.dataclass
class ChunkedEntry:
    """A chunked cache entry: the manifest plus lazy per-shard access.

    Shards are loaded individually (memmapped) after a per-file fingerprint
    check against the manifest, so a consumer touches ONLY the stock spans
    it owns — corruption anywhere else is invisible to it."""

    dir: Path
    meta: Dict[str, Any]

    @property
    def width(self) -> int:
        return int(self.meta["shard_width"])

    @property
    def n_shards(self) -> int:
        return int(self.meta["n_shards"])

    @property
    def n_stocks(self) -> int:
        return int(self.meta["shapes"]["returns"][1])

    def bounds(self) -> List[Tuple[int, int]]:
        return [tuple(s["cols"]) for s in self.meta["shards"]]

    def shards_for(
        self, columns: Optional[Tuple[int, int]] = None
    ) -> List[int]:
        """Indices of the shards intersecting [a, b) (all when None)."""
        if columns is None:
            return list(range(self.n_shards))
        a, b = columns
        return [i for i, (lo, hi) in enumerate(self.bounds())
                if hi > a and lo < b]

    def shard_path(self, i: int, name: str) -> Path:
        return self.dir / SHARD_DIRNAME / f"s{i:05d}.{name}.npy"

    def verify_shard(self, i: int) -> Tuple[bool, str]:
        """Check every file of shard `i` against the manifest's recorded
        size and sha256 (streamed). (ok, reason)."""
        rec = self.meta["shards"][i]["files"]
        for name in SHARD_ARRAYS:
            p = self.shard_path(i, name)
            want = rec[name]
            try:
                size = p.stat().st_size
            except OSError:
                return False, f"{p.name}: missing"
            if size != int(want["bytes"]):
                return False, (f"{p.name}: {size} bytes on disk, "
                               f"{want['bytes']} recorded")
            got = _file_sha256(p)
            if got != want["sha256"]:
                return False, (f"{p.name}: sha256 {got[:12]}… != recorded "
                               f"{want['sha256'][:12]}…")
        return True, "ok"

    def load_shard(self, i: int) -> Dict[str, np.ndarray]:
        """Memmap one verified shard's arrays (verify first — this does not
        re-check)."""
        return {
            name: np.load(self.shard_path(i, name), mmap_mode="r")
            for name in SHARD_ARRAYS
        }

    def load_global(self, name: str) -> Optional[np.ndarray]:
        rec = (self.meta.get("globals") or {}).get(name)
        if rec is None:
            return None
        p = self.dir / f"{name}.npy"
        data = p.read_bytes()
        if compute_digest(data) != rec["sha256"]:
            raise ValueError(f"{p.name}: sha256 mismatch vs manifest")
        return np.load(io.BytesIO(data), allow_pickle=False)

    def restore_shard(self, i: int, arrays: Dict[str, np.ndarray]) -> bool:
        """Re-store one shard from freshly re-decoded arrays. The manifest
        is the identity: the rewritten bytes must reproduce the recorded
        digests exactly (same source npz → same decode → same .npy bytes);
        a mismatch means the entry no longer matches its source and the
        caller should invalidate it. Returns True on a verified repair."""
        a, b = self.meta["shards"][i]["cols"]
        rec = self.meta["shards"][i]["files"]
        for name in SHARD_ARRAYS:
            arr = arrays[name]
            data = _npy_bytes(arr[:, a:b])
            if compute_digest(data) != rec[name]["sha256"]:
                return False
            write_verified(self.shard_path(i, name), data)
        return True


def store_chunked(
    char_path: Union[str, Path],
    macro_path: Optional[Union[str, Path]],
    arrays: Dict[str, Optional[np.ndarray]],
    width: Optional[int] = None,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> Optional[Path]:
    """Persist one split's decoded arrays as a chunked entry (see module
    docstring layout). `arrays` uses the same names as :func:`store`:
    returns/individual/mask are sharded along the stock axis, dates/macro/
    variable_names stay global. Atomic at entry level (tmp dir + rename,
    manifest written last) AND per file (``reliability.verified``); returns
    the entry dir, or None when caching is disabled or the write fails."""
    if not cache_enabled():
        return None
    try:
        w = shard_width(width)
        key, fps = chunked_entry_key(char_path, macro_path, w)
        root = cache_root()
        root.mkdir(parents=True, exist_ok=True)
        final = root / key
        if (final / "meta.json").exists():
            return final  # concurrent writer beat us; entry is complete
        returns = np.asarray(arrays["returns"])
        n = returns.shape[1]
        bounds = shard_bounds(n, w)
        tmp = Path(tempfile.mkdtemp(dir=root, prefix=f".{key}."))
        try:
            (tmp / SHARD_DIRNAME).mkdir()
            shards_meta = []
            for i, (a, b) in enumerate(bounds):
                files = {}
                for name in SHARD_ARRAYS:
                    arr = np.asarray(arrays[name])
                    data = _npy_bytes(arr[:, a:b])
                    sha = write_verified(
                        tmp / SHARD_DIRNAME / f"s{i:05d}.{name}.npy", data
                    )
                    files[name] = {"sha256": sha, "bytes": len(data)}
                shards_meta.append({"cols": [a, b], "files": files})
            globals_meta = {}
            shapes = {
                name: list(np.asarray(arrays[name]).shape)
                for name in SHARD_ARRAYS
            }
            for name in GLOBAL_ARRAYS:
                a = arrays.get(name)
                if a is None:
                    continue
                data = _npy_bytes(np.asarray(a))
                sha = write_verified(tmp / f"{name}.npy", data)
                globals_meta[name] = {"sha256": sha, "bytes": len(data)}
                shapes[name] = list(np.asarray(a).shape)
            meta = {
                "version": CACHE_VERSION,
                "kind": "chunked",
                "shard_width": w,
                "n_shards": len(bounds),
                "fingerprints": fps,
                "shapes": shapes,
                "shards": shards_meta,
                "globals": globals_meta,
                **(extra_meta or {}),
            }
            # manifest LAST: its presence marks a complete entry
            write_verified(
                tmp / "meta.json",
                json.dumps(meta, indent=1).encode(),
            )
            _evict_stale(root, fps["char"], keep=key)
            os.rename(tmp, final)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return final
    except Exception:
        return None


def load_chunked(
    char_path: Union[str, Path],
    macro_path: Optional[Union[str, Path]] = None,
    width: Optional[int] = None,
) -> Optional[ChunkedEntry]:
    """Open a chunked entry for (char, macro) at this shard width, or None
    on miss. Only the MANIFEST is read and verified here; shards verify
    individually via :meth:`ChunkedEntry.verify_shard` when loaded, so a
    corrupt shard a consumer never touches costs nothing. An unreadable or
    corrupt manifest deletes the entry and reports a miss."""
    if not cache_enabled():
        return None
    try:
        key, _ = chunked_entry_key(char_path, macro_path, width)
    except (OSError, zipfile.BadZipFile):
        return None  # unreadable SOURCE: let the npz path raise its own error
    d = _entry_dir(key)
    if not (d / "meta.json").exists():
        return None
    try:
        meta, _ = load_verified(
            d / "meta.json",
            parse=lambda data: json.loads(data.decode()),
            warn=False,
        )
        if meta.get("version") != CACHE_VERSION or meta.get("kind") != "chunked":
            raise ValueError(f"not a chunked v{CACHE_VERSION} entry")
        if len(meta["shards"]) != int(meta["n_shards"]):
            raise ValueError("manifest shard count mismatch")
        return ChunkedEntry(dir=d, meta=meta)
    except Exception:
        shutil.rmtree(d, ignore_errors=True)
        return None


def clear() -> int:
    """Delete every cache entry; returns the number removed."""
    root = cache_root()
    if not root.is_dir():
        return 0
    n = 0
    for d in root.iterdir():
        if d.is_dir():
            shutil.rmtree(d, ignore_errors=True)
            n += 1
    return n


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m deeplearninginassetpricing_paperreplication_torch."
             "data.diskcache",
        description="Inspect or clear the decoded-panel disk cache",
    )
    p.add_argument("--clear", action="store_true", help="delete all entries")
    args = p.parse_args(argv)
    root = cache_root()
    if args.clear:
        print(f"removed {clear()} entries from {root}")
        return 0
    entries = sorted(d for d in root.iterdir() if d.is_dir()) if root.is_dir() else []
    total = 0
    for d in entries:
        size = sum(f.stat().st_size for f in d.iterdir() if f.is_file())
        total += size
        src = "?"
        try:
            meta = json.loads((d / "meta.json").read_text())
            src = meta["fingerprints"]["char"]["path"]
        except Exception:
            pass
        print(f"  {d.name}  {size / (1 << 20):8.1f} MiB  {src}")
    print(f"{len(entries)} entries, {total / (1 << 20):.1f} MiB in {root}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
