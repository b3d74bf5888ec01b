"""Durable sweep ledger: one verified record per completed bucket.

The port's copy of the JAX package's ``reliability/ledger.py``. The
384-config search's unit of work is the architecture bucket (96
of them); the ledger makes it the unit of recovery too: every completed
bucket lands as one atomic, sha256-sidecar JSON record, written through
:mod:`.verified` so a kill mid-write cannot corrupt it, keyed by the
content that determines the bucket's result (architecture config + lr grid
+ seeds + TrainConfig). A restarted sweep consults the ledger and retrains
nothing it already holds. The keys are the JAX package's, byte for byte,
for the same config, grid, seeds and schedule; the key leaves out how the
bucket ran (compute dtype, kernel route), so each record also holds that
``execution``, and the sweep reuses a record only under the same one.
Records, quarantine markers and the queue manifest are otherwise the JAX
package's, so a ledger written by either package opens in the other.

Layout under ``<run_dir>/sweep_ledger/``::

    queue.json             — the work manifest (bucket list + shared
                             schedule), written once by the coordinating
                             process; workers derive ALL work from it
    records/<key>.json     — one verified record per completed bucket
    quarantine/<key>.json  — poison buckets (killed K consecutive workers)
    leases/<key>.json      — live worker leases (see scheduler.py)
    attempts/<key>.json    — per-bucket claim/failure history

Records hold no params (they are JSON): a sweep that consults the ledger
runs with ``keep_params=False`` — the protocol path, which retrains the
winners anyway.

Module level stays stdlib-only, like ``faults.py`` and ``verified.py``.
"""

from __future__ import annotations

import hashlib
import json
import math
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from .faults import inject
from .verified import (
    clear_generations,
    load_verified,
    verified_exists,
    write_verified,
)

LEDGER_DIRNAME = "sweep_ledger"
QUEUE_FILENAME = "queue.json"


def bucket_key(
    config: Dict[str, Any],
    lrs: List[float],
    seeds: List[int],
    tcfg: Dict[str, Any],
) -> str:
    """Content key of one bucket's work: sha256 over the canonical JSON of
    everything that determines its result — the architecture config dict,
    the lr grid (ORDER KEPT: it fixes the member layout of the grid), the
    seeds, and the training schedule. Two runs computing the same key would
    train the same bucket, so a record under this key is safe to reuse."""
    blob = json.dumps(
        {
            "config": config,
            "lrs": [float(lr) for lr in lrs],
            "seeds": [int(s) for s in seeds],
            "tcfg": tcfg,
        },
        sort_keys=True,
        default=str,
    ).encode()
    return hashlib.sha256(blob).hexdigest()


def _finite_or_none(x) -> Optional[float]:
    """JSON-safe scalar (non-finite → null, as ``sweep._finite``)."""
    x = float(x)
    return x if math.isfinite(x) else None


def make_record(
    key: str,
    index: int,
    config: Dict[str, Any],
    lrs: List[float],
    seeds: List[int],
    grid,
    best_valid_sharpe,
    *,
    execution: Dict[str, str],
    worker: Optional[str] = None,
    seconds: Optional[float] = None,
) -> Dict[str, Any]:
    """Assemble one bucket's ledger record from a ``train_bucket`` output.

    ``grid`` is the [(lr, seed)] array, ``best_valid_sharpe`` the matching
    Sharpe vector; floats round-trip JSON exactly (repr round-trip), so a
    ranking rebuilt from records is bit-identical to the in-process one.
    Non-finite Sharpes (never-updated trackers) map to null and back to
    -inf on read, the same convention as ``sweep_ranking.json``.
    ``execution`` is how the bucket ran (``parallel.sweep.execution_of``),
    ``worker`` the elastic worker that trained it (None in process). The
    record is the JAX package's with ``execution`` added."""
    return {
        "key": key,
        "index": int(index),
        "config": config,
        "lrs": [float(lr) for lr in lrs],
        "seeds": [int(s) for s in seeds],
        "grid": [[float(lr), float(s)] for lr, s in grid],
        "best_valid_sharpe": [_finite_or_none(s) for s in best_valid_sharpe],
        "worker": worker,
        "execution": dict(execution),
        "seconds": round(float(seconds), 3) if seconds is not None else None,
        "completed_at": round(time.time(), 3),
    }


class SweepLedger:
    """Verified per-bucket records + quarantine markers for one sweep.

    All writes go through :func:`.verified.write_verified` (atomic + sha256
    sidecar), all reads through :func:`.verified.load_verified`
    (digest-checked, errors naming the file). Instance counters (``hits``:
    records loaded, ``writes``: records written) carry the zero-retrain
    evidence."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        self.records_dir = self.root / "records"
        self.quarantine_dir = self.root / "quarantine"
        self.hits = 0
        self.writes = 0

    # -- records --------------------------------------------------------------

    def record_path(self, key: str) -> Path:
        return self.records_dir / f"{key}.json"

    def has(self, key: str) -> bool:
        return verified_exists(self.record_path(key))

    def load(self, key: str) -> Dict[str, Any]:
        """Digest-verified record read; counts as a ledger hit."""
        path = self.record_path(key)

        def parse(data: bytes) -> Dict[str, Any]:
            try:
                return json.loads(data.decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(
                    f"corrupt sweep-ledger record {path}: {e}") from e

        record, _ = load_verified(path, parse)
        self.hits += 1
        return record

    def write(self, key: str, record: Dict[str, Any]) -> None:
        """Verified write of one completed bucket's record. The fault site
        fires BEFORE any byte lands: a kill here loses the record (the
        bucket retrains after a restart) but never corrupts the ledger."""
        path = self.record_path(key)
        inject("sweep/ledger_write", path=str(path), bucket=key)
        write_verified(path, json.dumps(record, indent=2).encode())
        self.writes += 1

    def keys(self) -> List[str]:
        # "*.json" cannot match sidecars (.json.sha256), generations
        # (.json.g1), or in-flight tmp files (.json.tmp)
        if not self.records_dir.exists():
            return []
        return sorted(p.stem for p in self.records_dir.glob("*.json"))

    # -- quarantine -----------------------------------------------------------

    def quarantine_path(self, key: str) -> Path:
        return self.quarantine_dir / f"{key}.json"

    def quarantine(self, key: str, info: Dict[str, Any]) -> None:
        info = dict(info, key=key, quarantined_at=round(time.time(), 3))
        write_verified(self.quarantine_path(key),
                       json.dumps(info, indent=2).encode())

    def is_quarantined(self, key: str) -> bool:
        return verified_exists(self.quarantine_path(key))

    def quarantined(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        if not self.quarantine_dir.exists():
            return out
        for p in sorted(self.quarantine_dir.glob("*.json")):
            try:
                out[p.stem] = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                out[p.stem] = {"key": p.stem, "error": "unreadable marker"}
        return out

    # -- lifecycle ------------------------------------------------------------

    def reset(self) -> None:
        """Drop every record, quarantine marker, lease, and attempt file:
        a sweep that does not resume must not reuse a predecessor's work."""
        for sub in ("records", "quarantine", "leases", "attempts"):
            shutil.rmtree(self.root / sub, ignore_errors=True)
        clear_generations(self.root / QUEUE_FILENAME)
