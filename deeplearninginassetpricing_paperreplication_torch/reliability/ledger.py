"""Durable sweep ledger: one verified record per completed bucket.

The port's copy of the JAX package's ``reliability/ledger.py``, its record
part. The 384-config search's unit of work is the architecture bucket (96
of them); the ledger makes it the unit of recovery too: every completed
bucket lands as one atomic, sha256-sidecar JSON record, written through
:mod:`.verified` so a kill mid-write cannot corrupt it, keyed by the
content that determines the bucket's result (architecture config + lr grid
+ seeds + TrainConfig). A restarted sweep consults the ledger and retrains
nothing it already holds. The keys are the JAX package's, byte for byte,
for the same config, grid, seeds and schedule; the key leaves out how the
bucket ran (compute dtype, kernel route), so each record also holds that
``execution``, and the sweep reuses a record only under the same one.

Layout under ``<run_dir>/sweep_ledger/``::

    records/<key>.json     — one verified record per completed bucket

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
from .verified import load_verified, verified_exists, write_verified

LEDGER_DIRNAME = "sweep_ledger"


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
    seconds: Optional[float] = None,
) -> Dict[str, Any]:
    """Assemble one bucket's ledger record from a ``train_bucket`` output.

    ``grid`` is the [(lr, seed)] array, ``best_valid_sharpe`` the matching
    Sharpe vector; floats round-trip JSON exactly (repr round-trip), so a
    ranking rebuilt from records is bit-identical to the in-process one.
    Non-finite Sharpes (never-updated trackers) map to null and back to
    -inf on read, the same convention as ``sweep_ranking.json``.
    ``execution`` is how the bucket ran (``parallel.sweep.execution_of``).
    The record is the JAX package's with ``execution`` in place of its
    ``worker``."""
    return {
        "key": key,
        "index": int(index),
        "config": config,
        "lrs": [float(lr) for lr in lrs],
        "seeds": [int(s) for s in seeds],
        "grid": [[float(lr), float(s)] for lr, s in grid],
        "best_valid_sharpe": [_finite_or_none(s) for s in best_valid_sharpe],
        "execution": dict(execution),
        "seconds": round(float(seconds), 3) if seconds is not None else None,
        "completed_at": round(time.time(), 3),
    }


class SweepLedger:
    """Verified per-bucket records for one sweep.

    All writes go through :func:`.verified.write_verified` (atomic + sha256
    sidecar), all reads through :func:`.verified.load_verified`
    (digest-checked, errors naming the file). ``writes`` counts the
    records this instance wrote."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        self.records_dir = self.root / "records"
        self.writes = 0

    def record_path(self, key: str) -> Path:
        return self.records_dir / f"{key}.json"

    def has(self, key: str) -> bool:
        return verified_exists(self.record_path(key))

    def load(self, key: str) -> Dict[str, Any]:
        """Digest-verified record read."""
        path = self.record_path(key)

        def parse(data: bytes) -> Dict[str, Any]:
            try:
                return json.loads(data.decode())
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(
                    f"corrupt sweep-ledger record {path}: {e}") from e

        return load_verified(path, parse)[0]

    def write(self, key: str, record: Dict[str, Any]) -> None:
        """Verified write of one completed bucket's record. The fault site
        fires BEFORE any byte lands: a kill here loses the record (the
        bucket retrains after a restart) but never corrupts the ledger."""
        path = self.record_path(key)
        inject("sweep/ledger_write", path=str(path), bucket=key)
        write_verified(path, json.dumps(record, indent=2).encode())
        self.writes += 1

    def reset(self) -> None:
        """Drop every record: a sweep that does not resume must not reuse a
        predecessor's work."""
        shutil.rmtree(self.records_dir, ignore_errors=True)
