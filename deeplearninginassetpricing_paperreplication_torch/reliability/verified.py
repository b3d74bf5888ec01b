"""Atomic, digest-verified, generational file IO.

The port's copy of the JAX package's ``reliability/verified.py`` (stdlib
only). The contract the port's sweep artifacts (``sweep_ranking.json``,
``report.json``, the bucket ledger's records) and the ensemble CLI's
``ensemble_report.json`` follow:

  * **atomic** — bytes land in ``<name>.tmp`` and ``os.replace`` onto the
    target, so a kill mid-save leaves the previous file intact, never a
    truncated one;
  * **verified** — a sidecar ``<name>.sha256`` (JSON: ``{"sha256", "bytes"}``)
    is written after the data; loads recompute the digest and reject a file
    whose bytes don't match (bit rot, torn copies, an injected
    ``truncate_file`` fault);
  * **generational** — before each write the previous file rotates to
    ``<name>.g1`` (and ``.g1`` → ``.g2``, …, up to ``generations``); loads
    fall back generation-by-generation to the last good checkpoint, so a
    corrupted newest write can never strand a run.

Files without a sidecar still load: the digest check is skipped and the
caller's parse step is the validator — corruption then surfaces as a clear
``ValueError`` naming the offending file.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple, Union

from .faults import inject

DIGEST_SUFFIX = ".sha256"
DEFAULT_GENERATIONS = 2  # the current file plus one good predecessor
_MAX_SCAN = 10  # how many generations a load will ever look back through


def digest_path(path: Union[str, Path]) -> Path:
    path = Path(path)
    return path.with_name(path.name + DIGEST_SUFFIX)


def generation_path(path: Union[str, Path], gen: int) -> Path:
    path = Path(path)
    return path if gen == 0 else path.with_name(f"{path.name}.g{gen}")


def generation_candidates(path: Union[str, Path],
                          max_generations: int = _MAX_SCAN) -> List[Path]:
    """Newest-first candidate list: the file itself, then ``.g1``, …"""
    return [generation_path(path, g) for g in range(max_generations)]


def verified_exists(path: Union[str, Path]) -> bool:
    """Does ANY generation of `path` exist on disk?"""
    return any(p.exists() for p in generation_candidates(path))


def compute_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def check_digest(path: Path, data: bytes,
                 digest: Optional[str] = None) -> Tuple[bool, str]:
    """Verify `data` against `path`'s sidecar. (ok, reason); a missing or
    unreadable sidecar passes — the caller's parse is then the validator.
    ``digest``: `data`'s sha256 when the caller already computed it (skips
    re-hashing the same bytes)."""
    dp = digest_path(path)
    try:
        meta = json.loads(dp.read_text())
    except (OSError, ValueError):
        return True, "no digest sidecar (legacy or torn sidecar)"
    want = meta.get("sha256")
    if want is None:
        return True, "sidecar carries no sha256"
    got = digest or compute_digest(data)
    if got != want:
        return False, (
            f"sha256 mismatch (file {got[:12]}… != recorded {want[:12]}…, "
            f"{len(data)} bytes on disk, {meta.get('bytes')} recorded)"
        )
    return True, "ok"


def rotate_generations(path: Union[str, Path],
                       generations: int = DEFAULT_GENERATIONS) -> None:
    """Shift ``path`` → ``.g1`` → ``.g2`` … keeping at most `generations`
    files total (data and digest sidecars move together)."""
    path = Path(path)
    if generations <= 1 or not path.exists():
        return
    for g in range(generations - 2, -1, -1):
        src, dst = generation_path(path, g), generation_path(path, g + 1)
        if not src.exists():
            continue
        os.replace(src, dst)
        sdig, ddig = digest_path(src), digest_path(dst)
        if sdig.exists():
            os.replace(sdig, ddig)
        else:
            ddig.unlink(missing_ok=True)


def write_verified(path: Union[str, Path], data: bytes,
                   generations: int = DEFAULT_GENERATIONS) -> str:
    """Rotate, atomically write `data`, then its digest sidecar. Returns the
    hex digest (callers embed it to bind paired files together)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    inject("checkpoint/save", path=str(path))
    rotate_generations(path, generations)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)
    sha = compute_digest(data)
    _write_sidecar(path, sha, len(data))
    inject("checkpoint/saved", path=str(path))
    return sha


def _write_sidecar(path: Path, sha: str, nbytes: int) -> None:
    dp = digest_path(path)
    tmp = dp.with_name(dp.name + ".tmp")
    tmp.write_text(json.dumps({"sha256": sha, "bytes": nbytes}))
    os.replace(tmp, dp)


def load_verified(
    path: Union[str, Path],
    parse: Callable[[bytes], Any],
    warn: bool = True,
) -> Tuple[Any, Path]:
    """Load the newest generation of `path` that both digest-verifies and
    parses; returns ``(parse(data), actual_path)``.

    Falls back generation-by-generation past corrupt files (warning each
    time); when every existing generation is unusable raises a ``ValueError``
    naming each offending file and why, and when nothing exists at all
    raises ``FileNotFoundError``.
    """
    path = Path(path)
    inject("checkpoint/load", path=str(path))
    errors: List[str] = []
    for p in generation_candidates(path):
        if not p.exists():
            continue
        data = p.read_bytes()
        ok, why = check_digest(p, data)
        if not ok:
            errors.append(f"{p}: {why}")
            continue
        try:
            value = parse(data)
        except Exception as e:  # noqa: BLE001 — every parse failure falls back
            errors.append(f"{p}: {e}")
            continue
        if p != path and warn:
            warnings.warn(
                f"checkpoint {path.name}: newest generation unusable "
                f"({'; '.join(errors)}); fell back to {p.name}",
                stacklevel=2,
            )
        return value, p
    if errors:
        raise ValueError(
            f"no usable generation of checkpoint {path}: " + "; ".join(errors)
        )
    raise FileNotFoundError(f"no generation of {path} exists")


def clear_generations(path: Union[str, Path]) -> None:
    """Remove every generation of `path` plus digest sidecars."""
    for p in generation_candidates(path):
        p.unlink(missing_ok=True)
        digest_path(p).unlink(missing_ok=True)
