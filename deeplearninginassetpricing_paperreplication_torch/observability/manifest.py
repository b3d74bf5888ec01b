"""Run manifests: make any artifact directory self-describing.

``manifest.json`` is written once at CLI startup and answers, post-hoc,
every "what exactly produced this run dir?" question: config (and its
hash), seed, schedule, library versions, device topology, git sha, and a
content fingerprint of the input data. The port's copy of the JAX
package's ``observability/manifest.py``: the versions and the topology
are torch's and the CUDA devices'. Everything is best-effort — a
manifest must never be the reason a training run fails, so each probe
degrades to ``None`` rather than raising.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

from .events import EventLog, new_run_id

MANIFEST_SCHEMA_VERSION = 1
_FINGERPRINT_BYTES = 65536  # head+tail window hashed per data file


def _as_dict(obj) -> Optional[Dict[str, Any]]:
    if obj is None:
        return None
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    return dict(obj)


def config_hash(config) -> Optional[str]:
    """sha256 of the canonical (sorted-key) JSON of a config dict/dataclass
    — the stable identity two runs compare to know they trained the same
    model."""
    d = _as_dict(config)
    if d is None:
        return None
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def data_fingerprint(data_dir) -> Optional[Dict[str, Any]]:
    """Content fingerprint of a data directory: per-file (relative path,
    size, head/tail window) folded into one sha256. Windowed hashing keeps
    the real-shape panel (~GB of npz) cheap while still catching any
    regeneration, truncation, or swapped split."""
    data_dir = Path(data_dir)
    if not data_dir.exists():
        return None
    h = hashlib.sha256()
    n_files = 0
    total_bytes = 0
    for p in sorted(data_dir.rglob("*")):
        if not p.is_file():
            continue
        size = p.stat().st_size
        h.update(str(p.relative_to(data_dir)).encode())
        h.update(str(size).encode())
        try:
            with open(p, "rb") as f:
                h.update(f.read(_FINGERPRINT_BYTES))
                if size > 2 * _FINGERPRINT_BYTES:
                    f.seek(-_FINGERPRINT_BYTES, 2)
                    h.update(f.read(_FINGERPRINT_BYTES))
        except OSError:
            h.update(b"<unreadable>")
        n_files += 1
        total_bytes += size
    return {
        "root": str(data_dir),
        "n_files": n_files,
        "total_bytes": total_bytes,
        "digest": h.hexdigest(),
    }


def _git_sha() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=Path(__file__).resolve().parents[2],
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


def _versions() -> Dict[str, Optional[str]]:
    """python, numpy and torch versions, and the CUDA toolkit torch was
    built against (None without one)."""
    vers: Dict[str, Optional[str]] = {
        "python": sys.version.split()[0],
    }
    for mod in ("numpy", "torch"):
        try:
            vers[mod] = __import__(mod).__version__
        except Exception:
            vers[mod] = None
    try:
        import torch

        vers["cuda"] = torch.version.cuda
    except Exception:
        vers["cuda"] = None
    return vers


def device_topology() -> Dict[str, Any]:
    """The CUDA devices this process sees: count, and each one's name and
    compute capability (an empty list on a host without one)."""
    try:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return {
            "backend": "cuda" if n else "cpu",
            "device_count": n,
            "devices": [
                {
                    "id": i,
                    "name": torch.cuda.get_device_name(i),
                    "capability": list(torch.cuda.get_device_capability(i)),
                }
                for i in range(n)
            ],
        }
    except Exception as e:  # report tooling without a backend
        return {"error": repr(e)}


def build_manifest(
    kind: str,
    run_id: Optional[str] = None,
    config=None,
    tcfg=None,
    seed: Optional[int] = None,
    data_dir=None,
    argv=None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble the manifest dict (pure; no filesystem writes)."""
    manifest = {
        "schema": MANIFEST_SCHEMA_VERSION,
        "kind": kind,
        "run_id": run_id or new_run_id(),
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "argv": list(argv) if argv is not None else sys.argv[1:],
        "seed": seed,
        "config": _as_dict(config),
        "config_hash": config_hash(config),
        "train_config": _as_dict(tcfg),
        "versions": _versions(),
        "devices": device_topology(),
        "git_sha": _git_sha(),
        "data": data_fingerprint(data_dir) if data_dir is not None else None,
    }
    if extra:
        manifest.update(extra)
    return manifest


def write_manifest(run_dir, kind: str, events: Optional[EventLog] = None,
                   filename: str = "manifest.json",
                   **kwargs) -> Dict[str, Any]:
    """Build + write ``<run_dir>/manifest.json`` (`filename`: an elastic
    sweep worker's ``manifest.<id>.json``). The write is recorded as
    an event when `events` is given. run_id precedence: an explicit
    ``run_id=`` kwarg wins (cross-process shared launch ids), then the
    EventLog's id (so events and manifest cross-reference), then a fresh
    one."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    run_id = kwargs.pop("run_id", None)
    if run_id is None and events is not None:
        run_id = events.run_id
    manifest = build_manifest(kind, run_id=run_id, **kwargs)
    (run_dir / filename).write_text(json.dumps(manifest, indent=2))
    if events is not None:
        events.emit("manifest", kind, path=str(run_dir / filename),
                    config_hash=manifest["config_hash"])
    return manifest


def load_manifest(run_dir, filename: str = "manifest.json"
                  ) -> Optional[Dict[str, Any]]:
    path = Path(run_dir) / filename
    if not path.exists():
        return None
    return json.loads(path.read_text())


def update_manifest(run_dir, filename: str = "manifest.json",
                    **patch: Any) -> Optional[Dict[str, Any]]:
    """Merge `patch` into an existing ``manifest.json`` (atomically).

    The manifest is written at STARTUP, but some provenance only exists at
    the end — quorum-dropped ensemble members, a degraded sweep's coverage.
    Recording those IN the manifest keeps the run dir's one self-description
    authoritative. Best-effort like everything here: no manifest (or an
    unreadable one) returns None rather than raising."""
    import os

    run_dir = Path(run_dir)
    path = run_dir / filename
    try:
        manifest = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    manifest.update(patch)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=2))
    os.replace(tmp, path)
    return manifest
