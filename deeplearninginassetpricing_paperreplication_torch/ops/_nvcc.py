"""Building the port's CUDA sources with ``nvcc`` at first use.

Each kernel library is one ``nvcc`` process on one ``.cu`` file with a
plain C interface (bound through ``ctypes``), compiled for ``sm_90a`` into
``ops/_build/`` under a name keyed by the sources and flags, so an
unchanged source is built once. :func:`run` starts every process of a
build together and waits for them all.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class Job:
    """One library: `source` (a file in csrc/) compiled with `defines`."""

    name: str
    source: str
    defines: Tuple[str, ...] = ()

    @property
    def path(self) -> Path:
        h = hashlib.sha256()
        for f in sorted(CSRC.glob("*.cu*")):  # the sources and the headers
            h.update(f.name.encode() + f.read_bytes())
        h.update(" ".join(NVCC_FLAGS + self.defines).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and "
            "PATH): the port's CUDA kernels are built from source at first "
            "use")
    return found


def run(jobs: Sequence[Job], verbose: bool = False) -> Dict[str, str]:
    """Build `jobs` in parallel (one ``nvcc`` each, all started together).
    Returns {name: compiler output}; ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills) and rebuilds. Raises on the first
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    procs = {}
    for job in jobs:
        lib = job.path
        if lib.exists() and not verbose:
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
        procs[job.name] = (tmp, lib, subprocess.Popen(
            [nvcc(), *flags, *job.defines, "-o", str(tmp),
             str(CSRC / job.source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return logs
