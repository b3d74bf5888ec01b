"""ctypes loader for the native panel codec (``_native/panel_codec.cpp``).

The port's copy of the JAX package's ``data/native.py``: the same source,
the same loader behaviour. The shared library is built with the system C++
toolchain (``g++ -fopenmp``) on first use, on a BACKGROUND thread, into
``data/_build/`` (git-ignored; never the source directory). While the build
is in flight, or when it fails or no toolchain exists, every entry point
degrades to the NumPy decode, so a load never blocks on, nor hard-depends
on, a compiler. An already-built, fresh library loads synchronously:
``ctypes.CDLL`` of an existing file takes milliseconds.

``DLAP_NO_NATIVE`` (any non-empty value) keeps every decode on NumPy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "_native" / "panel_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED = False  # terminal: build/load attempted and lost — stay on NumPy
_BUILD_THREAD: Optional[threading.Thread] = None


def _build(so_path: Path) -> bool:
    cmds = [
        ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-o", str(so_path),
         str(_SRC)],
        ["g++", "-O3", "-shared", "-fPIC", "-o", str(so_path), str(_SRC)],
        ["cc", "-O3", "-shared", "-fPIC", "-lstdc++", "-o", str(so_path),
         str(_SRC)],
    ]
    for cmd in cmds:
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode == 0 and so_path.exists():
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


def so_path() -> Path:
    """Where the built library lives."""
    return BUILD_DIR / "panel_codec.so"


def _finish_load(path: Path) -> None:
    """CDLL-load + prototypes; sets _LIB or marks terminal failure. Caller
    holds _LOCK. The library at `path` is always complete (the build
    renames it into place), so a load failure here is a real toolchain/ABI
    problem, not a torn write."""
    global _LIB, _FAILED
    try:
        lib = ctypes.CDLL(str(path))
        lib.panel_decode.restype = ctypes.c_longlong
        lib.panel_decode.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.panel_codec_num_threads.restype = ctypes.c_int
        lib.panel_codec_num_threads.argtypes = []
        _LIB = lib
    except OSError:
        _FAILED = True


def _background_build(path: Path) -> None:
    """Build into a temporary name and rename into place: the unlocked
    'exists and fresh' fast path of :func:`_load` must never CDLL a
    partially written library."""
    global _FAILED
    ok = False
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.build")
        ok = _build(tmp)
        if ok:
            try:
                os.replace(tmp, path)  # readers see old-or-complete
            except OSError:
                ok = False
        tmp.unlink(missing_ok=True)
    except OSError:
        ok = False
    with _LOCK:
        if ok:
            _finish_load(path)
        else:
            _FAILED = True


def _load(wait: bool = False) -> Optional[ctypes.CDLL]:
    """The library if ready, else None. A missing or stale library starts a
    background build; `wait=True` (explicit availability queries, tests)
    joins it, while the load path never blocks."""
    global _FAILED, _BUILD_THREAD
    if _LIB is not None:
        return _LIB
    if _FAILED:
        return None
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        if os.environ.get("DLAP_NO_NATIVE"):
            _FAILED = True
            return None
        path = so_path()
        if path.exists() and path.stat().st_mtime >= _SRC.stat().st_mtime:
            _finish_load(path)  # built earlier: loading is milliseconds
            return _LIB
        if _BUILD_THREAD is None:
            _BUILD_THREAD = threading.Thread(
                target=_background_build, args=(path,),
                daemon=True, name="panel-codec-build",
            )
            _BUILD_THREAD.start()
        thread = _BUILD_THREAD
    if wait:
        thread.join()
    return _LIB


def native_available() -> bool:
    """Is the native codec usable? Joins any in-flight build: this is the
    explicit availability query, not the load path."""
    return _load(wait=True) is not None


def decode_panel(
    data: np.ndarray, missing_threshold: float
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Fused mask/zero-fill: data [T, N, 1+F] f32 -> (returns, features,
    mask). None when the library is not ready (the caller decodes with
    NumPy); otherwise bit for bit the NumPy decode (``panel.py``)."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    T, N, C = data.shape
    F = C - 1
    returns = np.empty((T, N), np.float32)
    features = np.empty((T, N, F), np.float32)
    mask = np.empty((T, N), np.uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.panel_decode(
        data.ctypes.data_as(fp), T, N, F, missing_threshold,
        returns.ctypes.data_as(fp), features.ctypes.data_as(fp),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return returns, features, mask.astype(bool)
