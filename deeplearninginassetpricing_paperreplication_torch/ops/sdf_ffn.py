"""Fused SDF-FFN forward: the panel MLP of every ensemble member, one launch.

The counterpart of the JAX package's ``ops/pallas_ffn.py`` forward
(``fused_sdf_ffn``; Pallas kernels ``_fwd_kernel`` and
``_fwd_kernel_members``). For member s, period t and stock n::

    w[s,t,n] = kout_s . relu(W_L,s ... relu(K1_s^T x[t,:,n] + zp[s,t]) ... + b) + bout_s

over the feature-major panel ``x_t [T, F, N]``. The member axis is explicit
(S = 1 is the single-model call), so an ensemble is one launch over one
panel read. Masking, zero-mean and normalization stay in plain PyTorch, as
they are plain XLA in the JAX package.

Two routes compute the same function:

* :func:`sdf_ffn_reference`: plain PyTorch, with the same bf16 operand
  rounding as the kernel. It is what a CPU tensor runs, and what the tests
  and ``chip_smoke.py`` hold the kernel against.
* the CUDA kernel ``csrc/sdf_ffn.cu`` (``sm_90a``), built from this
  package's sources with ``nvcc`` at first use and bound through ``ctypes``.
  A CUDA tensor always goes through it; a build or launch failure raises.

``compute_dtype="bfloat16"`` rounds both operands of every product to bf16
and accumulates in f32 (``pallas_ffn._dot``); biases stay f32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

_CSRC = Path(__file__).resolve().parent / "csrc" / "sdf_ffn.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
COMPUTE_DTYPES = ("float32", "bfloat16")
MAX_HIDDEN_LAYERS = 8
WIDTH_BOUNDS = (32, 64, 128)  # one library per bound on the padded width

# launches of the CUDA kernel, counted where the wrapper launches it and
# nowhere else (reset_launch_count() before a run, read it after)
launches = 0

_libs: Dict[int, ctypes.CDLL] = {}
_lib_lock = threading.Lock()

Mids = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def reset_launch_count() -> None:
    global launches
    launches = 0


def _round(a: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """An operand as the products see it: bf16-rounded (round to nearest
    even), kept in f32 so the accumulation stays f32."""
    if compute_dtype == "bfloat16":
        return a.to(torch.bfloat16).to(torch.float32)
    return a


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}: "
                         f"{compute_dtype!r}")


def sdf_ffn_reference(x_t: torch.Tensor, zp: torch.Tensor, k1T: torch.Tensor,
                      mids: Mids, kout: torch.Tensor, bout: torch.Tensor,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """The plain-PyTorch version of the kernel.

    x_t [T, F, N]; zp [S, T, H1]; k1T [S, H1, F]; mids ((W [S, H, Hin],
    b [S, H]), ...); kout [S, HL]; bout [S]  →  raw weights [S, T, N] f32.
    """
    _check_dtype(compute_dtype)
    x = _round(x_t.float(), compute_dtype)
    h = torch.einsum("shf,tfn->sthn", _round(k1T, compute_dtype), x)
    h = torch.relu(h + zp[..., None])
    for w, b in mids:
        h = torch.einsum("sko,ston->stkn", _round(w, compute_dtype),
                         _round(h, compute_dtype))
        h = torch.relu(h + b[:, None, :, None])
    out = torch.einsum("sk,stkn->stn", _round(kout, compute_dtype),
                       _round(h, compute_dtype))
    return out + bout[:, None, None]


# -- packed parameters ------------------------------------------------------


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


@dataclasses.dataclass(frozen=True)
class FfnLayout:
    """Offsets (in floats) of one member's packed parameters — the single
    definition the kernel reads through (``csrc/sdf_ffn.cu``)."""

    F: int
    hidden: Tuple[int, ...]
    hp: Tuple[int, ...]  # widths padded to a multiple of 4
    off_w: Tuple[int, ...]  # W_l offsets (entry 0: the first layer, k1)
    off_b: Tuple[int, ...]  # b_l offsets (entry 0 unused: zp carries b1)
    off_kout: int
    off_bout: int
    P: int  # floats per member

    def as_ints(self) -> List[int]:
        n = len(self.hidden)
        return ([n, self.F, self.P, self.off_kout, self.off_bout]
                + list(self.hidden) + list(self.hp) + list(self.off_w)
                + list(self.off_b))


def ffn_layout(F: int, hidden: Sequence[int]) -> FfnLayout:
    hidden = tuple(int(h) for h in hidden)
    if not hidden:
        raise ValueError("the fused FFN needs at least one hidden layer")
    hp = tuple(_pad4(h) for h in hidden)
    off = F * hp[0]  # k1 [F][hp0] at offset 0
    off_w, off_b = [0], [0]
    for li in range(1, len(hidden)):
        off_w.append(off)
        off += hidden[li] * hp[li - 1]
        off_b.append(off)
        off += hp[li]
    off_kout = off
    off += hp[-1]
    off_bout = off
    off += 4
    return FfnLayout(F, hidden, hp, tuple(off_w), tuple(off_b), off_kout,
                     off_bout, off)


@dataclasses.dataclass(frozen=True)
class PackedFfn:
    """Member-stacked FFN parameters, packed once in the kernel's layout.

    ``params`` [S, P] holds the weights already rounded to ``compute_dtype``
    (the biases unrounded); ``k1T``/``mids``/``kout``/``bout`` keep the
    unpacked tensors for the plain route."""

    params: torch.Tensor
    layout: FfnLayout
    compute_dtype: str
    k1T: torch.Tensor
    mids: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    kout: torch.Tensor
    bout: torch.Tensor

    @property
    def n_members(self) -> int:
        return self.params.shape[0]


def pack_ffn(k1T: torch.Tensor, mids: Mids, kout: torch.Tensor,
             bout: torch.Tensor, compute_dtype: str = "bfloat16") -> PackedFfn:
    """k1T [S, H1, F], mids ((W [S, H, Hin], b [S, H]), ...), kout [S, HL],
    bout [S] → :class:`PackedFfn` on the tensors' device."""
    _check_dtype(compute_dtype)
    S, H1, F = k1T.shape
    hidden = [H1] + [w.shape[1] for w, _ in mids]
    if len(hidden) > MAX_HIDDEN_LAYERS:
        raise ValueError(f"the fused FFN takes at most {MAX_HIDDEN_LAYERS} "
                         f"hidden layers; got {len(hidden)}")
    lay = ffn_layout(F, hidden)
    buf = torch.zeros(S, lay.P, dtype=torch.float32, device=k1T.device)
    with torch.no_grad():
        k1 = buf[:, :F * lay.hp[0]].unflatten(1, (F, lay.hp[0]))
        k1[:, :, :H1] = _round(k1T.float(), compute_dtype).transpose(1, 2)
        for li, (w, b) in enumerate(mids, start=1):
            h, hin = hidden[li], hidden[li - 1]
            o = lay.off_w[li]
            wv = buf[:, o:o + h * lay.hp[li - 1]].unflatten(
                1, (h, lay.hp[li - 1]))
            wv[:, :, :hin] = _round(w.float(), compute_dtype)
            buf[:, lay.off_b[li]:lay.off_b[li] + h] = b.float()
        buf[:, lay.off_kout:lay.off_kout + hidden[-1]] = _round(
            kout.float(), compute_dtype)
        buf[:, lay.off_bout] = bout.float()
    return PackedFfn(buf.contiguous(), lay, compute_dtype, k1T,
                     tuple((w, b) for w, b in mids), kout, bout)


# -- the CUDA kernel --------------------------------------------------------


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
            "the sdf_ffn_fwd kernel is built from source at first use")
    return found


def width_bound(hidden: Sequence[int]) -> int:
    """The library a model needs: the smallest of WIDTH_BOUNDS that holds
    its widest (padded) hidden layer."""
    w = max(_pad4(h) for h in hidden)
    for b in WIDTH_BOUNDS:
        if w <= b:
            return b
    raise ValueError(f"sdf_ffn_fwd: hidden width {max(hidden)} exceeds the "
                     f"kernel's {WIDTH_BOUNDS[-1]}")


def _lib_path(width: int) -> Path:
    key = hashlib.sha256(_CSRC.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"libsdf_ffn_w{width}_{key}.so"


def build(widths: Sequence[int] = WIDTH_BOUNDS,
          verbose: bool = False) -> Dict[int, str]:
    """Compile ``csrc/sdf_ffn.cu`` for sm_90a, one library per width bound,
    all ``nvcc`` processes started together, into the package's build
    directory (named by the source and flags, so an unchanged source is
    built once). Returns {width: compiler output}; ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills) and rebuilds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if verbose else [])
    procs = {}
    for w in widths:
        lib = _lib_path(w)
        if lib.exists() and not verbose:
            continue
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
        procs[w] = (tmp, lib, subprocess.Popen(
            [_nvcc(), *flags, f"-DSDF_FFN_MAXW={w}", "-o", str(tmp),
             str(_CSRC)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = {}
    for w, (tmp, lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_CSRC} for width {w} "
                               f"(rc {proc.returncode}):\n{out}")
        os.replace(tmp, lib)
        logs[w] = out
    return logs


def _load(width: int):
    with _lib_lock:
        if width not in _libs:
            build([width])
            lib = ctypes.CDLL(str(_lib_path(width)))
            lib.sdf_ffn_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
            lib.sdf_ffn_fwd.restype = ctypes.c_int
            _libs[width] = lib
        return _libs[width]


def _check_cuda(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"sdf_ffn_fwd: {name} must be a contiguous float32 "
                         f"tensor on {device}; got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if tuple(t.shape) != shape:
        raise ValueError(f"sdf_ffn_fwd: {name} must be {list(shape)}; got "
                         f"{list(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"sdf_ffn_fwd: {name} must be 16-byte aligned")


def _launch(x_t: torch.Tensor, zp: torch.Tensor,
            packed: PackedFfn) -> torch.Tensor:
    global launches
    lay = packed.layout
    T, F, N = x_t.shape
    S = packed.n_members
    dev = x_t.device
    _check_cuda("x_t", x_t, (T, lay.F, N), dev)
    _check_cuda("zp", zp, (S, T, lay.hidden[0]), dev)
    _check_cuda("params", packed.params, (S, lay.P), dev)
    lib = _load(width_bound(lay.hidden))
    out = torch.empty((S, T, N), dtype=torch.float32, device=dev)
    ints = lay.as_ints()
    layout = (ctypes.c_int * len(ints))(*ints)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdf_ffn_fwd(
            x_t.data_ptr(), zp.data_ptr(), packed.params.data_ptr(),
            out.data_ptr(), S, T, N, layout,
            int(packed.compute_dtype == "bfloat16"), stream)
    if rc != 0:
        raise RuntimeError(
            f"sdf_ffn_fwd launch failed (code {rc}: "
            + ("unsupported shape" if rc == -1 else "cudaError") + ")")
    launches += 1
    return out


def sdf_ffn_packed(x_t: torch.Tensor, zp: torch.Tensor, packed: PackedFfn,
                   kernel: str = "auto",
                   dropout_rate: float = 0.0) -> torch.Tensor:
    """Raw weights [S, T, N] from pre-packed member weights.

    A CUDA panel launches the kernel (``kernel`` "auto" or "on"); a CPU
    panel runs :func:`sdf_ffn_reference`. ``kernel="off"`` asks for the
    plain route explicitly on any device."""
    if dropout_rate > 0.0:
        raise ValueError("sdf_ffn_fwd is the eval-mode forward: dropout "
                         f"rate must be 0, got {dropout_rate}")
    if kernel not in ("auto", "on", "off"):
        raise ValueError(f"kernel must be auto|on|off: {kernel!r}")
    if kernel == "off" or (kernel == "auto" and x_t.device.type == "cpu"):
        return sdf_ffn_reference(x_t, zp, packed.k1T, packed.mids,
                                 packed.kout, packed.bout,
                                 packed.compute_dtype)
    if x_t.device.type != "cuda":
        raise ValueError(f"kernel='on' needs a CUDA panel; got {x_t.device}")
    return _launch(x_t, zp, packed)


def flops(S: int, T: int, N: int, F: int, hidden: Sequence[int]) -> int:
    """Multiply-adds ×2 of one call: 2·(F·H1 + Σ H_{l-1}·H_l + H_L) per
    (member, period, stock)."""
    per = F * hidden[0] + sum(a * b for a, b in zip(hidden, hidden[1:]))
    per += hidden[-1]
    return 2 * per * S * T * N


def bytes_moved(S: int, T: int, N: int, F: int, hidden: Sequence[int]) -> int:
    """Each input read once, the output written once (f32): the panel, zp,
    the packed weights, and the [S, T, N] output."""
    lay = ffn_layout(F, hidden)
    return 4 * (T * F * N + S * T * hidden[0] + S * lay.P + S * T * N)
