"""Matmul shape-ceiling microbench: what the card's tensor cores sustain on
OUR shapes.

The counterpart of the JAX package's ``ops/microbench.py`` (Pallas kernel
``_ceiling_kernel``, driven by ``measure_matmul_ceiling``). The model's hot
matmuls are narrow — [64,46], [64,64], [1,64], [8,224] rows×contract
against a long stock axis — far from the large tiles the card's 989
TFLOP/s bf16 data-sheet peak assumes. How much of that peak these shapes
can sustain is an empirical property of the card, so this measures it: a
kernel that stages every member's weights and an [K, BN] operand tile in
shared memory once and then issues nothing but the member-loop products
``acc += w[s] @ x`` on the tensor cores (``csrc/microbench.cu``). Elapsed
time over useful FLOPs is the sustained per-shape ceiling, which
``ops/roofline.py`` takes as the compute wall.

Two routes compute the same function, ``G·R·Σ_s w[s] @ x``:
:func:`matmul_ceiling_reference` (plain PyTorch, f32 from bf16 operands),
which a CPU tensor runs, and the CUDA kernel, which a CUDA tensor always
runs (a build or launch failure raises).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _nvcc
from .sdf_ffn import _raise_rc

# (rows M, contract K) pairs: the FFN's three layers at paper shape, the
# moment net, and the 128×128 yardstick of a dense tile
MODEL_MATMUL_SHAPES: Tuple[Tuple[int, int], ...] = (
    (64, 46), (64, 64), (8, 224), (128, 128),
)

# launches of the CUDA kernel, counted where the wrapper launches it
launches = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_count() -> None:
    global launches
    launches = 0


def matmul_ceiling_reference(w: torch.Tensor, x: torch.Tensor, repeats: int,
                             steps: int) -> torch.Tensor:
    """w [S, M, K], x [K, BN] (bf16) → G·R·Σ_s w[s] @ x [M, BN] in f32, on
    the tensors' device: what the kernel's accumulator holds after `steps`
    grid steps of `repeats` member loops."""
    acc = torch.einsum("smk,kn->mn", w.float(), x.float())
    return acc * float(steps * repeats)


def build_jobs() -> List[_nvcc.Job]:
    return [_nvcc.Job("microbench", "microbench.cu")]


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            (job,) = build_jobs()
            _nvcc.run([job])
            lib = ctypes.CDLL(str(job.path))
            lib.matmul_ceiling.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 7
                                           + [ctypes.c_void_p])
            lib.matmul_ceiling_occupancy.argtypes = (
                [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2)
            lib.matmul_ceiling.restype = ctypes.c_int
            lib.matmul_ceiling_occupancy.restype = ctypes.c_int
            _lib = lib
        return _lib


def step_groups(G: int, blocks: int, slots: int) -> int:
    """Step groups the G grid steps are cut into: the largest divisor of G
    (so every group runs as many steps) whose `blocks` × groups blocks fit
    the card's `slots` (SMs × blocks per SM) in one wave, at least 1."""
    return max([d for d in range(1, G + 1)
                if G % d == 0 and d * blocks <= slots] or [1])


def _launch(w: torch.Tensor, x: torch.Tensor, repeats: int,
            steps: int) -> torch.Tensor:
    global launches
    S, M, K = w.shape
    BN = x.shape[1]
    for name, t, shape in (("w", w, (S, M, K)), ("x", x, (K, BN))):
        if (t.device != x.device or t.dtype != torch.bfloat16
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(
                f"matmul_ceiling: {name} must be a contiguous bfloat16 "
                f"{list(shape)} tensor on {x.device}; got {t.dtype} "
                f"{list(t.shape)} on {t.device}")
    dev = x.device
    lib = _load()
    blocks, per_sm = ctypes.c_int(), ctypes.c_int()
    _raise_rc("matmul_ceiling", lib.matmul_ceiling_occupancy(
        S, M, K, BN, ctypes.byref(blocks), ctypes.byref(per_sm)))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = step_groups(steps, blocks.value, sms * per_sm.value)
    part = torch.empty((groups, M, BN), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.matmul_ceiling(
            w.data_ptr(), x.data_ptr(), part.data_ptr(), S, M, K, BN,
            repeats, steps, groups,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc("matmul_ceiling", rc)
    launches += 1
    return part.sum(dim=0)  # the fixed-order pass over the step groups


def matmul_ceiling(w: torch.Tensor, x: torch.Tensor, repeats: int,
                   steps: int) -> torch.Tensor:
    """G·R·Σ_s w[s] @ x [M, BN] f32 from w [S, M, K] and x [K, BN] bf16:
    the plain version on a CPU tensor, the kernel on any other (which
    raises if it is not CUDA)."""
    if x.device.type == "cpu":
        return matmul_ceiling_reference(w, x, repeats, steps)
    return _launch(w, x, repeats, steps)


def measure_matmul_ceiling(
    shapes: Sequence[Tuple[int, int]] = MODEL_MATMUL_SHAPES,
    bn: int = 2048,
    n_members: int = 9,
    repeats_per_step: int = 8,
    grid_steps: int = 64,
    timed_calls: int = 3,
    device: str = "cuda",
) -> Dict[str, Dict]:
    """Sustained bf16→f32 TFLOP/s per (M, K) shape on the card's tensor
    cores, operands resident in shared memory.

    Returns {"MxK": {"tflops", "seconds", "gflops_per_call",
    "fraction_of_dense_128"}} plus a "note". Useful FLOPs only (2·M·K·BN
    per matmul, the true M and K: the padding to 16 is the shape's cost);
    the 128×128 row is the dense yardstick, and narrow shapes' ceilings as
    a fraction of it quantify what the model's own dimensions cost. Timed
    with CUDA events over `timed_calls` calls after one warm-up call; a
    device that is not CUDA raises (there is nothing to time)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("measure_matmul_ceiling times the card's tensor "
                         f"cores with CUDA events; got device {device!r}")
    out: Dict[str, Dict] = {}
    for m, k in shapes:
        w = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (n_members, m, k)).astype(np.float32)).to(dev, torch.bfloat16)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (k, bn)).astype(np.float32)).to(dev, torch.bfloat16)
        _launch(w, x, repeats_per_step, grid_steps)  # build, load, warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(timed_calls):
            _launch(w, x, repeats_per_step, grid_steps)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / timed_calls
        flops = 2.0 * m * k * bn * n_members * repeats_per_step * grid_steps
        out[f"{m}x{k}"] = {
            "tflops": flops / dt / 1e12,
            "seconds": dt,
            "gflops_per_call": flops / 1e9,
        }
    dense = out.get("128x128", {}).get("tflops")
    if dense:
        for rec in out.values():
            rec["fraction_of_dense_128"] = rec["tflops"] / dense
    out["note"] = (
        f"S={n_members} member-loop matmuls on a shared-memory-resident "
        f"[K, {bn}] tile (mma.sync m16n8k16 bf16 -> f32, no device-memory "
        "traffic after staging): the sustained tensor-core ceiling for each "
        "model matmul shape; 128x128 is the dense yardstick")
    return out


def model_shape_ceiling_tflops(ceiling: Dict[str, Dict],
                               F: int = 46,
                               hidden: Sequence[int] = (64, 64),
                               M: int = 178, K: int = 8) -> float:
    """FLOP-weighted harmonic ceiling for one fused FFN+moment forward:
    time = Σ flops_i/ceiling_i, so the blended ceiling is Σf / Σ(f/c).
    (The [1,64] output projection is folded into the [64,64] class — same
    row-padding regime, negligible FLOP share.)"""
    layers = [(h_out, h_in) for h_in, h_out in
              zip([F, *hidden], [*hidden, 1])]
    layers.append((K, F + M))  # moment net

    def rate(m, k):
        for key, rec in ceiling.items():
            if key == f"{m}x{k}":
                return rec["tflops"]
        # nearest measured class: match on contract dim regime
        return ceiling.get("64x64", {}).get("tflops", 50.0)

    total_f, total_t = 0.0, 0.0
    for m, k in layers:
        f = 2.0 * m * k
        total_f += f
        total_t += f / rate(m, k)
    return round(total_f / total_t, 2)
