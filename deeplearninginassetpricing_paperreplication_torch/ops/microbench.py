"""Matmul shape-ceiling microbench: what the card's tensor cores sustain on
OUR shapes.

The counterpart of the JAX package's ``ops/microbench.py`` (Pallas kernel
``_ceiling_kernel``, driven by ``measure_matmul_ceiling``). The model's hot
matmuls are narrow — [64,46], [64,64], [1,64], [8,224] rows×contract
against a long stock axis — far from the large tiles the card's 989
TFLOP/s bf16 data-sheet peak assumes. How much of that peak these shapes
can sustain is an empirical property of the card, so this measures it: a
kernel that stages every member's weights in shared memory and an operand
tile in registers once and then issues nothing but the member-loop products
``acc += w[s] @ x`` on the tensor cores (``wgmma``, ``csrc/microbench.cu``,
at :func:`ceiling_plan`'s launch plan). Elapsed time over useful FLOPs is
the sustained per-shape ceiling, which ``ops/roofline.py`` takes as the
compute wall.

Two routes compute the same function, ``G·R·Σ_s w[s] @ x``:
:func:`matmul_ceiling_reference` (plain PyTorch, f32 from bf16 operands),
which a CPU tensor runs, and the CUDA kernel, which a CUDA tensor always
runs (a build or launch failure raises).
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _nvcc
from .sdf_ffn import MAX_SMEM, _raise_rc, _resident

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
                                           + [ctypes.c_int] * 12
                                           + [ctypes.c_longlong,
                                              ctypes.c_void_p])
            lib.matmul_ceiling_plan_info.argtypes = (
                [ctypes.c_int] * 9 + [ctypes.c_longlong,
                                      ctypes.POINTER(ctypes.c_int)])
            lib.matmul_ceiling_registers.argtypes = [ctypes.c_int] * 3
            for fn in (lib.matmul_ceiling, lib.matmul_ceiling_plan_info,
                       lib.matmul_ceiling_registers):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def step_groups(G: int, blocks: int, slots: int) -> int:
    """Step groups the G grid steps are cut into: the largest divisor of G
    (so every group runs as many steps) whose `blocks` × groups blocks fit
    the card's `slots` (SMs × blocks per SM) in one wave, at least 1."""
    return max([d for d in range(1, G + 1)
                if G % d == 0 and d * blocks <= slots] or [1])


# -- the launch plan -----------------------------------------------------------
#
# csrc/microbench.cu's kernel: warpgroups of 128 threads, each on 64 stocks
# (wgmma's 64-row side), at a member width of M rounded up to 8 among the
# built widths (M past the widest in row slices), one wgmma covering
# `stack` members side by side; w staged in shared memory per block, K-major
# core matrices without swizzle; x in registers, K cut into chunks of a
# built k-step count whose members' tiles fit one block.
CEILING_ROWS = 64
CEILING_WIDTHS = (8, 16, 32, 64, 128)
CEILING_STACKS = (9, 3, 1)  # members a wgmma covers, most first
CEILING_MAX_N = 192  # the widest product built (96 accumulators a thread)
CEILING_KSTEPS = (16, 14, 7, 4, 3, 2, 1)  # built k-step counts, most first
CEILING_MAX_WARPGROUPS = 4
CEILING_LAYOUT = "K-major, no swizzle"


def ceiling_max_warpgroups(n: int, ksteps: int) -> int:
    """Warpgroups a block of the instance may run (its launch bounds): four
    where the accumulators and A fragments take at most 80 registers, else
    two, which leaves each thread up to 255."""
    return CEILING_MAX_WARPGROUPS if n // 2 + 4 * ksteps <= 80 else 2


@dataclasses.dataclass(frozen=True)
class CeilingPlan:
    """The ceiling's launch: warpgroups per block (64 stocks each), each
    member's width (M rounded up to 8), the members one wgmma covers side by
    side (`stack`: its width is stack × width), M slices of that width, K
    chunks of `ksteps` k steps (16 deep), B's shared-memory layout and bytes,
    the resident blocks per SM that shared memory, threads and (where known)
    registers allow, the step groups of one wave, and the grid (stock
    blocks, slices × chunks, groups)."""

    warpgroups: int
    width: int
    stack: int
    slices: int
    kchunks: int
    ksteps: int
    layout: str
    smem_bytes: int
    blocks_per_sm: int
    groups: int
    grid: Tuple[int, int, int]

    @property
    def threads(self) -> int:
        return 128 * self.warpgroups

    @property
    def n(self) -> int:
        """The wgmma width."""
        return self.stack * self.width

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def ceiling_width(M: int) -> int:
    """The member width of an M-row slice: M rounded up to 8, among the
    built widths (the widest for M past it)."""
    m = -(-M // 8) * 8
    return next((w for w in CEILING_WIDTHS if w >= m), CEILING_WIDTHS[-1])


def ceiling_stack(S: int, width: int) -> int:
    """The members one wgmma covers: the most of CEILING_STACKS that divides
    S and keeps the product within CEILING_MAX_N."""
    return next(p for p in CEILING_STACKS
                if S % p == 0 and p * width <= CEILING_MAX_N)


def ceiling_plan(S: int, M: int, K: int, BN: int, sms: int, G: int = 64,
                 registers: Optional[Dict[Tuple[int, int, int], int]] = None
                 ) -> CeilingPlan:
    """The ceiling's launch plan for w [S, M, K] against x [K, BN] over G
    grid steps on a card of `sms` SMs.

    The width is :func:`ceiling_width`, the stack :func:`ceiling_stack`; K,
    padded to a multiple of 16 only, is cut into the fewest equal chunks of
    a built k-step count whose members' w fit one block's shared memory. Of
    1 to :func:`ceiling_max_warpgroups` warpgroups a block, the one that
    keeps the most warpgroups resident per SM, × the share of the wave's
    slots the step groups fill; then fewer warpgroups a block. `registers`
    ({(width, stack, ksteps): registers per thread}, as the built library
    reports them) bounds the blocks per SM too. Raises if nothing fits."""
    width = ceiling_width(M)
    stack = ceiling_stack(S, width)
    slices = -(-M // width)
    total = -(-K // 16)
    fits = [(total // ks, ks) for ks in CEILING_KSTEPS
            if total % ks == 0 and S * width * ks * 32 <= MAX_SMEM]
    if not fits:
        raise ValueError(f"matmul_ceiling: {S} members of width {width} do "
                         "not fit a block's shared memory")
    kchunks, ksteps = fits[0]
    smem = S * width * ksteps * 32
    regs = (registers or {}).get((width, stack, ksteps), 0)
    best = None
    for wgs in range(1, ceiling_max_warpgroups(stack * width, ksteps) + 1):
        blocks = _resident(smem, 128 * wgs, regs)
        if blocks < 1:
            continue
        grid_xy = (-(-BN // (CEILING_ROWS * wgs)), slices * kchunks)
        per_group = grid_xy[0] * grid_xy[1]
        groups = step_groups(G, per_group, sms * blocks)
        fill = min(1.0, groups * per_group / (sms * blocks))
        key = (round(blocks * wgs * fill, 6), -wgs)
        if best is None or key > best[0]:
            best = (key, CeilingPlan(wgs, width, stack, slices, kchunks,
                                     ksteps, CEILING_LAYOUT, smem, blocks,
                                     groups, (*grid_xy, groups)))
    if best is None:
        raise ValueError(f"matmul_ceiling: no block of S = {S}, width "
                         f"{width} fits an SM")
    return best[1]


_regs: Dict[Tuple[int, int, int], int] = {}
_plans: Dict[tuple, CeilingPlan] = {}


def card_ceiling_plan(dev, S: int, M: int, K: int, BN: int,
                      G: int) -> CeilingPlan:
    """:func:`ceiling_plan` for the card `dev`: its SM count and the
    registers of the library's kernel instance; kept per shape. Each plan
    is checked on the card once, before its first launch
    (:func:`ceiling_plan_info`): one that the kernel refuses, or whose
    blocks the card does not keep resident, raises."""
    key = (dev, S, M, K, BN, G)
    plan = _plans.get(key)
    if plan is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        bare = ceiling_plan(S, M, K, BN, sms, G)
        inst = (bare.width, bare.stack, bare.ksteps)
        if inst not in _regs:
            _regs[inst] = _load().matmul_ceiling_registers(*inst)
        plan = ceiling_plan(S, M, K, BN, sms, G,
                            {inst: _regs[inst]} if _regs[inst] > 0 else None)
        with torch.cuda.device(dev):
            held = ceiling_plan_info(plan, S, M, K, BN)
        if held["blocks_per_sm"] < plan.blocks_per_sm:
            raise RuntimeError(f"matmul_ceiling: the card keeps "
                               f"{held['blocks_per_sm']} blocks per SM of "
                               f"the plan {plan}")
        _plans[key] = plan
    return plan


def ceiling_plan_info(plan: CeilingPlan, S: int, M: int, K: int,
                      BN: int) -> Dict[str, int]:
    """What the card makes of `plan` (the current CUDA device): resident
    blocks per SM, registers and local-memory bytes per thread. Raises for
    a plan the kernel refuses."""
    out = (ctypes.c_int * 3)()
    rc = _load().matmul_ceiling_plan_info(
        S, M, K, BN, plan.warpgroups, plan.width, plan.stack, plan.kchunks,
        plan.ksteps, plan.smem_bytes, out)
    if rc != 0:
        raise RuntimeError(f"matmul_ceiling refused the plan {plan} "
                           f"(code {rc})")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


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
    plan = card_ceiling_plan(dev, S, M, K, BN, steps)
    part = torch.empty((plan.groups * plan.kchunks, M, BN),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _load().matmul_ceiling(
            w.data_ptr(), x.data_ptr(), part.data_ptr(), S, M, K, BN,
            repeats, steps, plan.groups, plan.warpgroups, plan.width,
            plan.stack, plan.kchunks, plan.ksteps, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc == -1:
        raise RuntimeError(f"matmul_ceiling refused the plan {plan}")
    _raise_rc("matmul_ceiling", rc)
    launches += 1
    return part.sum(dim=0)  # the fixed-order pass over the partials


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
        f"S={n_members} member-loop matmuls against a register-resident "
        f"[K, {bn}] operand in 64-stock tiles (wgmma m64nNk16 bf16 -> f32, "
        "N = M rounded to 8 times the members one product covers, w in "
        "shared memory, no device-memory traffic after staging): the "
        "sustained tensor-core ceiling for each model matmul shape; 128x128 "
        "is the dense yardstick")
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
