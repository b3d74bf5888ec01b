"""Fused moment net + conditional loss: h = tanh(K_stockᵀx + zp_m)
contracted into the per-(moment, asset) empirical means, forward, backward
and panel cotangent, without materializing h [K, T, N].

The counterpart of the JAX package's ``ops/pallas_moment.py``
(``fused_conditional_em``; Pallas kernels ``_fwd_kernel``/``_bwd_kernel``,
their member-fused twins, and ``_dx_kernel``). For member s::

    em[s,k,n] = Σ_t tanh(kT_s[k,:]·x[t,:,n] + zp_m[s,t,k]) · xr[s,t,n] · tinv[n]

with ``xr = R·m·(1 + F)`` and ``tinv = 1 / clip(T_i, 1)``;
``conditional_loss == mean(em²)`` (or sum / (K·n_assets) under padding).

Two routes compute the same functions: the plain PyTorch versions
:func:`cond_em_reference`, :func:`cond_em_bwd_reference` and
:func:`cond_em_dx_reference` (with the JAX kernels' bf16 rounding points),
which a CPU tensor runs, and the CUDA
kernels ``csrc/cond_em.cu`` (``sm_90a``, built with ``nvcc`` at first use,
bound through ``ctypes``), which a CUDA tensor always runs. ``kernel="off"``
is the only way to the plain route on the card.

The forward and backward kernels launch at :func:`cem_plan`'s plan (the
route, stock tile, members per block, threads, stages and shared memory,
Python arithmetic that the kernel checks on the card), the panel cotangent
at :func:`cem_dx_plan`'s; their f32 outputs keep the summation order of the
one-thread-per-stock kernels they replaced, bit for bit.

The kernels take at most :data:`MAX_MOMENTS` moments. Above that the
wrappers launch them over :func:`moment_chunks` (balanced chunks of at most
16 moments; every moment's terms are its own): em rows, ∂k_stock rows and
∂zp_m columns come per chunk; ∂xr and the panel cotangent are summed over
the chunks in f32, in chunk order, and the cotangent is rounded once to the
panel's dtype (each chunk's runs on the panel widened to f32, which every
kernel computes exactly as it does the bf16 panel). At K ≤ 16 the path is
one launch, as it was. The plain versions take any K.

The panel x_t is float32 or bfloat16 (``ExecutionConfig.bf16_panel``), as
in ``ops/sdf_ffn.py``: each kernel widens a bf16 panel exactly into the
f32 stages it computes from (``csrc/panel.cuh``), each plain version reads
``x_t.float()``, and the panel cotangent comes back in the panel's dtype,
rounded once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from . import BF16_PANEL, _nvcc, launch_total, reset_launch_counts
from .sdf_ffn import (BLOCK_SMEM_RESERVED, MAX_SMEM, PANEL_DTYPES,
                      REG_ALLOC_UNIT, SM_MAX_BLOCKS, SM_MAX_THREADS, SM_REGS,
                      SM_SMEM, _check_dtype, _panel_args, _raise_rc, _round,
                      _route, check_panel_dtype, is_bf16, panel_launch)

MAX_MOMENTS = 16  # the kernels' (csrc/cond_em.cu kMaxK); more go in chunks
BWD_STOCKS = 128  # the backward's stock tile: its partial sums are built on it

# launches of the CUDA kernels, counted per device where the wrapper
# launches them and nowhere else (ops.count_launch; reset_launch_count()
# before a run, read them after): these module totals sum the devices
_TOTALS = {"fwd_launches": "cond_em_fwd",
           "bwd_launches": "cond_em_bwd",
           "dx_launches": "cond_em_dx"}
# and those of the bf16-panel forms alone (a subset of the above)
_TOTALS.update({k + BF16_PANEL: v + BF16_PANEL
                for k, v in list(_TOTALS.items())})

_libs: Dict[bool, ctypes.CDLL] = {}  # by the panel's dtype: bf16 or not
_lib_lock = threading.Lock()


def __getattr__(name: str) -> int:
    if name in _TOTALS:
        return launch_total(_TOTALS[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_count() -> None:
    reset_launch_counts(_TOTALS.values())


# -- the plain versions -------------------------------------------------------


def _h(x_t, zp_m, kT, compute_dtype):
    """tanh moments [S, T, K, N]."""
    pre = torch.einsum("skf,tfn->stkn", _round(kT, compute_dtype),
                       _round(x_t.float(), compute_dtype))
    return torch.tanh(pre + zp_m[..., None])


def cond_em_reference(x_t: torch.Tensor, zp_m: torch.Tensor,
                      xr: torch.Tensor, tinv: torch.Tensor, kT: torch.Tensor,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """x_t [T, F, N], zp_m [S, T, K], xr [S, T, N], tinv [N], kT [S, K, F]
    → em [S, K, N]."""
    _check_dtype(compute_dtype)
    h = _h(x_t, zp_m, kT, compute_dtype)
    return (h * (xr * tinv)[:, :, None, :]).sum(dim=1)


def _dpre(x_t, zp_m, xr, tinv, kT, gem, compute_dtype):
    """(h, dpre = gem·xr·tinv·(1 − h²)) [S, T, K, N]: the cotangent of the
    moment net's pre-activation, shared by the backward and the panel
    cotangent."""
    h = _h(x_t, zp_m, kT, compute_dtype)
    return h, gem[:, None] * (xr * tinv)[:, :, None, :] * (1.0 - h * h)


def cond_em_bwd_reference(x_t, zp_m, xr, tinv, kT, gem,
                          compute_dtype: str = "float32"):
    """gem [S, K, N] → (dkT [S, K, F], dzp_m [S, T, K], dxr [S, T, N])."""
    h, dpre = _dpre(x_t, zp_m, xr, tinv, kT, gem, compute_dtype)
    dkT = torch.einsum("stkn,tfn->skf", _round(dpre, compute_dtype),
                       _round(x_t.float(), compute_dtype))
    dxr = (gem[:, None] * h).sum(dim=2) * tinv
    return dkT, dpre.sum(dim=3), dxr


def cond_em_dx_reference(x_t, zp_m, xr, tinv, kT, gem,
                         compute_dtype: str = "float32") -> torch.Tensor:
    """gem [S, K, N] → the panel cotangent dx [T, F, N] = Σ_s round(kT_s)ᵀ ·
    round(dpre_s), summed over the members (the rounding of
    ``pallas_moment._dx_kernel``), in the panel's dtype (a bf16 dx rounded
    once)."""
    _, dpre = _dpre(x_t, zp_m, xr, tinv, kT, gem, compute_dtype)
    return torch.einsum("skf,stkn->tfn", _round(kT, compute_dtype),
                        _round(dpre, compute_dtype)).to(x_t.dtype)


# -- the CUDA kernels ----------------------------------------------------------


def build_jobs() -> List[_nvcc.Job]:
    """One library per panel dtype (f32, then bf16), compiled side by
    side: each holds its dtype's kernel instances."""
    return [_nvcc.Job("cond_em", "cond_em.cu"),
            _nvcc.Job("cond_em_bf16_panel", "cond_em.cu",
                      ("-DCOND_EM_PANEL_BF16=1",))]


def _load(xb16: bool = False) -> ctypes.CDLL:
    """The library of a bf16 (`xb16`) or f32 panel's instances."""
    xb16 = bool(xb16)
    with _lib_lock:
        if xb16 not in _libs:
            job = build_jobs()[int(xb16)]
            _nvcc.run([job])
            _libs[xb16] = bind(ctypes.CDLL(str(job.path)))
        return _libs[xb16]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a cond_em.cu library's entries
    (this tree's argument lists)."""
    # every entry's first two: the panel and its dtype (1: bf16)
    panel = [ctypes.c_void_p, ctypes.c_int]
    lib.cond_em_fwd.argtypes = (panel + [ctypes.c_void_p] * 5
                                + [ctypes.c_int] * 13
                                + [ctypes.c_longlong, ctypes.c_void_p])
    lib.cond_em_bwd.argtypes = (panel + [ctypes.c_void_p] * 8
                                + [ctypes.c_int] * 12
                                + [ctypes.c_longlong, ctypes.c_void_p])
    lib.cond_em_dx.argtypes = (panel + [ctypes.c_void_p] * 6
                               + [ctypes.c_int] * 10
                               + [ctypes.c_longlong, ctypes.c_void_p])
    # every plan query names the panel's dtype last (xb16), which
    # must be the library's
    lib.cond_em_plan_info.argtypes = (
        [ctypes.c_int] * 14 + [ctypes.c_longlong, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)])
    lib.cond_em_dx_plan_info.argtypes = (
        [ctypes.c_int] * 10 + [ctypes.c_longlong, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)])
    lib.cond_em_registers.argtypes = [ctypes.c_int] * 7
    for fn in (lib.cond_em_fwd, lib.cond_em_bwd, lib.cond_em_dx,
               lib.cond_em_plan_info, lib.cond_em_dx_plan_info,
               lib.cond_em_registers):
        fn.restype = ctypes.c_int
    return lib


def moment_chunks(K: int) -> List[Tuple[int, int]]:
    """The moments [a, b) of each launch: one chunk where K ≤ MAX_MOMENTS,
    else ⌈K/16⌉ chunks as equal as they come, the larger first."""
    if K < 1:
        raise ValueError(f"cond_em: K must be at least 1; got {K}")
    n = -(-K // MAX_MOMENTS)
    q, r = divmod(K, n)
    edges = [0]
    for i in range(n):
        edges.append(edges[-1] + q + (i < r))
    return list(zip(edges, edges[1:]))


def chunk_moments(K: int) -> int:
    """The moments a launch plans for: K, or its largest chunk."""
    a, b = moment_chunks(K)[0]
    return b - a


def _groups(S: int, T: int, N: int, stocks: int, sms: int, waves: int) -> int:
    """Period groups per (member, stock block): enough blocks for `waves`
    blocks per SM, never more groups than periods."""
    blocks = S * (-(-N // stocks))
    return max(1, min(T, -(-waves * sms // blocks)))


# -- the launch plan --------------------------------------------------------------
#
# csrc/cond_em.cu's kernels and limits: the forward on the CUDA cores (route
# 0: register tiles of RT = 8 or 4 moments × CT stocks per thread) or, in
# bf16 with F ≤ MMA_MAX_F, on the tensor cores (route 1: warps of 16 stocks ×
# NT n tiles of 8 member-moments); the backward over 128-stock tiles, on
# the CUDA cores (route 0: 64 threads a member) or, in bf16, on the tensor
# cores (route 1). Both stream the panel through `stages` tiles. The f32
# partial sums fix the period groups (the forward's are planned on 64-stock
# blocks, the backward's on its 128-stock tiles); the forward's stock tile
# and both kernels' members per block and stages are free.

FWD_GROUP_STOCKS = 64
FWD_MAX_THREADS = 512
BWD_MAX_THREADS = 256
BWD_PER_MEMBER = 64
STAGE_STRIDE = BWD_STOCKS + 4  # the backward's stage rows (odd quarter)
MMA_MAX_F = 64
# route 0's stocks per thread, by RT, most first. By the rule below the plan
# would take CT 4 only from N = 11,261 (CT 8 at RT 4 from 22,521) at S = 9
# and K ∈ {4, 8}, past every training panel, so those are not built.
FWD_CTS = {8: (2, 1), 4: (2,)}
# route 0 takes the most stocks per thread whose grid still has this many
# warps per SM (fewer shared loads per FMA against more warps in flight)
FWD_MIN_WARPS = 6
# the stages the kernels take. The CUDA-core routes: a constant (two in the
# forward, one in the backward), as more timed the same (instruction issue
# and latency bound them). The tensor-core routes: the most of these that
# cost no wave (the panel read weighs more there)
FWD_CORES_STAGES = 2
FWD_STAGES = (2, 3, 4)
BWD_STAGES = (1, 2)


@dataclasses.dataclass(frozen=True)
class CemPlan:
    """One kernel's launch: route (0 CUDA cores, 1 bf16 tensor cores),
    stocks per block, members per block, threads per block, `var` (the
    forward's stocks per thread on route 0 or n tiles per warp on route 1;
    the backward's route 0: 0 with the stock-major copy of the tile, 1
    without; its route 1: warps per row group), the panel tiles in flight
    (`stages`), shared memory per block, the resident blocks per SM that
    shared memory, threads and (where known) registers allow, the period
    groups and the grid (x, y, z)."""

    kernel: str
    route: int
    tile: int
    members: int
    threads: int
    var: int
    stages: int
    smem_bytes: int
    blocks_per_sm: int
    groups: int
    grid: Tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


class CemPlans(NamedTuple):
    fwd: CemPlan
    bwd: CemPlan


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _odd4(w: int) -> int:
    """A row stride of at least w floats, a multiple of 4 whose quarter is
    odd (csrc/cond_em.cu odd4)."""
    s = _pad(w, 4)
    return s if (s // 4) % 2 else s + 4


def fwd_rt(K: int) -> int:
    """Route 0's moments per thread."""
    return 4 if _pad(K, 4) % 8 else 8


def mma_nt(M: int, K: int) -> int:
    """Route 1's n tiles per warp: the largest of 3, 2, 1 dividing the
    block's M·⌈K/8⌉ tiles of 8 member-moments."""
    tiles = M * _pad(K, 8) // 8
    return 3 if tiles % 3 == 0 else 2 if tiles % 2 == 0 else 1


def fwd_geometry(route: int, M: int, F: int, K: int, tpg: int, tile: int,
                 var: int, stages: int) -> Tuple[int, int]:
    """(threads, shared-memory floats) of the forward, as csrc/cond_em.cu's
    fwd_geometry counts them ((0, 0) for route 0 at other than
    FWD_CORES_STAGES stages, which it refuses). Route 0: kT [M][F][KP], zp_m
    [tpg][M][KP], the panel tiles [stages][F][tile] and xr
    [stages][M][tile], KP = ⌈K/4⌉·4. Route 1: zp_m [tpg][M·⌈K/8⌉·8], the
    tiles [stages][16·⌈F/16⌉][tile + 4], xr."""
    if route == 1:
        R = M * _pad(K, 8)
        return (32 * (R // 8 // var) * (tile // 16),
                tpg * R + stages * 16 * -(-F // 16) * (tile + 4)
                + stages * M * tile)
    if stages != FWD_CORES_STAGES:
        return 0, 0
    kp = _pad(K, 4)
    return (_pad(M * (kp // fwd_rt(K)) * (tile // var), 32),
            M * F * kp + tpg * M * kp + stages * F * tile
            + stages * M * tile)


def bwd_geometry(route: int, M: int, F: int, K: int, tpg: int, bf16: bool,
                 var: int, stages: int) -> Tuple[int, int]:
    """(threads, shared-memory floats) of the backward, as csrc/cond_em.cu's
    bwd_geometry counts them ((0, 0) for a plan it refuses: route 1's dkT
    tiles outnumbering two a warp, route 0 with more than one stage).
    Route 0: 64 phase-A threads a member, or phase B's items (4·⌈F/4⌉ dkT
    tiles and K dzp_m rows a member) where they are more; kT, zp_m, one
    stage [F][132] and the xr rows, the stock-major tile [128][⌈F/4⌉·4],
    dpre [128][·] (twice in bf16: as computed, and rounded); `var` 1 drops
    the stock-major tile (phase B reads the stage, whose rows pad to
    4·⌈F/4⌉). Route 1: `var` warps per row group of NT n tiles; zp_m
    [tpg][R], the stages [stages][16·⌈F/16⌉][132], xr rows, tinv, the dzp_m
    and dxr partials [8][R] and [R/8][128], dpre [⌈R/16⌉·16][136] in bf16,
    R = M·⌈K/8⌉·8."""
    if route == 1:
        R = M * _pad(K, 8)
        rg = R // 8 // mma_nt(M, K)
        if -(-R // 16) * -(-F // 8) > 2 * var * rg:
            return 0, 0
        return (32 * var * rg,
                tpg * R + stages * 16 * -(-F // 16) * STAGE_STRIDE
                + stages * M * BWD_STOCKS + BWD_STOCKS + 8 * R
                + R // 8 * BWD_STOCKS + _pad(R, 16) * (BWD_STOCKS + 8) // 2)
    if stages != 1:
        return 0, 0
    kp, fq = _pad(K, 4), -(-F // 4)
    xt = var == 0
    return (_pad(M * max(BWD_PER_MEMBER, 4 * fq + K), 32),
            M * F * kp + tpg * M * kp
            + (F if xt else 4 * fq) * STAGE_STRIDE
            + M * BWD_STOCKS + (BWD_STOCKS * _pad(F, 4) if xt else 0)
            + (2 if bf16 else 1) * BWD_STOCKS * _odd4(M * kp))


def _resident(smem: int, threads: int, regs: int) -> int:
    """Blocks one SM holds by shared memory (each block's allocation in
    128-byte units plus the 1 KB reserved for it), threads, its block limit
    and (when known) registers: each of the SM's four schedulers has a
    quarter of the register file, and the blocks' warps spread over them."""
    blocks = min(SM_SMEM // (_pad(smem, 128) + BLOCK_SMEM_RESERVED),
                 SM_MAX_THREADS // threads, SM_MAX_BLOCKS)
    if regs:
        per_warp = _pad(regs * 32, REG_ALLOC_UNIT)
        warps = SM_REGS // 4 // per_warp * 4
        blocks = min(blocks, warps // -(-threads // 32))
    return blocks


def _member_counts(S: int) -> List[int]:
    """Members per block of the balanced member groups, most first."""
    return sorted({-(-S // g) for g in range(1, S + 1)}, reverse=True)


def cem_plan(S: int, T: int, N: int, F: int, K: int, sms: int,
             compute_dtype: str = "float32",
             registers: Optional[Dict[tuple, int]] = None) -> CemPlans:
    """The launch plans of cond_em_fwd and cond_em_bwd on a card of `sms`
    SMs.

    Forward: route 1 in bf16 where F ≤ MMA_MAX_F, else route 0 at the most
    stocks per thread whose grid has FWD_MIN_WARPS warps per SM; then the
    members per block and the stock tile that put the least work on the
    busiest SM (⌈blocks / sms⌉ · tile · members; whole waves), fewest waves
    first, then the most members and the largest tile; route 1 then the most
    stages. Backward: route 1 in bf16 where F ≤ MMA_MAX_F, else route 0; the
    members per block, warps per row group (route 1), instance (route 0:
    with or without the stock-major copy) and stages by the same measure,
    route 1 two stages where they cost no wave. `registers` ({(kernel,
    route, var): registers per thread}, var the forward's instance or route
    1's NT, as the built library reports them) bounds the blocks per SM too.
    Above MAX_MOMENTS moments it plans the largest of :func:`moment_chunks`.
    Raises if nothing fits."""
    _check_dtype(compute_dtype)
    K = chunk_moments(K)
    bf16 = compute_dtype == "bfloat16"
    regs = registers or {}
    # -- forward
    groups = _groups(S, T, N, FWD_GROUP_STOCKS, sms, 4)
    tpg = -(-T // groups)
    route = 1 if bf16 and F <= MMA_MAX_F else 0
    if route == 0:
        cts = FWD_CTS[fwd_rt(K)]
        chunks = _pad(K, 4) // fwd_rt(K)
        ct = next((c for c in cts if S * chunks * -(-N // c) * groups
                   >= FWD_MIN_WARPS * 32 * sms), cts[-1])
    best = None
    for M in _member_counts(S):
        var = mma_nt(M, K) if route == 1 else ct
        q = 16 if route == 1 else 4
        mg = -(-S // M)
        stage_counts = FWD_STAGES if route == 1 else (FWD_CORES_STAGES,)
        for tile in range(q, _pad(N, q) + 1, q):
            threads, floats = fwd_geometry(route, M, F, K, tpg, tile, var,
                                           stage_counts[0])
            if threads > FWD_MAX_THREADS or 4 * floats > MAX_SMEM:
                break  # both grow with the tile
            grid = (-(-N // tile), groups, mg)
            per_sm = -(-(grid[0] * groups * mg) // sms)
            for ns in stage_counts:
                threads, floats = fwd_geometry(route, M, F, K, tpg, tile,
                                               var, ns)
                if 4 * floats > MAX_SMEM:
                    break
                bps = _resident(4 * floats, threads,
                                regs.get(("fwd", route, var), 0))
                if bps < 1:
                    continue
                key = (-(-per_sm // bps), per_sm * tile * M, -M, -tile, -ns)
                if best is None or key < best[0]:
                    best = (key, CemPlan("fwd", route, tile, M, threads, var,
                                         ns, 4 * floats, bps, groups, grid))
    if best is None:
        raise ValueError(f"cond_em_fwd: F = {F}, K = {K} at S = {S}, T = {T} "
                         "does not fit the kernel's shared memory")
    fwd = best[1]
    # -- backward
    groups = _groups(S, T, N, BWD_STOCKS, sms, 4)
    tpg = -(-T // groups)
    tiles = -(-N // BWD_STOCKS)
    route = 1 if bf16 and F <= MMA_MAX_F else 0
    best = None
    for M in _member_counts(S):
        for var in (8, 4) if route == 1 else (0, 1):
            for ns in BWD_STAGES if route == 1 else (1,):
                threads, floats = bwd_geometry(route, M, F, K, tpg, bf16, var,
                                               ns)
                limit = FWD_MAX_THREADS if route == 1 else BWD_MAX_THREADS
                if not 0 < threads <= limit or 4 * floats > MAX_SMEM:
                    continue
                inst = mma_nt(M, K) if route == 1 else var
                bps = _resident(4 * floats, threads,
                                regs.get(("bwd", route, inst), 0))
                if bps < 1:
                    continue
                grid = (-(-S // M), tiles, groups)
                per_sm = -(-(grid[0] * tiles * groups) // sms)
                # route 0 prefers the stock-major copy (var 0), route 1
                # the most warps per row group
                key = (-(-per_sm // bps), per_sm * M, -ns,
                       var if route == 0 else 0, -M, -var)
                if best is None or key < best[0]:
                    best = (key, CemPlan("bwd", route, BWD_STOCKS, M, threads,
                                         var, ns, 4 * floats, bps, groups,
                                         grid))
    if best is None:
        raise ValueError(f"cond_em_bwd: F = {F}, K = {K} at S = {S}, T = {T} "
                         "does not fit the kernel's shared memory")
    return CemPlans(fwd, best[1])


# csrc/cond_em.cu's panel cotangent: a persistent grid of G blocks walking
# (stock tile, period) cells, two panel tiles in flight. Route 0 (CUDA
# cores): phase A items of RT member-moments × 4 stocks, phase B items of
# DX_FEATURES features × 4 stocks, dealt out to the block's threads; route 1
# (bf16 tensor cores, F ≤ MMA_MAX_F): one warp per 16 stocks.
DX_STAGES = 2
DX_FEATURES = 6
DX_TILES = (32, 64, 96, 128)
DX_MMA_TILES = (32, 64, 128)
DX_MAX_THREADS = 512


@dataclasses.dataclass(frozen=True)
class CemDxPlan:
    """The panel cotangent's launch: route (0 CUDA cores, 1 bf16 tensor
    cores), stocks per cell, threads per block, the panel tiles in flight,
    shared memory per block, the resident blocks per SM that shared memory,
    threads and (where known) registers allow, and G persistent blocks over
    the T·⌈N/tile⌉ cells."""

    route: int
    tile: int
    threads: int
    stages: int
    smem_bytes: int
    blocks_per_sm: int
    G: int
    cells: int


def dx_route(F: int, compute_dtype: str) -> int:
    """Route 1 (bf16 on the tensor cores) where F ≤ MMA_MAX_F, else 0."""
    return 1 if compute_dtype == "bfloat16" and F <= MMA_MAX_F else 0


def dx_geometry(route: int, S: int, F: int, K: int, tile: int) -> int:
    """Shared-memory floats of the panel cotangent, as csrc/cond_em.cu's
    dx_geometry counts them. Route 0: kT [S][⌈F/6⌉·6][⌈K/4⌉·4], the panel
    tiles [2][F][tile], xr [2][S][tile], dpre [S·⌈K/4⌉·4][tile]. Route 1
    (words): kT twice in bf16, [RP][16·KS + 8] and [16·KS][RP + 8] with RP =
    ⌈S·K/16⌉·16 and KS = ⌈F/16⌉, the member of each of the RP rows, the
    panel tiles [2][16·KS][tile + 4], xr and the period's zp_m [2][RP]."""
    if route == 1:
        rp, ks = _pad(S * K, 16), -(-F // 16)
        return (rp * (8 * ks + 4) + 16 * ks * (rp // 2 + 4) + rp
                + DX_STAGES * (16 * ks * (tile + 4) + S * tile + rp))
    kp = _pad(K, 4)
    return (S * _pad(F, DX_FEATURES) * kp + DX_STAGES * (F + S) * tile
            + S * kp * tile)


def dx_balance(S: int, F: int, K: int, tile: int, threads: int) -> float:
    """Route 0's share of a block's thread-time that does work: phase A's
    items (RT·4·F FMAs each) and phase B's (DX_FEATURES·4·S·⌈K/4⌉·4) are
    dealt out in rounds of `threads`."""
    kp, rt, spt = _pad(K, 4), fwd_rt(K), tile // 4
    items = ((S * (kp // rt) * spt, 4 * rt * F),
             (-(-F // DX_FEATURES) * spt, 4 * DX_FEATURES * S * kp))
    work = sum(n * w for n, w in items)
    return work / (threads * sum(-(-n // threads) * w for n, w in items))


def cem_dx_plan(S: int, T: int, N: int, F: int, K: int, sms: int,
                compute_dtype: str = "float32",
                registers: Optional[Dict[int, int]] = None,
                tile: Optional[int] = None) -> CemDxPlan:
    """The panel cotangent's launch plan on a card of `sms` SMs.

    Of the stock tiles (and, on route 0, block sizes of whole warps up to
    the larger phase's items) whose shared memory fits, the one that keeps
    the most threads busy per SM: blocks × threads, × the share of the last
    round of cells that G = min(cells, blocks · sms) blocks fill, × on
    route 0 :func:`dx_balance`, taken to two significant figures (the
    balance is no finer); then more blocks (one block's barriers are
    hidden by the others), then the larger tile, then fewer threads.
    `registers` ({route: registers per thread}, as the built library
    reports them) bounds the blocks per SM too; `tile` forces one stock
    tile. Above MAX_MOMENTS moments it plans the largest of
    :func:`moment_chunks`. Raises if nothing fits, naming what refused:
    the shared memory, the threads or the registers."""
    _check_dtype(compute_dtype)
    K = chunk_moments(K)
    route = dx_route(F, compute_dtype)
    regs = (registers or {}).get(route, 0)
    best = None
    refused = set()
    # block sizes of whole warps from 64 up to the larger phase's items;
    # only where no tile has one, from one warp (one member's few items)
    for low in (64, 32):
        for bn in (tile,) if tile else DX_MMA_TILES if route else DX_TILES:
            if bn % (16 if route else 4):
                refused.add(f"the stock tile {bn}")
                continue
            if route:
                counts = (2 * bn,)
            else:
                most = max(S * (_pad(K, 4) // fwd_rt(K)),
                           -(-F // DX_FEATURES))
                counts = range(low, min(DX_MAX_THREADS,
                                        _pad(most * bn // 4, 32)) + 1, 32)
                if not counts:
                    refused.add(f"the threads (the items fill fewer than "
                                f"{low})")
            smem = 4 * dx_geometry(route, S, F, K, bn)
            if smem > MAX_SMEM:
                refused.add(f"the shared memory ({smem} B > {MAX_SMEM} B)")
                continue
            cells = T * -(-N // bn)
            for threads in counts:
                blocks = _resident(smem, threads, regs)
                if blocks < 1:
                    refused.add(f"the registers ({regs} a thread at "
                                f"{threads} threads)")
                    continue
                G = min(cells, blocks * sms)
                fill = cells / (G * -(-cells // G))
                busy = blocks * threads * fill
                if route:
                    busy = round(busy, 6)
                else:  # to two significant figures: the balance is no finer
                    busy = float(
                        f"{busy * dx_balance(S, F, K, bn, threads):.2g}")
                key = (busy, blocks, bn, -threads)
                if best is None or key > best[0]:
                    best = (key, CemDxPlan(route, bn, threads, DX_STAGES,
                                           smem, blocks, G, cells))
        if best is not None or route:
            break
    if best is None:
        raise ValueError(f"cond_em_dx: F = {F}, K = {K} at S = {S} has no "
                         "launch plan" + (f" at tile {tile}" if tile else "")
                         + ": refused by " + ", ".join(sorted(refused)))
    return best[1]


_regs: Dict[tuple, Dict[tuple, int]] = {}
_plans: Dict[tuple, CemPlans] = {}
_dx_regs: Dict[tuple, Dict[int, int]] = {}
_dx_plans: Dict[tuple, CemDxPlan] = {}


def card_cem_plan(dev, S: int, T: int, N: int, F: int, K: int,
                  compute_dtype: str, xb16: bool = False) -> CemPlans:
    """:func:`cem_plan` for the card `dev`: its SM count, and the registers
    of the library's kernel instances at (F, K, dtype), on a bf16 panel
    (their bf16-panel instances) with `xb16`; kept per shape. Each plan is
    checked on the card once, before its first launch (:func:`plan_info`):
    one that the kernel refuses, or whose blocks the card does not keep
    resident, raises. Above MAX_MOMENTS moments it plans the largest
    chunk."""
    K = chunk_moments(K)
    key = (dev, S, T, N, F, K, compute_dtype, bool(xb16))
    plans = _plans.get(key)
    if plans is None:
        bf16 = int(compute_dtype == "bfloat16")
        rkey = (F, K, bf16, bool(xb16))
        if rkey not in _regs:
            lib = _load(xb16)
            inst = [("fwd", 0, v) for v in FWD_CTS[fwd_rt(K)]] + [
                ("bwd", 0, 0), ("bwd", 0, 1)]
            if bf16 and F <= MMA_MAX_F:
                inst += [(k, 1, v) for k in ("fwd", "bwd") for v in (1, 2, 3)]
            got = {i: lib.cond_em_registers(int(i[0] == "bwd"), F, K, bf16,
                                            i[1], i[2], int(xb16))
                   for i in inst}
            _regs[rkey] = {i: r for i, r in got.items() if r > 0}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plans = cem_plan(S, T, N, F, K, sms, compute_dtype, _regs[rkey])
        with torch.cuda.device(dev):
            for p in plans:
                held = plan_info(p, S, T, N, F, K, compute_dtype, xb16)
                if held["blocks_per_sm"] < p.blocks_per_sm:
                    raise RuntimeError(
                        f"cond_em_{p.kernel}: the card keeps "
                        f"{held['blocks_per_sm']} blocks per SM of the plan "
                        f"{p}")
        _plans[key] = plans
    return plans


def plan_info(plan: CemPlan, S: int, T: int, N: int, F: int, K: int,
              compute_dtype: str, xb16: bool = False) -> Dict[str, int]:
    """What the card makes of `plan` (the current CUDA device): resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers and local-memory bytes per thread of the kernel it launches.
    Raises for a plan the kernel refuses. K above MAX_MOMENTS reads as its
    largest chunk."""
    K = chunk_moments(K)
    out = (ctypes.c_int * 3)()
    rc = _load(xb16).cond_em_plan_info(
        int(plan.kernel == "bwd"), S, T, F, N, K, plan.groups,
        int(compute_dtype == "bfloat16"), plan.route, plan.tile,
        plan.members, plan.threads, plan.var, plan.stages, plan.smem_bytes,
        int(xb16), out)
    if rc != 0:
        raise RuntimeError(f"cond_em_{plan.kernel} refused the plan {plan} "
                           f"(code {rc})")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


def card_cem_dx_plan(dev, S: int, T: int, N: int, F: int, K: int,
                     compute_dtype: str, tile: Optional[int] = None,
                     xb16: bool = False) -> CemDxPlan:
    """:func:`cem_dx_plan` for the card `dev`: its SM count, and the
    registers of the library's kernel instance at (F, K, dtype); kept per
    shape. Each plan is checked on the card once, before its first launch
    (:func:`dx_plan_info`): one that the kernel refuses, or whose blocks the
    card does not keep resident, raises. Above MAX_MOMENTS moments it plans
    the largest chunk."""
    K = chunk_moments(K)
    key = (dev, S, T, N, F, K, compute_dtype, tile, bool(xb16))
    plan = _dx_plans.get(key)
    if plan is None:
        bf16 = int(compute_dtype == "bfloat16")
        route = dx_route(F, compute_dtype)
        rkey = (F, K, bf16, bool(xb16))
        if rkey not in _dx_regs:
            r = _load(xb16).cond_em_registers(2, F, K, bf16, route, 0,
                                              int(xb16))
            _dx_regs[rkey] = {route: r} if r > 0 else {}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = cem_dx_plan(S, T, N, F, K, sms, compute_dtype, _dx_regs[rkey],
                           tile)
        with torch.cuda.device(dev):
            held = dx_plan_info(plan, S, T, N, F, K, compute_dtype, xb16)
        if held["blocks_per_sm"] < plan.blocks_per_sm:
            raise RuntimeError(f"cond_em_dx: the card keeps "
                               f"{held['blocks_per_sm']} blocks per SM of "
                               f"the plan {plan}")
        _dx_plans[key] = plan
    return plan


def dx_plan_info(plan: CemDxPlan, S: int, T: int, N: int, F: int, K: int,
                 compute_dtype: str, xb16: bool = False) -> Dict[str, int]:
    """What the card makes of the panel cotangent's `plan` (the current CUDA
    device), as :func:`plan_info` reports it. Raises for a plan the kernel
    refuses. K above MAX_MOMENTS reads as its largest chunk."""
    K = chunk_moments(K)
    out = (ctypes.c_int * 3)()
    rc = _load(xb16).cond_em_dx_plan_info(
        S, T, F, N, K, int(compute_dtype == "bfloat16"), plan.route,
        plan.tile, plan.threads, plan.G, plan.smem_bytes, int(xb16), out)
    if rc != 0:
        raise RuntimeError(f"cond_em_dx refused the plan {plan} (code {rc})")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


def _checked(x_t, zp_m, xr, tinv, kT):
    T, F, N = x_t.shape
    S, K, _ = kT.shape
    if K > MAX_MOMENTS:
        raise ValueError(f"cond_em: at most {MAX_MOMENTS} moments; got {K}")
    dev = x_t.device
    for name, t, shape in (("x_t", x_t, (T, F, N)), ("zp_m", zp_m, (S, T, K)),
                           ("xr", xr, (S, T, N)), ("tinv", tinv, (N,)),
                           ("kT", kT, (S, K, F))):
        dtypes = PANEL_DTYPES if name == "x_t" else (torch.float32,)
        if (t.device != dev or t.dtype not in dtypes
                or not t.is_contiguous() or tuple(t.shape) != shape):
            kinds = " or ".join(str(d).split(".")[-1] for d in dtypes)
            raise ValueError(
                f"cond_em: {name} must be a contiguous {kinds} {list(shape)}"
                f" tensor on {dev}; got {t.dtype} {list(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    return S, T, F, N, K, dev


def _refused(kernel: str, rc: int, plan: CemPlan) -> None:
    if rc == -1:
        raise RuntimeError(f"cond_em_{kernel} refused the plan {plan}")
    _raise_rc(f"cond_em_{kernel}", rc)


def _launch_fwd_chunk(x_t, zp_m, xr, tinv, kT, compute_dtype):
    """em [S, K, N] of one launch (K ≤ MAX_MOMENTS). The kernels round kT to the compute dtype themselves
    (route 1 as it builds its fragments), so no PyTorch op runs before the
    launch."""
    kT = kT.contiguous()
    S, T, F, N, K, dev = _checked(x_t, zp_m, xr, tinv, kT)
    plan = card_cem_plan(dev, S, T, N, F, K, compute_dtype, is_bf16(x_t)).fwd
    em_part = torch.empty((S, plan.groups, K, N), dtype=torch.float32,
                          device=dev)
    lib = _load(is_bf16(x_t))
    with torch.cuda.device(dev):
        rc = lib.cond_em_fwd(
            *_panel_args(x_t), zp_m.data_ptr(), xr.data_ptr(), tinv.data_ptr(),
            kT.data_ptr(), em_part.data_ptr(), S, T, F, N, K, plan.groups,
            int(compute_dtype == "bfloat16"), plan.route, plan.tile,
            plan.members, plan.threads, plan.var, plan.stages,
            plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    _refused("fwd", rc, plan)
    panel_launch("cond_em_fwd", x_t)
    return em_part.sum(dim=1)  # the fixed-order pass over the period groups


def _launch_bwd_chunk(x_t, zp_m, xr, tinv, kT, gem, compute_dtype):
    """(dkT, dzp_m, dxr) of one launch (K ≤ MAX_MOMENTS), kT rounded in the
    kernels as in the forward."""
    kT = kT.contiguous()
    S, T, F, N, K, dev = _checked(x_t, zp_m, xr, tinv, kT)
    gem = gem.float().contiguous()
    if tuple(gem.shape) != (S, K, N):
        raise ValueError(f"cond_em: gem must be {[S, K, N]}; got "
                         f"{list(gem.shape)}")
    plan = card_cem_plan(dev, S, T, N, F, K, compute_dtype, is_bf16(x_t)).bwd
    tiles, groups = plan.grid[1], plan.groups
    dkT_part = torch.empty((S, groups * tiles, K, F), dtype=torch.float32,
                           device=dev)
    dzpm_part = torch.empty((S, tiles, T, K), dtype=torch.float32,
                            device=dev)
    dxr = torch.empty((S, T, N), dtype=torch.float32, device=dev)
    lib = _load(is_bf16(x_t))
    with torch.cuda.device(dev):
        rc = lib.cond_em_bwd(
            *_panel_args(x_t), zp_m.data_ptr(), xr.data_ptr(), tinv.data_ptr(),
            kT.data_ptr(), gem.data_ptr(), dkT_part.data_ptr(),
            dzpm_part.data_ptr(), dxr.data_ptr(), S, T, F, N, K, groups,
            int(compute_dtype == "bfloat16"), plan.route, plan.members,
            plan.threads, plan.var, plan.stages, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    _refused("bwd", rc, plan)
    panel_launch("cond_em_bwd", x_t)
    return dkT_part.sum(dim=1), dzpm_part.sum(dim=1), dxr


def _launch_dx_chunk(x_t, zp_m, xr, tinv, kT, gem, compute_dtype,
                     plan: Optional[CemDxPlan] = None):
    """The panel cotangent dx [T, F, N] of one launch (K ≤ MAX_MOMENTS) in
    the panel's dtype, summed over the members; `plan` defaults to
    :func:`card_cem_dx_plan` for this card."""
    kT = _round(kT, compute_dtype).contiguous()
    S, T, F, N, K, dev = _checked(x_t, zp_m, xr, tinv, kT)
    gem = gem.float().contiguous()
    if tuple(gem.shape) != (S, K, N):
        raise ValueError(f"cond_em: gem must be {[S, K, N]}; got "
                         f"{list(gem.shape)}")
    if plan is None:
        plan = card_cem_dx_plan(dev, S, T, N, F, K, compute_dtype,
                                xb16=is_bf16(x_t))
    # in the panel's dtype: a bf16 dx is rounded once, in the kernel
    dx = torch.empty((T, F, N), dtype=x_t.dtype, device=dev)
    lib = _load(is_bf16(x_t))
    with torch.cuda.device(dev):
        rc = lib.cond_em_dx(
            *_panel_args(x_t), zp_m.data_ptr(), xr.data_ptr(), tinv.data_ptr(),
            kT.data_ptr(), gem.data_ptr(), dx.data_ptr(), S, T, F, N, K,
            int(compute_dtype == "bfloat16"), plan.route, plan.tile,
            plan.threads, plan.G, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc == -1:
        raise RuntimeError(f"cond_em_dx refused the plan {plan}")
    _raise_rc("cond_em_dx", rc)
    panel_launch("cond_em_dx", x_t)
    return dx


# -- moment chunks ----------------------------------------------------------------


def _moment_slice(t: torch.Tensor, dim: int, a: int, b: int) -> torch.Tensor:
    return t.narrow(dim, a, b - a).contiguous()


def chunked_fwd(fn, x_t, zp_m, xr, tinv, kT, compute_dtype):
    """em [S, K, N] from `fn` (a launch, or the plain version) over
    :func:`moment_chunks`: each chunk's em rows; one call where K ≤
    MAX_MOMENTS."""
    chunks = moment_chunks(kT.shape[1])
    if len(chunks) == 1:
        return fn(x_t, zp_m, xr, tinv, kT, compute_dtype)
    return torch.cat([fn(x_t, _moment_slice(zp_m, 2, a, b), xr, tinv,
                         _moment_slice(kT, 1, a, b), compute_dtype)
                      for a, b in chunks], dim=1)


def chunked_bwd(fn, x_t, zp_m, xr, tinv, kT, gem, compute_dtype):
    """(dkT, dzp_m, dxr) from `fn` over :func:`moment_chunks`: dkT rows and
    dzp_m columns per chunk, dxr summed over the chunks in f32, in chunk
    order."""
    chunks = moment_chunks(kT.shape[1])
    if len(chunks) == 1:
        return fn(x_t, zp_m, xr, tinv, kT, gem, compute_dtype)
    dkT, dzpm, dxr = [], [], None
    for a, b in chunks:
        k, z, r = fn(x_t, _moment_slice(zp_m, 2, a, b), xr, tinv,
                     _moment_slice(kT, 1, a, b), _moment_slice(gem, 1, a, b),
                     compute_dtype)
        dkT.append(k)
        dzpm.append(z)
        dxr = r if dxr is None else dxr + r
    return torch.cat(dkT, dim=1), torch.cat(dzpm, dim=2), dxr


def chunked_dx(fn, x_t, zp_m, xr, tinv, kT, gem, compute_dtype):
    """The panel cotangent from `fn` over :func:`moment_chunks`: each
    chunk's on the panel widened to f32 (an f32 cotangent, computed as on
    the bf16 panel), summed in f32 in chunk order and rounded once to the
    panel's dtype."""
    chunks = moment_chunks(kT.shape[1])
    if len(chunks) == 1:
        return fn(x_t, zp_m, xr, tinv, kT, gem, compute_dtype)
    x32 = x_t.float()
    dx = None
    for a, b in chunks:
        d = fn(x32, _moment_slice(zp_m, 2, a, b), xr, tinv,
               _moment_slice(kT, 1, a, b), _moment_slice(gem, 1, a, b),
               compute_dtype)
        dx = d if dx is None else dx + d
    return dx.to(x_t.dtype)


def _launch_fwd(x_t, zp_m, xr, tinv, kT, compute_dtype):
    """em [S, K, N]: one launch, or one a moment chunk above MAX_MOMENTS."""
    return chunked_fwd(_launch_fwd_chunk, x_t, zp_m, xr, tinv, kT,
                       compute_dtype)


def _launch_bwd(x_t, zp_m, xr, tinv, kT, gem, compute_dtype):
    """(dkT, dzp_m, dxr): one launch, or one a moment chunk."""
    return chunked_bwd(_launch_bwd_chunk, x_t, zp_m, xr, tinv, kT, gem,
                       compute_dtype)


def _launch_dx(x_t, zp_m, xr, tinv, kT, gem, compute_dtype,
               plan: Optional[CemDxPlan] = None):
    """The panel cotangent dx [T, F, N] in the panel's dtype: one launch
    (at `plan`, :func:`card_cem_dx_plan` by default), or one a moment chunk
    (each at its own card plan)."""
    if plan is not None:
        return _launch_dx_chunk(x_t, zp_m, xr, tinv, kT, gem, compute_dtype,
                                plan)
    return chunked_dx(_launch_dx_chunk, x_t, zp_m, xr, tinv, kT, gem,
                      compute_dtype)


class _CondEm(torch.autograd.Function):
    """Forward: the fwd kernel (or its plain version); backward: the dx
    kernel for the panel and the bwd kernel for zp_m, xr and k_stock, each
    only when one of its inputs needs a gradient."""

    @staticmethod
    def forward(ctx, meta, x_t, zp_m, xr, tinv, kT):
        route, cd = meta
        ctx.meta = meta
        if route == "plain":
            em = cond_em_reference(x_t, zp_m, xr, tinv, kT, cd)
        else:
            em = _launch_fwd(x_t, zp_m, xr, tinv, kT, cd)
        ctx.save_for_backward(x_t, zp_m, xr, tinv, kT, em)
        return em

    @staticmethod
    def backward(ctx, gem):
        route, cd = ctx.meta
        x_t, zp_m, xr, tinv, kT, em = ctx.saved_tensors
        need = ctx.needs_input_grad  # (meta, x_t, zp_m, xr, tinv, kT)
        gem = gem.float().contiguous()
        dx = dzpm = dxr = d_tinv = dkT = None
        if need[1]:
            dx = (cond_em_dx_reference if route == "plain" else _launch_dx)(
                x_t, zp_m, xr, tinv, kT, gem, cd)
        if need[2] or need[3] or need[5]:
            dkT, dzpm, dxr = (cond_em_bwd_reference if route == "plain"
                              else _launch_bwd)(x_t, zp_m, xr, tinv, kT,
                                                gem, cd)
            dzpm, dxr, dkT = (d if n else None for d, n in zip(
                (dzpm, dxr, dkT), (need[2], need[3], need[5])))
        if need[4]:
            # exact from the saved accumulator: em = tinv·Σ_t h·xr, so
            # dL/dtinv[n] = Σ_k gem·em / tinv (tinv ≥ 1/T > 0)
            d_tinv = ((gem * em).sum(dim=1) / tinv).sum(dim=0)
        return None, dx, dzpm, dxr, d_tinv, dkT


def fused_conditional_em(x_t: torch.Tensor, zp_m: torch.Tensor,
                         xr: torch.Tensor, tinv: torch.Tensor,
                         k_stock: torch.Tensor, *,
                         compute_dtype: str = "bfloat16",
                         kernel: str = "auto") -> torch.Tensor:
    """em [K, N], with the JAX signature: x_t [T, F, N], zp_m [T, K],
    xr [T, N], tinv [N], k_stock [F, K]. With a leading member axis on
    zp_m [S, T, K], xr [S, T, N] and k_stock [S, F, K] it returns
    em [S, K, N]. Differentiable with respect to the panel x_t (float32 or
    bfloat16; its gradient, summed over the members, which share it, comes
    back in its dtype), zp_m, xr, k_stock and tinv."""
    _check_dtype(compute_dtype)
    check_panel_dtype(x_t, "cond_em")
    single = zp_m.dim() == 2
    if single:
        zp_m, xr, k_stock = zp_m[None], xr[None], k_stock[None]
    meta = (_route(x_t, kernel), compute_dtype)
    em = _CondEm.apply(meta, x_t, zp_m.contiguous(), xr.contiguous(),
                       tinv.contiguous(), k_stock.transpose(1, 2).contiguous())
    return em[0] if single else em


# -- the bounds -----------------------------------------------------------------


def fwd_flops(S: int, T: int, N: int, F: int, K: int) -> int:
    """2·K·F multiply-adds per (member, period, stock) plus the K-wide
    contraction (tanh not counted)."""
    return 2 * S * T * N * K * (F + 1)


def fwd_bytes_moved(S: int, T: int, N: int, F: int, K: int,
                    x_bytes: int = 4) -> int:
    """The panel (`x_bytes` a value: 4 in f32, 2 in bf16), zp_m, xr, tinv
    and kT read once, em written once (f32)."""
    return (x_bytes * T * F * N
            + 4 * (S * T * K + S * T * N + N + S * K * F + S * K * N))


def bwd_flops(S: int, T: int, N: int, F: int, K: int) -> int:
    """The recomputed pre-activation and dkT (2·K·F each), plus dpre, dxr
    and dzp_m (about 4·K) per (member, period, stock)."""
    return 2 * S * T * N * K * (2 * F + 2)


def bwd_bytes_moved(S: int, T: int, N: int, F: int, K: int,
                    x_bytes: int = 4) -> int:
    """The forward's inputs (the panel at `x_bytes` a value) and gem read
    once; dkT, dzp_m and dxr written once (f32)."""
    return (x_bytes * T * F * N
            + 4 * (2 * S * T * K + 2 * S * T * N + N + 2 * S * K * F
                   + S * K * N))



def dx_flops(S: int, T: int, N: int, F: int, K: int) -> int:
    """The recomputed pre-activation and dx (2·K·F each), plus dpre (about
    4·K) per (member, period, stock)."""
    return 2 * S * T * N * K * (2 * F + 2)


def dx_bytes_moved(S: int, T: int, N: int, F: int, K: int,
                   x_bytes: int = 4) -> int:
    """The forward's inputs and gem read once; dx [T, F, N] written once,
    in the panel's dtype (`x_bytes` a value)."""
    return (2 * x_bytes * T * F * N
            + 4 * (S * T * K + S * T * N + N + S * K * F + S * K * N))
