"""Fused SDF-FFN: the panel MLP of every ensemble member, forward, recompute
backward and panel cotangent, one launch each.

The counterpart of the JAX package's ``ops/pallas_ffn.py``
(``fused_sdf_ffn``; Pallas kernels ``_fwd_kernel``/``_fwd_kernel_members``,
``_bwd_kernel``/``_bwd_kernel_members`` and ``_dx_kernel``). For member s,
period t and stock n::

    w[s,t,n] = kout_s . drop(relu(W_L,s ... drop(relu(K1_s^T x[t,:,n] + zp[s,t])) ... + b)) + bout_s

over the feature-major panel ``x_t [T, F, N]``. The member axis is explicit
(S = 1 is the single-model call), so an ensemble is one launch over one
panel read. Masking, zero-mean and normalization stay in plain PyTorch, as
they are plain XLA in the JAX package.

Two routes compute the same functions:

* plain PyTorch: :func:`sdf_ffn_reference`, :func:`sdf_ffn_bwd_reference`
  and :func:`sdf_ffn_dx_reference`, with the same bf16 operand rounding
  and the same dropout bits as the kernels. A CPU tensor runs them, and
  the tests and ``chip_smoke.py`` hold the kernels against them.
* the CUDA kernels ``csrc/sdf_ffn.cu`` (forward), ``csrc/sdf_ffn_bwd.cu``
  (backward) and ``csrc/sdf_ffn_dx.cu`` (panel cotangent), ``sm_90a``, built
  with ``nvcc`` at first use and bound through ``ctypes``. A CUDA tensor
  always goes through them; a build, plan or launch failure raises. These
  resident kernels hold a member's whole stack in shared memory (at most
  MAX_HIDDEN_LAYERS layers of padded width ≤ 128); every stack they cannot
  hold takes the streamed-weight route of all three, ``csrc/sdf_ffn_stream.cu``
  (one layer at a time, weights streamed through shared memory in slabs;
  :data:`STREAM_ROUTES`), up to STREAM_MAX_WIDTH, STREAM_MAX_LAYERS and
  STREAM_MAX_F. Each plan function picks the route: a shape the resident
  route plans keeps its plan.

:func:`sdf_ffn` is the differentiable entry (a ``torch.autograd.Function``
whose backward is ``sdf_ffn_dx`` for the panel and ``sdf_ffn_bwd`` for
everything else, each launched only when asked for);
:func:`sdf_ffn_packed` is the serving path's forward over weights packed
once.

``compute_dtype="bfloat16"`` rounds both operands of every product to bf16
and accumulates in f32 (``pallas_ffn._dot``); biases stay f32.

The panel x_t is float32 or bfloat16 (:data:`PANEL_DTYPES`; the bf16
panel is ``ExecutionConfig.bf16_panel``'s, the JAX package's default on
the kernel route), and no other dtype is taken. Every kernel widens a bf16
panel exactly into its f32 form (``csrc/panel.cuh``), and every plain
version computes on ``x_t.float()``, so either route on a bf16 panel is
that route on the f32 panel ``x.bfloat16().float()``; the panel cotangent
comes back in the panel's dtype, summed in f32 and rounded once (round to
nearest even), as the JAX kernel's ``.astype(dx_ref.dtype)``.

Dropout (training) is a counter-based hash of (member base, period,
stock, layer, unit), applied after the ReLU of every hidden layer: keep iff
the bits are ≥ round(rate·2³²), kept values scaled by 1/(1 − rate). The
mask does not depend on how the kernel tiles the stocks; it is not the JAX
kernel's TPU PRNG stream. ``seed`` is one int or one int per member: with
S seeds, member s draws exactly the masks of a one-member call with
``seeds[s]`` (as the JAX member kernels seed each member from its own
``seed_ref[s]``), so a member-fused ensemble trains like S serial runs; one
int gives member s the base of (seed, s).

The stock in the hash is the GLOBAL stock index: every entry takes an
``offset``, the global index of the panel's first stock (0 unsharded), and
stock n of the call hashes as offset + n. A rank of a stock-sharded run
passes its span's start, so its masks are exactly the unsharded run's
masks over its span, and the sharded run with dropout is the unsharded one
up to summation order. (The JAX sharded wrapper instead folds the rank into
the seed, ``seed + idx · 40507``; its masks come from the TPU PRNG and are
not the port's in any case. Keying on the global index keeps one hash for
the forward, the backward and the panel cotangent, whatever the sharding.)
At offset 0 every route computes what it did before the offset existed.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import (BF16_PANEL, STREAM, STREAM_MMA, STREAM_TILED, _nvcc,
               count_launch, launch_total, reset_launch_counts)

COMPUTE_DTYPES = ("float32", "bfloat16")
PANEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_HIDDEN_LAYERS = 8  # the resident kernels' (csrc/sdf_ffn_common.cuh)
WIDTH_BOUNDS = (32, 64, 128)  # one library per bound on the padded width
MAX_SMEM = 227 * 1024  # shared memory one block may use (bytes)
# the card's SM (H100): shared memory, of which each resident block also
# takes 1 KB for itself, and its thread and block limits
SM_SMEM = 228 * 1024
BLOCK_SMEM_RESERVED = 1024
SM_MAX_THREADS = 2048
SM_MAX_BLOCKS = 32
SM_REGS = 65536
REG_ALLOC_UNIT = 256  # a warp's registers come in units of 256
# the backward's stock tiles (= threads per block), its register-tile
# instances (4 × 4 tiles per thread; none in the w128 library) and its
# 4-wide register tiles per thread (csrc/sdf_ffn_bwd.cu)
BWD_TILES = (128, 96, 64, 32)
BWD_REG_TILES = (4, 6)
BWD_VEC_TILES = 4
# the forward's routes (csrc/sdf_ffn.cu): f32 register tiles on the CUDA
# cores at these stock tiles and block sizes; bf16 mma.sync on the tensor
# cores, 8 warps of 16 stocks per 128-stock tile, times 1 or 2 member
# phases (256 or 512 threads; 256 only in the w128 library)
FWD_ROUTES = {"float32": 0, "bfloat16": 1}
FWD_TILES = (32, 64, 128)
FWD_THREADS = (128, 256)
MMA_TILE = 128
# the panel cotangent's routes (csrc/sdf_ffn_dx.cu) at these stock tiles: 0,
# register tiles of 8 units × 4 stocks on the CUDA cores (dx's of
# DX_FEATURES features × 4 stocks; f32, and bf16 operands where pad16(F) >
# DX_MMA_MAX_F), at these block sizes; 1, bf16, the layers below the top on
# the CUDA cores and the rest on mma.sync, one warp per 16 stocks (threads
# = 2 · tile)
DX_TILES = (32, 64, 128)
DX_THREADS = (64, 128, 256)
DX_FEATURES = 6
DX_MMA_MAX_F = 64
# the streamed-weight route (csrc/sdf_ffn_stream.cu), for every stack the
# resident kernels cannot hold: its route number by compute dtype (in
# every plan's `route`), 256 threads a block, stock tiles (each thread 4
# units × 4 stocks of a layer pass), the slab depth the tile rows pad to,
# the limits it plans to (twice the reach its plan tests hold: widths
# 1,024, 32 layers, F 512), and the global memory it may take a launch for
# tile activations (where they do not fit shared memory) and for the
# backward's per-block gradient partials
STREAM_ROUTES = {"float32": 2, "bfloat16": 3}
STREAM_THREADS = 256
STREAM_TILES = (16, 32, 64)
STREAM_SLAB = 16
STREAM_MAX_WIDTH = 2048
STREAM_MAX_LAYERS = 64
STREAM_MAX_F = 1024
STREAM_SCRATCH_BYTES = 2 << 30
STREAM_GRAD_BYTES = 2 << 30
# its tensor-core route under bf16 compute (csrc/sdf_ffn_stream.cu
# fwd_stream_mma_kernel, bwd_stream_mma_kernel, dx_stream_mma_kernel): bf16
# tiles in shared memory only, at these stock tiles (each warp 64 units × 32
# stocks of mma.sync), weight slabs of STREAM_MMA_SLAB inputs from a bf16
# copy of the weights (stream_mma_weights) in a ring of STREAM_MMA_STAGES,
# and STREAM_MMA_RED floats of cross-warp sums. A stack whose bf16 tiles do
# not fit shared memory keeps route 3, and so does one deeper than
# STREAM_MMA_MAX_LAYERS: there the bf16 gradient is chaotic in the
# accumulation order (each layer's bf16 roundings flip with the last bits of
# its sums and the flips cascade down the stack), so it moves by the plain
# route's own distance from an exact (f64) evaluation, up to 1.5e-2 of
# max|ref| at 6 layers and 2.7e-2 at 12 (tools/stream_mma_accuracy.py),
# while route 3's per-element FMA order is the plain route's. The panel
# cotangent's route 4 decides every ReLU as route 3 does: the layers below
# the top run route 3's chains on the CUDA cores, and the top layer's
# decisions on mma.sync are certified (stream_certify_window)
STREAM_MMA_ROUTE = 4
STREAM_MMA_MAX_LAYERS = 4
STREAM_MMA_KERNELS = ("fwd", "bwd", "dx")
STREAM_MMA_TILES = (32, 64, 128)
STREAM_MMA_SLAB = 32
STREAM_MMA_STAGES = 3
STREAM_MMA_RED = 512
# route 4's dx recomputes a top-layer pre-activation h as route 3's exact
# chain where |h| ≤ window·(max|a|·Σ_k|W_uk| + |b_u|), the window
# STREAM_CERTIFY per started STREAM_CERTIFY_DEPTH inputs of the top layer
# (csrc/sdf_ffn_stream.cu kCertify, kCertifyDepth: sdf_ffn_dx.cu route 1's
# 2^-16 at 64 inputs, grown with the sum's depth)
STREAM_CERTIFY = 2.0 ** -16
STREAM_CERTIFY_DEPTH = 64
# its register-tiled route under f32 compute (csrc/sdf_ffn_stream.cu
# fwd_stream_tiled_kernel, bwd_stream_tiled_kernel, dx_stream_tiled_kernel):
# route 2's values bit for bit on the same plan (the dx at any plan), blocks
# of STREAM_TILED_THREADS threads, each 8 units × tile/16 stocks of a layer
# pass of STREAM_TILED_PASS units, weight slabs of STREAM_SLAB inputs in a
# ring of STREAM_TILED_STAGES (each slab [STREAM_TILED_PASS][STREAM_SLAB + 4]
# floats at most), the f32 tile in shared memory only, the backward's and
# the dx's dh_pre written over each layer's activations (the dx's K1 product
# on a map of its own where pad16(F) ≤ 64). Planned wherever its tile fits,
# else route 2, but for the forward and the panel cotangent of a stack whose
# layers are at most STREAM_TILED_NARROW units wide where route 2 takes tile
# 64: route 2's pass (4096 / tile units) is full there and route 5's a
# quarter used. chip_smoke.py's turns put that boundary: route 2's forward
# ~1.9× faster at 12 × 64 and (64, 64, 64) F = 512, and its dx ~1.3× at
# (64, 64) F = 256; route 5's faster at 96 units and at 64 units where
# route 2 takes tile 32 (the forward at (64, 64) F = 1024, the dx at 12 and
# 16 × 64), and route 5's backward faster at every streamed stack timed
STREAM_TILED_ROUTE = 5
STREAM_TILED_THREADS = 512
STREAM_TILED_TILES = (32, 64)
STREAM_TILED_PASS = 256
STREAM_TILED_STAGES = 3
STREAM_TILED_NARROW = 64

# launches of the CUDA kernels, counted per device where the wrapper
# launches them and nowhere else (ops.count_launch; reset_launch_count()
# before a run, read them after): these module totals sum the devices
_TOTALS = {"launches": "sdf_ffn_fwd",
           "bwd_launches": "sdf_ffn_bwd",
           "dx_launches": "sdf_ffn_dx"}
# and those of the bf16-panel forms and of the streamed route alone
# (subsets of the above)
_TOTALS.update({k + form: v + form for form in (BF16_PANEL, STREAM)
                for k, v in list(_TOTALS.items())})
# and those of the streamed route's tensor-core form (a subset of _stream)
_TOTALS.update({"launches" + STREAM_MMA: "sdf_ffn_fwd" + STREAM_MMA,
                "bwd_launches" + STREAM_MMA: "sdf_ffn_bwd" + STREAM_MMA,
                "dx_launches" + STREAM_MMA: "sdf_ffn_dx" + STREAM_MMA})
# and those of its register-tiled form (f32 compute; a subset of _stream)
_TOTALS.update({"launches" + STREAM_TILED: "sdf_ffn_fwd" + STREAM_TILED,
                "bwd_launches" + STREAM_TILED: "sdf_ffn_bwd" + STREAM_TILED,
                "dx_launches" + STREAM_TILED: "sdf_ffn_dx" + STREAM_TILED})

_libs: Dict[Tuple[str, int], ctypes.CDLL] = {}
_lib_lock = threading.Lock()

Mids = Sequence[Tuple[torch.Tensor, torch.Tensor]]
Seed = Union[int, Sequence[int]]


def __getattr__(name: str) -> int:
    if name in _TOTALS:
        return launch_total(_TOTALS[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launch_count() -> None:
    reset_launch_counts(_TOTALS.values())


def _round(a: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """An operand as the products see it: bf16-rounded (round to nearest
    even), kept in f32 so the accumulation stays f32."""
    if compute_dtype == "bfloat16":
        return a.to(torch.bfloat16).to(torch.float32)
    return a


def check_panel_dtype(x_t: torch.Tensor, who: str = "sdf_ffn") -> None:
    """Refuse a panel dtype the kernels do not take (never convert it)."""
    if x_t.dtype not in PANEL_DTYPES:
        raise ValueError(f"{who}: the panel x_t must be float32 or bfloat16;"
                         f" got {x_t.dtype}")


def panel_launch(kernel: str, x_t: torch.Tensor) -> None:
    """Count one launch of `kernel` on x_t's device and, on a bf16 panel,
    one of its bf16-panel form (``<kernel>_bf16_panel``)."""
    count_launch(kernel, x_t.device)
    if x_t.dtype == torch.bfloat16:
        count_launch(kernel + BF16_PANEL, x_t.device)


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}: "
                         f"{compute_dtype!r}")


# -- dropout bits (the same hash as csrc/sdf_ffn_common.cuh) ----------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def dropout_params(rate: float) -> Tuple[int, float]:
    """(threshold, scale): keep iff bits ≥ threshold = round(rate·2³²);
    kept values are multiplied by scale = 1/(1 − rate) in float32."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1): {rate}")
    threshold = int(round(rate * float(2 ** 32)))
    scale = float(np.float32(1.0) / np.float32(1.0 - rate))
    return threshold, scale


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for 32-bit values held in int64, without int64
    overflow (the product is split into 16-bit halves)."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fmix32_int(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def member_seeds(seed: Seed, S: int) -> Tuple[int, ...]:
    """The dropout seed as the kernels take it: one int, or a tuple of S
    ints (validated), each reduced to 32 bits."""
    if isinstance(seed, (int, np.integer)):
        return int(seed) & _M32
    seeds = tuple(int(x) & _M32 for x in seed)
    if len(seeds) != S:
        raise ValueError(f"sdf_ffn: {len(seeds)} dropout seeds for {S} "
                         "members")
    return seeds


def member_bases(seed: Seed, S: int) -> List[int]:
    """Member s's hash base fmix32(fmix32(seed_s ^ golden) ^ index_s):
    (seed, s) for one int seed, (seeds[s], 0) for S seeds — so member s of
    an S-seed call hashes exactly as a one-member call with seeds[s]."""
    seed = member_seeds(seed, S)
    keys = ([(seed, s) for s in range(S)] if isinstance(seed, int)
            else [(x, 0) for x in seed])
    return [_fmix32_int(_fmix32_int(x ^ _GOLDEN) ^ i) for x, i in keys]


def _row_hash(seed: Seed, S: int, T: int, N: int, device,
              offset: int = 0) -> torch.Tensor:
    """[S, T, N] int64: the per-(member, period, stock) base of the bits;
    stock n hashes as the global stock offset + n."""
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    h = torch.tensor(member_bases(seed, S), dtype=torch.int64, device=device)
    h = _fmix32(h[:, None, None] ^ ar(T)[None, :, None])
    return _fmix32(h ^ (ar(N) + int(offset))[None, None, :])


def _unit_bits(row: torch.Tensor, layer: int, H: int) -> torch.Tensor:
    """[S, T, H, N] bits of layer `layer`'s H units."""
    key = _mul32((layer << 8) | torch.arange(H, dtype=torch.int64,
                                             device=row.device), _GOLDEN)
    return _fmix32(row[:, :, None, :] ^ key[None, None, :, None])


def dropout_keep(seed: Seed, rate: float, layer: int, S: int, T: int,
                 H: int, N: int, device="cpu", offset: int = 0
                 ) -> torch.Tensor:
    """The kernels' keep mask [S, T, H, N] (bool) of one hidden layer of a
    call over the stocks [offset, offset + N); `seed` is one int or S
    ints."""
    threshold, _ = dropout_params(rate)
    return _unit_bits(_row_hash(seed, S, T, N, device, offset), layer,
                      H) >= threshold


# -- the plain versions -------------------------------------------------------


def _forward_stack(x_t, zp, k1T, mids, compute_dtype, seed, dropout_rate,
                   offset=0):
    """Post-ReLU, post-dropout activations (f32, unrounded) [S, T, H, N] of
    every hidden layer, and each layer's derivative factor (ReLU mask ×
    dropout multiplier): the ONE copy of the layer loop for the plain
    forward and backward."""
    _check_dtype(compute_dtype)
    T, _, N = x_t.shape
    S = zp.shape[0]
    drop = dropout_rate > 0.0
    if drop:
        threshold, scale = dropout_params(dropout_rate)
        row = _row_hash(seed, S, T, N, x_t.device, offset)
    x = _round(x_t.float(), compute_dtype)
    h_pre = torch.einsum("shf,tfn->sthn", _round(k1T, compute_dtype), x)
    h_pre = h_pre + zp[..., None]
    acts, facs = [], []
    for layer, wb in enumerate([None] + list(mids)):
        if wb is not None:
            w, b = wb
            h_pre = torch.einsum("sko,ston->stkn", _round(w, compute_dtype),
                                 _round(acts[-1], compute_dtype))
            h_pre = h_pre + b[:, None, :, None]
        fac = (h_pre > 0).float()
        if drop:
            keep = _unit_bits(row, layer, h_pre.shape[2]) >= threshold
            fac = fac * (keep.float() * scale)
        acts.append(torch.relu(h_pre) * (keep.float() * scale if drop
                                         else 1.0))
        facs.append(fac)
    return acts, facs


def sdf_ffn_reference(x_t: torch.Tensor, zp: torch.Tensor, k1T: torch.Tensor,
                      mids: Mids, kout: torch.Tensor, bout: torch.Tensor,
                      compute_dtype: str = "float32", seed: Seed = 0,
                      dropout_rate: float = 0.0, offset: int = 0
                      ) -> torch.Tensor:
    """The plain-PyTorch forward.

    x_t [T, F, N]; zp [S, T, H1]; k1T [S, H1, F]; mids ((W [S, H, Hin],
    b [S, H]), ...); kout [S, HL]; bout [S]  →  raw weights [S, T, N] f32.
    `offset`: the global index of the panel's first stock (dropout).
    """
    acts, _ = _forward_stack(x_t, zp, k1T, mids, compute_dtype, seed,
                             dropout_rate, offset)
    out = torch.einsum("sk,stkn->stn", _round(kout, compute_dtype),
                       _round(acts[-1], compute_dtype))
    return out + bout[:, None, None]


def _dh_chain(facs, mids, kout, g, compute_dtype):
    """dh_pre [S, T, H, N] of every hidden layer, from the cotangent g
    [S, T, N] of the raw weights down to the first layer: the ONE copy of
    the dh chain, with the JAX kernel's rounding points (both operands of
    kout·g and Wᵀ·dh_pre)."""
    cd = compute_dtype
    dh = _round(kout, cd)[:, None, :, None] * _round(g, cd)[:, :, None, :]
    dh_pres = [None] * len(facs)
    for li in range(len(mids), 0, -1):
        dh_pres[li] = dh * facs[li]
        dh = torch.einsum("sji,stjn->stin", _round(mids[li - 1][0], cd),
                          _round(dh_pres[li], cd))
    dh_pres[0] = dh * facs[0]
    return dh_pres


def sdf_ffn_bwd_reference(x_t: torch.Tensor, zp: torch.Tensor,
                          k1T: torch.Tensor, mids: Mids, kout: torch.Tensor,
                          g: torch.Tensor, compute_dtype: str = "float32",
                          seed: Seed = 0, dropout_rate: float = 0.0,
                          offset: int = 0):
    """The plain-PyTorch backward, with the JAX kernel's rounding points.

    g [S, T, N] → (dzp [S, T, H1], dk1T [S, H1, F], ((dW, db), ...),
    dkout [S, HL], dbout [S])."""
    cd = compute_dtype
    acts, facs = _forward_stack(x_t, zp, k1T, mids, cd, seed, dropout_rate,
                                offset)
    dh_pres = _dh_chain(facs, mids, kout, g, cd)
    dkout = torch.einsum("sthn,stn->sh", acts[-1], g)  # f32, unrounded
    dbout = g.sum(dim=(1, 2))
    dmids = tuple(
        (torch.einsum("stjn,stin->sji", _round(dh_pres[li], cd),
                      _round(acts[li - 1], cd)), dh_pres[li].sum(dim=(1, 3)))
        for li in range(1, len(mids) + 1))
    dk1T = torch.einsum("stjn,tfn->sjf", _round(dh_pres[0], cd),
                        _round(x_t.float(), cd))
    return (dh_pres[0].sum(dim=3), dk1T, dmids, dkout, dbout)


def sdf_ffn_dx_reference(x_t: torch.Tensor, zp: torch.Tensor,
                         k1T: torch.Tensor, mids: Mids, kout: torch.Tensor,
                         g: torch.Tensor, compute_dtype: str = "float32",
                         seed: Seed = 0, dropout_rate: float = 0.0,
                         offset: int = 0) -> torch.Tensor:
    """The plain-PyTorch panel cotangent, with the JAX kernel's rounding
    points (``pallas_ffn._dx_kernel``): g [S, T, N] → dx [T, F, N] =
    Σ_s round(K1_s)·round(dh1_pre_s), summed over the members because they
    share the panel, in the panel's dtype (a bf16 dx rounded once)."""
    cd = compute_dtype
    _, facs = _forward_stack(x_t, zp, k1T, mids, cd, seed, dropout_rate,
                             offset)
    dh1_pre = _dh_chain(facs, mids, kout, g, cd)[0]
    return torch.einsum("sjf,stjn->tfn", _round(k1T, cd),
                        _round(dh1_pre, cd)).to(x_t.dtype)


# -- packed parameters ------------------------------------------------------


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def _pad4(n: int) -> int:
    return _pad(n, 4)


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


# -- the CUDA kernels ---------------------------------------------------------


def width_bound(hidden: Sequence[int]) -> int:
    """The resident library a model needs: the smallest of WIDTH_BOUNDS that
    holds its widest (padded) hidden layer. A wider stack has no resident
    library; the streamed route serves it, and its bound reads as the
    padded width rounded up to 128. Raises past STREAM_MAX_WIDTH."""
    w = max(_pad4(h) for h in hidden)
    for b in WIDTH_BOUNDS:
        if w <= b:
            return b
    if w > STREAM_MAX_WIDTH:
        raise ValueError(f"sdf_ffn: hidden width {max(hidden)} exceeds the "
                         f"streamed route's {STREAM_MAX_WIDTH} (width)")
    return _pad(w, WIDTH_BOUNDS[-1])


def resident_fits(lay: FfnLayout) -> bool:
    """Can the resident kernels hold `lay` at all (at most
    MAX_HIDDEN_LAYERS layers, each within the widest library)? Whether a
    plan fits shared memory is the plan functions' question."""
    return (len(lay.hidden) <= MAX_HIDDEN_LAYERS
            and max(lay.hp) <= WIDTH_BOUNDS[-1])


def kernel_route_takes(F: int, hidden: Sequence[int]) -> bool:
    """Is (F, hidden) within the kernel route's limits: the resident
    kernels' or, past them, the streamed route's width, depth and F?
    (Whether a plan then fits is the plan functions' question.)"""
    return (len(hidden) <= STREAM_MAX_LAYERS and F <= STREAM_MAX_F
            and max(_pad4(h) for h in hidden) <= STREAM_MAX_WIDTH)


def is_stream(plan) -> bool:
    """Does `plan` launch the streamed-weight route (any of its forms)?"""
    return (plan.route in STREAM_ROUTES.values()
            or plan.route in (STREAM_MMA_ROUTE, STREAM_TILED_ROUTE))


_SOURCES = {"fwd": "sdf_ffn.cu", "bwd": "sdf_ffn_bwd.cu",
            "dx": "sdf_ffn_dx.cu"}
KERNELS = tuple(_SOURCES)


def build_jobs(widths: Sequence[int] = WIDTH_BOUNDS,
               kernels: Sequence[str] = KERNELS) -> List[_nvcc.Job]:
    """One library per (kernel, width bound), each compiled alone so only
    what a model needs is built at first use."""
    return [_nvcc.Job(f"sdf_ffn_{k}_w{w}", _SOURCES[k],
                      (f"-DSDF_FFN_MAXW={w}",))
            for k in kernels for w in widths]


STREAM_SOURCE = "sdf_ffn_stream.cu"


def stream_jobs(kernels: Sequence[str] = KERNELS) -> List[_nvcc.Job]:
    """The streamed route's libraries, one per kernel (its four panel ×
    compute instances, its two tensor-core ones and the four panel ×
    stock-tile instances of the register-tiled route), built only where a
    stack needs them."""
    return [_nvcc.Job(f"sdf_ffn_{k}_stream", STREAM_SOURCE,
                      (f"-DSDF_FFN_STREAM_KERNEL={KERNELS.index(k)}",))
            for k in kernels]


AUDIT_DEFINE = "-DSDF_FFN_DX_AUDIT"
# the dx audit's counters, in the order its library writes them
AUDIT_COUNTERS = ("elements", "certified", "flips", "flips_outside",
                  "max_ratio")


def audit_job(width: int = 64) -> _nvcc.Job:
    """The dx library's audit build: the same source under
    ``-DSDF_FFN_DX_AUDIT``, its own library (:func:`dx_audit`)."""
    return _nvcc.Job(f"sdf_ffn_dx_audit_w{width}", _SOURCES["dx"],
                     (f"-DSDF_FFN_MAXW={width}", AUDIT_DEFINE))


def stream_audit_job() -> _nvcc.Job:
    """The streamed dx library's audit build: its source under
    ``-DSDF_FFN_DX_AUDIT`` too, its own library (:func:`dx_audit` of a
    route-4 plan)."""
    (main,) = stream_jobs(["dx"])
    return _nvcc.Job("sdf_ffn_dx_stream_audit", STREAM_SOURCE,
                     main.defines + (AUDIT_DEFINE,))


def stream_certify_window(kin: int) -> float:
    """Route 4's certified window for a top layer of `kin` inputs
    (csrc/sdf_ffn_stream.cu certify_window): STREAM_CERTIFY per started
    STREAM_CERTIFY_DEPTH inputs."""
    return STREAM_CERTIFY * -(-int(kin) // STREAM_CERTIFY_DEPTH)


def build(widths: Sequence[int] = WIDTH_BOUNDS, verbose: bool = False,
          kernels: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile the forward, backward and panel-cotangent kernels for sm_90a,
    one library per (kernel, width bound), all ``nvcc`` processes started
    together. Returns
    {library name: compiler output} (see :func:`_nvcc.run`)."""
    return _nvcc.run(build_jobs(widths, kernels), verbose)


# the dropout arguments of every entry: (on, member_base, threshold, scale,
# the global stock offset)
_DROP_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_uint,
                  ctypes.c_float, ctypes.c_uint]
# every entry's first two: the panel and its dtype (1: bf16, 0: f32)
_PANEL_ARGTYPES = [ctypes.c_void_p, ctypes.c_int]
_ARGTYPES = {
    "fwd": (_PANEL_ARGTYPES + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] + _DROP_ARGTYPES
            + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]),
    "bwd": (_PANEL_ARGTYPES + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] + _DROP_ARGTYPES
            + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]),
    "dx": (_PANEL_ARGTYPES + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
           + [ctypes.POINTER(ctypes.c_int), ctypes.c_int] + _DROP_ARGTYPES
           + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_void_p]),
}


_STREAM_ARGTYPES = {
    # x, xb16, zp, params, out | g + grads (bwd: g, grad_part, dzp_part;
    # dx: g, dx), scratch, layout, layout on the card, S, T, N, bf16,
    # dropout, tile, smem, G, stream
    k: (_PANEL_ARGTYPES + [ctypes.c_void_p] * n
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        + [ctypes.c_int] * 4 + _DROP_ARGTYPES
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    for k, n in (("fwd", 4), ("bwd", 6), ("dx", 5))}


_STREAM_MMA_ARGTYPES = {
    # x, xb16, zp, params, wb, wtab, Pb, out | g, grad_part, dzp_part | g,
    # dx, wabs, layout, layout on the card, S, T, N, dropout, tile, smem, G,
    # stream
    k: (_PANEL_ARGTYPES + [ctypes.c_void_p] * 4 + [ctypes.c_int]
        + [ctypes.c_void_p] * n
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        + [ctypes.c_int] * 3 + _DROP_ARGTYPES
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    for k, n in (("fwd", 1), ("bwd", 3), ("dx", 3))}


_STREAM_TILED_ARGTYPES = {
    # x, xb16, zp, params, out | g, grad_part, dzp_part | g, dx, layout,
    # layout on the card, S, T, N, dropout, tile, smem, G, stream
    k: (_PANEL_ARGTYPES + [ctypes.c_void_p] * n
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        + [ctypes.c_int] * 3 + _DROP_ARGTYPES
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    for k, n in (("fwd", 3), ("bwd", 5), ("dx", 4))}


def _load_stream(kernel: str, audit: bool = False):
    """The streamed route's library of `kernel` (with `audit`, the dx's
    audit build), built at first use."""
    key = (kernel + STREAM + ("_audit" if audit else ""), 0)
    with _lib_lock:
        if key not in _libs:
            (job,) = [stream_audit_job()] if audit else stream_jobs([kernel])
            _nvcc.run([job])
            lib = ctypes.CDLL(str(job.path))
            fn = getattr(lib, f"sdf_ffn_{kernel}_stream")
            fn.argtypes = _STREAM_ARGTYPES[kernel]
            fn.restype = ctypes.c_int
            lib.sdf_ffn_stream_plan_info.argtypes = [
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.sdf_ffn_stream_plan_info.restype = ctypes.c_int
            lib.sdf_ffn_stream_registers.argtypes = [ctypes.c_int] * 2
            lib.sdf_ffn_stream_registers.restype = ctypes.c_int
            if kernel in STREAM_MMA_KERNELS:
                fn = getattr(lib, f"sdf_ffn_{kernel}_stream_mma")
                fn.argtypes = _STREAM_MMA_ARGTYPES[kernel]
                fn.restype = ctypes.c_int
                lib.sdf_ffn_stream_mma_plan_info.argtypes = [
                    ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)]
                lib.sdf_ffn_stream_mma_plan_info.restype = ctypes.c_int
                lib.sdf_ffn_stream_mma_registers.argtypes = [ctypes.c_int]
                lib.sdf_ffn_stream_mma_registers.restype = ctypes.c_int
            fn = getattr(lib, f"sdf_ffn_{kernel}_stream_tiled")
            fn.argtypes = _STREAM_TILED_ARGTYPES[kernel]
            fn.restype = ctypes.c_int
            lib.sdf_ffn_stream_tiled_plan_info.argtypes = [
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.sdf_ffn_stream_tiled_plan_info.restype = ctypes.c_int
            lib.sdf_ffn_stream_tiled_registers.argtypes = [ctypes.c_int]
            lib.sdf_ffn_stream_tiled_registers.restype = ctypes.c_int
            if audit:
                _bind_audit(lib)
            _libs[key] = lib
        return _libs[key]


def _load(kernel: str, width: int, audit: bool = False):
    key = (kernel + "_audit" if audit else kernel, width)
    with _lib_lock:
        if key not in _libs:
            (job,) = ([audit_job(width)] if audit
                      else build_jobs([width], [kernel]))
            _nvcc.run([job])
            lib = ctypes.CDLL(str(job.path))
            fn = getattr(lib, f"sdf_ffn_{kernel}")
            fn.argtypes = _ARGTYPES[kernel]
            fn.restype = ctypes.c_int
            # every plan query names the panel's dtype last (xb16): each
            # kernel's f32 and bf16-panel instances have their own
            # registers
            if kernel == "fwd":
                lib.sdf_ffn_fwd_plan_info.argtypes = [
                    ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5 + [
                    ctypes.c_longlong, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)]
                lib.sdf_ffn_fwd_plan_info.restype = ctypes.c_int
                lib.sdf_ffn_fwd_registers.argtypes = [ctypes.c_int] * 3
                lib.sdf_ffn_fwd_registers.restype = ctypes.c_int
            if kernel == "bwd":
                lib.sdf_ffn_bwd_plan_info.argtypes = [
                    ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3 + [
                    ctypes.c_longlong, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)]
                lib.sdf_ffn_bwd_plan_info.restype = ctypes.c_int
                lib.sdf_ffn_bwd_registers.argtypes = [ctypes.c_int] * 2
                lib.sdf_ffn_bwd_registers.restype = ctypes.c_int
            if kernel == "dx":
                lib.sdf_ffn_dx_plan_info.argtypes = [
                    ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 7 + [
                    ctypes.c_longlong, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int)]
                lib.sdf_ffn_dx_plan_info.restype = ctypes.c_int
                lib.sdf_ffn_dx_registers.argtypes = [ctypes.c_int] * 4
                lib.sdf_ffn_dx_registers.restype = ctypes.c_int
            if audit:
                _bind_audit(lib)
            _libs[key] = lib
        return _libs[key]


def _bind_audit(lib) -> None:
    """An audit build's counter entries (both dx sources name them
    alike)."""
    lib.sdf_ffn_dx_audit_reset.argtypes = [ctypes.c_void_p]
    lib.sdf_ffn_dx_audit_reset.restype = ctypes.c_int
    lib.sdf_ffn_dx_audit_read.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_void_p]
    lib.sdf_ffn_dx_audit_read.restype = ctypes.c_int


def _check_cuda(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                device: torch.device,
                dtypes: Tuple[torch.dtype, ...] = (torch.float32,)) -> None:
    if t.device != device or t.dtype not in dtypes or not t.is_contiguous():
        kinds = " or ".join(str(d).split(".")[-1] for d in dtypes)
        raise ValueError(f"sdf_ffn: {name} must be a contiguous {kinds} "
                         f"tensor on {device}; got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if tuple(t.shape) != shape:
        raise ValueError(f"sdf_ffn: {name} must be {list(shape)}; got "
                         f"{list(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"sdf_ffn: {name} must be 16-byte aligned")


def _raise_rc(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{kernel} launch failed (code {rc}: "
            + ("unsupported shape" if rc == -1 else "cudaError") + ")")


def _dropout_args(seed: Seed, rate: float, S: int, device, offset: int = 0):
    """(kernel arguments (on, member_base pointer, threshold, scale, the
    global stock offset), the [S] base tensor the pointer points into, kept
    alive by the caller)."""
    if not 0 <= int(offset) < 2 ** 32:
        raise ValueError(f"sdf_ffn: stock offset {offset} outside uint32")
    if rate <= 0.0:
        return (0, None, 0, 1.0, int(offset)), None
    threshold, scale = dropout_params(rate)
    bases = np.asarray(member_bases(seed, S), np.uint32).view(np.int32)
    base_t = torch.from_numpy(bases).to(device)
    return (1, base_t.data_ptr(), threshold, scale, int(offset)), base_t


def _layout_ints(lay: FfnLayout):
    ints = lay.as_ints()
    return (ctypes.c_int * len(ints))(*ints)


def is_bf16(x_t: torch.Tensor) -> bool:
    """Is x_t a bf16 panel (its kernels' bf16-panel instances)?"""
    return x_t.dtype == torch.bfloat16


def _panel_args(x_t: torch.Tensor):
    """An entry's first two arguments: the panel and its dtype flag."""
    return x_t.data_ptr(), int(is_bf16(x_t))


def _launch(x_t: torch.Tensor, zp: torch.Tensor, packed: PackedFfn,
            seed: Seed = 0, dropout_rate: float = 0.0,
            offset: int = 0) -> torch.Tensor:
    """Raw weights [S, T, N], launched at :func:`card_fwd_plan`."""
    lay = packed.layout
    T, F, N = x_t.shape
    S = packed.n_members
    dev = x_t.device
    _check_cuda("x_t", x_t, (T, lay.F, N), dev, PANEL_DTYPES)
    _check_cuda("zp", zp, (S, T, lay.hidden[0]), dev)
    _check_cuda("params", packed.params, (S, lay.P), dev)
    plan = card_fwd_plan(lay, dev, S, T, N, packed.compute_dtype,
                         is_bf16(x_t))
    out = torch.empty((S, T, N), dtype=torch.float32, device=dev)
    if is_stream(plan):
        _stream_launch("fwd", x_t, zp, packed, plan, seed, dropout_rate,
                       offset, (out,))
        return out
    lib = _load("fwd", width_bound(lay.hidden))
    drop, _bases = _dropout_args(seed, dropout_rate, S, dev, offset)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdf_ffn_fwd(
            *_panel_args(x_t), zp.data_ptr(), packed.params.data_ptr(),
            out.data_ptr(), S, T, N, _layout_ints(lay),
            int(packed.compute_dtype == "bfloat16"), *drop, plan.route,
            plan.tile, plan.threads, plan.members, plan.smem_bytes,
            plan.blocks_per_sm, plan.G, stream)
    if rc == -1:
        raise RuntimeError(f"sdf_ffn_fwd refused the plan {plan} for hidden "
                           f"{list(lay.hidden)}, F = {lay.F}")
    _raise_rc("sdf_ffn_fwd", rc)
    panel_launch("sdf_ffn_fwd", x_t)
    return out


def fwd_geometry(lay: FfnLayout, route: int, tile: int,
                 members: int = 1) -> Tuple[int, int]:
    """(shared-memory words of one block, words per member), as
    csrc/sdf_ffn.cu's smem_plan counts them.

    f32 route (0), units padded to 8 (the register tile's width): one
    member's weights (k1 and each later W_l as [inputs][units], biases,
    kout, bout), zp, the tile's row hashes, the x tile [max(F, H8)][tile]
    (odd layers write their output over it) and the even layers' tile
    [H8][tile], H8 the widest padded layer.
    bf16 route (1), every layer padded to the library's width bound W: two
    f32 x tiles [pad16(F)][tile + 4] (double-buffered), then per member
    its two zp rows [W] (double-buffered) and its weights: each layer's
    bf16 B rows (W units; inputs padded to 16 in the first layer, to W
    after it; rows inputs/2 + 4 words apart), the f32 biases of layers ≥ 2,
    the output product's 8 bf16 B rows (kout, then zeros) and bout,
    rounded up to 4 words."""
    hp, h = lay.hp, lay.hidden
    if route == 0:
        p8 = [_pad(x, 8) for x in hp]
        w = lay.F * p8[0] + sum(hp[li - 1] * p8[li] + p8[li]
                                for li in range(1, len(h))) + hp[-1] + 4
        h8 = max(p8)
        return w + p8[0] + tile + (max(lay.F, h8) + h8) * tile, w
    W = width_bound(h)
    w = W * (_pad(lay.F, 16) // 2 + 4) + (len(h) - 1) * W * (W // 2 + 5)
    w = _pad(w + 8 * (W // 2 + 4) + 4, 4) + 2 * W
    return 2 * _pad(lay.F, 16) * (tile + 4) + members * w, w


def mma_threads(lay: FfnLayout, members: int, registers: int = 0) -> int:
    """The tensor-core route's block: 512 threads (two member phases) where
    a group has two members or more, the library allows it (not w128) and
    the kernel's registers fit 16 warps on an SM; else 256."""
    two = (members >= 2 and width_bound(lay.hidden) <= 64
           and (not registers or registers <= SM_REGS // 512))
    return 512 if two else 256


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The forward's launch: route (0 f32 register tiles, 1 bf16 tensor
    cores), stock tile per cell, threads per block, members per block (the
    bf16 route stages a group's weights and runs them all on each panel
    tile), shared memory per block, the resident blocks per SM that shared
    memory, threads and registers allow, and the persistent grid G (at
    most blocks per SM × SMs, at most the cells) walking `cells` cells of
    (member group, period, stock tile)."""

    route: int
    tile: int
    threads: int
    members: int
    smem_bytes: int
    blocks_per_sm: int
    G: int
    cells: int
    scratch: int = 0  # streamed route: tile floats a block in global memory


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


def stream_rows(lay: FfnLayout, kernel: str,
                route: int = STREAM_ROUTES["float32"]) -> int:
    """Rows of a streamed block's tile buffers (csrc/sdf_ffn_stream.cu
    tile_rows; each buffer's rows padded to STREAM_SLAB): the panel tile,
    then the forward's two activation buffers (the widest layer each), or
    every layer's activations, two dh buffers and (dx) the cotangent's
    accumulator. Route 4's dx (bf16 rows; its dx accumulator an f32 tile
    apart): the panel tile, the layers below the top (each layer's dh_pre
    written over its activations) and the top layer's dh_pre. Route 5's
    backward and dx (csrc tiled_rows): the panel tile and every layer, each
    layer's dh_pre written over its activations, and (dx) the cotangent's
    accumulator."""
    r = [_pad(h, STREAM_SLAB) for h in lay.hidden]
    rf = _pad(lay.F, STREAM_SLAB)
    if kernel == "fwd":
        return rf + 2 * max(r)
    if kernel == "dx" and route == STREAM_MMA_ROUTE:
        return rf + sum(r)
    acc = rf if kernel == "dx" else 0
    if route == STREAM_TILED_ROUTE:
        return rf + sum(r) + acc
    return rf + sum(r) + 2 * max(r) + acc


def stream_geometry(lay: FfnLayout, kernel: str, tile: int,
                    route: int = STREAM_ROUTES["float32"]) -> Tuple[int, int]:
    """(shared-memory words (4 bytes) besides the tile buffers, words of the
    tile buffers) of a streamed block of `route` at stock tile `tile`, as
    csrc/sdf_ffn_stream.cu counts them.

    Routes 2 and 3: two weight slabs of STREAM_SLAB inputs ×
    16·threads/tile units, the row hashes and the g row; f32 tile rows of
    tile + 4 floats. The tensor-core route (STREAM_MMA_ROUTE): a ring of
    STREAM_MMA_STAGES slabs of SU rows × (STREAM_MMA_SLAB + 8) bf16 (SU the
    units of a pass, 64 a warp with tile/32 of the 8 warps along the stocks,
    or the widest padded layer where narrower), the row hashes, the g row
    and STREAM_MMA_RED cross-warp sums; bf16 tile rows of tile + 8. Its dx
    also counts pad16(F) among the layers for SU (its dx product's rows),
    shares the ring with the two f32 slabs of routes 2 and 3 (its exact
    layers below the top; the larger of the two) and adds an f32 dx tile of
    pad16(F) rows × (tile + 4). The register-tiled route
    (STREAM_TILED_ROUTE, csrc tiled_smem_bytes): a ring of
    STREAM_TILED_STAGES slabs of STREAM_TILED_PASS × (STREAM_SLAB + 4)
    floats, the row hashes and the g row; f32 tile rows of tile + 4."""
    rows = stream_rows(lay, kernel, route)
    if route == STREAM_TILED_ROUTE:
        ring = STREAM_TILED_STAGES * STREAM_TILED_PASS * (STREAM_SLAB + 4)
        return ring + 2 * tile, rows * (tile + 4)
    if route != STREAM_MMA_ROUTE:
        fixed = 2 * STREAM_SLAB * (16 * STREAM_THREADS // tile) + 2 * tile
        return fixed, rows * (tile + 4)
    dx = kernel == "dx"
    su = min(64 * (8 // (tile // 32)),
             max(_pad(h, STREAM_SLAB)
                 for h in lay.hidden + ((lay.F,) if dx else ())))
    ring = STREAM_MMA_STAGES * su * (STREAM_MMA_SLAB + 8) // 2
    if dx:
        ring = max(ring, 2 * STREAM_SLAB * (16 * STREAM_THREADS // tile))
    tiles = rows * (tile + 8) // 2
    if dx:
        tiles += _pad(lay.F, STREAM_SLAB) * (tile + 4)
    return ring + 2 * tile + STREAM_MMA_RED, tiles


def stream_plan(lay: FfnLayout, kernel: str, sms: int, S: int, T: int,
                N: int, registers: int = 0,
                route: int = STREAM_ROUTES["float32"]
                ) -> Tuple[int, int, int, int, int, int]:
    """The streamed route's launch for `kernel` ("fwd", "bwd" or "dx") on
    `route` (2 or 3, the tensor-core STREAM_MMA_ROUTE, or the register-tiled
    STREAM_TILED_ROUTE): (stock tile, shared memory, resident blocks per SM,
    G, cells, tile floats a block in global scratch — 0 where the tile
    buffers sit in shared memory).

    Of the stock tiles, with the tile buffers in shared memory where they
    fit, else in scratch (not on routes 4 and 5: ldmatrix reads shared
    memory only, and route 5 is the shared-memory form of route 2), the
    one that keeps the most stocks resident per
    SM (tile × blocks per SM, shared memory in front; then the larger
    tile). G: a persistent grid over the S·T·⌈N/tile⌉ cells (forward) or
    T·⌈N/tile⌉ (the panel cotangent; the backward's G blocks per member),
    at most the blocks resident on `sms` SMs, and no more than the
    scratch budgets allow. Raises naming the limit (width, layers, F,
    shared memory, registers, scratch)."""
    name = f"sdf_ffn_{kernel}"
    mma = route == STREAM_MMA_ROUTE
    tiled = route == STREAM_TILED_ROUTE
    if mma and kernel not in STREAM_MMA_KERNELS:
        raise ValueError(f"{name}: no tensor-core streamed route")
    over = [f"{what} {got} exceeds its {cap} ({tag})" for what, got, cap, tag
            in (("hidden width", max(lay.hp), STREAM_MAX_WIDTH, "width"),
                ("depth of", len(lay.hidden), STREAM_MAX_LAYERS, "layers"),
                ("F =", lay.F, STREAM_MAX_F, "F")) if got > cap]
    if over:
        raise ValueError(f"{name}: hidden {list(lay.hidden)} with F = "
                         f"{lay.F} does not fit the streamed route: "
                         + "; ".join(over))
    per = S if kernel == "bwd" else 1  # blocks a G column
    part = 4 * S * (lay.P + T * lay.hidden[0])  # bwd partials a G column
    threads = stream_threads(route)
    plans, refused = [], set()
    for tile in (STREAM_MMA_TILES if mma else STREAM_TILED_TILES if tiled
                 else STREAM_TILES):
        fixed, tf = stream_geometry(lay, kernel, tile, route)
        cells = (S if kernel == "fwd" else 1) * T * -(-N // tile)
        for in_smem in (True,) if mma or tiled else (True, False):
            smem = 4 * (fixed + (tf if in_smem else 0))
            if smem > MAX_SMEM:
                refused.add("shared memory")
                continue
            blocks = _resident(smem, threads, registers)
            if blocks < 1:
                refused.add(f"registers ({registers} a thread)")
                continue
            G = max(1, min(cells, blocks * sms // per))
            if not in_smem:
                G = min(G, STREAM_SCRATCH_BYTES // (4 * tf * per))
            if kernel == "bwd":
                G = min(G, STREAM_GRAD_BYTES // part)
            if G < 1:
                refused.add(f"scratch ({4 * tf * per} B of tile buffers, "
                            f"{part if kernel == 'bwd' else 0} B of gradient"
                            " partials a grid column)")
                continue
            plans.append(((in_smem, tile * blocks, tile),
                          (tile, smem, blocks, G, cells,
                           0 if in_smem else tf)))
    if not plans:
        raise ValueError(f"{name}: hidden {list(lay.hidden)} with F = "
                         f"{lay.F} does not fit the streamed route: refused "
                         "by " + ", ".join(sorted(refused)))
    return max(plans)[1]


def stream_threads(route: int) -> int:
    """Threads a block of the streamed `route`."""
    return STREAM_TILED_THREADS if route == STREAM_TILED_ROUTE \
        else STREAM_THREADS


def stream_reference_plan(lay: FfnLayout, kernel: str, plan, S: int):
    """Route 2's plan of the same stock tile and G as the streamed `plan`
    (a FwdPlan, BwdPlan or DxPlan of the register-tiled route): its tile
    buffers in shared memory where they fit, else in scratch. Route 2
    computes, on it, what route 5 computes on `plan`, bit for bit (the
    forward's out and the panel cotangent at any plan; the backward's
    gradients group the same stocks into the same cells), so it is route
    5's reference. Raises for a tile route 2 does not take."""
    route = STREAM_ROUTES["float32"]
    if plan.tile not in STREAM_TILES:
        raise ValueError(f"sdf_ffn_{kernel}: route {route} takes tiles "
                         f"{STREAM_TILES}, not {plan.tile}")
    fixed, tf = stream_geometry(lay, kernel, plan.tile, route)
    in_smem = 4 * (fixed + tf) <= MAX_SMEM
    smem = 4 * (fixed + (tf if in_smem else 0))
    per = S if kernel == "bwd" else 1
    scratch = 0 if in_smem else tf
    if 4 * plan.G * per * scratch > STREAM_SCRATCH_BYTES:
        raise ValueError(f"sdf_ffn_{kernel}: route {route}'s tile buffers "
                         f"at tile {plan.tile}, G = {plan.G} exceed its "
                         f"scratch")
    return dataclasses.replace(
        plan, route=route, threads=STREAM_THREADS, smem_bytes=smem,
        blocks_per_sm=_resident(smem, STREAM_THREADS, 0), scratch=scratch)


def fwd_plan(lay: FfnLayout, sms: int, S: int, T: int, N: int,
             compute_dtype: str = "float32",
             registers: Dict[int, int] = None) -> FwdPlan:
    """The forward's launch plan: the resident route's
    (:func:`resident_fwd_plan`) where it has one, else the streamed
    route's (:func:`stream_plan`; `registers` keyed by its route)."""
    _check_dtype(compute_dtype)
    if resident_fits(lay):
        try:
            return resident_fwd_plan(lay, sms, S, T, N, compute_dtype,
                                     registers)
        except ValueError:
            pass
    route, plan = stream_route_plan(lay, "fwd", sms, S, T, N, compute_dtype,
                                    registers)
    tile, smem, blocks, G, cells, scratch = plan
    return FwdPlan(route, tile, stream_threads(route), 1, smem, blocks, G,
                   cells, scratch)


def stream_route_plan(lay: FfnLayout, kernel: str, sms: int, S: int, T: int,
                      N: int, compute_dtype: str,
                      registers: Dict[int, int] = None):
    """(route, :func:`stream_plan`) of the streamed `kernel` at
    `compute_dtype`: under bf16 compute each kernel takes the tensor-core
    route (STREAM_MMA_ROUTE) for stacks of at most STREAM_MMA_MAX_LAYERS
    layers whose bf16 tiles fit shared memory, else route 3 (the tiles in
    shared memory or scratch); under f32 compute every kernel takes the
    register-tiled route (STREAM_TILED_ROUTE) where its tile fits shared
    memory, but for the forward and the panel cotangent where every padded
    layer is at most STREAM_TILED_NARROW units wide and route 2 takes tile
    64; else route 2. `registers` is keyed by route."""
    regs = registers or {}
    if (compute_dtype == "bfloat16" and kernel in STREAM_MMA_KERNELS
            and len(lay.hidden) <= STREAM_MMA_MAX_LAYERS):
        try:
            return STREAM_MMA_ROUTE, stream_plan(
                lay, kernel, sms, S, T, N, regs.get(STREAM_MMA_ROUTE, 0),
                STREAM_MMA_ROUTE)
        except ValueError:
            pass
    route = STREAM_ROUTES[compute_dtype]
    plan = None
    if compute_dtype == "float32" and _f32_route5:
        if (kernel != "bwd" and max(_pad(h, STREAM_SLAB) for h in lay.hidden)
                <= STREAM_TILED_NARROW):
            plan = stream_plan(lay, kernel, sms, S, T, N, regs.get(route, 0),
                               route)
        if plan is None or plan[0] != 64:
            try:
                return STREAM_TILED_ROUTE, stream_plan(
                    lay, kernel, sms, S, T, N,
                    regs.get(STREAM_TILED_ROUTE, 0), STREAM_TILED_ROUTE)
            except ValueError:
                pass
    return route, plan or stream_plan(lay, kernel, sms, S, T, N,
                                      regs.get(route, 0), route)


_f32_route5 = True


@contextlib.contextmanager
def f32_streamed_on_route2():
    """Plan the streamed f32 forward, backward and panel cotangent on route
    2 inside the block, as the plans did before route 5 (the card's check
    times the train CLI and the panel gradient on each route in turns); the
    plans kept per shape are dropped on entry and on exit."""
    global _f32_route5
    _fwd_plans.clear()
    _dx_plans.clear()
    _f32_route5 = False
    try:
        yield
    finally:
        _f32_route5 = True
        _fwd_plans.clear()
        _dx_plans.clear()


def resident_fwd_plan(lay: FfnLayout, sms: int, S: int, T: int, N: int,
                      compute_dtype: str = "float32",
                      registers: Dict[int, int] = None) -> FwdPlan:
    """The forward's launch plan for `lay` on a card of `sms` SMs.

    float32: of the stock tiles and block sizes whose shared memory fits,
    the one that keeps the most threads busy per SM (blocks per SM × the
    threads that have an 8 × 8 tile of the widest layer; then fewer
    threads, then the larger tile). bfloat16: the tensor-core route, with as many
    members per block as fit (all S where they do), balanced over the
    groups, in blocks of :func:`mma_threads`. `registers` ({route: registers per thread}, as the built
    library reports them) bounds the blocks per SM too. G = min(cells,
    blocks per SM · sms): a persistent grid, every block resident at once.
    Raises if nothing fits."""
    _check_dtype(compute_dtype)
    route = FWD_ROUTES[compute_dtype]
    regs = (registers or {}).get(route, 0)
    plans = []
    if route == 0:
        for tile in FWD_TILES:
            for threads in FWD_THREADS:
                smem = 4 * fwd_geometry(lay, 0, tile)[0]
                if smem > MAX_SMEM:
                    continue
                blocks = _resident(smem, threads, regs)
                busy = blocks * min(threads,
                                    _pad(max(lay.hp), 8) // 8 * (tile // 8))
                plans.append(((busy, -threads, tile),
                              (tile, threads, 1, smem, blocks)))
    else:
        base, per = fwd_geometry(lay, 1, MMA_TILE, 0)
        fit = (MAX_SMEM // 4 - base) // per
        if fit >= 1:
            groups = -(-S // min(S, fit))
            members = -(-S // groups)
            smem = 4 * fwd_geometry(lay, 1, MMA_TILE, members)[0]
            threads = mma_threads(lay, members, regs)
            plans.append(((0,), (MMA_TILE, threads, members, smem,
                                 _resident(smem, threads, regs))))
    plans = [p for p in plans if p[1][4] >= 1]
    if not plans:
        raise ValueError(f"sdf_ffn_fwd: hidden {list(lay.hidden)} with F = "
                         f"{lay.F} does not fit the kernel's shared memory")
    tile, threads, members, smem, blocks = max(plans)[1]
    cells = -(-S // members) * T * -(-N // tile)
    return FwdPlan(route, tile, threads, members, smem, blocks,
                   min(cells, blocks * sms), cells)


def _row_stride(w: int) -> int:
    """A stock-major tile's row stride (csrc/sdf_ffn_bwd.cu row_stride): a
    multiple of 4 floats whose quarter is odd."""
    s = _pad4(w)
    return s if (s // 4) % 2 else s + 4


def bwd_geometry(lay: FfnLayout, tile: int) -> Tuple[int, int, int]:
    """(shared-memory floats, 4 × 4 product tiles, 4-wide sum tiles) of the
    backward at stock tile `tile`, as csrc/sdf_ffn_bwd.cu's smem_plan counts
    them: the packed weights, zp, g, then the tile's x rows (F padded to 4)
    and one activation row per layer and stock; the tiles of dW_l and dK1,
    and of dkout + dbout and every db_l."""
    hp = lay.hp
    floats = lay.P + hp[0] + tile + tile * (
        _row_stride(lay.F) + sum(_row_stride(h) for h in hp))
    outer = _pad4(lay.F) // 4 * (hp[0] // 4) + sum(
        hp[li] // 4 * (hp[li - 1] // 4) for li in range(1, len(hp)))
    vec = hp[-1] // 4 + 1 + sum(h // 4 for h in hp[1:])
    return floats, outer, vec


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's launch: stock tile (= threads per block), shared
    memory per block, the resident blocks per SM that shared memory, the
    thread limit and the registers allow, blocks per member G, and the accumulators: `nt`
    register tiles per thread (a csrc instance), or 0 for read-add-write of
    each block's slice of grad_part per cell."""

    tile: int
    threads: int
    smem_bytes: int
    blocks_per_sm: int
    G: int
    nt: int
    route: int = 0  # 0 resident; or the streamed route's (STREAM_ROUTES)
    scratch: int = 0  # streamed route: tile floats a block in global memory

    @property
    def accumulators(self) -> str:
        return "registers" if self.nt else "grad_part"


def bwd_plan(lay: FfnLayout, sms: int, S: int, T: int, N: int,
             tile: int = None, registers: Dict[int, int] = None,
             compute_dtype: str = "float32") -> BwdPlan:
    """The backward's launch plan: the resident route's
    (:func:`resident_bwd_plan`) where it has one, else the streamed
    route's at `compute_dtype` (:func:`stream_plan`; `registers` keyed by
    its route). A forced `tile` is the resident route's."""
    _check_dtype(compute_dtype)
    if tile is not None or resident_fits(lay):
        try:
            return resident_bwd_plan(lay, sms, S, T, N, tile, registers)
        except ValueError:
            if tile is not None:
                raise
    route, plan = stream_route_plan(lay, "bwd", sms, S, T, N, compute_dtype,
                                    registers)
    bn, smem, blocks, G, _, scratch = plan
    return BwdPlan(bn, stream_threads(route), smem, blocks, G, 0, route,
                   scratch)


def resident_bwd_plan(lay: FfnLayout, sms: int, S: int, T: int, N: int,
                      tile: int = None,
                      registers: Dict[int, int] = None) -> BwdPlan:
    """The resident backward's launch plan for `lay` on a card of `sms` SMs.

    Among the stock tiles whose shared memory fits one block, it takes the
    one that keeps the most stocks resident per SM (tile × blocks per SM;
    then register accumulators; then the larger tile). The accumulators
    stay in registers when the product tiles fit an instance of
    BWD_REG_TILES per thread (not in the w128 library). `registers`
    ({nt: registers per thread of that kernel instance}, as the built
    library reports them) bounds the blocks per SM too. G = ⌊blocks per SM
    · sms / S⌋ blocks per member, capped at the (period, tile) cells, so
    one wave fills the card (a ceiling would put the remainder in a second
    wave of its own). `tile` forces one stock tile. Raises if none fits."""
    plans = []
    for bn in (BWD_TILES if tile is None else (tile,)):
        floats, outer, vec = bwd_geometry(lay, bn)
        smem = 4 * floats
        if bn not in BWD_TILES or smem > MAX_SMEM:
            continue
        blocks = min(SM_SMEM // (smem + BLOCK_SMEM_RESERVED),
                     SM_MAX_THREADS // bn, SM_MAX_BLOCKS)
        nt = 0
        if width_bound(lay.hidden) <= 64 and vec <= BWD_VEC_TILES * bn:
            nt = next((r for r in BWD_REG_TILES if outer <= r * bn), 0)
        regs = (registers or {}).get(nt, 0)
        if regs:
            per_warp = -(-regs * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
            blocks = min(blocks, SM_REGS // (per_warp * -(-bn // 32)))
        if blocks < 1:
            continue
        cells = T * (-(-N // bn))
        G = max(1, min(cells, blocks * sms // S))
        plans.append(BwdPlan(bn, bn, smem, blocks, G, nt))
    if not plans:
        raise ValueError(f"sdf_ffn_bwd: hidden {list(lay.hidden)} with F = "
                         f"{lay.F} does not fit the kernel's shared memory"
                         + (f" at tile {tile}" if tile else ""))
    return max(plans, key=lambda p: (p.tile * p.blocks_per_sm, p.nt > 0,
                                     p.tile))


def dx_route(lay: FfnLayout, compute_dtype: str) -> int:
    """The panel cotangent's route: 1 (tensor cores) for bf16 where a warp's
    dx fragments fit its registers (pad16(F) ≤ DX_MMA_MAX_F), else 0 (CUDA
    cores; bf16 operands rounded there)."""
    _check_dtype(compute_dtype)
    return int(compute_dtype == "bfloat16"
               and _pad(lay.F, 16) <= DX_MMA_MAX_F)


def _dx_core_words(lay: FfnLayout) -> int:
    """Route 0's weight buffer (csrc/sdf_ffn_dx.cu core_wwords): the packed
    layout and what the register tiles read past it."""
    F, hp, h = lay.F, lay.hp, lay.hidden
    end = max(lay.P, _pad(F, DX_FEATURES) * hp[0],
              (F - 1) * hp[0] + _pad(hp[0], 8))
    for li in range(1, len(h)):
        hin = hp[li - 1]
        end = max(end, lay.off_w[li] + _pad(h[li], 8) * hin,
                  lay.off_w[li] + (h[li] - 1) * hin + _pad(hin, 8))
    return _pad4(end)


def dx_geometry(lay: FfnLayout, route: int, tile: int, wbufs: int,
                xbufs: int) -> Tuple[int, int]:
    """(shared-memory words of one block, words per weight buffer), as
    csrc/sdf_ffn_dx.cu's smem_plan counts them: `xbufs` panel tiles
    [F][tile], activation tiles, two zp rows, two g rows and two rows of
    dropout row hashes [tile], then `wbufs` weight buffers.

    Route 0: one activation tile [H8][tile] per layer (H8 the widest layer
    padded to 8), zp rows [pad8(hp0)], and one member's packed weights a
    buffer (plus what the register tiles read past them).
    Route 1, every layer padded to the library's width bound W: an
    activation tile [W][tile + 4] per layer below the top (one where there
    is one layer), zp rows [W], and a member's image a buffer: K1
    [pad16(F)] and each W_l [W] as bf16 rows of W/2 + 4 words, then b_l,
    kout and the top layer's Σ|W| as W f32 words each."""
    F, hp, L = lay.F, lay.hp, len(lay.hidden)
    if route == 0:
        w = _dx_core_words(lay)
        acts, rows, stride, zw = L, max(_pad(x, 8) for x in hp), tile, _pad(
            hp[0], 8)
    else:
        W = width_bound(lay.hidden)
        rw = W // 2 + 4
        w = _pad4(_pad(F, 16) * rw + (L - 1) * W * (rw + 1) + 2 * W)
        acts, rows, stride, zw = max(L - 1, 1), W, tile + 4, W
    return (xbufs * F * tile + acts * rows * stride + 2 * zw + 4 * tile
            + wbufs * w, w)


def _dx_busy(lay: FfnLayout, tile: int, threads: int) -> float:
    """The share of a block's threads that route 0 keeps busy, weighted by
    multiply-adds: each product's register tiles (8 units, or DX_FEATURES
    features in dx, × 4 stocks) spread over the threads, in rounds."""
    F, hp, h = lay.F, lay.hp, lay.hidden
    L = len(h)
    prods = ([(-(-hp[0] // 8), F * hp[0])]
             + [(-(-hp[li] // 8), hp[li - 1] * hp[li]) for li in range(1, L)]
             + [(-(-hp[li - 1] // 8), h[li] * hp[li - 1])
                for li in range(1, L)]
             + [(-(-F // DX_FEATURES), F * hp[0])])
    busy = 0.0
    for row_tiles, fma in prods:
        tiles = row_tiles * (tile // 4)
        busy += fma * tiles / (-(-tiles // threads) * threads)
    return busy / sum(fma for _, fma in prods)


@dataclasses.dataclass(frozen=True)
class DxPlan:
    """The panel cotangent's launch: route (0: CUDA-core register tiles; 1:
    bf16, the layers below the top on the CUDA cores, the rest on the
    tensor cores), stock tile per cell, threads per block, weight buffers
    (S: every member resident for the block's life; 2: streamed, the next
    member's weights arriving while one computes; 1: streamed, each
    member's at the start of its step), panel tile buffers (2: the next
    cell's tile arriving while one computes; 1: once the cell's last member
    has read it), shared memory per block, the resident blocks per SM that
    shared memory, threads and registers allow, and the persistent grid G
    (at most blocks per SM × SMs, at most the cells) walking `cells` cells
    of (period, stock tile), each for all S members."""

    route: int
    tile: int
    threads: int
    wbufs: int
    xbufs: int
    resident: bool
    smem_bytes: int
    blocks_per_sm: int
    G: int
    cells: int
    scratch: int = 0  # streamed route: tile floats a block in global memory


def dx_plan(lay: FfnLayout, sms: int, S: int, T: int, N: int,
            compute_dtype: str = "float32",
            registers: Dict[int, int] = None, tile: int = None) -> DxPlan:
    """The panel cotangent's launch plan: the resident route's
    (:func:`resident_dx_plan`) where it has one, else the streamed route's
    (:func:`stream_plan`; `registers` keyed by its route). A forced `tile`
    is the resident route's."""
    _check_dtype(compute_dtype)
    if tile is not None or resident_fits(lay):
        try:
            return resident_dx_plan(lay, sms, S, T, N, compute_dtype,
                                    registers, tile)
        except ValueError:
            if tile is not None:
                raise
    route, plan = stream_route_plan(lay, "dx", sms, S, T, N, compute_dtype,
                                    registers)
    bn, smem, blocks, G, cells, scratch = plan
    return DxPlan(route, bn, stream_threads(route), 2, 1, False, smem, blocks,
                  G, cells, scratch)


def resident_dx_plan(lay: FfnLayout, sms: int, S: int, T: int, N: int,
                     compute_dtype: str = "float32",
                     registers: Dict[int, int] = None,
                     tile: int = None) -> DxPlan:
    """The resident panel cotangent's launch plan for `lay` on a card of
    `sms` SMs.

    Of the stock tiles, block sizes (route 0; route 1 runs a warp per 16
    stocks), weight buffers and panel tile buffers whose shared memory
    fits, and (route 0) whose threads each hold at most one dx tile
    (⌈F/DX_FEATURES⌉ × tile/4 ≤ threads), the one that keeps the most
    threads busy per SM (blocks × threads, × :func:`_dx_busy` on route 0;
    then the larger tile, whose weights and staging serve more stocks; then
    more blocks, then resident weights, then more weight buffers, then more
    panel buffers, then fewer threads). `registers` ({route: registers per
    thread}, as the built library reports them) bounds the blocks per SM
    too. G = min(cells, blocks per SM · sms). `tile` forces one stock tile.
    Raises if nothing fits."""
    route = dx_route(lay, compute_dtype)
    regs = (registers or {}).get(route, 0)
    # the member weights: resident, or streamed in two buffers or one
    bufs = sorted({S} | ({2} if S > 2 else set()) | ({1} if S > 1 else set()))
    plans = []
    for bn in (DX_TILES if tile is None else (tile,)):
        for threads in (DX_THREADS if route == 0 else (2 * bn,)):
            if (bn not in DX_TILES or route == 0
                    and -(-lay.F // DX_FEATURES) * (bn // 4) > threads):
                continue
            for wbufs in bufs:
                for xbufs in (1, 2):
                    smem = 4 * dx_geometry(lay, route, bn, wbufs, xbufs)[0]
                    if smem > MAX_SMEM:
                        continue
                    blocks = _resident(smem, threads, regs)
                    busy = blocks * threads * (_dx_busy(lay, bn, threads)
                                               if route == 0 else 1.0)
                    plans.append(((round(busy, 6), bn, blocks, wbufs == S,
                                   wbufs, xbufs, -threads),
                                  (bn, threads, wbufs, xbufs, smem, blocks)))
    plans = [p for p in plans if p[1][5] >= 1]
    if not plans:
        raise ValueError(f"sdf_ffn_dx: hidden {list(lay.hidden)} with F = "
                         f"{lay.F} does not fit the kernel's shared memory"
                         + (f" at tile {tile}" if tile else ""))
    tile, threads, wbufs, xbufs, smem, blocks = max(plans)[1]
    cells = T * -(-N // tile)
    return DxPlan(route, tile, threads, wbufs, xbufs, wbufs == S, smem,
                  blocks, min(cells, blocks * sms), cells)


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_bwd_regs: Dict[Tuple[int, bool], Dict[int, int]] = {}
_fwd_regs: Dict[Tuple[int, int, bool], Dict[int, int]] = {}
_fwd_plans: Dict[tuple, "FwdPlan"] = {}

# `xb16` below: plan for the kernel's bf16-panel instance (a bf16 x_t),
# whose registers are its own, else for its f32-panel one


_stream_regs: Dict[Tuple[str, int, bool], int] = {}


def _stream_registers(kernel: str, route: int, xb16: bool) -> int:
    """Registers per thread of the streamed `kernel`'s instance of `route`
    (0 if the library cannot say)."""
    key = (kernel, route, bool(xb16))
    if key not in _stream_regs:
        lib = _load_stream(kernel)
        r = (lib.sdf_ffn_stream_mma_registers(int(xb16))
             if route == STREAM_MMA_ROUTE
             else lib.sdf_ffn_stream_tiled_registers(int(xb16))
             if route == STREAM_TILED_ROUTE else lib.sdf_ffn_stream_registers(
                 int(route == STREAM_ROUTES["bfloat16"]), int(xb16)))
        _stream_regs[key] = max(r, 0)
    return _stream_regs[key]


def _card_plan(plan_fn, kernel, lay, sms, resident_regs, xb16, *args):
    """`plan_fn` at the resident library's registers (where the resident
    route can hold `lay`) and, where it takes a streamed route, again at
    that route's registers in the streamed library: a stack that needs no
    streamed library builds none."""
    regs = dict(resident_regs() if resident_fits(lay) else {})
    plan = plan_fn(lay, sms, *args, registers=regs)
    while is_stream(plan) and plan.route not in regs:
        regs[plan.route] = _stream_registers(kernel, plan.route, xb16)
        plan = plan_fn(lay, sms, *args, registers=regs)
    return plan


def card_bwd_plan(lay: FfnLayout, dev, S: int, T: int, N: int,
                  tile: int = None, xb16: bool = False,
                  compute_dtype: str = "float32") -> BwdPlan:
    """:func:`bwd_plan` for the card `dev`: its SM count, and the registers
    of the library's kernel instances (the resident ones, or the streamed
    one at `compute_dtype`)."""

    def resident():
        rkey = (width_bound(lay.hidden), bool(xb16))
        if rkey not in _bwd_regs:
            lib = _load("bwd", rkey[0])
            regs = {nt: lib.sdf_ffn_bwd_registers(nt, int(xb16))
                    for nt in (0,) + BWD_REG_TILES}
            _bwd_regs[rkey] = {nt: r for nt, r in regs.items() if r > 0}
        return _bwd_regs[rkey]

    def plan_fn(lay, sms, registers):
        return bwd_plan(lay, sms, S, T, N, tile, registers, compute_dtype)

    return _card_plan(plan_fn, "bwd", lay, _sm_count(dev), resident, xb16)


def card_fwd_plan(lay: FfnLayout, dev, S: int, T: int, N: int,
                  compute_dtype: str, xb16: bool = False) -> FwdPlan:
    """:func:`fwd_plan` for the card `dev`: its SM count, and the registers
    of the library's two kernels at the layout's F; kept per shape, so a serving loop plans
    each bucket once."""
    key = (lay, dev, S, T, N, compute_dtype, bool(xb16))
    if key not in _fwd_plans:
        def resident():
            lib_key = (width_bound(lay.hidden), lay.F, bool(xb16))
            if lib_key not in _fwd_regs:
                lib = _load("fwd", lib_key[0])
                _fwd_regs[lib_key] = {
                    r: lib.sdf_ffn_fwd_registers(r, lay.F, int(xb16))
                    for r in FWD_ROUTES.values()}
            return _fwd_regs[lib_key]

        def plan_fn(lay, sms, registers):
            return fwd_plan(lay, sms, S, T, N, compute_dtype, registers)

        _fwd_plans[key] = _card_plan(plan_fn, "fwd", lay, _sm_count(dev),
                                     resident, xb16)
    return _fwd_plans[key]


_dx_regs: Dict[Tuple[int, int, int, bool], Dict[int, int]] = {}
_dx_plans: Dict[tuple, DxPlan] = {}


def card_dx_plan(lay: FfnLayout, dev, S: int, T: int, N: int,
                 compute_dtype: str, tile: int = None,
                 xb16: bool = False) -> DxPlan:
    """:func:`dx_plan` for the card `dev`: its SM count, and the registers
    of the library's kernel for the layout's F and dtype; kept per shape
    (and forced `tile`).
    Each plan is checked on the card once, before its first launch
    (:func:`dx_plan_info`): one that the kernel refuses, or whose blocks
    the card does not keep resident, raises."""
    key = (lay, dev, S, T, N, compute_dtype, tile, bool(xb16))
    plan = _dx_plans.get(key)
    if plan is None:
        def resident():
            route = dx_route(lay, compute_dtype)
            bf16 = int(compute_dtype == "bfloat16")
            rkey = (width_bound(lay.hidden), lay.F, bf16, bool(xb16))
            if rkey not in _dx_regs:
                regs = _load("dx", rkey[0]).sdf_ffn_dx_registers(
                    route, bf16, lay.F, int(xb16))
                _dx_regs[rkey] = {route: regs} if regs > 0 else {}
            return _dx_regs[rkey]

        def plan_fn(lay, sms, registers):
            return dx_plan(lay, sms, S, T, N, compute_dtype, registers, tile)

        plan = _card_plan(plan_fn, "dx", lay, _sm_count(dev), resident,
                          xb16)
        with torch.cuda.device(dev):
            held = dx_plan_info(lay, S, compute_dtype, plan, xb16=xb16)
        if held["blocks_per_sm"] < plan.blocks_per_sm:
            raise RuntimeError(f"sdf_ffn_dx: the card keeps "
                               f"{held['blocks_per_sm']} blocks per SM of "
                               f"the plan {plan}")
        _dx_plans[key] = plan
    return plan


def dx_plan_info(lay: FfnLayout, S: int, compute_dtype: str,
                 plan: DxPlan, audit: bool = False,
                 xb16: bool = False) -> Dict[str, int]:
    """What the card makes of `plan` (the current CUDA device): resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers and local-memory bytes per thread of the kernel it launches
    (of the audit build's, with `audit`). Raises for a plan the kernel
    refuses."""
    if is_stream(plan):
        if audit and plan.route != STREAM_MMA_ROUTE:
            raise ValueError("sdf_ffn_dx: the audit builds are of the "
                             "certified routes (1, and the streamed route "
                             f"{STREAM_MMA_ROUTE}); the plan is route "
                             f"{plan.route}'s")
        return stream_plan_info("dx", lay, plan, xb16, audit)
    out = (ctypes.c_int * 3)()
    rc = _load("dx", width_bound(lay.hidden), audit).sdf_ffn_dx_plan_info(
        _layout_ints(lay), S, int(compute_dtype == "bfloat16"), plan.route,
        plan.tile, plan.threads, plan.wbufs, plan.xbufs, plan.smem_bytes,
        int(xb16), out)
    if rc != 0:
        raise RuntimeError(f"sdf_ffn_dx refused the plan {plan} (code {rc})")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


def fwd_plan_info(lay: FfnLayout, S: int, plan: FwdPlan,
                  xb16: bool = False) -> Dict[str, int]:
    """What the card makes of `plan` (the current CUDA device): resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers and local-memory bytes per thread of the kernel it launches.
    Raises for a plan the kernel refuses."""
    if is_stream(plan):
        return stream_plan_info("fwd", lay, plan, xb16)
    out = (ctypes.c_int * 3)()
    rc = _load("fwd", width_bound(lay.hidden)).sdf_ffn_fwd_plan_info(
        _layout_ints(lay), S, plan.route, plan.tile, plan.threads,
        plan.members, plan.smem_bytes, int(xb16), out)
    if rc != 0:
        raise RuntimeError(f"sdf_ffn_fwd refused the plan {plan} (code {rc})")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


def bwd_plan_info(lay: FfnLayout, plan: BwdPlan,
                  xb16: bool = False) -> Dict[str, int]:
    """What the card makes of `plan` (the current CUDA device): resident
    blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers and local-memory bytes per thread of the kernel instance it
    launches. Raises for a plan the kernel refuses."""
    if is_stream(plan):
        return stream_plan_info("bwd", lay, plan, xb16)
    out = (ctypes.c_int * 3)()
    rc = _load("bwd", width_bound(lay.hidden)).sdf_ffn_bwd_plan_info(
        _layout_ints(lay), plan.tile, plan.threads, plan.nt,
        plan.smem_bytes, int(xb16), out)
    if rc != 0:
        raise RuntimeError(f"sdf_ffn_bwd refused the plan {plan} (code {rc})")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


def stream_plan_info(kernel: str, lay: FfnLayout, plan,
                     xb16: bool = False, audit: bool = False
                     ) -> Dict[str, int]:
    """What the card makes of a streamed `plan` of `kernel` (the current
    CUDA device): resident blocks per SM, registers and local-memory bytes
    per thread of the instance it launches (the plan's route names the
    compute dtype; `audit`: of the dx's audit build). Raises for a plan the
    kernel refuses."""
    out = (ctypes.c_int * 3)()
    lib = _load_stream(kernel, audit)
    rc = (lib.sdf_ffn_stream_mma_plan_info(
        _layout_ints(lay), plan.tile, plan.smem_bytes, int(xb16), out)
        if plan.route == STREAM_MMA_ROUTE
        else lib.sdf_ffn_stream_tiled_plan_info(
            _layout_ints(lay), plan.tile, plan.smem_bytes, int(xb16), out)
        if plan.route == STREAM_TILED_ROUTE else lib.sdf_ffn_stream_plan_info(
            _layout_ints(lay), int(plan.route == STREAM_ROUTES["bfloat16"]),
            plan.tile, plan.smem_bytes, int(plan.scratch > 0), int(xb16),
            out))
    if rc != 0:
        raise RuntimeError(f"sdf_ffn_{kernel}_stream refused the plan {plan}"
                           f" (code {rc})")
    return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2])


_layouts_dev: Dict[Tuple[FfnLayout, str], torch.Tensor] = {}


def _layout_dev(lay: FfnLayout, dev) -> torch.Tensor:
    """The layout's ints on the card (the streamed kernels' LayoutTable),
    copied once per (layout, device)."""
    key = (lay, str(dev))
    if key not in _layouts_dev:
        _layouts_dev[key] = torch.tensor(lay.as_ints(), dtype=torch.int32,
                                         device=dev)
    return _layouts_dev[key]


def _stream_launch(kernel: str, x_t: torch.Tensor, zp: torch.Tensor,
                   packed: PackedFfn, plan, seed: Seed, dropout_rate: float,
                   offset: int, outs: Sequence[torch.Tensor]) -> None:
    """One launch of the streamed `kernel` at `plan` writing `outs` (fwd:
    out; bwd: g, grad_part, dzp_part; dx: g, dx), inputs checked by the
    caller; counts it under the kernel and its ``_stream`` form (and the
    register-tiled route's also under ``_stream_tiled``)."""
    lay = packed.layout
    T, _, N = x_t.shape
    S = packed.n_members
    dev = x_t.device
    mma = plan.route == STREAM_MMA_ROUTE
    tiled = plan.route == STREAM_TILED_ROUTE
    if not (plan.route == STREAM_ROUTES[packed.compute_dtype]
            or (mma and packed.compute_dtype == "bfloat16")
            or (tiled and packed.compute_dtype == "float32")):
        raise ValueError(f"sdf_ffn_{kernel}: the plan {plan} is not the "
                         f"streamed route at {packed.compute_dtype}")
    if mma:
        _stream_mma_launch(kernel, x_t, zp, packed, plan, seed, dropout_rate,
                           offset, outs)
        return
    if tiled:
        fixed, tf = stream_geometry(lay, kernel, plan.tile, plan.route)
        if (plan.tile not in STREAM_TILED_TILES or plan.scratch
                or plan.smem_bytes != 4 * (fixed + tf)
                or plan.smem_bytes > MAX_SMEM):
            raise ValueError(
                f"sdf_ffn_{kernel}: route {STREAM_TILED_ROUTE} refuses the "
                f"plan {plan}: a tile of {STREAM_TILED_TILES} in shared "
                f"memory, {4 * (fixed + tf)} B at tile {plan.tile} against "
                f"its {MAX_SMEM} (shared memory)")
    blocks = plan.G * (S if kernel == "bwd" else 1)
    scratch = (torch.empty(blocks * plan.scratch, dtype=torch.float32,
                           device=dev) if plan.scratch else None)
    drop, _bases = _dropout_args(seed, dropout_rate, S, dev, offset)
    lib = _load_stream(kernel)
    entry = f"sdf_ffn_{kernel}_stream" + ("_tiled" if tiled else "")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        head = (*_panel_args(x_t), zp.data_ptr(), packed.params.data_ptr(),
                *(t.data_ptr() for t in outs))
        layout = (_layout_ints(lay), _layout_dev(lay, dev).data_ptr(), S, T,
                  N)
        tail = (plan.tile, plan.smem_bytes, plan.G, stream)
        rc = (getattr(lib, entry)(*head, *layout, *drop, *tail) if tiled
              else getattr(lib, entry)(
                  *head, None if scratch is None else scratch.data_ptr(),
                  *layout, int(packed.compute_dtype == "bfloat16"), *drop,
                  *tail))
    if rc == -1:
        raise RuntimeError(f"{entry} refused the plan {plan} for hidden "
                           f"{list(lay.hidden)}, F = {lay.F}")
    _raise_rc(entry, rc)
    panel_launch(f"sdf_ffn_{kernel}", x_t)
    count_launch(f"sdf_ffn_{kernel}{STREAM}", dev)
    if tiled:
        count_launch(f"sdf_ffn_{kernel}{STREAM_TILED}", dev)


def stream_mma_table(lay: FfnLayout) -> Tuple[int, List[int]]:
    """(bf16 values a member, [off_a, ld_a, off_t, ld_t] per layer) of the
    bf16 weight copy the tensor-core route streams: each layer l's matrix
    A_l [pad16(h_l)][ld_a] (A_l[u][k] = the weight from input k to unit u;
    ld_a = the layer's inputs padded to STREAM_MMA_SLAB), in layer order,
    then for l ≥ 1 its transpose [pad16(h_{l-1})][ld_t] (the dh chain's
    Wᵀ; ld_t = h_l padded), then layer 0's, K1 [pad16(F)][ld_t] (the panel
    cotangent's dx product), zero past each matrix. Every offset and row is
    a multiple of 8 values (16 bytes)."""
    h, ins = lay.hidden, (lay.F,) + lay.hidden[:-1]
    off, tab = 0, []
    for li in range(len(h)):
        ld = _pad(ins[li], STREAM_MMA_SLAB)
        tab.append([off, ld, 0, 0])
        off += _pad(h[li], 16) * ld
    for li in list(range(1, len(h))) + [0]:
        ld = _pad(h[li], STREAM_MMA_SLAB)
        tab[li][2:] = [off, ld]
        off += _pad(ins[li], 16) * ld
    return off, [x for row in tab for x in row]


def _stream_mma_index(lay: FfnLayout) -> Tuple[int, np.ndarray]:
    """(values a member, the packed f32 index each value of the bf16 copy
    reads: P, one past the packed row, where it is zero)."""
    Pb, tab = stream_mma_table(lay)
    src = np.full(Pb, lay.P, np.int64)
    h, hp = lay.hidden, lay.hp
    for li in range(len(h)):
        off_a, ld_a, off_t, ld_t = tab[4 * li:4 * li + 4]
        u = np.arange(h[li])[:, None]
        if li == 0:  # k1 [F][hp0]: input k, unit u at k·hp0 + u
            k = np.arange(lay.F)[None, :]
            at = k * hp[0] + u
        else:  # W_l [h_l][hp_{l-1}]
            k = np.arange(h[li - 1])[None, :]
            at = lay.off_w[li] + u * hp[li - 1] + k
        src[off_a + u * ld_a + k] = at
        src[off_t + k.T * ld_t + u.T] = at.T
    return Pb, src


_mma_index: Dict[Tuple[FfnLayout, str], Tuple[int, torch.Tensor]] = {}
_mma_tabs: Dict[Tuple[FfnLayout, str], torch.Tensor] = {}


def stream_mma_weights(packed: PackedFfn) -> torch.Tensor:
    """[S, Pb] bf16: the bf16 copy of `packed`'s weights that the
    tensor-core route streams (:func:`stream_mma_table`'s layout), gathered
    from packed.params on their device. Under bf16 compute the packed
    weights are already bf16 values (:func:`pack_ffn`), so the copy is
    exact. The route's wrapper makes it at each launch, so it follows
    weights updated in place (a serving engine's hot reload, a CUDA graph's
    replay)."""
    if packed.compute_dtype != "bfloat16":
        raise ValueError("sdf_ffn: the bf16 weight copy is the bf16-compute "
                         "route's")
    dev = packed.params.device
    key = (packed.layout, str(dev))
    if key not in _mma_index:
        Pb, src = _stream_mma_index(packed.layout)
        _mma_index[key] = (Pb, torch.from_numpy(src).to(dev))
    _, src = _mma_index[key]
    padded = torch.nn.functional.pad(packed.params, (0, 1))
    return padded[:, src].to(torch.bfloat16).contiguous()


def stream_mma_wabs(packed: PackedFfn) -> torch.Tensor:
    """[S, HL] f32: Σ_k |W_uk| over the inputs k of each unit u of each
    member's top layer (K1's columns in a one-layer stack), from
    packed.params on their device: the magnitude bound of route 4's
    certified window. The dx's wrapper makes it at each launch, as it makes
    the bf16 copy."""
    lay, S = packed.layout, packed.n_members
    h, hp, p = lay.hidden, lay.hp, packed.params
    if len(h) == 1:
        k1 = p[:, :lay.F * hp[0]].view(S, lay.F, hp[0])
        return k1.abs().sum(dim=1)[:, :h[0]].contiguous()
    o = lay.off_w[-1]
    w = p[:, o:o + h[-1] * hp[-2]].view(S, h[-1], hp[-2])
    return w.abs().sum(dim=2).contiguous()


def _stream_mma_launch(kernel: str, x_t: torch.Tensor, zp: torch.Tensor,
                       packed: PackedFfn, plan, seed: Seed,
                       dropout_rate: float, offset: int,
                       outs: Sequence[torch.Tensor], lib=None) -> None:
    """One launch of the streamed `kernel`'s tensor-core form at `plan`
    (fwd: out; bwd: g, grad_part, dzp_part; dx: g, dx), the bf16 weight copy
    (and the dx's :func:`stream_mma_wabs`) made here; counts it under the
    kernel, its ``_stream`` and its ``_stream_mma`` forms. `lib`: another
    build of the kernel's library (the dx audit's), whose launch is not
    counted."""
    lay = packed.layout
    T, _, N = x_t.shape
    S = packed.n_members
    dev = x_t.device
    wb = stream_mma_weights(packed)
    if kernel == "dx":
        outs = tuple(outs) + (stream_mma_wabs(packed),)
    key = (lay, str(dev))
    if key not in _mma_tabs:
        _mma_tabs[key] = torch.tensor(stream_mma_table(lay)[1],
                                      dtype=torch.int32, device=dev)
    drop, _bases = _dropout_args(seed, dropout_rate, S, dev, offset)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib or _load_stream(kernel),
                     f"sdf_ffn_{kernel}_stream_mma")(
            *_panel_args(x_t), zp.data_ptr(), packed.params.data_ptr(),
            wb.data_ptr(), _mma_tabs[key].data_ptr(), wb.shape[1],
            *(t.data_ptr() for t in outs), _layout_ints(lay),
            _layout_dev(lay, dev).data_ptr(), S, T, N, *drop, plan.tile,
            plan.smem_bytes, plan.G, stream)
    if rc == -1:
        raise RuntimeError(f"sdf_ffn_{kernel}_stream_mma refused the plan "
                           f"{plan} for hidden {list(lay.hidden)}, F = "
                           f"{lay.F}")
    _raise_rc(f"sdf_ffn_{kernel}_stream_mma", rc)
    if lib is not None:
        return
    panel_launch(f"sdf_ffn_{kernel}", x_t)
    count_launch(f"sdf_ffn_{kernel}{STREAM}", dev)
    count_launch(f"sdf_ffn_{kernel}{STREAM_MMA}", dev)


def _launch_bwd(x_t: torch.Tensor, zp: torch.Tensor, packed: PackedFfn,
                g: torch.Tensor, seed: Seed = 0, dropout_rate: float = 0.0,
                plan: BwdPlan = None, offset: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grads [S, P] in the packed layout, dzp [S, T, H1]); `plan` defaults
    to :func:`card_bwd_plan` for this card."""
    lay = packed.layout
    T, F, N = x_t.shape
    S = packed.n_members
    dev = x_t.device
    _check_cuda("x_t", x_t, (T, lay.F, N), dev, PANEL_DTYPES)
    _check_cuda("zp", zp, (S, T, lay.hidden[0]), dev)
    _check_cuda("params", packed.params, (S, lay.P), dev)
    _check_cuda("g", g, (S, T, N), dev)
    if plan is None:
        plan = card_bwd_plan(lay, dev, S, T, N, xb16=is_bf16(x_t),
                             compute_dtype=packed.compute_dtype)
    G = plan.G
    grad_part = torch.zeros((S, G, lay.P), dtype=torch.float32, device=dev)
    dzp_part = torch.zeros((S, G, T, lay.hidden[0]), dtype=torch.float32,
                           device=dev)
    if is_stream(plan):
        _stream_launch("bwd", x_t, zp, packed, plan, seed, dropout_rate,
                       offset, (g, grad_part, dzp_part))
        return grad_part.sum(dim=1), dzp_part.sum(dim=1)
    lib = _load("bwd", width_bound(lay.hidden))
    drop, _bases = _dropout_args(seed, dropout_rate, S, dev, offset)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdf_ffn_bwd(
            *_panel_args(x_t), zp.data_ptr(), packed.params.data_ptr(),
            g.data_ptr(), grad_part.data_ptr(), dzp_part.data_ptr(), S, T, N,
            _layout_ints(lay), int(packed.compute_dtype == "bfloat16"),
            *drop, G, plan.tile, plan.threads, plan.nt, plan.smem_bytes,
            plan.blocks_per_sm, stream)
    if rc == -1:
        raise RuntimeError(f"sdf_ffn_bwd refused the plan {plan} for hidden "
                           f"{list(lay.hidden)}, F = {lay.F}")
    _raise_rc("sdf_ffn_bwd", rc)
    panel_launch("sdf_ffn_bwd", x_t)
    # the fixed-order pass over the per-block partials
    return grad_part.sum(dim=1), dzp_part.sum(dim=1)


def _dx_call(lib, x_t: torch.Tensor, zp: torch.Tensor, packed: PackedFfn,
             g: torch.Tensor, seed: Seed, dropout_rate: float,
             plan: Optional[DxPlan], offset: int = 0) -> torch.Tensor:
    """One launch of `lib`'s sdf_ffn_dx (the main library or its audit
    build) at `plan`, :func:`card_dx_plan` by default; a streamed plan
    launches the streamed library (`lib` None), or its audit build (`lib`,
    a route-4 plan)."""
    lay = packed.layout
    T, F, N = x_t.shape
    S = packed.n_members
    dev = x_t.device
    _check_cuda("x_t", x_t, (T, lay.F, N), dev, PANEL_DTYPES)
    _check_cuda("zp", zp, (S, T, lay.hidden[0]), dev)
    _check_cuda("params", packed.params, (S, lay.P), dev)
    _check_cuda("g", g, (S, T, N), dev)
    cd = packed.compute_dtype
    if plan is None:
        plan = card_dx_plan(lay, dev, S, T, N, cd, xb16=is_bf16(x_t))
    # in the panel's dtype: a bf16 dx is rounded once, in the kernel
    dx = torch.empty((T, lay.F, N), dtype=x_t.dtype, device=dev)
    if is_stream(plan):
        if lib is None:
            _stream_launch("dx", x_t, zp, packed, plan, seed, dropout_rate,
                           offset, (g, dx))
        else:
            _stream_mma_launch("dx", x_t, zp, packed, plan, seed,
                               dropout_rate, offset, (g, dx), lib)
        return dx
    # route 1's member images (bf16 rows), written by the launch itself
    img = (torch.empty(S * dx_geometry(lay, 1, plan.tile, plan.wbufs,
                                       plan.xbufs)[1],
                       dtype=torch.int32, device=dev)
           if plan.route == 1 else None)
    drop, _bases = _dropout_args(seed, dropout_rate, S, dev, offset)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdf_ffn_dx(
            *_panel_args(x_t), zp.data_ptr(), packed.params.data_ptr(),
            g.data_ptr(), dx.data_ptr(),
            None if img is None else img.data_ptr(), S, T, N,
            _layout_ints(lay), int(cd == "bfloat16"), *drop, plan.route,
            plan.tile, plan.threads, plan.wbufs, plan.xbufs, plan.smem_bytes,
            plan.G, stream)
    if rc == -1:
        raise RuntimeError(f"sdf_ffn_dx refused the plan {plan} for hidden "
                           f"{list(lay.hidden)}, F = {lay.F}")
    _raise_rc("sdf_ffn_dx", rc)
    return dx


def _launch_dx(x_t: torch.Tensor, zp: torch.Tensor, packed: PackedFfn,
               g: torch.Tensor, seed: Seed = 0, dropout_rate: float = 0.0,
               plan: DxPlan = None, offset: int = 0) -> torch.Tensor:
    """The panel cotangent dx [T, F, N] in the panel's dtype, summed over
    the members; `plan` defaults to :func:`card_dx_plan` for this card."""
    if plan is None:
        plan = card_dx_plan(packed.layout, x_t.device, packed.n_members,
                            x_t.shape[0], x_t.shape[2], packed.compute_dtype,
                            xb16=is_bf16(x_t))
    if is_stream(plan):  # counted where it launches
        return _dx_call(None, x_t, zp, packed, g, seed, dropout_rate, plan,
                        offset)
    dx = _dx_call(_load("dx", width_bound(packed.layout.hidden)), x_t, zp,
                  packed, g, seed, dropout_rate, plan, offset)
    panel_launch("sdf_ffn_dx", x_t)
    return dx


def dx_audit(x_t: torch.Tensor, zp: torch.Tensor, packed: PackedFfn,
             g: torch.Tensor, seed: Seed = 0, dropout_rate: float = 0.0,
             plan: DxPlan = None, offset: int = 0
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """:func:`_launch_dx` through the audit build (:func:`audit_job`, or
    :func:`stream_audit_job` for a route-4 plan): (dx, the launch's counters
    of the top-layer decisions of route 1 or 4, keyed by
    :data:`AUDIT_COUNTERS`: ``max_ratio`` is the largest |mma − chain| /
    (max|a|·Σ|W| + |b|); beside them the audit kernel's ``registers`` and
    ``local_bytes``). It launches no kernel of the main path and counts no
    launch; it waits for the card."""
    lay = packed.layout
    dev = x_t.device
    if dev.type != "cuda":
        raise ValueError(f"dx_audit runs the audit kernel on CUDA tensors; "
                         f"got {dev}")
    if plan is None:
        plan = card_dx_plan(lay, dev, packed.n_members, x_t.shape[0],
                            x_t.shape[2], packed.compute_dtype,
                            xb16=is_bf16(x_t))
    lib = (_load_stream("dx", audit=True) if is_stream(plan)
           else _load("dx", width_bound(lay.hidden), audit=True))
    out = (ctypes.c_ulonglong * len(AUDIT_COUNTERS))()
    with torch.cuda.device(dev):
        # opens the audit kernel to the plan's shared memory
        held = dx_plan_info(lay, packed.n_members, packed.compute_dtype,
                            plan, audit=True, xb16=is_bf16(x_t))
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_rc("sdf_ffn_dx_audit_reset", lib.sdf_ffn_dx_audit_reset(stream))
        dx = _dx_call(lib, x_t, zp, packed, g, seed, dropout_rate, plan,
                      offset)
        _raise_rc("sdf_ffn_dx_audit_read",
                  lib.sdf_ffn_dx_audit_read(out, stream))
    counts = {k: int(v) for k, v in zip(AUDIT_COUNTERS[:-1], out[:-1])}
    counts["max_ratio"] = float(np.array([out[-1]], np.uint64).astype(
        np.uint32).view(np.float32)[0])
    counts.update(registers=held["registers"],
                  local_bytes=held["local_bytes"])
    return dx, counts


def unpack_grads(grads: torch.Tensor, lay: FfnLayout):
    """Packed-layout gradients [S, P] → (dk1T [S, H1, F], ((dW [S, H, Hin],
    db [S, H]), ...), dkout [S, HL], dbout [S])."""
    S = grads.shape[0]
    h = lay.hidden
    dk1T = grads[:, :lay.F * lay.hp[0]].view(S, lay.F, lay.hp[0])
    dk1T = dk1T[:, :, :h[0]].transpose(1, 2)
    dmids = []
    for li in range(1, len(h)):
        o = lay.off_w[li]
        dW = grads[:, o:o + h[li] * lay.hp[li - 1]].view(
            S, h[li], lay.hp[li - 1])[:, :, :h[li - 1]]
        db = grads[:, lay.off_b[li]:lay.off_b[li] + h[li]]
        dmids.append((dW, db))
    dkout = grads[:, lay.off_kout:lay.off_kout + h[-1]]
    return dk1T, tuple(dmids), dkout, grads[:, lay.off_bout]


def _route(x_t: torch.Tensor, kernel: str) -> str:
    """"kernel" or "plain": a CUDA panel launches the kernel ("auto" or
    "on"), a CPU panel runs the plain version, and "off" asks for the plain
    route explicitly on any device."""
    if kernel not in ("auto", "on", "off"):
        raise ValueError(f"kernel must be auto|on|off: {kernel!r}")
    if kernel == "off" or (kernel == "auto" and x_t.device.type == "cpu"):
        return "plain"
    if x_t.device.type != "cuda":
        raise ValueError(f"kernel='on' needs a CUDA panel; got {x_t.device}")
    return "kernel"


def sdf_ffn_packed(x_t: torch.Tensor, zp: torch.Tensor, packed: PackedFfn,
                   kernel: str = "auto", dropout_rate: float = 0.0,
                   seed: Seed = 0, offset: int = 0) -> torch.Tensor:
    """Raw weights [S, T, N] from pre-packed member weights (the serving
    path: no gradient)."""
    check_panel_dtype(x_t)
    if _route(x_t, kernel) == "plain":
        return sdf_ffn_reference(x_t, zp, packed.k1T, packed.mids,
                                 packed.kout, packed.bout,
                                 packed.compute_dtype, seed, dropout_rate,
                                 offset)
    return _launch(x_t, zp, packed, seed, dropout_rate, offset)


class _SdfFfn(torch.autograd.Function):
    """Forward: the fwd kernel (or its plain version); backward: the dx
    kernel for the panel and the bwd kernel for zp and the weights (or
    their plain versions), each only when one of its inputs needs a
    gradient, regenerating the forward's dropout masks from the seed(s).
    Packing happens here; autograd sees the raw tensors."""

    @staticmethod
    def forward(ctx, meta, x_t, zp, k1T, kout, bout, *mids_flat):
        route, cd, seed, rate, off = meta
        mids = tuple(zip(mids_flat[0::2], mids_flat[1::2]))
        ctx.meta = meta
        ctx.n_mids = len(mids)
        ctx.save_for_backward(x_t, zp, k1T, kout, *mids_flat)
        if route == "plain":
            return sdf_ffn_reference(x_t, zp, k1T, mids, kout, bout, cd,
                                     seed, rate, off)
        ctx.packed = pack_ffn(k1T, mids, kout, bout, cd)
        return _launch(x_t, zp, ctx.packed, seed, rate, off)

    @staticmethod
    def backward(ctx, g):
        route, cd, seed, rate, off = ctx.meta
        x_t, zp, k1T, kout, *mids_flat = ctx.saved_tensors
        mids = tuple(zip(mids_flat[0::2], mids_flat[1::2]))
        need = ctx.needs_input_grad  # (meta, x_t, zp, k1T, kout, bout, *mids)
        g = g.float().contiguous()
        dx = None
        if need[1]:
            dx = (sdf_ffn_dx_reference(x_t, zp, k1T, mids, kout, g, cd, seed,
                                       rate, off) if route == "plain" else
                  _launch_dx(x_t, zp.contiguous(), ctx.packed, g, seed,
                             rate, offset=off))
        grads = [None] * (len(need) - 2)
        if any(need[2:]):
            if route == "plain":
                dzp, dk1T, dmids, dkout, dbout = sdf_ffn_bwd_reference(
                    x_t, zp, k1T, mids, kout, g, cd, seed, rate, off)
            else:
                flat, dzp = _launch_bwd(x_t, zp.contiguous(), ctx.packed, g,
                                        seed, rate, offset=off)
                dk1T, dmids, dkout, dbout = unpack_grads(flat,
                                                         ctx.packed.layout)
            grads = [d if n else None for d, n in zip(
                [dzp, dk1T, dkout, dbout, *(t for wb in dmids for t in wb)],
                need[2:])]
        return (None, dx, *grads)


def sdf_ffn(x_t: torch.Tensor, zp: torch.Tensor, k1T: torch.Tensor,
            mids: Mids, kout: torch.Tensor, bout: torch.Tensor, *,
            seed: Seed = 0, dropout_rate: float = 0.0,
            compute_dtype: str = "bfloat16",
            kernel: str = "auto", offset: int = 0) -> torch.Tensor:
    """Differentiable fused FFN: raw weights [S, T, N].

    Gradients flow to the panel x_t (summed over the members, which share
    it), to zp (and through it to the macro path) and to every weight and
    bias. ``seed`` (one int, or S ints: one per member) and
    ``dropout_rate`` draw the dropout masks, identically in the forward and
    the backward; ``offset`` is the global index of x_t's first stock (a
    stock shard's start). x_t is float32 or bfloat16; its gradient comes
    back in its dtype. The plain route takes any depth and width; the
    kernel route's limits are its plans' (a shape no route plans raises
    where it is launched, naming the limit)."""
    _check_dtype(compute_dtype)
    check_panel_dtype(x_t)
    S, H1, F = k1T.shape
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1): {dropout_rate}")
    meta = (_route(x_t, kernel), compute_dtype, member_seeds(seed, S),
            float(dropout_rate), int(offset))
    flat = [t for wb in mids for t in wb]
    return _SdfFfn.apply(meta, x_t, zp, k1T, kout, bout, *flat)


# -- the bounds -----------------------------------------------------------------


def flops(S: int, T: int, N: int, F: int, hidden: Sequence[int]) -> int:
    """Multiply-adds ×2 of one forward: 2·(F·H1 + Σ H_{l-1}·H_l + H_L) per
    (member, period, stock)."""
    per = F * hidden[0] + sum(a * b for a, b in zip(hidden, hidden[1:]))
    per += hidden[-1]
    return 2 * per * S * T * N


def bytes_moved(S: int, T: int, N: int, F: int, hidden: Sequence[int],
                x_bytes: int = 4) -> int:
    """Each input read once, the output written once: the panel (`x_bytes`
    a value: 4 in f32, 2 in bf16), zp, the packed weights, and the
    [S, T, N] output (f32)."""
    lay = ffn_layout(F, hidden)
    return (x_bytes * T * F * N
            + 4 * (S * T * hidden[0] + S * lay.P + S * T * N))


def bwd_flops(S: int, T: int, N: int, F: int, hidden: Sequence[int]) -> int:
    """Multiply-adds ×2 of one backward: the recomputed hidden stack, then
    per layer the weight gradient (H·Hin) and, above the first layer, the
    propagated dh (H·Hin), plus the output projection's dkout and dh —
    about 2.6× the forward at the paper's widths."""
    mids = sum(a * b for a, b in zip(hidden, hidden[1:]))
    per = F * hidden[0] + mids  # the recomputed hidden stack
    per += F * hidden[0] + 2 * mids + 2 * hidden[-1]  # the gradients
    return 2 * per * S * T * N


def bwd_bytes_moved(S: int, T: int, N: int, F: int,
                    hidden: Sequence[int], x_bytes: int = 4) -> int:
    """The panel (`x_bytes` a value), zp, the weights and g read once; dzp
    and the parameter gradients written once (f32)."""
    lay = ffn_layout(F, hidden)
    return (x_bytes * T * F * N
            + 4 * (2 * S * T * hidden[0] + 2 * S * lay.P + S * T * N))


def dx_flops(S: int, T: int, N: int, F: int, hidden: Sequence[int]) -> int:
    """Multiply-adds ×2 of one panel cotangent: the recomputed hidden stack
    (F·H1 + Σ H_{l-1}·H_l), the dh chain (H_L for kout·g, then Σ H_{l-1}·H_l)
    and dx = K1·dh1_pre (F·H1) — about twice the forward."""
    mids = sum(a * b for a, b in zip(hidden, hidden[1:]))
    per = 2 * F * hidden[0] + 2 * mids + hidden[-1]
    return 2 * per * S * T * N


def dx_bytes_moved(S: int, T: int, N: int, F: int,
                   hidden: Sequence[int], x_bytes: int = 4) -> int:
    """The panel, zp, the weights and g read once; dx [T, F, N] written
    once, in the panel's dtype (`x_bytes` a value)."""
    lay = ffn_layout(F, hidden)
    return (2 * x_bytes * T * F * N
            + 4 * (S * T * hidden[0] + S * lay.P + S * T * N))
