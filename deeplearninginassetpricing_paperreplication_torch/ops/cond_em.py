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
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import torch

from . import _nvcc
from .sdf_ffn import _check_dtype, _raise_rc, _round, _route

MAX_MOMENTS = 16
FWD_STOCKS = 64  # stocks per forward block
BWD_STOCKS = 128  # stocks per backward block (its shared-memory tile)

# launches of the CUDA kernels, counted where the wrapper launches them
fwd_launches = 0
bwd_launches = 0
dx_launches = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_count() -> None:
    global fwd_launches, bwd_launches, dx_launches
    fwd_launches = 0
    bwd_launches = 0
    dx_launches = 0


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
    ``pallas_moment._dx_kernel``)."""
    _, dpre = _dpre(x_t, zp_m, xr, tinv, kT, gem, compute_dtype)
    return torch.einsum("skf,stkn->tfn", _round(kT, compute_dtype),
                        _round(dpre, compute_dtype))


# -- the CUDA kernels ----------------------------------------------------------


def build_jobs() -> List[_nvcc.Job]:
    return [_nvcc.Job("cond_em", "cond_em.cu")]


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            (job,) = build_jobs()
            _nvcc.run([job])
            lib = ctypes.CDLL(str(job.path))
            lib.cond_em_fwd.argtypes = ([ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
            lib.cond_em_bwd.argtypes = ([ctypes.c_void_p] * 9
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
            lib.cond_em_dx.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
            lib.cond_em_fwd.restype = lib.cond_em_bwd.restype = ctypes.c_int
            lib.cond_em_dx.restype = ctypes.c_int
            _lib = lib
        return _lib


def _groups(S: int, T: int, N: int, stocks: int, sms: int, waves: int) -> int:
    """Period groups per (member, stock block): enough blocks for `waves`
    blocks per SM, never more groups than periods."""
    blocks = S * (-(-N // stocks))
    return max(1, min(T, -(-waves * sms // blocks)))


def _checked(x_t, zp_m, xr, tinv, kT):
    T, F, N = x_t.shape
    S, K, _ = kT.shape
    if K > MAX_MOMENTS:
        raise ValueError(f"cond_em: at most {MAX_MOMENTS} moments; got {K}")
    dev = x_t.device
    for name, t, shape in (("x_t", x_t, (T, F, N)), ("zp_m", zp_m, (S, T, K)),
                           ("xr", xr, (S, T, N)), ("tinv", tinv, (N,)),
                           ("kT", kT, (S, K, F))):
        if (t.device != dev or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(
                f"cond_em: {name} must be a contiguous float32 {list(shape)}"
                f" tensor on {dev}; got {t.dtype} {list(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    return S, T, F, N, K, dev


def _launch_fwd(x_t, zp_m, xr, tinv, kT, compute_dtype):
    global fwd_launches
    kT = _round(kT, compute_dtype).contiguous()
    S, T, F, N, K, dev = _checked(x_t, zp_m, xr, tinv, kT)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = _groups(S, T, N, FWD_STOCKS, sms, 4)
    em_part = torch.empty((S, groups, K, N), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.cond_em_fwd(
            x_t.data_ptr(), zp_m.data_ptr(), xr.data_ptr(), tinv.data_ptr(),
            kT.data_ptr(), em_part.data_ptr(), S, T, F, N, K, groups,
            int(compute_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc("cond_em_fwd", rc)
    fwd_launches += 1
    return em_part.sum(dim=1)  # the fixed-order pass over the period groups


def _launch_bwd(x_t, zp_m, xr, tinv, kT, gem, compute_dtype):
    global bwd_launches
    kT = _round(kT, compute_dtype).contiguous()
    S, T, F, N, K, dev = _checked(x_t, zp_m, xr, tinv, kT)
    gem = gem.float().contiguous()
    if tuple(gem.shape) != (S, K, N):
        raise ValueError(f"cond_em: gem must be {[S, K, N]}; got "
                         f"{list(gem.shape)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = -(-N // BWD_STOCKS)
    groups = _groups(S, T, N, BWD_STOCKS, sms, 4)
    dkT_part = torch.empty((S, groups * tiles, K, F), dtype=torch.float32,
                           device=dev)
    dzpm_part = torch.empty((S, tiles, T, K), dtype=torch.float32,
                            device=dev)
    dxr = torch.empty((S, T, N), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.cond_em_bwd(
            x_t.data_ptr(), zp_m.data_ptr(), xr.data_ptr(), tinv.data_ptr(),
            kT.data_ptr(), gem.data_ptr(), dkT_part.data_ptr(),
            dzpm_part.data_ptr(), dxr.data_ptr(), S, T, F, N, K, groups,
            int(compute_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc("cond_em_bwd", rc)
    bwd_launches += 1
    return dkT_part.sum(dim=1), dzpm_part.sum(dim=1), dxr


def _launch_dx(x_t, zp_m, xr, tinv, kT, gem, compute_dtype):
    """The panel cotangent dx [T, F, N], summed over the members."""
    global dx_launches
    kT = _round(kT, compute_dtype).contiguous()
    S, T, F, N, K, dev = _checked(x_t, zp_m, xr, tinv, kT)
    gem = gem.float().contiguous()
    if tuple(gem.shape) != (S, K, N):
        raise ValueError(f"cond_em: gem must be {[S, K, N]}; got "
                         f"{list(gem.shape)}")
    dx = torch.empty((T, F, N), dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.cond_em_dx(
            x_t.data_ptr(), zp_m.data_ptr(), xr.data_ptr(), tinv.data_ptr(),
            kT.data_ptr(), gem.data_ptr(), dx.data_ptr(), S, T, F, N, K,
            int(compute_dtype == "bfloat16"),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc("cond_em_dx", rc)
    dx_launches += 1
    return dx


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
    em [S, K, N]. Differentiable with respect to the panel x_t (summed over
    the members, which share it), zp_m, xr, k_stock and tinv."""
    _check_dtype(compute_dtype)
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


def fwd_bytes_moved(S: int, T: int, N: int, F: int, K: int) -> int:
    """The panel, zp_m, xr, tinv and kT read once, em written once (f32)."""
    return 4 * (T * F * N + S * T * K + S * T * N + N + S * K * F
                + S * K * N)


def bwd_flops(S: int, T: int, N: int, F: int, K: int) -> int:
    """The recomputed pre-activation and dkT (2·K·F each), plus dpre, dxr
    and dzp_m (about 4·K) per (member, period, stock)."""
    return 2 * S * T * N * K * (2 * F + 2)


def bwd_bytes_moved(S: int, T: int, N: int, F: int, K: int) -> int:
    """The forward's inputs and gem read once; dkT, dzp_m and dxr written
    once (f32)."""
    return 4 * (T * F * N + 2 * S * T * K + 2 * S * T * N + N
                + 2 * S * K * F + S * K * N)



def dx_flops(S: int, T: int, N: int, F: int, K: int) -> int:
    """The recomputed pre-activation and dx (2·K·F each), plus dpre (about
    4·K) per (member, period, stock)."""
    return 2 * S * T * N * K * (2 * F + 2)


def dx_bytes_moved(S: int, T: int, N: int, F: int, K: int) -> int:
    """The forward's inputs and gem read once; dx [T, F, N] written once
    (f32)."""
    return 4 * (2 * T * F * N + S * T * K + S * T * N + N + S * K * F
                + S * K * N)
