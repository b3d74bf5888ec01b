"""Dual roofline accounting: analytic FLOPs and device-memory bytes per
training pass, for the H100.

A copy of the JAX package's ``ops/roofline.py`` shape arithmetic, with the
same functions and names (and the same result keys, so the two packages'
summaries compare key for key): pure functions of shapes, with no device
access, so ``chip_smoke.py`` can join them with measured epoch times and
the tests can hold the counts against the JAX package's.

The FLOP counts are USEFUL flops (true model dimensions, 2·MACs): MFU =
useful / elapsed / peak. The model's matmuls are 64 rows wide or narrower
([64,46], [64,64], [1,64], [8,224] against the long stock axis), far from
the large tiles the data-sheet peak assumes, so the compute wall is better
judged against what these shapes CAN sustain on the card's tensor cores:
``ops/microbench.py``'s ``measure_matmul_ceiling`` measures that per shape,
and ``roofline_summary`` takes the measured ceiling. (The result keys keep
the JAX names: "mxu" names the card's tensor cores, "hbm" its device
memory.)

Model structure being counted (paper defaults, ``models/networks.py``):
  SDF FFN   : panel rows [F=46] → 64 → 64 → 1, per-period macro bias zp
              (computed from the LSTM state — counted separately)
  Moment net: concat(panel row [F], raw macro [M]) → K=8 moments
  Macro LSTM: M → 4 units, one step per period (negligible but counted)

Backward passes follow the kernels' recompute backward: bwd = forward
recompute + dgrad chain + wgrad, with no dx (training never asks for the
panel cotangent).

Peaks: the H100 SXM data sheet's dense rates (NVIDIA), which assume the
card's full 700 W power limit: 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32 on the CUDA cores, 3.35 TB/s of HBM3. They are defined here
once; ``chip_smoke.py``'s kernel bounds read them from here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# the H100 SXM's published dense peaks
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_PEAK_GBPS = 3350.0


def _matmul_flops(m: int, k: int, n: int) -> float:
    """Useful FLOPs (2·MACs) of an [m,k]×[k,n] matmul."""
    return 2.0 * m * k * n


def ffn_matmul_shapes(F: int, hidden: Sequence[int] = (64, 64)
                      ) -> List[Tuple[int, int]]:
    """The fused FFN's per-period matmul (rows, contract) pairs against the
    stock axis — the shapes whose throughput ceiling ops/microbench.py
    measures."""
    dims = [F, *hidden, 1]
    return [(out, inp) for inp, out in zip(dims[:-1], dims[1:])]


def ffn_flops_per_pass(
    T: int, N: int, F: int, hidden: Sequence[int] = (64, 64),
    mode: str = "fwd",
) -> float:
    """FLOPs of one fused-FFN panel pass (``ops/sdf_ffn.py``).

    fwd: x[F,BN] → h1[H1,BN] → h2[H2,BN] → w[1,BN] per period.
    bwd: recompute of fwd + dgrad (dh_i = W_{i+1}ᵀ dh_{i+1}, no dx to the
    panel) + wgrad ([H,BN]×[BN,H'] contractions over the stock tile).
    """
    layers = ffn_matmul_shapes(F, hidden)
    fwd = sum(_matmul_flops(out, inp, N) for out, inp in layers)
    if mode == "fwd":
        return T * fwd
    if mode != "bwd":
        raise ValueError(f"mode must be fwd|bwd, got {mode!r}")
    dgrad = sum(_matmul_flops(inp, out, N) for out, inp in layers[1:])
    wgrad = sum(_matmul_flops(out, inp, N) for out, inp in layers)
    return T * (fwd + dgrad + wgrad)


def moment_flops_per_pass(
    T: int, N: int, F: int, M: int, K: int = 8, mode: str = "fwd",
) -> float:
    """FLOPs of one fused moment-net pass (``ops/cond_em.py``):
    concat(panel row, raw macro) → K moment weights, contracted into the
    [K] empirical means in-kernel (one more K-row MAC per element)."""
    inp = F + M
    fwd = _matmul_flops(K, inp, N) + 2.0 * K * N  # + mean contraction
    if mode == "fwd":
        return T * fwd
    if mode != "bwd":
        raise ValueError(f"mode must be fwd|bwd, got {mode!r}")
    return T * (fwd + _matmul_flops(K, inp, N) + 2.0 * K * N)


def lstm_flops(T: int, M: int, units: Sequence[int] = (4,),
               mode: str = "fwd") -> float:
    """Macro LSTM: 4 gates × (in+U)×U MACs per period per layer; bwd ≈ 2×.
    At M=178, U=4 this is ~0.7 MFLOP/epoch — 5 orders below the panel."""
    flops = 0.0
    inp = M
    for u in units:
        flops += T * 4 * 2.0 * (inp + u) * u
        inp = u
    return flops * (1.0 if mode == "fwd" else 3.0)


def phase_epoch_flops(
    shapes: Dict[str, int],
    hidden: Sequence[int] = (64, 64),
    M: int = 178,
    K: int = 8,
    rnn_units: Sequence[int] = (4,),
    phase: str = "phase3",
) -> float:
    """FLOPs of ONE epoch of a phase (the pass structure of the JAX package's
    ``bench._bandwidth_accounting``): train fwd+bwd on T_train, plus
    fwd-only valid AND test
    evaluation every epoch (FFN + moment net both — the eval computes the
    conditional loss)."""
    Tt, Tv, Te = shapes["T_train"], shapes["T_valid"], shapes["T_test"]
    N, F = shapes["N"], shapes["F"]

    def ffn(T, mode):
        return (ffn_flops_per_pass(T, N, F, hidden, mode)
                + lstm_flops(T, M, rnn_units, mode))

    def mom(T, mode):
        return moment_flops_per_pass(T, N, F, M, K, mode)

    eval_flops = ffn(Tv + Te, "fwd") + mom(Tv + Te, "fwd")
    if phase == "phase1":  # unconditional: no moment net in the train step
        return ffn(Tt, "fwd") + ffn(Tt, "bwd") + eval_flops
    if phase == "phase2":  # moment update: SDF frozen, moment net trains
        return (ffn(Tt, "fwd") + mom(Tt, "fwd") + mom(Tt, "bwd")
                + eval_flops)
    if phase == "phase3":  # conditional: FFN + moment net fwd+bwd
        return (ffn(Tt, "fwd") + ffn(Tt, "bwd")
                + mom(Tt, "fwd") + mom(Tt, "bwd") + eval_flops)
    raise ValueError(f"phase must be phase1|phase2|phase3, got {phase!r}")


def schedule_flops(
    shapes: Dict[str, int],
    epochs: Tuple[int, int, int] = (256, 64, 1024),
    hidden: Sequence[int] = (64, 64),
    M: int = 178,
    K: int = 8,
) -> float:
    """Useful FLOPs of the whole 3-phase schedule (per member)."""
    return sum(
        n * phase_epoch_flops(shapes, hidden, M, K, phase=ph)
        for n, ph in zip(epochs, ("phase1", "phase2", "phase3"))
    )


def roofline_summary(
    epoch_seconds: float,
    shapes: Dict[str, int],
    phase: str = "phase3",
    n_members: int = 1,
    panel_bytes_per_epoch: float = None,
    shape_ceiling_tflops: float = None,
    hidden: Sequence[int] = (64, 64),
    M: int = 178,
    K: int = 8,
) -> Dict:
    """Join a MEASURED epoch time with the analytic FLOPs and bytes into the
    dual roofline: which wall (device memory or tensor cores) the epoch is
    near, and how near.

    `n_members`: member-fused runs execute n× the FLOPs on ~1× the panel
    bytes (one HBM read serves every member), which is exactly why the
    single-model epoch sits on the bandwidth side of the ridge and the
    9-member epoch on the compute side (intensity scales with n_members).

    `shape_ceiling_tflops`: measured sustained throughput of the model's own
    matmul shapes (``ops/microbench.py``); when given, the compute
    floor uses it instead of the whole-chip peak these narrow matmuls
    cannot reach.
    """
    useful = n_members * phase_epoch_flops(shapes, hidden, M, K, phase=phase)
    return _summarize(useful, epoch_seconds, panel_bytes_per_epoch,
                      shape_ceiling_tflops, label="per_epoch")


def schedule_roofline_summary(
    wall_seconds: float,
    shapes: Dict[str, int],
    epochs: Tuple[int, int, int] = (256, 64, 1024),
    n_members: int = 1,
    panel_bytes_total: float = None,
    shape_ceiling_tflops: float = None,
    hidden: Sequence[int] = (64, 64),
    M: int = 178,
    K: int = 8,
) -> Dict:
    """Roofline for a full 3-phase run (e.g. the 9-member ensemble's warm
    wall): useful FLOPs of the whole schedule × members vs the measured
    wall — the MFU-backed form of the ensemble compute-floor claim."""
    useful = n_members * schedule_flops(shapes, epochs, hidden, M, K)
    return _summarize(useful, wall_seconds, panel_bytes_total,
                      shape_ceiling_tflops, label="schedule")


def _summarize(useful: float, elapsed: float, nbytes: float,
               shape_ceiling_tflops: float, label: str) -> Dict:
    out = {
        f"useful_gflops_{label}": round(useful / 1e9, 2),
        "achieved_tflops": round(useful / elapsed / 1e12, 2),
        "mfu": round(useful / elapsed / PEAK_BF16_FLOPS, 4),
        "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
    }
    ceiling = (shape_ceiling_tflops * 1e12 if shape_ceiling_tflops
               else PEAK_BF16_FLOPS)
    if shape_ceiling_tflops:
        out["shape_ceiling_tflops"] = round(shape_ceiling_tflops, 2)
        out["fraction_of_shape_ceiling"] = round(
            useful / elapsed / ceiling, 3)
    if nbytes:
        intensity = useful / nbytes
        ridge = ceiling / (HBM_PEAK_GBPS * 1e9)
        out["arithmetic_intensity_flop_per_byte"] = round(intensity, 1)
        out["ridge_intensity_flop_per_byte"] = round(ridge, 1)
        out["bound"] = "hbm" if intensity < ridge else "mxu"
        # roofline bound on elapsed time given both walls
        t_hbm = nbytes / (HBM_PEAK_GBPS * 1e9)
        t_mxu = useful / ceiling
        out["roofline_floor_ms"] = round(max(t_hbm, t_mxu) * 1e3, 3)
        out["floor_components_ms"] = {
            "hbm": round(t_hbm * 1e3, 3),
            ("mxu_at_shape_ceiling" if shape_ceiling_tflops else
             "mxu_at_peak"): round(t_mxu * 1e3, 3),
        }
        out["fraction_of_roofline_floor"] = round(
            max(t_hbm, t_mxu) / elapsed, 3)
    return out
