"""The PyTorch port's roofline arithmetic (ops/roofline.py) and matmul
ceiling microbench (ops/microbench.py) against the JAX package's.

Every count is a pure function of shapes, so the port's must equal the JAX
module's exactly for the same shapes; only the peaks differ (the H100's
here). The microbench's plain version is held against the JAX Pallas
``_ceiling_kernel`` in the interpreter on the JAX test's own shapes
(rtol 1e-4, atol 1e-4, as there: the kernel accumulates G·R·S products one
by one, the plain version scales one sum). Its CUDA kernel runs only on the
card: that test is marked ``cuda`` and skips without one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deeplearninginassetpricing_paperreplication_torch.ops import (
    microbench as MB,
)
from deeplearninginassetpricing_paperreplication_torch.ops import roofline as R
from deeplearninginassetpricing_paperreplication_tpu.ops import (
    microbench as JMB,
)
from deeplearninginassetpricing_paperreplication_tpu.ops import (
    roofline as JR,
)

SHAPES = {"T_train": 48, "T_valid": 12, "T_test": 24, "N": 10_000, "F": 46}


@pytest.mark.parametrize("hidden", [(64, 64), (8, 8, 8), (32,)])
def test_counts_equal_the_jax_module(hidden):
    F, N, T, M, K = 46, 10_000, 48, 178, 8
    assert R.ffn_matmul_shapes(F, hidden) == JR.ffn_matmul_shapes(F, hidden)
    for mode in ("fwd", "bwd"):
        assert R.ffn_flops_per_pass(T, N, F, hidden, mode) == \
            JR.ffn_flops_per_pass(T, N, F, hidden, mode)
        assert R.moment_flops_per_pass(T, N, F, M, K, mode) == \
            JR.moment_flops_per_pass(T, N, F, M, K, mode)
        assert R.lstm_flops(T, M, (4,), mode) == JR.lstm_flops(T, M, (4,),
                                                              mode)
    for phase in ("phase1", "phase2", "phase3"):
        assert R.phase_epoch_flops(SHAPES, hidden, phase=phase) == \
            JR.phase_epoch_flops(SHAPES, hidden, phase=phase)
    assert R.schedule_flops(SHAPES, (8, 4, 16), hidden) == \
        JR.schedule_flops(SHAPES, (8, 4, 16), hidden)
    with pytest.raises(ValueError, match="mode"):
        R.ffn_flops_per_pass(T, N, F, hidden, "dx")


@pytest.mark.parametrize("ceiling", [None, 300.0])
def test_summaries_equal_the_jax_module_under_the_same_peaks(monkeypatch,
                                                             ceiling):
    """With the JAX module's peaks put in, the port's summaries are the
    JAX ones key for key; with its own, the H100 data sheet's."""
    assert (R.PEAK_BF16_FLOPS, R.PEAK_F32_FLOPS, R.HBM_PEAK_GBPS) == (
        989e12, 67e12, 3350.0)
    own = R.roofline_summary(0.05, SHAPES, "phase3", 9, 4e8, ceiling)
    assert own["peak_bf16_tflops"] == 989.0
    monkeypatch.setattr(R, "PEAK_BF16_FLOPS", JR.PEAK_BF16_FLOPS)
    monkeypatch.setattr(R, "HBM_PEAK_GBPS", JR.HBM_PEAK_GBPS)
    for n_members in (1, 9):
        args = (0.05, SHAPES, "phase3", n_members, 4e8, ceiling)
        assert R.roofline_summary(*args) == JR.roofline_summary(*args)
    args = (12.0, SHAPES, (8, 4, 16), 9, 1e10, ceiling)
    assert R.schedule_roofline_summary(*args) == \
        JR.schedule_roofline_summary(*args)


def test_model_shape_ceiling_equals_the_jax_function():
    ceiling = {"64x46": {"tflops": 310.0}, "64x64": {"tflops": 402.5},
               "8x224": {"tflops": 150.25}, "128x128": {"tflops": 610.0}}
    assert MB.MODEL_MATMUL_SHAPES == JMB.MODEL_MATMUL_SHAPES
    for kw in (dict(), dict(F=10, hidden=(8, 8), M=6, K=4)):
        assert MB.model_shape_ceiling_tflops(ceiling, **kw) == \
            JMB.model_shape_ceiling_tflops(ceiling, **kw)
    # a missing class falls back the same way
    partial = {"64x64": {"tflops": 402.5}}
    assert MB.model_shape_ceiling_tflops(partial) == \
        JMB.model_shape_ceiling_tflops(partial)


def test_reference_equals_the_jax_ceiling_kernel():
    """G grid steps × R repeats × S members of w[s] @ x, in the Pallas
    interpreter, against the port's plain version on the same bf16
    operands (the JAX test's shapes), and the port's CPU route."""
    m, k, bn, S, Rp, G = 8, 16, 128, 2, 2, 3
    w = np.random.default_rng(0).standard_normal((S, m, k))
    x = np.random.default_rng(1).standard_normal((k, bn))
    wj, xj = jnp.asarray(w, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    fn = pl.pallas_call(
        functools.partial(JMB._ceiling_kernel, n_members=S, repeats=Rp),
        grid=(G,),
        in_specs=[pl.BlockSpec((S, m, k), lambda i: (0, 0, 0)),
                  pl.BlockSpec((k, bn), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((m, bn), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((m, bn), jnp.float32),
        interpret=True)
    ref = np.asarray(fn(wj, xj))
    wt = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    before = MB.launches
    for got in (MB.matmul_ceiling_reference(wt, xt, Rp, G),
                MB.matmul_ceiling(wt, xt, Rp, G)):
        assert got.dtype == torch.float32 and got.shape == (m, bn)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert MB.launches == before  # a CPU tensor never reaches the kernel


def test_step_groups_fill_one_wave_evenly():
    # the JAX defaults on 132 SMs: 16 column tiles at two blocks per SM
    assert MB.step_groups(64, 16, 264) == 16
    assert MB.step_groups(64, 32, 132) == 4  # 128 x 128: two row slices
    assert MB.step_groups(64, 8, 132) == 16
    assert MB.step_groups(3, 16, 264) == 3
    assert MB.step_groups(64, 500, 132) == 1  # more blocks than one wave
    for G, blocks, slots in ((64, 16, 264), (48, 7, 132), (5, 2, 9)):
        d = MB.step_groups(G, blocks, slots)
        assert G % d == 0 and (d == 1 or d * blocks <= slots)


def test_measurement_needs_the_card():
    with pytest.raises(ValueError, match="CUDA events"):
        MB.measure_matmul_ceiling(shapes=((8, 16),), bn=128, n_members=2,
                                  repeats_per_step=2, grid_steps=3,
                                  timed_calls=1, device="cpu")


# (M, K, BN, S) of the ceiling's plans: the model's shapes at the JAX
# defaults, and the small ragged check shape
PLAN_SHAPES = [(m, k, 2048, 9) for m, k in MB.MODEL_MATMUL_SHAPES] + [
    (8, 16, 100, 2)]
SMS = 132  # an H100 SXM


@pytest.mark.parametrize("regs", [None, 80, 128], ids=["no-regs", "r80",
                                                       "r128"])
@pytest.mark.parametrize("m,k,bn,S", PLAN_SHAPES,
                         ids=[f"{m}x{k}" for m, k, _, _ in PLAN_SHAPES])
def test_ceiling_plan_pads_k_to_16_and_fills_one_wave(m, k, bn, S, regs):
    """The wgmma width is M rounded up to 8, K is padded to a multiple of
    16 only (cut into chunks whose members' tiles fit one block), and the
    step groups fill one wave: every block of the grid is resident at
    once."""
    G = 64 if bn == 2048 else 3
    bare = MB.ceiling_plan(S, m, k, bn, SMS, G)
    p = MB.ceiling_plan(S, m, k, bn, SMS, G, None if regs is None else {
        (bare.width, bare.stack, bare.ksteps): regs})
    assert p.width == -(-m // 8) * 8 and p.slices == 1
    # one wgmma covers `stack` members side by side, within the built N
    assert S % p.stack == 0 and p.n <= MB.CEILING_MAX_N
    assert p.warpgroups <= MB.ceiling_max_warpgroups(p.n, p.ksteps)
    assert p.kchunks * p.ksteps * 16 == -(-k // 16) * 16
    assert p.ksteps in MB.CEILING_KSTEPS
    assert p.smem_bytes == S * p.width * p.ksteps * 32 <= 232_448
    assert p.layout == "K-major, no swizzle"
    assert p.grid[0] * MB.CEILING_ROWS * p.warpgroups >= bn
    assert p.grid[1] == p.kchunks and p.grid[2] == p.groups
    assert p.blocks <= p.blocks_per_sm * SMS
    assert p.groups == MB.step_groups(G, p.grid[0] * p.grid[1],
                                      SMS * p.blocks_per_sm)
    assert 1 <= p.warpgroups <= MB.CEILING_MAX_WARPGROUPS
    assert p.blocks_per_sm * p.threads <= 2048


def test_ceiling_plans_of_the_roofline_path():
    """At the JAX defaults: 128 × 128 at width 128, K in two chunks of 64
    (nine members' 128-row tiles of 64 k in 147,456 B: one block an SM, of
    four warpgroups); 8 × 224 at width 8 (no M padding), 14 k steps, nine
    members a product (m64n72k16); 64 × 46 at width 64, 3 k steps (K 48,
    never 64), three members a product (m64n192k16)."""
    big = MB.ceiling_plan(9, 128, 128, 2048, SMS, 64)
    assert (big.width, big.stack, big.kchunks, big.ksteps, big.smem_bytes,
            big.blocks_per_sm, big.warpgroups, big.groups, big.grid) == (
                128, 1, 2, 4, 147_456, 1, 4, 8, (8, 2, 8))
    narrow = MB.ceiling_plan(9, 8, 224, 2048, SMS, 64)
    assert (narrow.width, narrow.stack, narrow.n, narrow.kchunks,
            narrow.ksteps) == (8, 9, 72, 1, 14)
    mid = MB.ceiling_plan(9, 64, 46, 2048, SMS, 64)
    assert (mid.ksteps, mid.stack, mid.n) == (3, 3, 192)


def test_ceiling_registers_bound_the_resident_blocks():
    free = MB.ceiling_plan(9, 64, 46, 2048, SMS, 64)
    tight = MB.ceiling_plan(9, 64, 46, 2048, SMS, 64, {(64, 3, 3): 168})
    assert (tight.blocks_per_sm * tight.warpgroups
            < free.blocks_per_sm * free.warpgroups)
    assert MB.ceiling_plan(9, 64, 46, 2048, SMS, 64,
                           {(8, 3, 3): 255}) == free


def test_ceiling_width_and_refusals():
    assert [MB.ceiling_width(m) for m in (1, 8, 9, 46, 64, 65, 128, 300)] == [
        8, 8, 16, 64, 64, 128, 128, 128]
    assert [MB.ceiling_stack(S, w) for S, w in ((9, 8), (9, 64), (9, 128),
                                                (2, 8), (6, 32))] == [
        9, 3, 1, 1, 3]
    assert MB.ceiling_plan(2, 300, 16, 256, SMS, 4).slices == 3
    with pytest.raises(ValueError):  # 400 members' rows fit no block
        MB.ceiling_plan(400, 128, 16, 2048, SMS, 64)


@pytest.mark.cuda
def test_ceiling_kernel_matches_reference_on_card():
    """matmul_ceiling against its plain version, padded shapes included
    (K 46 → 48, width 8 at M = 8, K 128 in two chunks) at 2 × 3 steps; bit
    for bit at the timed configuration (S = 9, 8 repeats × 64 steps,
    several steps per step group) on integer operands in [-2, 2], whose
    every partial sum is exact in f32; and the measurement's keys (needs a
    card + nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for (m, k), bn in zip(MB.MODEL_MATMUL_SHAPES + ((8, 16),),
                          (2048, 2048, 2048, 2048, 100)):
        w = torch.randn(3, m, k, generator=g, device=dev).bfloat16()
        x = torch.randn(k, bn, generator=g, device=dev).bfloat16()
        got = MB.matmul_ceiling(w, x, 2, 3)
        ref = MB.matmul_ceiling_reference(w, x, 2, 3)
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-4 * ref.abs().max().item())
    for m, k in MB.MODEL_MATMUL_SHAPES:
        w = torch.randint(-2, 3, (9, m, k), generator=g,
                          device=dev).bfloat16()
        x = torch.randint(-2, 3, (k, 2048), generator=g,
                          device=dev).bfloat16()
        assert torch.equal(MB.matmul_ceiling(w, x, 8, 64),
                           MB.matmul_ceiling_reference(w, x, 8, 64))
    out = MB.measure_matmul_ceiling(shapes=((64, 46), (128, 128)),
                                    grid_steps=4)
    assert out["64x46"]["tflops"] > 0 and "fraction_of_dense_128" in out[
        "64x46"]
