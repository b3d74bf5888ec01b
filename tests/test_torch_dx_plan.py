"""The launch plan of the port's FFN panel cotangent
(ops/sdf_ffn.py::dx_plan).

The plan is arithmetic in Python, and csrc/sdf_ffn_dx.cu recomputes its
shared memory and refuses a plan that disagrees; the card is asked once per
plan whether it keeps the planned blocks resident. So its shape and its
limits are held here on the CPU for every hidden width of the JAX sweep grid
(``deeplearninginassetpricing_paperreplication_tpu/parallel/sweep.py:82``
``grid_configs`` ``hidden_dims``), the odd widths (8, 7, 6) of the card
tests, S ∈ {1, 3, 9} and both dtypes: the plan fits one block's shared
memory and the SM's at its blocks per SM, gives each route-0 thread at most
one dx tile, respects the registers the built kernels report, buffers the
weights and the panel tile only as the kernel can (weights resident, or
streamed through two buffers or one; one or two panel tiles), and its grid
is the persistent set of resident blocks (or every cell, where there are
fewer).
"""

import numpy as np
import pytest

from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K

F = 46  # the paper's characteristics
SMS = 132  # an H100 SXM
BLOCK_SMEM_LIMIT = 232_448  # 227 KB: what one block may use
HIDDEN = [(64, 64), (128, 128), (64, 64, 64), (32, 32), (8, 7, 6)]
IDS = ["-".join(map(str, h)) for h in HIDDEN]
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("hidden", HIDDEN, ids=IDS)
def test_every_width_gets_a_plan_that_fits(hidden, S, cd):
    lay = K.ffn_layout(F, hidden)
    plan = K.dx_plan(lay, SMS, S, 48, 10_000, cd)
    assert plan.route == K.dx_route(lay, cd) == (cd == "bfloat16")
    assert plan.smem_bytes <= BLOCK_SMEM_LIMIT
    assert plan.blocks_per_sm >= 1
    assert plan.blocks_per_sm * (plan.smem_bytes + K.BLOCK_SMEM_RESERVED) \
        <= K.SM_SMEM
    assert plan.blocks_per_sm * plan.threads <= K.SM_MAX_THREADS
    assert plan.smem_bytes == 4 * K.dx_geometry(
        lay, plan.route, plan.tile, plan.wbufs, plan.xbufs)[0]
    # the weights: every member resident, or streamed through two buffers
    # (more than two members) or one; the panel tile in one buffer or two
    assert plan.wbufs == S or plan.wbufs == 1 or plan.wbufs == 2 < S
    assert plan.resident == (plan.wbufs == S) and plan.xbufs in (1, 2)
    assert plan.tile in K.DX_TILES
    if plan.route == 0:
        assert plan.threads in K.DX_THREADS
        # each thread holds at most one dx tile of 6 features × 4 stocks
        assert -(-F // K.DX_FEATURES) * (plan.tile // 4) <= plan.threads
    else:
        assert plan.threads == 2 * plan.tile  # a warp per 16 stocks


def test_smem_geometry_at_the_paper_width():
    """The words csrc/sdf_ffn_dx.cu's smem_plan lays out at (64, 64)."""
    lay = K.ffn_layout(F, (64, 64))
    # route 0 at tile 64, 128 threads: the packed weights (no read past
    # them at these widths) in two buffers, two x tiles 46 × 64, two
    # activation tiles 64 × 64, two zp rows of 64, two g and two row-hash
    # rows of 64
    assert lay.P == 46 * 64 + 64 * 64 + 64 + 64 + 4
    assert K.dx_geometry(lay, 0, 64, 2, 2) == (
        2 * lay.P + 2 * 46 * 64 + 2 * 64 * 64 + 2 * 64 + 4 * 64, lay.P)
    # one weight buffer and one panel tile: 74,768 B, three blocks an SM
    assert 4 * K.dx_geometry(lay, 0, 64, 1, 1)[0] == 74_768
    # route 1 at tile 64: two x tiles 46 × 64, layer 1's activation tile
    # 64 × (64 + 4), two zp rows of 64, two g and two row-hash rows of 64;
    # an image of K1 48 rows and W2 64 rows of 64/2 + 4 words, then b2,
    # kout and Σ|W2|
    image = 48 * 36 + 64 * 36 + 3 * 64
    assert K.dx_geometry(lay, 1, 64, 9, 2) == (
        2 * 46 * 64 + 64 * 68 + 2 * 64 + 4 * 64 + 9 * image, image)
    # odd widths: the register tiles read up to 8 units (and 6 features)
    # past the packed layout, so route 0's buffer grows to hold them
    odd = K.ffn_layout(F, (12,))
    assert odd.P == 46 * 12 + 12 + 4
    assert K.dx_geometry(odd, 0, 32, 1, 1)[1] == 48 * 12


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("hidden", HIDDEN, ids=IDS)
def test_grid_is_the_resident_set(hidden, S, cd):
    lay = K.ffn_layout(F, hidden)
    for T, N in ((48, 10_000), (48, 10_007), (2, 100)):
        plan = K.dx_plan(lay, SMS, S, T, N, cd)
        assert plan.cells == T * -(-N // plan.tile)
        assert plan.G == min(plan.cells, plan.blocks_per_sm * SMS)
        # every cell is walked by exactly one block, for all S members; no
        # block idles while another has two cells more than it
        per_block = -(-plan.cells // plan.G)
        assert (per_block - 1) * plan.G < plan.cells <= per_block * plan.G


def test_paper_width_keeps_two_blocks_and_eight_warps():
    lay = K.ffn_layout(F, (64, 64))
    for S in (1, 3, 9):
        for cd in DTYPES:
            plan = K.dx_plan(lay, SMS, S, 48, 10_000, cd)
            assert plan.blocks_per_sm >= 2, (S, cd, plan)
            assert plan.blocks_per_sm * plan.threads >= 8 * 32, (S, cd, plan)
    # the panel-gradient path's plans at the registers the kernels use
    # (164 and 154: three warps to each scheduler): f32 in 64-stock tiles
    # of 8 × 4 register tiles, one per thread in the layer products, with
    # one weight buffer and one panel tile, so that three blocks share an
    # SM; bf16 in 64-stock tiles, both double-buffered at three blocks
    f32 = K.dx_plan(lay, SMS, 9, 48, 10_000, "float32", registers={0: 164})
    assert (f32.tile, f32.threads, f32.wbufs, f32.xbufs) == (64, 128, 1, 1)
    assert f32.blocks_per_sm == 3 and f32.G == 3 * SMS
    bf16 = K.dx_plan(lay, SMS, 9, 48, 10_000, "bfloat16", registers={1: 154})
    assert (bf16.tile, bf16.threads, bf16.wbufs, bf16.xbufs,
            bf16.blocks_per_sm) == (64, 128, 2, 2, 3)


def test_registers_bound_the_resident_blocks():
    """The registers a kernel reports lower the blocks per SM, and G with
    them."""
    lay = K.ffn_layout(F, (64, 64))
    # route 1 at 64-stock tiles (4 warps): 168 registers are 5,376 a warp
    # (21 units of 256), three to each scheduler's 16,384: twelve warps,
    # three blocks; 169 round up to 5,632, two a scheduler: 256 threads
    three = K.dx_plan(lay, SMS, 9, 48, 10_000, "bfloat16", registers={1: 168})
    assert (three.tile, three.blocks_per_sm, three.G) == (64, 3, 3 * SMS)
    two = K.dx_plan(lay, SMS, 9, 48, 10_000, "bfloat16", registers={1: 169})
    assert two.blocks_per_sm * two.threads == 256
    # where registers, not shared memory, cap the blocks, the weights and
    # the panel tile keep their second buffers
    assert (three.wbufs, three.xbufs) == (2, 2)
    # at 255 registers (8,192 a warp) at most 256 threads an SM
    full = K.dx_plan(lay, SMS, 9, 48, 10_000, "bfloat16", registers={1: 255})
    assert full.blocks_per_sm * full.threads <= K.SM_REGS // 256
    assert full.G == full.blocks_per_sm * SMS
    # route 0: a 255-register kernel holds two 128-thread blocks, not
    # three, where shared memory would allow more
    small = K.ffn_layout(F, (8, 7, 6))
    free = K.dx_plan(small, SMS, 9, 48, 10_000, "float32")
    capped = K.dx_plan(small, SMS, 9, 48, 10_000, "float32",
                       registers={0: 255})
    assert free.blocks_per_sm > capped.blocks_per_sm
    assert capped.blocks_per_sm * capped.threads * 256 <= K.SM_REGS
    assert capped.G == capped.blocks_per_sm * SMS


def test_plan_refuses_what_does_not_fit():
    for cd in DTYPES:
        with pytest.raises(ValueError, match="does not fit"):
            K.dx_plan(K.ffn_layout(2000, (128, 128)), SMS, 1, 48, 10_000, cd)
    with pytest.raises(ValueError, match="compute_dtype"):
        K.dx_plan(K.ffn_layout(F, (64, 64)), SMS, 1, 48, 10_000, "float16")


def test_wide_panels_take_the_cuda_core_route_in_bf16():
    """Beyond 64 features a warp's dx fragments do not fit its registers:
    bf16 then runs on the CUDA cores with rounded operands."""
    for f, route in ((10, 1), (64, 1), (65, 0), (120, 0)):
        lay = K.ffn_layout(f, (64, 64))
        assert K.dx_route(lay, "bfloat16") == route
        assert K.dx_route(lay, "float32") == 0
        assert K.dx_plan(lay, SMS, 9, 48, 10_000, "bfloat16").route == route


def test_audit_build_is_the_dx_source_under_its_macro():
    """The C2 audit library is sdf_ffn_dx.cu compiled with one more macro,
    into its own library; everything the macro adds sits inside its
    #ifdef blocks, so the main library is the source without them."""
    (main,) = K.build_jobs([64], ["dx"])
    audit = K.audit_job(64)
    assert audit.source == main.source == "sdf_ffn_dx.cu"
    assert audit.defines == main.defines + (K.AUDIT_DEFINE,)
    assert audit.name != main.name and audit.path != main.path
    src = (K._nvcc.CSRC / main.source).read_text().splitlines()
    outside, depth = [], 0
    for line in src:
        if line.startswith("#ifdef SDF_FFN_DX_AUDIT"):
            depth += 1
        elif depth and line.startswith("#endif"):
            depth -= 1
        elif not depth:
            outside.append(line)
    assert depth == 0
    assert sum(line.startswith("#ifdef SDF_FFN_DX_AUDIT") for line in src) == 3
    for name in ("g_dx_audit", "audit_add", "sdf_ffn_dx_audit_"):
        assert not any(name in line for line in outside), name


def test_audit_needs_cuda_tensors():
    import torch

    lay_hidden, S, T, N = [64, 64], 1, 2, 8
    g = torch.Generator().manual_seed(0)
    k1T = torch.randn(S, 64, F, generator=g)
    mids = [(torch.randn(S, 64, 64, generator=g), torch.zeros(S, 64))]
    packed = K.pack_ffn(k1T, mids, torch.randn(S, 64, generator=g),
                        torch.zeros(S), "bfloat16")
    assert packed.layout.hidden == tuple(lay_hidden)
    with pytest.raises(ValueError, match="CUDA"):
        K.dx_audit(torch.randn(T, F, N), torch.zeros(S, T, 64), packed,
                   torch.zeros(S, T, N))
    assert K.AUDIT_COUNTERS == ("elements", "certified", "flips",
                                "flips_outside", "max_ratio")


# -- the streamed route's tensor-core panel cotangent (route 4) ---------------

# chip_smoke.py phase 21's stacks that route 4 serves (≤ 4 layers), and the
# deeper ones route 3 keeps
ROUTE4 = [((256, 256), 46), ((132,), 46), ((144,) * 4, 46), ((64, 64), 256)]
ROUTE4_IDS = ["256x256", "132", "4x144", "64x64-F256"]


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("hidden,f", ROUTE4, ids=ROUTE4_IDS)
def test_bf16_streamed_dx_takes_the_tensor_core_route(hidden, f, S):
    """Under bf16 compute the streamed panel cotangent plans route 4: its
    bf16 tiles and f32 dx tile in shared memory (no scratch), 256 threads,
    a stock tile of STREAM_MMA_TILES, the shared memory that
    csrc/sdf_ffn_stream.cu's dx_mma_smem_bytes counts; f32 compute takes
    the register-tiled route 5 (512 threads), but for (64, 64) at F = 256,
    whose route 2 takes tile 64 (the 64-wide layers fill route 2's pass and
    a quarter of route 5's), which keeps route 2."""
    lay = K.ffn_layout(f, hidden)
    plan = K.dx_plan(lay, SMS, S, 48, 10_000, "bfloat16")
    assert K.is_stream(plan) and plan.route == K.STREAM_MMA_ROUTE
    assert plan.scratch == 0 and plan.threads == K.STREAM_THREADS
    assert plan.tile in K.STREAM_MMA_TILES
    fixed, tiles = K.stream_geometry(lay, "dx", plan.tile, plan.route)
    assert plan.smem_bytes == 4 * (fixed + tiles) <= BLOCK_SMEM_LIMIT
    assert plan.cells == 48 * -(-10_000 // plan.tile)
    assert plan.G == min(plan.cells, plan.blocks_per_sm * SMS)
    f32 = K.dx_plan(lay, SMS, S, 48, 10_000, "float32")
    narrow = max(hidden) <= K.STREAM_TILED_NARROW
    assert (f32.route, f32.threads) == (
        (K.STREAM_ROUTES["float32"], K.STREAM_THREADS) if narrow
        else (K.STREAM_TILED_ROUTE, K.STREAM_TILED_THREADS))
    # at the registers of an 8-warp block of the tensor-core kernels (the
    # forward's 180, the backward's 237) it still plans, one block an SM
    for regs in (180, 237):
        held = K.dx_plan(lay, SMS, S, 48, 10_000, "bfloat16",
                         {K.STREAM_MMA_ROUTE: regs})
        assert held.route == K.STREAM_MMA_ROUTE and held.blocks_per_sm == 1


@pytest.mark.parametrize("depth", [5, 12, 16])
def test_deep_bf16_streamed_dx_keeps_route_3(depth):
    """A plan decision by depth: past STREAM_MMA_MAX_LAYERS layers the
    streamed bf16 panel cotangent stays on route 3 (the CUDA cores); the
    f32 one takes route 5 at every depth whose tile fits (the 64-wide
    stacks' route 2 takes tile 32 there)."""
    assert depth > K.STREAM_MMA_MAX_LAYERS
    lay = K.ffn_layout(F, (144,) * depth if depth < 12 else (64,) * depth)
    for S in (1, 9):
        plan = K.dx_plan(lay, SMS, S, 48, 10_000, "bfloat16")
        assert plan.route == K.STREAM_ROUTES["bfloat16"]
        assert K.dx_plan(lay, SMS, S, 48, 10_000, "float32").route == \
            K.STREAM_TILED_ROUTE


def test_f32_streamed_dx_plan_at_256x256_is_unchanged():
    """Route 2's plan at (256, 256), F = 46 is unchanged: tile 32, one
    block an SM, its tiles in shared memory (the card's reference for route
    5, which f32 compute now plans: tile 64, 512 threads); and route 3
    forced at bf16 (the plan the card checks route 4 against) is route 2's
    geometry."""
    lay = K.ffn_layout(F, (256, 256))
    for S in (1, 9):
        plan = K.dx_plan(lay, SMS, S, 48, 10_000, "float32")
        assert (plan.route, plan.tile, plan.threads, plan.smem_bytes,
                plan.blocks_per_sm, plan.G, plan.cells, plan.scratch) == (
                    K.STREAM_TILED_ROUTE, 64, K.STREAM_TILED_THREADS,
                    227_328, 1, SMS, 7_536, 0)
        assert K.stream_plan(lay, "dx", SMS, S, 48, 10_000,
                             route=K.STREAM_ROUTES["float32"]) == (
            32, 177_920, 1, SMS, 15_024, 0)
        assert K.stream_plan(lay, "dx", SMS, S, 48, 10_000,
                             route=K.STREAM_ROUTES["bfloat16"]) == (
            32, 177_920, 1, SMS, 15_024, 0)


def test_stream_audit_build_is_the_stream_source_under_its_macro():
    """The streamed dx's audit library is sdf_ffn_stream.cu compiled as the
    dx library with the audit macro, into its own library; everything the
    macro adds sits inside its #ifdef blocks."""
    (main,) = K.stream_jobs(["dx"])
    audit = K.stream_audit_job()
    assert audit.source == main.source == K.STREAM_SOURCE
    assert audit.defines == main.defines + (K.AUDIT_DEFINE,)
    assert audit.name != main.name and audit.path != main.path
    src = (K._nvcc.CSRC / main.source).read_text().splitlines()
    outside, depth, blocks = [], 0, 0
    for line in src:
        if line.startswith("#ifdef SDF_FFN_DX_AUDIT"):
            depth += 1
            blocks += 1
        elif depth and line.startswith("#endif"):
            depth -= 1
        elif not depth:
            outside.append(line)
    assert depth == 0 and blocks >= 3
    for name in ("g_dx_audit", "audit_add", "sdf_ffn_dx_audit_", "seen"):
        assert not any(name in line for line in outside), name


def test_certified_window_mirrors_the_kernel():
    """ops/sdf_ffn.py's window is csrc/sdf_ffn_stream.cu's: 2^-16 (route
    1's kCertify in sdf_ffn_dx.cu) per started 64 inputs of the top layer."""
    import re

    src = (K._nvcc.CSRC / K.STREAM_SOURCE).read_text()
    dx_src = (K._nvcc.CSRC / "sdf_ffn_dx.cu").read_text()
    const = "constexpr float kCertify = 1.0f / 65536.0f;"
    assert const in src and const in dx_src
    assert K.STREAM_CERTIFY == 1.0 / 65536.0
    depth = re.search(r"constexpr int kCertifyDepth = (\d+);", src)
    assert depth and int(depth.group(1)) == K.STREAM_CERTIFY_DEPTH == 64
    assert ("return kCertify * (float)((kin + kCertifyDepth - 1) / "
            "kCertifyDepth);") in src
    for kin, want in ((1, 2 ** -16), (46, 2 ** -16), (64, 2 ** -16),
                      (65, 2 ** -15), (132, 3 * 2 ** -16), (256, 2 ** -14),
                      (2048, 2 ** -11)):
        assert K.stream_certify_window(kin) == want


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (round to nearest even), as float32."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


@pytest.mark.parametrize("depth", [64, 256, 1024, 2048])
def test_blocked_sum_within_the_certified_window(depth):
    """A numpy model of route 4's certification. Products of bf16 values
    are exact in f32, so route 3's fmaf chain over the top layer's inputs
    (k in order from 0) is replayed here bit for bit; an mma order is
    modelled as 16-wide blocks, each summed exactly and added to the f32
    accumulator. On phase 21's draws (torch generator 21; the layer below a
    ReLU of K1ᵀx + zp at F = 46, the top layer's W at depth^-0.5, b at 0.1)
    the blocked pre-activation is within window/8 of the chain, relative to
    the magnitude bound max|a|·Σ|W| + |b|, so every decision outside the
    window is the chain's."""
    import torch

    g = torch.Generator().manual_seed(21)
    U, n = 64, 128
    x = torch.randn(F, n, generator=g).numpy()
    k1 = (torch.randn(depth, F, generator=g) * F ** -0.5).numpy()
    zp = (torch.randn(depth, 1, generator=g) * 0.3).numpy()
    a = _bf16(np.maximum(_bf16(k1) @ _bf16(x) + zp, 0.0))  # [depth, n]
    w = _bf16((torch.randn(U, depth, generator=g) * depth ** -0.5).numpy())
    b = (torch.randn(U, 1, generator=g) * 0.1).numpy().astype(np.float32)
    chain = np.zeros((U, n), np.float32)
    for k in range(depth):  # fmaf(w, a, h): the exact product, one rounding
        chain = (chain + w[:, k:k + 1] * a[k:k + 1, :]).astype(np.float32)
    blocked = np.zeros((U, n), np.float32)
    for k0 in range(0, depth, 16):
        part = w[:, k0:k0 + 16].astype(np.float64) @ a[k0:k0 + 16].astype(
            np.float64)
        blocked = (blocked.astype(np.float64) + part).astype(np.float32)
    h_chain = (chain + b).astype(np.float32)
    h_mma = (blocked + b).astype(np.float32)
    mag = (a.max(axis=0)[None, :] * np.abs(w).sum(axis=1)[:, None]
           + np.abs(b))
    window = K.stream_certify_window(depth)
    gap = np.abs(h_mma.astype(np.float64) - h_chain) / mag
    assert float(gap.max()) <= window / 8
    outside = np.abs(h_mma) > window * mag
    assert np.array_equal(h_mma[outside] > 0, h_chain[outside] > 0)
    # the model exercises both: sums that differ, and some within the window
    assert (h_mma != h_chain).any()
    assert 0 < float(outside.mean()) <= 1.0
