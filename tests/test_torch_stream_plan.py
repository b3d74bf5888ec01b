"""The launch plans of the kernel route's shape range (CPU arithmetic): the
SDF-FFN's streamed-weight route (ops/sdf_ffn.py stream_plan, as
csrc/sdf_ffn_stream.cu counts its shared memory), where it is chosen, its
reach and its refusals, and its tensor-core form under bf16 compute (route
STREAM_MMA_ROUTE: bf16 tiles, its bf16 weight copy); the conditional EM's
moment chunks (ops/cond_em.py moment_chunks, cem_plan / cem_dx_plan of a
chunk); and the panel cotangent's plan for one member with few
characteristics (C11)."""

import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.ops import cond_em as C
from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K

SMS, T, N = 132, 48, 10_000
DTYPES = ("float32", "bfloat16")
KINDS = ("fwd", "bwd", "dx")
# chip_smoke.py phase 21 (a): widths above 128, 12 and 16 layers, F = 256
PHASE21 = [((256, 256), 46), ((132,), 46), ((64,) * 12, 46),
           ((64,) * 16, 46), ((64, 64), 256)]
# the streamed route's stocks per SM at (256, 256) before its tensor-core
# form (one block an SM: forward tile 64, backward 32, panel cotangent 32)
CUDA_CORE_STOCKS = {"fwd": 64, "bwd": 32, "dx": 32}
# shapes the resident kernels plan today (the plan tests' grids)
RESIDENT = [((64, 64), 46), ((128, 128), 46), ((64, 64, 64), 46),
            ((32, 32), 46), ((8, 7, 6), 10), ((64, 64), 80), ((8,), 5)]


def _plan(kind, lay, S, cd, registers=None):
    if kind == "fwd":
        return K.fwd_plan(lay, SMS, S, T, N, cd, registers)
    if kind == "bwd":
        return K.bwd_plan(lay, SMS, S, T, N, registers=registers,
                          compute_dtype=cd)
    return K.dx_plan(lay, SMS, S, T, N, cd, registers)


def _resident(kind, lay, S, cd):
    if kind == "fwd":
        return K.resident_fwd_plan(lay, SMS, S, T, N, cd)
    if kind == "bwd":
        return K.resident_bwd_plan(lay, SMS, S, T, N)
    return K.resident_dx_plan(lay, SMS, S, T, N, cd)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("hidden,F", PHASE21,
                         ids=["256x256", "132", "12x64", "16x64", "F256"])
def test_streamed_plans_fit_the_block(hidden, F, S, kind):
    """Each plan at phase 21's shapes fits one block's shared memory, 256
    threads and the SM: its shared memory is the slabs, row hashes and g
    row, plus the tile buffers where they sit in shared memory (else a
    scratch slice a block); G fills at most the resident blocks (per member
    for the backward) and the scratch budgets. Under bf16 compute every
    kernel takes the tensor-core route, its bf16 tiles in shared memory, at
    least twice the (256, 256) stocks per SM of the CUDA cores' (forward 2 ×
    64, backward and panel cotangent 2 × 32), up to STREAM_MMA_MAX_LAYERS
    layers; the 12- and 16-layer stacks keep route 3."""
    lay = K.ffn_layout(F, hidden)
    for cd in DTYPES:
        plan = _plan(kind, lay, S, cd)
        if not K.is_stream(plan):
            assert K.resident_fits(lay)  # only (64, 64) at F = 256
            continue
        mma = (cd == "bfloat16" and kind in K.STREAM_MMA_KERNELS
               and len(hidden) <= K.STREAM_MMA_MAX_LAYERS)
        assert plan.route == (K.STREAM_MMA_ROUTE if mma
                              else K.STREAM_ROUTES[cd])
        assert plan.threads == K.STREAM_THREADS
        assert plan.tile in (K.STREAM_MMA_TILES if mma else K.STREAM_TILES)
        fixed, tf = K.stream_geometry(lay, kind, plan.tile, plan.route)
        assert plan.smem_bytes == 4 * (fixed + (0 if plan.scratch else tf))
        assert plan.scratch in ((0,) if mma else (0, tf))
        if mma:
            assert plan.tile * plan.blocks_per_sm >= 2 * CUDA_CORE_STOCKS[
                kind]
        assert plan.smem_bytes <= K.MAX_SMEM
        assert plan.blocks_per_sm >= 1
        assert plan.blocks_per_sm * (plan.smem_bytes + K.BLOCK_SMEM_RESERVED
                                     ) <= K.SM_SMEM
        assert plan.blocks_per_sm * plan.threads <= K.SM_MAX_THREADS
        per = S if kind == "bwd" else 1
        assert 1 <= plan.G * per <= max(per, plan.blocks_per_sm * SMS)
        assert 4 * plan.G * per * plan.scratch <= K.STREAM_SCRATCH_BYTES
        if kind == "bwd":
            assert 4 * plan.G * S * (lay.P + T * hidden[0]) <= \
                K.STREAM_GRAD_BYTES


def test_phase21_shapes_take_the_streamed_route():
    """Past the resident kernels every kernel streams; the paper's widths
    at F = 256 stream the panel cotangent and the bf16 forward only (the
    resident f32 forward and the backward still plan)."""
    for hidden, F in PHASE21[:4]:
        lay = K.ffn_layout(F, hidden)
        assert all(K.is_stream(_plan(k, lay, 1, cd))
                   for k in KINDS for cd in DTYPES)
    lay = K.ffn_layout(256, (64, 64))
    got = {(k, cd): K.is_stream(_plan(k, lay, 1, cd))
           for k in KINDS for cd in DTYPES}
    assert got == {("fwd", "float32"): False, ("fwd", "bfloat16"): True,
                   ("bwd", "float32"): False, ("bwd", "bfloat16"): False,
                   ("dx", "float32"): True, ("dx", "bfloat16"): True}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("hidden,F", RESIDENT)
def test_streamed_route_only_where_no_resident_plan_fits(hidden, F, S, kind):
    """A shape the resident route plans keeps that plan (the same object
    the resident plan function gives, its registers too)."""
    lay = K.ffn_layout(F, hidden)
    for cd in DTYPES:
        assert _plan(kind, lay, S, cd) == _resident(kind, lay, S, cd)


@pytest.mark.parametrize("kind", KINDS)
def test_reach_widths_1024_depth_32_F_512_nine_members(kind):
    """The reach plans with its tile buffers in scratch; under bf16 compute
    that is route 3 on the CUDA cores (the tensor-core route's ldmatrix
    reads shared memory only): a plan decision by shape."""
    lay = K.ffn_layout(512, (1024,) * 32)
    for S in (1, 9):
        for cd in DTYPES:
            plan = _plan(kind, lay, S, cd)
            assert K.is_stream(plan) and plan.G >= 1
            assert plan.scratch > 0  # the tile buffers go to scratch
            assert plan.route == K.STREAM_ROUTES[cd]
    if kind in K.STREAM_MMA_KERNELS:
        with pytest.raises(ValueError, match="shared memory"):
            K.stream_plan(lay, kind, SMS, 1, T, N,
                          route=K.STREAM_MMA_ROUTE)


@pytest.mark.parametrize("kind", K.STREAM_MMA_KERNELS)
@pytest.mark.parametrize("depth", [K.STREAM_MMA_MAX_LAYERS,
                                   K.STREAM_MMA_MAX_LAYERS + 1, 12, 16])
def test_tensor_core_route_up_to_its_depth(depth, kind):
    """A plan decision by depth: bf16 stacks of at most STREAM_MMA_MAX_LAYERS
    layers past the resident kernels take the tensor-core route, deeper
    ones route 3 (tiles in shared memory, the CUDA cores), the forward, the
    backward and the panel cotangent alike."""
    lay = K.ffn_layout(46, (144,) * depth if depth <= 6 else (64,) * depth)
    for S in (1, 9):
        plan = _plan(kind, lay, S, "bfloat16")
        deep = depth > K.STREAM_MMA_MAX_LAYERS
        assert plan.route == (K.STREAM_ROUTES["bfloat16"] if deep
                              else K.STREAM_MMA_ROUTE)
        assert K.is_stream(plan)


@pytest.mark.parametrize("kind,tile,smem,G9", [
    ("fwd", 64, 161_024, 132), ("bwd", 32, 171_008, 14)])
def test_f32_streamed_plans_at_256x256_are_the_cuda_cores(kind, tile, smem,
                                                          G9):
    """f32 compute keeps the CUDA-core route's plans: (256, 256), F = 46,
    one block an SM."""
    lay = K.ffn_layout(46, (256, 256))
    for S, G in ((1, 132), (9, G9 if kind == "bwd" else 132)):
        plan = _plan(kind, lay, S, "float32")
        assert (plan.route, plan.tile, plan.smem_bytes, plan.blocks_per_sm,
                plan.G, plan.scratch) == (K.STREAM_ROUTES["float32"], tile,
                                          smem, 1, G, 0)


@pytest.mark.parametrize("kind", K.STREAM_MMA_KERNELS)
@pytest.mark.parametrize("hidden,F", [((256, 256), 46), ((132,), 46),
                                      ((144,) * 4, 46), ((200, 136, 160), 80)],
                         ids=["256x256", "132", "4x144", "200-136-160"])
def test_tensor_core_smem_is_what_the_kernel_counts(hidden, F, kind):
    """The tensor-core plan's shared memory, counted as
    csrc/sdf_ffn_stream.cu's mma_smem_bytes counts it: a ring of three
    slabs of SU rows × 40 bf16, the row hashes and the g row, 512 floats of
    cross-warp sums, then the bf16 tile rows of tile + 8. The panel
    cotangent's (dx_mma_smem_bytes): SU counts pad16(F) too, the ring holds
    at least the exact layers' two f32 slabs of 16 × 4096/tile, its bf16
    rows are the panel tile's and each layer's once, and an f32 dx tile of
    pad16(F) × (tile + 4) follows them."""
    lay = K.ffn_layout(F, hidden)
    plan = _plan(kind, lay, 1, "bfloat16")
    assert plan.route == K.STREAM_MMA_ROUTE
    p16 = [-(-h // 16) * 16 for h in hidden]
    f16 = -(-F // 16) * 16
    if kind == "dx":
        su = min(64 * 8 // (plan.tile // 32), max(p16 + [f16]))
        rows = f16 + sum(p16)
        assert rows == K.stream_rows(lay, kind, K.STREAM_MMA_ROUTE)
        assert plan.smem_bytes == (
            max(2 * 3 * su * 40, 2 * 16 * (4096 // plan.tile) * 4)
            + 8 * plan.tile + 4 * 512 + 2 * rows * (plan.tile + 8)
            + 4 * f16 * (plan.tile + 4))
    else:
        su = min(64 * 8 // (plan.tile // 32), max(p16))
        rows = K.stream_rows(lay, kind)
        assert plan.smem_bytes == (2 * 3 * su * 40 + 8 * plan.tile + 4 * 512
                                   + 2 * rows * (plan.tile + 8))
    assert plan.smem_bytes <= K.MAX_SMEM
    if hidden == (256, 256):
        assert (plan.tile, plan.blocks_per_sm) == {
            "fwd": (128, 1), "bwd": (64, 1), "dx": (128, 1)}[kind]


@pytest.mark.parametrize("hidden,F,S", [((256, 256), 46, 2), ((132,), 46, 1),
                                        ((12,) * 3, 5, 3),
                                        ((8, 7, 6), 10, 2)])
def test_stream_mma_weights_equal_the_packed_weights(hidden, F, S):
    """The tensor-core route's bf16 weight copy holds exactly the packed
    (bf16-rounded) weights: each layer's [units][inputs] matrix and its
    transpose (the first layer's, K1 [F][h0], the panel cotangent's dx
    product), zero past them, every offset and row 16-byte aligned; the
    dx's Σ|W| of the top layer's units is the packed weights'."""
    g = torch.Generator().manual_seed(3)
    k1T = torch.randn(S, hidden[0], F, generator=g)
    mids = [(torch.randn(S, hidden[i], hidden[i - 1], generator=g),
             torch.randn(S, hidden[i], generator=g))
            for i in range(1, len(hidden))]
    packed = K.pack_ffn(k1T, mids, torch.randn(S, hidden[-1], generator=g),
                        torch.randn(S, generator=g), "bfloat16")
    wb = K.stream_mma_weights(packed)
    Pb, tab = K.stream_mma_table(packed.layout)
    assert wb.dtype == torch.bfloat16 and wb.shape == (S, Pb)
    assert all(v % 8 == 0 for v in tab)
    dk1T, dmids, _, _ = K.unpack_grads(packed.params, packed.layout)
    weights = [dk1T] + [w for w, _ in dmids]
    ins = (F,) + tuple(hidden[:-1])
    covered = 0
    for li, w in enumerate(weights):
        off_a, ld_a, off_t, ld_t = tab[4 * li:4 * li + 4]
        rows = -(-hidden[li] // 16) * 16
        a = wb[:, off_a:off_a + rows * ld_a].float().view(S, rows, ld_a)
        assert torch.equal(a[:, :hidden[li], :ins[li]], w)
        assert not a[:, hidden[li]:].any() and not a[:, :, ins[li]:].any()
        covered += rows * ld_a
        rows = -(-ins[li] // 16) * 16
        at = wb[:, off_t:off_t + rows * ld_t].float().view(S, rows, ld_t)
        assert ld_t == -(-hidden[li] // K.STREAM_MMA_SLAB) * K.STREAM_MMA_SLAB
        assert torch.equal(at[:, :ins[li], :hidden[li]], w.transpose(1, 2))
        assert not at[:, ins[li]:].any()
        assert not at[:, :, hidden[li]:].any()
        covered += rows * ld_t
    assert covered == Pb
    # layer 0's transpose comes last: the other matrices keep their offsets
    assert tab[2] == max(tab[2::4])
    wabs = K.stream_mma_wabs(packed)
    assert wabs.shape == (S, hidden[-1]) and wabs.dtype == torch.float32
    torch.testing.assert_close(wabs, weights[-1].abs().sum(dim=2),
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="bf16"):
        K.stream_mma_weights(K.pack_ffn(k1T, mids, torch.zeros(S, hidden[-1]),
                                        torch.zeros(S), "float32"))


@pytest.mark.parametrize("hidden,F,limit", [
    ((K.STREAM_MAX_WIDTH + 4,), 46, "(width)"),
    ((8,) * (K.STREAM_MAX_LAYERS + 1), 46, "(layers)"),
    ((64, 64), K.STREAM_MAX_F + 1, "(F)"),
], ids=["width", "layers", "F"])
def test_shapes_beyond_every_route_raise_naming_the_limit(hidden, F, limit):
    lay = K.ffn_layout(F, hidden)
    for kind in KINDS:
        for cd in DTYPES:
            with pytest.raises(ValueError, match="does not fit the streamed "
                                                 "route") as e:
                _plan(kind, lay, 1, cd)
            assert limit in str(e.value)
    assert not K.kernel_route_takes(F, hidden)


def test_scratch_and_registers_refusals_name_them():
    # the backward's gradient partials of 9 members of 64 × 2048² weights
    lay = K.ffn_layout(1024, (2048,) * 64)
    with pytest.raises(ValueError, match="scratch"):
        K.bwd_plan(lay, SMS, 9, T, N)
    # a register count no block of 256 threads holds
    with pytest.raises(ValueError, match="registers"):
        K.stream_plan(K.ffn_layout(46, (256, 256)), "fwd", SMS, 1, T, N,
                      registers=10_000)
    # 255 registers a thread: one block of 256 threads an SM
    capped = K.stream_plan(K.ffn_layout(46, (256,)), "fwd", SMS, 1, T, N,
                           registers=255)
    assert capped[2] == 1


def test_forced_tiles_stay_resident():
    """A forced stock tile is the resident route's (timing sweeps): at a
    stack the resident route cannot hold it raises, it never streams."""
    lay = K.ffn_layout(46, (256, 256))
    with pytest.raises(ValueError, match="at tile 64"):
        K.bwd_plan(lay, SMS, 1, T, N, tile=64)
    with pytest.raises(ValueError, match="at tile 64"):
        K.dx_plan(lay, SMS, 1, T, N, "float32", tile=64)


@pytest.mark.parametrize("Kn", [1, 8, 16, 17, 31, 32, 33, 48, 100])
def test_moment_chunks_cover_k_in_balanced_chunks(Kn):
    chunks = C.moment_chunks(Kn)
    sizes = [b - a for a, b in chunks]
    assert len(chunks) == -(-Kn // C.MAX_MOMENTS)
    assert chunks[0][0] == 0 and chunks[-1][1] == Kn
    assert all(b == c for (_, b), (c, _) in zip(chunks, chunks[1:]))
    assert max(sizes) <= C.MAX_MOMENTS and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)
    assert C.chunk_moments(Kn) == sizes[0]


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("Kn", [17, 32])
def test_cem_plans_plan_a_moment_chunk(Kn, cd, S):
    """Past 16 moments cem_plan and cem_dx_plan plan the largest chunk:
    the plans of K = ⌈K/⌈K/16⌉⌉; at ≤ 16 moments K itself."""
    k = C.chunk_moments(Kn)
    assert k <= C.MAX_MOMENTS
    assert C.cem_plan(S, T, N, 46, Kn, SMS, cd) == C.cem_plan(
        S, T, N, 46, k, SMS, cd)
    assert C.cem_dx_plan(S, T, N, 46, Kn, SMS, cd) == C.cem_dx_plan(
        S, T, N, 46, k, SMS, cd)
    assert C.chunk_moments(8) == 8 and C.moment_chunks(16) == [(0, 16)]


@pytest.mark.parametrize("Kn", [1, 4, 8])
@pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 6])
def test_c11_one_member_few_characteristics_plans(F, Kn):
    """C11: one member with F ≤ 6 characteristics in f32 has a panel
    cotangent plan: its items fill one warp (the 64-thread floor of the
    other shapes holds none), so the block is whole warps from 32."""
    plan = C.cem_dx_plan(1, T, N, F, Kn, SMS, "float32")
    assert plan.route == 0
    assert plan.threads >= 32 and plan.threads % 32 == 0
    assert plan.threads <= C.DX_MAX_THREADS
    assert plan.smem_bytes <= K.MAX_SMEM and plan.blocks_per_sm >= 1
    assert plan.G == min(plan.cells, plan.blocks_per_sm * SMS)


def test_a_dx_plan_that_cannot_fit_names_what_refused():
    with pytest.raises(ValueError, match="shared memory"):
        C.cem_dx_plan(9, T, N, 5000, 8, SMS, "float32")
    with pytest.raises(ValueError, match="stock tile 102"):
        C.cem_dx_plan(9, T, N, 46, 8, SMS, "float32", tile=102)
