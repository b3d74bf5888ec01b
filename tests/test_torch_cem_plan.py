"""The launch plan of the port's conditional-EM kernels
(ops/cond_em.py::cem_plan).

The plan is arithmetic in Python, and csrc/cond_em.cu recomputes its
shared memory and threads, asks the card how many blocks it keeps resident,
and refuses a plan that disagrees. So its shape and its limits are held
here on the CPU, at the shapes the training paths and the JAX sweep grid
use: S ∈ {1, 2, 3, 4, 9} members (S = 2 and 4 are the sweep's grids),
K ∈ {4, 8} moments (the sweep's ``num_condition_moment``), the paper's
F = 46 and the fixture's F = 10,
T ∈ {4, 12, 24, 48} periods and a ragged N, both dtypes, on an H100's 132
SMs. Every plan fits one block's shared memory and fills whole waves (the
grid is resident at once). The period groups and the backward's 128-stock
tiles are what keep the f32 sums bit for bit those of the
one-thread-per-stock kernels, so they are pinned to ``_groups``.
"""

import itertools

import pytest

from deeplearninginassetpricing_paperreplication_torch.ops import cond_em as C

SMS = 132  # an H100 SXM
BLOCK_SMEM_LIMIT = 232_448  # 227 KB: what one block may use
SM_SMEM = 233_472  # 228 KB an SM, with 1 KB reserved per resident block
SHAPES = list(itertools.product((1, 2, 3, 4, 9), (4, 8), (46, 10), (4, 12, 24, 48),
                                (10000, 10007)))
IDS = [f"S{s}-K{k}-F{f}-T{t}-N{n}" for s, k, f, t, n in SHAPES]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,F,T,N", SHAPES, ids=IDS)
def test_plans_fit_and_fill_whole_waves(S, K, F, T, N, cd):
    for p in C.cem_plan(S, T, N, F, K, SMS, cd):
        assert p.smem_bytes <= BLOCK_SMEM_LIMIT
        assert p.blocks_per_sm >= 1
        assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SM_SMEM
        assert p.blocks_per_sm * p.threads <= 2048 and p.threads % 32 == 0
        # whole waves: every block of the grid is resident at once
        assert p.blocks <= p.blocks_per_sm * SMS
        assert p.grid[2 if p.kernel == "fwd" else 0] == -(-S // p.members)
        assert 1 <= p.members <= S
        # bf16 products on the tensor cores where the k steps allow
        assert p.route == (1 if cd == "bfloat16" and F <= C.MMA_MAX_F else 0)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,F,T,N", SHAPES, ids=IDS)
def test_sum_partitions_are_the_bitwise_contract(S, K, F, T, N, cd):
    """The forward's period groups are those of 64-stock blocks, the
    backward's those of its 128-stock partial tiles; the grid covers every
    stock and member, and the geometry is what the kernel counts."""
    fwd, bwd = C.cem_plan(S, T, N, F, K, SMS, cd)
    assert fwd.groups == C._groups(S, T, N, 64, SMS, 4)
    assert fwd.grid[1] == fwd.groups and fwd.grid[0] * fwd.tile >= N
    assert bwd.groups == C._groups(S, T, N, 128, SMS, 4)
    assert bwd.tile == C.BWD_STOCKS == 128
    assert bwd.grid[1:] == (-(-N // 128), bwd.groups)
    tpg = -(-T // fwd.groups)
    assert (fwd.threads, fwd.smem_bytes // 4) == C.fwd_geometry(
        fwd.route, fwd.members, F, K, tpg, fwd.tile, fwd.var, fwd.stages)
    tpg = -(-T // bwd.groups)
    assert (bwd.threads, bwd.smem_bytes // 4) == C.bwd_geometry(
        bwd.route, bwd.members, F, K, tpg, cd == "bfloat16", bwd.var,
        bwd.stages)


def test_geometry_at_the_ensemble_shape():
    """The words csrc/cond_em.cu lays out at S = 9, T = 48, F = 46, K = 8."""
    # forward f32: kT 9·46·8, zp_m 48·9·8, two panel slabs 46 × 76 and
    # two xr rows 9 × 76; 9 members × 38 stock pairs, to whole warps
    assert C.fwd_geometry(0, 9, 46, 8, 48, 76, 2, 2) == (
        352, 3312 + 3456 + 2 * 46 * 76 + 2 * 9 * 76)
    # forward bf16: zp_m [48][72], slabs [16·3][80 + 4] and xr; 3 row groups
    # of 3 n tiles × 5 warps of 16 stocks
    assert C.fwd_geometry(1, 9, 46, 8, 48, 80, 3, 4) == (
        480, 48 * 72 + 4 * 48 * 84 + 4 * 9 * 80)
    # backward f32, three members a block: kT, zp_m, one stage [46][132],
    # xr, the stock-major tile [128][48], dpre [128][28]
    assert C.bwd_geometry(0, 3, 46, 8, 48, False, 0, 1) == (
        192, 1104 + 1152 + 46 * 132 + 3 * 128 + 128 * 48 + 128 * 28)
    # without the stock-major tile: one stage of 48 rows
    assert C.bwd_geometry(0, 1, 46, 8, 7, False, 1, 1) == (
        64, 368 + 56 + 48 * 132 + 128 + 128 * 12)


@pytest.mark.parametrize("smem,threads,regs,blocks", [
    (76608, 96, 183, 2), (57216, 64, 127, 4), (93952, 352, 64, 2),
    (60512, 352, 60, 2), (89856, 480, 90, 1)])
def test_residency_is_what_the_card_reported(smem, threads, regs, blocks):
    """Resident blocks per SM as the H100's occupancy query reported them
    for built kernels: each scheduler holds a quarter of the register file,
    so three 96-thread blocks of 183 registers do not fit where the total
    would."""
    assert C._resident(smem, threads, regs) == blocks


def test_the_main_paths_plans():
    """The plans of the training paths (T = 48, N = 10,000, K = 8)."""
    one = C.cem_plan(1, 48, 10000, 46, 8, SMS, "float32")
    assert (one.fwd.tile, one.fwd.var, one.fwd.grid) == (304, 1, (33, 4, 1))
    assert (one.bwd.var, one.bwd.stages, one.bwd.grid) == (1, 1, (1, 79, 7))
    ens = C.cem_plan(9, 48, 10000, 46, 8, SMS, "float32")
    assert (ens.fwd.tile, ens.fwd.members, ens.fwd.var) == (76, 9, 2)
    assert ens.fwd.blocks == SMS  # one block an SM, every member on it
    assert (ens.bwd.members, ens.bwd.var, ens.bwd.grid) == (3, 0, (3, 79, 1))
    bf = C.cem_plan(9, 48, 10000, 46, 8, SMS, "bfloat16")
    assert (bf.fwd.route, bf.fwd.tile, bf.fwd.members) == (1, 80, 9)
    assert (bf.bwd.route, bf.bwd.members, bf.bwd.var) == (1, 3, 8)


# K = 17 plans its moment chunks (tests/test_torch_shapes.py), so it refuses
# only what a chunk cannot fit
@pytest.mark.parametrize("kw", [dict(F=5000), dict(K=17, F=5000), dict(K=0),
                                dict(F=5000, cd="bfloat16")],
                         ids=["wide-F", "K17", "K0", "wide-F-bf16"])
def test_a_shape_that_cannot_fit_raises(kw):
    S, T, N, F, K = 9, 48, 10000, kw.get("F", 46), kw.get("K", 8)
    with pytest.raises(ValueError):
        C.cem_plan(S, T, N, F, K, SMS, kw.get("cd", "float32"))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 9])
def test_stages_and_instances(S, cd):
    """The CUDA-core routes take a constant number of stages (the forward
    two, the backward one) and a built instance; the geometry refuses any
    other stage count there, as csrc/cond_em.cu does."""
    fwd, bwd = C.cem_plan(S, 48, 10000, 46, 8, SMS, cd)
    if fwd.route == 0:
        assert fwd.stages == C.FWD_CORES_STAGES
        assert fwd.var in C.FWD_CTS[C.fwd_rt(8)]
    else:
        assert fwd.stages in C.FWD_STAGES
    assert bwd.stages == 1 if bwd.route == 0 else bwd.stages in C.BWD_STAGES
    assert C.fwd_geometry(0, S, 46, 8, 48, 76, 2, 3) == (0, 0)
    assert C.bwd_geometry(0, S, 46, 8, 48, False, 0, 2) == (0, 0)


def test_an_unknown_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        C.cem_plan(9, 48, 10000, 46, 8, SMS, "float16")


# -- the panel cotangent's plan (ops/cond_em.py::cem_dx_plan) -----------------

DX_PLAN_SHAPES = list(itertools.product((1, 3, 9), (4, 8, 16), (10, 46, 80)))
DX_IDS = [f"S{s}-K{k}-F{f}" for s, k, f in DX_PLAN_SHAPES]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,K,F", DX_PLAN_SHAPES, ids=DX_IDS)
def test_dx_plan_fits_and_fills_whole_waves(S, K, F, cd):
    T, N = 48, 10000
    p = C.cem_dx_plan(S, T, N, F, K, SMS, cd)
    assert p.smem_bytes <= BLOCK_SMEM_LIMIT
    assert p.smem_bytes == 4 * C.dx_geometry(p.route, S, F, K, p.tile)
    assert p.blocks_per_sm >= 1
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SM_SMEM
    assert p.blocks_per_sm * p.threads <= 2048 and p.threads % 32 == 0
    # a persistent grid of whole waves: every block resident at once
    assert p.cells == T * -(-N // p.tile)
    assert p.G == min(p.cells, p.blocks_per_sm * SMS)
    assert p.stages == C.DX_STAGES == 2
    # bf16 products on the tensor cores where the k steps allow
    assert p.route == (1 if cd == "bfloat16" and F <= C.MMA_MAX_F else 0)
    if p.route == 1:
        assert p.tile in C.DX_MMA_TILES and p.threads == 2 * p.tile
    else:
        assert p.tile in C.DX_TILES and p.threads <= C.DX_MAX_THREADS
        assert 0 < C.dx_balance(S, F, K, p.tile, p.threads) <= 1


def test_dx_plan_of_the_panel_gradient():
    """The panel-gradient path's plans (S = 9, T = 48, N = 10,000, F = 46,
    K = 8): f32 on the CUDA cores, without a register bound 128-stock cells
    of nine warps whose phases (9 × 32 pre items, 8 × 32 dx tiles) each
    take one round; at the 122 registers the card reported, which hold 16
    warps an SM, three blocks of five warps on 64-stock cells; bf16 on the
    tensor cores, a warp per 16 stocks, two blocks an SM."""
    f32 = C.cem_dx_plan(9, 48, 10000, 46, 8, SMS, "float32")
    assert (f32.route, f32.tile, f32.threads, f32.blocks_per_sm, f32.G,
            f32.cells) == (0, 128, 288, 2, 264, 3792)
    assert f32.smem_bytes == 4 * (9 * 48 * 8 + 2 * (46 + 9) * 128
                                  + 72 * 128)
    card = C.cem_dx_plan(9, 48, 10000, 46, 8, SMS, "float32", {0: 122})
    assert (card.tile, card.threads, card.blocks_per_sm, card.G) == (
        64, 160, 3, 396)
    bf = C.cem_dx_plan(9, 48, 10000, 46, 8, SMS, "bfloat16")
    assert (bf.route, bf.tile, bf.threads, bf.blocks_per_sm, bf.G) == (
        1, 128, 256, 2, 264)
    # kT twice in bf16 (80 rows of 28 words, 48 rows of 44), the members of
    # the 80 rows, two panel slabs [48][132], xr rows [9][128] and zp_m [80]
    assert bf.smem_bytes == 4 * (80 * 28 + 48 * 44 + 80 + 2 * (
        48 * 132 + 9 * 128 + 80))


def test_dx_registers_bound_the_resident_blocks():
    free = C.cem_dx_plan(9, 48, 10000, 46, 8, SMS, "bfloat16")
    tight = C.cem_dx_plan(9, 48, 10000, 46, 8, SMS, "bfloat16",
                          registers={1: 168}, tile=free.tile)
    assert tight.blocks_per_sm < free.blocks_per_sm
    assert tight.G == tight.blocks_per_sm * SMS
    # another route's registers do not bind
    assert C.cem_dx_plan(9, 48, 10000, 46, 8, SMS, "bfloat16",
                         registers={0: 255}) == free


def test_dx_balance_counts_rounds():
    # 144 pre items and 128 dx tiles on 160 threads: one round each
    assert C.dx_balance(9, 46, 4, 64, 160) == pytest.approx(
        (144 * 4 * 4 * 46 + 128 * 24 * 9 * 4) / (160 * (4 * 4 * 46
                                                          + 24 * 9 * 4)))
    # on 128 threads phase A takes two rounds
    assert C.dx_balance(9, 46, 8, 64, 128) < C.dx_balance(9, 46, 8, 64, 160)


@pytest.mark.parametrize("kw", [dict(F=5000), dict(K=17, F=5000), dict(K=0),
                                dict(tile=102), dict(tile=4096),
                                dict(F=5000, cd="bfloat16")],
                         ids=["wide-F", "K17", "K0", "tile102", "tile4096",
                              "wide-F-bf16"])
def test_a_dx_shape_that_cannot_fit_raises(kw):
    with pytest.raises(ValueError):
        C.cem_dx_plan(9, 48, 10000, kw.get("F", 46), kw.get("K", 8), SMS,
                      kw.get("cd", "float32"), tile=kw.get("tile"))


@pytest.mark.parametrize("F", [46, 64, 65, 80])
def test_dx_bf16_past_64_features_takes_the_cuda_cores(F):
    assert C.dx_route(F, "bfloat16") == (1 if F <= 64 else 0)
    assert C.dx_route(F, "float32") == 0
    assert C.cem_dx_plan(3, 12, 1001, F, 8, SMS, "bfloat16").route == (
        1 if F <= 64 else 0)
