"""The launch plan of the port's FFN forward (ops/sdf_ffn.py::fwd_plan).

The plan is arithmetic in Python, and csrc/sdf_ffn.cu recomputes and
checks it on the card (it refuses a plan that disagrees, or one whose grid
the card cannot keep resident), so its shape and its limits are held here
on the CPU for every hidden width of the JAX sweep grid
(``deeplearninginassetpricing_paperreplication_tpu/parallel/sweep.py:82``
``grid_configs`` ``hidden_dims``) and S ∈ {1, 2, 3, 4, 9} (one model, the
sweep's --quick and bucket grids, the diagnostic retrains, the ensemble),
both routes: the plan fits one block's shared memory and the SM's at its
blocks per SM, respects the registers the built kernels report, and its
grid is the persistent set of resident blocks (or every cell, where there
are fewer).
"""

import pytest

from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K

F = 46  # the paper's characteristics
SMS = 132  # an H100 SXM
BLOCK_SMEM_LIMIT = 232_448  # 227 KB: what one block may use
SWEEP_HIDDEN = [(64, 64), (128, 128), (64, 64, 64), (32, 32)]
IDS = ["-".join(map(str, h)) for h in SWEEP_HIDDEN]
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("S", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("hidden", SWEEP_HIDDEN, ids=IDS)
def test_every_sweep_width_gets_a_plan_that_fits(hidden, S, cd):
    lay = K.ffn_layout(F, hidden)
    plan = K.fwd_plan(lay, SMS, S, 48, 10_000, cd)
    assert plan.route == K.FWD_ROUTES[cd]
    assert plan.smem_bytes <= BLOCK_SMEM_LIMIT
    assert plan.blocks_per_sm >= 1
    assert plan.blocks_per_sm * (plan.smem_bytes + K.BLOCK_SMEM_RESERVED) \
        <= K.SM_SMEM
    assert plan.blocks_per_sm * plan.threads <= K.SM_MAX_THREADS
    assert plan.smem_bytes == 4 * K.fwd_geometry(lay, plan.route, plan.tile,
                                                 plan.members)[0]
    if cd == "float32":
        assert plan.members == 1
        assert plan.tile in K.FWD_TILES and plan.threads in K.FWD_THREADS
    else:
        # the tensor-core route: 8 warps of 16 stocks, twice where two
        # member phases fit, and the members split into balanced groups
        # that each fit one block
        assert plan.tile == K.MMA_TILE
        assert plan.threads == (512 if S > 1 and K.width_bound(hidden) <= 64
                                else 256)
        groups = -(-S // plan.members)
        assert 1 <= plan.members <= S and -(-S // groups) == plan.members
        if K.fwd_geometry(lay, 1, K.MMA_TILE, S)[0] * 4 <= BLOCK_SMEM_LIMIT:
            assert plan.members == S  # one panel tile serves every member


def test_smem_geometry_at_the_paper_width():
    """The words csrc/sdf_ffn.cu's smem_plan lays out at (64, 64)."""
    lay = K.ffn_layout(F, (64, 64))
    # f32 at tile 64: k1 46×64, W2ᵀ 64×64, b2, kout, bout; zp; row hashes;
    # the x tile, which layer 2 overwrites (max(46, 64) × 64), and layer
    # 1's tile 64×64
    w = 46 * 64 + 64 * 64 + 64 + 64 + 4
    assert K.fwd_geometry(lay, 0, 64) == (w + 64 + 64 + 2 * 64 * 64, w)
    # units pad to 8 (a register tile's width), inputs stay at 4
    odd = K.ffn_layout(46, (12, 20))
    w = 46 * 16 + 12 * 24 + 24 + 20 + 4
    assert K.fwd_geometry(odd, 0, 32) == (w + 16 + 32 + (46 + 24) * 32, w)
    # bf16: two f32 x tiles 48 × (128 + 4); per member two zp rows of 64,
    # B rows of 64 units × (48/2 + 4) and × (64/2 + 4) words, b2 in f32,
    # the output product's 8 B rows × (64/2 + 4) words and bout
    member = 2 * 64 + 64 * 28 + 64 * 36 + 64 + 8 * 36 + 4
    assert K.fwd_geometry(lay, 1, 128, 9) == (2 * 48 * 132 + 9 * member,
                                              member)
    # ragged widths pad every layer to the library's bound (here w32), the
    # first layer's inputs to 16
    odd = K.ffn_layout(5, (7, 5, 3))
    member = 2 * 32 + 32 * (8 + 4) + 2 * 32 * (16 + 4) + 2 * 32 + 8 * 20 + 4
    assert K.fwd_geometry(odd, 1, 128, 2)[1] == member


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("S", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("hidden", SWEEP_HIDDEN, ids=IDS)
def test_grid_is_the_resident_set(hidden, S, cd):
    lay = K.ffn_layout(F, hidden)
    for T, N in ((48, 10_000), (4, 16_384), (2, 100)):
        plan = K.fwd_plan(lay, SMS, S, T, N, cd)
        assert plan.cells == -(-S // plan.members) * T * -(-N // plan.tile)
        assert plan.G == min(plan.cells, plan.blocks_per_sm * SMS)
        # every cell is walked by exactly one block; no block idles while
        # another has two cells more than it
        per_block = -(-plan.cells // plan.G)
        assert (per_block - 1) * plan.G < plan.cells <= per_block * plan.G


def test_paper_width_keeps_at_least_two_blocks_resident():
    lay = K.ffn_layout(F, (64, 64))
    f32 = K.fwd_plan(lay, SMS, 9, 48, 10_000, "float32")
    assert f32.blocks_per_sm >= 2 and f32.tile * f32.blocks_per_sm >= 128
    bf16 = K.fwd_plan(lay, SMS, 3, 4, 16_384, "bfloat16")  # serving
    assert bf16.blocks_per_sm * bf16.threads >= 512 and bf16.members == 3
    # all nine members' bf16 weights and the double-buffered tile fit one
    # block: the panel tile is read once for the whole ensemble
    ens = K.fwd_plan(lay, SMS, 9, 48, 10_000, "bfloat16")
    assert ens.members == 9 and ens.cells == 48 * -(-10_000 // 128)


def test_registers_bound_the_resident_blocks():
    """The registers a kernel reports lower the blocks per SM, and G with
    them: a 158-register kernel at 128 threads leaves room for 3."""
    lay = K.ffn_layout(F, (32, 32))
    free = K.fwd_plan(lay, SMS, 9, 48, 10_000, "float32")
    assert free.threads == 128
    # 158 registers: 5,120 a warp (20 units of 256), 20,480 a block: 3
    capped = K.fwd_plan(lay, SMS, 9, 48, 10_000, "float32",
                        registers={0: 158})
    assert capped.blocks_per_sm <= 3
    small = K.ffn_layout(F, (8, 7, 6))
    open_ = K.fwd_plan(small, SMS, 9, 48, 10_000, "float32")
    tight = K.fwd_plan(small, SMS, 9, 48, 10_000, "float32",
                       registers={0: 158})
    assert open_.blocks_per_sm > tight.blocks_per_sm == 3
    assert tight.G == 3 * SMS
    # the bf16 kernel's registers bound its blocks: at 128 registers a
    # 16-warp block (two member phases) fits, at 129 only an 8-warp one;
    # 128 registers keep two 8-warp blocks (65,536 / (4,096 · 8))
    lay = K.ffn_layout(F, (64, 64))
    assert K.fwd_plan(lay, SMS, 3, 4, 16_384, "bfloat16",
                      registers={1: 128}).threads == 512
    one = K.fwd_plan(lay, SMS, 3, 4, 16_384, "bfloat16", registers={1: 129})
    assert one.threads == 256 and one.blocks_per_sm == 1 and one.G == SMS
    assert K.fwd_plan(lay, SMS, 1, 48, 10_000, "bfloat16",
                      registers={1: 128}).blocks_per_sm == 2


def test_plan_refuses_what_does_not_fit():
    for cd in DTYPES:
        with pytest.raises(ValueError, match="does not fit"):
            K.fwd_plan(K.ffn_layout(2000, (128, 128)), SMS, 1, 48, 10_000, cd)
    with pytest.raises(ValueError, match="compute_dtype"):
        K.fwd_plan(K.ffn_layout(F, (64, 64)), SMS, 1, 48, 10_000, "float16")
