"""The launch plan of the port's FFN backward (ops/sdf_ffn.py::bwd_plan).

The plan is arithmetic in Python, and csrc/sdf_ffn_bwd.cu recomputes and
checks it on the card (it refuses a plan that disagrees), so its shape and
its limits are held here on the CPU: every hidden width of the JAX sweep
grid (``deeplearninginassetpricing_paperreplication_tpu/parallel/sweep.py:82``
``grid_configs`` ``hidden_dims``) gets a plan within one block's shared
memory, the paper's (64, 64) keeps two or more blocks resident per SM, and
G · S blocks never spill past one wave at S ∈ {1, 2, 3, 4, 9} (S = 2 and 4
are the sweep's grids).
"""

import pytest

from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K

F = 46  # the paper's characteristics
SMS = 132  # an H100 SXM
BLOCK_SMEM_LIMIT = 232_448  # 227 KB: what one block may use
SWEEP_HIDDEN = [(64, 64), (128, 128), (64, 64, 64), (32, 32)]


@pytest.mark.parametrize("hidden", SWEEP_HIDDEN,
                         ids=["-".join(map(str, h)) for h in SWEEP_HIDDEN])
def test_every_sweep_width_gets_a_plan(hidden):
    lay = K.ffn_layout(F, hidden)
    plan = K.bwd_plan(lay, SMS, 9, 48, 10_000)
    assert plan.smem_bytes <= BLOCK_SMEM_LIMIT
    assert plan.tile in K.BWD_TILES and plan.threads == plan.tile
    assert plan.blocks_per_sm >= 1
    # what the blocks hold, as csrc/sdf_ffn_bwd.cu's smem_plan lays it out:
    # the packed weights, zp, g, and per stock an x row and one activation
    # row per layer (row strides a multiple of 4 floats with an odd quarter)
    rows = K._row_stride(F) + sum(K._row_stride(h) for h in lay.hp)
    assert plan.smem_bytes == 4 * (lay.P + lay.hp[0] + plan.tile
                                   + plan.tile * rows)
    for w in (F, *lay.hp):
        s = K._row_stride(w)
        assert s >= w and s % 4 == 0 and (s // 4) % 2 == 1
    # at most what the blocks resident on one SM can share
    assert plan.blocks_per_sm * (plan.smem_bytes + K.BLOCK_SMEM_RESERVED) \
        <= K.SM_SMEM
    if K.width_bound(hidden) == 128:
        assert plan.accumulators == "grad_part"


def test_paper_width_keeps_two_blocks_resident():
    lay = K.ffn_layout(F, (64, 64))
    plan = K.bwd_plan(lay, SMS, 1, 48, 10_000)
    assert plan.blocks_per_sm >= 2
    assert plan.smem_bytes <= 113 * 1024
    assert plan.accumulators == "registers" and plan.nt in K.BWD_REG_TILES
    _, outer, vec = K.bwd_geometry(lay, plan.tile)
    # dK1 (46 → 48 rows) and dW2 in 4 × 4 tiles; dkout, dbout and db2
    assert outer == 12 * 16 + 16 * 16 and vec == 16 + 1 + 16
    assert outer <= plan.nt * plan.tile and vec <= K.BWD_VEC_TILES * plan.tile


@pytest.mark.parametrize("S", [1, 2, 3, 4, 9])
@pytest.mark.parametrize("hidden", SWEEP_HIDDEN,
                         ids=["-".join(map(str, h)) for h in SWEEP_HIDDEN])
def test_blocks_fill_one_wave_and_no_more(S, hidden):
    lay = K.ffn_layout(F, hidden)
    for T, N in ((48, 10_000), (4, 16_384), (2, 100)):
        plan = K.bwd_plan(lay, SMS, S, T, N)
        cells = T * -(-N // plan.tile)
        assert 1 <= plan.G <= cells
        assert plan.G * S <= plan.blocks_per_sm * SMS
        if cells >= SMS * plan.blocks_per_sm:  # enough cells to fill it
            assert plan.G == plan.blocks_per_sm * SMS // S


def test_registers_bound_the_resident_blocks():
    """The registers a kernel instance takes (as the built library reports
    them) lower the blocks per SM, and G with them."""
    lay = K.ffn_layout(F, (64, 64))
    free = K.bwd_plan(lay, SMS, 9, 48, 10_000)
    # 168 registers: 5,376 a warp (21 units of 256), 16,128 for the 3
    # warps of a 96-thread block, so 4 blocks by registers; shared memory
    # keeps 2
    assert K.bwd_plan(lay, SMS, 9, 48, 10_000,
                      registers={free.nt: 168}).blocks_per_sm == 2
    # 255 registers at tile 96: 65,536 // (8,192 · 3) = 2
    tight = K.bwd_plan(lay, SMS, 9, 48, 10_000, tile=96,
                       registers={free.nt: 255})
    assert tight.blocks_per_sm == 2
    small = K.ffn_layout(F, (8, 7, 6))
    wide_open = K.bwd_plan(small, SMS, 9, 48, 10_000, tile=128)
    capped = K.bwd_plan(small, SMS, 9, 48, 10_000, tile=128,
                        registers={wide_open.nt: 200})
    # 200 registers: 6,400 a warp (25 units), 4 warps a block
    assert capped.blocks_per_sm == 65_536 // (6_400 * 4) == 2
    assert wide_open.blocks_per_sm > capped.blocks_per_sm
    assert capped.G == 2 * SMS // 9


def test_plan_refuses_what_does_not_fit():
    # (128,) * 8 outgrows the resident backward's shared memory (bwd_plan
    # then takes the streamed route, tests/test_torch_shapes.py), and a
    # width past the streamed route's limit fits no route
    with pytest.raises(ValueError, match="does not fit"):
        K.resident_bwd_plan(K.ffn_layout(F, (128,) * 8), SMS, 1, 48, 10_000)
    with pytest.raises(ValueError, match="does not fit the streamed route"):
        K.bwd_plan(K.ffn_layout(F, (K.STREAM_MAX_WIDTH + 4,)), SMS, 1, 48,
                   10_000)
    # a forced tile that does not fit at (128, 128)
    with pytest.raises(ValueError, match="at tile 128"):
        K.bwd_plan(K.ffn_layout(F, (128, 128)), SMS, 1, 48, 10_000,
                   tile=128)
