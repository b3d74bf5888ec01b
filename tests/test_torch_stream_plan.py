"""The launch plans of the kernel route's shape range (CPU arithmetic): the
SDF-FFN's streamed-weight route (ops/sdf_ffn.py stream_plan, as
csrc/sdf_ffn_stream.cu counts its shared memory), where it is chosen, its
reach and its refusals, and its tensor-core form under bf16 compute (route
STREAM_MMA_ROUTE: bf16 tiles, its bf16 weight copy) and its register-tiled
form under f32 compute (route STREAM_TILED_ROUTE, held to route 2 on the
same plan: stream_reference_plan); the conditional EM's
moment chunks (ops/cond_em.py moment_chunks, cem_plan / cem_dx_plan of a
chunk); and the panel cotangent's plan for one member with few
characteristics (C11)."""

import dataclasses

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


def _route2_tile(kind, lay, S):
    """The stock tile of route 2's own plan of `kind` (the narrow stacks'
    boundary reads it)."""
    return K.stream_plan(lay, kind, SMS, S, T, N,
                         route=K.STREAM_ROUTES["float32"])[0]


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
    layers; the 12- and 16-layer stacks keep route 3. Under f32 compute
    every kernel takes the register-tiled route, its f32 tile in shared
    memory, but the forward and the panel cotangent of the 64-wide stacks
    where route 2 takes tile 64 (the deep stacks' forward, the dx at F =
    256), which keep route 2."""
    lay = K.ffn_layout(F, hidden)
    for cd in DTYPES:
        plan = _plan(kind, lay, S, cd)
        if not K.is_stream(plan):
            assert K.resident_fits(lay)  # only (64, 64) at F = 256
            continue
        mma = (cd == "bfloat16" and kind in K.STREAM_MMA_KERNELS
               and len(hidden) <= K.STREAM_MMA_MAX_LAYERS)
        tiled = (cd == "float32"
                 and not (kind != "bwd"
                          and max(hidden) <= K.STREAM_TILED_NARROW
                          and _route2_tile(kind, lay, S) == 64))
        assert plan.route == (K.STREAM_MMA_ROUTE if mma
                              else K.STREAM_TILED_ROUTE if tiled
                              else K.STREAM_ROUTES[cd])
        assert plan.threads == (K.STREAM_TILED_THREADS if tiled
                                else K.STREAM_THREADS)
        assert plan.tile in (K.STREAM_MMA_TILES if mma
                             else K.STREAM_TILED_TILES if tiled
                             else K.STREAM_TILES)
        fixed, tf = K.stream_geometry(lay, kind, plan.tile, plan.route)
        assert plan.smem_bytes == 4 * (fixed + (0 if plan.scratch else tf))
        assert plan.scratch in ((0,) if mma or tiled else (0, tf))
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


def test_f32_dx_plan_at_256x256_is_route_5():
    """f32 compute plans the panel cotangent's register-tiled route at
    (256, 256), F = 46: 48 + 512 + 48 rows at tile 64, 227,328 B of shared
    memory (within one block's 232,448), 512 threads (DxPlan.threads is the
    route's), one block an SM, G 132 over the T·⌈N/64⌉ cells, no scratch, at
    S = 1 and 9; route 2's reference plan is its own at that tile and G."""
    lay = K.ffn_layout(46, (256, 256))
    assert K.stream_rows(lay, "dx", K.STREAM_TILED_ROUTE) == 608
    for S in (1, 9):
        plan = _plan("dx", lay, S, "float32")
        assert (plan.route, plan.tile, plan.smem_bytes, plan.threads,
                plan.blocks_per_sm, plan.G, plan.cells, plan.scratch) == (
                    K.STREAM_TILED_ROUTE, 64, 227_328,
                    K.STREAM_TILED_THREADS, 1, SMS, T * -(-N // 64), 0)
        assert 227_328 == 4 * (3 * 256 * 20 + 2 * 64 + 608 * 68) <= K.MAX_SMEM
        ref = K.stream_reference_plan(lay, "dx", plan, S)
        assert (ref.route, ref.tile, ref.G, ref.threads) == (
            K.STREAM_ROUTES["float32"], 64, SMS, K.STREAM_THREADS)


@pytest.mark.parametrize("hidden,F", [((1024,) * 32, 512), ((1536,), 46),
                                      ((1280, 1280), 46)],
                         ids=["reach", "1536", "1280x1280"])
def test_f32_dx_stacks_route_5_cannot_hold_keep_route_2(hidden, F):
    """Route 5 has no scratch form: where its dx tile does not fit shared
    memory at tile 32 (the reach, one 1,536-unit layer, two of 1,280) the
    f32 panel cotangent keeps route 2 with its tile buffers in scratch, at
    S = 1 and 9, and a route-5 plan asked for raises naming shared
    memory."""
    lay = K.ffn_layout(F, hidden)
    with pytest.raises(ValueError, match="shared memory"):
        K.stream_plan(lay, "dx", SMS, 1, T, N, route=K.STREAM_TILED_ROUTE)
    for S in (1, 9):
        plan = _plan("dx", lay, S, "float32")
        assert plan.route == K.STREAM_ROUTES["float32"] and plan.scratch > 0
        assert plan.threads == K.STREAM_THREADS


@pytest.mark.parametrize("kind,tile,smem,G9", [
    ("fwd", 64, 161_024, 132), ("bwd", 32, 171_008, 14)])
def test_f32_streamed_plans_at_256x256_are_the_cuda_cores(kind, tile, smem,
                                                          G9):
    """f32 compute plans the register-tiled route on the CUDA cores at (256,
    256), F = 46: tile 64 in shared memory (the backward's dh_pre over its
    activations: 48 + 512 rows), one block an SM, G 132 (the backward's 14 a
    member at S = 9). Route 2, asked for, keeps its plans: the forward at
    tile 64, the backward at tile 32."""
    lay = K.ffn_layout(46, (256, 256))
    for S in (1, 9):
        G = G9 if kind == "bwd" and S == 9 else 132
        plan = _plan(kind, lay, S, "float32")
        assert (plan.route, plan.tile, plan.smem_bytes, plan.blocks_per_sm,
                plan.G, plan.scratch) == (K.STREAM_TILED_ROUTE, 64, 214_272,
                                          1, G, 0)
        assert K.stream_plan(lay, kind, SMS, S, T, N, route=K.STREAM_ROUTES[
            "float32"]) == (tile, smem, 1, G, (S if kind == "fwd" else 1)
                            * T * -(-N // tile), 0)


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


@pytest.mark.parametrize("kind", K.KERNELS)
@pytest.mark.parametrize("hidden,F", [((256, 256), 46), ((132,), 46),
                                      ((64,) * 12, 46), ((200, 136, 160), 80),
                                      ((320, 320), 46)],
                         ids=["256x256", "132", "12x64", "200-136-160",
                              "320x320"])
def test_register_tiled_smem_is_what_the_kernel_counts(hidden, F, kind):
    """The register-tiled plan's shared memory, counted as
    csrc/sdf_ffn_stream.cu's tiled_smem_bytes counts it: a ring of three
    slabs of 256 units × 20 floats, the row hashes and the g row, then the
    f32 tile rows of tile + 4: the forward's panel tile and two buffers of
    the widest layer, the backward's panel tile and every layer once (each
    layer's dh_pre over its activations; route 2 adds two dh buffers), the
    panel cotangent's as the backward's and its f32 dx accumulator of
    pad16(F) rows (route 2 adds the two dh buffers)."""
    lay = K.ffn_layout(F, hidden)
    tile, smem, blocks, G, cells, scratch = K.stream_plan(
        lay, kind, SMS, 1, T, N, route=K.STREAM_TILED_ROUTE)
    p16 = [-(-h // 16) * 16 for h in hidden]
    f16 = -(-F // 16) * 16
    rows = f16 + {"fwd": 2 * max(p16), "bwd": sum(p16),
                  "dx": sum(p16) + f16}[kind]
    assert rows == K.stream_rows(lay, kind, K.STREAM_TILED_ROUTE)
    assert rows == (K.stream_rows(lay, kind) if kind == "fwd"
                    else K.stream_rows(lay, kind) - 2 * max(p16))
    ring = 3 * 256 * 20
    assert smem == 4 * (ring + 2 * tile + rows * (tile + 4))
    assert smem <= K.MAX_SMEM and scratch == 0 and blocks >= 1
    assert tile in K.STREAM_TILED_TILES
    # the larger tile wherever it fits: 64 but for the 12-layer backward
    # and dx, the 80-feature dx and the 320-wide stack
    assert tile == (64 if 4 * (ring + 128 + rows * 68) <= K.MAX_SMEM else 32)
    assert tile == (32 if hidden == (320, 320)
                    or (kind, hidden) in (("bwd", (64,) * 12),
                                          ("dx", (64,) * 12),
                                          ("dx", (200, 136, 160))) else 64)
    assert G == min(cells, blocks * SMS)


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("hidden,F", [((256, 256), 46), ((132,), 46),
                                      ((200, 136, 160), 80), ((384,), 46),
                                      ((256,) * 3, 46)],
                         ids=["256x256", "132", "200-136-160", "384",
                              "3x256"])
def test_register_tiled_backward_tile_is_one_route_2_takes(hidden, F, S):
    """Route 5's backward is bit for bit route 2's only on the same (tile,
    G), so its tile must be one route 2 takes: stream_reference_plan gives
    route 2's plan of that tile and G (the tile buffers in shared memory
    where they fit, else in scratch, within its budget), for the forward
    and the panel cotangent too."""
    lay = K.ffn_layout(F, hidden)
    for kind in K.KERNELS:
        plan = _plan(kind, lay, S, "float32")
        assert plan.route == K.STREAM_TILED_ROUTE
        assert plan.tile in K.STREAM_TILES
        ref = K.stream_reference_plan(lay, kind, plan, S)
        assert type(ref) is type(plan) and K.is_stream(ref)
        assert (ref.route, ref.tile, ref.G) == (K.STREAM_ROUTES["float32"],
                                               plan.tile, plan.G)
        fixed, tf = K.stream_geometry(lay, kind, plan.tile, ref.route)
        fits = 4 * (fixed + tf) <= K.MAX_SMEM
        assert ref.scratch == (0 if fits else tf)
        assert ref.smem_bytes == 4 * (fixed + (tf if fits else 0))
        assert ref.blocks_per_sm >= 1
        per = S if kind == "bwd" else 1
        assert 4 * ref.G * per * ref.scratch <= K.STREAM_SCRATCH_BYTES
    # a tile route 2 does not take has no reference
    bad = K.FwdPlan(K.STREAM_TILED_ROUTE, 128, 256, 1, 0, 1, 1, 1)
    with pytest.raises(ValueError, match="takes tiles"):
        K.stream_reference_plan(lay, "fwd", bad, S)


@pytest.mark.parametrize("hidden,F", PHASE21 + [((1024,) * 32, 512)],
                         ids=["256x256", "132", "12x64", "16x64", "F256",
                              "reach"])
def test_f32_dx_scratch_stacks_and_bf16_plans_keep_their_route(hidden, F):
    """Route 5 takes only f32 plans whose tile fits: the f32 panel
    cotangent takes it where its tile fits (the deep 64-wide stacks', whose
    route 2 takes tile 32, too), the reach's scratch-tile stacks stay on
    route 2, the forward and the panel cotangent of the 64-wide stacks
    where route 2 takes tile 64 on route 2 (the deep stacks' forward, the
    dx at F = 256; their backward takes route 5), and no bf16 plan is route
    5's (route 4, else route 3)."""
    lay = K.ffn_layout(F, hidden)
    for S in (1, 9):
        for kind in KINDS:
            for cd in DTYPES:
                plan = _plan(kind, lay, S, cd)
                if not K.is_stream(plan):
                    continue
                if cd == "bfloat16":
                    assert plan.route in (K.STREAM_MMA_ROUTE,
                                          K.STREAM_ROUTES["bfloat16"])
                elif (plan.scratch
                      or (kind != "bwd"
                          and max(hidden) <= K.STREAM_TILED_NARROW
                          and _route2_tile(kind, lay, S) == 64)):
                    assert plan.route == K.STREAM_ROUTES["float32"]
                else:
                    assert plan.route == K.STREAM_TILED_ROUTE
                if plan.route == K.STREAM_TILED_ROUTE:
                    assert cd == "float32"
                    assert (hidden in ((256, 256), (132,))
                            or kind in ("bwd", "dx"))
                    assert F < 512
    if F == 512:  # the reach streams its tiles through scratch on route 2
        assert K.fwd_plan(lay, SMS, 1, T, N).scratch > 0


# (hidden, F): the f32 forward's, backward's and panel cotangent's routes,
# as chip_smoke.py's turns timed them (route 2 against route 5 at T = 48, N
# = 10,000; the dx at 3 × 64, F = 512 and at (64, 64), F = 1024 on route 2
# because route 5's tile does not fit)
TIMED_ROUTES = [((64,) * 12, 46, 2, 5, 5), ((64,) * 16, 46, 2, 5, 5),
                ((64,) * 3, 512, 2, 5, 2), ((64, 64), 1024, 5, 5, 2),
                ((96, 96), 384, 5, 5, 5), ((132,), 46, 5, 5, 5),
                ((320, 320), 46, 5, 5, 5)]


@pytest.mark.parametrize("hidden,F,fwd,bwd,dx", TIMED_ROUTES,
                         ids=["12x64", "16x64", "3x64-F512", "64x64-F1024",
                              "96x96-F384", "132", "320x320"])
def test_f32_routes_are_the_faster_in_turns(hidden, F, fwd, bwd, dx):
    """The f32 forward keeps route 2 where every layer is at most
    STREAM_TILED_NARROW units wide and route 2 takes tile 64 (its 64-unit
    pass full, route 5's 256-unit pass a quarter used); it takes route 5 at
    96 units, and at 64 units where route 2 takes tile 32. The backward
    takes route 5 at every stack, the panel cotangent wherever its tile
    fits (at 12 and 16 × 64 route 2 takes tile 32). Route 2 keeps its own
    plan."""
    lay = K.ffn_layout(F, hidden)
    for S in (1, 9):
        for kind, route in (("fwd", fwd), ("bwd", bwd), ("dx", dx)):
            plan = _plan(kind, lay, S, "float32")
            assert K.is_stream(plan)
            assert plan.route == (K.STREAM_TILED_ROUTE if route == 5
                                  else K.STREAM_ROUTES["float32"])
            if route == 2:
                tile, smem, blocks, G, _, scratch = K.stream_plan(
                    lay, kind, SMS, S, T, N, route=plan.route)
                assert (plan.tile, plan.smem_bytes, plan.blocks_per_sm,
                        plan.G, plan.scratch) == (tile, smem, blocks, G,
                                                  scratch)


def test_f32_streamed_on_route2_plans_route_2_inside_the_block():
    """f32_streamed_on_route2 plans the streamed f32 forward, backward and
    panel cotangent on route 2 inside the block, as before route 5, and
    route 5 again after it; the bf16 plans do not change."""
    lay = K.ffn_layout(46, (256, 256))
    before = {(k, cd): _plan(k, lay, 1, cd) for k in KINDS for cd in DTYPES}
    with K.f32_streamed_on_route2():
        inside = {(k, cd): _plan(k, lay, 1, cd)
                  for k in KINDS for cd in DTYPES}
    after = {(k, cd): _plan(k, lay, 1, cd) for k in KINDS for cd in DTYPES}
    assert after == before
    for key, plan in inside.items():
        if key[1] == "float32":
            assert before[key].route == K.STREAM_TILED_ROUTE
            assert plan.route == K.STREAM_ROUTES["float32"]
            assert (plan.tile, plan.threads) == (
                CUDA_CORE_STOCKS[key[0]], K.STREAM_THREADS)
        else:
            assert plan == before[key]


def test_a_stack_route_5_cannot_hold_falls_to_route_2():
    """(2048,) at F = 46 is wide enough for route 5, but its tile does not
    fit shared memory at any tile it takes: the plans fall to route 2 (tile
    buffers in scratch). A launch of a route-5 plan the kernel would refuse
    raises before the card, naming the limit; so does one at the wrong
    compute."""
    lay = K.ffn_layout(46, (2048,))
    for kind in K.KERNELS:
        with pytest.raises(ValueError, match="shared memory"):
            K.stream_plan(lay, kind, SMS, 1, T, N,
                          route=K.STREAM_TILED_ROUTE)
        plan = _plan(kind, lay, 1, "float32")
        assert plan.route == K.STREAM_ROUTES["float32"] and plan.scratch > 0
    g = torch.Generator().manual_seed(0)
    S, Tc, Nc, F, hidden = 1, 2, 8, 5, (256,)
    lay = K.ffn_layout(F, hidden)
    x = torch.randn(Tc, F, Nc, generator=g)
    zp = torch.randn(S, Tc, hidden[0], generator=g)
    k1T = torch.randn(S, hidden[0], F, generator=g)
    args = (k1T, [], torch.randn(S, hidden[0], generator=g),
            torch.randn(S, generator=g))
    good = K.fwd_plan(lay, SMS, S, Tc, Nc, "float32")
    assert good.route == K.STREAM_TILED_ROUTE
    out = (torch.empty(S, Tc, Nc),)
    for bad, match in (
            (dataclasses.replace(good, smem_bytes=good.smem_bytes + 16),
             r"\(shared memory\)"),
            (dataclasses.replace(good, tile=16), r"\(shared memory\)"),
            (dataclasses.replace(good, scratch=1), r"\(shared memory\)")):
        with pytest.raises(ValueError, match=match):
            K._stream_launch("fwd", x, zp, K.pack_ffn(*args, "float32"), bad,
                             0, 0.0, 0, out)
    with pytest.raises(ValueError, match="not the streamed route at bfloat16"):
        K._stream_launch("fwd", x, zp, K.pack_ffn(*args, "bfloat16"), good, 0,
                         0.0, 0, out)
    # the panel cotangent's route-5 plan: 2·pad16(F) + 256 rows at tile 64
    dx = K.dx_plan(lay, SMS, S, Tc, Nc, "float32")
    assert (dx.route, dx.tile, dx.threads, dx.scratch) == (
        K.STREAM_TILED_ROUTE, 64, K.STREAM_TILED_THREADS, 0)
    assert dx.smem_bytes == 4 * (3 * 256 * 20 + 128 + (16 + 256 + 16) * 68)
    outs = (torch.empty(S, Tc, Nc), torch.empty_like(x))
    for bad in (dataclasses.replace(dx, smem_bytes=good.smem_bytes),
                dataclasses.replace(dx, tile=16),
                dataclasses.replace(dx, scratch=1)):
        with pytest.raises(ValueError, match=r"route 5 refuses .*"
                                             r"\(shared memory\)"):
            K._stream_launch("dx", x, zp, K.pack_ffn(*args, "float32"), bad,
                             0, 0.0, 0, outs)
    with pytest.raises(ValueError, match="not the streamed route at bfloat16"):
        K._stream_launch("dx", x, zp, K.pack_ffn(*args, "bfloat16"), dx, 0,
                         0.0, 0, outs)


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
