"""The port's serving mesh on the CPU, case for case as
``tests/test_serving.py`` holds the JAX engine's on its 8-device virtual
CPU mesh: the degenerate mesh, the stock-sharded and member-sharded
meshes, the validation messages, the hot swap and the canary's revert,
macro appends, ``server_child_argv``/``fleet.json`` and ``--mesh_slice``.

The port's single-process mesh holds ``torch.device``s and the CPU has
one, so its positions here all name it (the Python API allows that; the
CLI spec does not: a spec needing more devices than the host has is an
error). The bars (``PERF.md`` §2): a ``stocks=1`` mesh is bit for bit the
one-device engine; a sharded engine is within ``SHARDED_ATOL`` = 1e-6 of
it (JAX's bar: the port gathers the members' weights and runs the
cross-section on one position, so only the plain route's matmul blocking
over a span can move a bit); captures after warmup are 0. Against the JAX
mesh engines the port is held at the serving bars of
``tests/test_torch_serving.py`` (weights and SDF atol 2e-5): the JAX
engine is not bit for bit even against itself on this tree (ROADMAP C1).

Members are JAX-initialized params exported as reference ``.pt`` run
dirs (hidden (8, 8), LSTM (4,), dropout 0), which both packages read.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.parallel import (
    partition,
)
from deeplearninginassetpricing_paperreplication_torch.serving.autoscale import (  # noqa: E501
    FleetController,
)
from deeplearninginassetpricing_paperreplication_torch.serving.engine import (
    InferenceEngine,
    InferenceRequest,
)
from deeplearninginassetpricing_paperreplication_torch.serving.fleet import (
    read_fleet_json,
    server_child_argv,
)
from deeplearninginassetpricing_paperreplication_torch.serving.server import (
    build_arg_parser,
    main as serve_main,
    mesh_config,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    partition as jpartition,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    autoscale as jautoscale,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    engine as jengine,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    fleet as jfleet,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    server as jserver,
)
from deeplearninginassetpricing_paperreplication_tpu.training.checkpoint import (  # noqa: E501
    save_torch_checkpoint,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

CPU = torch.device("cpu")
CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
SHARDED_ATOL = 1e-6
CROSS_ATOL = 2e-5
STATS_KEYS = ("mesh", "mesh_devices", "stock_shards", "member_axis",
              "sharded_dispatch")


def _jcfg(train):
    return JGANConfig(macro_feature_dim=train.macro_feature_dim,
                      individual_feature_dim=train.individual_feature_dim,
                      hidden_dim=(8, 8), num_units_rnn=(4,), dropout=0.0)


def _write(d, cfg, seed):
    save_torch_checkpoint(d / "best_model_sharpe.pt",
                          JGAN(cfg).init(jax.random.key(seed)), cfg)
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, splits):
    root = tmp_path_factory.mktemp("mesh_members")
    return [_write(root / f"seed_{s}", _jcfg(splits[0]), s)
            for s in (0, 1, 2)]


def _cpu_mesh(*axes):
    n = int(np.prod([s for _, s in axes]))
    return partition.MeshConfig(tuple(axes), (CPU,) * n)


def _engine(dirs, splits, mesh=None, **kw):
    _, _, test = splits
    kw.setdefault("stock_buckets", (64, 96))
    kw.setdefault("batch_buckets", (1, 2))
    return InferenceEngine(dirs, macro_history=test.macro, exec_cfg=CPU_F32,
                           mesh=mesh, **kw)


def _jengine(dirs, splits, mesh=None, **kw):
    _, _, test = splits
    kw.setdefault("stock_buckets", (64, 96))
    kw.setdefault("batch_buckets", (1, 2))
    return jengine.InferenceEngine(dirs, macro_history=test.macro, mesh=mesh,
                                   **kw)


def _req(ds, t, returns=True, n=None):
    n = ds.N if n is None else n
    return InferenceRequest(
        individual=ds.individual[t][:n], mask=ds.mask[t][:n].astype(
            np.float32),
        returns=ds.returns[t][:n] if returns else None, month=t)


def _jreq(r):
    return jengine.InferenceRequest(individual=r.individual, mask=r.mask,
                                    returns=r.returns, month=r.month)


def _same(a, b):
    np.testing.assert_array_equal(a.weights, b.weights)
    assert a.sdf == b.sdf
    if a.member_sdf is not None:
        np.testing.assert_array_equal(a.member_sdf, b.member_sdf)


def _close(a, b, atol):
    np.testing.assert_allclose(a.weights, b.weights, atol=atol, rtol=0)
    if a.sdf is not None:
        assert abs(a.sdf - b.sdf) < atol
        np.testing.assert_allclose(a.member_sdf, b.member_sdf, atol=atol,
                                   rtol=0)


def test_engine_degenerate_mesh_bitwise_identical(dirs, splits):
    _, _, test = splits
    ref = _engine(dirs, splits)
    eng = _engine(dirs, splits, "stocks=1")
    jeng = _jengine(dirs, splits, "stocks=1")
    stats = eng.stats()
    assert {k: stats[k] for k in STATS_KEYS} == {
        k: jeng.stats()[k] for k in STATS_KEYS} == {
        "mesh": "stocks=1", "mesh_devices": 1, "stock_shards": 1,
        "member_axis": None, "sharded_dispatch": False}
    assert ref.stats()["mesh"] == "stocks=1"
    assert ref.stats()["sharded_dispatch"] is False
    for t in (0, 5, test.T - 1):
        a = ref.infer_one(_req(test, t))
        _same(a, eng.infer_one(_req(test, t)))
        _close(a, jeng.infer_one(_jreq(_req(test, t))), CROSS_ATOL)


def test_engine_sharded_mesh_matches_single_device(dirs, splits):
    """stocks=8 over eight CPU positions: per-position span staging, the
    cross-section on the first position, within SHARDED_ATOL of the
    one-device engine and within the serving bar of JAX's stocks=8
    engine, with no capture after warmup."""
    _, _, test = splits
    ref = _engine(dirs, splits)
    eng = _engine(dirs, splits, _cpu_mesh(("stocks", 8)))
    jeng = _jengine(dirs, splits, "stocks=8", stock_buckets=(64,),
                    batch_buckets=(1,))
    stats = eng.stats()
    assert {k: stats[k] for k in STATS_KEYS} == {
        k: jeng.stats()[k] for k in STATS_KEYS} == {
        "mesh": "stocks=8", "mesh_devices": 8, "stock_shards": 8,
        "member_axis": None, "sharded_dispatch": True}
    assert eng.warmup() == 4
    assert eng.stats()["staging_buffers"] == 4
    for t in (0, 3, test.T - 1):
        a = eng.infer_one(_req(test, t))
        _close(a, ref.infer_one(_req(test, t)), SHARDED_ATOL)
        _close(a, jeng.infer_one(_jreq(_req(test, t))), CROSS_ATOL)
        np.testing.assert_allclose(np.abs(a.weights).sum(), 1.0, rtol=1e-5)
    # micro-batched, and a short request padded into the 64 bucket's spans
    res = eng.infer([_req(test, t, returns=False) for t in (2, 9)])
    for r, t in zip(res, (2, 9)):
        assert r.batch_bucket == 2
        _close(r, ref.infer_one(_req(test, t, returns=False)), SHARDED_ATOL)
    r40 = eng.infer_one(_req(test, 4, returns=False, n=40))
    assert (r40.bucket, r40.n) == (64, 40)
    _close(r40, ref.infer_one(_req(test, 4, returns=False, n=40)),
           SHARDED_ATOL)
    # a CUDA-free engine has no graphs: the counter stays at its warmup
    assert eng.stats()["steady_state_captures"] == 0
    # the eager route is the same steps
    got = eng.infer([_req(test, 1)], graphs=False)[0]
    _same(got, eng.infer_one(_req(test, 1)))


def test_engine_mesh_member_axis(tmp_path, splits):
    """members=2,stocks=4: the member axis cuts the stack, the stocks cut
    each member row's bucket; within the bars of the 2-member one-device
    engine and the JAX mesh engine."""
    _, _, test = splits
    dirs2 = [_write(tmp_path / f"seed_{s}", _jcfg(splits[0]), s)
             for s in (0, 1)]
    ref = _engine(dirs2, splits, stock_buckets=(64,), batch_buckets=(1,))
    eng = _engine(dirs2, splits, _cpu_mesh(("members", 2), ("stocks", 4)),
                  stock_buckets=(64,), batch_buckets=(1,))
    jeng = _jengine(dirs2, splits, "members=2,stocks=4",
                    stock_buckets=(64,), batch_buckets=(1,))
    assert {k: eng.stats()[k] for k in STATS_KEYS} == {
        k: jeng.stats()[k] for k in STATS_KEYS}
    assert eng.stats()["member_axis"] == "members"
    assert eng.stats()["stock_shards"] == 4
    for t in (1, 7):
        a = eng.infer_one(_req(test, t))
        _close(a, ref.infer_one(_req(test, t)), SHARDED_ATOL)
        _close(a, jeng.infer_one(_jreq(_req(test, t))), CROSS_ATOL)


@pytest.mark.parametrize("mesh,buckets,match", [
    ("stocks=8", (60,), "divisible"),
    ("members=2,stocks=4", (64,), "member"),
])
def test_engine_mesh_validation(dirs, splits, mesh, buckets, match):
    """The JAX engine's two refusals, with its words; the port's mesh of
    eight CPU positions stands in for the spec on the one-device CPU."""
    axes = partition.parse_mesh_spec(mesh).axes
    with pytest.raises(ValueError, match=match):
        _engine(dirs, splits, _cpu_mesh(*axes), stock_buckets=buckets,
                batch_buckets=(1,))
    with pytest.raises(ValueError, match=match):
        _jengine(dirs, splits, mesh, stock_buckets=buckets,
                 batch_buckets=(1,))


def test_engine_mesh_spec_wider_than_the_host_is_an_error(dirs, splits):
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        _engine(dirs, splits, "stocks=2")
    with pytest.raises(ValueError, match="one member axis only"):
        _engine(dirs, splits, _cpu_mesh(("stocks", 2), ("other", 2)))


def test_engine_mesh_hot_swap_and_revert(tmp_path, splits):
    """A reload copies into every position's tensors: the swapped
    generation matches a fresh one-device engine of the new params, and the
    canary's revert gives the pre-swap answers back bit for bit."""
    _, _, test = splits
    cfg = _jcfg(splits[0])
    dirs = [_write(tmp_path / f"seed_{s}", cfg, s) for s in (0, 1, 2)]
    eng = _engine(dirs, splits, _cpu_mesh(("members", 1), ("stocks", 4)),
                  stock_buckets=(64,), batch_buckets=(1,))
    eng.warmup()
    before = eng.infer_one(_req(test, 0))
    snap = eng.snapshot_params()
    _write(tmp_path / "seed_0", cfg, 99)
    out = eng.reload()
    assert out["swapped"] is True and out["params_generation"] == 1
    ref = _engine(dirs, splits, stock_buckets=(64,), batch_buckets=(1,))
    for t in (0, 6):
        _close(eng.infer_one(_req(test, t)), ref.infer_one(_req(test, t)),
               SHARDED_ATOL)
    assert not np.array_equal(eng.infer_one(_req(test, 0)).weights,
                              before.weights)
    eng.restore_params(snap)
    _same(eng.infer_one(_req(test, 0)), before)
    assert eng.stats()["steady_state_captures"] == 0


def test_engine_mesh_macro_append_matches_rescan(dirs, splits):
    """Appended months drive the same spans: the answer equals a fresh
    sharded engine scanning the full history, within the rescan bar of
    ``test_torch_serving.py``."""
    _, _, test = splits
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((2, test.macro.shape[1])).astype(np.float32)
    inc = _engine(dirs, splits, _cpu_mesh(("stocks", 8)),
                  stock_buckets=(64,), batch_buckets=(1,))
    for row in rows:
        inc.append_month(row)
    full = InferenceEngine(dirs, macro_history=np.concatenate(
        [test.macro, rows]), stock_buckets=(64,), batch_buckets=(1,),
        exec_cfg=CPU_F32, mesh=_cpu_mesh(("stocks", 8)))
    r = _req(test, 1)
    r.month = test.T + 1
    np.testing.assert_allclose(inc.infer_one(r).weights,
                               full.infer_one(r).weights, atol=2e-5)


def test_fleet_mesh_slice_argv_and_layout(tmp_path):
    """The fleet parent stamps the replica↔device-slice lease without
    touching a device: ``--mesh_slice i%N:N`` in each child argv, as the
    JAX package's; ``fleet.json`` publishes the mapping, key for key."""
    argv = ["--checkpoint_dirs", "m0", "m1", "--mesh", "stocks=-1",
            "--mesh_slices", "2"]
    args = build_arg_parser().parse_args(argv)
    jargs = jserver.build_arg_parser().parse_args(argv)
    for rid, want in ((0, "0:2"), (1, "1:2"), (2, "0:2")):
        ours = server_child_argv(args, rid, tmp_path / f"r{rid}", 8000)
        theirs = jfleet.server_child_argv(jargs, rid, tmp_path / f"r{rid}",
                                          8000)
        for a in (ours, theirs):
            assert a[a.index("--mesh") + 1] == "stocks=-1"
            assert a[a.index("--mesh_slice") + 1] == want
        child = build_arg_parser().parse_args(ours[3:])
        assert (child.mesh, child.mesh_slice) == ("stocks=-1", want)
    bare = build_arg_parser().parse_args(["--checkpoint_dirs", "m0"])
    a = server_child_argv(bare, 0, tmp_path / "r", 8000)
    assert "--mesh" not in a and "--mesh_slice" not in a

    class _FakeFleet:
        replicas = 2

        def __init__(self, run_dir):
            self.run_dir = run_dir

        @staticmethod
        def live_ids():
            return [0, 1]

    layouts = []
    for ctl_cls, sub in ((FleetController, "port"),
                         (jautoscale.FleetController, "jax")):
        d = tmp_path / sub
        d.mkdir()
        ctl_cls(_FakeFleet(d), make_argv=lambda r, a: [], host="127.0.0.1",
                port=8000, admin_ports={0: 9000, 1: 9001},
                mesh="stocks=-1", mesh_slices=2).publish_layout()
        layouts.append(read_fleet_json(d))
    assert layouts[0] == layouts[1] == jfleet.read_fleet_json(tmp_path / "jax")
    assert layouts[0]["mesh"] == "stocks=-1"
    assert layouts[0]["mesh_slices"] == 2
    assert layouts[0]["mesh_slice_by_replica"] == {"0": "0:2", "1": "1:2"}


def test_server_mesh_slice_resolves_disjoint_positions(dirs, splits, tmp_path,
                                                        capsys):
    """``--mesh stocks=-1 --mesh_slice i:2`` lays replica i's mesh over
    slice i of the local devices: disjoint across replicas (a host of eight
    cards, as ``partition.slice_devices`` cuts it; the same cut JAX makes
    of its eight devices). On the one-device CPU a second slice does not
    fit, and the server refuses to start rather than serve a narrower
    mesh."""
    cards = [torch.device("cuda", i) for i in range(8)]
    meshes = [partition.MeshConfig(
        (("stocks", -1),), partition.slice_devices(i, 2, devices=cards))
        .build() for i in (0, 1)]
    assert [m.shape for m in meshes] == [{"stocks": 4}] * 2
    assert not set(meshes[0].devices.flat) & set(meshes[1].devices.flat)
    jdevs = jax.devices()
    assert [[jdevs.index(d) for d in jpartition.slice_devices(
        i, 2, devices=jdevs)] for i in (0, 1)] == [
        [cards.index(d) for d in m.devices.flat] for m in meshes]
    cfg = mesh_config("stocks=-1", "0:1", "cpu")
    assert cfg.build().shape == {"stocks": 1}
    with pytest.raises(ValueError, match="2 slices of width 0 exceed 1"):
        mesh_config("stocks=-1", "1:2", "cpu")
    with pytest.raises(ValueError, match="I:N"):
        mesh_config("stocks=-1", "1", "cpu")
    _, _, test = splits
    np.save(tmp_path / "macro.npy", test.macro)
    rc = serve_main(["--checkpoint_dirs", *dirs, "--macro_npy",
                     str(tmp_path / "macro.npy"), "--device", "cpu",
                     "--mesh", "stocks=2", "--no_warmup"])
    assert rc == 2
    assert "needs 2 devices, have 1" in capsys.readouterr().err
