"""The port's multi-process training on the CPU: ``parallel/multihost.py``
and ``parallel/multihost_worker.py`` against the JAX package's.

* ``initialize_distributed`` joins nothing without an environment and is
  idempotent inside a group;
* ``create_hybrid_mesh`` lays out JAX's grids: one granule (stand-in ranks
  against JAX's own function on its 8-device CPU mesh, by device id), two
  granules granule-major (against JAX's function on stand-in devices with
  a ``process_index``), and the "member groups" error;
* the worker CLI spawned as gloo ranks on TCP: 2 ranks (mesh [2, 1]) agree,
  each member's loss bit for bit the one-process step; 4 ranks on 2
  granules (mesh [2, 2], ``GROUP_RANK`` faked) agree, within rtol 2e-4 of
  [2, 1] (only the stock sums' order differs);
* the worker's step against JAX's ``make_train_step`` on the bridged
  parameters, at the worker's shapes: loss rtol 2e-4, parameters atol 2e-5
  (``tests/test_parity.py:89-102``).

The rank processes import no JAX.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deeplearninginassetpricing_paperreplication_torch.parallel import (
    multihost,
)
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    multihost_worker as W,
)
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    partition,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (  # noqa: E501
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import GAN as JGAN
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    multihost as jmh,
)
from deeplearninginassetpricing_paperreplication_tpu.training import (
    steps as jsteps,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
N_STOCKS = 16  # the panel of both worlds: [2, 1] × 16, [2, 2] × 8 a rank
TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
            "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK")


# -- initialize_distributed ----------------------------------------------------


def test_initialize_distributed_without_an_environment(monkeypatch):
    for k in TORCHRUN:
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert multihost.initialize_distributed() is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        multihost.initialize_distributed("127.0.0.1:1", num_processes=2)


def test_initialize_distributed_is_idempotent_in_a_group(tmp_path):
    """Inside a group (a world of one over a FileStore) it returns True at
    once, with or without arguments, and joins nothing more; the summary
    has JAX's keys and this world's counts."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert multihost.initialize_distributed() is True
        assert multihost.initialize_distributed(
            "127.0.0.1:1", num_processes=4, process_id=3) is True
        assert dist.get_world_size() == 1
        s = multihost.process_local_summary("cpu")
        assert set(s) == set(jmh.process_local_summary())
        assert s == {"process_index": 0, "process_count": 1,
                     "local_devices": 1, "global_devices": 1,
                     "platform": "cpu"}
        assert multihost.rank_granules() == [0]
    finally:
        dist.destroy_process_group()


def test_process_local_summary_has_the_jax_keys():
    s = multihost.process_local_summary("cpu")
    assert set(s) == set(jmh.process_local_summary())
    assert (s["process_count"], s["global_devices"], s["platform"]) == (
        1, 1, "cpu")


# -- create_hybrid_mesh --------------------------------------------------------


@pytest.mark.parametrize("members", [None, 1, 2, 4, 8])
def test_hybrid_mesh_one_granule_is_jaxs_grid(members):
    """Eight stand-in ranks in one granule give the grid JAX's function
    gives on its 8-device CPU mesh, by device id."""
    jm = jmh.create_hybrid_mesh(members_per_host_group=members)
    pm = multihost.create_hybrid_mesh(members_per_host_group=members,
                                      devices=range(8))
    assert pm.shape == dict(jm.shape)
    assert pm.axis_names == tuple(jm.axis_names)
    assert pm.devices.tolist() == [[d.id for d in row]
                                   for row in jm.devices]


def test_hybrid_mesh_member_groups_error():
    with pytest.raises(ValueError, match="member groups"):
        jmh.create_hybrid_mesh(members_per_host_group=3)
    with pytest.raises(ValueError, match="member groups"):
        multihost.create_hybrid_mesh(members_per_host_group=3,
                                     devices=range(8))
    with pytest.raises(ValueError, match="member groups"):
        multihost.create_hybrid_mesh(members_per_host_group=3,
                                     devices=range(8),
                                     granules=[0] * 4 + [1] * 4)


class _Dev:
    """A stand-in device of JAX's layout rules: an id and an owning
    process (no slice index)."""

    def __init__(self, i, process):
        self.id, self.process_index = i, process


@pytest.mark.parametrize("granules", [[0] * 4 + [1] * 4, [0, 1] * 4,
                                      [1, 0, 0, 1, 1, 0, 1, 0]],
                         ids=["blocks", "interleaved", "mixed"])
@pytest.mark.parametrize("members", [None, 4, 1])
def test_hybrid_mesh_two_granules_is_granule_major(granules, members):
    """Two granules of four ranks: JAX's process-granule layout
    (``multihost.py:127-142``), granule-major, on stand-in devices; with
    one row per granule each row lies within its granule."""
    fakes = [_Dev(i, g) for i, g in enumerate(granules)]
    jm = jmh.create_hybrid_mesh(members_per_host_group=members,
                                devices=fakes)
    pm = multihost.create_hybrid_mesh(members_per_host_group=members,
                                      devices=range(8), granules=granules)
    assert pm.shape == dict(jm.shape)
    assert pm.devices.tolist() == [[d.id for d in row]
                                   for row in jm.devices]
    if members is None:
        assert pm.shape == {"batch": 2, "stocks": 4}
        for g, row in enumerate(pm.devices.tolist()):
            assert {granules[r] for r in row} == {g}


# -- the worker ------------------------------------------------------------------


def _world(n, per, tmp, granules=None):
    run_dir = tmp / f"world{n}"
    results, wall = W.spawn_world(
        lambda r, c: W.worker_command(
            r, c, n, "--device", "cpu", "--n_stocks_per_device", str(per),
            "--run_dir", str(run_dir), "--run_id", f"w{n}"),
        n, granules=granules, timeout=180)
    return results, run_dir


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worker CLI as 2 gloo ranks (mesh [2, 1]) and as 4 ranks on two
    granules (mesh [2, 2]), each over the same 16-stock panel."""
    tmp = tmp_path_factory.mktemp("multihost")
    return {"2x1": _world(2, N_STOCKS, tmp),
            "2x2": _world(4, N_STOCKS // 2, tmp, granules=[0, 0, 1, 1])}


def _torch_batch(N):
    host = W.worker_panel(W.JAX_T, N, W.JAX_M, W.JAX_F)
    return {k: torch.from_numpy(v) for k, v in host.items()}


def test_two_ranks_agree_and_are_the_one_process_step(worlds):
    results, _ = worlds["2x1"]
    for r, o in enumerate(results):
        assert o["summary"] == {"process_index": r, "process_count": 2,
                                "local_devices": 1, "global_devices": 2,
                                "platform": "cpu"}
        assert o["mesh_shape"] == [2, 1]
        assert o["axis_names"] == ["batch", "stocks"]
        assert o["n_global_devices"] == 2
    assert results[0]["losses"] == results[1]["losses"]
    cfg, batch = W.jax_config(), _torch_batch(N_STOCKS)
    for g, loss in enumerate(results[0]["losses"]):
        m, _ = W.member_step(cfg, W.member_state_dict(cfg, g), batch,
                             CPU_F32)
        assert float(m["loss"]) == loss, g  # bit for bit
    assert results[0]["losses"][0] != results[0]["losses"][1]


def test_four_ranks_on_two_granules_agree_within_the_loss_bar(worlds):
    results, _ = worlds["2x2"]
    for r, o in enumerate(results):
        assert o["summary"]["process_index"] == r
        assert o["summary"]["process_count"] == 4
        assert o["mesh_shape"] == [2, 2]
    assert all(o["losses"] == results[0]["losses"] for o in results)
    np.testing.assert_allclose(results[0]["losses"],
                               worlds["2x1"][0][0]["losses"], rtol=2e-4)


@pytest.mark.parametrize("world", ["2x1", "2x2"])
def test_every_rank_writes_its_telemetry(worlds, world):
    """Each rank its events stream and heartbeat, rank 0 the manifest with
    the mesh: each rank's granule and position."""
    results, run_dir = worlds[world]
    n = len(results)
    for r in range(n):
        ev = run_dir / ("events.jsonl" if r == 0 else f"events.proc{r}.jsonl")
        rows = [json.loads(x) for x in ev.read_text().splitlines()]
        assert {x.get("run_id") for x in rows} == {f"w{n}"}
        names = {x["name"] for x in rows if x["kind"] == "span_end"}
        assert {"multihost/mesh_build", "multihost/train_step"} <= names
        hb = json.loads((run_dir / f"heartbeat.proc{r}.json").read_text())
        assert hb["heartbeat"]["section"] == "done"
    mesh = json.loads((run_dir / "manifest.json").read_text())[
        "devices"]["mesh"]
    assert mesh["shape"] == results[0]["mesh_shape"]
    assert mesh["backend"] == "gloo"
    granules = [x["granule"] for x in mesh["ranks"]]
    assert granules == ([0, 1] if n == 2 else [0, 0, 1, 1])


def test_the_worker_refuses_cuda_without_a_card(tmp_path):
    """--device cuda on a host without a card exits 2 naming CUDA, before
    it joins anything."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    import subprocess

    proc = subprocess.run(W.worker_command(0, "127.0.0.1:1", 1),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "CUDA" in proc.stderr


def test_worker_panel_is_the_jax_workers():
    """The panel's draws, in the JAX worker's order (seed 0)."""
    T, N, M, F = W.JAX_T, 16, W.JAX_M, W.JAX_F
    p = W.worker_panel(T, N, M, F)
    rng = np.random.default_rng(0)
    mask = (rng.random((T, N)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    assert np.array_equal(p["mask"], mask)
    assert np.array_equal(p["macro"],
                          rng.standard_normal((T, M)).astype(np.float32))
    assert p["individual"].shape == (T, N, F)
    assert p["returns"].shape == (T, N) and p["returns"].dtype == np.float32


# -- the step against JAX ------------------------------------------------------


def test_the_workers_step_is_jaxs_make_train_step():
    """JAX's ``make_train_step(gan, "conditional", make_optimizer(1e-3))``
    at the worker's shapes against the port's step on the bridged
    parameters."""
    T, N = W.JAX_T, N_STOCKS
    jcfg = JGANConfig(macro_feature_dim=W.JAX_M,
                      individual_feature_dim=W.JAX_F, hidden_dim=(4,),
                      num_units_rnn=(2,), dropout=0.0)
    jgan = JGAN(jcfg)
    params = jgan.init(jax.random.key(7), T=T, N=N)
    host = W.worker_panel(T, N, W.JAX_M, W.JAX_F)
    tx = jsteps.make_optimizer(W.LR)
    step = jax.jit(jsteps.make_train_step(jgan, "conditional", tx))
    new_params, _, jm = step(params, tx.init(params["sdf_net"]),
                             {k: jnp.asarray(v) for k, v in host.items()},
                             None)
    cfg = W.jax_config()
    sd = state_dict_from_jax_params(jax.device_get(params), cfg)
    m, gan = W.member_step(cfg, sd, _torch_batch(N), CPU_F32)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    ref = state_dict_from_jax_params(jax.device_get(new_params), cfg)
    moved = 0
    for k, v in gan.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=2e-5,
                                   err_msg=k)
        moved += int(not torch.equal(v, sd[k]))
    assert moved > 0  # the step moved the SDF net


def test_a_one_rank_world_is_the_plain_step():
    """Without a group (world size 1) ``run_rank`` is a 1 × 1 mesh with no
    collective: member 0's step on the whole panel."""
    out = W.run_rank(W.jax_config(), W.JAX_T, N_STOCKS, "cpu")
    assert out["mesh_shape"] == [1, 1] and out["n_global_devices"] == 1
    cfg = W.jax_config()
    m, _ = W.member_step(cfg, W.member_state_dict(cfg, 0),
                         _torch_batch(N_STOCKS), CPU_F32)
    assert out["losses"] == [float(m["loss"])]
    assert partition.world_size() == 1
