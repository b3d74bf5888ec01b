"""The port's mesh-packed sweep on the CPU: ``train_bucket(grid_mesh=…)``,
``run_sweep(grid_mesh=…)``, the slice-leasing worker and the sweep CLI's
``--device_slices``/``--slice_width``, against the bars of ``PERF.md`` §2
and the JAX package's mesh-packed ``train_bucket``.

A single-process mesh holds ``torch.device``s; the CPU has one, so the
positions here all name it (``partition.local_devices`` on a host of
cards gives one per card). The bars:

* a grid mesh over D positions is bit for bit the same bucket at
  ``member_chunk = G/D`` on one device (histories, reported Sharpes,
  params, ranking): each position runs that chunk's ``train_members``;
* a one-position mesh (``--device_slices 1``) is bit for bit no mesh;
* mesh-on against mesh-off: bit for bit on this CPU at these shapes (the
  bar is the sweep's rtol 2e-4 / atol 2e-5; bit for bit is what is seen,
  so it is asserted), and both within that bar of the JAX package's
  ``train_bucket(grid_mesh=grid_slice_mesh(0, 2))`` on its 8-device
  virtual CPU mesh, the port started from the JAX init.

Model: hidden (8,), LSTM (4,), K = 8, T = 12, N = 64, F = 6, M = 3,
schedule 4/2/6 (2/1/3 for the worker and CLI), f32.
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch import sweep as cli
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    partition,
)
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    sweep as sw,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.scheduler import (  # noqa: E501
    WorkQueue,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.supervisor import (  # noqa: E501
    RestartPolicy,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (  # noqa: E501
    stacked_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import GAN as JGAN
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    ensemble as jens,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    partition as jpartition,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    sweep as jsw,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    TrainConfig as JTrainConfig,
)

CPU = torch.device("cpu")
CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
LRS = [1e-3, 5e-4]
SEEDS = [42, 7, 11, 22]
SCHEDULE = dict(num_epochs_unc=4, num_epochs_moment=2, num_epochs=6,
                ignore_epoch=0)
SHORT = dict(num_epochs_unc=2, num_epochs_moment=1, num_epochs=3,
             ignore_epoch=0)


def _panel(T=12, N=64, F=6, M=3, seed=2):
    rng = np.random.default_rng(seed)
    mask = (rng.random((T, N)) > 0.3).astype(np.float32)
    return {
        "individual": (rng.standard_normal((T, N, F))
                       * mask[:, :, None]).astype(np.float32),
        "returns": (rng.standard_normal((T, N)) * 0.05
                    * mask).astype(np.float32),
        "mask": mask,
        "macro": rng.standard_normal((T, M)).astype(np.float32),
    }


PANEL = _panel()


def _tb():
    return {k: torch.from_numpy(v) for k, v in PANEL.items()}


def _cfg(dropout=0.1, cls=GANConfig):
    return cls(macro_feature_dim=3, individual_feature_dim=6,
               hidden_dim=(8,), dropout=dropout)


def _grid_mesh(width, n_slices=1, index=0):
    return partition.grid_slice_mesh(index, n_slices, width=width,
                                     devices=[CPU] * (width * n_slices))


def _same_bucket(a, b):
    np.testing.assert_array_equal(a["best_valid_sharpe"],
                                  b["best_valid_sharpe"])
    assert list(a["params"]) == list(b["params"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for k in a["history"]:
        np.testing.assert_array_equal(a["history"][k], b["history"][k],
                                      err_msg=k)


def _ranking(ranked):
    return [(r["lr"], r["seed"], r["valid_sharpe"]) for r in ranked]


# -- the single-process mesh ---------------------------------------------------


def test_local_devices_and_mesh_positions():
    assert partition.local_devices("cpu") == (CPU,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            partition.local_devices("cuda")
    mesh = _grid_mesh(4)
    assert mesh.shape == {"grid": 4}
    pos = mesh.positions()
    assert [c for c, _ in pos] == [{"grid": i} for i in range(4)]
    assert [partition.position_device(d) for _, d in pos] == [CPU] * 4
    assert sw.mesh_positions(mesh) == [CPU] * 4
    # the rank meshes' lookup stays strict: one device at four positions
    with pytest.raises(ValueError, match="not \\(once\\) in the mesh"):
        mesh.position(CPU)
    with pytest.raises(TypeError, match="rank mesh"):
        partition.position_device(3)
    # a spec the host cannot hold names both counts; never a narrower mesh
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        partition.parse_mesh_spec(
            "grid=2", partition.local_devices("cpu")).build()
    with pytest.raises(ValueError, match="2 slices of width 1 exceed 1"):
        partition.grid_slice_mesh(0, 2, width=1,
                                  devices=partition.local_devices("cpu"))
    with pytest.raises(ValueError, match="one axis 'grid'"):
        sw.mesh_positions(partition.MeshConfig(
            (("stocks", 2),), (CPU, CPU)).build())


# -- the bars -------------------------------------------------------------------


def test_grid_mesh_is_member_chunk_bit_for_bit():
    """Grid width 8 over 4 positions, dropout 0.1: each position's two rows
    are the ``member_chunk=2`` run's, bit for bit, and so is the ranking;
    mesh-on is also bit for bit mesh-off here."""
    tb = _tb()
    tcfg = TrainConfig(**SCHEDULE)
    mesh = _grid_mesh(4)
    on = sw.train_bucket(_cfg(), LRS, SEEDS, tb, tb, tcfg, exec_cfg=CPU_F32,
                         grid_mesh=mesh)
    chunked = sw.train_bucket(_cfg(), LRS, SEEDS, tb, tb, tcfg,
                              exec_cfg=CPU_F32, member_chunk=2)
    off = sw.train_bucket(_cfg(), LRS, SEEDS, tb, tb, tcfg, exec_cfg=CPU_F32)
    assert on["placement"] == {
        "positions": 4, "span": 2, "fallback": False,
        "devices": ["cpu"] * 4, "launches": [dict.fromkeys(
            ("sdf_ffn_fwd", "sdf_ffn_bwd", "sdf_ffn_dx", "cond_em_fwd",
             "cond_em_bwd", "cond_em_dx"), 0)] * 4}
    np.testing.assert_array_equal(on["grid"], off["grid"])
    _same_bucket(on, chunked)
    _same_bucket(on, off)
    configs = sw.grid_configs(_cfg(), hidden_dims=((8,), (6,)),
                              rnn_units=((4,),), num_moments=(8,),
                              dropouts=(0.1,), lrs=LRS)
    kw = dict(tcfg=TrainConfig(**SHORT), top_k=None, verbose=False,
              exec_cfg=CPU_F32)
    ranked = sw.run_sweep(configs, SEEDS, tb, tb, grid_mesh=mesh, **kw)
    assert _ranking(ranked) == _ranking(
        sw.run_sweep(configs, SEEDS, tb, tb, member_chunk=2, **kw))


def test_one_position_mesh_and_ragged_grid_fall_back_bit_for_bit():
    """A one-position mesh is placement only; a grid the mesh does not
    divide (6 points over 4) trains whole on the first position, and the
    stats name its bucket."""
    tb = _tb()
    tcfg = TrainConfig(**SHORT)
    off = sw.train_bucket(_cfg(), LRS, SEEDS[:3], tb, tb, tcfg,
                          exec_cfg=CPU_F32)
    one = sw.train_bucket(_cfg(), LRS, SEEDS[:3], tb, tb, tcfg,
                          exec_cfg=CPU_F32, grid_mesh=_grid_mesh(1))
    ragged = sw.train_bucket(_cfg(), LRS, SEEDS[:3], tb, tb, tcfg,
                             exec_cfg=CPU_F32, grid_mesh=_grid_mesh(4))
    assert one["placement"]["span"] == 6
    assert ragged["placement"]["fallback"] is True
    assert ragged["placement"]["span"] is None
    assert ragged["placement"]["devices"] == ["cpu"]
    _same_bucket(one, off)
    _same_bucket(ragged, off)
    stats = {}
    sw.run_sweep([(_cfg(), lr) for lr in LRS], SEEDS[:3], tb, tb, tcfg=tcfg,
                 top_k=None, verbose=False, exec_cfg=CPU_F32,
                 grid_mesh=_grid_mesh(4), stats_out=stats)
    assert stats["grid_mesh"]["fallback_buckets"] == [1]
    assert stats["grid_mesh"]["bucket_placement"][0]["fallback"] is True


@pytest.fixture(scope="module")
def jax_mesh_sweep():
    """The JAX package's mesh-packed search of one bucket (grid width 8
    over a 4-device slice of its 8-device mesh), dropout 0: its ranking
    with params, and its stats."""
    jb = {k: jnp.asarray(v) for k, v in PANEL.items()}
    jstats = {}
    jranked = jsw.run_sweep(
        [(_cfg(0.0, JGANConfig), lr) for lr in LRS], SEEDS, jb, jb,
        tcfg=JTrainConfig(**SCHEDULE), top_k=None, keep_params=True,
        verbose=False, stats_out=jstats,
        grid_mesh=jpartition.grid_slice_mesh(0, 2))
    return jranked, jstats


def _jax_init(cfg, seeds):
    jgan = JGAN(JGANConfig(**dataclasses.asdict(cfg)))
    return stacked_state_dict_from_jax_params(
        jax.device_get(jens.init_ensemble_params(jgan, seeds)), cfg)


def test_grid_mesh_stats_keys_are_the_jax_sweeps(jax_mesh_sweep):
    """``stats_out["grid_mesh"]`` carries the JAX keys with the same axes."""
    _, jstats = jax_mesh_sweep
    stats = {}
    tb = _tb()
    sw.run_sweep([(_cfg(0.0), 1e-3)], [42, 7, 11, 22], tb, tb,
                 tcfg=TrainConfig(1, 0, 1, ignore_epoch=0), top_k=None,
                 verbose=False, exec_cfg=CPU_F32, stats_out=stats,
                 grid_mesh=_grid_mesh(4))
    assert set(jstats["grid_mesh"]) <= set(stats["grid_mesh"])
    assert stats["grid_mesh"]["axes"] == jstats["grid_mesh"]["axes"] \
        == {"grid": 4}
    assert stats["grid_mesh"]["devices"] == ["cpu"] * 4
    assert len(jstats["grid_mesh"]["devices"]) == 4


def test_mesh_on_and_off_against_the_jax_mesh_packed_bucket(jax_mesh_sweep):
    """Dropout 0, the JAX init: the port's bucket over 4 positions and
    without a mesh, against the JAX bucket over a 4-device slice (grid
    width 8), by the sweep bars."""
    jranked, _ = jax_mesh_sweep
    tb = _tb()
    kw = dict(exec_cfg=CPU_F32, init=_jax_init)
    on = sw.train_bucket(_cfg(0.0), LRS, SEEDS, tb, tb,
                         TrainConfig(**SCHEDULE), grid_mesh=_grid_mesh(4),
                         **kw)
    off = sw.train_bucket(_cfg(0.0), LRS, SEEDS, tb, tb,
                          TrainConfig(**SCHEDULE), **kw)
    _same_bucket(on, off)
    want = {(r["lr"], r["seed"]): r for r in jranked}
    assert len(want) == len(on["grid"]) == len(LRS) * len(SEEDS)
    for g, (lr, seed) in enumerate(on["grid"]):
        ref = want[(float(lr), int(seed))]
        assert np.isfinite(ref["valid_sharpe"])
        np.testing.assert_allclose(on["best_valid_sharpe"][g],
                                   ref["valid_sharpe"], rtol=2e-4,
                                   atol=1e-5)
        sd = state_dict_from_jax_params(
            jax.tree.map(np.asarray, ref["params"]), _cfg(0.0))
        for k, v in sd.items():
            np.testing.assert_allclose(on["params"][k][g].numpy(),
                                       v.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=f"{g} {k}")


# -- the slice-leasing worker ----------------------------------------------------


def test_slice_leasing_worker_drains_the_queue(tmp_path):
    """Two device slices of two positions: a bucket held by a live foreign
    lease makes the worker wait, and while it waits its slice is taken
    over; it leases the other slice, takes the expired bucket over, drains,
    and releases that slice. The ledger's ranking is byte for byte the
    in-process mesh-packed run's."""
    configs = sw.grid_configs(_cfg(), hidden_dims=((8,), (6,)),
                              rnn_units=((4,),), num_moments=(8,),
                              dropouts=(0.1,), lrs=LRS)
    tcfg = TrainConfig(**SHORT)
    q = WorkQueue(tmp_path / "ledger", lease_timeout_s=3.0,
                  backoff=RestartPolicy(backoff_base_s=0.0,
                                        backoff_max_s=0.0, jitter_frac=0.0))
    items = sw.bucket_work_items(configs, SEEDS, tcfg)
    q.write_manifest(items, {"tcfg": dataclasses.asdict(tcfg),
                             "seeds": SEEDS, "device_slices": 2,
                             "slice_width": 2})
    status, held = q.claim("wX")  # a live foreign lease on bucket 1
    assert status == "claimed" and held["index"] == 0
    real_renew = q.renew_device_slice
    stolen = []

    def steal_then_renew(index, worker):
        # the worker's own renewal while it waits: another worker took
        # its slice just before (the lease keeper's renewals pass through)
        if threading.current_thread() is threading.main_thread() \
                and not stolen:
            stolen.append(index)
            q.slice_path(index).write_text(json.dumps(
                {"worker": "thief", "ts": time.time()}))
        return real_renew(index, worker)

    q.renew_device_slice = steal_then_renew
    tb = _tb()
    trained = sw.run_sweep_worker(q, "w0", tb, tb, exec_cfg=CPU_F32,
                                  verbose=False, poll_s=0.05,
                                  devices=[CPU] * 4)
    assert trained == 2 and stolen == [0]
    ranked, coverage = sw.ranking_from_ledger(q)
    assert coverage["complete"]
    # released at drain; the stolen slice stays the thief's
    assert not q.slice_path(1).exists()
    assert json.loads(q.slice_path(0).read_text())["worker"] == "thief"
    ref = sw.run_sweep(configs, SEEDS, tb, tb, tcfg=tcfg, top_k=None,
                       verbose=False, exec_cfg=CPU_F32,
                       grid_mesh=_grid_mesh(2))
    assert _ranking(ranked) == _ranking(ref)


def test_worker_waits_while_every_slice_is_held(tmp_path, monkeypatch):
    """Every slice held by a live worker: the worker polls and trains
    nothing until one frees."""
    q = WorkQueue(tmp_path / "ledger", lease_timeout_s=30.0)
    q.write_manifest(sw.bucket_work_items(
        [(_cfg(), 1e-3)], SEEDS[:2], TrainConfig(**SHORT)),
        {"tcfg": dataclasses.asdict(TrainConfig(**SHORT)),
         "seeds": SEEDS[:2], "device_slices": 1})
    assert q.claim_device_slice("other", 1) == 0
    naps = []

    def nap(s):
        naps.append(s)
        if len(naps) == 3:
            q.release_device_slice(0, "other")

    monkeypatch.setattr(sw.time, "sleep", nap)
    tb = _tb()
    assert sw.run_sweep_worker(q, "w0", tb, tb, exec_cfg=CPU_F32,
                               verbose=False, poll_s=0.01) == 1
    assert naps[:3] == [0.01] * 3
    assert not q.slice_path(0).exists()


# -- the CLI ------------------------------------------------------------------------


def test_cli_device_slices_preflight_and_hot_spare_warning(
        synthetic_dir, tmp_path, capsys, monkeypatch):
    common = ["--data_dir", str(synthetic_dir), "--quick", "--device", "cpu",
              "--compute_dtype", "float32", "--search_only"]
    with pytest.raises(SystemExit) as e:
        cli.main(common + ["--save_dir", str(tmp_path / "a"),
                           "--device_slices", "2"])
    assert str(e.value) == (
        "--device_slices 2 does not fit the local devices: 2 slices of "
        "width 0 exceed 1 devices")
    with pytest.raises(SystemExit, match="--slice_width 2 does not fit"):
        cli.main(common + ["--save_dir", str(tmp_path / "b"),
                           "--device_slices", "1", "--slice_width", "2"])

    class Stop(Exception):
        pass

    def stop(*_a, **_k):
        raise Stop

    monkeypatch.setattr(cli, "_prepare_queue", stop)
    capsys.readouterr()
    with pytest.raises(Stop):
        cli.main(common + ["--save_dir", str(tmp_path / "c"),
                           "--device_slices", "1", "--workers", "2"])
    assert ("--workers 2 > --device_slices 1: 1 worker(s) will idle as "
            "hot spares until a slice frees") in capsys.readouterr().err


def test_cli_one_slice_is_bit_for_bit_no_mesh(synthetic_dir, tmp_path):
    """``--device_slices 1`` in process: the manifest carries the slices,
    and the ranking file is byte for byte the run's without a mesh."""
    common = ["--data_dir", str(synthetic_dir), "--quick", "--device", "cpu",
              "--compute_dtype", "float32", "--search_only"]
    cli.main(common + ["--save_dir", str(tmp_path / "off")])
    cli.main(common + ["--save_dir", str(tmp_path / "on"),
                       "--device_slices", "1"])
    meta = json.loads((tmp_path / "on" / "sweep_ledger" /
                       "queue.json").read_text())
    assert meta["device_slices"] == 1 and meta["slice_width"] is None
    assert ((tmp_path / "on" / "sweep_ranking.json").read_bytes()
            == (tmp_path / "off" / "sweep_ranking.json").read_bytes())
