"""The PyTorch port's hyperparameter sweep and protocol CLI against the JAX
package's, on the CPU.

* bucketing: ``grid_configs``, ``bucketize`` and ``bucket_work_items``
  equal the JAX package's (order, lr lists, ``bucket_key`` strings) for
  the paper's 384-point grid and the ``--quick`` grid;
* ``run_sweep`` against the JAX ``run_sweep``: two buckets × two lrs × two
  seeds, dropout 0, the port started from the JAX init through the
  ``init`` hook, at the ensemble test's bars
  (``tests/test_torch_ensemble.py``): each grid point's reported valid
  Sharpe rtol 2e-4, atol 1e-5, the winner's params rtol 2e-4, atol 2e-5,
  and the ranking order wherever adjacent Sharpes differ by > 1e-4;
* the per-member learning rate: uniform lrs give the scalar route's bits,
  a two-lr bucket is two one-lr buckets (rtol 2e-4, dropout on), and grid
  point (lr, s) draws its dropout from ``s * 7919 + 13``;
* the reported-Sharpe chain (phase-3 best → phase-1 best → -inf), the
  ranking's null round trip and its corruption error, ledger resume;
* ``select_winners`` and ``run_protocol`` (mirroring
  ``tests/test_protocol.py``), the CLI, and the refusal without a card.

Model: hidden (8, 8) and (6,), LSTM (4,), K = 4, schedule 8/4/16, ignore
2, f32.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch import sweep as cli
from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble import (
    evaluate_ensemble,
    stack_checkpoints,
)
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    ensemble as ens_mod,
)
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    sweep as sw,
)
from deeplearninginassetpricing_paperreplication_torch.reliability import (
    verified,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.ledger import (
    SweepLedger,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    stacked_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.training.steps import (
    MemberOptimizer,
    Optimizer,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
)
from deeplearninginassetpricing_paperreplication_tpu import sweep as jcli
from deeplearninginassetpricing_paperreplication_tpu.models.gan import GAN as JGAN
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    ensemble as jens,
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

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
SCHEDULE = dict(num_epochs_unc=8, num_epochs_moment=4, num_epochs=16,
                ignore_epoch=2)
SEEDS = [11, 22]
LRS = (1e-3, 5e-3)
GRID_KW = dict(hidden_dims=((8, 8), (6,)), rnn_units=((4,),),
               num_moments=(4,), dropouts=(0.0,), lrs=LRS)


def _tbatch(ds):
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in ds.full_batch().items()}


def _jbatch(ds):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in ds.full_batch().items()}


def _base(ds, cls=GANConfig):
    return cls(macro_feature_dim=ds.macro_feature_dim,
               individual_feature_dim=ds.individual_feature_dim)


def _jax_init(cfg, seeds):
    """The JAX sweep's start for a grid (``init_ensemble_params`` of the
    grid's seeds), bridged into the port's member-stacked state dict."""
    jgan = JGAN(JGANConfig(**dataclasses.asdict(cfg)))
    return stacked_state_dict_from_jax_params(
        jax.device_get(jens.init_ensemble_params(jgan, seeds)), cfg)


def _key(entry):
    return (sw.architecture_signature(entry["config"]), entry["lr"],
            entry["seed"])


# -- bucketing ----------------------------------------------------------------


@pytest.mark.parametrize("grid,n_buckets", [("paper", 96), ("quick", 2)])
def test_bucketing_and_keys_equal_the_jax_package(splits, grid, n_buckets):
    kw = {} if grid == "paper" else cli.QUICK_GRID_KW
    assert kw == ({} if grid == "paper" else jcli.QUICK_GRID_KW)
    ours = sw.grid_configs(_base(splits[0]), **kw)
    theirs = jsw.grid_configs(_base(splits[0], JGANConfig), **kw)
    assert len(ours) == len(theirs) == (384 if grid == "paper" else 4)
    assert [(c.to_dict(), lr) for c, lr in ours] == [
        (c.to_dict(), lr) for c, lr in theirs]
    b_ours, b_theirs = sw.bucketize(ours), jsw.bucketize(theirs)
    assert len(b_ours) == len(b_theirs) == n_buckets
    assert list(b_ours) == list(b_theirs)  # signatures, in order
    for a, b in zip(b_ours.values(), b_theirs.values()):
        assert a["lrs"] == b["lrs"] and a["cfg"].to_dict() == b["cfg"].to_dict()
    sched = (cli.QUICK_SEARCH_SCHEDULE if grid == "quick"
             else dict(num_epochs_unc=64, num_epochs_moment=16,
                       num_epochs=256, ignore_epoch=16))
    items = sw.bucket_work_items(ours, [42], TrainConfig(**sched, seed=42))
    assert items == jsw.bucket_work_items(
        theirs, [42], JTrainConfig(**sched, seed=42))
    assert len({it["key"] for it in items}) == n_buckets


# -- run_sweep against the JAX run_sweep ----------------------------------------


@pytest.fixture(scope="module")
def sweeps(splits):
    """Both packages' run_sweep over the same grid from the same start."""
    train, valid, _ = splits
    jranked = jsw.run_sweep(
        jsw.grid_configs(_base(train, JGANConfig), **GRID_KW), SEEDS,
        _jbatch(train), _jbatch(valid), tcfg=JTrainConfig(**SCHEDULE),
        top_k=None, keep_params=True, verbose=False)
    stats = {}
    ranked = sw.run_sweep(
        sw.grid_configs(_base(train), **GRID_KW), SEEDS, _tbatch(train),
        _tbatch(valid), tcfg=TrainConfig(**SCHEDULE), top_k=None,
        keep_params=True, verbose=False, exec_cfg=CPU_F32, stats_out=stats,
        init=_jax_init)
    return ranked, jranked, stats


def test_run_sweep_matches_jax_per_grid_point(sweeps):
    ranked, jranked, stats = sweeps
    assert stats["n_buckets"] == 2 and len(stats["bucket_seconds"]) == 2
    assert len(ranked) == len(jranked) == 2 * len(LRS) * len(SEEDS)
    want = {_key(r): r["valid_sharpe"] for r in jranked}
    got = {_key(r): r["valid_sharpe"] for r in ranked}
    assert set(got) == set(want)
    keys = sorted(want, key=str)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=2e-4, atol=1e-5)
    assert all(np.isfinite(v) for v in got.values())


def test_run_sweep_ranking_and_winner_params_match_jax(sweeps):
    ranked, jranked, _ = sweeps
    order, jorder = [_key(r) for r in ranked], [_key(r) for r in jranked]
    sharpes = [r["valid_sharpe"] for r in jranked]
    # the order is pinned wherever the JAX ranking separates neighbours
    for i in range(len(jorder)):
        lo = i == 0 or sharpes[i - 1] - sharpes[i] > 1e-4
        hi = i == len(jorder) - 1 or sharpes[i] - sharpes[i + 1] > 1e-4
        if lo and hi:
            assert order[i] == jorder[i], i
    assert order[0] == jorder[0]
    cfg = ranked[0]["config"]
    ref = state_dict_from_jax_params(
        jax.tree.map(np.asarray, jranked[0]["params"]), cfg)
    assert list(ranked[0]["params"]) == list(ref)
    for k in ref:
        np.testing.assert_allclose(ranked[0]["params"][k].numpy(),
                                   ref[k].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


# -- the per-member learning rate ------------------------------------------------


@pytest.mark.parametrize("lr", [1e-3, 2e-3, 1e-4])
def test_uniform_lrs_are_the_scalar_route_bit_for_bit(lr):
    """The member step at one lr, held as an [S] f32 tensor, gives the bits
    of the same step with the lr as a Python float (``Optimizer``'s one-model
    route, with the member norms)."""

    class ScalarRoute(Optimizer):
        _norms = MemberOptimizer._norms

    rng = np.random.default_rng(3)
    shapes = [(4, 5), (6,), (1,)]
    p0 = [rng.standard_normal((4,) + s).astype(np.float32) for s in shapes]
    scalar, one, per = ([torch.from_numpy(a.copy()) for a in p0]
                        for _ in range(3))
    opts = (ScalarRoute(scalar, lr), MemberOptimizer(one, lr),
            MemberOptimizer(per, [lr] * 4))
    for o in opts[1:]:
        assert o.lr.dtype == torch.float32 and o.lr.shape == (4,)
    for step in range(4):
        gs = [torch.from_numpy(rng.standard_normal((4,) + s).astype(
            np.float32) * (3.0 if step == 0 else 0.3)) for s in shapes]
        norms = [o.step(gs) for o in opts]
        assert all(torch.equal(norms[0], n) for n in norms[1:])
    for ps in (one, per):
        assert all(torch.equal(a, b) for a, b in zip(scalar, ps))
    with pytest.raises(ValueError, match="3 learning rates for 4"):
        MemberOptimizer(per, [lr] * 3)


def test_a_two_lr_bucket_is_two_one_lr_buckets(splits):
    """Dropout 0.1: the grid's points keep their init and dropout seeds
    whatever bucket (or member chunk) they train in."""
    train, valid, _ = splits
    cfg = dataclasses.replace(_base(train), hidden_dim=(8, 8),
                              num_units_rnn=(4,), num_condition_moment=4,
                              dropout=0.1)
    tb, vb = _tbatch(train), _tbatch(valid)
    tcfg = TrainConfig(**SCHEDULE)
    both = sw.train_bucket(cfg, LRS, SEEDS, tb, vb, tcfg, exec_cfg=CPU_F32)
    assert both["grid"].tolist() == [[lr, s] for lr in LRS for s in SEEDS]
    for i, lr in enumerate(LRS):
        one = sw.train_bucket(cfg, [lr], SEEDS, tb, vb, tcfg,
                              exec_cfg=CPU_F32)
        rows = slice(i * len(SEEDS), (i + 1) * len(SEEDS))
        np.testing.assert_allclose(both["best_valid_sharpe"][rows],
                                   one["best_valid_sharpe"], rtol=2e-4,
                                   atol=1e-5)
        for k, v in one["history"].items():
            np.testing.assert_allclose(both["history"][k][rows], v,
                                       rtol=2e-4, atol=1e-5, err_msg=k)
        for k, v in one["params"].items():
            np.testing.assert_allclose(both["params"][k][rows].numpy(),
                                       v.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=k)
    # the lrs differ, so the points do
    assert not np.allclose(both["history"]["train_loss"][0],
                           both["history"]["train_loss"][len(SEEDS)])
    # member_chunk=3 trains the grid's four points as 3 + 1: the same points
    chunked = sw.train_bucket(cfg, LRS, SEEDS, tb, vb, tcfg, member_chunk=3,
                              exec_cfg=CPU_F32)
    np.testing.assert_allclose(chunked["best_valid_sharpe"],
                               both["best_valid_sharpe"], rtol=2e-4,
                               atol=1e-5)
    for k, v in both["params"].items():
        np.testing.assert_allclose(chunked["params"][k].numpy(), v.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def test_grid_point_draws_the_jax_sweeps_dropout_stream(splits,
                                                        monkeypatch):
    train, valid, _ = splits
    drawn = []
    real = ens_mod.phase_epoch_seeds

    def spy(seed, num_epochs):
        drawn.append(seed)
        return real(seed, num_epochs)

    monkeypatch.setattr(ens_mod, "phase_epoch_seeds", spy)
    cfg = dataclasses.replace(_base(train), hidden_dim=(6,),
                              num_condition_moment=4)
    sw.train_bucket(cfg, LRS, SEEDS, _tbatch(train), _tbatch(valid),
                    TrainConfig(1, 1, 1, ignore_epoch=0), exec_cfg=CPU_F32)
    assert drawn == [s * 7919 + 13 for _ in LRS for s in SEEDS]
    assert sw.dropout_base_seed(42) == 42 * 7919 + 13


# -- the reported Sharpe, the ranking file, resume ----------------------------------


@pytest.mark.parametrize("case,schedule", [
    ("phase3", dict(num_epochs_unc=4, num_epochs_moment=1, num_epochs=4,
                    ignore_epoch=1)),
    ("phase1", dict(num_epochs_unc=4, num_epochs_moment=1, num_epochs=2,
                    ignore_epoch=2)),
    ("none", dict(num_epochs_unc=2, num_epochs_moment=0, num_epochs=2,
                  ignore_epoch=5)),
])
def test_reported_sharpe_chain(splits, case, schedule):
    """Phase 3's best where its tracker updated, else phase 1's, else
    -inf; phase 2 is skipped at 0 epochs."""
    train, valid, _ = splits
    cfg = dataclasses.replace(_base(train), hidden_dim=(6,),
                              num_condition_moment=4, dropout=0.0)
    tcfg = TrainConfig(**schedule)
    out = sw.train_bucket(cfg, LRS, SEEDS, _tbatch(train), _tbatch(valid),
                          tcfg, exec_cfg=CPU_F32)
    vs = out["history"]["valid_sharpe"]  # [G, E1 + E3]
    e1, ig = tcfg.num_epochs_unc, tcfg.ignore_epoch
    if case == "phase3":
        want = vs[:, e1 + ig + 1:].max(axis=1)
    elif case == "phase1":
        want = vs[:, ig + 1:e1].max(axis=1)
    else:
        want = np.full(len(vs), -np.inf)
    np.testing.assert_array_equal(out["best_valid_sharpe"], want)


def test_never_updated_point_round_trips_the_ranking_file(splits, tmp_path):
    train, valid, _ = splits
    cfg = dataclasses.replace(_base(train), hidden_dim=(6,),
                              num_condition_moment=4)
    ranked = sw.run_sweep(
        [(cfg, 1e-3)], [7], _tbatch(train), _tbatch(valid),
        tcfg=TrainConfig(2, 0, 2, ignore_epoch=5), top_k=None,
        verbose=False, exec_cfg=CPU_F32)
    assert ranked[0]["valid_sharpe"] == float("-inf")
    ranked = ranked + [{"config": cfg, "lr": 5e-4, "seed": 7,
                        "valid_sharpe": 0.5}]
    path = cli.write_ranking(tmp_path, ranked)
    rows = json.loads(path.read_text())
    assert rows[0]["valid_sharpe"] is None and rows[1]["valid_sharpe"] == 0.5
    assert verified.digest_path(path).exists()
    back = cli.load_ranking(path)
    assert back[0]["valid_sharpe"] == float("-inf")
    assert back[1]["config"] == cfg and back[1]["lr"] == 5e-4
    # the JAX package reads the port's ranking file, null included
    jrows = jcli.load_ranking(path)
    assert [r["valid_sharpe"] for r in jrows] == [float("-inf"), 0.5]


def test_corrupt_ranking_raises_naming_the_file(splits, tmp_path):
    cfg = _base(splits[0])
    path = cli.write_ranking(tmp_path, [
        {"config": cfg, "lr": 1e-3, "seed": 7, "valid_sharpe": 0.5}])
    with open(path, "r+b") as f:  # torn write / bit rot
        f.truncate(20)
    with pytest.raises(ValueError, match="sweep_ranking.json"):
        cli.load_ranking(path)


def test_consult_ledger_retrains_nothing(splits, tmp_path, monkeypatch):
    train, valid, _ = splits
    configs = sw.grid_configs(
        dataclasses.replace(_base(train), num_condition_moment=4),
        hidden_dims=((6,), (4, 4)), rnn_units=((4,),), num_moments=(4,),
        dropouts=(0.05,), lrs=LRS)
    tcfg = TrainConfig(2, 1, 3, ignore_epoch=0)
    args = (configs, SEEDS, _tbatch(train), _tbatch(valid))
    ledger = SweepLedger(tmp_path / "sweep_ledger")
    stats = {}
    first = sw.run_sweep(*args, tcfg=tcfg, top_k=None, verbose=False,
                         exec_cfg=CPU_F32, ledger=ledger, stats_out=stats)
    assert stats["ledger_writes"] == 2 and stats["ledger_hits"] == 0
    assert len(list(ledger.records_dir.glob("*.json"))) == 2

    def boom(*a, **kw):
        raise AssertionError("a completed bucket was retrained")

    monkeypatch.setattr(sw, "train_bucket", boom)
    stats = {}
    again = sw.run_sweep(*args, tcfg=tcfg, top_k=None, verbose=False,
                         exec_cfg=CPU_F32,
                         ledger=SweepLedger(tmp_path / "sweep_ledger"),
                         consult_ledger=True, stats_out=stats)
    assert stats == {"n_buckets": 2, "bucket_seconds": [],
                     "ledger_hits": 2, "ledger_writes": 0}
    assert [(_key(r), r["valid_sharpe"]) for r in again] == [
        (_key(r), r["valid_sharpe"]) for r in first]
    with pytest.raises(ValueError, match="keep_params=False"):
        sw.run_sweep(*args, tcfg=tcfg, keep_params=True, verbose=False,
                     exec_cfg=CPU_F32, ledger=ledger, consult_ledger=True)


@pytest.mark.parametrize("change", [dict(compute_dtype="bfloat16"),
                                    dict(kernel="off")])
def test_a_record_of_another_execution_is_retrained(splits, tmp_path,
                                                    monkeypatch, change):
    """The bucket key is the JAX package's and leaves the execution out:
    a resume at another compute dtype or kernel route retrains the bucket
    and replaces its record, which the next resume at that execution
    reuses."""
    train, valid, _ = splits
    configs = sw.grid_configs(
        dataclasses.replace(_base(train), num_condition_moment=4),
        hidden_dims=((6,),), rnn_units=((4,),), num_moments=(4,),
        dropouts=(0.0,), lrs=LRS)
    tcfg = TrainConfig(2, 1, 3, ignore_epoch=0)
    args = (configs, SEEDS, _tbatch(train), _tbatch(valid))
    ledger = SweepLedger(tmp_path / "sweep_ledger")
    sw.run_sweep(*args, tcfg=tcfg, verbose=False, exec_cfg=CPU_F32,
                 ledger=ledger)
    (path,) = ledger.records_dir.glob("*.json")
    assert ledger.load(path.stem)["execution"] == {
        "compute_dtype": "float32", "kernel": "auto"}
    other = dataclasses.replace(CPU_F32, **change)
    trained, real = [], sw.train_bucket
    monkeypatch.setattr(sw, "train_bucket",
                        lambda *a, **kw: trained.append(1) or real(*a, **kw))
    for n_trained, hits in ((1, 0), (1, 1)):
        stats = {}
        sw.run_sweep(*args, tcfg=tcfg, verbose=False, exec_cfg=other,
                     ledger=ledger, consult_ledger=True, stats_out=stats)
        assert (len(trained), stats["ledger_hits"]) == (n_trained, hits)
    assert ledger.load(path.stem)["execution"] == sw.execution_of(other)


# -- select_winners, run_protocol, the CLI ---------------------------------------


def test_select_winners_dedupes_settings(splits):
    cfg = dataclasses.replace(_base(splits[0]), hidden_dim=(8,))
    cfg2 = dataclasses.replace(cfg, hidden_dim=(4, 4))
    ranked = [
        {"config": cfg, "lr": 1e-3, "seed": 1, "valid_sharpe": 3.0},
        {"config": cfg, "lr": 1e-3, "seed": 2, "valid_sharpe": 2.5},  # dup
        {"config": cfg2, "lr": 1e-3, "seed": 1, "valid_sharpe": 2.0},
        {"config": cfg, "lr": 1e-4, "seed": 1, "valid_sharpe": 1.0},
    ]
    winners = cli.select_winners(ranked, top_k=3)
    assert len(winners) == 3
    assert winners[0]["seed"] == 1 and winners[0]["lr"] == 1e-3
    assert winners[1]["config"].hidden_dim == (4, 4)
    assert winners[2]["lr"] == 1e-4


def test_run_protocol_end_to_end(splits, tmp_path):
    """search → winners → member-stacked ensembles → grand ensemble →
    artifacts, with the member run dirs read back by stack_checkpoints and
    the diagnostic retrain's Spearman."""
    train, valid, test = splits
    tb, vb, teb = _tbatch(train), _tbatch(valid), _tbatch(test)
    cfg = dataclasses.replace(_base(train), hidden_dim=(8,),
                              num_units_rnn=(3,), num_condition_moment=4)
    configs = sw.grid_configs(
        cfg, hidden_dims=((8,),), rnn_units=((3,),), num_moments=(4,),
        dropouts=(0.05,), lrs=(1e-3, 1e-2, 5e-3))
    search_tcfg = TrainConfig(num_epochs_unc=2, num_epochs_moment=1,
                              num_epochs=3, ignore_epoch=0, seed=0)
    ens_tcfg = TrainConfig(num_epochs_unc=3, num_epochs_moment=1,
                           num_epochs=4, ignore_epoch=0)
    report = cli.run_protocol(
        configs, tb, vb, teb,
        search_tcfg=search_tcfg, ensemble_tcfg=ens_tcfg,
        search_seeds=[7], ensemble_seeds=[11, 22], top_k=2,
        save_dir=str(tmp_path), verbose=False, exec_cfg=CPU_F32,
        diagnostic_top=3, diagnostic_seeds=[11])
    assert report["n_search_points"] == 3
    assert report["search_stats"]["n_buckets"] == 1
    assert len(report["winners"]) == 2
    assert {"train", "valid", "test"} == set(
        report["winners"][0]["ensemble_sharpe"])
    assert report["n_grand_members"] == 4
    assert np.isfinite(report["grand_ensemble_test_sharpe"])
    diag = report["search_vs_retrain"]
    assert [p["n_seeds"] for p in diag["points"]] == [1, 1, 1]
    assert diag["n_pairs_used"] == 3

    ranking = json.loads((tmp_path / "sweep_ranking.json").read_text())
    assert len(ranking) == 3
    assert ranking[0]["valid_sharpe"] >= ranking[1]["valid_sharpe"]
    for name in ("sweep_ranking.json", "report.json"):
        verified.load_verified(tmp_path / name, json.loads)  # sidecar holds
    member_dirs = sorted(str(p) for p in tmp_path.glob("rank*_seed*"))
    assert len(member_dirs) == 4
    rank0 = [d for d in member_dirs if "rank0" in d]
    got_cfg, stacked = stack_checkpoints(rank0, device="cpu")
    assert got_cfg == cfg and next(iter(stacked.values())).shape[0] == 2
    # the report's test Sharpe is what --checkpoint_dirs computes from them
    res = ens_mod.ensemble_metrics(got_cfg, stacked, teb, CPU_F32)
    assert float(res["ensemble_sharpe"]) == pytest.approx(
        report["winners"][0]["ensemble_sharpe"]["test"], abs=1e-6)


def test_sweep_cli_quick_round_trip(synthetic_dir, tmp_path, capsys):
    """--quick --device cpu: the ranking, the ledger, the rank dirs and the
    report; evaluate_ensemble on rank0's dirs gives its test Sharpe; a
    --resume-from-ledger --search_only rerun retrains no bucket and writes
    the same ranking."""
    save = tmp_path / "sw"
    common = ["--data_dir", str(synthetic_dir), "--save_dir", str(save),
              "--quick", "--device", "cpu", "--compute_dtype", "float32"]
    cli.main(common)
    report = json.loads((save / "report.json").read_text())
    assert len(report["winners"]) == 2 and report["n_grand_members"] == 6
    assert len(list(SweepLedger(save / "sweep_ledger").records_dir.glob(
        "*.json"))) == 2
    dirs = sorted(str(p) for p in save.glob("rank0_seed*"))
    assert len(dirs) == 3
    res = evaluate_ensemble(dirs, str(synthetic_dir),
                            exec_cfg=ExecutionConfig(
                                device="cpu", compute_dtype="float32"),
                            verbose=False)
    assert res["test_sharpe"] == pytest.approx(
        report["winners"][0]["ensemble_sharpe"]["test"], abs=1e-6)
    ranking = (save / "sweep_ranking.json").read_text()
    cli.main(common + ["--resume-from-ledger", "--search_only"])
    out = capsys.readouterr().out
    assert out.count("ledger hit") == 2
    assert (save / "sweep_ranking.json").read_text() == ranking


def test_cli_and_run_sweep_refuse_to_run_without_a_card(synthetic_dir,
                                                       splits, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a CUDA device")
    with pytest.raises(SystemExit) as e:
        cli.main(["--data_dir", str(synthetic_dir), "--quick"])
    assert e.value.code != 0 and "CUDA" in capsys.readouterr().err
    train, valid, _ = splits
    with pytest.raises(RuntimeError, match="CUDA"):
        sw.run_sweep([(_base(train), 1e-3)], [1], _tbatch(train),
                     _tbatch(valid), tcfg=TrainConfig(1, 0, 1),
                     verbose=False)
