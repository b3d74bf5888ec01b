"""The PyTorch port's ensemble training against the JAX package's, on the CPU.

* ``train_ensemble`` (members stacked on a leading axis) against the JAX
  ``train_ensemble`` (vmapped), from the same params through
  ``stacked_state_dict_from_jax_params``, dropout 0, at the JAX test's own
  bars (``tests/test_parallel.py``): history rtol 2e-4 (atol 1e-6 losses,
  1e-5 Sharpes), final params rtol 2e-4, atol 2e-5;
* member s of a dropout-on ensemble against the port's own serial
  ``train_3phase(seed=s)``: the same masks (per-member seeds in the FFN
  kernels, one generator per member for the LSTM and moment-net dropout),
  so only the batched summation order differs (rtol 2e-4);
* the pieces: per-member dropout seeds, per-member gradient clipping,
  losses and metrics over a leading member axis, quorum;
* the ``--train_seeds`` CLI and its round trip through ``--checkpoint_dirs``,
  its ``ensemble_report.json`` verified by its ``.sha256`` sidecar.

Model: hidden (8, 8), LSTM (4,), K = 4, schedule 8/4/16, ignore 2, f32.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch import evaluate_ensemble
from deeplearninginassetpricing_paperreplication_torch.ops import losses as L
from deeplearninginassetpricing_paperreplication_torch.ops import metrics as M
from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K
from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble import (
    QuorumError,
    apply_quorum,
    ensemble_metrics,
    ensemble_metrics_from_weights,
    member_validity,
    member_weights,
    run_member_chunks,
    train_ensemble,
)
from deeplearninginassetpricing_paperreplication_torch.reliability import (
    verified,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    member_state_dicts,
    stacked_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.training.steps import (
    MemberOptimizer,
    Optimizer,
)
from deeplearninginassetpricing_paperreplication_torch.training.trainer import (
    HISTORY_KEYS,
    train_3phase,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    ensemble as jens,
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
SEEDS = [11, 22, 33]


def _cfg_kw(ds, **kw):
    base = dict(macro_feature_dim=ds.macro_feature_dim,
                individual_feature_dim=ds.individual_feature_dim,
                hidden_dim=(8, 8), num_units_rnn=(4,),
                num_condition_moment=4, dropout=0.0)
    return dict(base, **kw)


def _tbatch(ds):
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in ds.full_batch().items()}


def _jbatch(ds):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in ds.full_batch().items()}


def _check_history(got, want, bars):
    for k in HISTORY_KEYS:
        atol = 1e-5 if "sharpe" in k else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=bars, atol=atol,
                                   err_msg=k)


# -- the whole slice ----------------------------------------------------------


def test_train_ensemble_matches_jax(splits):
    """The port's ensemble against the JAX vmapped ensemble, dropout 0, from
    the same start, through all three phases, to the final params."""
    train, valid, test = splits
    kw = _cfg_kw(train)
    jcfg = JGANConfig(**kw)
    jgan, jfinal, jhist = jens.train_ensemble(
        jcfg, _jbatch(train), _jbatch(valid), _jbatch(test), seeds=SEEDS,
        tcfg=JTrainConfig(**SCHEDULE), verbose=False)
    cfg = GANConfig(**kw)
    start = stacked_state_dict_from_jax_params(
        jax.device_get(jens.init_ensemble_params(jgan, SEEDS)), cfg)
    final, hist = train_ensemble(
        cfg, _tbatch(train), _tbatch(valid), _tbatch(test), seeds=SEEDS,
        tcfg=TrainConfig(**SCHEDULE), exec_cfg=CPU_F32, state_dicts=start,
        verbose=False)
    assert hist["train_loss"].shape == (3, 8 + 16)
    _check_history(hist, {k: np.asarray(v) for k, v in jhist.items()}, 2e-4)
    ref = stacked_state_dict_from_jax_params(jax.device_get(jfinal), cfg)
    assert list(final) == list(ref)
    for k in ref:
        np.testing.assert_allclose(final[k].numpy(), ref[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def test_ensemble_member_matches_serial_with_dropout(splits):
    """Dropout 0.1 in the FFN, between two LSTM layers and in a hidden
    moment layer: member s of the ensemble trains as train_3phase(seed=s),
    and member_chunk gives the same members."""
    train, valid, test = splits
    cfg = GANConfig(**_cfg_kw(train, dropout=0.1, num_units_rnn=(4, 4),
                              hidden_dim_moment=(5,)))
    batches = [_tbatch(d) for d in splits]
    tcfg = TrainConfig(**SCHEDULE)
    final, hist = train_ensemble(cfg, *batches, seeds=SEEDS, tcfg=tcfg,
                                 exec_cfg=CPU_F32, verbose=False)
    for i, seed in enumerate(SEEDS):
        _, params, shist, _ = train_3phase(cfg, *batches, tcfg=tcfg,
                                           seed=seed, verbose=False,
                                           exec_cfg=CPU_F32)
        _check_history({k: v[i] for k, v in hist.items()}, shist, 2e-4)
        for k, v in params.items():
            np.testing.assert_allclose(final[k][i].numpy(), v.numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
    chunked, chist = train_ensemble(cfg, *batches, seeds=SEEDS, tcfg=tcfg,
                                    member_chunk=2, exec_cfg=CPU_F32,
                                    verbose=False)
    _check_history(chist, hist, 2e-4)
    for k in final:
        torch.testing.assert_close(chunked[k], final[k], rtol=2e-4,
                                   atol=2e-5)


# -- per-member dropout seeds ----------------------------------------------------


def _pr2_row_hash(seed, S, T, N):
    """The dropout row hash as the single-seed kernels computed it."""
    ar = lambda n: torch.arange(n, dtype=torch.int64)  # noqa: E731
    h = K._fmix32(torch.tensor((int(seed) ^ K._GOLDEN) & K._M32))
    h = K._fmix32(h ^ ar(S)[:, None, None])
    h = K._fmix32(h ^ ar(T)[None, :, None])
    return K._fmix32(h ^ ar(N)[None, None, :])


def test_per_member_seeds_draw_the_single_member_masks():
    """S seeds give member s the masks of an S = 1 call with seeds[s]; the
    S = 1 masks and one-int-seed masks are the single-seed hash's."""
    seeds = [7, 2 ** 31 - 5, 123456]
    for layer in (0, 1):
        fused = K.dropout_keep(seeds, 0.3, layer, 3, 5, 16, 33)
        for s, seed in enumerate(seeds):
            assert torch.equal(fused[s], K.dropout_keep(
                seed, 0.3, layer, 1, 5, 16, 33)[0])
    threshold, _ = K.dropout_params(0.3)
    for seed, S in ((9, 1), (9, 3), (2 ** 32 + 4, 2)):
        old = K._unit_bits(_pr2_row_hash(seed, S, 5, 33), 1, 16) >= threshold
        assert torch.equal(K.dropout_keep(seed, 0.3, 1, S, 5, 16, 33), old)
    with pytest.raises(ValueError, match="2 dropout seeds for 3"):
        K.dropout_keep([1, 2], 0.3, 0, 3, 5, 16, 33)


def test_per_member_seeds_in_the_fused_ffn():
    """The plain forward and backward at S = 3 with three seeds equal three
    S = 1 calls, and autograd through sdf_ffn agrees."""
    rng = np.random.default_rng(12)
    S, T, F, N, hidden = 3, 4, 6, 21, (7, 5)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x, zp, k1T = t(T, F, N), t(S, T, hidden[0]), t(S, hidden[0], F)
    mids = [(t(S, hidden[1], hidden[0]), t(S, hidden[1]))]
    kout, bout, g = t(S, hidden[1]), t(S), t(S, T, N)
    seeds = [31, 32, 33]
    out = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout, "float32",
                              seeds, 0.3)
    bwd = K.sdf_ffn_bwd_reference(x, zp, k1T, mids, kout, g, "float32",
                                  seeds, 0.3)
    for s, seed in enumerate(seeds):
        one = lambda a: a[s:s + 1]  # noqa: E731
        m1 = [(one(w), one(b)) for w, b in mids]
        torch.testing.assert_close(out[s:s + 1], K.sdf_ffn_reference(
            x, one(zp), one(k1T), m1, one(kout), one(bout), "float32", seed,
            0.3))
        ref = K.sdf_ffn_bwd_reference(x, one(zp), one(k1T), m1, one(kout),
                                      one(g), "float32", seed, 0.3)
        torch.testing.assert_close(bwd[0][s:s + 1], ref[0])
        torch.testing.assert_close(bwd[1][s:s + 1], ref[1])
        torch.testing.assert_close(bwd[2][0][0][s:s + 1], ref[2][0][0])
    params = [zp, k1T, kout] + [w for w, _ in mids]
    for p in params:
        p.requires_grad_()
    y = K.sdf_ffn(x, zp, k1T, mids, kout, bout, seed=seeds, dropout_rate=0.3,
                  compute_dtype="float32")
    torch.testing.assert_close(y.detach(), out)
    gz, gk, gko, gw = torch.autograd.grad((y * g).sum(), params)
    torch.testing.assert_close(gz, bwd[0])
    torch.testing.assert_close(gk, bwd[1])
    torch.testing.assert_close(gko, bwd[3])
    torch.testing.assert_close(gw, bwd[2][0][0])


# -- per-member clipping ------------------------------------------------------------


def test_member_optimizer_clips_each_member_by_its_own_norm():
    """Member 0's gradient norm is above grad_clip, member 1's below it:
    each member's update equals a one-model Optimizer.step, over three
    steps (the Adam state stays per member)."""
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (5,), (1,)]
    p0 = [rng.standard_normal((2,) + s).astype(np.float32) for s in shapes]
    stacked = [torch.from_numpy(a.copy()) for a in p0]
    singles = [[torch.from_numpy(a[m].copy()) for a in p0] for m in (0, 1)]
    opt = MemberOptimizer(stacked, 1e-2)
    opts = [Optimizer(singles[m], 1e-2) for m in (0, 1)]
    seen = []
    for scale in ((5.0, 0.1), (0.2, 0.05), (3.0, 2.0)):
        gs = [rng.standard_normal((2,) + s).astype(np.float32) for s in shapes]
        for a in gs:
            a[0] *= scale[0]
            a[1] *= scale[1]
        norms = opt.step([torch.from_numpy(a) for a in gs])
        assert norms.shape == (2,)
        seen.append(norms.tolist())
        for m in (0, 1):
            n = opts[m].step([torch.from_numpy(a[m]) for a in gs])
            torch.testing.assert_close(norms[m], n, rtol=1e-6, atol=0)
            for a, b in zip(stacked, singles[m]):
                torch.testing.assert_close(a[m], b, rtol=0, atol=1e-7)
    # the first step clips member 0 and leaves member 1 as it is
    assert seen[0][0] > 1.0 > seen[0][1]


# -- a leading member axis on the losses and metrics ------------------------------


@pytest.mark.parametrize("n_assets", [None, 70])
def test_losses_and_metrics_take_a_member_axis(n_assets):
    """A stacked [S, T, N] input gives what S separate [T, N] calls give."""
    g = torch.Generator().manual_seed(5)
    S, T, N, Kn = 3, 12, 40, 4
    w = torch.randn(S, T, N, generator=g)
    R = torch.randn(T, N, generator=g) * 0.1
    m = (torch.rand(T, N, generator=g) > 0.25).float()
    h = torch.tanh(torch.randn(S, Kn, T, N, generator=g))
    stacked = [
        L.portfolio_returns(w, R, m),
        *L.unconditional_loss(w, R, m, n_assets=n_assets),
        *L.conditional_loss(w, R, m, h, n_assets=n_assets),
        L.residual_loss(w, R, m),
    ]
    F = stacked[0]
    stacked += [M.sharpe(F), M.sharpe(F, ddof=0), M.sharpe_monitor(F)]
    for s in range(S):
        one = [
            L.portfolio_returns(w[s], R, m),
            *L.unconditional_loss(w[s], R, m, n_assets=n_assets),
            *L.conditional_loss(w[s], R, m, h[s], n_assets=n_assets),
            L.residual_loss(w[s], R, m),
            M.sharpe(F[s]), M.sharpe(F[s], ddof=0), M.sharpe_monitor(F[s]),
        ]
        for i, (a, b) in enumerate(zip(stacked, one)):
            torch.testing.assert_close(a[s], b, rtol=1e-6, atol=1e-9,
                                       msg=f"output {i}")


# -- quorum, chunking, weights-level ensembles --------------------------------------


def test_member_validity_and_apply_quorum():
    stacked = {"w": torch.ones(3, 2), "b": torch.zeros(3)}
    stacked["w"][1, 0] = float("nan")
    np.testing.assert_array_equal(member_validity(stacked),
                                  [True, False, True])
    kept_params, kept, dropped = apply_quorum(stacked, [7, 8, 9], quorum=2)
    assert kept == [7, 9] and dropped == [8]
    assert kept_params["w"].shape == (2, 2)
    assert torch.isfinite(kept_params["w"]).all()
    with pytest.raises(QuorumError, match=r"\[8\]"):
        apply_quorum(stacked, [7, 8, 9], quorum=3)
    finite = {"w": torch.ones(2, 2)}
    out, kept, dropped = apply_quorum(finite, (7, 8), quorum=2)
    assert out is finite and kept == [7, 8] and dropped == []


def test_run_member_chunks_concatenates_nested_results():
    out = run_member_chunks(lambda xs: {"p": {"a": torch.tensor(xs)},
                                        "h": np.asarray(xs)[:, None]},
                            [1, 2, 3, 4, 5], 2)
    assert out["p"]["a"].tolist() == [1, 2, 3, 4, 5]
    assert out["h"].shape == (5, 1)


def test_ensemble_metrics_from_weights_is_the_params_route(splits):
    train = splits[0]
    cfg = GANConfig(**_cfg_kw(train))
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble \
        import init_ensemble_params
    stacked = init_ensemble_params(cfg, SEEDS)
    b = _tbatch(train)
    a = ensemble_metrics(cfg, stacked, b, CPU_F32)
    w = member_weights(cfg, stacked, b, CPU_F32)
    c = ensemble_metrics_from_weights(w, b)
    for k in a:
        np.testing.assert_array_equal(a[k], c[k], err_msg=k)


def test_stacked_bridge_is_the_per_member_bridge(splits):
    train = splits[0]
    from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
        GAN as JGAN,
    )
    kw = _cfg_kw(train)
    jgan = JGAN(JGANConfig(**kw))
    vparams = jax.device_get(jens.init_ensemble_params(jgan, SEEDS))
    cfg = GANConfig(**kw)
    stacked = stacked_state_dict_from_jax_params(vparams, cfg)
    for s, sd in enumerate(member_state_dicts(stacked)):
        one = state_dict_from_jax_params(
            jax.tree.map(lambda x, s=s: np.asarray(x)[s], vparams), cfg)
        assert list(sd) == list(one)
        for k in one:
            assert torch.equal(sd[k], one[k]), k


# -- the CLI ----------------------------------------------------------------------


def test_train_seeds_cli_round_trip(synthetic_dir, tmp_path, capsys):
    """--train_seeds --save_dir --device cpu writes member run dirs and a
    report; --checkpoint_dirs on them gives the same test Sharpe."""
    save = tmp_path / "ens"
    evaluate_ensemble.main([
        "--data_dir", str(synthetic_dir), "--train_seeds", "42", "123",
        "--epochs_unc", "4", "--epochs_moment", "2", "--epochs", "6",
        "--ignore_epoch", "1", "--save_dir", str(save), "--device", "cpu"])
    report, _ = verified.load_verified(save / "ensemble_report.json",
                                       json.loads)  # the sidecar verifies
    assert verified.digest_path(save / "ensemble_report.json").exists()
    assert set(report) == {"seeds", "ensemble_sharpe", "explained_variation",
                           "cross_sectional_r2", "individual_test_sharpes"}
    assert report["seeds"] == [42, 123]
    assert len(report["individual_test_sharpes"]) == 2
    dirs = [str(save / f"seed_{s}") for s in (42, 123)]
    for d in dirs:
        for f in ("config.json", "best_model_sharpe.pt"):
            assert (save / d / f).exists()
    res = evaluate_ensemble.evaluate_ensemble(
        dirs, str(synthetic_dir), exec_cfg=ExecutionConfig(device="cpu"),
        verbose=False)
    assert np.isfinite(res["test_sharpe"])
    assert res["test_sharpe"] == pytest.approx(
        report["ensemble_sharpe"]["test"], abs=1e-6)
    assert res["individual_sharpes"] == pytest.approx(
        report["individual_test_sharpes"], abs=1e-6)
    # quorum: a missing member dir is skipped while 2 of 3 load
    res_q = evaluate_ensemble.evaluate_ensemble(
        dirs + [str(tmp_path / "gone")], str(synthetic_dir),
        exec_cfg=ExecutionConfig(device="cpu"), verbose=False, quorum=2)
    assert res_q["test_sharpe"] == res["test_sharpe"]
    assert res_q["skipped_dirs"][0]["reason"] == "missing config.json"
    with pytest.raises(ValueError, match="quorum is 3"):
        evaluate_ensemble.evaluate_ensemble(
            dirs + [str(tmp_path / "gone")], str(synthetic_dir),
            exec_cfg=ExecutionConfig(device="cpu"), verbose=False, quorum=3)
    capsys.readouterr()


def test_cli_and_stack_checkpoints_refuse_to_run_without_a_card(
        synthetic_dir, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a CUDA device")
    with pytest.raises(SystemExit) as e:
        evaluate_ensemble.main(["--data_dir", str(synthetic_dir),
                                "--train_seeds", "1"])
    assert e.value.code != 0 and "CUDA" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        evaluate_ensemble.main(["--data_dir", str(synthetic_dir)])
    assert e.value.code != 0 and "exactly one" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_ensemble.stack_checkpoints(["unused"])


# -- on the card ----------------------------------------------------------------------


@pytest.mark.cuda
def test_ensemble_launches_one_kernel_per_pass_on_card(splits):
    """At S = 3 every epoch launches the four kernels exactly as one model
    does (needs a card + nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        cond_em as C,
    )
    train, valid, test = splits
    cfg = GANConfig(**_cfg_kw(train, dropout=0.05, num_condition_moment=8))
    batches = [{k: v.cuda() for k, v in _tbatch(d).items()} for d in splits]
    K.reset_launch_count()
    C.reset_launch_count()
    train_ensemble(cfg, *batches, seeds=SEEDS, tcfg=TrainConfig(**SCHEDULE),
                   exec_cfg=ExecutionConfig(compute_dtype="float32"),
                   verbose=False)
    torch.cuda.synchronize()
    # (fwd, bwd, cem_fwd, cem_bwd) per epoch: phase 1 (3,1,2,0) × 8,
    # phase 2 (1,0,1,1) × 4, phase 3 (3,1,3,1) × 16
    assert (K.launches, K.bwd_launches, C.fwd_launches, C.bwd_launches) == (
        8 * 3 + 4 + 16 * 3, 8 + 16, 8 * 2 + 4 + 16 * 3, 4 + 16)
