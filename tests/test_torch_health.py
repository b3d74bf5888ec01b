"""The port's model health against the JAX package's, on the CPU.

The same inputs from a numpy seed, the same parameters (the JAX
``GAN.init`` through ``state_dict_from_jax_params``), f32, dropout 0 unless
named:

* ``panel_diagnostics`` on the same (w, R, mask, h), also with a padded
  stock axis and ``n_assets``, and without the N̄/N_t weighting;
* the port's diagnostics pass (``diagnostics_members``) against the JAX
  ``make_diag_fn`` under jit, on the fused conditional-EM route (the
  default moment net) and the h route (a hidden moment layer), and the
  identity mean_k v_k² == loss_cond of the same eval forward;
* ``candidate_diagnostics`` at S = 3;
* ``train_3phase(diag_stride=2)`` against the JAX trainer's ``diag_*``
  history, and the diagnostics' observational freeness (dropout 0.05, on
  and off, bit for bit);
* ``health.json``'s schema against the JAX ``compute_health`` document,
  the drift profile and scores against the JAX ``drift.py``, and the train
  CLI's ``--diag_stride``.

Tolerances (ROADMAP.md): losses and every diagnostic rtol 2e-4 / atol 1e-6;
the identity rtol 1e-6 (both sides come from the same em).
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.gan import GAN
from deeplearninginassetpricing_paperreplication_torch.observability import (
    drift,
    modelhealth,
)
from deeplearninginassetpricing_paperreplication_torch.ops import diagnostics
from deeplearninginassetpricing_paperreplication_torch.reliability.verified import (
    digest_path,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    stacked_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.training.trainer import (
    train_3phase,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    drift as jdrift,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    modelhealth as jhealth,
)
from deeplearninginassetpricing_paperreplication_tpu.ops import (
    diagnostics as jdiag,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    ensemble as jens,
)
from deeplearninginassetpricing_paperreplication_tpu.training.trainer import (
    train_3phase as jtrain_3phase,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    TrainConfig as JTrainConfig,
)

PKG = "deeplearninginassetpricing_paperreplication_torch"
CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
TOL = dict(rtol=2e-4, atol=1e-6)
SCHEDULE = dict(num_epochs_unc=8, num_epochs_moment=4, num_epochs=16,
                ignore_epoch=2)
ARCHS = {"fused_em": dict(), "moment_hidden": dict(hidden_dim_moment=(8,))}


def _cfg_kw(ds, **kw):
    base = dict(macro_feature_dim=ds.macro_feature_dim,
                individual_feature_dim=ds.individual_feature_dim,
                hidden_dim=(8, 8), num_units_rnn=(4,), dropout=0.0)
    return dict(base, **kw)


def _tbatch(ds):
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in ds.full_batch().items()}


def _jbatch(ds):
    return {k: jnp.asarray(v) for k, v in ds.full_batch().items()}


def _assert_diag(port, ref, member=None, err=""):
    """Every scalar of SCALAR_KEYS and the violations, port [S] (member
    `member`, or the reduced value) against the JAX reference."""
    for k in diagnostics.SCALAR_KEYS + ("moment_violations",):
        got = np.asarray(port[k])
        if member is not None:
            got = got[member]
        np.testing.assert_allclose(got, np.asarray(ref[k]), **TOL,
                                   err_msg=f"{err} {k}")


def _panel(seed, T=9, N=40, K=5, pad=0):
    """(w, R, mask, h) from a numpy seed, the stock axis padded by `pad`
    all-masked columns."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((T, N)).astype(np.float32) * 0.1
    R = rng.standard_normal((T, N)).astype(np.float32) * 0.05
    mask = (rng.random((T, N)) > 0.25).astype(np.float32)
    mask[:, 0] = 0.0  # one asset never valid: T_i clamps to 1
    h = np.tanh(rng.standard_normal((K, T, N))).astype(np.float32)
    w = w * mask
    if pad:
        w, R, mask = (np.pad(a, ((0, 0), (0, pad))) for a in (w, R, mask))
        h = np.pad(h, ((0, 0), (0, 0), (0, pad)))
    return w, R, mask, h


@pytest.mark.parametrize("case", ["plain", "padded", "unweighted"])
def test_panel_diagnostics_match_jax(case):
    w, R, mask, h = _panel(1, pad=24 if case == "padded" else 0)
    n_assets = 40 if case == "padded" else None
    weighted = case != "unweighted"
    ref = jdiag.panel_diagnostics(
        jnp.asarray(w), jnp.asarray(R), jnp.asarray(mask), jnp.asarray(h),
        weighted, n_assets=None if n_assets is None else jnp.float32(40))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    port = diagnostics.panel_diagnostics(
        t(w)[None], t(R), t(mask), t(h)[None], weighted, n_assets=n_assets)
    assert set(port) == set(ref)
    assert all(v.dtype == torch.float32 for v in port.values())
    assert port["moment_violations"].shape == (1, 5)
    assert float(port["computed"][0]) == 1.0
    _assert_diag({k: v.numpy() for k, v in port.items()}, ref, member=0,
                 err=case)
    na = None if n_assets is None else jnp.float32(40)
    mv = diagnostics.moment_violations(t(w)[None], t(R), t(mask),
                                       t(h)[None], weighted,
                                       n_assets=n_assets)
    np.testing.assert_allclose(mv[0].numpy(), np.asarray(
        jdiag.moment_violations(jnp.asarray(w), jnp.asarray(R),
                                jnp.asarray(mask), jnp.asarray(h), weighted,
                                n_assets=na)), **TOL)
    uv = diagnostics.unconditional_violation(t(w)[None], t(R), t(mask),
                                             weighted, n_assets=n_assets)
    np.testing.assert_allclose(float(uv[0]), float(
        jdiag.unconditional_violation(jnp.asarray(w), jnp.asarray(R),
                                      jnp.asarray(mask), weighted,
                                      n_assets=na)), **TOL)
    if case == "padded":
        # the padding changes nothing: the unpadded panel's diagnostics
        w0, R0, m0, h0 = _panel(1)
        plain = diagnostics.panel_diagnostics(
            t(w0)[None], t(R0), t(m0), t(h0)[None], weighted)
        np.testing.assert_allclose(port["moment_violations"].numpy(),
                                   plain["moment_violations"].numpy(),
                                   rtol=1e-6)


def test_member_axis_is_independent_members():
    """Three members in one call give each member's own S = 1 call."""
    panels = [_panel(s) for s in (2, 3, 4)]
    R, mask = torch.from_numpy(panels[0][1]), torch.from_numpy(panels[0][2])
    w = torch.stack([torch.from_numpy(p[0]) * mask for p in panels])
    h = torch.stack([torch.from_numpy(p[3]) for p in panels])
    stacked = diagnostics.panel_diagnostics(w, R, mask, h)
    for s in range(3):
        one = diagnostics.panel_diagnostics(w[s:s + 1], R, mask, h[s:s + 1])
        for k, v in one.items():
            np.testing.assert_allclose(stacked[k][s].numpy(), v[0].numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def test_sdf_series_stats_skip_nonfinite_months_as_jax():
    F = np.random.default_rng(5).standard_normal((2, 11)).astype(
        np.float32) * 0.05
    F[0, 3] = np.nan
    F[1, [0, 7]] = np.inf
    port = diagnostics.sdf_series_stats(torch.from_numpy(F))
    for s in range(2):
        ref = jdiag.sdf_series_stats(jnp.asarray(F[s]))
        for k, v in ref.items():
            np.testing.assert_allclose(port[k][s].numpy(), np.asarray(v),
                                       rtol=1e-6, err_msg=k)


def test_zeros_diagnostics_match_jax_structure():
    ref = jdiag.zeros_diagnostics(6)
    port = diagnostics.zeros_diagnostics(6, S=2)
    assert set(port) == set(ref)
    assert port["moment_violations"].shape == (2, 6)
    assert all(float(v.abs().sum()) == 0.0 for v in port.values())


def _pair(ds, seed=3, **kw):
    """(JAX gan, JAX params, port GAN, port stacked params) from one
    start."""
    jgan = JGAN(JGANConfig(**_cfg_kw(ds, **kw)))
    params = jgan.init(jax.random.key(seed))
    cfg = GANConfig(**_cfg_kw(ds, **kw))
    sd = state_dict_from_jax_params(jax.device_get(params), cfg)
    gan = GAN.from_state_dict(cfg, sd, CPU_F32)
    return jgan, params, gan, {k: v[None] for k, v in sd.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_diagnostics_pass_matches_jax(splits, arch):
    valid = splits[1]
    jgan, params, gan, stacked = _pair(valid, **ARCHS[arch])
    ref = jax.jit(jdiag.make_diag_fn(jgan))(params, _jbatch(valid))
    port = diagnostics.diagnostics_members(gan, stacked, _tbatch(valid))
    _assert_diag({k: v.numpy() for k, v in port.items()}, ref, member=0,
                 err=arch)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_violation_identity_with_the_eval_loss(splits, arch):
    """mean_k v_k² is the conditional loss of the same eval forward: on the
    fused route both come from the one em."""
    valid = splits[1]
    _, _, gan, stacked = _pair(valid, **ARCHS[arch])
    tb = _tbatch(valid)
    d = diagnostics.diagnostics_members(gan, stacked, tb)
    with torch.no_grad():
        loss_cond = gan.forward(tb, "conditional")["loss_conditional"]
    v = d["moment_violations"][0].double()
    np.testing.assert_allclose(float((v ** 2).mean()), float(loss_cond),
                               rtol=1e-6)
    np.testing.assert_allclose(float(d["loss_cond"][0]), float(loss_cond),
                               rtol=1e-6)


def test_candidate_diagnostics_match_jax(splits):
    valid = splits[1]
    kw = _cfg_kw(valid)
    jgan = JGAN(JGANConfig(**kw))
    vparams = jens.init_ensemble_params(jgan, (1, 2, 3))
    ref = jhealth.candidate_diagnostics(jgan, vparams, _jbatch(valid))
    cfg = GANConfig(**kw)
    stacked = stacked_state_dict_from_jax_params(jax.device_get(vparams),
                                                 cfg)
    port = modelhealth.candidate_diagnostics(GAN(cfg, CPU_F32), stacked,
                                             _tbatch(valid))
    assert set(port) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k], v, **TOL, err_msg=k)
    assert len(port["per_member_violation_max"]) == 3


@pytest.fixture(scope="module")
def diag_runs(splits, tmp_path_factory):
    """The JAX and the port trainer with diag_stride 2 from one start
    (8/4/16, ignore 2, dropout 0), and the port's health.json run dir."""
    train, valid, test = splits
    kw = _cfg_kw(train)
    jgan, _, jhist, _ = jtrain_3phase(
        JGANConfig(**kw), _jbatch(train), _jbatch(valid), _jbatch(test),
        tcfg=JTrainConfig(**SCHEDULE), seed=5, verbose=False, diag_stride=2)
    cfg = GANConfig(**kw)
    start = state_dict_from_jax_params(
        jax.device_get(jgan.init(jax.random.key(5))), cfg)
    save = tmp_path_factory.mktemp("diag_run")
    gan, params, hist, _ = train_3phase(
        cfg, _tbatch(train), _tbatch(valid), _tbatch(test),
        tcfg=TrainConfig(**SCHEDULE), seed=5, verbose=False,
        exec_cfg=CPU_F32, state_dict=start, save_dir=str(save),
        diag_stride=2)
    return jgan, jhist, gan, params, hist, save


def test_trainer_diag_history_matches_jax(diag_runs):
    _, jhist, _, _, hist, _ = diag_runs
    jkeys = sorted(k for k in jhist if k.startswith("diag_"))
    assert sorted(k for k in hist if k.startswith("diag_")) == jkeys
    np.testing.assert_array_equal(hist["diag_computed"],
                                  np.asarray(jhist["diag_computed"]))
    # phase-local stride epochs of phases 1 and 3, never phase 2
    want = [1.0 if e % 2 == 0 else 0.0 for e in range(8)] + [
        1.0 if e % 2 == 0 else 0.0 for e in range(16)]
    assert hist["diag_computed"].tolist() == want
    assert hist["diag_moment_violations"].shape == (24, 8)
    for k in jkeys:
        np.testing.assert_allclose(hist[k], np.asarray(jhist[k]), **TOL,
                                   err_msg=k)


def test_health_json_matches_jax_document(diag_runs, splits):
    jgan, jhist, gan, params, hist, save = diag_runs
    doc = modelhealth.read_health(save)
    assert digest_path(save / modelhealth.HEALTH_FILENAME).exists()
    jparams = jgan.init(jax.random.key(5))
    jdoc = jhealth.compute_health(jgan, jparams, _jbatch(splits[1]),
                                  history=jhist, guard_trips=[],
                                  diag_stride=2)
    assert set(doc) == set(jdoc)
    assert set(doc["diagnostics"]) == set(jdoc["diagnostics"])
    assert set(doc["history_last"]) == set(jdoc["history_last"])
    assert doc["history_last"]["history_row"] == 22
    assert doc["finite"] is True and doc["guard_trips"] == 0
    assert doc["divergence_trips"] == [] and doc["diag_stride"] == 2
    # the document is the final params' diagnostics on the valid batch
    again = modelhealth.compute_diagnostics_host(gan, params,
                                                 _tbatch(splits[1]))
    assert doc["diagnostics"] == again


def test_read_health_without_a_file_is_none(tmp_path):
    assert modelhealth.read_health(tmp_path) is None
    assert modelhealth.read_health(tmp_path / "absent") is None


def test_write_health_serializes_nonfinite_as_null(tmp_path):
    modelhealth.write_health(tmp_path, {"kind": "model_health",
                                        "diagnostics": {"a": float("nan"),
                                                        "b": [1.0, np.inf]}})
    doc = json.loads((tmp_path / "health.json").read_text())
    assert doc["diagnostics"] == {"a": None, "b": [1.0, None]}


@pytest.mark.parametrize("diag", [
    {"moment_violation_max": 0.5, "sdf_finite_frac": 1.0},
    {"moment_violation_max": 2.0, "sdf_finite_frac": 1.0},
    {"moment_violation_max": float("nan"), "sdf_finite_frac": 1.0},
    {"moment_violation_max": 0.5, "sdf_finite_frac": 0.9},
    {"moment_violation_max": 0.5, "sdf_finite_frac": 1.0,
     "weight_hhi": 0.7, "turnover": None},
], ids=["healthy", "over", "nan", "nonfinite_sdf", "hhi_turnover"])
def test_health_thresholds_classify_as_jax(diag):
    """The bars the gate sets (the HHI and turnover keys pass ungated, as
    under the JAX defaults)."""
    kw = dict(moment_tolerance=1.0)
    assert (modelhealth.HealthThresholds(**kw).classify(diag)
            == jhealth.HealthThresholds(**kw).classify(diag))


def test_diag_stride_is_observationally_free(splits, tmp_path):
    """Dropout 0.05: the same final params, best checkpoints and non-diag
    history bit for bit with the diagnostics on and off."""
    from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
        load_checkpoint_dir,
    )

    train, valid, test = splits
    cfg = GANConfig(**_cfg_kw(train, dropout=0.05))
    runs = {}
    for stride in (None, 2):
        save = tmp_path / f"stride_{stride}"
        _, params, hist, _ = train_3phase(
            cfg, _tbatch(train), _tbatch(valid), _tbatch(test),
            tcfg=TrainConfig(**SCHEDULE), seed=11, verbose=False,
            exec_cfg=CPU_F32, save_dir=str(save), diag_stride=stride)
        runs[stride] = (params, hist, save)
    (p0, h0, s0), (p1, h1, s1) = runs[None], runs[2]
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert not any(k.startswith("diag_") for k in h0)
    for k, v in h0.items():
        np.testing.assert_array_equal(h1[k], v, err_msg=k)
    for which in ("best_model_loss", "best_model_sharpe", "final_model"):
        a, b = (load_checkpoint_dir(s, which)[1] for s in (s0, s1))
        assert all(torch.equal(a[k], b[k]) for k in a), which
    assert (s0 / "health.json").exists() and (s1 / "health.json").exists()


def _drift_panel(seed, T=6, N=50, F=4, M=3, shift=0.0):
    rng = np.random.default_rng(seed)
    return {"individual": (rng.standard_normal((T, N, F)) + shift).astype(
                np.float32),
            "mask": (rng.random((T, N)) > 0.2).astype(np.float32),
            "macro": rng.standard_normal((40, M)).astype(np.float32)}


def test_drift_profile_and_scores_match_jax(splits):
    ref_panel = splits[0].full_batch()
    port = drift.reference_profile(ref_panel, source="fixture")
    jref = jdrift.reference_profile(ref_panel, source="fixture")
    port.pop("written_at")
    jref.pop("written_at")
    assert port == jref
    for shift in (0.0, 0.3, 3.0):
        panel = dict(splits[1].full_batch())
        panel["individual"] = panel["individual"] + np.float32(shift)
        assert drift.drift_report(port, panel) == jdrift.drift_report(
            jref, panel)
    req = splits[2].individual[0]
    assert drift.score_request(port, req) == jdrift.score_request(jref, req)
    # a constant series and a panel without macro
    const = _drift_panel(1)
    const["individual"][..., 0] = 2.0
    del const["macro"]
    a = drift.reference_profile(const)
    b = jdrift.reference_profile(const)
    a.pop("written_at"), b.pop("written_at")
    assert a == b
    moved = _drift_panel(2, shift=0.5)
    assert drift.drift_report(a, moved) == jdrift.drift_report(b, moved)


def test_drift_profile_roundtrip_verified(tmp_path, splits):
    prof = drift.reference_profile(splits[0].full_batch(), source="x")
    path = drift.write_profile(tmp_path, prof)
    assert path.name == drift.PROFILE_FILENAME
    assert digest_path(path).exists()
    assert drift.read_profile(tmp_path) == prof
    assert drift.read_profile(path) == prof
    # each package reads the other's file
    assert jdrift.read_profile(tmp_path) == prof
    assert drift.read_profile(tmp_path / "absent") is None


def test_train_cli_diag_stride_writes_health_and_profile(synthetic_dir,
                                                         tmp_path):
    save = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.train", "--data_dir",
         str(synthetic_dir), "--save_dir", str(save), "--epochs_unc", "4",
         "--epochs_moment", "2", "--epochs", "6", "--ignore_epoch", "1",
         "--hidden_dim", "8", "8", "--device", "cpu", "--diag_stride", "4"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for f in ("reference_profile.json", "health.json"):
        assert (save / f).exists() and digest_path(save / f).exists(), f
    hist = np.load(save / "history.npz")
    assert hist["diag_computed"].tolist() == [1, 0, 0, 0, 1, 0, 0, 0, 1, 0]
    assert hist["diag_moment_violations"].shape == (10, 8)
    assert {f"diag_{k}" for k in diagnostics.SCALAR_KEYS} <= set(hist.files)
    health = modelhealth.read_health(save)
    assert health["diag_stride"] == 4 and health["finite"]
    assert health["history_last"]["history_row"] == 8
    profile = drift.read_profile(save)
    assert profile["source"] == str(synthetic_dir)
    assert profile["n_periods"] == 24 and len(profile["individual"]) == 10
