"""The PyTorch port's training slice against the JAX package's, on the CPU.

The same start (the JAX ``GAN.init`` params through the weight bridge
``state_dict_from_jax_params``), the same fixture panel, f32, dropout 0:

* ``GAN.forward`` of every phase, with the trainable subtree's gradients,
  against the JAX ``GAN.forward`` and ``jax.grad``;
* one train step (clip and Adam) against ``make_train_step``, including a
  step whose gradient norm exceeds 1, so optax's clip formula is what is
  held;
* the whole 3-phase trainer against ``train_3phase`` (schedule 8/4/16,
  ignore 2);
* the train CLI on the CPU, its run directory loading back strictly, and
  its refusal to run without a card unless asked.

Tolerances (ROADMAP.md, from the JAX package's own torch parity): weights
atol 2e-5, losses rtol 2e-4, Sharpe atol 1e-3, params atol 2e-5. Gradients
rtol 1e-4 of the largest entry: only the summation order differs.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.gan import GAN
from deeplearninginassetpricing_paperreplication_torch.models.networks import (
    AssetPricingModule,
)
from deeplearninginassetpricing_paperreplication_torch.training import (
    steps,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    load_checkpoint_dir,
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
from deeplearninginassetpricing_paperreplication_torch.utils.rng import (
    phase_epoch_seeds,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.training import (
    steps as jsteps,
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
PHASES = ("unconditional", "moment", "conditional")
SCHEDULE = dict(num_epochs_unc=8, num_epochs_moment=4, num_epochs=16,
                ignore_epoch=2)


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


def _pair(ds, seed=3, **kw):
    """(JAX gan, JAX params, port GAN) from the same start."""
    jgan = JGAN(JGANConfig(**_cfg_kw(ds, **kw)))
    params = jgan.init(jax.random.key(seed))
    cfg = GANConfig(**_cfg_kw(ds, **kw))
    sd = state_dict_from_jax_params(jax.device_get(params), cfg)
    return jgan, params, GAN.from_state_dict(cfg, sd, CPU_F32)


@pytest.mark.parametrize("arch", [dict(), dict(hidden_dim_moment=(5,))],
                         ids=["fused_em", "moment_hidden"])
@pytest.mark.parametrize("phase", PHASES)
def test_forward_and_grads_match_jax(splits, phase, arch):
    """Every phase's losses, weights and monitor Sharpe, and the gradient
    of the trainable subtree. The default moment net takes the fused
    conditional-EM route; a hidden moment layer the plain route."""
    train = splits[0]
    jgan, params, gan = _pair(train, **arch)
    jb, tb = _jbatch(train), _tbatch(train)
    key = jsteps.trainable_key(phase)

    def loss_fn(sub):
        return jgan.forward(dict(params, **{key: sub}), jb, phase=phase)[
            "loss"]

    jout = jgan.forward(params, jb, phase=phase)
    jgrad = jax.grad(loss_fn)(params[key])
    steps.set_trainable(gan, key)
    out = gan.forward(tb, phase=phase)
    np.testing.assert_allclose(out["weights"].detach().numpy(),
                               np.asarray(jout["weights"]), atol=2e-5)
    for k in ("loss", "loss_unconditional", "loss_conditional"):
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]), rtol=2e-4,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(out["sharpe"].detach()),
                               float(jout["sharpe"]), atol=1e-3)
    names = [n for n, _ in gan.module.named_parameters()
             if n.startswith(key + ".")]
    params_t = [p for n, p in gan.module.named_parameters()
                if n.startswith(key + ".")]
    grads = torch.autograd.grad(out["loss"], params_t)
    jfull = dict(jax.device_get(params))
    jfull[key] = jax.device_get(jgrad)
    ref = state_dict_from_jax_params(jfull, gan.cfg)
    for n, g in zip(names, grads):
        r = ref[n].numpy()
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-4 * np.abs(r).max() + 1e-10,
                                   err_msg=n)
    frozen = [p for n, p in gan.module.named_parameters()
              if not n.startswith(key + ".")]
    assert all(not p.requires_grad for p in frozen)


def _run_jax_step(jgan, params, jb, phase, lr):
    tx = jsteps.make_optimizer(lr)
    key = jsteps.trainable_key(phase)
    opt_state = tx.init(params[key])
    step = jax.jit(jsteps.make_train_step(jgan, phase, tx))
    return step(params, opt_state, jb, None)


@pytest.mark.parametrize("scale", [1.0, 300.0], ids=["small_grad",
                                                     "clipped"])
def test_train_step_matches_jax(splits, scale):
    """One clip → Adam step of phase 1 against ``make_train_step``. Scaling
    the returns by 300 puts the gradient norm far above 1, so the step
    runs through optax's clip branch."""
    train = splits[0]
    jgan, params, gan = _pair(train)
    jb, tb = _jbatch(train), _tbatch(train)
    jb = dict(jb, returns=jb["returns"] * scale)
    tb = dict(tb, returns=tb["returns"] * scale)
    new_params, _, jm = _run_jax_step(jgan, params, jb, "unconditional",
                                      1e-3)
    opt = steps.Optimizer(steps.subtree_params(gan, "sdf_net"), 1e-3)
    m = steps.train_step(gan, "unconditional", opt, tb, None)
    gn = float(jm["grad_norm"])
    assert (gn > 1.0) == (scale > 1.0)
    np.testing.assert_allclose(float(m["grad_norm"]), gn, rtol=1e-4)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(m["sharpe"]), float(jm["sharpe"]),
                               atol=1e-3)
    # Adam's first step moves each parameter by about lr·g/(|g| + 1e-8):
    # where the (clipped) gradient is within a few eps of 0 its size, not
    # the algorithm, decides the step, so those entries are not compared
    jgrad = jax.grad(lambda sub: jgan.forward(
        dict(params, sdf_net=sub), jb, phase="unconditional")["loss"])(
        params["sdf_net"])
    full = dict(jax.device_get(params), sdf_net=jax.device_get(jgrad))
    gref = state_dict_from_jax_params(full, gan.cfg)
    ref = state_dict_from_jax_params(jax.device_get(new_params), gan.cfg)
    compared = total = 0
    for k, v in gan.module.state_dict().items():
        ok = np.abs(gref[k].numpy()) / max(gn, 1.0) > 1e-6
        if not k.startswith("sdf_net."):
            ok = np.ones_like(ok)
        np.testing.assert_allclose(v.numpy()[ok], ref[k].numpy()[ok],
                                   atol=2e-5, err_msg=k)
        compared, total = compared + ok.sum(), total + ok.size
    assert compared >= 0.6 * total


def test_optimizer_is_optax_adam_with_global_clip():
    """Three steps on fixed gradients, one of them above the clip norm,
    against optax's chain on the same numbers."""
    rng = np.random.default_rng(4)
    p0 = [rng.standard_normal((3, 4)).astype(np.float32),
          rng.standard_normal((5,)).astype(np.float32)]
    gs = [[rng.standard_normal(a.shape).astype(np.float32) * s for a in p0]
          for s in (0.1, 5.0, 0.3)]
    tx = jsteps.make_optimizer(1e-2)
    jp = [jnp.asarray(a) for a in p0]
    state = tx.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    opt = steps.Optimizer(tp, 1e-2)
    for g in gs:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([torch.from_numpy(a) for a in g])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(a) for a in g])), rtol=1e-6)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)


@pytest.fixture(scope="module")
def trained_pair(splits):
    """The JAX and the port trainer from the same start, 8/4/16, ignore 2."""
    train, valid, test = splits
    kw = _cfg_kw(train)
    jcfg = JGANConfig(**kw)
    jgan, jparams, jhist, _ = jtrain_3phase(
        jcfg, _jbatch(train), _jbatch(valid), _jbatch(test),
        tcfg=JTrainConfig(**SCHEDULE), seed=5, verbose=False)
    cfg = GANConfig(**kw)
    start = state_dict_from_jax_params(
        jax.device_get(jgan.init(jax.random.key(5))), cfg)
    gan, params, hist, trainer = train_3phase(
        cfg, _tbatch(train), _tbatch(valid), _tbatch(test),
        tcfg=TrainConfig(**SCHEDULE), seed=5, verbose=False,
        exec_cfg=CPU_F32, state_dict=start)
    return jhist, jax.device_get(jparams), hist, params, cfg


def test_trainer_history_matches_jax(trained_pair):
    jhist, _, hist, _, _ = trained_pair
    assert list(hist["phase"]) == list(jhist["phase"])
    assert len(hist["phase"]) == 8 + 16
    for k in ("train_loss", "valid_loss", "test_loss"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=2e-4, atol=1e-9,
                                   err_msg=k)
    for k in ("train_sharpe", "valid_sharpe", "test_sharpe"):
        np.testing.assert_allclose(hist[k], jhist[k], atol=1e-3, err_msg=k)
    np.testing.assert_allclose(hist["grad_norm"], jhist["grad_norm"],
                               rtol=2e-4)


def test_trainer_selects_the_same_epochs_and_params(trained_pair):
    jhist, jparams, hist, params, cfg = trained_pair
    for label, n in (("unc", 8), ("cond", 16)):
        sel = np.asarray(hist["phase"]) == label
        for h in (hist, jhist):
            assert sel.sum() == n
        vs, jvs = hist["valid_sharpe"][sel], jhist["valid_sharpe"][sel]
        elig = np.arange(n) > SCHEDULE["ignore_epoch"]
        assert np.argmax(np.where(elig, vs, -np.inf)) == np.argmax(
            np.where(elig, jvs, -np.inf))
    ref = state_dict_from_jax_params(jparams, cfg)
    assert list(params) == list(ref)
    for k in ref:
        np.testing.assert_allclose(params[k].numpy(), ref[k].numpy(),
                                   atol=2e-5, err_msg=k)


def test_epoch_seeds_are_reproducible_and_distinct():
    a = phase_epoch_seeds(42, [8, 4, 16])
    assert a == phase_epoch_seeds(42, [8, 4, 16])
    assert [len(s) for s in a] == [8, 4, 16]
    flat = [x for s in a for x in s]
    assert len(set(flat)) == len(flat)
    assert all(0 <= x < 2 ** 31 for x in flat)
    assert a != phase_epoch_seeds(43, [8, 4, 16])


def test_training_dropout_draws_from_the_seed(splits):
    """With dropout 0.05 the training forward depends on the seed alone:
    the same seed gives the same loss, another seed another loss, and no
    seed is the eval forward."""
    train = splits[0]
    cfg = GANConfig(**_cfg_kw(train, dropout=0.05))
    gan = GAN(cfg, CPU_F32)
    tb = _tbatch(train)
    a = gan.forward(tb, "conditional", seed=11)["loss"].detach()
    b = gan.forward(tb, "conditional", seed=11)["loss"].detach()
    c = gan.forward(tb, "conditional", seed=12)["loss"].detach()
    e1 = gan.forward(tb, "conditional")["loss"].detach()
    e2 = gan.forward(tb, "conditional")["loss"].detach()
    assert float(a) == float(b) and float(a) != float(c)
    assert float(e1) == float(e2) and float(e1) != float(a)


def test_train_cli_writes_a_run_dir_that_loads_back(synthetic_dir, tmp_path):
    save = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.train", "--data_dir",
         str(synthetic_dir), "--save_dir", str(save), "--epochs_unc", "4",
         "--epochs_moment", "2", "--epochs", "6", "--ignore_epoch", "1",
         "--hidden_dim", "8", "8", "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for f in ("config.json", "best_model_loss.pt", "best_model_sharpe.pt",
              "final_model.pt", "history.npz", "final_metrics.json"):
        assert (save / f).exists(), f
    cfg, sd = load_checkpoint_dir(save, "final_model")
    module = AssetPricingModule(cfg)
    module.load_state_dict(sd, strict=True)
    hist = np.load(save / "history.npz")
    assert list(hist["phase"]) == ["unc"] * 4 + ["cond"] * 6
    import json
    m = json.loads((save / "final_metrics.json").read_text())
    assert np.isfinite(m["test"]["sharpe"]) and m["device"] == "cpu"
