"""Training and evaluation of the PyTorch port on the bf16 feature-major
panel (``ExecutionConfig.bf16_panel``) against the JAX package, on the CPU.

The same start (the JAX ``GAN.init`` params through the weight bridge
``state_dict_from_jax_params``), the fixture panel, f32 compute, dropout 0.
The JAX side runs its fused kernels in the Pallas interpreter with
``bf16_panel=True``, so its ``prepare_batch`` stores ``individual_t`` in
bf16 (``tests/test_pallas.py``'s bf16-panel route). The port's CPU route
is the plain one, which never stores a bf16 panel itself, so its batches
carry a hand-prepared bf16 ``individual_t`` (``prepare_batch`` keeps a
panel it is given), and its plain versions read it:

* ``GAN.forward`` of every phase and the trainable subtree's gradients;
* ``GAN.moments``: the default moment net reads the bf16 panel, as the JAX
  MomentNet's one einsum does (f32 operands on the CPU, ROADMAP C4);
* ``train_3phase`` at 2/1/2 epochs: histories, Sharpes and selected epochs;
* evaluation on the f32 panel: ``member_weights`` and ``ensemble_metrics``
  on a training-prepared (bf16-panel) batch bit for bit the f32 batch's;
* the CLIs' ``execution_config``: the bf16 panel with bf16 compute, the
  f32 panel with ``--compute_dtype float32``.

Tolerances (the training slice's, ROADMAP "Tolerances"): weights atol
2e-5, losses rtol 2e-4, Sharpes atol 1e-3, gradients atol 2e-5 where
|g| > 1e-6 (ROADMAP C6: an entry within a few eps of 0 is summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch import evaluate_ensemble
from deeplearninginassetpricing_paperreplication_torch.models.gan import GAN
from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble import (
    ensemble_metrics,
    member_weights,
)
from deeplearninginassetpricing_paperreplication_torch.training import (
    steps,
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
from deeplearninginassetpricing_paperreplication_tpu.training import (
    steps as jsteps,
)
from deeplearninginassetpricing_paperreplication_tpu.training.trainer import (
    train_3phase as jtrain_3phase,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    ExecutionConfig as JExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    TrainConfig as JTrainConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
INTERP_BF16 = JExecutionConfig(pallas_ffn="on", interpret=True,
                               compute_dtype="float32", block_stocks=16,
                               bf16_panel=True)
PHASES = ("unconditional", "moment", "conditional")
SCHEDULE = dict(num_epochs_unc=2, num_epochs_moment=1, num_epochs=2,
                ignore_epoch=0)


def _kw(ds):
    return dict(macro_feature_dim=ds.macro_feature_dim,
                individual_feature_dim=ds.individual_feature_dim,
                hidden_dim=(8, 8), num_units_rnn=(4,), dropout=0.0)


def _jbatch(ds):
    return {k: jnp.asarray(v) for k, v in ds.full_batch().items()}


def _bf16_panel(batch):
    """`batch` with the bf16 feature-major panel a kernel-route
    ``prepare_batch`` stores (prepared by hand: the CPU route does not)."""
    return dict(batch, individual_t=batch["individual"].permute(
        0, 2, 1).contiguous().to(torch.bfloat16))


def _tbatch(ds, bf16=True):
    b = {k: torch.from_numpy(np.asarray(v, np.float32))
         for k, v in ds.full_batch().items()}
    return _bf16_panel(b) if bf16 else b


def _pair(ds, seed=3):
    kw = _kw(ds)
    jgan = JGAN(JGANConfig(**kw), INTERP_BF16)
    params = jgan.init(jax.random.key(seed))
    cfg = GANConfig(**kw)
    sd = state_dict_from_jax_params(jax.device_get(params), cfg)
    return jgan, params, GAN.from_state_dict(cfg, sd, CPU_F32)


@pytest.mark.parametrize("phase", PHASES)
def test_forward_and_grads_on_the_bf16_panel_match_jax(splits, phase):
    train = splits[0]
    jgan, params, gan = _pair(train)
    jb = jgan.prepare_batch(_jbatch(train))
    assert jb["individual_t"].dtype == jnp.bfloat16
    tb = _tbatch(train)
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
        np.testing.assert_allclose(float(out[k].detach()), float(jout[k]),
                                   rtol=2e-4, atol=1e-9, err_msg=k)
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
        big = np.abs(r) > 1e-6
        np.testing.assert_allclose(g.numpy()[big], r[big], atol=2e-5,
                                   err_msg=n)


def test_moments_read_the_bf16_panel_like_jax(splits):
    """The default moment net on a bf16 panel: the JAX MomentNet's einsum
    (f32 operands on the CPU) against the port's; and on the card the same
    path rounds its operands to the compute dtype, which the CPU cannot
    show, so here bf16 compute must read as f32 too."""
    test = splits[2]
    jgan, params, gan = _pair(test, seed=4)
    jb = jgan.prepare_batch(_jbatch(test))
    h_j = np.asarray(jgan.moments(params, jb))
    np.testing.assert_allclose(gan.moments(_tbatch(test)).numpy(), h_j,
                               atol=2e-5)
    bf16 = GAN.from_state_dict(gan.cfg, gan.module.state_dict(),
                               ExecutionConfig(device="cpu"))
    assert torch.equal(bf16.moments(_tbatch(test)),
                       gan.moments(_tbatch(test)))
    # the f32 panel takes the concat-free MomentNet, as JAX's does
    h_f = np.asarray(jgan.moments(params, _jbatch(test)))
    np.testing.assert_allclose(gan.moments(_tbatch(test, bf16=False))
                               .numpy(), h_f, atol=2e-5)


@pytest.fixture(scope="module")
def trained_pair(splits):
    """The JAX trainer on its bf16 panel and the port's on the same panel,
    from the same start, 2/1/2 epochs."""
    train, valid, test = splits
    kw = _kw(train)
    jgan, jparams, jhist, _ = jtrain_3phase(
        JGANConfig(**kw), _jbatch(train), _jbatch(valid), _jbatch(test),
        tcfg=JTrainConfig(**SCHEDULE), seed=5, verbose=False,
        exec_cfg=INTERP_BF16)
    cfg = GANConfig(**kw)
    start = state_dict_from_jax_params(
        jax.device_get(jgan.init(jax.random.key(5))), cfg)
    _, params, hist, _ = train_3phase(
        cfg, _tbatch(train), _tbatch(valid), _tbatch(test),
        tcfg=TrainConfig(**SCHEDULE), seed=5, verbose=False,
        exec_cfg=CPU_F32, state_dict=start)
    return jhist, jax.device_get(jparams), hist, params, cfg


def test_train_3phase_on_the_bf16_panel_matches_jax(trained_pair):
    jhist, jparams, hist, params, cfg = trained_pair
    assert list(hist["phase"]) == list(jhist["phase"])
    for k in ("train_loss", "valid_loss", "test_loss"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=2e-4, atol=1e-9,
                                   err_msg=k)
    for k in ("train_sharpe", "valid_sharpe", "test_sharpe"):
        np.testing.assert_allclose(hist[k], jhist[k], atol=1e-3, err_msg=k)
    for label in ("unc", "cond"):
        sel = np.asarray(hist["phase"]) == label
        assert np.argmax(hist["valid_sharpe"][sel]) == np.argmax(
            np.asarray(jhist["valid_sharpe"])[sel])
    ref = state_dict_from_jax_params(jparams, cfg)
    for k in ref:
        np.testing.assert_allclose(params[k].numpy(), ref[k].numpy(),
                                   atol=2e-5, err_msg=k)


def test_evaluation_rebuilds_the_f32_panel(splits):
    """member_weights and ensemble_metrics on a batch prepared for training
    (its bf16 panel) are bit for bit the f32 batch's: evaluation does not
    depend on the training-side storage (the JAX package's
    ``member_weights``)."""
    test = splits[2]
    kw = _kw(test)
    jgan = JGAN(JGANConfig(**kw))
    stacked = stacked_state_dict_from_jax_params(
        jax.device_get(jax.vmap(jgan.init)(
            jax.random.split(jax.random.key(6), 3))), GANConfig(**kw))
    cfg = GANConfig(**kw)
    bf16, f32 = _tbatch(test), _tbatch(test, bf16=False)
    for ex in (CPU_F32, ExecutionConfig(device="cpu")):
        assert torch.equal(member_weights(cfg, stacked, bf16, ex),
                           member_weights(cfg, stacked, f32, ex))
        a = ensemble_metrics(cfg, stacked, bf16, ex)
        b = ensemble_metrics(cfg, stacked, f32, ex)
        assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("dtype,panel", [("bfloat16", True),
                                         ("float32", False)])
def test_cli_execution_config_ties_the_panel_to_compute(dtype, panel):
    args = evaluate_ensemble.build_arg_parser().parse_args(
        ["--data_dir", "d", "--checkpoint_dirs", "r", "--device", "cpu",
         "--compute_dtype", dtype])
    ex = evaluate_ensemble.execution_config(args)
    assert ex.bf16_panel is panel and ex.compute_dtype == dtype
    cfg = GANConfig(macro_feature_dim=3, individual_feature_dim=5,
                    hidden_dim=(8, 8))
    # the card's route stores the bf16 panel exactly with bf16 compute
    assert ExecutionConfig(compute_dtype=dtype, bf16_panel=ex.bf16_panel,
                           device="cuda").stores_bf16_panel(cfg) is panel
