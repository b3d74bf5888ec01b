"""The port's joint (1-phase) trainer against the JAX package's, on the CPU.

* ``_plateau_update`` on a 60-step metric trace, step for step against
  torch's own ``ReduceLROnPlateau`` and the JAX ``_plateau_update``:
  exact.
* ``joint_train`` from the JAX init (bridged through
  ``state_dict_from_jax_params``) against the JAX ``joint_train``: f32,
  dropout 0, T = 10, N = 24, F = 4, M = 3, hidden (6,), 12 epochs,
  patience 2, so the learning rate halves three times (to 1.25e-4). Every
  history key every epoch (losses rtol 2e-4, Sharpes rtol 1e-3, ``lr``
  exact), final params atol 2e-5.
* With dropout, two runs from one seed repeat bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.gan import GAN
from deeplearninginassetpricing_paperreplication_torch.training import joint
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.training import (
    joint as jjoint,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
T, N, F, M = 10, 24, 4, 3


def small_batch(seed=0):
    """A masked panel made with numpy from a seed (both packages' input)."""
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


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _cfg_kw(dropout=0.0):
    return dict(macro_feature_dim=M, individual_feature_dim=F,
                hidden_dim=(6,), dropout=dropout)


def _metric_trace():
    """60 metrics: rises, plateaus, a dip, ties within the threshold,
    negative values and a late improvement."""
    rng = np.random.default_rng(5)
    up = np.linspace(0.1, 0.5, 12)
    flat = 0.5 + rng.normal(0, 1e-6, 15)  # within 1e-4 relative of best
    dip = np.linspace(0.4, -0.3, 10)
    neg = -0.3 + rng.normal(0, 0.05, 13)
    late = np.linspace(0.45, 0.6, 10)
    return np.concatenate([up, flat, dip, neg, late]).astype(np.float32)


def test_plateau_update_matches_torch_and_jax():
    trace = _metric_trace()
    assert trace.size == 60
    factor, patience, lr = 0.5, 3, 1e-3
    ref_opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=lr)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        ref_opt, mode="max", factor=factor, patience=patience,
        threshold=1e-4)
    scale = torch.tensor(1.0)
    best = torch.tensor(-np.inf, dtype=torch.float32)
    bad = torch.tensor(0, dtype=torch.int32)
    jscale, jbest, jbad = jnp.float32(1.0), jnp.float32(-np.inf), jnp.int32(0)
    for m in trace:
        sched.step(float(m))
        scale, best, bad = joint._plateau_update(
            scale, best, bad, torch.tensor(m), factor, patience, 1e-4)
        jscale, jbest, jbad = jjoint._plateau_update(
            jscale, jbest, jbad, jnp.float32(m), factor, patience, 1e-4)
        # torch keeps lr in float64; factor 0.5's powers are exact in f32
        assert float(scale) == pytest.approx(
            ref_opt.param_groups[0]["lr"] / lr, rel=1e-12)
        assert float(scale) == float(jscale)
        assert float(best) == float(jbest)
        assert int(bad) == int(jbad) == sched.num_bad_epochs
    assert float(scale) < 1.0  # the trace did decay the rate


def test_joint_train_matches_jax():
    batch = small_batch()
    jgan = JGAN(JGANConfig(**_cfg_kw()))
    params = jgan.init(jax.random.key(0))
    jparams, jhist = jjoint.joint_train(jgan, params, batch, batch,
                                        num_epochs=12, plateau_patience=2)
    cfg = GANConfig(**_cfg_kw())
    gan = GAN.from_state_dict(
        cfg, state_dict_from_jax_params(jax.device_get(params), cfg),
        CPU_F32)
    hist = joint.joint_train(gan, _tb(batch), _tb(batch), num_epochs=12,
                             plateau_patience=2)
    assert set(hist) == set(jhist) == set(joint.JOINT_KEYS)
    assert jhist["lr"][-1] == np.float32(1.25e-4)
    np.testing.assert_array_equal(hist["lr"], jhist["lr"])
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=2e-4, err_msg=k)
    for k in ("train_sharpe", "valid_sharpe"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-3, err_msg=k)
    ref = state_dict_from_jax_params(jax.device_get(jparams), cfg)
    for name, p in gan.module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=2e-5,
                                   err_msg=name)


def test_joint_train_with_dropout_repeats_bit_for_bit():
    batch = _tb(small_batch(1))
    cfg = GANConfig(**_cfg_kw(dropout=0.2))
    runs = []
    for _ in range(2):
        gan = GAN(cfg, CPU_F32)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(11)
            for p in gan.module.parameters():
                p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
        hist = joint.joint_train(gan, batch, batch, num_epochs=6, seed=7)
        runs.append((hist, {k: v.clone() for k, v in
                            gan.module.state_dict().items()}))
    (h0, p0), (h1, p1) = runs
    for k in h0:
        assert np.isfinite(h0[k]).all(), k
        np.testing.assert_array_equal(h0[k], h1[k], err_msg=k)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
