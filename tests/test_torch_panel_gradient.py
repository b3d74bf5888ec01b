"""The panel gradient of the GAN: the characteristic sensitivity
∂loss/∂individual, the port against the JAX package, on the CPU.

The same start (the JAX ``GAN.init`` params through the weight bridge), the
fixture panel, f32, dropout 0, eval forward: ``torch.autograd.grad`` of the
port's ``GAN.forward`` (one model) and ``GAN.forward_members`` (three
members) losses w.r.t. ``batch["individual"]`` against ``jax.grad`` of the
JAX ``GAN.forward`` under the Pallas interpreter (its fused SDF-FFN and
fused conditional-EM, whose ``_dx_kernel``s give the panel's cotangent;
members through ``jax.vmap``). The port's gradient runs through its plain
panel cotangents, which a CPU tensor takes. Tolerance: f32, rtol 1e-4 with
atol 1e-5·max|ref|; only the summation order differs.

Parameters stay frozen, so only the panel cotangents run: the plain
versions' calls are counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.gan import GAN
from deeplearninginassetpricing_paperreplication_torch.ops import cond_em as C
from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    stacked_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    ExecutionConfig as JExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
INTERP = JExecutionConfig(pallas_ffn="on", interpret=True,
                          compute_dtype="float32", block_stocks=16,
                          bf16_panel=False)


def _cfg_kw(ds):
    return dict(macro_feature_dim=ds.macro_feature_dim,
                individual_feature_dim=ds.individual_feature_dim,
                hidden_dim=(8, 8), num_units_rnn=(4,), dropout=0.0)


def _close(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def _jax_grad(jgan, params, batch, phase, members=False):
    """jax.grad of the (member-summed) loss w.r.t. batch["individual"]."""
    def loss(ind):
        b = jgan.prepare_batch(dict(batch, individual=ind))
        if not members:
            return jgan.forward(params, b, phase=phase)["loss"]
        return jnp.sum(jax.vmap(lambda p: jgan.forward(p, b, phase=phase)[
            "loss"])(params))
    return np.asarray(jax.grad(loss)(batch["individual"]))


def _port_grad(fn, batch):
    ind = batch["individual"].clone().requires_grad_()
    (dx,) = torch.autograd.grad(fn(dict(batch, individual=ind)), ind)
    return dx.numpy()


@pytest.mark.parametrize("phase", ["conditional", "unconditional"])
def test_one_model_panel_gradient_matches_jax(splits, phase):
    train = splits[0]
    jgan = JGAN(JGANConfig(**_cfg_kw(train)), INTERP)
    params = jgan.init(jax.random.key(3))
    cfg = GANConfig(**_cfg_kw(train))
    gan = GAN.from_state_dict(
        cfg, state_dict_from_jax_params(jax.device_get(params), cfg),
        CPU_F32)
    for p in gan.module.parameters():
        p.requires_grad_(False)
    batch = {k: np.asarray(v, np.float32)
             for k, v in train.full_batch().items()}
    ref = _jax_grad(jgan, params, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, phase)
    got = _port_grad(lambda b: gan.forward(b, phase)["loss"],
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == batch["individual"].shape
    _close(got, ref)


@pytest.mark.parametrize("phase", ["conditional", "unconditional"])
def test_member_panel_gradient_matches_jax_vmap(splits, phase):
    """Three members over one panel: the gradient of the summed losses,
    forward_members against the JAX forward vmapped over the members."""
    train = splits[0]
    jgan = JGAN(JGANConfig(**_cfg_kw(train)), INTERP)
    vparams = jax.vmap(jgan.init)(jax.random.split(jax.random.key(5), 3))
    cfg = GANConfig(**_cfg_kw(train))
    stacked = stacked_state_dict_from_jax_params(jax.device_get(vparams),
                                                 cfg)
    gan = GAN(cfg, CPU_F32)
    batch = {k: np.asarray(v, np.float32)
             for k, v in train.full_batch().items()}
    ref = _jax_grad(jgan, vparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, phase,
                    members=True)
    got = _port_grad(
        lambda b: gan.forward_members(stacked, b, phase)["loss"].sum(),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, ref)


def test_frozen_parameters_run_only_the_panel_cotangents(splits,
                                                         monkeypatch):
    """A sensitivity pass with every parameter frozen: the conditional loss
    runs the FFN's panel cotangent and not its parameter backward; the
    conditional-EM runs its panel cotangent and its backward (for dxr, the
    chain back into the weights) — once each, as on the card."""
    calls = {}
    for mod, names in ((K, ("sdf_ffn_reference", "sdf_ffn_bwd_reference",
                            "sdf_ffn_dx_reference")),
                       (C, ("cond_em_reference", "cond_em_bwd_reference",
                            "cond_em_dx_reference"))):
        for name in names:
            def counted(*a, _f=getattr(mod, name), _n=name, **kw):
                calls[_n] = calls.get(_n, 0) + 1
                return _f(*a, **kw)
            monkeypatch.setattr(mod, name, counted)
    train = splits[0]
    cfg = GANConfig(**_cfg_kw(train))
    gan = GAN(cfg, CPU_F32)
    for p in gan.module.parameters():
        p.requires_grad_(False)
    batch = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in train.full_batch().items()}
    got = _port_grad(lambda b: gan.forward(b, "conditional")["loss"], batch)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert calls == {"sdf_ffn_reference": 1, "sdf_ffn_dx_reference": 1,
                     "cond_em_reference": 1, "cond_em_bwd_reference": 1,
                     "cond_em_dx_reference": 1}
    calls.clear()
    # the weights against a random cotangent: the FFN's panel cotangent only
    cot = torch.from_numpy(np.random.default_rng(0).standard_normal(
        batch["mask"].shape).astype(np.float32))
    _port_grad(lambda b: (gan.forward(b, "unconditional")["weights"]
                          * cot).sum(), batch)
    assert calls == {"sdf_ffn_reference": 1, "sdf_ffn_dx_reference": 1}
