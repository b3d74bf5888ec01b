"""The PyTorch port's models against the JAX package's, with the same
weights: the macro LSTM's scan and step, SDFNet and MomentNet through the
weight bridge, and the reference checkpoint loaded strictly.

Tolerances (ROADMAP.md, from the JAX package's own torch parity): weights
and moments atol 2e-5 in f32; the LSTM states atol 1e-6 (a few dozen f32
cell steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.gan import GAN
from deeplearninginassetpricing_paperreplication_torch.models.networks import (
    AssetPricingModule,
    init_params,
)
from deeplearninginassetpricing_paperreplication_torch.models.recurrent import (
    stacked_lstm_scan,
    stacked_lstm_step,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    load_checkpoint_dir,
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models import (
    recurrent as jrec,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.training import (
    checkpoint as jckpt,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")


def _tbatch(ds):
    """A JAX-package PanelDataset's batch as the port's tensors."""
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in ds.full_batch().items()}


def _lstm_layers(rng, M, H, n_layers):
    """numpy params per layer, in both packages' naming."""
    layers = []
    for li in range(n_layers):
        i = M if li == 0 else H
        k = H ** -0.5
        layers.append({n: rng.uniform(-k, k, s).astype(np.float32)
                       for n, s in (("w_ih", (4 * H, i)), ("w_hh", (4 * H, H)),
                                    ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))})
    return layers


@pytest.mark.parametrize("n_layers", [1, 2])
def test_lstm_scan_and_step_match_jax(n_layers):
    rng = np.random.default_rng(0)
    T, M, H = 20, 6, 4
    layers = _lstm_layers(rng, M, H, n_layers)
    x = rng.standard_normal((T + 1, M)).astype(np.float32)
    tree = {f"{n}_l{li}": jnp.asarray(v) for li, p in enumerate(layers)
            for n, v in p.items()}
    hs_j, carries_j = jrec.stacked_lstm_scan(tree, jnp.asarray(x[:T]),
                                             n_layers)
    h_j, _ = jrec.stacked_lstm_step(tree, carries_j, jnp.asarray(x[T]),
                                    n_layers)
    tl = [{n: torch.from_numpy(v) for n, v in p.items()} for p in layers]
    hs_p, carries_p = stacked_lstm_scan(tl, torch.from_numpy(x[:T]))
    h_p, _ = stacked_lstm_step(tl, carries_p, torch.from_numpy(x[T]))
    np.testing.assert_allclose(hs_p.numpy(), np.asarray(hs_j), atol=1e-6)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), atol=1e-6)
    for (h, c), (hj, cj) in zip(carries_p, carries_j):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-6)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-6)
    # the step continues the scan: == re-scanning one month more
    hs_full, _ = stacked_lstm_scan(tl, torch.from_numpy(x))
    np.testing.assert_allclose(h_p.numpy(), hs_full[-1].numpy(), atol=1e-6)


# hidden (8, 7, 6): a mid stack of two ragged layers; hidden_dim_moment
# (5,): the moment net's split first layer feeding a hidden layer; no
# hidden layer: the output projection is the split layer; no LSTM: the raw
# macro is the per-period state
ARCHS = [dict(hidden_dim=(8, 8)),
         dict(hidden_dim=(8, 7, 6), hidden_dim_moment=(5,)),
         dict(hidden_dim=()),
         dict(hidden_dim=(8,), use_rnn=False)]


@pytest.mark.parametrize("arch", ARCHS, ids=["paper_shape", "deeper",
                                             "no_hidden", "no_lstm"])
def test_sdf_and_moment_nets_match_jax(splits, arch):
    _, _, test = splits
    kw = dict(macro_feature_dim=test.macro_feature_dim,
              individual_feature_dim=test.individual_feature_dim,
              num_units_rnn=(4,), dropout=0.0, **arch)
    jgan = JGAN(JGANConfig(**kw))
    params = jgan.init(jax.random.key(3))
    batch = {k: jnp.asarray(v) for k, v in test.full_batch().items()}
    w_j = np.asarray(jgan.weights(params, batch))
    h_j = np.asarray(jgan.moments(params, batch))
    cfg = GANConfig(**kw)
    sd = state_dict_from_jax_params(jax.device_get(params), cfg)
    gan = GAN.from_state_dict(cfg, sd, CPU_F32)
    tb = _tbatch(test)
    np.testing.assert_allclose(gan.weights(tb).numpy(), w_j, atol=2e-5)
    np.testing.assert_allclose(gan.moments(tb).numpy(), h_j, atol=2e-5)
    np.testing.assert_allclose(
        gan.sdf_factor(tb).numpy(),
        np.asarray(jgan.sdf_factor(params, batch)), atol=2e-5)


def test_bridge_roundtrips_the_reference_state_dict():
    """torch .pt → JAX tree (the JAX package's importer) → the port's
    bridge gives back the same tensors, key for key."""
    cfg, sd = load_checkpoint_dir("ref_runs/small120x500")
    jcfg = JGANConfig.from_dict(cfg.to_dict())
    tree = jckpt.params_from_torch_state_dict(sd, jcfg)
    back = state_dict_from_jax_params(tree, cfg)
    assert list(back) == list(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_reference_checkpoint_loads_strictly_and_matches_jax():
    """ref_runs/small120x500 (120x500x46, macro 8) into the port with
    load_state_dict(strict=True): the same weights as the JAX package's
    load_torch_checkpoint on data/synthetic_demo's test split."""
    from deeplearninginassetpricing_paperreplication_tpu.data.panel import (
        load_splits,
    )

    cfg, sd = load_checkpoint_dir("ref_runs/small120x500")
    module = AssetPricingModule(cfg)
    missing = module.load_state_dict(sd, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    jgan, jparams = jckpt.load_torch_checkpoint(
        "ref_runs/small120x500/best_model_sharpe.pt")
    _, _, test = load_splits("data/synthetic_demo")
    batch = {k: jnp.asarray(v) for k, v in test.full_batch().items()}
    w_j = np.asarray(jgan.normalized_weights(jparams, batch))
    gan = GAN(cfg, CPU_F32, module)
    w_p = gan.normalized_weights(_tbatch(test)).numpy()
    np.testing.assert_allclose(w_p, w_j, atol=2e-5)
    np.testing.assert_allclose(np.abs(w_p).sum(axis=1)[test.mask.any(1)], 1.0,
                               rtol=1e-5)


def test_init_params_is_seeded_and_bounded():
    cfg = GANConfig(macro_feature_dim=3, individual_feature_dim=5,
                    hidden_dim=(8,), dropout=0.0)
    a, b = AssetPricingModule(cfg), AssetPricingModule(cfg)
    init_params(a, torch.Generator().manual_seed(7))
    init_params(b, torch.Generator().manual_seed(7))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    w = dict(a.named_parameters())["sdf_net.fc_layers.0.weight"]
    assert w.abs().max() <= cfg.sdf_input_dim ** -0.5


def test_training_mode_dropout_draws_from_the_seed():
    """Training mode is a dropout seed (the JAX package's rng), not the
    module flag: with a seed the SDF net drops units reproducibly; without
    one, even a module in .train() runs the eval forward."""
    cfg = GANConfig(macro_feature_dim=3, individual_feature_dim=5,
                    hidden_dim=(8,), dropout=0.05)
    module = AssetPricingModule(cfg).train()
    init_params(module, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    macro = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    indiv = torch.from_numpy(rng.standard_normal((4, 60, 5)).astype(
        np.float32))
    mask = torch.ones(4, 60)
    a = module.sdf_net(macro, indiv, mask, seed=5)
    b = module.sdf_net(macro, indiv, mask, seed=5)
    c = module.sdf_net(macro, indiv, mask, seed=6)
    ev = module.sdf_net(macro, indiv, mask)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, ev)
    torch.testing.assert_close(ev, module.eval().sdf_net(macro, indiv, mask))


def test_moment_output_params_split_matches_jax(splits):
    """The moment net's output layer split [macro, individual], as the
    JAX package's moment_output_params reads it."""
    from deeplearninginassetpricing_paperreplication_torch.models.networks \
        import moment_output_params
    from deeplearninginassetpricing_paperreplication_tpu.models.networks \
        import moment_output_params as jmop

    _, _, test = splits
    kw = dict(macro_feature_dim=test.macro_feature_dim,
              individual_feature_dim=test.individual_feature_dim,
              hidden_dim=(8,), dropout=0.0)
    jgan = JGAN(JGANConfig(**kw))
    params = jgan.init(jax.random.key(4))
    cfg = GANConfig(**kw)
    gan = GAN.from_state_dict(
        cfg, state_dict_from_jax_params(jax.device_get(params), cfg),
        CPU_F32)
    for a, b in zip(moment_output_params(gan.module, cfg),
                    jmop(params, JGANConfig(**kw))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
