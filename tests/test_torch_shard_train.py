"""Stock-sharded training (ROADMAP A10a) against the JAX package, on CPU
gloo ranks.

The same numpy-seeded inputs and weights (the JAX ``GAN.init`` params
through ``state_dict_from_jax_params``), f32, dropout 0, go through the
JAX package on its 8-device CPU mesh (GSPMD's psums; the kernels' sharded
wrappers under ``shard_map`` in the Pallas interpreter) and through the
port on 2 and 4 ranks (``test_torch_shard_ranks.py``'s workers; each world
spawned once per module):

* the losses of a padded toy panel, rtol 1e-5 (as ``tests/test_losses.py``
  holds JAX's sharded losses);
* one step of each phase: the loss rtol 2e-5, the raw gradients of every
  trainable parameter atol 2e-5 where |g| > 1e-6 (a gradient `world` times
  too large fails this), ``grad_norm`` rtol 1e-5, the parameters after the
  step atol 2e-5 (where the gradient is not within a few eps of 0, as
  ``test_torch_training.py`` compares them), every rank's bytes equal;
* each rank's plain FFN and conditional-EM against JAX's
  ``fused_sdf_ffn_sharded`` and ``fused_conditional_em_sharded``;
* a rank's dropout masks: the unsharded masks' columns [a, b) bit for bit;
* a short ``train_3phase`` at world size 2 within 1e-3 rel of the
  unsharded run, the ranks bit for bit equal, and a mid-phase resume bit
  for bit the uninterrupted sharded run; world size 1 bit for bit the
  unsharded route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from deeplearninginassetpricing_paperreplication_torch.models.gan import GAN
from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    collectives,
)
from deeplearninginassetpricing_paperreplication_torch.training import steps
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (  # noqa: E501
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.training.trainer import (  # noqa: E501
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
from deeplearninginassetpricing_paperreplication_tpu.ops import losses as JL
from deeplearninginassetpricing_paperreplication_tpu.ops.pallas_ffn import (
    fused_sdf_ffn_sharded,
)
from deeplearninginassetpricing_paperreplication_tpu.ops.pallas_moment import (  # noqa: E501
    fused_conditional_em_sharded,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    partition as jpartition,
)
from deeplearninginassetpricing_paperreplication_tpu.training import (
    steps as jsteps,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)
from test_torch_shard_ranks import (
    losses_steps_worker,
    spawn,
    train_worker,
)

PHASES = ("unconditional", "moment", "conditional")
CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
T, F, H, N = 6, 5, 8, 32  # the kernels' toy panel (N divides 2, 4 and 8)


def _cfg_kw(ds):
    return dict(macro_feature_dim=ds.macro_feature_dim,
                individual_feature_dim=ds.individual_feature_dim,
                hidden_dim=(8, 8), num_units_rnn=(4,),
                num_condition_moment=4, dropout=0.0)


def _toy(rng, T=6, N=30, K=3, pad_to=32):
    """A ragged toy panel padded with masked zeros to `pad_to` stocks."""
    m = (rng.random((T, N)) > 0.25).astype(np.float32)
    w = (rng.standard_normal((T, N)) * m).astype(np.float32)
    R = (0.1 * rng.standard_normal((T, N)) * m).astype(np.float32)
    h = np.tanh(rng.standard_normal((K, T, N))).astype(np.float32)
    pad = ((0, 0), (0, pad_to - N))
    return dict(w=np.pad(w, pad), R=np.pad(R, pad), m=np.pad(m, pad),
                h=np.pad(h, ((0, 0),) + pad), n_assets=float(N))


def _ffn_inputs(rng):
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    k1 = f32(rng.standard_normal((F, H)) / np.sqrt(F))
    w2 = f32(rng.standard_normal((H, H)) / np.sqrt(H))
    b2 = f32(0.1 * rng.standard_normal(H))
    ko = f32(rng.standard_normal((H, 1)) / np.sqrt(H))
    bo = f32(0.1 * rng.standard_normal(1))
    return dict(
        x=f32(rng.standard_normal((T, F, N))),
        zp=f32(0.3 * rng.standard_normal((T, H))), k1=k1, w2=w2, b2=b2,
        ko=ko, bo=bo, seed=11, rate=0.1,
        cem=dict(x=f32(rng.standard_normal((T, F, N))),
                 zpm=f32(0.3 * rng.standard_normal((T, 4))),
                 xr=f32(0.2 * rng.standard_normal((T, N))),
                 tinv=f32(1.0 / rng.integers(1, T + 1, N)),
                 ks=f32(rng.standard_normal((F, 4)) / np.sqrt(F))))


@pytest.fixture(scope="module")
def inputs(splits):
    """Everything the ranks read, and the JAX start they are held to."""
    train = splits[0]
    rng = np.random.default_rng(22)
    jgan = JGAN(JGANConfig(**_cfg_kw(train)))
    params = jgan.init(jax.random.key(3))
    cfg = GANConfig(**_cfg_kw(train))
    fi = _ffn_inputs(rng)
    t = lambda a: np.ascontiguousarray(a)  # noqa: E731
    port_ffn = dict(x=fi["x"], zp=fi["zp"][None], k1T=t(fi["k1"].T[None]),
                    mids=[(t(fi["w2"].T[None]), fi["b2"][None])],
                    kout=t(fi["ko"][:, 0][None]), bout=fi["bo"],
                    seed=fi["seed"], rate=fi["rate"])
    return dict(
        toy=_toy(rng), cfg=_cfg_kw(train), batch=train.full_batch(),
        state_dict=state_dict_from_jax_params(jax.device_get(params), cfg),
        ffn=port_ffn, cem=fi["cem"], jgan=jgan, params=params, raw=fi)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, inputs, tmp_path_factory):
    """(world, [each rank's outputs]) of one spawn of `world` ranks."""
    world = request.param
    wd = tmp_path_factory.mktemp(f"shard_world{world}")
    torch.save({k: v for k, v in inputs.items()
                if k not in ("jgan", "params", "raw")}, wd / "in.pt")
    spawn(losses_steps_worker, world, wd)
    return world, [torch.load(wd / f"out{r}.pt", weights_only=False)
                   for r in range(world)]


@pytest.fixture(scope="module")
def jax_steps(inputs):
    """JAX's loss, raw gradient, grad norm and parameters after one step
    of each phase, on the batch stock-sharded over the 8-device mesh."""
    jgan, params = inputs["jgan"], inputs["params"]
    mesh = jpartition.create_mesh(8)
    batch = jpartition.shard_batch(
        {k: jnp.asarray(v) for k, v in inputs["batch"].items()}, mesh)
    p_r = jax.device_put(params, jpartition.replicated(mesh))
    cfg = GANConfig(**inputs["cfg"])
    out = {}
    for phase in PHASES:
        key = jsteps.trainable_key(phase)
        tx = jsteps.make_optimizer(1e-3)
        step = jax.jit(jsteps.make_train_step(jgan, phase, tx))
        new, _, met = step(p_r, jax.device_put(
            tx.init(params[key]), jpartition.replicated(mesh)), batch, None)
        grad = jax.jit(jax.grad(lambda sub: jgan.forward(
            dict(p_r, **{key: sub}), batch, phase=phase)["loss"]))(p_r[key])
        full = dict(jax.device_get(params), **{key: jax.device_get(grad)})
        out[phase] = dict(
            loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
            grads=state_dict_from_jax_params(full, cfg),
            params=state_dict_from_jax_params(jax.device_get(new), cfg))
    return out


def test_sharded_losses_match_the_jax_mesh(ranks, inputs):
    """Each rank's losses of the padded toy panel (n_assets = 30 of 32)
    equal JAX's on the 8-device mesh, rtol 1e-5; F too."""
    world, outs = ranks
    toy = inputs["toy"]
    mesh = jpartition.create_mesh(8)
    sh2 = jpartition.named_sharding(mesh, JP(None, "stocks"))
    sh3 = jpartition.named_sharding(mesh, JP(None, None, "stocks"))
    w, R, m = (jax.device_put(jnp.asarray(toy[k]), sh2)
               for k in ("w", "R", "m"))
    h = jax.device_put(jnp.asarray(toy["h"]), sh3)
    n = toy["n_assets"]
    ref = {
        "F": jax.jit(JL.portfolio_returns)(w, R, m),
        "unconditional": jax.jit(lambda *a: JL.unconditional_loss(
            *a, n_assets=n)[0])(w, R, m),
        "conditional": jax.jit(lambda *a: JL.conditional_loss(
            *a, n_assets=n)[0])(w, R, m, h),
        "residual": jax.jit(JL.residual_loss)(w, R, m),
    }
    for o in outs:
        for k, v in ref.items():
            np.testing.assert_allclose(o["losses"][k].numpy(),
                                       np.asarray(v), rtol=1e-5, atol=1e-9,
                                       err_msg=f"world {world}: {k}")


@pytest.mark.parametrize("phase", PHASES)
def test_sharded_step_loss_gradients_and_norm_match_jax(ranks, jax_steps,
                                                        phase):
    """The loss, the raw all-reduced gradient of every trainable parameter
    and the step's grad norm equal ``jax.grad`` and JAX's step on the
    sharded batch."""
    world, outs = ranks
    ref = jax_steps[phase]
    for o in outs:
        s = o["steps"][phase]
        np.testing.assert_allclose(float(s["loss"]), ref["loss"], rtol=2e-5)
        np.testing.assert_allclose(float(s["step_loss"]), ref["loss"],
                                   rtol=2e-5)
        np.testing.assert_allclose(float(s["grad_norm"]), ref["grad_norm"],
                                   rtol=1e-5)
        assert s["grads"]
        for name, g in s["grads"].items():
            r = ref["grads"][name].numpy()
            big = np.abs(r) > 1e-6
            np.testing.assert_allclose(g.numpy()[big], r[big], atol=2e-5,
                                       rtol=0, err_msg=f"world {world} {name}")


@pytest.mark.parametrize("phase", PHASES)
def test_params_after_one_sharded_step_match_jax(ranks, jax_steps, phase):
    """The parameters after one step of the phase, atol 2e-5 (Adam's first
    step moves a parameter by about lr·g/(|g| + 1e-8): where the gradient
    is within a few eps of 0 its rounding decides the step, so those
    entries are not compared), and every rank's bytes equal."""
    world, outs = ranks
    ref = jax_steps[phase]
    gn = max(ref["grad_norm"], 1.0)
    for o in outs:
        for k, v in o["steps"][phase]["params"].items():
            ok = np.abs(ref["grads"][k].numpy()) / gn > 1e-6
            np.testing.assert_allclose(v.numpy()[ok], ref["params"][k].numpy()
                                       [ok], atol=2e-5, err_msg=k)
            assert torch.equal(v, outs[0]["steps"][phase]["params"][k])


def test_per_rank_plain_kernels_match_jax_sharded_wrappers(ranks, inputs):
    """Each rank's plain FFN and conditional-EM on its stocks equal JAX's
    ``fused_sdf_ffn_sharded`` and ``fused_conditional_em_sharded`` (the
    Pallas interpreter under shard_map) on a mesh of `world` devices."""
    world, outs = ranks
    raw = inputs["raw"]
    mesh = jpartition.create_mesh(world)
    w = fused_sdf_ffn_sharded(
        jnp.asarray(raw["x"]), jnp.asarray(raw["zp"]),
        [(jnp.asarray(raw["k1"]), None),
         (jnp.asarray(raw["w2"]), jnp.asarray(raw["b2"]))],
        jnp.asarray(raw["ko"]), jnp.asarray(raw["bo"]), mesh, "stocks",
        interpret=True, compute_dtype="float32", block_stocks=16)
    c = raw["cem"]
    em = fused_conditional_em_sharded(
        *(jnp.asarray(c[k]) for k in ("x", "zpm", "xr", "tinv", "ks")),
        mesh, "stocks", interpret=True, compute_dtype="float32",
        block_stocks=16)
    w, em = np.asarray(w), np.asarray(em)
    for o in outs:
        a, b = o["span"]
        np.testing.assert_allclose(o["ffn"][0].numpy(), w[:, a:b],
                                   atol=2e-5 * np.abs(w).max())
        np.testing.assert_allclose(o["cem"].numpy(), em[:, a:b],
                                   atol=2e-5 * np.abs(em).max())


def test_rank_dropout_masks_are_the_unsharded_span(ranks, inputs):
    """Rank r's masks (the global stock offset a in the hash) are the
    unsharded masks' columns [a, b) bit for bit, and its FFN with dropout
    the unsharded FFN's columns (the same zeros)."""
    world, outs = ranks
    f = inputs["ffn"]
    t = torch.as_tensor
    full = K.sdf_ffn(t(f["x"]), t(f["zp"]), t(f["k1T"]),
                     [tuple(t(x) for x in wb) for wb in f["mids"]],
                     t(f["kout"]), t(f["bout"]), seed=f["seed"],
                     dropout_rate=f["rate"], compute_dtype="float32",
                     kernel="off")
    for o in outs:
        a, b = o["span"]
        for layer, mask in enumerate(o["masks"]):
            assert torch.equal(mask, K.dropout_keep(
                f["seed"], f["rate"], layer, 1, T, H, N)[..., a:b])
        d = o["ffn_dropout"].detach()
        np.testing.assert_allclose(d.numpy(), full[..., a:b].detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert not torch.equal(outs[0]["masks"][0], outs[1]["masks"][0])


# -- a short 3-phase run at world size 2, and world size 1 -------------------


@pytest.fixture(scope="module")
def trained(splits, tmp_path_factory):
    """The sharded run at world 2 (full, and stopped then resumed) and the
    unsharded run from the same start."""
    train = splits[0]
    cfg = GANConfig(**dict(_cfg_kw(train), dropout=0.05))
    tcfg = TrainConfig(num_epochs_unc=4, num_epochs_moment=2, num_epochs=5,
                       ignore_epoch=1, seed=7)
    jgan = JGAN(JGANConfig(**_cfg_kw(train)))
    sd = state_dict_from_jax_params(
        jax.device_get(jgan.init(jax.random.key(5))), cfg)
    wd = tmp_path_factory.mktemp("shard_train")
    torch.save(dict(cfg=dict(_cfg_kw(train), dropout=0.05),
                    tcfg=dict(num_epochs_unc=4, num_epochs_moment=2,
                              num_epochs=5, ignore_epoch=1, seed=7),
                    batches=[ds.full_batch() for ds in splits],
                    state_dict=sd), wd / "in.pt")
    spawn(train_worker, 2, wd)
    tb = [{k: torch.as_tensor(np.asarray(v, np.float32))
           for k, v in ds.full_batch().items()} for ds in splits]
    _, params, hist, _ = train_3phase(cfg, *tb, tcfg=tcfg, exec_cfg=CPU_F32,
                                      verbose=False, state_dict=sd)
    outs = [torch.load(wd / f"train{r}.pt", weights_only=False)
            for r in range(2)]
    return dict(outs=outs, unsharded=(params, hist), cfg=cfg, tcfg=tcfg,
                sd=sd, batches=tb, wd=wd)


def test_three_phase_training_at_world_two(trained):
    """Every epoch's losses within 1e-3 rel and Sharpes within 5e-3 of the
    unsharded run (dropout 0.05: the same masks, drawn at the global stock
    index), and the two ranks' params and histories bit for bit equal."""
    outs = trained["outs"]
    ref_params, ref_hist = trained["unsharded"]
    params, hist = outs[0]["full"]
    for k in ("train_loss", "valid_loss", "test_loss"):
        np.testing.assert_allclose(hist[k], ref_hist[k], rtol=1e-3, err_msg=k)
    for k in ("train_sharpe", "valid_sharpe", "test_sharpe"):
        np.testing.assert_allclose(hist[k], ref_hist[k], atol=5e-3, err_msg=k)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), ref_params[k].numpy(),
                                   atol=1e-4, err_msg=k)
        assert torch.equal(v, outs[1]["full"][0][k])
    for k in hist:
        assert np.array_equal(np.asarray(hist[k]),
                              np.asarray(outs[1]["full"][1][k]))
    files = {p.name for p in (trained["wd"] / "full").iterdir()}
    assert {"final_model.pt", "history.npz", "config.json"} <= files


def test_midphase_resume_under_sharding(trained):
    """Stopped after 7 epochs (inside phase 3) with a state every 2, then
    resumed on both ranks: bit for bit the uninterrupted sharded run; the
    resume files are written by rank 0 alone and cleared at the end."""
    outs = trained["outs"]
    assert "resume_state.pt" in outs[0]["cut_files"]
    for o in outs:
        params, hist = o["resumed"]
        full_params, full_hist = o["full"]
        for k in params:
            assert torch.equal(params[k], full_params[k]), k
        for k in full_hist:
            assert np.array_equal(np.asarray(hist[k]),
                                  np.asarray(full_hist[k])), k
    assert not list((trained["wd"] / "cut").glob("resume_*"))


def test_world_size_one_is_the_unsharded_route(trained):
    """A shard of world size 1 runs no collective: the forward and one
    step of each phase, and the 3-phase run, bit for bit unsharded."""
    cfg, sd, tb = trained["cfg"], trained["sd"], trained["batches"]
    one = ExecutionConfig(device="cpu", compute_dtype="float32",
                          shard=collectives.shard_of(
                              tb[0]["returns"].shape[1]))
    for phase in PHASES:
        a, b = (GAN.from_state_dict(cfg, sd, ec) for ec in (CPU_F32, one))
        key = steps.trainable_key(phase)
        ma = steps.train_step(a, phase, steps.Optimizer(
            steps.subtree_params(a, key), 1e-3), tb[0], 5)
        mb = steps.train_step(b, phase, steps.Optimizer(
            steps.subtree_params(b, key), 1e-3), tb[0], 5)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (phase, k)
        for k, v in a.module.state_dict().items():
            assert torch.equal(v, b.module.state_dict()[k]), (phase, k)
    _, params, hist, _ = train_3phase(cfg, *tb, tcfg=trained["tcfg"],
                                      exec_cfg=one, verbose=False,
                                      state_dict=sd)
    ref_params, ref_hist = trained["unsharded"]
    for k in params:
        assert torch.equal(params[k], ref_params[k]), k
    for k in ref_hist:
        assert np.array_equal(np.asarray(hist[k]), np.asarray(ref_hist[k]))
