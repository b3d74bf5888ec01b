"""The kernel route's shape range on the CPU: the plain versions of the
fused SDF-FFN and conditional-EM at the shapes past the resident CUDA
kernels (hidden widths above 128, more than 8 layers, more than 16
moments), against the JAX package's Pallas kernels in the interpreter.

The streamed-weight route (``csrc/sdf_ffn_stream.cu``) and the moment
chunks run their kernels only on the card (``chip_smoke.py --only_shapes``
holds them against these plain versions there). Here the same numpy-seeded
inputs go through the JAX ``fused_sdf_ffn`` / ``fused_conditional_em``
(``interpret=True``), ``jax.grad`` and ``jax.vmap`` of them, and through the
port's plain route, which a CPU tensor runs at any depth, width and K; the
moment-chunk wrapper runs with the plain versions as its per-chunk callee.

Tolerances are those of tests/test_torch_ffn.py and
tests/test_torch_cond_em.py: the FFN's weights f32 within atol 2e-5, bf16
within 1e-3·max|w|; gradients and panel cotangents f32 within
1e-4·max|ref|, bf16 within 2e-2·max|ref|; the conditional EM f32 within
1e-4·max|ref|, bf16 within 2e-2·max|ref|.
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
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.ops.pallas_ffn import (
    fused_sdf_ffn,
)
from deeplearninginassetpricing_paperreplication_tpu.ops.pallas_moment import (
    fused_conditional_em,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

T, F, N = 6, 5, 37  # ragged N: not a multiple of the 16-stock block
REL = {"float32": 1e-4, "bfloat16": 2e-2}
# past the resident kernels: widths above 128, 9 and 16 layers
STACKS = [(256, 256), (132,), (16,) * 9, (8,) * 16]
STACK_IDS = ["256x256", "132", "9x16", "16x8"]


def _ffn_params(rng, hidden, S):
    """JAX-layout FFN params with a leading member axis of S."""
    k1 = rng.standard_normal((S, F, hidden[0])) / np.sqrt(F)
    mids = [(rng.standard_normal((S, a, b)) / np.sqrt(a),
             0.1 * rng.standard_normal((S, b)))
            for a, b in zip(hidden, hidden[1:])]
    ko = rng.standard_normal((S, hidden[-1], 1)) / np.sqrt(hidden[-1])
    bo = 0.1 * rng.standard_normal((S, 1))
    zp = 0.3 * rng.standard_normal((S, T, hidden[0]))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(zp), f32(k1), [(f32(a), f32(b)) for a, b in mids], f32(ko),
            f32(bo))


def _jax_ffn(x, zp, k1, mids, ko, bo, cd):
    return fused_sdf_ffn(x, zp, [(k1, None)] + list(mids), ko, bo,
                         interpret=True, compute_dtype=cd, block_stocks=16)


def _close(got, ref, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", STACKS, ids=STACK_IDS)
def test_plain_ffn_matches_jax_past_the_resident_kernels(hidden, cd):
    """One model (S = 1); tests/test_torch_shapes_members.py holds S = 3."""
    check_plain_ffn_against_jax(hidden, cd, 1)


def check_plain_ffn_against_jax(hidden, cd, S):
    """sdf_ffn on the plain route (kernel="off", a CPU panel): the weights,
    every parameter gradient and the panel cotangent against the JAX
    kernel, jax.grad of Σ g·w, and (S > 1) jax.vmap over the members,
    whose panel cotangents sum."""
    rng = np.random.default_rng(len(hidden) * 1000 + hidden[0] + S)
    x = rng.standard_normal((T, F, N)).astype(np.float32)
    zp, k1, mids, ko, bo = _ffn_params(rng, hidden, S)
    g = rng.standard_normal((S, T, N)).astype(np.float32)

    def member(x_, zp_, k1_, mids_, ko_, bo_, g_):
        return jnp.sum(_jax_ffn(x_, zp_, k1_, mids_, ko_, bo_, cd) * g_)

    j = lambda a: jnp.asarray(a)  # noqa: E731
    jp = (j(zp), j(k1), [(j(a), j(b)) for a, b in mids], j(ko), j(bo))
    if S == 1:  # the one-model kernel, its member axis added back
        one = jax.tree_util.tree_map(lambda a: a[0], jp)
        w_j = _jax_ffn(j(x), *one, cd)[None]
        grads_j = jax.grad(lambda x_, *p: member(x_, *p, j(g[0])),
                           argnums=(0, 1, 2, 3, 4, 5))(j(x), *one)
        grads_j = jax.tree_util.tree_map(lambda a: a[None], grads_j)
        grads_j = (grads_j[0][0],) + tuple(grads_j[1:])
    else:  # jax.vmap over the members: the member-fused kernel
        w_j = jax.vmap(lambda *p: _jax_ffn(j(x), *p, cd))(*jp)
        grads_j = jax.grad(lambda x_, *p: jnp.sum(jax.vmap(
            lambda *q: member(x_, *q))(*p, j(g))),
            argnums=(0, 1, 2, 3, 4, 5))(j(x), *jp)

    t = torch.from_numpy
    xt = t(x).requires_grad_()
    params = [t(zp), t(np.swapaxes(k1, 1, 2)).contiguous(),
              t(ko[..., 0]).contiguous(), t(bo[..., 0]).contiguous()]
    tmids = [(t(np.swapaxes(a, 1, 2)).contiguous(), t(b)) for a, b in mids]
    leaves = params + [p for wb in tmids for p in wb]
    for p in leaves:
        p.requires_grad_()
    w = K.sdf_ffn(xt, params[0], params[1], tmids, params[2], params[3],
                  compute_dtype=cd, kernel="off")
    assert w.shape == (S, T, N)
    wj = np.asarray(w_j)
    _close(w.detach(), wj, 2e-5 if cd == "float32"
           else 1e-3 * np.abs(wj).max(), "weights")
    got = torch.autograd.grad((w * t(g)).sum(), [xt] + leaves)
    dx, dzp, dk1T, dkout, dbout, *dmids = got
    ref = [grads_j[0], grads_j[1], np.swapaxes(np.asarray(grads_j[2]), 1, 2),
           np.asarray(grads_j[4])[..., 0], np.asarray(grads_j[5])[..., 0]]
    for (da, db), (ja, jb) in zip(zip(dmids[0::2], dmids[1::2]), grads_j[3]):
        ref += [np.swapaxes(np.asarray(ja), 1, 2), jb]
    names = ["dx", "dzp", "dk1T", "dkout", "dbout"] + [
        f"d{n}{i}" for i in range(1, len(hidden)) for n in ("W", "b")]
    for name, a, r in zip(names, [dx, dzp, dk1T, dkout, dbout] + dmids, ref):
        r = np.asarray(r)
        _close(a, r, REL[cd] * np.abs(r).max() + 1e-12, name)


def test_ffn_takes_any_depth_on_the_plain_route_only_where_asked():
    """The layer cap belongs to the resident kernels: pack_ffn and sdf_ffn
    take 9 and 16 layers, and a CPU panel with kernel="on" still raises
    (no quiet fallback)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((T, F, N)).astype(np.float32))
    zp, k1, mids, ko, bo = _ffn_params(rng, (8,) * 9, 1)
    t = torch.from_numpy
    args = (t(zp), t(np.swapaxes(k1, 1, 2)).contiguous(),
            [(t(np.swapaxes(a, 1, 2)).contiguous(), t(b)) for a, b in mids],
            t(ko[..., 0]), t(bo[..., 0]))
    packed = K.pack_ffn(*args[1:], "float32")
    assert len(packed.layout.hidden) == 9 and not K.resident_fits(
        packed.layout)
    torch.testing.assert_close(
        K.sdf_ffn_packed(x, args[0], packed),
        K.sdf_ffn(x, *args, compute_dtype="float32", kernel="off"))
    with pytest.raises(ValueError, match="CUDA"):
        K.sdf_ffn(x, *args, compute_dtype="float32", kernel="on")


def _cem_inputs(seed, Kn, S):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    x = f32(rng.standard_normal((T, F, N)))
    zpm = f32(0.3 * rng.standard_normal((S, T, Kn)))
    xr = f32(0.2 * rng.standard_normal((S, T, N)))
    tinv = f32(1.0 / rng.integers(1, T + 1, N))
    ks = f32(rng.standard_normal((S, F, Kn)) / np.sqrt(F))
    g = f32(rng.standard_normal((S, Kn, N)))
    return x, zpm, xr, tinv, ks, g


@pytest.mark.parametrize("S", [1, 3], ids=["one", "members"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("Kn", [17, 32])
def test_plain_cond_em_matches_jax_past_16_moments(Kn, cd, S):
    """fused_conditional_em's plain route at K = 17 and 32: em, the
    gradients of zp_m, xr, tinv and k_stock, and (f32) the panel cotangent,
    against the JAX kernel, its jax.grad and (S = 3) jax.vmap over the
    members."""
    x, zpm, xr, tinv, ks, g = _cem_inputs(Kn + S, Kn, S)

    def jem(x_, zpm_, xr_, tinv_, ks_):
        return jax.vmap(lambda a, b, c: fused_conditional_em(
            x_, a, b, tinv_, c, block_stocks=16, interpret=True,
            compute_dtype=cd))(zpm_, xr_, ks_)

    j = [jnp.asarray(a) for a in (x, zpm, xr, tinv, ks)]
    em_j = np.asarray(jem(*j))
    grads_j = jax.grad(lambda *a: jnp.sum(jem(*a) * g),
                       argnums=(0, 1, 2, 3, 4))(*j)
    tx = [torch.from_numpy(a).requires_grad_() for a in (x, zpm, xr, tinv,
                                                          ks)]
    em = C.fused_conditional_em(*tx, compute_dtype=cd, kernel="off")
    assert em.shape == (S, Kn, N)
    _close(em.detach(), em_j, REL[cd] * np.abs(em_j).max(), "em")
    got = torch.autograd.grad((em * torch.from_numpy(g)).sum(), tx)
    for name, a, r in zip(("dx", "dzp_m", "dxr", "dtinv", "dk_stock"), got,
                          grads_j):
        if name == "dx" and cd == "bfloat16":
            continue  # the JAX CPU route reads x in f32 (ROADMAP C4)
        r = np.asarray(r)
        _close(a, r, REL[cd] * np.abs(r).max() + 1e-12, name)


@pytest.mark.parametrize("S", [1, 3], ids=["one", "members"])
@pytest.mark.parametrize("Kn", [16, 17, 32, 33])
def test_moment_chunks_equal_the_unchunked_plain_call(Kn, S):
    """The moment-chunk wrappers with the plain versions as the per-chunk
    callee equal one plain call: em and ∂k_stock / ∂zp_m per chunk, ∂xr
    summed in f32 (f32 tolerance), the panel cotangent summed in f32 and
    rounded once to the panel's dtype (on a bf16 panel within one bf16
    ulp of the plain call's single rounding); ≤ 16 moments is one call."""
    x, zpm, xr, tinv, ks, g = _cem_inputs(40 + Kn, Kn, S)
    t = [torch.from_numpy(a) for a in (x, zpm, xr, tinv, ks, g)]
    x_t, zp_m, xr_t, tinv_t, k_s, gem = t
    kT = k_s.transpose(1, 2).contiguous()
    chunks = C.moment_chunks(Kn)
    assert len(chunks) == -(-Kn // 16)
    assert chunks[0][0] == 0 and chunks[-1][1] == Kn
    assert all(b - a <= C.MAX_MOMENTS for a, b in chunks)
    assert all(a == b for (_, a), (b, _) in zip(chunks, chunks[1:]))
    assert max(b - a for a, b in chunks) - min(b - a for a, b in chunks) <= 1
    calls = []

    def counted(fn):
        def call(*a):
            calls.append(a[4].shape[1])
            return fn(*a)
        return call

    for cd in ("float32", "bfloat16"):
        em = C.chunked_fwd(counted(C.cond_em_reference), x_t, zp_m, xr_t,
                           tinv_t, kT, cd)
        _close(em, C.cond_em_reference(x_t, zp_m, xr_t, tinv_t, kT, cd),
               1e-6, "em")
        got = C.chunked_bwd(counted(C.cond_em_bwd_reference), x_t, zp_m,
                            xr_t, tinv_t, kT, gem, cd)
        ref = C.cond_em_bwd_reference(x_t, zp_m, xr_t, tinv_t, kT, gem, cd)
        for name, a, r in zip(("dkT", "dzp_m", "dxr"), got, ref):
            _close(a, r, 1e-5 * float(r.abs().max()), name)
        for panel in (x_t, x_t.bfloat16()):
            dx = C.chunked_dx(counted(C.cond_em_dx_reference), panel, zp_m,
                              xr_t, tinv_t, kT, gem, cd)
            rdx = C.cond_em_dx_reference(panel, zp_m, xr_t, tinv_t, kT, gem,
                                         cd)
            assert dx.dtype == panel.dtype
            scale = float(rdx.float().abs().max())
            ulp = (torch.ldexp(torch.ones_like(rdx.float()),
                               torch.frexp(rdx.float()).exponent - 8)
                   if panel.dtype == torch.bfloat16 else 0.0)
            assert bool(((dx.float() - rdx.float()).abs()
                         <= 1e-5 * scale + ulp).all()), "dx"
    sizes = [b - a for a, b in chunks]
    assert calls == sizes * 8  # per dtype: fwd, bwd, dx on two panels


def _tbatch(ds):
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in ds.full_batch().items()}


def test_nine_layer_gan_matches_jax(splits):
    """A 9-layer SDF net (past the resident kernels' 8) through the whole
    GAN on the CPU, weights bridged from the JAX init: the weights, moments
    and SDF factor against the JAX model (atol 2e-5)."""
    _, _, test = splits
    kw = dict(macro_feature_dim=test.macro_feature_dim,
              individual_feature_dim=test.individual_feature_dim,
              num_units_rnn=(4,), hidden_dim=(8,) * 9,
              num_condition_moment=17, dropout=0.0)
    jgan = JGAN(JGANConfig(**kw))
    params = jgan.init(jax.random.key(9))
    batch = {k: jnp.asarray(v) for k, v in test.full_batch().items()}
    cfg = GANConfig(**kw)
    gan = GAN.from_state_dict(
        cfg, state_dict_from_jax_params(jax.device_get(params), cfg),
        ExecutionConfig(device="cpu", compute_dtype="float32"))
    tb = _tbatch(test)
    np.testing.assert_allclose(gan.weights(tb).numpy(),
                               np.asarray(jgan.weights(params, batch)),
                               atol=2e-5)
    np.testing.assert_allclose(gan.moments(tb).numpy(),
                               np.asarray(jgan.moments(params, batch)),
                               atol=2e-5)
    np.testing.assert_allclose(gan.sdf_factor(tb).numpy(),
                               np.asarray(jgan.sdf_factor(params, batch)),
                               atol=2e-5)
