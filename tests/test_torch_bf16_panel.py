"""The bf16 feature-major panel (``ExecutionConfig.bf16_panel``) of the
PyTorch port's panel kernels, against the JAX package, on the CPU.

* ``ExecutionConfig.stores_bf16_panel`` and the port's ``prepare_batch``
  against the JAX ``GAN.prepare_batch`` decision (``bf16_panel and
  use_pallas(hidden_dim)``) over kernel on / off / auto, the device, an
  empty ``hidden_dim`` and ``bf16_panel=False``. The JAX package's
  ``"auto"`` means its accelerator (a TPU); the port's means a CUDA
  device, so the port's ``("auto", "cuda")`` is JAX's ``"on"``.
* The plain versions of the six panel kernels (which a CPU tensor runs,
  and which the CUDA kernels are held to on the card) on a bf16 panel: bit
  for bit the same function on ``x.bfloat16().float()``, the panel
  cotangents returned in bf16, rounded once from that f32 result.
* Against the JAX ``fused_sdf_ffn`` and ``fused_conditional_em`` in the
  Pallas interpreter on the same bf16 panel, compute f32, one member:
  forward and VJP at rtol 1e-4 with atol 1e-5·max|ref| (only the
  summation order differs); the bf16 panel cotangent within one bf16 ulp,
  since another summation order can move its one rounding. (Over S
  members JAX's vmap rounds each member's dx to bf16 and sums them in
  bf16; the port sums them in f32 and rounds once, as one call of the JAX
  kernel does.)
* A panel dtype the kernels do not take is an error, never a conversion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.gan import GAN
from deeplearninginassetpricing_paperreplication_torch.ops import cond_em as C
from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K
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
    ExecutionConfig as JExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

T, F, N, KN, S = 6, 5, 37, 4, 2  # ragged N against a 16-stock block
HIDDEN = (8, 7)


def _bf16_ulp(a):
    """One bf16 ulp of each |a| (f32 numpy)."""
    _, e = np.frexp(np.abs(a).astype(np.float32))
    return np.where(a == 0, 0.0, np.ldexp(1.0, e - 8)).astype(np.float32)


def _within_one_ulp(got, ref, what):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    ulp = np.maximum(_bf16_ulp(got), _bf16_ulp(ref))
    assert np.all(np.abs(got - ref) <= ulp), what


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max(), err_msg=what)


# -- the predicate ---------------------------------------------------------------

JAX_ROUTE = {("on", "cpu"): "on", ("on", "cuda"): "on", ("off", "cpu"): "off",
             ("off", "cuda"): "off", ("auto", "cpu"): "auto",
             ("auto", "cuda"): "on"}


@pytest.mark.parametrize("bf16_panel", [True, False])
@pytest.mark.parametrize("hidden", [(8, 7), ()], ids=["ffn", "no_hidden"])
@pytest.mark.parametrize("kernel,device", sorted(JAX_ROUTE))
def test_predicate_is_the_jax_prepare_batch_decision(kernel, device, hidden,
                                                     bf16_panel):
    kw = dict(macro_feature_dim=3, individual_feature_dim=F,
              hidden_dim=hidden, num_units_rnn=(4,))
    jex = JExecutionConfig(pallas_ffn=JAX_ROUTE[(kernel, device)],
                           bf16_panel=bf16_panel)
    jb = JGAN(JGANConfig(**kw), jex).prepare_batch(
        {"individual": jnp.zeros((T, N, F), jnp.float32)})
    jax_bf16 = ("individual_t" in jb
                and jb["individual_t"].dtype == jnp.bfloat16)
    ex = ExecutionConfig(kernel=kernel, device=device, bf16_panel=bf16_panel)
    cfg = GANConfig(**kw)
    assert ex.stores_bf16_panel(cfg) == jax_bf16
    pb = GAN(cfg, ex).prepare_batch({"individual": torch.zeros(T, N, F)})
    assert pb["individual_t"].dtype == (torch.bfloat16 if jax_bf16
                                        else torch.float32)
    assert pb["individual"].dtype == torch.float32


def test_prepared_panel_passes_through_and_defaults():
    """A batch that has individual_t keeps it (as in the JAX package); the
    default is JAX's (bf16_panel True); the plain route on the CPU stays
    f32, so the CPU tests' numbers do not move."""
    assert ExecutionConfig().bf16_panel is True
    cfg = GANConfig(macro_feature_dim=3, individual_feature_dim=F,
                    hidden_dim=HIDDEN, num_units_rnn=(4,))
    x = torch.randn(T, N, F)
    assert not ExecutionConfig(device="cpu").stores_bf16_panel(cfg)
    gan = GAN(cfg, ExecutionConfig(kernel="on", device="cpu"))
    given = x.permute(0, 2, 1).contiguous()
    assert gan.prepare_batch({"individual": x, "individual_t": given})[
        "individual_t"] is given
    got = gan.prepare_batch({"individual": x})["individual_t"]
    assert torch.equal(got, x.permute(0, 2, 1).to(torch.bfloat16))


# -- the plain versions on a bf16 panel ------------------------------------------


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32))
    x = t(T, F, N)
    zp = t(S, T, HIDDEN[0], scale=0.3)
    k1T = t(S, HIDDEN[0], F, scale=F ** -0.5)
    mids = [(t(S, HIDDEN[1], HIDDEN[0], scale=HIDDEN[0] ** -0.5),
             t(S, HIDDEN[1], scale=0.1))]
    kout = t(S, HIDDEN[1], scale=HIDDEN[1] ** -0.5)
    bout = t(S, scale=0.1)
    g = t(S, T, N, scale=1.0 / N)
    zpm = t(S, T, KN, scale=0.3)
    xr = t(S, T, N, scale=0.1)
    tinv = torch.from_numpy(
        (1.0 / rng.integers(1, T + 1, N)).astype(np.float32))
    kT = t(S, KN, F, scale=F ** -0.5)
    gem = t(S, KN, N, scale=1.0 / N)
    return x, (zp, k1T, mids, kout, bout, g), (zpm, xr, tinv, kT, gem)


def _plain_calls(ffn, cem, cd, rate, offset):
    zp, k1T, mids, kout, bout, g = ffn
    zpm, xr, tinv, kT, gem = cem
    seed = [7, 8]

    def bwd(x):
        dzp, dk1T, dmids, dkout, dbout = K.sdf_ffn_bwd_reference(
            x, zp, k1T, mids, kout, g, cd, seed, rate, offset)
        return [dzp, dk1T, dkout, dbout] + [t for wb in dmids for t in wb]

    return {
        "sdf_ffn_fwd": lambda x: [K.sdf_ffn_reference(
            x, zp, k1T, mids, kout, bout, cd, seed, rate, offset)],
        "sdf_ffn_bwd": bwd,
        "sdf_ffn_dx": lambda x: [K.sdf_ffn_dx_reference(
            x, zp, k1T, mids, kout, g, cd, seed, rate, offset)],
        "cond_em_fwd": lambda x: [C.cond_em_reference(x, zpm, xr, tinv, kT,
                                                      cd)],
        "cond_em_bwd": lambda x: list(C.cond_em_bwd_reference(
            x, zpm, xr, tinv, kT, gem, cd)),
        "cond_em_dx": lambda x: [C.cond_em_dx_reference(x, zpm, xr, tinv, kT,
                                                        gem, cd)],
    }


@pytest.mark.parametrize("rate,offset", [(0.0, 0), (0.2, 5_000)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_plain_versions_on_a_bf16_panel(cd, rate, offset):
    """Each plain version on a bf16 panel is bit for bit itself on the
    widened panel x.bfloat16().float(); a panel cotangent comes back in
    bf16, that f32 result rounded once."""
    x, ffn, cem = _inputs()
    xb = x.to(torch.bfloat16)
    xw = xb.float()
    for name, call in _plain_calls(ffn, cem, cd, rate, offset).items():
        got, ref = call(xb), call(xw)
        assert len(got) == len(ref) > 0, name
        for a, b in zip(got, ref):
            if name.endswith("_dx"):
                assert a.dtype == torch.bfloat16 and b.dtype == torch.float32
                assert torch.equal(a, b.to(torch.bfloat16)), name
            else:
                assert a.dtype == torch.float32, name
                assert torch.equal(a, b), name


def test_the_wrappers_take_a_bf16_panel_and_refuse_other_dtypes():
    """The differentiable entries on a bf16 panel: the gradient w.r.t. the
    panel arrives in bf16 (the plain dx rounded once), the others in f32;
    float16 and float64 panels are refused, not converted."""
    x, (zp, k1T, mids, kout, bout, g), (zpm, xr, tinv, kT, gem) = _inputs(1)
    xb = x.to(torch.bfloat16).requires_grad_()
    w = K.sdf_ffn(xb, zp, k1T, mids, kout, bout, compute_dtype="float32")
    (dx,) = torch.autograd.grad((w * g).sum(), xb)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, K.sdf_ffn_dx_reference(
        xb.detach(), zp, k1T, mids, kout, g, "float32"))
    ks = kT.transpose(1, 2).contiguous()
    em = C.fused_conditional_em(xb, zpm, xr, tinv, ks,
                                compute_dtype="float32")
    (dx,) = torch.autograd.grad((em * gem).sum(), xb)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, C.cond_em_dx_reference(
        xb.detach(), zpm, xr, tinv, kT, gem, "float32"))
    for dtype in (torch.float16, torch.float64):
        xo = x.to(dtype)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            K.sdf_ffn(xo, zp, k1T, mids, kout, bout)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            K.sdf_ffn_packed(xo, zp, K.pack_ffn(k1T, mids, kout, bout,
                                                "float32"))
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            C.fused_conditional_em(xo, zpm, xr, tinv, ks)


def test_bytes_moved_take_the_panel_element_size():
    """A bound reads the same work whatever implements it: the bf16 panel
    halves the panel's bytes (and the panel cotangent's)."""
    panel = T * F * N
    for fn, n in ((K.bytes_moved, 1), (K.bwd_bytes_moved, 1),
                  (K.dx_bytes_moved, 2)):
        args = (S, T, N, F, HIDDEN)
        assert fn(*args) - fn(*args, 2) == 2 * n * panel
        assert fn(*args, 4) == fn(*args)
    for fn, n in ((C.fwd_bytes_moved, 1), (C.bwd_bytes_moved, 1),
                  (C.dx_bytes_moved, 2)):
        args = (S, T, N, F, KN)
        assert fn(*args) - fn(*args, 2) == 2 * n * panel


# -- against the JAX kernels in the interpreter ----------------------------------


def _np(t):
    return t.detach().numpy()


def test_sdf_ffn_matches_jax_on_a_bf16_panel():
    """fused_sdf_ffn (interpret, compute f32) on the bf16 panel against the
    port's sdf_ffn on it: the weights and their VJP; the bf16 dx within one
    bf16 ulp."""
    x, ffn, _ = _inputs(2)
    zp, k1T, mids, kout, bout, g = (t[:1] if torch.is_tensor(t) else
                                    [(w[:1], b[:1]) for w, b in t]
                                    for t in ffn)
    xb = x.to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jargs = (jnp.asarray(_np(zp)), jnp.asarray(_np(k1T.transpose(1, 2))),
             jnp.asarray(_np(mids[0][0].transpose(1, 2))),
             jnp.asarray(_np(mids[0][1])), jnp.asarray(_np(kout))[..., None],
             jnp.asarray(_np(bout))[..., None])

    def one(x_, zp_, k1_, w_, b_, ko_, bo_):
        return fused_sdf_ffn(x_, zp_, [(k1_, None), (w_, b_)], ko_, bo_,
                             interpret=True, compute_dtype="float32",
                             block_stocks=16)

    def members(x_, *a):
        return jax.vmap(lambda *m: one(x_, *m))(*a)

    w_j, vjp = jax.vjp(members, jx, *jargs)
    grads_j = vjp(jnp.asarray(_np(g)))
    assert grads_j[0].dtype == jnp.bfloat16
    xt = xb.clone().requires_grad_()
    ts = [t.clone().requires_grad_() for t in (zp, k1T, mids[0][0],
                                               mids[0][1], kout, bout)]
    w = K.sdf_ffn(xt, ts[0], ts[1], [(ts[2], ts[3])], ts[4], ts[5],
                  compute_dtype="float32")
    _close(_np(w), w_j, "weights")
    grads = torch.autograd.grad((w * g).sum(), [xt] + ts)
    assert grads[0].dtype == torch.bfloat16
    _within_one_ulp(grads[0].float().numpy(),
                    np.asarray(grads_j[0].astype(jnp.float32)), "dx")
    swap = lambda a: np.swapaxes(np.asarray(a), -1, -2)  # noqa: E731
    for name, got, ref in (("dzp", grads[1], grads_j[1]),
                           ("dk1T", grads[2], swap(grads_j[2])),
                           ("dW", grads[3], swap(grads_j[3])),
                           ("db", grads[4], grads_j[4]),
                           ("dkout", grads[5], np.asarray(grads_j[5])[..., 0]),
                           ("dbout", grads[6], np.asarray(grads_j[6])[..., 0])):
        _close(got.numpy(), ref, name)


def test_cond_em_matches_jax_on_a_bf16_panel():
    """fused_conditional_em (interpret, compute f32) on the bf16 panel
    against the port's on it: em and its VJP; the bf16 dx within one bf16
    ulp."""
    x, _, (zpm, xr, tinv, kT, gem) = _inputs(3)
    zpm, xr, kT, gem = zpm[:1], xr[:1], kT[:1], gem[:1]
    xb = x.to(torch.bfloat16)
    ks = kT.transpose(1, 2).contiguous()
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jargs = [jnp.asarray(_np(a)) for a in (zpm, xr, tinv, ks)]

    def em_j(x_, zpm_, xr_, tinv_, ks_):
        return jax.vmap(lambda a, b, c: fused_conditional_em(
            x_, a, b, tinv_, c, block_stocks=16, interpret=True,
            compute_dtype="float32"))(zpm_, xr_, ks_)

    em_ref, vjp = jax.vjp(em_j, jx, *jargs)
    grads_j = vjp(jnp.asarray(_np(gem)))
    xt = xb.clone().requires_grad_()
    ts = [t.clone().requires_grad_() for t in (zpm, xr, tinv, ks)]
    em = C.fused_conditional_em(xt, *ts, compute_dtype="float32")
    _close(_np(em), em_ref, "em")
    grads = torch.autograd.grad((em * gem).sum(), [xt] + ts)
    assert grads[0].dtype == torch.bfloat16
    _within_one_ulp(grads[0].float().numpy(),
                    np.asarray(grads_j[0].astype(jnp.float32)), "dx")
    for name, got, ref in zip(("dzp_m", "dxr", "dtinv", "dk_stock"),
                              grads[1:], grads_j[1:]):
        _close(got.numpy(), ref, name)
