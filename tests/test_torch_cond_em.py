"""The PyTorch port's fused conditional-EM (ops/cond_em.py) against the JAX
package's Pallas kernel in the interpreter.

The same numpy-seeded inputs go through the JAX ``fused_conditional_em``
(``interpret=True``, ragged N against a 16-stock block) and its gradient
(``jax.grad``), and through the port's plain versions, which a CPU tensor
runs. The CUDA kernels run only on the card: the test that launches them is
marked ``cuda`` and skips without one.

Tolerances: f32 within 1e-4·max|ref| (only the summation order differs);
bf16 within 2e-2·max|ref| (both round the operands of the products to bf16,
so a flip of one rounding after another summation order is what remains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.ops import cond_em as C
from deeplearninginassetpricing_paperreplication_tpu.ops.pallas_moment import (
    fused_conditional_em,
)

T, F, N, K = 6, 5, 37, 4
REL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(seed=0, S=None):
    rng = np.random.default_rng(seed)
    lead = () if S is None else (S,)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    x = f32(rng.standard_normal((T, F, N)))
    zpm = f32(0.3 * rng.standard_normal(lead + (T, K)))
    xr = f32(0.2 * rng.standard_normal(lead + (T, N)))
    tinv = f32(1.0 / rng.integers(1, T + 1, N))
    ks = f32(rng.standard_normal(lead + (F, K)) / np.sqrt(F))
    g = f32(rng.standard_normal(lead + (K, N)))
    return x, zpm, xr, tinv, ks, g


def _close(a, ref, cd, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(a), ref,
                               atol=REL[cd] * np.abs(ref).max(), rtol=0,
                               err_msg=what)


def _jax_em(cd):
    def em(x, zpm, xr, tinv, ks):
        return fused_conditional_em(x, zpm, xr, tinv, ks, block_stocks=16,
                                    interpret=True, compute_dtype=cd)
    return em


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_and_backward_match_jax(cd):
    x, zpm, xr, tinv, ks, g = _inputs()
    jem = _jax_em(cd)
    j = [jnp.asarray(a) for a in (x, zpm, xr, tinv, ks)]
    em_j = jem(*j)
    grads_j = jax.grad(lambda zpm, xr, tinv, ks: jnp.sum(
        jem(j[0], zpm, xr, tinv, ks) * g), argnums=(0, 1, 2, 3))(*j[1:])
    t = [torch.from_numpy(a).requires_grad_(i > 0)
         for i, a in enumerate((x, zpm, xr, tinv, ks))]
    em = C.fused_conditional_em(*t, compute_dtype=cd)
    assert em.shape == (K, N)
    _close(em.detach(), em_j, cd, "em")
    grads = torch.autograd.grad((em * torch.from_numpy(g)).sum(), t[1:])
    for name, a, b in zip(("dzp_m", "dxr", "dtinv", "dk_stock"), grads,
                          grads_j):
        _close(a, b, cd, name)


def test_member_axis_matches_jax_vmap():
    """S = 3 members over one panel against the JAX call vmapped over
    members (its batching rule runs the member-fused kernels)."""
    S = 3
    x, zpm, xr, tinv, ks, g = _inputs(1, S=S)
    jem = _jax_em("float32")

    def loss(zpm, xr, ks):
        return jnp.sum(jax.vmap(lambda a, b, c: jem(jnp.asarray(x), a, b,
                                                     jnp.asarray(tinv), c))(
            zpm, xr, ks) * g)

    j = [jnp.asarray(a) for a in (zpm, xr, ks)]
    em_j = jax.vmap(lambda a, b, c: jem(jnp.asarray(x), a, b,
                                        jnp.asarray(tinv), c))(*j)
    grads_j = jax.grad(loss, argnums=(0, 1, 2))(*j)
    t = [torch.from_numpy(a).requires_grad_() for a in (zpm, xr, ks)]
    em = C.fused_conditional_em(torch.from_numpy(x), t[0], t[1],
                                torch.from_numpy(tinv), t[2],
                                compute_dtype="float32")
    assert em.shape == (S, K, N)
    _close(em.detach(), em_j, "float32", "em")
    grads = torch.autograd.grad((em * torch.from_numpy(g)).sum(), t)
    for name, a, b in zip(("dzp_m", "dxr", "dk_stock"), grads, grads_j):
        _close(a, b, "float32", name)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_plain_backward_is_autograd_of_plain_forward(cd):
    """The plain backward (the bwd kernel's yardstick) against torch
    autograd through the plain forward; in bf16 autograd also rounds the
    backward's operands differently, so only f32 is exact to 1e-5."""
    S = 2
    x, zpm, xr, tinv, ks, g = _inputs(2, S=S)
    kT = torch.from_numpy(np.swapaxes(ks, 1, 2).copy())
    t = [torch.from_numpy(a).requires_grad_() for a in (zpm, xr)]
    kT.requires_grad_()
    gem = torch.from_numpy(g)
    em = C.cond_em_reference(torch.from_numpy(x), t[0], t[1],
                             torch.from_numpy(tinv), kT, cd)
    auto = torch.autograd.grad((em * gem).sum(), [kT, t[0], t[1]])
    plain = C.cond_em_bwd_reference(torch.from_numpy(x), t[0].detach(),
                                    t[1].detach(), torch.from_numpy(tinv),
                                    kT.detach(), gem, cd)
    rel = 1e-5 if cd == "float32" else REL[cd]
    for a, b in zip(plain, auto):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=rel * b.abs().max().item())


def test_routes_and_refusals():
    x, zpm, xr, tinv, ks, _ = _inputs(3)
    args = [torch.from_numpy(a) for a in (x, zpm, xr, tinv, ks)]
    launches = lambda: (C.fwd_launches, C.bwd_launches, C.dx_launches)  # noqa: E731
    before = launches()
    a = C.fused_conditional_em(*args, kernel="auto")
    b = C.fused_conditional_em(*args, kernel="off")
    torch.testing.assert_close(a, b)
    assert launches() == before  # CPU: never a kernel
    with pytest.raises(ValueError, match="CUDA"):
        C.fused_conditional_em(*args, kernel="on")
    # the panel's gradient, once refused, is the plain panel cotangent
    xg = args[0].clone().requires_grad_()
    em = C.fused_conditional_em(xg, *args[1:], compute_dtype="float32")
    em.sum().backward()
    ks = args[4]
    torch.testing.assert_close(xg.grad, C.cond_em_dx_reference(
        args[0], args[1][None], args[2][None], args[3],
        ks.T[None].contiguous(), torch.ones(1, K, N), "float32"))
    assert launches() == before
    # bound bookkeeping at the training shape: the panel read dominates
    assert C.fwd_bytes_moved(1, 48, 10000, 46, 8) > 4 * 48 * 46 * 10000
    assert C.bwd_flops(1, 48, 10000, 46, 8) == 2 * 48 * 10000 * 8 * 94


def _jax_dx(x, zpm, xr, tinv, ks, g, S=None):
    """jax.grad w.r.t. the panel of Σ g·em through the interpreted Pallas
    kernel (f32); with S, of the call vmapped over the members."""
    jem = _jax_em("float32")
    j = [jnp.asarray(a) for a in (zpm, xr, tinv, ks)]
    if S is None:
        return jax.grad(lambda x_: jnp.sum(jem(x_, *j) * g))(jnp.asarray(x))
    return jax.grad(lambda x_: jnp.sum(jax.vmap(
        lambda a, b, c: jem(x_, a, b, j[2], c))(j[0], j[1], j[3]) * g))(
            jnp.asarray(x))


@pytest.mark.parametrize("S", [None, 3], ids=["one", "members"])
def test_panel_gradient_matches_jax(S):
    """Autograd of the fused conditional-EM (plain route) w.r.t. the panel
    against jax.grad of the JAX kernel, ragged N (21 stocks against a
    16-stock block): one member, and S = 3 through jax.vmap, whose members'
    cotangents sum. f32 within 1e-4·max|ref|."""
    n = 21
    x, zpm, xr, tinv, ks, g = _inputs(4, S=S)
    x, xr, tinv, g = x[..., :n], xr[..., :n], tinv[:n], g[..., :n]
    ref = _jax_dx(x, zpm, xr, tinv, ks, g, S)
    xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
    em = C.fused_conditional_em(
        xt, *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (zpm, xr, tinv, ks)), compute_dtype="float32")
    (dx,) = torch.autograd.grad(
        (em * torch.from_numpy(np.ascontiguousarray(g))).sum(), xt)
    assert dx.shape == (T, F, n)
    _close(dx, ref, "float32", "dx")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_dx_reference_is_autograd_of_plain_forward(cd):
    """The plain panel cotangent against torch autograd w.r.t. x_t through
    the plain forward (two members). f32 to 1e-5; bf16 within
    2e-2·max|ref| (autograd does not round dpre as the kernel does)."""
    x, zpm, xr, tinv, ks, g = _inputs(5, S=2)
    xt = torch.from_numpy(x).requires_grad_()
    kT = torch.from_numpy(np.swapaxes(ks, 1, 2).copy())
    args = [torch.from_numpy(a) for a in (zpm, xr, tinv)]
    em = C.cond_em_reference(xt, *args, kT, cd)
    (auto,) = torch.autograd.grad((em * torch.from_numpy(g)).sum(), xt)
    dx = C.cond_em_dx_reference(xt.detach(), *args, kT, torch.from_numpy(g),
                                cd)
    rel = 1e-5 if cd == "float32" else REL[cd]
    torch.testing.assert_close(dx, auto, rtol=0,
                               atol=rel * auto.abs().max().item())


def test_backward_runs_only_what_is_asked(monkeypatch):
    """The panel cotangent runs only when x_t needs a gradient, the
    parameter backward only when zp_m, xr or k_stock does; every other
    input's gradient is None."""
    calls = {"bwd": 0, "dx": 0}
    for name, key in (("cond_em_bwd_reference", "bwd"),
                      ("cond_em_dx_reference", "dx")):
        def counted(*a, _f=getattr(C, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(C, name, counted)
    x, zpm, xr, tinv, ks, g = (torch.from_numpy(a) for a in _inputs(6, S=2))
    xg = x.clone().requires_grad_()
    em = C.fused_conditional_em(xg, zpm, xr, tinv, ks, compute_dtype="float32")
    (dx,) = torch.autograd.grad((em * g).sum(), xg)  # frozen parameters
    assert calls == {"bwd": 0, "dx": 1} and dx.shape == x.shape
    xr = xr.clone().requires_grad_()
    em = C.fused_conditional_em(xg, zpm, xr, tinv, ks, compute_dtype="float32")
    dx2, dxr = torch.autograd.grad((em * g).sum(), (xg, xr))
    assert calls == {"bwd": 1, "dx": 2}
    torch.testing.assert_close(dx2, dx)
    ks = ks.clone().requires_grad_()
    em = C.fused_conditional_em(x, zpm, xr.detach(), tinv, ks,
                                compute_dtype="float32")
    (dks,) = torch.autograd.grad((em * g).sum(), ks)  # a data panel
    assert calls == {"bwd": 2, "dx": 2} and dks.shape == ks.shape


def _card_inputs(g, S, Tn, Nn, Kn, dev):
    x = torch.randn(Tn, 46, Nn, generator=g, device=dev)
    zpm = torch.randn(S, Tn, Kn, generator=g, device=dev) * 0.3
    xr = torch.randn(S, Tn, Nn, generator=g, device=dev) * 0.1
    tinv = 1.0 / torch.randint(1, Tn + 1, (Nn,), generator=g,
                               device=dev).float()
    kT = torch.randn(S, Kn, 46, generator=g, device=dev) * 0.15
    gem = torch.randn(S, Kn, Nn, generator=g, device=dev)
    return x, zpm, xr, tinv, kT, gem


CARD_SHAPES = [(1, 48, 10000, 8), (3, 7, 1001, 8), (1, 48, 10000, 4),
               (3, 7, 1001, 4)]


@pytest.mark.cuda
def test_dx_kernel_matches_plain_on_card():
    """cond_em_dx against cond_em_dx_reference, ragged N, K = 4, 5, 8 and
    16, and two calls bitwise-equal (needs a card + nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    for S, Tn, Nn, Kn in ((1, 48, 10000, 8), (9, 7, 1001, 8),
                          (9, 7, 1001, 4), (3, 5, 10007, 16),
                          (2, 6, 999, 5)):
        x, zpm, xr, tinv, kT, gem = _card_inputs(g, S, Tn, Nn, Kn, dev)
        for cd in ("float32", "bfloat16"):
            dx = C._launch_dx(x, zpm, xr, tinv, kT, gem, cd)
            assert torch.equal(dx, C._launch_dx(x, zpm, xr, tinv, kT, gem,
                                                cd))
            ref = C.cond_em_dx_reference(x, zpm, xr, tinv, kT, gem, cd)
            torch.testing.assert_close(dx, ref, rtol=0,
                                       atol=REL[cd] * ref.abs().max().item())


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """cond_em_fwd / cond_em_bwd against their plain versions, K = 4 and 8,
    and two backward calls bitwise-equal (needs a card + nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for S, Tn, Nn, Kn in CARD_SHAPES:
        x, zpm, xr, tinv, kT, gem = _card_inputs(g, S, Tn, Nn, Kn, dev)
        for cd in ("float32", "bfloat16"):
            em = C._launch_fwd(x, zpm, xr, tinv, kT, cd)
            ref = C.cond_em_reference(x, zpm, xr, tinv, kT, cd)
            torch.testing.assert_close(em, ref, rtol=0,
                                       atol=REL[cd] * ref.abs().max().item())
            outs = C._launch_bwd(x, zpm, xr, tinv, kT, gem, cd)
            again = C._launch_bwd(x, zpm, xr, tinv, kT, gem, cd)
            assert all(torch.equal(a, b) for a, b in zip(outs, again))
            for a, b in zip(outs, C.cond_em_bwd_reference(
                    x, zpm, xr, tinv, kT, gem, cd)):
                torch.testing.assert_close(
                    a, b, rtol=0, atol=REL[cd] * b.abs().max().item())


@pytest.mark.cuda
def test_plans_hold_on_card():
    """Each plan of cem_plan and cem_dx_plan at the card tests' shapes is
    one the kernels take, and the card keeps at least its blocks resident
    (needs a card + nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for (S, Tn, Nn, Kn), cd in zip(CARD_SHAPES * 2,
                                   ["float32"] * 4 + ["bfloat16"] * 4):
        for plan in C.card_cem_plan(dev, S, Tn, Nn, 46, Kn, cd):
            info = C.plan_info(plan, S, Tn, Nn, 46, Kn, cd)
            assert info["blocks_per_sm"] >= plan.blocks_per_sm
            assert info["local_bytes"] == 0
        plan = C.card_cem_dx_plan(dev, S, Tn, Nn, 46, Kn, cd)
        info = C.dx_plan_info(plan, S, Tn, Nn, 46, Kn, cd)
        assert info["blocks_per_sm"] >= plan.blocks_per_sm
        assert info["local_bytes"] == 0
