"""The PyTorch port's fused SDF-FFN (ops/sdf_ffn.py) against the JAX
package's Pallas kernel.

The same numpy-seeded inputs go through the JAX ``fused_sdf_ffn`` in the
Pallas interpreter (and ``jax.grad`` of it) and through the port's plain
versions, which is what a CPU tensor runs. The CUDA kernels themselves run
only on the card: the packed-parameter layout they read is emulated here in
numpy, and the tests that launch them are marked ``cuda`` and skip without
a card.

Tolerances: f32 weights within atol 2e-5 (the repo's weight parity bar;
only the summation order differs). bf16 within 1e-3·max|w|: both sides
round the operands of every product to bf16 the same way and accumulate in
f32, so only a rounding flip of an activation after a different summation
order (one bf16 ulp, 2⁻⁸ relative) can separate them. Gradients: f32
within 1e-4·max|ref|, bf16 within 2e-2·max|ref| (a flipped rounding feeds
the sums of many products).

Dropout is not compared with JAX (its masks come from the TPU's PRNG,
which the interpreter does not run): the port's masks are held by their
keep share, their unbiasedness, their independence of the stock count, and
by the backward against autograd of the forward with the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.ops import sdf_ffn as K
from deeplearninginassetpricing_paperreplication_tpu.ops.pallas_ffn import (
    fused_sdf_ffn,
)

T, F, N = 6, 5, 37  # ragged N: not a multiple of the 16-stock block


def _params(rng, hidden, S=None):
    """JAX-layout FFN params; with S, each gets a leading member axis."""
    lead = () if S is None else (S,)
    k1 = rng.standard_normal(lead + (F, hidden[0])) / np.sqrt(F)
    mids = [(rng.standard_normal(lead + (a, b)) / np.sqrt(a),
             0.1 * rng.standard_normal(lead + (b,)))
            for a, b in zip(hidden, hidden[1:])]
    ko = rng.standard_normal(lead + (hidden[-1], 1)) / np.sqrt(hidden[-1])
    bo = 0.1 * rng.standard_normal(lead + (1,))
    zp = rng.standard_normal(lead + (T, hidden[0]))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(zp), f32(k1), [(f32(a), f32(b)) for a, b in mids], f32(ko),
            f32(bo))


def _jax_ffn(x, zp, k1, mids, ko, bo, cd):
    return fused_sdf_ffn(
        x, zp, [(k1, None)] + list(mids), ko, bo,
        interpret=True, compute_dtype=cd, block_stocks=16)


def _port_args(zp, k1, mids, ko, bo):
    """JAX layout (member-stacked) → the port's: k1T [S,H1,F], W [S,H,Hin],
    kout [S,HL], bout [S]."""
    t = torch.from_numpy
    return (t(zp), t(np.swapaxes(k1, -1, -2)).contiguous(),
            [(t(np.swapaxes(a, -1, -2)).contiguous(), t(b)) for a, b in mids],
            t(ko[..., 0]), t(bo[..., 0]))


@pytest.mark.parametrize("cd,hidden", [
    ("float32", (8, 8)), ("float32", (8, 8, 8)), ("bfloat16", (8, 8, 8))])
def test_reference_matches_jax_fused_ffn(cd, hidden):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, F, N)).astype(np.float32)
    zp, k1, mids, ko, bo = _params(rng, hidden)
    w_jax = np.asarray(_jax_ffn(jnp.asarray(x), jnp.asarray(zp),
                                jnp.asarray(k1),
                                [(jnp.asarray(a), jnp.asarray(b))
                                 for a, b in mids],
                                jnp.asarray(ko), jnp.asarray(bo), cd))
    args = _port_args(zp[None], k1[None], [(a[None], b[None]) for a, b in mids],
                      ko[None], bo[None])
    w_port = K.sdf_ffn_packed(torch.from_numpy(x), args[0],
                              K.pack_ffn(*args[1:], cd))[0]
    assert w_port.shape == (T, N)
    atol = 2e-5 if cd == "float32" else 1e-3 * np.abs(w_jax).max()
    np.testing.assert_allclose(w_port.numpy(), w_jax, atol=atol)


def test_member_axis_matches_jax_vmap():
    """The explicit member axis against the JAX call vmapped over members
    (its batching rule fires the member-fused kernel, interpret mode)."""
    S, hidden = 3, (8, 8)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, F, N)).astype(np.float32)
    zp, k1, mids, ko, bo = _params(rng, hidden, S=S)

    def one(zp_, k1_, mids_, ko_, bo_):
        return _jax_ffn(jnp.asarray(x), zp_, k1_, mids_, ko_, bo_, "float32")

    w_jax = np.asarray(jax.vmap(one)(
        jnp.asarray(zp), jnp.asarray(k1),
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in mids],
        jnp.asarray(ko), jnp.asarray(bo)))
    before = K.launches
    zp_t, *rest = _port_args(zp, k1, mids, ko, bo)
    w_port = K.sdf_ffn_packed(torch.from_numpy(x), zp_t,
                              K.pack_ffn(*rest, "float32"))
    assert K.launches == before  # a CPU panel never reaches the kernel
    assert w_port.shape == (S, T, N)
    np.testing.assert_allclose(w_port.numpy(), w_jax, atol=2e-5)


def _emulate_kernel(x, zp, packed):
    """The CUDA kernel's arithmetic in numpy, reading ONLY the packed
    buffer through its layout — holds the layout the kernel is given."""
    lay, P = packed.layout, packed.params.numpy()
    bf16 = packed.compute_dtype == "bfloat16"

    def rnd(a):
        if not bf16:
            return a
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            torch.bfloat16).float().numpy()

    S, Tn, H1 = zp.shape
    out = np.zeros((S, Tn, x.shape[2]), np.float32)
    for s in range(S):
        k1 = P[s, :lay.F * lay.hp[0]].reshape(lay.F, lay.hp[0])
        zpp = np.zeros((Tn, lay.hp[0]), np.float32)
        zpp[:, :H1] = zp[s]
        h = rnd(np.maximum(np.einsum("fj,tfn->tjn", k1, rnd(x))
                           + zpp[:, :, None], 0))
        for li in range(1, len(lay.hidden)):
            hin, ho = lay.hp[li - 1], lay.hidden[li]
            W = P[s, lay.off_w[li]:lay.off_w[li] + ho * hin].reshape(ho, hin)
            b = P[s, lay.off_b[li]:lay.off_b[li] + ho]
            nxt = np.zeros((Tn, lay.hp[li], x.shape[2]), np.float32)
            nxt[:, :ho] = rnd(np.maximum(np.einsum("kj,tjn->tkn", W, h)
                                         + b[None, :, None], 0))
            h = nxt
        ko = P[s, lay.off_kout:lay.off_kout + lay.hp[-1]]
        out[s] = np.einsum("j,tjn->tn", ko, h) + P[s, lay.off_bout]
    return out


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_packed_layout_matches_reference(cd):
    """Ragged widths (7, 5, 3: every segment padded to 4) and three
    members: the kernel's view of the packed parameters computes the
    plain version's function."""
    S, hidden = 3, (7, 5, 3)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, F, N)).astype(np.float32)
    zp, k1T, mids, kout, bout = _port_args(*_params(rng, hidden, S=S))
    packed = K.pack_ffn(k1T, mids, kout, bout, cd)
    lay = packed.layout
    assert lay.hp == (8, 8, 4) and lay.P % 4 == 0 and packed.params.shape == (
        S, lay.P)
    ref = K.sdf_ffn_reference(torch.from_numpy(x), zp, k1T, mids, kout, bout,
                              cd).numpy()
    emu = _emulate_kernel(x, zp.numpy(), packed)
    np.testing.assert_allclose(emu, ref, atol=1e-5)


def test_wrapper_routes_and_refusals():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((T, F, N)).astype(np.float32))
    zp, k1T, mids, kout, bout = _port_args(*_params(rng, (8, 8), S=2))
    packed = K.pack_ffn(k1T, mids, kout, bout, "float32")
    plain = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout, "float32")
    for kernel in ("auto", "off"):
        torch.testing.assert_close(
            K.sdf_ffn_packed(x, zp, packed, kernel=kernel), plain)
    with pytest.raises(ValueError, match="CUDA"):
        K.sdf_ffn_packed(x, zp, packed, kernel="on")
    # training-mode dropout: the plain route draws the kernels' masks
    dropped = K.sdf_ffn_packed(x, zp, packed, dropout_rate=0.05, seed=9)
    torch.testing.assert_close(dropped, K.sdf_ffn_reference(
        x, zp, k1T, mids, kout, bout, "float32", 9, 0.05))
    assert not torch.equal(dropped, plain)
    with pytest.raises(ValueError, match="dropout"):
        K.sdf_ffn(x, zp, k1T, mids, kout, bout, dropout_rate=1.0)
    with pytest.raises(ValueError, match="compute_dtype"):
        K.pack_ffn(k1T, mids, kout, bout, "float16")
    assert K.width_bound((64, 64)) == 64 and K.width_bound((8,)) == 32
    # wider stacks take the streamed route (bound: the width padded to
    # 128); past its limit no route takes them
    assert K.width_bound((200,)) == 256
    with pytest.raises(ValueError, match="exceeds"):
        K.width_bound((K.STREAM_MAX_WIDTH + 1,))
    # bound bookkeeping: 2·(F·H1 + H1·H2 + H2) per (member, period, stock)
    assert K.flops(3, 4, 16384, 46, (64, 64)) == 2 * (
        46 * 64 + 64 * 64 + 64) * 3 * 4 * 16384


def _jax_grads(x, zp, k1, mids, ko, bo, g, cd):
    """jax.grad of Σ g·w through the interpreted Pallas kernel."""
    def loss(zp, k1, mids, ko, bo):
        return jnp.sum(_jax_ffn(jnp.asarray(x), zp, k1, mids, ko, bo, cd)
                       * g)
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(zp), jnp.asarray(k1),
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in mids],
        jnp.asarray(ko), jnp.asarray(bo))


def _port_grads(x, args, g, cd, S):
    """sdf_ffn_bwd_reference in the JAX layout (member axis kept)."""
    zp, k1T, mids, kout, _ = args
    dzp, dk1T, dmids, dkout, dbout = K.sdf_ffn_bwd_reference(
        torch.from_numpy(x), zp, k1T, mids, kout,
        torch.from_numpy(g).reshape(S, T, N), cd)
    return (dzp, dk1T.transpose(1, 2),
            [(dW.transpose(1, 2), db) for dW, db in dmids],
            dkout[..., None], dbout[:, None])


def _close_grads(port, ref, cd, squeeze):
    rel = 1e-4 if cd == "float32" else 2e-2
    flat_p = [port[0], port[1]] + [t for wb in port[2] for t in wb] + [
        port[3], port[4]]
    flat_r = [ref[0], ref[1]] + [t for wb in ref[2] for t in wb] + [
        ref[3], ref[4]]
    for i, (p, r) in enumerate(zip(flat_p, flat_r)):
        p = p.numpy()[0] if squeeze else p.numpy()
        r = np.asarray(r)
        np.testing.assert_allclose(p, r, rtol=0,
                                   atol=rel * np.abs(r).max() + 1e-12,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("cd,hidden", [
    ("float32", (8, 8)), ("float32", (8, 8, 8)), ("bfloat16", (8, 8)),
    ("bfloat16", (8, 8, 8)), ("float32", (128, 128))])
def test_bwd_reference_matches_jax_grad(cd, hidden):
    """The backward's plain version against jax.grad of the JAX kernel
    (ragged N: the second 16-stock block holds 5), also at the sweep grid's
    widest hidden (128, 128) (parallel/sweep.py:82)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((T, F, N)).astype(np.float32)
    zp, k1, mids, ko, bo = _params(rng, hidden)
    g = rng.standard_normal((T, N)).astype(np.float32)
    ref = _jax_grads(x, zp, k1, mids, ko, bo, g, cd)
    args = _port_args(zp[None], k1[None],
                      [(a[None], b[None]) for a, b in mids], ko[None],
                      bo[None])
    _close_grads(_port_grads(x, args, g, cd, 1), ref, cd, squeeze=True)


def test_bwd_member_axis_matches_jax_vmap_grad():
    S, hidden = 3, (8, 8)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((T, F, N)).astype(np.float32)
    zp, k1, mids, ko, bo = _params(rng, hidden, S=S)
    g = rng.standard_normal((S, T, N)).astype(np.float32)

    def one(zp_, k1_, mids_, ko_, bo_, g_):
        return jax.grad(lambda *p: jnp.sum(_jax_ffn(
            jnp.asarray(x), *p, "float32") * g_), argnums=(0, 1, 2, 3, 4))(
            zp_, k1_, mids_, ko_, bo_)

    ref = jax.vmap(one)(jnp.asarray(zp), jnp.asarray(k1),
                        [(jnp.asarray(a), jnp.asarray(b)) for a, b in mids],
                        jnp.asarray(ko), jnp.asarray(bo), jnp.asarray(g))
    args = _port_args(zp, k1, mids, ko, bo)
    _close_grads(_port_grads(x, args, g, "float32", S), ref, "float32",
                 squeeze=False)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_bwd_reference_is_autograd_of_the_forward(rate):
    """With dropout on and one seed, the plain backward regenerates the
    forward's masks: it equals torch autograd through the plain forward
    (f32, three members, a ragged mid stack)."""
    S, hidden = 3, (7, 5, 3)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((T, F, N)).astype(np.float32))
    zp, k1T, mids, kout, bout = _port_args(*_params(rng, hidden, S=S))
    params = [zp, k1T, kout, bout] + [t for wb in mids for t in wb]
    for p in params:
        p.requires_grad_()
    g = torch.from_numpy(rng.standard_normal((S, T, N)).astype(np.float32))
    out = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout, "float32", 21,
                              rate)
    auto = torch.autograd.grad((out * g).sum(), params)
    dzp, dk1T, dmids, dkout, dbout = K.sdf_ffn_bwd_reference(
        x, zp.detach(), k1T.detach(), [(w.detach(), b.detach())
                                       for w, b in mids],
        kout.detach(), g, "float32", 21, rate)
    got = [dzp, dk1T, dkout, dbout] + [t for wb in dmids for t in wb]
    for a, b in zip(got, auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # the differentiable entry takes the same route on a CPU tensor
    out2 = K.sdf_ffn(x, zp, k1T, mids, kout, bout, seed=21,
                     dropout_rate=rate, compute_dtype="float32")
    for a, b in zip(torch.autograd.grad((out2 * g).sum(), params), auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dropout_keep_share_and_tiling_independence():
    keep = K.dropout_keep(seed=3, rate=0.05, layer=1, S=2, T=8, H=64, N=1000)
    share = keep.float().mean().item()  # 1,024,000 units: σ ≈ 2e-4
    assert abs(share - 0.95) < 2e-3
    # a unit's bit depends on (seed, s, t, n, layer, j) only: not on N
    wider = K.dropout_keep(seed=3, rate=0.05, layer=1, S=2, T=8, H=64,
                           N=1500)
    assert torch.equal(keep, wider[..., :1000])
    assert not torch.equal(keep, K.dropout_keep(4, 0.05, 1, 2, 8, 64, 1000))
    assert not torch.equal(keep, K.dropout_keep(3, 0.05, 0, 2, 8, 64, 1000))
    threshold, scale = K.dropout_params(0.05)
    assert threshold == round(0.05 * 2 ** 32)
    assert scale == pytest.approx(1 / 0.95, rel=1e-7)


def test_dropout_is_unbiased():
    """Inverted dropout: the mean output over seeds approaches the
    no-dropout output (inputs positive, so every ReLU is active)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(np.abs(rng.standard_normal((4, 3, 64))).astype(
        np.float32))
    zp = torch.ones(1, 4, 16)
    k1T = torch.from_numpy(np.abs(rng.standard_normal((1, 16, 3))).astype(
        np.float32))
    kout, bout = torch.ones(1, 16), torch.zeros(1)
    det = K.sdf_ffn_reference(x, zp, k1T, [], kout, bout)
    runs = torch.stack([K.sdf_ffn_reference(x, zp, k1T, [], kout, bout,
                                            "float32", s, 0.3)
                        for s in range(40)])
    ratio = (runs.mean(0).sum() / det.sum()).item()
    assert abs(ratio - 1.0) < 0.02
    assert ((runs == 0) | (runs > 0)).all()


def _jax_dx(x, zp, k1, mids, ko, bo, g, S=None):
    """jax.grad w.r.t. the panel of Σ g·w through the interpreted Pallas
    kernel (f32); with S, of the call vmapped over the members (the dx
    primitive's sequential fallback), so the members' cotangents sum."""
    def one(x_, zp_, k1_, mids_, ko_, bo_):
        return _jax_ffn(x_, zp_, k1_, mids_, ko_, bo_, "float32")

    j = lambda a: jnp.asarray(a)  # noqa: E731
    p = (j(zp), j(k1), [(j(a), j(b)) for a, b in mids], j(ko), j(bo))
    if S is None:
        return jax.grad(lambda x_: jnp.sum(one(x_, *p) * g))(j(x))
    return jax.grad(lambda x_: jnp.sum(jax.vmap(
        one, in_axes=(None, 0, 0, 0, 0, 0))(x_, *p) * g))(j(x))


def test_panel_gradient_matches_jax_and_kernel_on_refuses_cpu():
    """The panel's gradient is refused only on the kernel route of a CPU
    panel (no quiet fallback to the plain version); on the plain route it
    runs: autograd of the fused FFN w.r.t. x_t against jax.grad of the JAX
    kernel, one member, ragged N (21 stocks against a 16-stock block), f32
    within 1e-4·max|ref|."""
    n = 21
    rng = np.random.default_rng(10)
    x = rng.standard_normal((T, F, n)).astype(np.float32)
    zp, k1, mids, ko, bo = _params(rng, (8, 8))
    g = rng.standard_normal((T, n)).astype(np.float32)
    ref = np.asarray(_jax_dx(x, zp, k1, mids, ko, bo, g))
    xt = torch.from_numpy(x).requires_grad_()
    args = _port_args(zp[None], k1[None], [(a[None], b[None]) for a, b in mids],
                      ko[None], bo[None])
    before = (K.launches, K.bwd_launches, K.dx_launches)
    out = K.sdf_ffn(xt, *args, compute_dtype="float32")
    (dx,) = torch.autograd.grad((out[0] * torch.from_numpy(g)).sum(), xt)
    assert (K.launches, K.bwd_launches, K.dx_launches) == before
    assert dx.shape == (T, F, n)
    np.testing.assert_allclose(dx.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    with pytest.raises(ValueError, match="CUDA"):
        K.sdf_ffn(xt, *args, compute_dtype="float32", kernel="on")


def test_panel_gradient_member_axis_matches_jax_vmap():
    """S = 3 members over one panel: the port's dx sums the members'
    cotangents, as jax.grad of the JAX call vmapped over the members does
    (f32, ragged N)."""
    S, n = 3, 21
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T, F, n)).astype(np.float32)
    zp, k1, mids, ko, bo = _params(rng, (8, 8), S=S)
    g = rng.standard_normal((S, T, n)).astype(np.float32)
    ref = np.asarray(_jax_dx(x, zp, k1, mids, ko, bo, g, S=S))
    zp_t, *rest = _port_args(zp, k1, mids, ko, bo)
    dx = K.sdf_ffn_dx_reference(torch.from_numpy(x), zp_t, rest[0], rest[1],
                                rest[2], torch.from_numpy(g), "float32")
    np.testing.assert_allclose(dx.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("seed", [21, [21, 22, 23]], ids=["one", "per_member"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_dx_reference_is_autograd_of_the_forward(seed, cd):
    """With dropout 0.05 the plain panel cotangent regenerates the
    forward's masks: it equals torch autograd w.r.t. x_t through the plain
    forward (three members, a ragged mid stack). f32 to 1e-5 (the same
    einsums); bf16 within 2e-2·max|ref|, because autograd does not round
    the backward's operands as the kernel does."""
    S, hidden = 3, (7, 5, 3)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((T, F, N)).astype(
        np.float32)).requires_grad_()
    zp, k1T, mids, kout, bout = _port_args(*_params(rng, hidden, S=S))
    g = torch.from_numpy(rng.standard_normal((S, T, N)).astype(np.float32))
    out = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout, cd, seed, 0.05)
    (auto,) = torch.autograd.grad((out * g).sum(), x)
    dx = K.sdf_ffn_dx_reference(x.detach(), zp, k1T, mids, kout, g, cd, seed,
                                0.05)
    rel = 1e-5 if cd == "float32" else 2e-2
    torch.testing.assert_close(dx, auto, rtol=0,
                               atol=rel * auto.abs().max().item())


def test_backward_runs_only_what_is_asked(monkeypatch):
    """The autograd Function's backward runs the panel cotangent only when
    x_t needs a gradient and the parameter backward only when zp or a
    weight does, and returns None for every other input."""
    calls = {"bwd": 0, "dx": 0}
    for name, key in (("sdf_ffn_bwd_reference", "bwd"),
                      ("sdf_ffn_dx_reference", "dx")):
        def counted(*a, _f=getattr(K, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((T, F, N)).astype(np.float32))
    zp, k1T, mids, kout, bout = _port_args(*_params(rng, (8, 8), S=2))
    xg = x.clone().requires_grad_()
    out = K.sdf_ffn(xg, zp, k1T, mids, kout, bout, compute_dtype="float32")
    (dx,) = torch.autograd.grad(out.sum(), xg)  # frozen parameters
    assert calls == {"bwd": 0, "dx": 1} and dx.shape == x.shape
    kout = kout.clone().requires_grad_()
    out = K.sdf_ffn(x, zp, k1T, mids, kout, bout, compute_dtype="float32")
    (dkout,) = torch.autograd.grad(out.sum(), kout)  # a data panel
    assert calls == {"bwd": 1, "dx": 1} and dkout.shape == kout.shape
    bout = bout.clone().requires_grad_()
    out = K.sdf_ffn(x, zp, k1T, mids, kout.detach(), bout,
                    compute_dtype="float32")
    out.sum().backward()
    assert calls == {"bwd": 2, "dx": 1} and bout.grad is not None
    torch.testing.assert_close(bout.grad, torch.full_like(bout, T * N))


# the sweep grid's other widths (parallel/sweep.py:82), one member and
# three, ragged N: (S, T, N, hidden)
SWEEP_CASES = tuple((S, 6, N, h)
                    for h in ((128, 128), (64, 64, 64), (32, 32))
                    for S, N in ((1, 2001), (3, 1003)))


@pytest.mark.cuda
def test_bwd_kernel_matches_reference_on_card():
    """sdf_ffn_bwd against sdf_ffn_bwd_reference with dropout, and two
    calls bitwise-equal (needs a card + nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    for S, Tn, Nn, hidden in ((1, 48, 10000, (64, 64)),
                              (2, 3, 1001, (8, 7, 6))) + SWEEP_CASES:
        x = torch.randn(Tn, 46, Nn, generator=g, device=dev)
        zp = torch.randn(S, Tn, hidden[0], generator=g, device=dev)
        k1T = torch.randn(S, hidden[0], 46, generator=g, device=dev) * 0.15
        mids = [(torch.randn(S, b, a, generator=g, device=dev) * a ** -0.5,
                 torch.randn(S, b, generator=g, device=dev) * 0.1)
                for a, b in zip(hidden, hidden[1:])]
        kout = torch.randn(S, hidden[-1], generator=g, device=dev) * 0.1
        bout = torch.randn(S, generator=g, device=dev) * 0.1
        gout = torch.randn(S, Tn, Nn, generator=g, device=dev)
        for cd in ("float32", "bfloat16"):
            packed = K.pack_ffn(k1T, mids, kout, bout, cd)
            grads, dzp = K._launch_bwd(x, zp, packed, gout, 5, 0.05)
            again = K._launch_bwd(x, zp, packed, gout, 5, 0.05)
            assert torch.equal(grads, again[0]) and torch.equal(dzp, again[1])
            dk1T, dmids, dkout, dbout = K.unpack_grads(grads, packed.layout)
            ref = K.sdf_ffn_bwd_reference(x, zp, k1T, mids, kout, gout, cd,
                                          5, 0.05)
            got = [dzp, dk1T, dkout, dbout] + [t for wb in dmids for t in wb]
            want = [ref[0], ref[1], ref[3], ref[4]] + [
                t for wb in ref[2] for t in wb]
            rel = 1e-4 if cd == "float32" else 2e-2
            for a, b in zip(got, want):
                torch.testing.assert_close(
                    a, b, rtol=0, atol=rel * b.abs().max().item())


@pytest.mark.cuda
def test_dx_kernel_matches_reference_on_card():
    """sdf_ffn_dx against sdf_ffn_dx_reference with dropout 0.05 and
    without (the panel-gradient path), one seed per member, ragged N (a
    multiple of 4 or not), and two calls bitwise-equal (needs a card +
    nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    for S, Tn, Nn, hidden in ((1, 48, 10000, (64, 64)),
                              (3, 48, 10007, (64, 64)),
                              (3, 5, 1001, (8, 7, 6))) + SWEEP_CASES:
        x = torch.randn(Tn, 46, Nn, generator=g, device=dev)
        zp = torch.randn(S, Tn, hidden[0], generator=g, device=dev)
        k1T = torch.randn(S, hidden[0], 46, generator=g, device=dev) * 0.15
        mids = [(torch.randn(S, b, a, generator=g, device=dev) * a ** -0.5,
                 torch.randn(S, b, generator=g, device=dev) * 0.1)
                for a, b in zip(hidden, hidden[1:])]
        kout = torch.randn(S, hidden[-1], generator=g, device=dev) * 0.1
        bout = torch.randn(S, generator=g, device=dev) * 0.1
        gout = torch.randn(S, Tn, Nn, generator=g, device=dev)
        seed = list(range(5, 5 + S))
        for cd in ("float32", "bfloat16"):
            packed = K.pack_ffn(k1T, mids, kout, bout, cd)
            for rate in (0.0, 0.05):
                dx = K._launch_dx(x, zp, packed, gout, seed, rate)
                assert torch.equal(dx, K._launch_dx(x, zp, packed, gout,
                                                    seed, rate))
                ref = K.sdf_ffn_dx_reference(x, zp, k1T, mids, kout, gout,
                                             cd, seed, rate)
                rel = 1e-4 if cd == "float32" else 2e-2
                torch.testing.assert_close(dx, ref, rtol=0,
                                           atol=rel * ref.abs().max().item())


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """The CUDA kernel against its plain version (needs a card + nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for S, Tn, Nn, hidden in ((1, 1, 16384, (64, 64)), (3, 4, 10007, (64, 64)),
                              (2, 3, 1001, (8, 7, 6))) + SWEEP_CASES:
        x = torch.randn(Tn, 46, Nn, generator=g, device=dev)
        zp = torch.randn(S, Tn, hidden[0], generator=g, device=dev)
        k1T = torch.randn(S, hidden[0], 46, generator=g, device=dev) * 0.15
        mids = [(torch.randn(S, b, a, generator=g, device=dev) * a ** -0.5,
                 torch.randn(S, b, generator=g, device=dev) * 0.1)
                for a, b in zip(hidden, hidden[1:])]
        kout = torch.randn(S, hidden[-1], generator=g, device=dev) * 0.1
        bout = torch.randn(S, generator=g, device=dev) * 0.1
        for cd in ("float32", "bfloat16"):
            before = K.launches
            out = K.sdf_ffn_packed(x, zp, K.pack_ffn(k1T, mids, kout, bout,
                                                     cd))
            torch.cuda.synchronize()
            assert K.launches == before + 1
            ref = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout, cd)
            tol = (dict(rtol=1e-4, atol=1e-5) if cd == "float32"
                   else dict(rtol=0, atol=2e-2 * ref.abs().max().item()))
            torch.testing.assert_close(out, ref, **tol)
