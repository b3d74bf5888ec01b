"""The PyTorch port's fused SDF-FFN (ops/sdf_ffn.py) against the JAX
package's Pallas kernel.

The same numpy-seeded inputs go through the JAX ``fused_sdf_ffn`` in the
Pallas interpreter and through the port's plain version, which is what a
CPU tensor runs. The CUDA kernel itself runs only on the card: the
packed-parameter layout it reads is emulated here in numpy, and the test
that launches it is marked ``cuda`` and skips without a card.

Tolerances: f32 weights within atol 2e-5 (the repo's weight parity bar;
only the summation order differs). bf16 within 1e-3·max|w|: both sides
round the operands of every product to bf16 the same way and accumulate in
f32, so only a rounding flip of an activation after a different summation
order (one bf16 ulp, 2⁻⁸ relative) can separate them.
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
    with pytest.raises(ValueError, match="dropout"):
        K.sdf_ffn_packed(x, zp, packed, dropout_rate=0.05)
    with pytest.raises(ValueError, match="compute_dtype"):
        K.pack_ffn(k1T, mids, kout, bout, "float16")
    assert K.width_bound((64, 64)) == 64 and K.width_bound((8,)) == 32
    with pytest.raises(ValueError, match="exceeds"):
        K.width_bound((200,))
    # bound bookkeeping: 2·(F·H1 + H1·H2 + H2) per (member, period, stock)
    assert K.flops(3, 4, 16384, 46, (64, 64)) == 2 * (
        46 * 64 + 64 * 64 + 64) * 3 * 4 * 16384


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """The CUDA kernel against its plain version (needs a card + nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for S, Tn, Nn, hidden in ((1, 1, 16384, (64, 64)), (3, 4, 10007, (64, 64)),
                              (2, 3, 1001, (8, 7, 6))):
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
