"""How far the panel cotangent's bf16 plain version moves when its
pre-activations move by an f32 ulp, and how many top-layer elements the
tensor-core route of ``sdf_ffn_dx`` must recompute as the exact chain.

The backward uses ReLU's derivative, a step. A sum taken in another order
(the tensor cores' accumulation) moves a pre-activation by an ulp or two;
where that carries it across 0, the unit's factor flips and a whole term of
dx moves. This script perturbs every pre-activation of
``sdf_ffn_dx_reference`` (bf16 rounding points, hidden (64, 64), F = 46) by
a relative ``eps`` and prints max|d|/max|ref| against the unperturbed
version, beside the kernels' bf16 bar (2e-2). Then it prints the share of
top-layer pre-activations within the bound csrc/sdf_ffn_dx.cu certifies
(kCertify · (max|a| · Σ|W| + |b|)), which the kernel recomputes.

    python tools/dx_flip_sensitivity.py            # S = 3, T = 8, N = 10,007

CPU only, about a minute.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeplearninginassetpricing_paperreplication_torch.ops import (  # noqa: E402
    sdf_ffn as K,
)

CERTIFY = 2.0 ** -16  # csrc/sdf_ffn_dx.cu kCertify


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--S", type=int, default=3)
    ap.add_argument("--T", type=int, default=8)
    ap.add_argument("--N", type=int, default=10_007)
    ap.add_argument("--seed", type=int, default=4)
    a = ap.parse_args(argv)
    S, T, N, F, H, cd = a.S, a.T, a.N, 46, 64, "bfloat16"
    g = torch.Generator().manual_seed(a.seed)
    x = torch.randn(T, F, N, generator=g)
    zp = torch.randn(S, T, H, generator=g) * 0.3
    k1T = torch.randn(S, H, F, generator=g) * F ** -0.5
    W = torch.randn(S, H, H, generator=g) * H ** -0.5
    b = torch.randn(S, H, generator=g) * 0.1
    kout = torch.randn(S, H, generator=g) * H ** -0.5
    gout = torch.randn(S, T, N, generator=g) / N
    ref = K.sdf_ffn_dx_reference(x, zp, k1T, [(W, b)], kout, gout, cd)
    R = lambda t: K._round(t, cd)  # noqa: E731

    def perturbed(eps):
        h0 = torch.einsum("shf,tfn->sthn", R(k1T), R(x)) + zp[..., None]
        h0 = h0 * (1 + eps * torch.randn(h0.shape, generator=g))
        a0 = torch.relu(h0)
        h1 = torch.einsum("sko,ston->stkn", R(W), R(a0)) + b[:, None, :, None]
        h1 = h1 * (1 + eps * torch.randn(h1.shape, generator=g))
        dh = R(kout)[:, None, :, None] * R(gout)[:, :, None, :]
        d0 = torch.einsum("sji,stjn->stin", R(W), R(dh * (h1 > 0))) * (h0 > 0)
        return torch.einsum("sjf,stjn->tfn", R(k1T), R(d0))

    scale = float(ref.abs().max())
    print(f"S={S} T={T} N={N} F={F} hidden=({H}, {H}) bf16; bar 2e-2")
    for eps in (0.0, 2.0 ** -23, 2.0 ** -21):
        d = (perturbed(eps) - ref).abs()
        print(f"pre-activations moved by {eps:.3g} relative: max|d|/max|ref| "
              f"{float(d.max()) / scale:.3e}; elements off by > 1e-3·max "
              f"{int((d > 1e-3 * scale).sum())}")
    h0 = torch.einsum("shf,tfn->sthn", R(k1T), R(x)) + zp[..., None]
    a0 = R(torch.relu(h0))
    h1 = torch.einsum("sko,ston->stkn", R(W), a0) + b[:, None, :, None]
    bound = CERTIFY * (a0.abs().amax(dim=2, keepdim=True)
                       * R(W).abs().sum(dim=2)[:, None, :, None]
                       + b.abs()[:, None, :, None])
    share = float((h1.abs() <= bound).float().mean())
    print(f"top-layer pre-activations within the certified bound: {share:.3e}"
          f" (a 16-stock warp step has {16 * H} of them)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
