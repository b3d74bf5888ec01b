"""Why the stock sum's backward all-reduces: the gradient of a loss with
nested stock sums on gloo CPU ranks, under the port's ``stock_sum`` and
under an identity backward.

The losses are stock sums of terms in F, and F (with the cross-sectional
zero-mean) is itself a stock sum. Every rank computes F and the loss in
full, so a rank's cotangent of F covers only its own stocks' terms; the
stocks behind F on that rank need the sum over ranks. This script trains
nothing: it takes a toy panel (T = 5, N = 8, a three-parameter weight
map), computes the gradient of the zero-mean + unconditional + residual
loss unsharded, then on `--world` ranks with

* the port's ``parallel.collectives.stock_sum`` (all_reduce forward and
  backward) and ``all_reduce_grads`` (one all-reduce, divided by world);
* an identity backward with one plain all-reduce of the gradients,

and prints each one's max |g − g_unsharded| beside max |g_unsharded|.

    python tools/stock_sum_backward.py [--world 2]

CPU only, a few seconds.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeplearninginassetpricing_paperreplication_torch.models.networks import (  # noqa: E402,E501
    masked_zero_mean,
)
from deeplearninginassetpricing_paperreplication_torch.ops import (  # noqa: E402
    losses,
)
from deeplearninginassetpricing_paperreplication_torch.parallel import (  # noqa: E402,E501
    collectives,
)


def toy(seed=0, T=5, N=8):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(T, N, generator=g)
    R = torch.randn(T, N, generator=g) * 0.1
    m = (torch.rand(T, N, generator=g) > 0.2).float()
    return w, R, m, torch.randn(3, generator=g)


def loss_of(theta, w, R, m, shard=None):
    wt = masked_zero_mean((theta[0] * w + theta[1] * w * w + theta[2]) * m,
                          m, shard)
    n = shard.n_global if shard is not None else None
    loss, _ = losses.unconditional_loss(wt, R, m, n_assets=n, shard=shard)
    return loss + losses.residual_loss(wt, R, m, shard)


def _identity_backward(ctx, g):
    if not ctx.keepdim:
        g = g.unsqueeze(ctx.dim)
    shape = list(g.shape)
    shape[ctx.dim] = ctx.size
    return g.expand(shape), None, None, None


def rank_main(rank, world, workdir, scheme):
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, f"s_{scheme}"),
                                     world), rank=rank, world_size=world)
    if scheme == "identity":
        collectives._StockSum.backward = staticmethod(_identity_backward)
    w, R, m, theta = toy()
    shard = collectives.shard_of(w.shape[1])
    a, b = shard.span
    theta = theta.clone().requires_grad_(True)
    loss = loss_of(theta, *(x[:, a:b].contiguous() for x in (w, R, m)),
                   shard)
    (g,) = torch.autograd.grad(loss, theta)
    if scheme == "identity":
        dist.all_reduce(g)
    else:
        (g,) = collectives.all_reduce_grads([g], shard)
    if rank == 0:
        torch.save(g, os.path.join(workdir, f"g_{scheme}.pt"))
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    args = ap.parse_args(argv)
    w, R, m, theta = toy()
    theta = theta.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(loss_of(theta, w, R, m), theta)
    with tempfile.TemporaryDirectory() as wd:
        for scheme in ("port", "identity"):
            mp.start_processes(rank_main, args=(args.world, wd, scheme),
                               nprocs=args.world, start_method="spawn")
            g = torch.load(os.path.join(wd, f"g_{scheme}.pt"))
            print(f"{scheme:8s} backward, world {args.world}: max|g - "
                  f"g_unsharded| {float((g - ref).abs().max()):.3e} against "
                  f"max|g_unsharded| {float(ref.abs().max()):.3e}")


if __name__ == "__main__":
    main()
