"""Stock-sharded training's collectives on CPU ranks, and the rank workers
the other sharded tests spawn.

Each world is spawned once per test (``torch.multiprocessing`` with the
gloo backend over a ``FileStore`` under ``tmp_path``, no TCP port): the
ranks load their inputs from the work dir, compute, and save their outputs
there; the test process holds them against the unsharded route (here) or
the JAX package (``test_torch_shard_train.py``, ``test_torch_shard_data.py``).
This module imports no JAX, so a rank starts fast.

The tests here hold the collectives on a loss with nested stock sums (a
loss summed over stocks of terms in F, itself a stock sum), where a
``stock_sum`` with an identity backward would miss the cross-rank terms:
the sharded gradient must be the unsharded one at world sizes 2 and 4.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deeplearninginassetpricing_paperreplication_torch.parallel import (
    collectives,
    partition,
)


def spawn(fn, world: int, workdir: Path, *args) -> None:
    """Run fn(rank, world, workdir, *args) on `world` gloo ranks joined
    through a FileStore in `workdir`."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        store.unlink()
    mp.start_processes(_rank_main, args=(world, str(workdir), fn, args),
                       nprocs=world, join=True, start_method="spawn")


def _rank_main(rank, world, workdir, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        fn(rank, world, Path(workdir), *args)
    finally:
        dist.destroy_process_group()


def local_batch(batch, world, rank):
    """`batch` (host arrays) as rank `rank`'s CPU tensors under the
    canonical stock sharding of a world of `world`."""
    mesh = partition.create_mesh(devices=range(world))
    tb = {k: torch.as_tensor(np.asarray(v, np.float32))
          for k, v in batch.items()}
    return partition.shard_batch(tb, mesh, device=rank)


# -- the nested-sum toy ------------------------------------------------------


def _toy(seed=0, T=5, N=8):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(T, N, generator=g)
    R = torch.randn(T, N, generator=g) * 0.1
    m = (torch.rand(T, N, generator=g) > 0.2).float()
    theta = torch.randn(3, generator=g)
    return w, R, m, theta


def _toy_loss(theta, w, R, m, shard=None):
    """A loss of the losses' shape: weights from a replicated parameter, a
    zero-mean over stocks, F a stock sum, then a stock sum of terms in F."""
    from deeplearninginassetpricing_paperreplication_torch.models.networks \
        import masked_zero_mean
    from deeplearninginassetpricing_paperreplication_torch.ops import losses

    wt = (theta[0] * w + theta[1] * w * w + theta[2]) * m
    wt = masked_zero_mean(wt, m, shard)
    n = shard.n_global if shard is not None else None
    loss, _ = losses.unconditional_loss(wt, R, m, n_assets=n, shard=shard)
    return loss + losses.residual_loss(wt, R, m, shard)


def _toy_worker(rank, world, workdir):
    w, R, m, theta = _toy()
    shard = collectives.shard_of(w.shape[1])
    a, b = shard.span
    theta = theta.clone().requires_grad_(True)
    loss = _toy_loss(theta, w[:, a:b].contiguous(), R[:, a:b].contiguous(),
                     m[:, a:b].contiguous(), shard)
    (g,) = torch.autograd.grad(loss, theta)
    (g,) = collectives.all_reduce_grads([g], shard)
    torch.save({"loss": loss.detach(), "grad": g},
               workdir / f"toy{rank}.pt")


@pytest.mark.parametrize("world", [2, 4])
def test_stock_sum_gives_the_unsharded_gradient(tmp_path, world):
    """The sharded loss and the all-reduced gradient of a replicated
    parameter equal the unsharded ones (only the sums' order differs), and
    every rank holds the same bytes."""
    spawn(_toy_worker, world, tmp_path)
    w, R, m, theta = _toy()
    theta = theta.clone().requires_grad_(True)
    loss = _toy_loss(theta, w, R, m)
    (g,) = torch.autograd.grad(loss, theta)
    outs = [torch.load(tmp_path / f"toy{r}.pt") for r in range(world)]
    for o in outs:
        np.testing.assert_allclose(float(o["loss"]), float(loss.detach()),
                                   rtol=1e-6)
        # theta[2] (a bias the zero-mean removes) has a zero gradient up
        # to rounding: absolute bar relative to the largest entry
        np.testing.assert_allclose(o["grad"].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()))
        assert torch.equal(o["grad"], outs[0]["grad"])


def test_world_size_one_runs_no_collective():
    """Without a process group, or at world size 1, stock_sum is the plain
    sum, all_reduce_grads the identity and shard_of the whole axis."""
    x = torch.randn(3, 7)
    shard = collectives.shard_of(7)
    assert (shard.rank, shard.world, shard.span) == (0, 1, (0, 7))
    assert not collectives.is_sharded(shard)
    assert torch.equal(collectives.stock_sum(x, -1, shard), x.sum(dim=-1))
    assert torch.equal(collectives.stock_sum(x, -1, shard, keepdim=True),
                       x.sum(dim=-1, keepdim=True))
    grads = [torch.randn(2), torch.randn(3, 1)]
    assert collectives.all_reduce_grads(grads, shard) == grads
    assert collectives.gather_ints([3, 4], shard, "cpu") == [[3, 4]]


# -- rank workers of test_torch_shard_train.py ---------------------------------


def _span_of(x, a, b, dim):
    return torch.as_tensor(np.ascontiguousarray(
        np.take(np.asarray(x, np.float32), np.arange(a, b), axis=dim)))


def losses_steps_worker(rank, world, workdir):
    """The losses of a toy panel, one step of each phase (loss, raw
    gradients, grad norm, parameters after) and the plain FFN, dropout
    masks and conditional-EM on this rank's stocks."""
    from deeplearninginassetpricing_paperreplication_torch.models.gan import (
        GAN,
    )
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        cond_em as C,
    )
    from deeplearninginassetpricing_paperreplication_torch.ops import losses
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        sdf_ffn as K,
    )
    from deeplearninginassetpricing_paperreplication_torch.training import (
        steps,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig

    inp = torch.load(workdir / "in.pt", weights_only=False)
    out = {}
    toy = inp["toy"]
    shard = collectives.shard_of(toy["w"].shape[1])
    a, b = shard.span
    w, R, m = (_span_of(toy[k], a, b, 1) for k in ("w", "R", "m"))
    h = _span_of(toy["h"], a, b, 2)
    n = toy["n_assets"]
    out["losses"] = {
        "F": losses.portfolio_returns(w, R, m, True, shard),
        "unconditional": losses.unconditional_loss(
            w, R, m, n_assets=n, shard=shard)[0],
        "conditional": losses.conditional_loss(
            w, R, m, h, n_assets=n, shard=shard)[0],
        "residual": losses.residual_loss(w, R, m, shard),
    }

    cfg = GANConfig(**inp["cfg"])
    lb = local_batch(inp["batch"], world, rank)
    ec = ExecutionConfig(device="cpu", compute_dtype="float32",
                         shard=collectives.shard_of(
                             inp["batch"]["returns"].shape[1]))
    out["steps"] = {}
    for phase in ("unconditional", "moment", "conditional"):
        key = steps.trainable_key(phase)
        gan = GAN.from_state_dict(cfg, inp["state_dict"], ec)
        steps.set_trainable(gan, key)
        o = gan.forward(lb, phase=phase)
        names = [k for k, p in gan.module.named_parameters()
                 if k.startswith(key + ".")]
        grads = torch.autograd.grad(o["loss"],
                                    steps.subtree_params(gan, key))
        grads = collectives.all_reduce_grads(grads, ec.shard)
        gan2 = GAN.from_state_dict(cfg, inp["state_dict"], ec)
        opt = steps.Optimizer(steps.subtree_params(gan2, key), 1e-3)
        met = steps.train_step(gan2, phase, opt, lb, None)
        out["steps"][phase] = dict(
            loss=o["loss"].detach(), grads=dict(zip(names, grads)),
            step_loss=met["loss"], grad_norm=met["grad_norm"],
            params={k: v.clone() for k, v in
                    gan2.module.state_dict().items()})

    ffn = inp["ffn"]
    shard = collectives.shard_of(ffn["x"].shape[2])
    a, b = shard.span
    x = _span_of(ffn["x"], a, b, 2)
    args = [torch.as_tensor(ffn[k]) for k in ("zp", "k1T")]
    mids = [tuple(torch.as_tensor(t) for t in wb) for wb in ffn["mids"]]
    kout, bout = torch.as_tensor(ffn["kout"]), torch.as_tensor(ffn["bout"])
    out["ffn"] = K.sdf_ffn_reference(x, *args, mids, kout, bout, "float32")
    seed, rate = ffn["seed"], ffn["rate"]
    out["ffn_dropout"] = K.sdf_ffn(x, *args, mids, kout, bout, seed=seed,
                                   dropout_rate=rate,
                                   compute_dtype="float32", kernel="off",
                                   offset=a)
    out["masks"] = [K.dropout_keep(seed, rate, layer, 1, x.shape[0],
                                   args[1].shape[1], b - a, offset=a)
                    for layer in range(len(mids) + 1)]
    cem = inp["cem"]
    out["cem"] = C.fused_conditional_em(
        _span_of(cem["x"], a, b, 2), torch.as_tensor(cem["zpm"]),
        _span_of(cem["xr"], a, b, 1), _span_of(cem["tinv"], a, b, 0),
        torch.as_tensor(cem["ks"]), compute_dtype="float32")
    out["span"] = (a, b)
    torch.save(out, workdir / f"out{rank}.pt")


def train_worker(rank, world, workdir):
    """A short sharded train_3phase, then the same run stopped mid-phase
    and resumed, each into its own run dir."""
    from deeplearninginassetpricing_paperreplication_torch.training.trainer \
        import train_3phase
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig

    inp = torch.load(workdir / "in.pt", weights_only=False)
    cfg, tcfg = GANConfig(**inp["cfg"]), TrainConfig(**inp["tcfg"])
    batches = [local_batch(bt, world, rank) for bt in inp["batches"]]
    ec = ExecutionConfig(device="cpu", compute_dtype="float32",
                         shard=collectives.shard_of(
                             batches[0]["returns"].shape[1] * world))
    out = {}
    _, params, hist, _ = train_3phase(
        cfg, *batches, tcfg=tcfg, exec_cfg=ec, verbose=False,
        save_dir=str(workdir / "full"), state_dict=inp["state_dict"])
    out["full"] = (params, hist)
    cut = workdir / "cut"
    train_3phase(cfg, *batches, tcfg=tcfg, exec_cfg=ec, verbose=False,
                 save_dir=str(cut), state_dict=inp["state_dict"],
                 checkpoint_every=2, stop_after_epochs=7)
    out["cut_files"] = sorted(p.name for p in cut.iterdir())
    _, params, hist, _ = train_3phase(
        cfg, *batches, tcfg=tcfg, exec_cfg=ec, verbose=False,
        save_dir=str(cut), state_dict=inp["state_dict"], resume=True,
        checkpoint_every=2)
    out["resumed"] = (params, hist)
    torch.save(out, workdir / f"train{rank}.pt")


# -- rank workers of test_torch_shard_data.py ----------------------------------


def data_worker(rank, world, workdir, data_dir, shard_width):
    """stream_batch_sharded of each split (f32 and bf16 wire) and the
    StartupPipeline over the mesh, with their events."""
    from deeplearninginassetpricing_paperreplication_torch.data.panel import (
        load_splits,
    )
    from deeplearninginassetpricing_paperreplication_torch.data.pipeline \
        import StartupPipeline, stream_batch_sharded
    from deeplearninginassetpricing_paperreplication_torch.observability \
        .events import EventLog

    mesh = partition.create_mesh()
    ev = EventLog(workdir / f"ev{rank}")
    splits = [ds.pad_stocks(world) for ds in load_splits(data_dir)]
    out = {"streamed": {}}
    for name, ds in zip(("train", "valid", "test"), splits):
        for wire in (False, True):
            out["streamed"][(name, wire)] = stream_batch_sharded(
                ds.full_batch(), mesh, events=ev, split=name,
                bf16_wire=wire, device="cpu")
    res = StartupPipeline(data_dir, device="cpu", events=ev, mesh=mesh,
                          shard_width=shard_width).start().result()
    out["pipeline"] = dict(batches=res.batches,
                           n=[ds.N for ds in res.datasets],
                           n_assets=[ds.n_assets for ds in res.datasets])
    ev.close()
    torch.save(out, workdir / f"data{rank}.pt")
