"""One rank of a multi-process run: the executable proof that
``parallel.multihost`` coordinates real processes.

The counterpart of the JAX package's ``parallel/multihost_worker.py``.
Each rank joins the group through ``initialize_distributed`` (a TCP
coordinator), builds the granule-outer hybrid mesh, makes the JAX
worker's panel (NumPy from seed 0: the same bytes), takes its stock span
(``partition.shard_batch``), inits the member of its mesh row, runs ONE
conditional ``train_step`` whose stock sums all-reduce over its row's
ranks only (``exec_cfg.shard`` on the row's subgroup), gathers the
[n_batch] loss vector to every rank and prints a JSON result line, last.
The spawner (:func:`spawn_world`: the tests, ``chip_smoke.py``) holds the
ranks' losses equal, which they are only if the collectives ran.

A member's init is the port's seed-derived one (member g from seed
``MEMBER_SEED + g``, the same on every rank of its row): JAX's ``key(7)``
draws have no torch counterpart, so the tests hold the step itself against
JAX's ``make_train_step`` in one process. One command per rank (set no
torchrun variables; ``GROUP_RANK`` names a rank's node, its granule):

    python -m deeplearninginassetpricing_paperreplication_torch.parallel.multihost_worker \\
        --coordinator localhost:9876 --num_processes 2 --process_id 0 \\
        --device cpu

On a card a rank runs on ``cuda:(process_id % device_count)``: NCCL where
each rank has a card of its own, gloo where ranks share one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.pipeline import trainer_precompile_fn
from ..models.gan import GAN
from ..models.networks import init_member_params
from ..observability import (
    EventLog,
    Heartbeat,
    RunLogger,
    set_run_logger,
    write_manifest,
)
from ..training.steps import Optimizer, subtree_params, train_step
from ..utils.config import ExecutionConfig, GANConfig, resolve_device
from .collectives import leave_process_group, shard_of
from .multihost import (
    GRANULE_ENV,
    create_hybrid_mesh,
    initialize_distributed,
    process_local_summary,
    rank_granules,
)
from .partition import (
    BATCH_AXIS,
    STOCK_AXIS,
    rank,
    shard_batch,
    stock_span,
    world_size,
)

# the JAX worker's panel and model: T, M, F = 6, 4, 5
JAX_T, JAX_M, JAX_F = 6, 4, 5
MEMBER_SEED = 7  # member g inits from MEMBER_SEED + g
LR = 1e-3


def jax_config() -> GANConfig:
    """The JAX worker's model: hidden (4,), LSTM (2,), no dropout."""
    return GANConfig(macro_feature_dim=JAX_M, individual_feature_dim=JAX_F,
                     hidden_dim=(4,), num_units_rnn=(2,), dropout=0.0)


def worker_panel(T: int, N: int, M: int, F: int) -> Dict[str, np.ndarray]:
    """The JAX worker's panel at (T, N, M, F): NumPy from seed 0, drawn in
    its order, so the same bytes in every process and in both packages."""
    rng = np.random.default_rng(0)
    mask = (rng.random((T, N)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    macro = rng.standard_normal((T, M)).astype(np.float32)
    individual = (rng.standard_normal((T, N, F)) * mask[:, :, None]
                  ).astype(np.float32)
    returns = (rng.standard_normal((T, N)) * 0.05 * mask).astype(np.float32)
    return {"macro": macro, "individual": individual, "returns": returns,
            "mask": mask}


def member_state_dict(cfg: GANConfig, member: int) -> Dict[str, torch.Tensor]:
    """Member `member`'s initial parameters (CPU, f32)."""
    stacked = init_member_params(cfg, [MEMBER_SEED + member])
    return {k: v[0] for k, v in stacked.items()}


def member_step(cfg: GANConfig, state_dict, batch, exec_cfg: ExecutionConfig,
                lr: float = LR) -> Tuple[Dict[str, torch.Tensor], GAN]:
    """One conditional train step (clip, Adam) of a fresh optimizer from
    `state_dict` on `batch` (tensors on ``exec_cfg.device``; this rank's
    stocks under ``exec_cfg.shard``), dropout off: (the step's metrics, its
    loss that of the parameters before the update; the stepped GAN)."""
    gan = GAN.from_state_dict(cfg, state_dict, exec_cfg)
    opt = Optimizer(subtree_params(gan, "sdf_net"), lr)
    metrics = train_step(gan, "conditional", opt, gan.prepare_batch(batch),
                         None)
    return metrics, gan


def _mesh_record(mesh, granules) -> Dict:
    return {"axis_names": list(mesh.axis_names),
            "shape": list(mesh.devices.shape), "world_size": world_size(),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "ranks": [{"rank": int(r), "granule": int(granules[int(r)]),
                       "position": [pos[a] for a in mesh.axis_names]}
                      for pos, r in mesh.positions()]}


def run_rank(cfg: GANConfig, T: int, n_stocks_per_device: int, device,
             kernel: str = "auto", events=None, heartbeat=None,
             run_dir=None, argv=None) -> Dict:
    """This rank's part of the step, inside a joined group (or alone, the
    world of one): mesh → its batch → its row's member → one step → the
    gathered losses. Returns the result line's dict; a failed check raises.

    The mesh is ``create_hybrid_mesh`` with one member row per granule;
    row g's ranks all sit on granule g. N = `n_stocks_per_device` × the
    stock axis; each rank plans its kernels at its own span (recorded as
    ``program`` events) before the step."""
    events = events if events is not None else EventLog()
    dev = torch.device(device)
    world, me = world_size(), rank()
    granules = rank_granules()
    order = sorted(set(granules))
    if heartbeat is not None:
        heartbeat.beat("mesh")
    with events.span("multihost/mesh_build"):
        mesh = create_hybrid_mesh(members_per_host_group=len(order),
                                  granules=granules)
    rows = [[int(r) for r in row] for row in mesh.devices.tolist()]
    # the outer ('batch') axis crosses granules: row g's ranks all sit on
    # granule g
    for g, row in enumerate(rows):
        owners = {granules[r] for r in row}
        if owners != {order[g]}:
            raise RuntimeError(f"outer mesh row {g} spans granules {owners}")
    if run_dir is not None and me == 0:
        write_manifest(run_dir, "multihost_worker", events=events, argv=argv,
                       config=cfg, mesh=_mesh_record(mesh, granules))
    # every rank creates every row's group, in row order (new_group is a
    # collective of the whole world)
    groups = ([dist.new_group(ranks=row) for row in rows] if world > 1
              else [None])
    pos = mesh.position(me)
    g, col = pos[BATCH_AXIS], pos[STOCK_AXIS]
    n_batch, n_stocks = mesh.devices.shape
    N = n_stocks_per_device * n_stocks
    M, F = cfg.macro_feature_dim, cfg.individual_feature_dim
    local = shard_batch(worker_panel(T, N, M, F), mesh, device=me)
    batch = {k: torch.as_tensor(np.asarray(v, np.float32)).to(dev)
             for k, v in local.items()}
    shard = shard_of(N, group=groups[g])
    if shard.span != stock_span(N, mesh, device=me):
        raise RuntimeError(f"rank {me}: row group span {shard.span} is not "
                           f"the mesh's {stock_span(N, mesh, device=me)}")
    # the f32 comparison route (kernel against plain): the f32 panel
    exec_cfg = ExecutionConfig(kernel=kernel, compute_dtype="float32",
                               bf16_panel=False, device=str(dev),
                               shard=shard)
    with events.span("multihost/plan"):
        trainer_precompile_fn(cfg, exec_cfg, events)(
            {"train": {"returns": tuple(batch["returns"].shape),
                       "macro": tuple(batch["macro"].shape)}})
    if heartbeat is not None:
        heartbeat.beat("train_step", memory=True)
    with events.span("multihost/train_step", n_members=int(n_batch)):
        metrics, _ = member_step(cfg, member_state_dict(cfg, g), batch,
                                 exec_cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the span holds the device's work
    with events.span("multihost/gather"):
        # the [n_batch] gather as an all_reduce(SUM) of a zero-filled
        # buffer where column 0 of each row writes its loss (gloo's
        # collectives on card tensors are all_reduce and broadcast only);
        # one value plus zeros is exact
        buf = torch.zeros(n_batch, dtype=torch.float32, device=dev)
        if col == 0:
            buf[g] = metrics["loss"]
        if world > 1:
            dist.all_reduce(buf)
        losses = buf.cpu().numpy()
    if losses.shape != (n_batch,) or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"rank {me}: gathered losses {losses.tolist()}")
    return {
        "summary": process_local_summary(dev),
        "mesh_shape": [int(n_batch), int(n_stocks)],
        "axis_names": list(mesh.axis_names),
        "n_global_devices": world,
        # f32 values as exact doubles: the spawner compares them bit for bit
        "losses": [float(x) for x in losses],
    }


def worker(coordinator: str, num_processes: int, process_id: int,
           cfg: Optional[GANConfig] = None, T: int = JAX_T,
           n_stocks_per_device: int = 8, device: str = "cuda",
           kernel: str = "auto", run_dir=None, run_id: Optional[str] = None,
           argv=None) -> Dict:
    """Join the group as rank `process_id`, run :func:`run_rank` on
    `cfg` (the JAX worker's model by default) and a T × N panel, leave the
    group; returns the result line's dict. Every process writes its own
    events stream (``events.jsonl`` / ``events.proc{p}.jsonl``) and
    ``heartbeat.proc{p}.json`` in `run_dir`; rank 0 the manifest and the
    human-readable lines."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    if not initialize_distributed(coordinator, num_processes, process_id,
                                  device=dev):
        raise RuntimeError("initialize_distributed returned False with "
                           "explicit arguments")
    try:
        if world_size() != num_processes:
            raise RuntimeError(f"joined a world of {world_size()}, not "
                               f"{num_processes}")
        events = (EventLog(run_dir, run_id=run_id) if run_dir
                  else EventLog(run_id=run_id))
        logger = set_run_logger(RunLogger(events=events))
        hb = None
        if run_dir:
            hb = Heartbeat(Path(run_dir) / f"heartbeat.proc{process_id}.json",
                           events=events)
            hb.beat("init")
        logger.info(f"[multihost] {num_processes} processes joined "
                    f"({dist.get_backend()}); rank {process_id} on {dev}")
        out = run_rank(cfg or jax_config(), T, n_stocks_per_device, dev,
                       kernel, events, hb, run_dir, argv)
        if hb is not None:
            hb.beat("done", memory=True)
        events.close()
        return out
    finally:
        leave_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0's TCP store")
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--n_stocks_per_device", type=int, default=8)
    p.add_argument("--run_dir", type=str, default=None,
                   help="Telemetry dir: every process writes its own "
                        "events file (events.jsonl / events.proc{p}.jsonl) "
                        "and heartbeat.proc{p}.json there; human-readable "
                        "lines come from process 0 only")
    p.add_argument("--run_id", type=str, default=None,
                   help="Shared run id for all processes of one launch; "
                        "default: each process generates its own")
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="run on the CUDA device (default; an error without "
                        "one) or, explicitly, on the CPU")
    p.add_argument("--kernel", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="the CUDA kernels (auto: on a CUDA device) or, with "
                        "off, their plain PyTorch versions")
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    out = worker(args.coordinator, args.num_processes, args.process_id,
                 n_stocks_per_device=args.n_stocks_per_device,
                 device=args.device, kernel=args.kernel,
                 run_dir=args.run_dir, run_id=args.run_id,
                 argv=sys.argv[1:] if argv is None else argv)
    # the result line is protocol output (the spawner parses each rank's
    # stdout for it), not logging: every rank prints it, always last
    print(json.dumps(out), flush=True)


# -- the spawner ---------------------------------------------------------------

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT", "GROUP_RANK")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def worker_command(process_id: int, coordinator: str, num_processes: int,
                   *extra: str) -> List[str]:
    """The worker CLI's argv for one rank."""
    return [sys.executable, "-m", f"{__package__}.multihost_worker",
            "--coordinator", coordinator,
            "--num_processes", str(num_processes), "--process_id",
            str(process_id), *extra]


def _result_line(out: str) -> Optional[Dict]:
    for line in reversed(out.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def _run_world(command, n, granules, env, timeout, cwd):
    base = {k: v for k, v in (os.environ if env is None else env).items()
            if k not in _TORCHRUN_VARS}
    coordinator = f"127.0.0.1:{_free_port()}"
    files, procs = [], []
    t0 = time.perf_counter()
    for r in range(n):
        env_r = dict(base, **({GRANULE_ENV: str(granules[r])}
                              if granules is not None else {}))
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        files.append((out, err))
        procs.append(subprocess.Popen(command(r, coordinator), cwd=cwd,
                                      env=env_r, stdout=out, stderr=err,
                                      text=True))
    deadline = t0 + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break  # one rank failed: the others would wait on it
            if time.perf_counter() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for out, err in files:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    return procs, texts, wall


def spawn_world(command: Callable[[int, str], Sequence[str]], n: int,
                granules: Optional[Sequence[int]] = None, env=None,
                timeout: float = 600.0, cwd=None
                ) -> Tuple[List[Dict], float]:
    """Run a world of `n` rank processes joined through a TCP store on a
    free port of this host and wait for every one: ``command(process_id,
    coordinator)`` gives a rank's argv (:func:`worker_command`, or another
    program that calls :func:`worker`). `granules` (one per rank) become
    the ranks' ``GROUP_RANK``, their node index; the environment's other
    torchrun variables are removed.

    Returns (each rank's result line, rank by rank; the wall seconds from
    the spawn to the last rank's exit). A rank that exits non-zero, times
    out or prints no result line fails the world: the others are killed,
    and the world runs once more on a fresh port (another process may take
    the probed port before the store binds it). A second failure raises,
    naming the ranks and the end of their stderr."""
    failure = ""
    for _ in range(2):
        procs, texts, wall = _run_world(command, n, granules, env, timeout,
                                        cwd)
        results = [_result_line(out) for out, _ in texts]
        bad = [r for r, (p, res) in enumerate(zip(procs, results))
               if p.returncode != 0 or res is None]
        if not bad:
            return results, wall
        failure = "\n".join(
            f"rank {r} exited {procs[r].returncode}:\n{texts[r][1][-3000:]}"
            for r in bad)
    raise RuntimeError(f"the world of {n} ranks failed twice:\n{failure}")


if __name__ == "__main__":
    main()
