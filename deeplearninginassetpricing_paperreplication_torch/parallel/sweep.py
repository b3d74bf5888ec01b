"""Hyperparameter sweeps: the paper's 384-config search, each architecture
bucket's (lr × seed) grid trained on the member axis.

The counterpart of the JAX package's ``parallel/sweep.py``. Protocol (paper §II.E): search 384 configs, keep the best few, train
9 seeds each, ensemble. The search is organized as in the JAX package:

  * configs are BUCKETED by architecture signature (every field that
    changes tensor shapes or the forward: hidden dims, rnn units, moment
    dims, dropout rate, loss flags); the default grid has 96 buckets of 4
    learning rates;
  * within a bucket the (lr × seed) grid, lr-major, is the member axis of
    the port's member-stacked runner (``parallel.ensemble.train_members``):
    every SDF-FFN and conditional-EM pass of the whole grid is ONE kernel
    launch over one panel read, and the learning rate rides per member
    through ``MemberOptimizer`` (where the JAX package vmaps optax's
    ``inject_hyperparams`` learning rate);
  * buckets run one after another; with a :class:`SweepLedger` every
    completed bucket lands as one verified record before the next starts,
    and a resumed sweep (``consult_ledger``) retrains none of them;
  * elastically, N worker processes (:func:`run_sweep_worker`) claim
    buckets from a leased, file-locked work queue
    (``reliability/scheduler.py``) and train each with the same
    :func:`train_bucket`; :func:`ranking_from_ledger` rebuilds the ranking
    from the records, in manifest order, so a fully covered elastic search
    gives the in-process ranking bit for bit;
  * the ranking is a stable sort by best valid Sharpe over bucket order,
    then grid order.

Grid point (lr, s) starts from the init of seed s and draws its dropout
from the base seed ``s * 7919 + 13``, as the JAX sweep's
``train_base_key(s * 7919 + 13)`` does (an ensemble member of seed s draws
from s itself).

What the JAX module has and this one does not: the XLA program machinery
(``warm_bucket_programs``, ``compile_ahead`` and the
``sweep/bucket_compile`` counter) has no counterpart, as the port compiles
no program per bucket: each kernel library builds once per width bound
(``ops/_nvcc.py``). In its place an elastic worker records each bucket's
kernel launch plans (``observability/programs.record_program``) before
the bucket trains.

Mesh packing (``grid_mesh``, a ``('grid',)`` mesh of ``torch.device``s,
``partition.grid_slice_mesh`` over ``partition.local_devices``): mesh
position p of a width-D mesh trains grid rows ``[p·G/D, (p+1)·G/D)``
through ``train_members`` on its own device, as ``shard_stack_tree`` lays
the JAX grid out. A point keeps its lr, init and dropout base seed, so a
position's rows are bit for bit the same rows trained at
``member_chunk = G/D`` on one device; the results join in grid order. A
grid D does not divide trains whole on the first position (the JAX naive
fallback). The positions train one after another: on two cards, a thread
per card took longer than this order (``tools/mesh_schedule.py``), as the
epoch loop is bound by the host.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.networks import init_member_params
from ..observability.logging import get_run_logger
from ..ops import device_launch_counts
from ..reliability.faults import inject
from ..reliability.ledger import SweepLedger, bucket_key, make_record
from ..utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
    resolve_device,
)
from .ensemble import train_members
from .partition import (
    GRID_AXIS,
    grid_slice_mesh,
    local_devices,
    on_device,
    position_device,
)

Batch = Dict[str, torch.Tensor]
# (cfg, seeds) -> member-stacked state dict [S, ...]: a grid's start
InitFn = Callable[[GANConfig, Sequence[int]], Dict[str, torch.Tensor]]


def architecture_signature(cfg: GANConfig) -> Tuple:
    """Everything that shapes the model and its forward (lr excluded)."""
    return (
        cfg.hidden_dim, cfg.use_rnn, cfg.num_units_rnn,
        cfg.hidden_dim_moment, cfg.num_condition_moment,
        cfg.dropout, cfg.normalize_w, cfg.weighted_loss,
        cfg.residual_loss_factor,
        cfg.macro_feature_dim, cfg.individual_feature_dim,
    )


def grid_configs(
    base: GANConfig,
    hidden_dims: Sequence[Sequence[int]] = ((64, 64), (128, 128), (64, 64, 64), (32, 32)),
    rnn_units: Sequence[Sequence[int]] = ((4,), (8,), (16,), (32,)),
    num_moments: Sequence[int] = (4, 8),
    dropouts: Sequence[float] = (0.05, 0.01, 0.1),
    lrs: Sequence[float] = (1e-3, 5e-4, 2e-3, 1e-4),
) -> List[Tuple[GANConfig, float]]:
    """Cartesian search space; defaults give 4*4*2*3*4 = 384 combos, the
    paper's 384-model search."""
    return [
        (replace(base, hidden_dim=tuple(hd), num_units_rnn=tuple(ru),
                 num_condition_moment=nm, dropout=dr), lr)
        for hd, ru, nm, dr, lr in itertools.product(
            hidden_dims, rnn_units, num_moments, dropouts, lrs)
    ]


def bucketize(
    configs_and_lrs: Sequence[Tuple[GANConfig, float]],
) -> Dict[Tuple, Dict]:
    """Group a (config, lr) search space into ordered architecture buckets,
    {signature: {"cfg", "lrs"}}: the one bucketing the sweep and the ledger
    keys use (bucket order fixes ranking tie-breaks)."""
    buckets: Dict[Tuple, Dict] = {}
    for cfg, lr in configs_and_lrs:
        b = buckets.setdefault(architecture_signature(cfg),
                               {"cfg": cfg, "lrs": []})
        if lr not in b["lrs"]:
            b["lrs"].append(lr)
    return buckets


def bucket_work_items(
    configs_and_lrs: Sequence[Tuple[GANConfig, float]],
    seeds: Sequence[int],
    tcfg: TrainConfig,
) -> List[Dict[str, Any]]:
    """The ordered, JSON-ready list of a sweep's buckets: each with its
    content key (``ledger.bucket_key``), index, config dict and lr grid."""
    tcfg_dict = dataclasses.asdict(tcfg)
    return [
        {
            "key": bucket_key(b["cfg"].to_dict(), b["lrs"], list(seeds),
                              tcfg_dict),
            "index": i,
            "config": b["cfg"].to_dict(),
            "lrs": [float(lr) for lr in b["lrs"]],
        }
        for i, b in enumerate(bucketize(configs_and_lrs).values())
    ]


def _entries_from_record(cfg: GANConfig, record: Dict[str, Any]) -> List[Dict]:
    """One ledger record → its ranking entries (a null Sharpe — a
    never-updated tracker — maps back to -inf, as in ``load_ranking``)."""
    return [
        {
            "config": cfg,
            "lr": float(g[0]),
            "seed": int(g[1]),
            "valid_sharpe": float(s) if s is not None else float("-inf"),
        }
        for g, s in zip(record["grid"], record["best_valid_sharpe"])
    ]


def execution_of(exec_cfg: ExecutionConfig) -> Dict[str, str]:
    """What a ledger record holds of how its bucket ran: the fields of
    `exec_cfg` that change the result but not the bucket's key."""
    return {"compute_dtype": exec_cfg.compute_dtype,
            "kernel": exec_cfg.kernel}


def dropout_base_seed(seed: int) -> int:
    """The dropout stream of grid point (lr, seed): the JAX sweep's
    ``train_base_key(seed * 7919 + 13)``."""
    return int(seed) * 7919 + 13


def train_bucket(
    cfg: GANConfig,
    lrs: Sequence[float],
    seeds: Sequence[int],
    train_batch: Batch,
    valid_batch: Batch,
    tcfg: TrainConfig,
    member_chunk: Optional[int] = None,
    exec_cfg: Optional[ExecutionConfig] = None,
    init: Optional[InitFn] = None,
    grid_mesh=None,
    placed: Optional[Dict[Any, Dict[str, Batch]]] = None,
) -> Dict[str, Any]:
    """Train the (lr × seed) grid of one architecture bucket, members
    stacked: one 3-phase run in which every pass of every grid point is one
    kernel launch. Without test evals, as the JAX sweep's
    ``has_test=False``.

    Grid layout: axis 0 enumerates lr-major (lr_i, seed_j) pairs. `init`
    builds the start from (cfg, the grid's seeds); default
    ``init_member_params``. `member_chunk` caps the member axis per run
    (sequential chunks, concatenated).

    `grid_mesh`: lay the grid over a ``('grid',)`` mesh (see the module
    doc); `placed` is :func:`place_on_mesh`'s copy of the two batches on
    the mesh's devices (made here when not given).

    Returns {"grid": [(lr, seed)] float64, "best_valid_sharpe": [G], the
    reported Sharpe of each point (phase-3 best if that tracker updated,
    else phase-1 best, else -inf), "params": the final params [G, ...],
    "history": {key: [G, E]}}; with a mesh also "placement" (what
    :func:`_train_on_mesh` returns), the params on the first position's
    device."""
    grid = [(lr, s) for lr in lrs for s in seeds]
    grid_seeds = [int(s) for _, s in grid]
    start = (init or init_member_params)(cfg, grid_seeds)
    kw = dict(lrs=[float(lr) for lr, _ in grid],
              dropout_seeds=[dropout_base_seed(s) for s in grid_seeds],
              member_chunk=member_chunk, exec_cfg=exec_cfg)
    if grid_mesh is not None:
        if placed is None:
            placed = place_on_mesh(train_batch, valid_batch, grid_mesh)
        out = _train_on_mesh(cfg, grid_seeds, tcfg, start, kw, grid_mesh,
                             placed)
        return {"grid": np.asarray(grid, dtype=np.float64), **out}
    out = train_members(
        cfg, train_batch, valid_batch, None, grid_seeds, tcfg,
        state_dicts=start, verbose=False, **kw)
    return {"grid": np.asarray(grid, dtype=np.float64),
            "best_valid_sharpe": out["best_valid_sharpe"],
            "params": out["params"], "history": out["history"]}


def mesh_positions(grid_mesh) -> List[torch.device]:
    """The ``torch.device`` of each position of a ``('grid',)`` mesh, in
    grid order."""
    if tuple(grid_mesh.shape) != (GRID_AXIS,):
        raise ValueError(f"grid_mesh must have the one axis {GRID_AXIS!r}; "
                         f"got {tuple(grid_mesh.shape)}")
    return [position_device(d) for _, d in grid_mesh.positions()]


def place_on_mesh(train_batch: Batch, valid_batch: Batch, grid_mesh
                  ) -> Dict[torch.device, Dict[str, Batch]]:
    """{device: {"train", "valid"}}: the two batches copied once onto each
    device of the mesh (a batch already there is not copied), for every
    bucket of a search to read."""
    placed: Dict[torch.device, Dict[str, Batch]] = {}
    for dev in mesh_positions(grid_mesh):
        if dev not in placed:
            placed[dev] = {
                name: {k: v.to(dev) for k, v in b.items()}
                for name, b in (("train", train_batch),
                                ("valid", valid_batch))}
    return placed


def _train_on_mesh(cfg: GANConfig, grid_seeds: List[int], tcfg: TrainConfig,
                   start: Dict[str, torch.Tensor], kw: Dict[str, Any],
                   grid_mesh, placed) -> Dict[str, Any]:
    """Each mesh position in turn trains its span of the grid on its own
    device; the results join in grid order on the first position's device.
    "placement" records the positions, the span (None where the mesh does
    not divide the grid and the first position trains it whole), each
    position's device and its kernel launches by name."""
    devices = mesh_positions(grid_mesh)
    G, D = len(grid_seeds), len(devices)
    ragged = G % D != 0
    spans = ([(0, G)] if ragged
             else [(p * G // D, (p + 1) * G // D) for p in range(D)])
    outs, launches = [], []
    for p, (a, b) in enumerate(spans):
        dev = devices[p]
        before = device_launch_counts(dev)
        with on_device(dev):
            outs.append(train_members(
                cfg, placed[dev]["train"], placed[dev]["valid"], None,
                grid_seeds[a:b], tcfg,
                state_dicts={k: v[a:b] for k, v in start.items()},
                verbose=False,
                **{k: v[a:b] if k in ("lrs", "dropout_seeds") else v
                   for k, v in kw.items()}))
        after = device_launch_counts(dev)
        launches.append({k: after[k] - before[k] for k in after})
    dev0 = devices[0]
    return {
        "best_valid_sharpe": np.concatenate(
            [o["best_valid_sharpe"] for o in outs]),
        "params": {k: torch.cat([o["params"][k].to(dev0) for o in outs])
                   for k in outs[0]["params"]},
        "history": {k: np.concatenate([o["history"][k] for o in outs])
                    for k in outs[0]["history"]},
        "placement": {"positions": D, "span": None if ragged else G // D,
                      "fallback": ragged,
                      "devices": [str(devices[p]) for p in range(len(spans))],
                      "launches": launches},
    }


def run_sweep(
    configs_and_lrs: Sequence[Tuple[GANConfig, float]],
    seeds: Sequence[int],
    train_batch: Batch,
    valid_batch: Batch,
    tcfg: Optional[TrainConfig] = None,
    top_k: Optional[int] = 4,
    keep_params: bool = False,
    verbose: bool = True,
    member_chunk: Optional[int] = None,
    exec_cfg: Optional[ExecutionConfig] = None,
    stats_out: Optional[Dict] = None,
    ledger: Optional[SweepLedger] = None,
    consult_ledger: bool = False,
    init: Optional[InitFn] = None,
    heartbeat=None,
    grid_mesh=None,
) -> List[Dict]:
    """Execute a sweep: bucket → member-stacked grid per bucket → global
    ranking.

    `grid_mesh`: mesh-packed execution, every bucket's grid laid over the
    ``('grid',)`` mesh (:func:`train_bucket`); the panel goes to each of
    its devices once for the whole search. ``stats_out["grid_mesh"]``
    gets the JAX keys (the axes as laid out, each position's device), the
    buckets a ragged grid trained whole on the first position
    (``fallback_buckets``) and each trained bucket's placement
    (``bucket_placement``).

    Runs on ``exec_cfg.device`` (default the card: without one, an error
    naming CUDA); the batches move there. Returns the top_k entries (all
    when top_k is None) as dicts with config, lr, seed and valid Sharpe —
    and, with `keep_params`, the grid point's final selected params (CPU
    tensors [...] under the reference's ``state_dict`` keys).

    `ledger`: every completed bucket's result lands as one verified record
    before the next bucket starts. With `consult_ledger` (the
    ``--resume-from-ledger`` mode) buckets already recorded are not
    retrained; their entries load from the ledger (``stats_out
    ["ledger_hits"]``). A record is reused only where it ran at this
    `exec_cfg`'s compute dtype and kernel route (:func:`execution_of`; the
    key, the JAX package's, leaves them out), else its bucket retrains and
    the new record replaces it. Ledger records hold no params, so consult
    mode requires ``keep_params=False``.

    `stats_out`, when given, gets ``n_buckets``, ``bucket_seconds`` (wall
    s of each bucket trained) and, with a ledger, ``ledger_hits`` and
    ``ledger_writes``. `init` is :func:`train_bucket`'s. `heartbeat` (an
    ``observability.Heartbeat``) beats ``sweep_bucket`` as each bucket
    starts; the run logger's events get a ``sweep/bucket`` span per
    bucket trained and ``sweep/ledger_hit`` / ``sweep/ledger_write``
    counters."""
    tcfg = tcfg or TrainConfig()
    exec_cfg = exec_cfg or ExecutionConfig()
    device = resolve_device(exec_cfg.device)
    train_batch = {k: v.to(device) for k, v in train_batch.items()}
    valid_batch = {k: v.to(device) for k, v in valid_batch.items()}
    placed = (place_on_mesh(train_batch, valid_batch, grid_mesh)
              if grid_mesh is not None else None)
    placements: List[Dict[str, Any]] = []
    bucket_list = list(bucketize(configs_and_lrs).items())
    n_buckets = len(bucket_list)

    # human lines from process 0 only; every process keeps its copy in
    # its own events.jsonl
    logger = get_run_logger()

    def log(msg):
        logger.info(msg, verbose=verbose)

    execution = execution_of(exec_cfg)
    done_records: Dict[Tuple, Dict] = {}
    bucket_keys: Dict[Tuple, str] = {}
    if ledger is not None:
        tcfg_dict = dataclasses.asdict(tcfg)
        for sig, b in bucket_list:
            bucket_keys[sig] = bucket_key(
                b["cfg"].to_dict(), b["lrs"], list(seeds), tcfg_dict)
        if consult_ledger:
            if keep_params:
                raise ValueError(
                    "consult_ledger requires keep_params=False: ledger "
                    "records are JSON and hold no params")
            for sig, _b in bucket_list:
                if not ledger.has(bucket_keys[sig]):
                    continue
                rec = ledger.load(bucket_keys[sig])
                if rec.get("execution") == execution:
                    done_records[sig] = rec
                else:
                    log(f"[sweep] ledger record {bucket_keys[sig][:12]} ran "
                        f"at {rec.get('execution')}, not {execution}: "
                        "retraining its bucket")

    results = []
    bucket_seconds = []
    ledger_writes_before = ledger.writes if ledger is not None else 0
    for i, (sig, b) in enumerate(bucket_list):
        key = bucket_keys.get(sig)
        rec = done_records.get(sig)
        if rec is not None:
            # a completed bucket is NEVER retrained: its entries load from
            # the verified record
            logger.events.counter("sweep/ledger_hit", bucket=i + 1, path=key)
            log(f"[sweep] bucket {i + 1}/{n_buckets}: ledger hit — "
                "reusing recorded result")
            results.extend(_entries_from_record(b["cfg"], rec))
            continue
        # fault-injection site: one hit per bucket, the search's unit of work
        inject("sweep/bucket", bucket=i + 1, n_buckets=n_buckets,
               path=key or "")
        if heartbeat is not None:
            # liveness advances once per bucket, the search's unit of work
            heartbeat.beat("sweep_bucket", bucket=i + 1, n_buckets=n_buckets)
        log(f"[sweep] bucket {i + 1}/{n_buckets}: "
            f"hidden={b['cfg'].hidden_dim} rnn={b['cfg'].num_units_rnn} "
            f"K={b['cfg'].num_condition_moment} drop={b['cfg'].dropout} "
            f"× {len(b['lrs'])} lrs × {len(seeds)} seeds")
        with logger.events.span("sweep/bucket", bucket=i + 1,
                                n_buckets=n_buckets) as sp_b:
            out = train_bucket(b["cfg"], b["lrs"], seeds, train_batch,
                               valid_batch, tcfg, member_chunk=member_chunk,
                               exec_cfg=exec_cfg, init=init,
                               grid_mesh=grid_mesh, placed=placed)
        bucket_seconds.append(sp_b.seconds)
        if grid_mesh is not None:
            placements.append({"bucket": i + 1, **out["placement"]})
            if out["placement"]["fallback"]:
                logger.events.counter("sweep/grid_fallback", bucket=i + 1,
                                      grid=len(out["grid"]),
                                      positions=out["placement"]["positions"])
        if ledger is not None:
            # durably record the completed bucket BEFORE moving on: a crash
            # after this line costs no completed work
            ledger.write(key, make_record(
                key, i, b["cfg"].to_dict(), b["lrs"], list(seeds),
                out["grid"], out["best_valid_sharpe"], execution=execution,
                seconds=sp_b.seconds))
            logger.events.counter("sweep/ledger_write", bucket=i + 1,
                                  path=key)
        for g_idx, (g, s) in enumerate(
                zip(out["grid"], out["best_valid_sharpe"])):
            entry = {
                "config": b["cfg"],
                "lr": float(g[0]),
                "seed": int(g[1]),
                "valid_sharpe": float(s),
            }
            if keep_params:
                entry["params"] = {k: v[g_idx].detach().cpu()
                                   for k, v in out["params"].items()}
            results.append(entry)
    if stats_out is not None:
        stats_out["n_buckets"] = n_buckets
        stats_out["bucket_seconds"] = bucket_seconds
        if grid_mesh is not None:
            stats_out["grid_mesh"] = {
                "axes": dict(grid_mesh.shape),
                "devices": [str(d) for d in mesh_positions(grid_mesh)],
                "fallback_buckets": [p["bucket"] for p in placements
                                     if p["fallback"]],
                "bucket_placement": placements}
        if ledger is not None:
            stats_out["ledger_hits"] = len(done_records)
            stats_out["ledger_writes"] = ledger.writes - ledger_writes_before
    results.sort(key=lambda r: -r["valid_sharpe"])
    return results if top_k is None else results[:top_k]


# -- elastic execution: leased workers over the bucket queue -----------------


def record_bucket_programs(cfg: GANConfig, n_members: int,
                           batches: Dict[str, Batch],
                           exec_cfg: ExecutionConfig, events=None,
                           name_prefix: str = "") -> Dict[str, Dict]:
    """Work out one bucket's kernel launch plans on the card, at the
    bucket's member count and the batches' shapes, and record each through
    ``observability.programs.record_program`` (a ``program`` row in
    `events`); returns them by name. The port's stand-in for the JAX
    worker's ``warm_bucket_programs``: nothing compiles per bucket here,
    but the plans say which route and launch geometry the bucket trains
    with. On the plain route (a CPU device, ``kernel="off"``) there is
    nothing to plan and the result is empty."""
    from ..data.pipeline import trainer_precompile_fn

    shapes = {name: {"returns": tuple(b["returns"].shape),
                     **({"macro": tuple(b["macro"].shape)}
                        if "macro" in b else {})}
              for name, b in batches.items()}
    return trainer_precompile_fn(cfg, exec_cfg, events, members=n_members,
                                 name_prefix=name_prefix)(shapes)["programs"]


def run_sweep_worker(
    queue,
    worker_id: str,
    train_batch: Batch,
    valid_batch: Batch,
    exec_cfg: Optional[ExecutionConfig] = None,
    heartbeat=None,
    verbose: bool = True,
    poll_s: float = 0.5,
    programs_out: Optional[Dict[str, Dict]] = None,
    devices: Optional[Sequence] = None,
) -> int:
    """One elastic sweep worker's claim → train → record loop.

    `queue` is a :class:`reliability.scheduler.WorkQueue` whose manifest
    (written by the coordinating ``sweep.py --workers N`` process) carries
    the bucket list plus the shared schedule (TrainConfig dict, seeds,
    member_chunk). The worker claims buckets under a heartbeat-stamped
    lease (kept alive by a background :class:`LeaseKeeper` thread: one
    bucket's training can outlive the lease timeout), trains each with the
    SAME :func:`train_bucket` the in-process sweep uses (so results are
    bit-identical to a single-process run), records it in the ledger with
    its ``worker``, and releases. Before a bucket trains, its kernel launch
    plans go into the run logger's events (:func:`record_bucket_programs`;
    also into `programs_out` when given). A bucket whose training raises
    is released for retry (the claim already counted the attempt; K
    failed claims quarantine it — see scheduler.py); ``"wait"`` polls for
    other workers' leases to complete or expire; ``"drained"`` exits
    cleanly. Returns the number of buckets this worker trained.

    Runs on ``exec_cfg.device`` (default the card; without one, an error
    naming CUDA); the batches move there.

    Mesh packing: with ``device_slices`` S (and ``slice_width``) in the
    manifest the worker first leases one of the S disjoint device slices
    of `devices` (default ``partition.local_devices`` of the route;
    ``queue.claim_device_slice``), waiting while every slice is held,
    copies its batches onto that slice's devices once, and trains every
    bucket over a ``('grid',)`` mesh of them, recording each position's
    launch plans. While it waits for buckets it renews the slice; after a
    ``LeaseLost`` it leases a slice again (and copies the panel there),
    and it releases the slice at drain. A slice taken over mid-bucket
    keeps that bucket's result (placement changes no value). Bucket
    leases, takeover and quarantine are unchanged: the slice is a lease
    of its own, renewed by the same keeper."""
    from ..reliability.scheduler import LeaseKeeper, LeaseLost

    exec_cfg = exec_cfg or ExecutionConfig()
    device = resolve_device(exec_cfg.device)
    train_batch = {k: v.to(device) for k, v in train_batch.items()}
    valid_batch = {k: v.to(device) for k, v in valid_batch.items()}
    logger = get_run_logger()
    manifest = queue.load_manifest()
    tcfg = TrainConfig(**manifest["tcfg"])
    seeds = [int(s) for s in manifest["seeds"]]
    member_chunk = manifest.get("member_chunk")
    bucket_timeout = manifest.get("bucket_timeout_s")
    n_slices = int(manifest.get("device_slices") or 0)
    slice_width = manifest.get("slice_width")
    if n_slices and devices is None:
        devices = local_devices(device)
    execution = execution_of(exec_cfg)
    n_buckets = len(queue.items())
    trained = 0
    grid_mesh = placed = slice_idx = None
    while True:
        if n_slices and slice_idx is None:
            slice_idx = queue.claim_device_slice(worker_id, n_slices)
            if slice_idx is None:
                # every slice held by a live worker: wait for one to free
                if heartbeat is not None:
                    heartbeat.beat("sweep_wait")
                time.sleep(poll_s)
                continue
            grid_mesh = grid_slice_mesh(
                slice_idx, n_slices,
                width=int(slice_width) if slice_width else None,
                devices=devices)
            logger.info(
                f"[sweep:{worker_id}] leased device slice {slice_idx}/"
                f"{n_slices}: devices "
                f"{[str(d) for d in mesh_positions(grid_mesh)]}",
                verbose=verbose)
            # the panel onto the slice's devices, once per slice
            placed = place_on_mesh(train_batch, valid_batch, grid_mesh)
        status, item = queue.claim(worker_id)
        if status == "drained":
            break
        if status == "wait":
            # stay live while other workers hold the remaining leases — one
            # of them may die, expiring its lease back into the pool. Sleep
            # only until the nearest lease-expiry/backoff deadline (capped
            # at poll_s): an idle worker wakes AT the expiry and takes the
            # orphan over (scheduler.next_wake_delay)
            if heartbeat is not None:
                heartbeat.beat("sweep_wait")
            if slice_idx is not None:
                # an idle worker still owns its devices: keep the slice
                # lease warm so a takeover only happens on real death
                try:
                    queue.renew_device_slice(slice_idx, worker_id)
                except LeaseLost:
                    grid_mesh = placed = slice_idx = None
            time.sleep(queue.next_wake_delay(poll_s, worker=worker_id))
            continue
        key, idx = item["key"], int(item["index"])
        cfg = GANConfig.from_dict(item["config"], strict=False)
        if heartbeat is not None:
            heartbeat.beat("sweep_bucket", bucket=idx + 1,
                           n_buckets=n_buckets)
        logger.info(
            f"[sweep:{worker_id}] bucket {idx + 1}/{n_buckets} "
            f"(attempt {item['attempt']}): hidden={cfg.hidden_dim} "
            f"rnn={cfg.num_units_rnn} × {len(item['lrs'])} lrs × "
            f"{len(seeds)} seeds"
            + (f" [slice {slice_idx}]" if slice_idx is not None else ""),
            verbose=verbose)
        # mid-bucket fault site: fires with the lease HELD — a kill here
        # leaves an orphan lease that must expire and be taken over
        inject("sweep/bucket", bucket=idx + 1, n_buckets=n_buckets,
               path=key, worker=worker_id)
        try:
            # the keeper beats the heartbeat on every renewal, so the
            # supervising watchdog sees liveness through a bucket that
            # outlives the heartbeat timeout — bounded by the per-bucket
            # wall budget (past it, both signals go stale and the worker
            # is killed and the bucket reclaimed as hung)
            with logger.events.span("sweep/bucket", bucket=idx + 1,
                                    worker=worker_id) as sp_b, \
                    LeaseKeeper(queue, key, worker_id, heartbeat=heartbeat,
                                max_lifetime_s=bucket_timeout,
                                slice_index=slice_idx) as keeper:
                G = len(item["lrs"]) * len(seeds)
                programs = {}
                for prefix, dev, width in _plan_positions(
                        idx, G, grid_mesh, device):
                    programs.update(record_bucket_programs(
                        cfg, min(width, member_chunk or width),
                        {"train": train_batch, "valid": valid_batch},
                        dataclasses.replace(exec_cfg, device=str(dev)),
                        events=logger.events, name_prefix=prefix))
                if programs_out is not None:
                    programs_out.update(programs)
                out = train_bucket(
                    cfg, item["lrs"], seeds, train_batch, valid_batch, tcfg,
                    member_chunk=member_chunk, exec_cfg=exec_cfg,
                    grid_mesh=grid_mesh, placed=placed)
            if keeper.slice_lost:
                # the device slice was taken over (this worker was presumed
                # dead) while the bucket lease held: the result stands, but
                # the next bucket trains on a freshly leased slice
                logger.warning(
                    f"[sweep:{worker_id}] device slice {slice_idx} was "
                    "taken over mid-train; keeping the result and leasing "
                    "a slice again")
                grid_mesh = placed = slice_idx = None
            if keeper.lost:
                # presumed dead and taken over mid-train: the new owner's
                # (bit-identical) result is the one the ledger records
                logger.warning(
                    f"[sweep:{worker_id}] bucket {idx + 1} lease was taken "
                    "over mid-train; discarding this copy of the result")
                continue
            queue.ledger.write(key, make_record(
                key, idx, cfg.to_dict(), item["lrs"], seeds,
                out["grid"], out["best_valid_sharpe"], execution=execution,
                worker=worker_id, seconds=sp_b.seconds))
            logger.events.counter("sweep/ledger_write", bucket=idx + 1,
                                  path=key, worker=worker_id)
            queue.complete(key, worker_id)
            trained += 1
        except Exception as e:  # noqa: BLE001 — any failure releases the claim
            queue.fail(key, worker_id, error=f"{type(e).__name__}: {e}")
            logger.warning(
                f"[sweep:{worker_id}] bucket {idx + 1} failed "
                f"({type(e).__name__}: {e}); released for retry")
    if slice_idx is not None:
        queue.release_device_slice(slice_idx, worker_id)
    return trained


def _plan_positions(idx: int, G: int, grid_mesh, device):
    """(program name prefix, device, members) of each position that
    trains bucket `idx` of grid width G: one on `device` without a mesh,
    else every position at its span (the first alone, the whole grid,
    where the mesh does not divide it)."""
    if grid_mesh is None:
        return [(f"bucket{idx + 1}/", device, G)]
    devices = mesh_positions(grid_mesh)
    D = len(devices)
    if G % D:
        return [(f"bucket{idx + 1}/pos0/", devices[0], G)]
    return [(f"bucket{idx + 1}/pos{p}/", dev, G // D)
            for p, dev in enumerate(devices)]


def ranking_from_ledger(queue) -> Tuple[List[Dict], Dict[str, Any]]:
    """Reconstruct the global ranking from a sweep's ledger records, in
    manifest bucket order (ranking tie-breaks match the in-process sweep
    exactly), plus the COVERAGE manifest for degraded completion: which
    buckets are quarantined (with their attempt history) or missing, and
    the completed fraction. A fully covered ledger reproduces ``run_sweep``
    (top_k=None) bit for bit."""
    results: List[Dict] = []
    quarantined_info = queue.ledger.quarantined()
    quarantined: List[Dict[str, Any]] = []
    missing: List[Dict[str, Any]] = []
    items = queue.items()
    for item in items:
        key = item["key"]
        if queue.ledger.has(key):
            cfg = GANConfig.from_dict(item["config"], strict=False)
            results.extend(
                _entries_from_record(cfg, queue.ledger.load(key)))
        elif key in quarantined_info or queue.ledger.is_quarantined(key):
            q = quarantined_info.get(key, {})
            quarantined.append({
                "index": item["index"], "key": key,
                "config": item["config"], "lrs": item["lrs"],
                "attempts": q.get("attempts"),
                "history": q.get("history"),
            })
        else:
            missing.append({"index": item["index"], "key": key})
    n = len(items)
    completed = n - len(quarantined) - len(missing)
    coverage = {
        "n_buckets": n,
        "completed": completed,
        "coverage": round(completed / n, 4) if n else 1.0,
        "complete": not quarantined and not missing,
        "quarantined": quarantined,
        "missing": missing,
    }
    results.sort(key=lambda r: -r["valid_sharpe"])
    return results, coverage


def open_work_queue(
    run_dir: Union[str, Path],
    events=None,
    create: bool = False,
):
    """The run dir's :class:`WorkQueue`, parameterized from its own queue
    manifest when one exists (lease timeout / max attempts / retry backoff
    are FLEET-level settings: every worker must agree on them, so they ride
    in the manifest, not per-process flags)."""
    from ..reliability.ledger import LEDGER_DIRNAME
    from ..reliability.scheduler import WorkQueue
    from ..reliability.supervisor import RestartPolicy

    queue = WorkQueue(Path(run_dir) / LEDGER_DIRNAME, events=events)
    if not create:
        meta = queue.load_manifest()
        queue.lease_timeout_s = float(
            meta.get("lease_timeout_s", queue.lease_timeout_s))
        queue.max_attempts = int(meta.get("max_attempts", queue.max_attempts))
        if meta.get("retry_backoff_s") is not None:
            queue.backoff = RestartPolicy(
                backoff_base_s=float(meta["retry_backoff_s"]),
                backoff_max_s=max(30.0, float(meta["retry_backoff_s"])))
    return queue
