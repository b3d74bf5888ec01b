"""Hyperparameter sweeps: the paper's 384-config search, each architecture
bucket's (lr × seed) grid trained on the member axis.

The counterpart of the JAX package's ``parallel/sweep.py``, its in-process
part. Protocol (paper §II.E): search 384 configs, keep the best few, train
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
  * the ranking is a stable sort by best valid Sharpe over bucket order,
    then grid order.

Grid point (lr, s) starts from the init of seed s and draws its dropout
from the base seed ``s * 7919 + 13``, as the JAX sweep's
``train_base_key(s * 7919 + 13)`` does (an ensemble member of seed s draws
from s itself).

What the JAX module has and this one does not: the XLA program machinery
(``warm_bucket_programs``, ``compile_ahead``, ``record_program`` and the
``sweep/bucket_compile`` counter) has no counterpart, as the port compiles
no program per bucket: each kernel library builds once per width bound
(``ops/_nvcc.py``). The elastic sweep (``run_sweep_worker``,
``ranking_from_ledger``, ``open_work_queue``), ``grid_mesh`` and the
``sweep/*`` event counters are not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.networks import init_member_params
from ..observability.logging import get_run_logger
from ..reliability.faults import inject
from ..reliability.ledger import SweepLedger, bucket_key, make_record
from ..utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
    resolve_device,
)
from .ensemble import train_members

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
) -> Dict[str, Any]:
    """Train the (lr × seed) grid of one architecture bucket, members
    stacked: one 3-phase run in which every pass of every grid point is one
    kernel launch. Without test evals, as the JAX sweep's
    ``has_test=False``.

    Grid layout: axis 0 enumerates lr-major (lr_i, seed_j) pairs. `init`
    builds the start from (cfg, the grid's seeds); default
    ``init_member_params``. `member_chunk` caps the member axis per run
    (sequential chunks, concatenated).

    Returns {"grid": [(lr, seed)] float64, "best_valid_sharpe": [G], the
    reported Sharpe of each point (phase-3 best if that tracker updated,
    else phase-1 best, else -inf), "params": the final params [G, ...],
    "history": {key: [G, E]}}."""
    grid = [(lr, s) for lr in lrs for s in seeds]
    grid_seeds = [int(s) for _, s in grid]
    start = (init or init_member_params)(cfg, grid_seeds)
    out = train_members(
        cfg, train_batch, valid_batch, None, grid_seeds, tcfg,
        lrs=[float(lr) for lr, _ in grid],
        dropout_seeds=[dropout_base_seed(s) for s in grid_seeds],
        member_chunk=member_chunk, exec_cfg=exec_cfg, state_dicts=start,
        verbose=False)
    return {"grid": np.asarray(grid, dtype=np.float64),
            "best_valid_sharpe": out["best_valid_sharpe"],
            "params": out["params"], "history": out["history"]}


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
) -> List[Dict]:
    """Execute a sweep: bucket → member-stacked grid per bucket → global
    ranking.

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
    ``ledger_writes``. `init` is :func:`train_bucket`'s."""
    tcfg = tcfg or TrainConfig()
    exec_cfg = exec_cfg or ExecutionConfig()
    device = resolve_device(exec_cfg.device)
    train_batch = {k: v.to(device) for k, v in train_batch.items()}
    valid_batch = {k: v.to(device) for k, v in valid_batch.items()}
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
            log(f"[sweep] bucket {i + 1}/{n_buckets}: ledger hit — "
                "reusing recorded result")
            results.extend(_entries_from_record(b["cfg"], rec))
            continue
        # fault-injection site: one hit per bucket, the search's unit of work
        inject("sweep/bucket", bucket=i + 1, n_buckets=n_buckets,
               path=key or "")
        log(f"[sweep] bucket {i + 1}/{n_buckets}: "
            f"hidden={b['cfg'].hidden_dim} rnn={b['cfg'].num_units_rnn} "
            f"K={b['cfg'].num_condition_moment} drop={b['cfg'].dropout} "
            f"× {len(b['lrs'])} lrs × {len(seeds)} seeds")
        t0 = time.perf_counter()
        out = train_bucket(b["cfg"], b["lrs"], seeds, train_batch,
                           valid_batch, tcfg, member_chunk=member_chunk,
                           exec_cfg=exec_cfg, init=init)
        seconds = time.perf_counter() - t0
        bucket_seconds.append(seconds)
        if ledger is not None:
            # durably record the completed bucket BEFORE moving on: a crash
            # after this line costs no completed work
            ledger.write(key, make_record(
                key, i, b["cfg"].to_dict(), b["lrs"], list(seeds),
                out["grid"], out["best_valid_sharpe"], execution=execution,
                seconds=seconds))
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
        if ledger is not None:
            stats_out["ledger_hits"] = len(done_records)
            stats_out["ledger_writes"] = ledger.writes - ledger_writes_before
    results.sort(key=lambda r: -r["valid_sharpe"])
    return results if top_k is None else results[:top_k]
