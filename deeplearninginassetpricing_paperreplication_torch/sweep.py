"""The paper protocol as ONE command: 384-config search → top-k × 9 seeds →
weight-averaged ensembles → test Sharpe report, checkpointing everything.

    python -m deeplearninginassetpricing_paperreplication_torch.sweep \\
        --data_dir data/synthetic_data --save_dir ./sweep_run --quick

The counterpart of the JAX package's ``sweep.py`` (paper §II.E: "384
models … four best … 9 models"). The search trains each architecture
bucket's (lr × seed) grid members-stacked (one kernel launch per pass for
the whole grid, ``parallel/sweep.py``), in this process or, with
``--workers N``, in N supervised worker processes that claim buckets from
a leased, ledger-backed work queue (``reliability/scheduler.py``: a dead
or hung worker's lease expires and its bucket is taken over; a bucket
that keeps killing its workers is quarantined and the ranking ships
degraded, with ``sweep_coverage.json``). Every winner's seed ensemble
trains members-stacked at the winner's lr (``parallel/ensemble.py``), and
evaluation follows the reference's ensemble reduction (averaged
normalized weights, re-normalized, negated Sharpe, ddof=0).

Artifacts in --save_dir:
    sweep_ranking.json (+ .sha256)   — every (config, lr, seed) + valid Sharpe
    sweep_coverage.json (+ .sha256)  — a degraded elastic search's coverage
    sweep_ledger/queue.json          — the work manifest (+ fleet settings)
    sweep_ledger/records/<key>.json  — one verified record per searched bucket
    sweep_ledger/quarantine/<key>.json — poison buckets
    rank{r}_seed{s}/config.json      — per-member run dirs in the reference
    rank{r}_seed{s}/best_model_sharpe.pt   layout (``evaluate_ensemble
                                       --checkpoint_dirs`` reads them)
    report.json (+ .sha256)          — per-winner + grand ensemble Sharpes
    events*.jsonl, heartbeat*.json, manifest*.json — the coordinator's and
                                       each worker's (``<wid>``) telemetry

It runs on the CUDA device unless ``--device cpu`` is given. The panel
loads through the chunked store (``data/pipeline.load_splits_chunked``: a
rerun memmaps the cached decode) and ships mask-packed
(``data/transfer.device_put_batch``), on the bf16 wire where every swept
configuration rounds the panel to bf16 anyway; ``--small_sample`` keeps
``--n_periods`` × ``--n_stocks``. Workers run on the coordinator's
``--device``, ``--kernel`` and ``--compute_dtype``: a worker without a
card fails rather than train on the CPU. ``--device_slices S``
(``--slice_width W``) packs the search over the process's devices
(``parallel/partition.local_devices``): each worker leases one of S
disjoint slices of W devices and lays every bucket's grid over it
(``parallel/sweep.py``'s ``grid_mesh``); with ``--workers 0`` one slice
spans the local devices. A layout the host cannot hold fails before any
work starts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.pipeline import load_splits_chunked
from .data.transfer import device_put_batch
from .evaluate_ensemble import add_execution_args, execution_config
from .observability.events import EventLog
from .observability.heartbeat import Heartbeat
from .observability.logging import RunLogger, get_run_logger, set_run_logger
from .observability.manifest import (
    load_manifest,
    update_manifest,
    write_manifest,
)
from .observability.metrics import MetricsSidecar
from .ops.sdf_ffn import _route as ffn_route
from .parallel.ensemble import (
    PAPER_SEEDS,
    apply_quorum,
    ensemble_metrics,
    ensemble_metrics_from_weights,
    member_weights,
    train_ensemble,
)
from .parallel.partition import grid_slice_mesh, local_devices, slice_devices
from .parallel.sweep import (
    architecture_signature,
    bucket_work_items,
    execution_of,
    grid_configs,
    open_work_queue,
    ranking_from_ledger,
    run_sweep,
    run_sweep_worker,
)
from .reliability.ledger import LEDGER_DIRNAME, SweepLedger
from .reliability.verified import (
    clear_generations,
    load_verified,
    write_verified,
)
from .training.checkpoint import member_state_dicts, save_state_dict
from .utils.config import ExecutionConfig, GANConfig, TrainConfig, resolve_device

# the --quick smoke grid + schedules, as importable constants (the JAX
# package's, so a quick sweep has the same buckets and bucket keys)
QUICK_GRID_KW = dict(
    hidden_dims=((64, 64), (32, 32)),
    rnn_units=((4,),),
    num_moments=(8,),
    dropouts=(0.05,),
    lrs=(1e-3, 5e-4),
)
QUICK_SEARCH_SCHEDULE = dict(
    num_epochs_unc=8, num_epochs_moment=4, num_epochs=16, ignore_epoch=2)
QUICK_ENSEMBLE_SCHEDULE = dict(
    num_epochs_unc=16, num_epochs_moment=8, num_epochs=32, ignore_epoch=4)


def _finite(x: float):
    """JSON-safe scalar: -inf (a grid point whose trackers never updated)
    would serialize as the non-standard '-Infinity'; map non-finite to
    None."""
    return x if math.isfinite(x) else None


def write_ranking(save_dir, ranked: Sequence[Dict],
                  coverage: Optional[Dict] = None) -> Path:
    """Write ``sweep_ranking.json`` (and, when the search completed
    DEGRADED, ``sweep_coverage.json``) through the verified path: atomic
    tmp+replace with a sha256 sidecar, so a mid-write kill can never leave
    a torn ranking for a resume to trust. The coverage manifest is the
    explicit contract of a degraded completion: which buckets are missing
    from this ranking, why, and after how many attempts."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    rows = [
        {
            "rank": i,
            "config": r["config"].to_dict(),
            "lr": r["lr"],
            "seed": r["seed"],
            "valid_sharpe": _finite(r["valid_sharpe"]),
        }
        for i, r in enumerate(ranked)
    ]
    path = save_dir / "sweep_ranking.json"
    write_verified(path, json.dumps(rows, indent=2).encode())
    if coverage is not None:
        write_verified(save_dir / "sweep_coverage.json",
                       json.dumps(coverage, indent=2).encode())
    return path


def load_ranking(path) -> List[Dict]:
    """Parse a written sweep_ranking.json back into ranking rows (GANConfig
    round-trip; JSON null — a never-updated tracker — maps back to -inf so
    it sorts below every real Sharpe).

    Digest-verified: the ``.sha256`` sidecar is checked when present, and
    corruption raises a ``ValueError`` NAMING the file instead of resuming
    the protocol from a silently wrong ranking."""
    path = Path(path)

    def parse(data: bytes) -> List[Dict]:
        try:
            return json.loads(data.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(
                f"corrupt or truncated sweep ranking {path}: {e}") from e

    rows, _ = load_verified(path, parse)
    return [
        {
            "config": GANConfig.from_dict(r["config"]),
            "lr": r["lr"],
            "seed": r["seed"],
            "valid_sharpe": (
                r["valid_sharpe"] if r["valid_sharpe"] is not None
                else float("-inf")
            ),
        }
        for r in rows
    ]


def select_winners(ranked: List[Dict], top_k: int) -> List[Dict]:
    """Top-k DISTINCT (architecture, lr) combos from a ranked sweep result:
    several seeds of one setting collapse to its best-ranked entry."""
    winners, seen = [], set()
    for r in ranked:
        key = (architecture_signature(r["config"]), r["lr"])
        if key not in seen:
            seen.add(key)
            winners.append(r)
        if len(winners) == top_k:
            break
    return winners


def _spearman(pairs: List[Tuple[float, float]]) -> Optional[float]:
    """Rank correlation of (search, retrain) Sharpe pairs (ties broken by
    position, as the JAX package's); None when either side is constant."""
    def ranks(a):
        r = np.empty(len(a))
        r[np.argsort(a)] = np.arange(len(a))
        return r

    ra = ranks(np.asarray([p[0] for p in pairs]))
    rb = ranks(np.asarray([p[1] for p in pairs]))
    denom = float(np.std(ra) * np.std(rb))
    if denom <= 0:
        return None
    return float(np.mean((ra - ra.mean()) * (rb - rb.mean())) / denom)


def run_protocol(
    configs_and_lrs: Sequence[Tuple[GANConfig, float]],
    train_batch,
    valid_batch,
    test_batch,
    search_tcfg: TrainConfig,
    ensemble_tcfg: TrainConfig,
    search_seeds: Sequence[int] = (42,),
    ensemble_seeds: Sequence[int] = PAPER_SEEDS,
    top_k: int = 4,
    save_dir: Optional[str] = None,
    verbose: bool = True,
    member_chunk: Optional[int] = None,
    exec_cfg: Optional[ExecutionConfig] = None,
    ranking: Optional[List[Dict]] = None,
    diagnostic_top: int = 8,
    diagnostic_seeds: Sequence[int] = (42, 123, 456),
    quorum: Optional[int] = None,
    ledger: Optional[SweepLedger] = None,
    consult_ledger: bool = False,
    coverage: Optional[Dict] = None,
    heartbeat=None,
    grid_mesh=None,
) -> Dict:
    """Search → winners → per-winner member-stacked seed ensembles → report.

    `ranking`: a precomputed stage-1 result (the parsed sweep_ranking.json
    or a ledger-rebuilt elastic ranking) — skips the search, so an
    interrupted protocol resumes at the ensemble stage. `ledger` /
    `consult_ledger`: bucket-level durability for stage 1 (see
    ``run_sweep``). `coverage`: a degraded elastic search's coverage
    manifest, shipped beside the ranking (``sweep_coverage.json``) and
    echoed in the report. `heartbeat` beats each stage's section.

    `quorum`: a winner's ensemble proceeds with ≥ quorum finite members,
    dropping diverged ones (recorded per winner as ``dropped_seeds``);
    fewer raises ``parallel.ensemble.QuorumError``. None: no check.

    `diagnostic_top` / `diagnostic_seeds`: ranks top_k..diagnostic_top are
    also retrained (full schedule, `diagnostic_seeds` members each) to
    widen the search-vs-retrain rank comparison (the Spearman in
    ``report["search_vs_retrain"]``) to ≥ 8 pairs; every point there is
    valued at the same member count. ≤ top_k disables the retrains.

    `grid_mesh`: the search's mesh packing (``run_sweep``).
    """
    t0 = time.time()
    exec_cfg = exec_cfg or ExecutionConfig()
    save_dir = Path(save_dir) if save_dir else None

    # human lines from process 0 only; every process keeps its copy in
    # its own events.jsonl
    logger = get_run_logger()

    def log(msg):
        logger.info(msg, verbose=verbose)

    # ---- stage 1: hyperparameter search ----
    search_stats: Dict = {}
    if ranking is not None:
        log(f"[protocol] reusing precomputed search ranking "
            f"({len(ranking)} points)")
        ranked = ranking
    else:
        log(f"[protocol] search: {len(configs_and_lrs)} (config, lr) combos "
            f"× {len(search_seeds)} seeds")
        with logger.events.span("protocol/search",
                                n_combos=len(configs_and_lrs)):
            ranked = run_sweep(
                configs_and_lrs, search_seeds, train_batch, valid_batch,
                tcfg=search_tcfg, top_k=None, keep_params=False,
                verbose=verbose, member_chunk=member_chunk,
                exec_cfg=exec_cfg, stats_out=search_stats, ledger=ledger,
                consult_ledger=consult_ledger, heartbeat=heartbeat,
                grid_mesh=grid_mesh,
            )
    search_s = time.time() - t0
    if save_dir:  # also on resume: keep the artifact contract in save_dir
        write_ranking(save_dir, ranked, coverage)
    winners = select_winners(ranked, top_k)
    log(f"[protocol] search done in {search_s:.1f}s; top {len(winners)}:")
    for i, w in enumerate(winners):
        log(f"  #{i}: hidden={w['config'].hidden_dim} "
            f"rnn={w['config'].num_units_rnn} "
            f"K={w['config'].num_condition_moment} "
            f"drop={w['config'].dropout} lr={w['lr']} "
            f"valid_sharpe={w['valid_sharpe']:.4f}")

    # ---- stage 2: per-winner member-stacked seed ensembles ----
    report = {
        "search_seconds": round(search_s, 1),
        "search_resumed_from_ranking": ranking is not None,
        "n_search_points": len(ranked),
        **({"search_stats": search_stats} if search_stats else {}),
        **({"search_coverage": coverage} if coverage is not None else {}),
        **({"quorum": quorum} if quorum is not None else {}),
        "winners": [],
    }
    splits = {"train": train_batch, "valid": valid_batch, "test": test_batch}
    all_test_weights = []  # [S, T, N] per winner, for the grand ensemble
    winner_params = []  # kept for the same-seed-count diagnostic below
    for rank, w in enumerate(winners):
        cfg = w["config"]
        tcfg = dataclasses.replace(ensemble_tcfg, lr=w["lr"])
        log(f"[protocol] ensemble #{rank}: {len(ensemble_seeds)} seeds, "
            f"lr={w['lr']}")
        if heartbeat is not None:
            heartbeat.beat("winner_ensemble", rank=rank)
        with logger.events.span("protocol/ensemble", rank=rank,
                                n_seeds=len(ensemble_seeds)):
            params, _hist = train_ensemble(
                cfg, train_batch, valid_batch, test_batch,
                seeds=ensemble_seeds, tcfg=tcfg, member_chunk=member_chunk,
                exec_cfg=exec_cfg, verbose=verbose)
        member_seeds = [int(s) for s in ensemble_seeds]
        dropped: List[int] = []
        if quorum is not None:
            params, member_seeds, dropped = apply_quorum(
                params, ensemble_seeds, quorum)
            for s in dropped:
                logger.events.counter("sweep/quorum_drop", rank=rank, seed=s)
            if dropped:
                log(f"[protocol] ensemble #{rank}: dropped diverged members "
                    f"(seeds {dropped}); proceeding with "
                    f"{len(member_seeds)}/{len(ensemble_seeds)} "
                    f"(quorum {quorum})")
        metrics = {name: ensemble_metrics(cfg, params, b, exec_cfg)
                   for name, b in splits.items()}
        all_test_weights.append(
            member_weights(cfg, params, test_batch, exec_cfg))
        winner_params.append({"cfg": cfg, "params": params,
                              "seeds": member_seeds})
        if save_dir:
            for seed, sd in zip(member_seeds, member_state_dicts(params)):
                mdir = save_dir / f"rank{rank}_seed{seed}"
                mdir.mkdir(parents=True, exist_ok=True)
                cfg.save(mdir / "config.json")
                save_state_dict(mdir / "best_model_sharpe.pt", sd)
        report["winners"].append({
            "rank": rank,
            "config": cfg.to_dict(),
            "lr": w["lr"],
            "search_valid_sharpe": _finite(w["valid_sharpe"]),
            "seeds": member_seeds,
            "dropped_seeds": dropped,
            "ensemble_sharpe": {
                name: _finite(float(m["ensemble_sharpe"]))
                for name, m in metrics.items()
            },
            "individual_test_sharpes": [
                _finite(s) for s in metrics["test"]["individual_sharpes"].tolist()
            ],
        })
        log(f"  test ensemble sharpe: "
            f"{report['winners'][-1]['ensemble_sharpe']['test']}")

    # ---- selection-noise diagnostic: search Sharpe vs retrained ensemble --
    # Every point is valued at the SAME member count (a 9-seed ensemble's
    # Sharpe carries a level shift from extra averaging that a 3-seed one
    # lacks): the winners are re-evaluated on the diagnostic_seeds subset of
    # their trained members where all of them survived, else at their full
    # ensemble (n_seeds records it).
    diag_points = []
    for w, wp in zip(report["winners"], winner_params):
        member_seeds = wp["seeds"]
        if set(diagnostic_seeds) <= set(member_seeds):
            idx = [member_seeds.index(s) for s in diagnostic_seeds]
            sub = {k: v[idx] for k, v in wp["params"].items()}
            val = _finite(float(ensemble_metrics(
                wp["cfg"], sub, valid_batch, exec_cfg)["ensemble_sharpe"]))
            n_seeds = len(idx)
        else:
            val = w["ensemble_sharpe"]["valid"]
            n_seeds = len(member_seeds)
        diag_points.append({
            "rank": w["rank"],
            "search_valid_sharpe": w["search_valid_sharpe"],
            "ensemble_valid_sharpe": val,
            "n_seeds": n_seeds,
        })
    extra = (select_winners(ranked, diagnostic_top)[len(winners):]
             if diagnostic_top > len(winners) else [])
    for di, w in enumerate(extra):
        rank = len(winners) + di
        log(f"[protocol] diagnostic retrain #{rank}: "
            f"{len(diagnostic_seeds)} seeds, lr={w['lr']}")
        if heartbeat is not None:
            heartbeat.beat("diagnostic_retrain", rank=rank)
        params, _hist = train_ensemble(
            w["config"], train_batch, valid_batch, test_batch,
            seeds=diagnostic_seeds,
            tcfg=dataclasses.replace(ensemble_tcfg, lr=w["lr"]),
            member_chunk=member_chunk, exec_cfg=exec_cfg, verbose=False)
        m = ensemble_metrics(w["config"], params, valid_batch, exec_cfg)
        diag_points.append({
            "rank": rank,
            "search_valid_sharpe": _finite(w["valid_sharpe"]),
            "ensemble_valid_sharpe": _finite(float(m["ensemble_sharpe"])),
            "n_seeds": len(diagnostic_seeds),
        })
    if len(diag_points) >= 2:
        # None encodes a non-finite tracker (diverged member): DROP those
        # pairs rather than rank a diverged model mid-pack
        pairs = [(p["search_valid_sharpe"], p["ensemble_valid_sharpe"])
                 for p in diag_points
                 if p["search_valid_sharpe"] is not None
                 and p["ensemble_valid_sharpe"] is not None]
        report["search_vs_retrain"] = {
            "points": diag_points,
            "spearman_rank_correlation": (_spearman(pairs)
                                          if len(pairs) >= 2 else None),
            "n_pairs_used": len(pairs),
            "note": "search-rank vs full-schedule-retrain rank agreement "
                    "over the top diagnostic_top distinct settings (the "
                    "winners' ensembles plus smaller diagnostic retrains — "
                    "n_seeds per point; non-finite entries dropped); a "
                    "low/negative value means the quick-schedule search "
                    "Sharpe would mis-rank candidates",
        }

    # ---- stage 3: grand ensemble across all winners' members ----
    if heartbeat is not None:
        heartbeat.beat("grand_ensemble")
    grand = ensemble_metrics_from_weights(
        torch.cat(all_test_weights, dim=0), test_batch)
    report["grand_ensemble_test_sharpe"] = float(grand["ensemble_sharpe"])
    report["grand_ensemble_test_ev"] = float(grand["explained_variation"])
    report["grand_ensemble_test_xs_r2"] = float(grand["cross_sectional_r2"])
    # the surviving member count: quorum drops shrink winners' ensembles
    report["n_grand_members"] = int(
        sum(int(w.shape[0]) for w in all_test_weights))
    report["total_seconds"] = round(time.time() - t0, 1)
    if save_dir:
        write_verified(save_dir / "report.json",
                       json.dumps(report, indent=2).encode())
    log(f"[protocol] grand ensemble ({report['n_grand_members']} members) "
        f"test sharpe: {report['grand_ensemble_test_sharpe']:.4f}")
    log(f"[protocol] total {report['total_seconds']:.1f}s")
    return report


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Paper protocol: config search → seed ensembles → report"
    )
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="./sweep_results")

    # search grid (defaults give the paper's 384 combos; --quick shrinks)
    p.add_argument("--quick", action="store_true",
                   help="Tiny grid + short schedules (smoke/demo)")
    p.add_argument("--top_k", type=int, default=4)
    p.add_argument("--search_seeds", type=int, nargs="+", default=[42])
    p.add_argument("--ensemble_seeds", type=int, nargs="+",
                   default=list(PAPER_SEEDS))
    p.add_argument("--resume_ranking", type=str, default=None, metavar="JSON",
                   help="Path to a previously written sweep_ranking.json: "
                        "skip stage 1 (the search) and go straight to the "
                        "winner ensembles")
    # elastic execution (reliability/ledger.py + scheduler.py)
    p.add_argument("--workers", type=int, default=0, metavar="N",
                   help="Elastic search: run stage 1 as N supervise-wrapped "
                        "worker processes claiming architecture buckets "
                        "from a leased, ledger-backed work queue (dead "
                        "workers' leases expire and their buckets are "
                        "re-claimed; poison buckets quarantine). 0 "
                        "(default) trains buckets in this process")
    p.add_argument("--resume-from-ledger", action="store_true",
                   dest="resume_from_ledger",
                   help="Resume stage 1 from the save dir's bucket ledger: "
                        "completed buckets load from their verified records "
                        "instead of retraining (without it the ledger is "
                        "cleared first; the supervisor appends this on "
                        "sweep restarts); a record written at another "
                        "--compute_dtype or --kernel is retrained")
    p.add_argument("--metrics_port", type=int, default=None, metavar="PORT",
                   help="Serve live Prometheus metrics on "
                        "http://127.0.0.1:PORT/metrics while the sweep runs "
                        "(read-only stdlib sidecar over the coordinator's "
                        "counters/gauges/span histograms; port 0 picks a "
                        "free one, printed at startup)")
    p.add_argument("--search_only", action="store_true",
                   help="Stop after stage 1: write sweep_ranking.json "
                        "(plus sweep_coverage.json when degraded) and exit")
    p.add_argument("--lease_timeout", type=float, default=120.0, metavar="S",
                   help="Elastic: lease staleness after which a worker's "
                        "claimed bucket is presumed dead and re-claimable")
    p.add_argument("--max_bucket_attempts", type=int, default=3, metavar="K",
                   help="Elastic: claims a bucket may consume without ever "
                        "completing before it is quarantined as poison")
    p.add_argument("--retry_backoff", type=float, default=2.0, metavar="S",
                   help="Elastic: per-bucket retry backoff base (doubles "
                        "per attempt — the supervisor's backoff curve)")
    p.add_argument("--device_slices", type=int, default=0, metavar="S",
                   help="Mesh-packed search: cut the local devices into S "
                        "disjoint contiguous slices; each worker leases ONE "
                        "slice (the queue's device-slice lease) and lays "
                        "its buckets' (lr × seed) grids over a ('grid',) "
                        "mesh of that slice's devices. With --workers 0 one "
                        "slice spans the local devices. 0 (default): no "
                        "mesh. A grid point trains the same either way")
    p.add_argument("--slice_width", type=int, default=None, metavar="W",
                   help="Devices per slice (default: local device count "
                        "// device_slices)")
    p.add_argument("--bucket_timeout", type=float, default=3600.0,
                   metavar="S",
                   help="Elastic: per-bucket wall budget. While a bucket "
                        "trains, the lease keeper beats the worker "
                        "heartbeat (so long buckets are NOT hang-killed); "
                        "past this budget it goes silent, the worker is "
                        "killed as hung, and the bucket is reclaimed — "
                        "repeated overruns quarantine it")
    p.add_argument("--worker", action="store_true",
                   help="Run as one elastic worker: claim buckets from the "
                        "save_dir's existing queue until drained (normally "
                        "spawned by --workers N, not by hand)")
    p.add_argument("--worker_id", type=str, default=None,
                   help="Stable worker name (events.<id>.jsonl, "
                        "heartbeat.<id>.json, manifest.<id>.json)")
    p.add_argument("--worker_heartbeat_timeout", type=float, default=300.0,
                   metavar="S",
                   help="Per-worker supervision: heartbeat staleness that "
                        "counts as a hang (the lease keeper beats through "
                        "a training bucket, so this need not exceed bucket "
                        "time — --bucket_timeout bounds that instead)")
    p.add_argument("--worker_min_uptime", type=float, default=5.0,
                   metavar="S")
    p.add_argument("--worker_max_restarts", type=int, default=5)
    p.add_argument("--worker_backoff", type=float, default=1.0, metavar="S")
    p.add_argument("--quorum", type=int, default=None, metavar="Q",
                   help="Ensemble quorum: proceed with ≥Q surviving "
                        "(finite) seed members per winner, dropping "
                        "diverged members (recorded in the report); fewer "
                        "than Q survivors is an error")
    p.add_argument("--diagnostic_top", type=int, default=8,
                   help="Retrain the top-D distinct settings (winners plus "
                        "extra diagnostic retrains) so the search-vs-retrain "
                        "rank correlation has ≥8 pairs; ≤ top_k disables")
    p.add_argument("--diagnostic_seeds", type=int, nargs="+",
                   default=[42, 123, 456])

    # schedules
    p.add_argument("--member_chunk", type=int, default=None,
                   help="Cap members per stacked run (sequential chunks); "
                        "the plain route (--kernel off) keeps [S, T, H, N] "
                        "activations")
    p.add_argument("--search_epochs_unc", type=int, default=64)
    p.add_argument("--search_epochs_moment", type=int, default=16)
    p.add_argument("--search_epochs", type=int, default=256)
    p.add_argument("--search_ignore_epoch", type=int, default=16)
    p.add_argument("--epochs_unc", type=int, default=256)
    p.add_argument("--epochs_moment", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1024)
    p.add_argument("--ignore_epoch", type=int, default=64)
    p.add_argument("--small_sample", action="store_true",
                   help="Search on the first --n_periods periods x the "
                        "--n_stocks stocks with the most valid observations")
    p.add_argument("--n_periods", type=int, default=100)
    p.add_argument("--n_stocks", type=int, default=500)
    add_execution_args(p)
    return p


def _worker_main(args) -> int:
    """One elastic sweep worker: claim buckets from the save_dir's queue
    manifest until drained. Spawned (and supervised) by the coordinating
    ``--workers N`` process; everything that must be FLEET-consistent —
    schedule, seeds, grid, lease policy, wire format — comes from the
    manifest, and the execution flags from the coordinator's argv."""
    exec_cfg = execution_config(args)  # exits naming CUDA without a card
    device = resolve_device(exec_cfg.device)
    save_dir = Path(args.save_dir)
    wid = args.worker_id or f"w{os.getpid()}"
    events = EventLog(save_dir, process_index=0,
                      filename=f"events.{wid}.jsonl")
    hb = Heartbeat(save_dir / f"heartbeat.{wid}.json", events=events)
    logger = set_run_logger(RunLogger(events=events))
    hb.beat("setup")
    try:
        queue = open_work_queue(save_dir, events=events)
        meta = queue.load_manifest()
        if meta.get("execution") not in (None, execution_of(exec_cfg)):
            raise SystemExit(
                f"worker {wid}: --kernel/--compute_dtype give "
                f"{execution_of(exec_cfg)}, the queue was written for "
                f"{meta['execution']}")
        manifest_name = f"manifest.{wid}.json"
        # a restarted worker carries its predecessors' plans and counts
        prev = load_manifest(save_dir, manifest_name) or {}
        write_manifest(save_dir, "sweep_worker", events=events,
                       filename=manifest_name, data_dir=meta.get("data_dir"),
                       extra={"worker": wid, "device": str(device),
                              "execution": execution_of(exec_cfg)})
        logger.info(f"[sweep:{wid}] elastic worker up: "
                    f"{len(queue.items())} buckets on {device}; kernel "
                    f"{exec_cfg.kernel}, compute dtype "
                    f"{exec_cfg.compute_dtype}")
        with events.span("data/load"):
            train_ds, valid_ds, _ = load_splits_chunked(
                meta.get("data_dir") or args.data_dir, events=events)
        if meta.get("small_sample"):
            train_ds = train_ds.subsample(meta["n_periods"],
                                          meta["n_stocks"])
            valid_ds = valid_ds.subsample(
                min(meta["n_periods"], valid_ds.T), meta["n_stocks"])
        bf16_wire = bool(meta.get("bf16_wire", False))
        train_b, valid_b = (
            device_put_batch(ds.full_batch(), device=device,
                             bf16_wire=bf16_wire)
            for ds in (train_ds, valid_ds))
        # the route every bucket of this worker runs: the CUDA kernels, or
        # their plain versions (a CPU device, --kernel off)
        update_manifest(save_dir, filename=manifest_name, kernel_route=(
            "cuda" if ffn_route(train_b["returns"], exec_cfg.kernel)
            == "kernel" else "plain"))
        hb.beat("sweep_wait")
        programs: Dict[str, Dict] = dict(prev.get("kernel_programs") or {})
        n = run_sweep_worker(queue, wid, train_b, valid_b, exec_cfg=exec_cfg,
                             heartbeat=hb, programs_out=programs)
        # the route each bucket trained on: its kernels' launch plans as
        # the card holds them (empty on the plain route)
        update_manifest(save_dir, filename=manifest_name,
                        kernel_programs=programs,
                        buckets_trained=prev.get("buckets_trained", 0) + n)
        hb.beat("done", memory=True)
        logger.info(f"[sweep:{wid}] queue drained; trained {n} buckets")
    finally:
        events.close()
    return 0


def _prepare_queue(args, configs, search_tcfg, save_dir, events, logger,
                   bf16_wire, exec_cfg):
    """The run dir's ledger + work manifest, shared by BOTH stage-1 modes
    (in-process and elastic): writing ``sweep_ledger/queue.json`` even for
    a single-process sweep is what lets a supervised restart detect the
    ledger and auto-append ``--resume-from-ledger``, and lets a later
    ``--workers N`` run adopt a partially completed single-process search.
    With ``--resume-from-ledger`` an existing manifest is kept only when it
    describes THIS sweep — same bucket keys in the same order (keys hash
    config+grid+seeds+schedule); anything else is reset, discarding
    completed records, rather than silently reusing foreign work. A kept
    record written at another compute dtype or kernel route is dropped,
    and its bucket retrains (as ``run_sweep`` does)."""
    from .reliability.scheduler import WorkQueue
    from .reliability.supervisor import RestartPolicy

    ledger = SweepLedger(save_dir / LEDGER_DIRNAME)
    queue = WorkQueue(
        save_dir / LEDGER_DIRNAME, ledger=ledger,
        lease_timeout_s=args.lease_timeout,
        max_attempts=args.max_bucket_attempts,
        backoff=RestartPolicy(backoff_base_s=args.retry_backoff,
                              backoff_max_s=max(30.0, args.retry_backoff)),
        events=events,
    )
    items = bucket_work_items(configs, args.search_seeds, search_tcfg)
    execution = execution_of(exec_cfg)
    meta = {
        "kind": "sweep_queue",
        "tcfg": dataclasses.asdict(search_tcfg),
        "seeds": [int(s) for s in args.search_seeds],
        "member_chunk": args.member_chunk,
        "bf16_wire": bool(bf16_wire),
        "data_dir": args.data_dir,
        "small_sample": bool(args.small_sample),
        "n_periods": args.n_periods,
        "n_stocks": args.n_stocks,
        "lease_timeout_s": args.lease_timeout,
        "max_attempts": args.max_bucket_attempts,
        "retry_backoff_s": args.retry_backoff,
        "bucket_timeout_s": args.bucket_timeout,
        "execution": execution,
        # mesh packing is fleet-consistent: every worker must agree on the
        # device partitioning, so it rides the manifest
        "device_slices": int(args.device_slices or 0),
        "slice_width": args.slice_width,
    }
    keep = False
    if args.resume_from_ledger and queue.queue_path().exists():
        try:
            old = queue.load_manifest()
            keep = ([it["key"] for it in old.get("items", [])]
                    == [it["key"] for it in items])
        except (ValueError, FileNotFoundError, KeyError):
            keep = False
        if not keep:
            logger.warning(
                "[sweep] existing ledger does not match this grid/schedule; "
                "resetting it (completed records discarded)")
    if not keep:
        ledger.reset()
    else:
        for it in items:
            key = it["key"]
            if (ledger.has(key)
                    and ledger.load(key).get("execution") != execution):
                logger.warning(
                    f"[sweep] ledger record {key[:12]} ran at another "
                    f"execution than {execution}: retraining its bucket")
                clear_generations(ledger.record_path(key))
    # write (or, on resume, REwrite) the manifest: the work list is
    # identical on a kept resume, but this invocation's fleet policy —
    # lease timeout, attempt budget, retry backoff — must win over the
    # stale one (records and quarantine markers are untouched either way)
    queue.write_manifest(items, meta)
    return ledger, queue


def _elastic_search(args, queue, save_dir, events, hb, logger):
    """Stage 1 as a supervised worker fleet: run N supervise-wrapped
    ``--worker`` children against the prepared work manifest, rebuild the
    ranking (and its coverage manifest) from the ledger. Returns
    ``(ranked, coverage, worker summaries)``."""
    from .reliability.faults import ENV_EVENTS, ENV_PLAN, ENV_STATE
    from .reliability.scheduler import run_supervised_workers
    from .reliability.supervisor import RestartPolicy

    items = queue.items()
    status = queue.status()
    if status["completed"]:
        # the fleet-level ledger-hit evidence: this many buckets are reused
        # from the ledger, not retrained (workers skip them inside claim(),
        # which scans every item per call — a per-scan counter there would
        # inflate, so the coordinator records the truth once)
        events.counter("sweep/ledger_hit", value=status["completed"])
    logger.info(
        f"[sweep] elastic search: {len(items)} buckets × {args.workers} "
        f"workers (already completed: {status['completed']}, quarantined: "
        f"{status['quarantined']})")

    # fault-plan plumbing (as the supervise CLI's): a fleet sharing one
    # state file sees ONE hit stream, so a planned kill fires exactly once
    # across all workers and restarts
    env = dict(os.environ)
    if env.get(ENV_PLAN):
        env.setdefault(ENV_STATE, str(save_dir / "fault_state.json"))
        env.setdefault(ENV_EVENTS, str(save_dir / "events.faults.jsonl"))
    # each worker gets the data dir and this run's execution flags (no
    # worker falls back to the CPU); everything else is in the manifest
    worker_cmds = {
        f"w{i}": [sys.executable, "-m", f"{__package__}.sweep", "--worker",
                  "--worker_id", f"w{i}", "--data_dir", args.data_dir,
                  "--save_dir", str(save_dir), "--device", args.device,
                  "--kernel", args.kernel,
                  "--compute_dtype", args.compute_dtype]
        for i in range(args.workers)
    }
    policy = RestartPolicy(
        heartbeat_timeout_s=args.worker_heartbeat_timeout,
        min_uptime_s=args.worker_min_uptime,
        max_restarts=args.worker_max_restarts,
        backoff_base_s=args.worker_backoff,
    )
    summaries: Dict[str, Dict] = {}
    with events.span("sweep/fleet", workers=args.workers,
                     n_buckets=len(items)):
        fleet = threading.Thread(
            target=lambda: summaries.update(run_supervised_workers(
                save_dir, worker_cmds, policy=policy, env=env)),
            name="sweep-fleet")
        fleet.start()
        while fleet.is_alive():
            # the COORDINATOR's liveness: its own supervisor (if any) must
            # see progress while it blocks on the fleet
            hb.beat("sweep_fleet")
            fleet.join(timeout=2.0)
    for wid, summary in sorted(summaries.items()):
        line = (f"[sweep] worker {wid}: outcome={summary['outcome']} "
                f"restarts={summary['restarts']} "
                f"hang_kills={summary['hang_kills']}")
        if summary["outcome"] == "success":
            logger.info(line)
        else:
            logger.warning(line)
    ranked, coverage = ranking_from_ledger(queue)
    if not ranked:
        raise RuntimeError(
            "elastic search completed no buckets at all — see "
            f"{save_dir}/supervised.w*.log and the quarantine markers in "
            f"{save_dir}/{LEDGER_DIRNAME}/quarantine/")
    if not coverage["complete"]:
        logger.warning(
            f"[sweep] DEGRADED completion: {coverage['completed']}/"
            f"{coverage['n_buckets']} buckets "
            f"({len(coverage['quarantined'])} quarantined, "
            f"{len(coverage['missing'])} missing) — the ranking ships "
            "anyway; sweep_coverage.json is the explicit contract")
    return ranked, coverage, summaries


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    if args.worker:
        return _worker_main(args)
    exec_cfg = execution_config(args)  # exits naming CUDA without a card
    device = resolve_device(exec_cfg.device)
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    events = EventLog(save_dir)
    hb = Heartbeat(save_dir / "heartbeat.json", events=events)
    logger = set_run_logger(RunLogger(events=events))
    hb.beat("setup")
    sidecar = None
    if args.metrics_port is not None:
        sidecar = MetricsSidecar([events.metrics], port=args.metrics_port)
        port = sidecar.start()
        logger.info(f"metrics sidecar: http://127.0.0.1:{port}/metrics "
                    "(Prometheus text)")
    try:
        _protocol(args, exec_cfg, device, save_dir, events, hb, logger,
                  argv)
    finally:
        if sidecar is not None:
            sidecar.stop()
        events.close()


def _protocol(args, exec_cfg, device, save_dir, events, hb, logger, argv):
    logger.info(f"Paper-protocol sweep on {device}; kernel "
                f"{exec_cfg.kernel}, compute dtype {exec_cfg.compute_dtype}")
    with events.span("data/load"):
        train_ds, valid_ds, test_ds = load_splits_chunked(args.data_dir,
                                                          events=events)
    if args.small_sample:
        train_ds = train_ds.subsample(args.n_periods, args.n_stocks)
        valid_ds = valid_ds.subsample(min(args.n_periods, valid_ds.T),
                                      args.n_stocks)
        test_ds = test_ds.subsample(min(args.n_periods, test_ds.T),
                                    args.n_stocks)
    base = GANConfig(
        macro_feature_dim=train_ds.macro_feature_dim,
        individual_feature_dim=train_ds.individual_feature_dim,
    )
    if args.quick:
        configs = grid_configs(base, **QUICK_GRID_KW)
        search_tcfg = TrainConfig(
            **QUICK_SEARCH_SCHEDULE, seed=args.search_seeds[0])
        ensemble_tcfg = TrainConfig(**QUICK_ENSEMBLE_SCHEDULE)
        if args.ensemble_seeds == list(PAPER_SEEDS):
            args.ensemble_seeds = [42, 123, 456]
        args.top_k = min(args.top_k, 2)
        args.diagnostic_top = args.top_k  # smoke mode: no extra retrains
    else:
        configs = grid_configs(base)  # the 384-combo paper grid
        search_tcfg = TrainConfig(
            num_epochs_unc=args.search_epochs_unc,
            num_epochs_moment=args.search_epochs_moment,
            num_epochs=args.search_epochs,
            ignore_epoch=args.search_ignore_epoch,
            seed=args.search_seeds[0],
        )
        ensemble_tcfg = TrainConfig(
            num_epochs_unc=args.epochs_unc,
            num_epochs_moment=args.epochs_moment,
            num_epochs=args.epochs,
            ignore_epoch=args.ignore_epoch,
        )
    # mask-packed; the bf16 wire only where every swept configuration's
    # consumers round the panel to bf16 anyway
    bf16_wire = all(exec_cfg.bf16_wire_ok(c) for c, _ in configs)
    train_b, valid_b, test_b = (
        device_put_batch(ds.full_batch(), device=device, bf16_wire=bf16_wire)
        for ds in (train_ds, valid_ds, test_ds))

    ranking = load_ranking(args.resume_ranking) if args.resume_ranking else None
    # startup manifest: base config + both schedules + grid size, so the
    # save dir carries its own provenance
    write_manifest(
        save_dir, "sweep", events=events, config=base, tcfg=search_tcfg,
        seed=args.search_seeds[0], data_dir=args.data_dir, argv=argv,
        extra={
            "n_configs": len(configs),
            "quick": bool(args.quick),
            "top_k": args.top_k,
            "ensemble_seeds": list(args.ensemble_seeds),
            "ensemble_train_config": dataclasses.asdict(ensemble_tcfg),
            "resumed_from_ranking": args.resume_ranking,
            "workers": args.workers,
            "resume_from_ledger": bool(args.resume_from_ledger),
            "quorum": args.quorum,
            "execution": execution_of(exec_cfg),
            "device_slices": args.device_slices,
        },
    )
    hb.beat("protocol")
    if args.device_slices:
        # fail HERE, not as a worker crash loop after slice leases are
        # claimed: the fit check is slice_devices itself, so the pre-flight
        # cannot drift from what the workers enforce
        try:
            slice_devices(0, args.device_slices, args.slice_width,
                          devices=local_devices(device))
        except ValueError as e:
            raise SystemExit(
                f"--device_slices {args.device_slices}"
                + (f" --slice_width {args.slice_width}"
                   if args.slice_width else "")
                + f" does not fit the local devices: {e}") from e
        if args.workers > args.device_slices:
            # legal: a worker with no slice lease polls until one frees, so
            # the surplus are hot spares that train only after another
            # worker dies and its slice expires
            logger.warning(
                f"[sweep] --workers {args.workers} > --device_slices "
                f"{args.device_slices}: {args.workers - args.device_slices} "
                "worker(s) will idle as hot spares until a slice frees")

    # stage-1 durability: every completed bucket lands in the save dir's
    # ledger (and the work manifest is written up front), so any restart —
    # supervised auto --resume-from-ledger or manual — resumes from the
    # last completed bucket, not from zero
    coverage = None
    if ranking is None:
        ledger, queue = _prepare_queue(
            args, configs, search_tcfg, save_dir, events, logger, bf16_wire,
            exec_cfg)
        if args.workers > 0:
            ranking, coverage, _summaries = _elastic_search(
                args, queue, save_dir, events, hb, logger)
    else:
        ledger = SweepLedger(save_dir / LEDGER_DIRNAME)

    # in-process mesh packing: one slice spanning the local devices (the
    # elastic fleet leases one slice per worker through the manifest)
    grid_mesh = None
    if args.device_slices and args.workers == 0:
        grid_mesh = grid_slice_mesh(0, 1, width=args.slice_width,
                                    devices=local_devices(device))
        logger.info(f"[sweep] mesh-packed grids over "
                    f"{grid_mesh.devices.size} device(s)")

    if args.search_only:
        if ranking is None:
            with events.span("protocol/search", n_combos=len(configs)):
                ranking = run_sweep(
                    configs, args.search_seeds, train_b, valid_b,
                    tcfg=search_tcfg, top_k=None, keep_params=False,
                    member_chunk=args.member_chunk, exec_cfg=exec_cfg,
                    ledger=ledger, consult_ledger=args.resume_from_ledger,
                    heartbeat=hb, grid_mesh=grid_mesh)
        path = write_ranking(save_dir, ranking, coverage)
        if coverage is not None:
            update_manifest(save_dir, search_coverage=coverage)
        hb.beat("done", memory=True)
        logger.info(f"[sweep] search-only: ranking ({len(ranking)} points) "
                    f"written to {path}")
        return

    report = run_protocol(
        configs, train_b, valid_b, test_b,
        search_tcfg=search_tcfg, ensemble_tcfg=ensemble_tcfg,
        search_seeds=args.search_seeds,
        ensemble_seeds=args.ensemble_seeds,
        top_k=args.top_k, save_dir=args.save_dir,
        member_chunk=args.member_chunk, exec_cfg=exec_cfg,
        ranking=ranking,
        diagnostic_top=args.diagnostic_top,
        diagnostic_seeds=args.diagnostic_seeds,
        quorum=args.quorum,
        ledger=ledger,
        consult_ledger=args.resume_from_ledger,
        coverage=coverage,
        heartbeat=hb,
        grid_mesh=grid_mesh,
    )
    # late provenance into the manifest: quorum drops and degraded-search
    # coverage only exist after the protocol ran
    drops = {str(w["rank"]): w["dropped_seeds"]
             for w in report["winners"] if w.get("dropped_seeds")}
    patch = {}
    if drops:
        patch["quorum_drops"] = {"quorum": args.quorum,
                                 "dropped_members": drops}
    if coverage is not None:
        patch["search_coverage"] = coverage
    if patch:
        update_manifest(save_dir, **patch)
    hb.beat("done", memory=True)
    logger.info(f"\nReport written to {save_dir / 'report.json'}")
    logger.info("Grand ensemble test Sharpe: "
                f"{report['grand_ensemble_test_sharpe']:.4f}")


if __name__ == "__main__":
    main()
