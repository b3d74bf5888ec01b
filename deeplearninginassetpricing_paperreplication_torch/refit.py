"""Rolling re-estimation CLI — monthly walk-forward refits as ledger
buckets, feeding the promotion gate.

    python -m deeplearninginassetpricing_paperreplication_torch.refit \\
        --data_dir data/synthetic_data --run_dir ./refit_run \\
        --start_month 12 --n_refits 6 --stride 1

The counterpart of the JAX package's ``refit.py``, with the same
functions, flags, layout, span, counter and fault-site names. The paper
estimates the SDF once on a fixed split; a production system re-estimates
as new months arrive. Each refit — "train a K-seed ensemble on the first
*m* months of the train panel" — is one bucket of the elastic sweep's
machinery (``reliability/ledger.py`` + ``reliability/scheduler.py``):
durable per-bucket records, leased multi-worker execution with stale-lease
takeover, retry and quarantine of poison months, and supervised restart
with ``--resume-from-ledger``. A killed worker resumes with zero retrains
of completed months, whose checkpoints are never touched again (each
record carries its members' artifact sha256s as the evidence).

Completed refits then walk through the promotion gate
(``reliability/promotion.py``) in month order: digest verification,
architecture compatibility, the finite-weights/SDF validation pass (the
kernels at S = the seed count), and the Sharpe-regression check against
the incumbent pointer. A refit that regressed does not reach the pointer;
a passing one atomically advances ``serving_current.json``.

Layout under ``<run_dir>``::

    sweep_ledger/           — queue.json + records/ + leases/
    refits/m{month:04}/seed{s}/
                            — one verified member checkpoint per
                              (refit month × seed): config.json,
                              best_model_{sharpe,loss}.pt, final_model.pt,
                              history.npz, health.json and the window's
                              reference_profile.json (each .pt and .json
                              with its .sha256 sidecar)
    serving_current.json    — the promotion pointer (unless
                              --promote_root points elsewhere)
    events*.jsonl, heartbeat*.json, manifest*.json
                            — the coordinator's and each worker's telemetry

It runs on the CUDA device unless ``--device cpu`` is given, on the
``--kernel`` route and ``--compute_dtype`` of ``add_execution_args``;
workers run at the coordinator's, and refuse a queue written for another
execution. As in the JAX package, a bucket's members train one after
another, completed months promote under a monotone month cutoff, and a
gate rejection does not stop later months. Unlike the JAX worker, which
opens its queue with the default lease settings, a port worker takes the
fleet's lease timeout, attempt budget and retry backoff from the queue
manifest, as the port's sweep workers do.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from .evaluate_ensemble import add_execution_args, execution_config
from .reliability.ledger import LEDGER_DIRNAME, SweepLedger, bucket_key


def member_dir(run_dir, month: int, seed: int) -> Path:
    return Path(run_dir) / "refits" / f"m{month:04d}" / f"seed{seed}"


def refit_months(args) -> List[int]:
    if args.months:
        months = [int(m) for m in args.months]
    else:
        months = [args.start_month + i * args.stride
                  for i in range(args.n_refits)]
    if sorted(set(months)) != months:
        raise ValueError(f"refit months must be strictly increasing: {months}")
    if months and months[0] < 2:
        raise ValueError("a refit needs at least 2 train months")
    return months


def build_refit_items(cfg, months: List[int], seeds: List[int],
                      tcfg) -> List[Dict[str, Any]]:
    """One work item per refit month. The bucket key hashes everything
    that determines the month's checkpoints — architecture, seeds,
    schedule, and the month itself — so a ledger record under this key is
    safe to reuse; the keys are the JAX package's for the same inputs."""
    tdict = dataclasses.asdict(tcfg)
    items = []
    for i, m in enumerate(months):
        key = bucket_key(dict(cfg.to_dict(), __refit_month=int(m)),
                         [tcfg.lr], seeds, tdict)
        items.append({"key": key, "index": i, "month": int(m)})
    return items


def train_refit_bucket(
    cfg,
    month: int,
    seeds: List[int],
    train_ds,
    valid_batch,
    tcfg,
    run_dir,
    events=None,
    heartbeat=None,
    exec_cfg=None,
    init: Optional[Callable[[int], Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Train the month's K-seed ensemble: one ``train_3phase`` per seed on
    the first `month` periods of the train panel (walk-forward), full
    valid split (`valid_batch`, tensors), on ``exec_cfg.device``. Each
    member lands as a verified checkpoint dir the promotion gate (and
    ``stack_checkpoints``) consumes, with the window's reference profile.
    Returns the record payload: dirs, per-member best valid Sharpe, and
    each artifact's sha256.

    `init` (seed → state_dict), when given, starts each member from that
    state dict instead of ``train_3phase``'s seeded init (the tests start
    from the JAX package's init); None on every CLI path."""
    import numpy as np

    from .data.pipeline import stream_batch
    from .observability.drift import reference_profile, write_profile
    from .reliability.promotion import verify_member_dirs
    from .training.trainer import train_3phase
    from .utils.config import ExecutionConfig, resolve_device

    exec_cfg = exec_cfg or ExecutionConfig()
    device = resolve_device(exec_cfg.device)
    window = train_ds.subsample(month, train_ds.N)
    # the refit window's reference profile (observability/drift.py): the
    # fingerprint of the data THIS month's ensemble learned from, written
    # into every member dir so the promotion gate's data_drift check can
    # score later panels against it
    window_np = window.full_batch()
    profile = reference_profile(window_np, source=f"month{month:04d}")
    # the streamed, mask-packed transfer (bit for bit device_put_batch)
    train_b = stream_batch(window_np, device=device)
    valid_b = {k: v.to(device) for k, v in valid_batch.items()}
    dirs: List[str] = []
    sharpes: List[Optional[float]] = []
    for s in seeds:
        d = member_dir(run_dir, month, s)
        _gan, _params, history, _trainer = train_3phase(
            cfg, train_b, valid_b, tcfg=tcfg, save_dir=str(d),
            seed=int(s), verbose=False, exec_cfg=exec_cfg,
            state_dict=None if init is None else init(int(s)),
            events=events, heartbeat=heartbeat)
        write_profile(d, profile)
        vs = np.asarray(history["valid_sharpe"], np.float64)
        finite = vs[np.isfinite(vs)]
        sharpes.append(float(finite.max()) if finite.size else None)
        dirs.append(str(d))
    members, rejection = verify_member_dirs(dirs)
    if rejection is not None:
        raise RuntimeError(
            f"refit month {month} produced an unverifiable member: "
            f"{rejection[0]}: {rejection[1]}")
    return {"dirs": dirs, "members": members, "valid_sharpe": sharpes}


def run_refit_worker(
    queue,
    worker_id: str,
    cfg,
    train_ds,
    valid_batch,
    heartbeat=None,
    poll_s: float = 0.5,
    exec_cfg=None,
) -> int:
    """One refit worker's claim → train → record loop (the
    ``run_sweep_worker`` shape, over refit-month buckets). Completed
    months are skipped inside ``claim()`` via the ledger — a restarted
    worker re-trains nothing it already recorded. Each record carries how
    its month ran (``parallel.sweep.execution_of``). `exec_cfg`:
    :func:`train_refit_bucket`'s."""
    from .observability.logging import get_run_logger
    from .parallel.sweep import execution_of
    from .reliability.faults import inject
    from .reliability.scheduler import LeaseKeeper
    from .utils.config import ExecutionConfig, TrainConfig

    exec_cfg = exec_cfg or ExecutionConfig()
    logger = get_run_logger()
    manifest = queue.load_manifest()
    tcfg = TrainConfig(**manifest["tcfg"])
    seeds = [int(s) for s in manifest["seeds"]]
    run_dir = Path(manifest["run_dir"])
    bucket_timeout = manifest.get("bucket_timeout_s")
    n_buckets = len(queue.items())
    trained = 0
    while True:
        status, item = queue.claim(worker_id)
        if status == "drained":
            break
        if status == "wait":
            if heartbeat is not None:
                heartbeat.beat("refit_wait")
            time.sleep(queue.next_wake_delay(poll_s, worker=worker_id))
            continue
        key, idx, month = item["key"], int(item["index"]), int(item["month"])
        if heartbeat is not None:
            heartbeat.beat("refit_bucket", bucket=idx + 1,
                           n_buckets=n_buckets)
        logger.info(f"[refit:{worker_id}] month {month} "
                    f"({idx + 1}/{n_buckets}, attempt {item['attempt']}): "
                    f"{len(seeds)} seeds", verbose=True)
        # mid-bucket fault site (shared with the sweep): fires with the
        # lease held — a kill here orphans the lease for takeover
        inject("sweep/bucket", bucket=idx + 1, n_buckets=n_buckets,
               path=key, worker=worker_id)
        try:
            with logger.events.span("refit/bucket", month=month,
                                    worker=worker_id) as sp, \
                    LeaseKeeper(queue, key, worker_id, heartbeat=heartbeat,
                                max_lifetime_s=bucket_timeout) as keeper:
                out = train_refit_bucket(
                    cfg, month, seeds, train_ds, valid_batch, tcfg,
                    run_dir, events=logger.events, heartbeat=heartbeat,
                    exec_cfg=exec_cfg)
            if keeper.lost:
                logger.warning(
                    f"[refit:{worker_id}] month {month} lease was taken "
                    "over mid-train; discarding this copy")
                continue
            queue.ledger.write(key, {
                "kind": "refit_bucket", "key": key, "index": idx,
                "month": month, "dirs": out["dirs"],
                "members": out["members"],
                "valid_sharpe": out["valid_sharpe"],
                "execution": execution_of(exec_cfg),
                "worker": worker_id,
                "seconds": round(sp.seconds, 3),
                "completed_at": round(time.time(), 3),
            })
            logger.events.counter("sweep/ledger_write", bucket=idx + 1,
                                  path=key, worker=worker_id, month=month)
            queue.complete(key, worker_id)
            trained += 1
        except Exception as e:  # noqa: BLE001 — any failure releases the claim
            queue.fail(key, worker_id, error=f"{type(e).__name__}: {e}")
            logger.warning(
                f"[refit:{worker_id}] month {month} failed "
                f"({type(e).__name__}: {e}); released for retry")
    return trained


def promote_completed(
    queue,
    promote_root,
    valid_batch_np: Optional[Dict[str, Any]],
    sharpe_tolerance: Optional[float],
    events=None,
    logger=None,
    moment_tolerance: Optional[float] = None,
    drift_threshold: Optional[float] = None,
    exec_cfg=None,
) -> Dict[str, Any]:
    """Walk the ledger's completed refits through the promotion gate in
    month order. Idempotent: months the pointer (head or history) already
    names as a source are skipped — and, because refits promote in month
    order, so is every month ≤ the NEWEST month the pointer names. The
    pointer's embedded history is bounded (history_keep), so on a long
    rolling run old sources age out of it; without the monotone cutoff a
    restarted coordinator would re-promote those aged-out months and move
    the pointer back onto a months-stale model. Gate rejections are
    recorded and do NOT stop later months — a bad refit month must not
    wedge the rolling pipeline. `exec_cfg`: the gate's validation pass
    (device, kernel route, compute dtype)."""
    from .reliability.promotion import GateRejection, promote, read_pointer

    pointer = read_pointer(promote_root)
    already = set()
    if pointer is not None:
        already.add(pointer.get("source"))
        for h in pointer.get("history") or []:
            already.add(h.get("source"))
    latest_month = -1
    for src in already:
        if (isinstance(src, str) and src.startswith("month")
                and src[5:].isdigit()):
            latest_month = max(latest_month, int(src[5:]))
    promoted: List[int] = []
    rejected: List[Dict[str, Any]] = []
    skipped: List[int] = []
    for item in sorted(queue.items(), key=lambda it: int(it["index"])):
        key, month = item["key"], int(item["month"])
        source = f"month{month:04d}"
        if not queue.ledger.has(key):
            continue
        if source in already or month <= latest_month:
            skipped.append(month)
            continue
        record = queue.ledger.load(key)
        try:
            head = promote(
                promote_root, record["dirs"], valid_batch=valid_batch_np,
                source=source, sharpe_tolerance=sharpe_tolerance,
                events=events, moment_tolerance=moment_tolerance,
                drift_threshold=drift_threshold, exec_cfg=exec_cfg)
            promoted.append(month)
            if logger is not None:
                logger.info(
                    f"[refit] month {month} promoted → generation "
                    f"{head['generation']} "
                    f"(valid Sharpe {head['valid_sharpe']})")
        except GateRejection as e:
            rejected.append({"month": month, "reason": e.reason,
                             "detail": e.detail[:300]})
            if logger is not None:
                logger.warning(f"[refit] month {month} REJECTED by the "
                               f"gate: {e.reason} ({e.detail[:200]})")
    return {"promoted": promoted, "rejected": rejected, "skipped": skipped}


# -- CLI ---------------------------------------------------------------------


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Rolling walk-forward re-estimation as ledger buckets, "
                    "feeding the checkpoint promotion gate")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--run_dir", type=str, required=True,
                   help="ledger + refit checkpoints + (default) the "
                        "promotion pointer")
    p.add_argument("--months", type=int, nargs="+", default=None,
                   help="explicit train-month counts, strictly increasing "
                        "(overrides --start_month/--n_refits/--stride)")
    p.add_argument("--start_month", type=int, default=12,
                   help="first refit trains on this many leading train "
                        "months")
    p.add_argument("--n_refits", type=int, default=4)
    p.add_argument("--stride", type=int, default=1,
                   help="months added per refit step")
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2],
                   help="ensemble member seeds per refit")
    # schedule (paper 3-phase; tiny values make a CI-speed refit)
    p.add_argument("--epochs_unc", type=int, default=256)
    p.add_argument("--epochs_moment", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1024)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ignore_epoch", type=int, default=64)
    # model
    p.add_argument("--hidden_dim", type=int, nargs="+", default=[64, 64])
    p.add_argument("--rnn_dim", type=int, nargs="+", default=[4])
    p.add_argument("--num_moments", type=int, default=8)
    p.add_argument("--dropout", type=float, default=0.05)
    p.add_argument("--no_lstm", action="store_false", dest="use_lstm",
                   default=True)
    # promotion gate
    p.add_argument("--no_promote", action="store_true",
                   help="train + record only; leave the pointer untouched")
    p.add_argument("--promote_root", type=str, default=None,
                   help="control-plane dir for serving_current.json "
                        "(default: --run_dir)")
    p.add_argument("--sharpe_tolerance", type=float, default=0.05,
                   help="candidate valid Sharpe may trail the incumbent by "
                        "this much; negative disables the regression gate")
    p.add_argument("--moment_tolerance", type=float, default=None,
                   help="model-health gate: reject a refit (reason "
                        "moment_violation) whose worst per-moment "
                        "conditional violation norm on the valid split "
                        "exceeds this or is non-finite")
    p.add_argument("--drift_threshold", type=float, default=None,
                   help="data-drift gate: reject a refit (reason "
                        "data_drift) whose reference profile diverges "
                        "from the valid panel past this max PSI (0.25 = "
                        "the standard significant-shift bar)")
    # elastic execution
    p.add_argument("--workers", type=int, default=0, metavar="N",
                   help="run N supervised worker processes against the "
                        "bucket queue (0 = train in-process)")
    p.add_argument("--worker", action="store_true",
                   help="internal: run as one elastic worker (spawned by "
                        "--workers N)")
    p.add_argument("--worker_id", type=str, default=None)
    p.add_argument("--resume-from-ledger", action="store_true",
                   dest="resume_from_ledger",
                   help="keep an existing matching ledger (completed "
                        "months are NOT re-trained); auto-appended by the "
                        "supervisor on worker restart")
    p.add_argument("--lease_timeout", type=float, default=60.0)
    p.add_argument("--max_bucket_attempts", type=int, default=3)
    p.add_argument("--retry_backoff", type=float, default=1.0)
    p.add_argument("--bucket_timeout", type=float, default=None)
    p.add_argument("--worker_heartbeat_timeout", type=float, default=300.0)
    p.add_argument("--worker_min_uptime", type=float, default=5.0)
    p.add_argument("--worker_max_restarts", type=int, default=5)
    p.add_argument("--worker_backoff", type=float, default=1.0)
    add_execution_args(p)
    return p


def _build_cfg(args, train_ds):
    from .utils.config import GANConfig

    return GANConfig(
        macro_feature_dim=train_ds.macro_feature_dim,
        individual_feature_dim=train_ds.individual_feature_dim,
        hidden_dim=tuple(args.hidden_dim),
        num_units_rnn=tuple(args.rnn_dim),
        num_condition_moment=args.num_moments,
        dropout=args.dropout,
        use_rnn=args.use_lstm,
    )


def _load_data(args, events):
    from .data.pipeline import load_splits_chunked

    with events.span("data/load"):
        train_ds, valid_ds, _test = load_splits_chunked(
            args.data_dir, events=events)
    return train_ds, valid_ds


def _prepare_queue(args, items, cfg, tcfg, run_dir, events, logger,
                   exec_cfg):
    """Ledger + verified work manifest (the sweep CLI's reset-or-keep
    contract: ``--resume-from-ledger`` keeps records only when the manifest
    describes THIS refit schedule — same keys, same order — at this
    execution, ``parallel.sweep.execution_of(exec_cfg)``; anything else is
    reset, discarding completed records)."""
    from .parallel.sweep import execution_of
    from .reliability.scheduler import WorkQueue
    from .reliability.supervisor import RestartPolicy

    ledger = SweepLedger(run_dir / LEDGER_DIRNAME)
    queue = WorkQueue(
        run_dir / LEDGER_DIRNAME, ledger=ledger,
        lease_timeout_s=args.lease_timeout,
        max_attempts=args.max_bucket_attempts,
        backoff=RestartPolicy(backoff_base_s=args.retry_backoff,
                              backoff_max_s=max(30.0, args.retry_backoff)),
        events=events,
    )
    execution = execution_of(exec_cfg)
    meta = {
        "kind": "refit_queue",
        # workers read the architecture from the manifest, never from argv
        "config": cfg.to_dict(),
        "tcfg": dataclasses.asdict(tcfg),
        "seeds": [int(s) for s in args.seeds],
        "data_dir": args.data_dir,
        "run_dir": str(run_dir),
        "months": [int(it["month"]) for it in items],
        "lease_timeout_s": args.lease_timeout,
        "max_attempts": args.max_bucket_attempts,
        "retry_backoff_s": args.retry_backoff,
        "bucket_timeout_s": args.bucket_timeout,
        "execution": execution,
    }
    keep = False
    if args.resume_from_ledger and queue.queue_path().exists():
        try:
            old = queue.load_manifest()
            keep = ([it["key"] for it in old.get("items", [])]
                    == [it["key"] for it in items]
                    and old.get("execution") == execution)
        except (ValueError, FileNotFoundError, KeyError):
            keep = False
        if not keep:
            logger.warning(
                "[refit] existing ledger does not match this "
                "schedule/config/execution; resetting it")
    if not keep:
        ledger.reset()
    queue.write_manifest(items, meta)
    return ledger, queue


def _worker_main(args) -> int:
    """One elastic refit worker (``--worker``): everything fleet-consistent
    — months, seeds, schedule, config, lease settings — comes from the
    queue manifest, and the execution flags from the coordinator's argv.
    A worker refuses a manifest written for another execution."""
    from .data.pipeline import stream_batch
    from .observability.events import EventLog
    from .observability.heartbeat import Heartbeat
    from .observability.logging import RunLogger, set_run_logger
    from .observability.manifest import write_manifest
    from .ops.sdf_ffn import _route as ffn_route
    from .parallel.sweep import execution_of, open_work_queue
    from .utils.config import GANConfig, TrainConfig, resolve_device

    exec_cfg = execution_config(args)  # exits naming CUDA without a card
    device = resolve_device(exec_cfg.device)
    run_dir = Path(args.run_dir)
    wid = args.worker_id or f"w{os.getpid()}"
    events = EventLog(run_dir, filename=f"events.{wid}.jsonl")
    hb = Heartbeat(run_dir / f"heartbeat.{wid}.json", events=events)
    logger = set_run_logger(RunLogger(events=events))
    hb.beat("setup")
    try:
        queue = open_work_queue(run_dir, events=events)
        manifest = queue.load_manifest()
        if manifest.get("execution") not in (None, execution_of(exec_cfg)):
            raise SystemExit(
                f"worker {wid}: --kernel/--compute_dtype give "
                f"{execution_of(exec_cfg)}, the queue was written for "
                f"{manifest['execution']}")
        logger.info(f"[refit:{wid}] worker up: {len(queue.items())} refit "
                    f"months on {device}; kernel {exec_cfg.kernel}, compute "
                    f"dtype {exec_cfg.compute_dtype}")
        train_ds, valid_ds = _load_data(args, events)
        cfg = GANConfig.from_dict(manifest["config"], strict=False)
        TrainConfig(**manifest["tcfg"])  # validate early, like the sweep worker
        valid_b = stream_batch(valid_ds.full_batch(), device=device)
        write_manifest(run_dir, "refit_worker", events=events,
                       filename=f"manifest.{wid}.json",
                       data_dir=args.data_dir,
                       extra={"worker": wid, "device": str(device),
                              "execution": execution_of(exec_cfg),
                              "kernel_route": (
                                  "cuda" if ffn_route(
                                      valid_b["returns"], exec_cfg.kernel)
                                  == "kernel" else "plain")})
        hb.beat("refit_wait")
        n = run_refit_worker(queue, wid, cfg, train_ds, valid_b,
                             heartbeat=hb, exec_cfg=exec_cfg)
        hb.beat("done", memory=True)
        logger.info(f"[refit:{wid}] queue drained; trained {n} refit months")
    finally:
        events.close()
    return 0


def _run_fleet(args, run_dir, events, hb, logger) -> Dict[str, Dict]:
    """N supervise-wrapped ``--worker`` children against the prepared
    manifest (the sweep CLI's fleet shape: shared fault-plan state so a
    planned kill fires once fleet-wide; per-worker supervisor events;
    each worker on this run's ``--device``, ``--kernel`` and
    ``--compute_dtype``)."""
    from .reliability.faults import ENV_EVENTS, ENV_PLAN, ENV_STATE
    from .reliability.scheduler import run_supervised_workers
    from .reliability.supervisor import RestartPolicy

    env = dict(os.environ)
    if env.get(ENV_PLAN):
        env.setdefault(ENV_STATE, str(run_dir / "fault_state.json"))
        env.setdefault(ENV_EVENTS, str(run_dir / "events.faults.jsonl"))
    worker_cmds = {
        f"w{i}": [sys.executable, "-m", f"{__package__}.refit", "--worker",
                  "--worker_id", f"w{i}", "--data_dir", args.data_dir,
                  "--run_dir", str(run_dir), "--device", args.device,
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
    with events.span("refit/fleet", workers=args.workers,
                     n_buckets=len(refit_months(args))):
        fleet = threading.Thread(
            target=lambda: summaries.update(run_supervised_workers(
                run_dir, worker_cmds, policy=policy, env=env)),
            name="refit-fleet")
        fleet.start()
        while fleet.is_alive():
            hb.beat("refit_fleet")
            fleet.join(timeout=2.0)
    for wid, summary in sorted(summaries.items()):
        line = (f"[refit] worker {wid}: outcome={summary['outcome']} "
                f"restarts={summary['restarts']}")
        (logger.info if summary["outcome"] == "success"
         else logger.warning)(line)
    return summaries


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.worker:
        return _worker_main(args)
    exec_cfg = execution_config(args)  # exits naming CUDA without a card

    from .data.pipeline import stream_batch
    from .observability.events import EventLog
    from .observability.heartbeat import Heartbeat
    from .observability.logging import RunLogger, set_run_logger
    from .observability.manifest import write_manifest
    from .parallel.sweep import execution_of
    from .utils.config import TrainConfig, resolve_device

    device = resolve_device(exec_cfg.device)
    run_dir = Path(args.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    events = EventLog(run_dir)
    hb = Heartbeat(run_dir / "heartbeat.json", events=events)
    logger = set_run_logger(RunLogger(events=events))
    hb.beat("setup")
    try:
        train_ds, valid_ds = _load_data(args, events)
        months = refit_months(args)
        if months and months[-1] > train_ds.T:
            raise SystemExit(
                f"refit month {months[-1]} exceeds the train panel "
                f"({train_ds.T} periods)")
        cfg = _build_cfg(args, train_ds)
        tcfg = TrainConfig(
            num_epochs_unc=args.epochs_unc,
            num_epochs_moment=args.epochs_moment, num_epochs=args.epochs,
            lr=args.lr, ignore_epoch=args.ignore_epoch)
        write_manifest(run_dir, "refit", events=events, config=cfg,
                       tcfg=tcfg, data_dir=args.data_dir, argv=argv,
                       extra={"months": months, "seeds": list(args.seeds),
                              "workers": args.workers,
                              "resume_from_ledger": args.resume_from_ledger,
                              "execution": execution_of(exec_cfg)})
        items = build_refit_items(cfg, months, args.seeds, tcfg)
        _ledger, queue = _prepare_queue(args, items, cfg, tcfg, run_dir,
                                        events, logger, exec_cfg)
        status = queue.status()
        if status["completed"]:
            events.counter("sweep/ledger_hit", value=status["completed"])
        logger.info(f"[refit] {len(items)} refit months × {len(args.seeds)} "
                    f"seeds on {device}; kernel {exec_cfg.kernel}, compute "
                    f"dtype {exec_cfg.compute_dtype} (already completed: "
                    f"{status['completed']})")

        if args.workers > 0:
            _run_fleet(args, run_dir, events, hb, logger)
        else:
            valid_b = stream_batch(valid_ds.full_batch(), device=device)
            run_refit_worker(queue, "inline", cfg, train_ds, valid_b,
                             heartbeat=hb, exec_cfg=exec_cfg)

        outcome: Dict[str, Any] = {"status": queue.status()}
        if not args.no_promote:
            valid_np = valid_ds.full_batch()
            tol = (None if args.sharpe_tolerance < 0
                   else args.sharpe_tolerance)
            hb.beat("promote")
            outcome["promotion"] = promote_completed(
                queue, args.promote_root or run_dir, valid_np, tol,
                events=events, logger=logger,
                moment_tolerance=args.moment_tolerance,
                drift_threshold=args.drift_threshold, exec_cfg=exec_cfg)
        hb.beat("done", memory=True)
        logger.info(f"[refit] done: {outcome}")
    finally:
        events.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
