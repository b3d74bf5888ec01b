"""Training CLI: the 3-phase GAN on one CUDA card (or, explicitly, the CPU).

    python -m deeplearninginassetpricing_paperreplication_torch.train \\
        --data_dir data/synthetic_data --save_dir ./checkpoints

The counterpart of the JAX package's ``train.py``, flag for flag but for
``--share_sdf_program`` (it chooses between XLA program bodies; eager
PyTorch has none) and ``--pallas`` (here ``--kernel``): the schedule,
the model's widths (``--no_lstm``, and ``--rnn_dim_moment``, which
neither package's model reads), dropout and seed; ``--save_best_freq``
(accepted, no effect, as in the reference and the JAX CLI);
``--checkpoint_every K`` (a resumable state every K epochs within each
phase), ``--stop_after_epochs E`` (stop after E epochs of this
invocation, leaving a resumable state; the process exits 0 and writes no
``final_metrics.json``) and ``--resume`` (continue from the run dir's
state, bit for bit an uninterrupted run); the divergence guard
(``--no_divergence_guard``, ``--guard_max_trips``); ``--metrics_port``
(a read-only ``/metrics`` and ``/healthz`` sidecar while it trains; 0
picks a free port, logged at startup); ``--profile DIR`` (a
``torch.profiler`` Chrome trace of the training, CPU and CUDA
activities, into DIR); ``--diag_stride``. The port's own flags are
``--device`` (default cuda: a host without a CUDA device is an error
naming CUDA, never a quiet CPU run), ``--kernel auto|on|off`` and
``--compute_dtype``.

``--shard_stocks`` trains on the stock axis split over the ranks of a
``torch.distributed`` process group, each rank on its own contiguous span
(``parallel/collectives.py``: the sums over stocks and the gradients are
all-reduced)::

    python -m torch.distributed.run --nproc_per_node 2 \
        -m deeplearninginassetpricing_paperreplication_torch.train \
        --data_dir D --save_dir R --shard_stocks [--device cpu]

It joins the group torchrun describes in the environment (NCCL where each
rank has a card of its own, gloo where ranks share one or on the CPU); the
device is ``cuda:LOCAL_RANK % device_count``. Without a group it runs at
world size 1, the unsharded route bit for bit, and says so. Only rank 0
writes the run dir's files; every rank writes its own
``events.proc<r>.jsonl``, and the manifest records the mesh.

The panel loads through the overlapped startup pipeline
(``data/pipeline.py``: decode through the disk cache, streamed mask-packed
transfer, the route's kernels built and planned meanwhile; the bf16 wire
where ``ExecutionConfig.bf16_wire_ok``); ``--no_pipeline`` is the
sequential ``load_splits`` + ``to_batch``; ``--small_sample`` loads through
the cache and keeps ``--n_periods`` × ``--n_stocks``.

It writes into ``--save_dir``: ``events.jsonl`` (spans, counters —
``epochs_dispatched``, ``guard/trip``, ``panel_cache`` —, log lines,
memory and ``program`` rows), ``heartbeat.json`` (the phase section and
``device_memory``), ``manifest.json`` (config, versions, devices, data
fingerprint, ``reference_profile`` and ``kernel_programs``: each
kernel's launch plan as the card holds it), ``reference_profile.json``
(the train split's drift profile, before training), ``config.json``,
``metrics.jsonl`` (one row per epoch), ``best_model_loss.pt``,
``best_model_sharpe.pt``, ``final_model.pt``, ``history.npz`` (with
``diag_*`` fields under ``--diag_stride`` and ``divergence_trips`` after
a guard trip), ``health.json`` and ``final_metrics.json``; mid-run also
``resume_state.pt`` and ``resume_meta.json``, cleared when the run
completes. The port's ``evaluate_ensemble``, server and promotion gate
read that directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import time
from pathlib import Path

import torch

from .data.panel import load_panel, load_splits
from .data.pipeline import (
    StartupPipeline,
    load_splits_cached,
    probe_split_shapes,
    split_paths,
    stream_batch_sharded,
    trainer_precompile_fn,
)
from .data.transfer import device_put_batch
from .evaluate_ensemble import add_execution_args, execution_config
from .observability.drift import (
    PROFILE_FILENAME,
    reference_profile,
    write_profile,
)
from .observability.events import EventLog
from .observability.heartbeat import Heartbeat
from .observability.logging import RunLogger, set_run_logger
from .observability.manifest import (
    mesh_record,
    update_manifest,
    write_manifest,
)
from .observability.metrics import MetricsSidecar
from .parallel import collectives, partition
from .training.trainer import train_3phase
from .utils.config import GANConfig, TrainConfig, resolve_device


def _profile_panel(data_dir, profile_ds, train_ds):
    """The panel the drift profile sketches: the whole train split, as the
    unsharded run profiles it. A rank's startup pipeline holds only its own
    stock span, so beyond one rank (`profile_ds` None) the split's
    characteristics are decoded whole here; the macro series are global on
    every rank."""
    if profile_ds is not None:
        return profile_ds.full_batch()
    full = load_panel(split_paths(data_dir, "train")[0])
    return {"individual": full.individual, "mask": full.mask,
            "macro": train_ds.macro}


def profile_trace_nonempty(trace_dir) -> bool:
    """Did the profiler actually write anything under `trace_dir`? The CLI
    must not claim a trace it did not leave."""
    trace_dir = Path(trace_dir)
    if not trace_dir.is_dir():
        return False
    return any(p.is_file() and p.stat().st_size > 0
               for p in trace_dir.rglob("*"))


def params_sha256(params) -> str:
    """sha256 of a state_dict's names and tensor bytes, in order."""
    h = hashlib.sha256()
    for k, v in params.items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the Asset Pricing GAN (PyTorch, CUDA)")
    p.add_argument("--config", type=str, help="Path to config JSON")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, default="./checkpoints")
    # 3-phase schedule (paper defaults)
    p.add_argument("--epochs_unc", type=int, default=256)
    p.add_argument("--epochs_moment", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1024)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--print_freq", type=int, default=128)
    p.add_argument("--ignore_epoch", type=int, default=64)
    p.add_argument("--save_best_freq", type=int, default=128,
                   help="Accepted for reference-CLI parity and, like the "
                        "reference (which plumbs it but never reads it), "
                        "it has no effect: best params are tracked every "
                        "epoch and persisted on update (use "
                        "--checkpoint_every for mid-phase persistence)")
    # model (paper defaults)
    p.add_argument("--use_lstm", action="store_true", default=True)
    p.add_argument("--no_lstm", action="store_false", dest="use_lstm")
    p.add_argument("--hidden_dim", type=int, nargs="+", default=[64, 64])
    p.add_argument("--rnn_dim", type=int, nargs="+", default=[4])
    p.add_argument("--num_moments", type=int, default=8)
    p.add_argument("--dropout", type=float, default=0.05)
    p.add_argument("--hidden_dim_moment", type=int, nargs="+", default=[])
    p.add_argument("--rnn_dim_moment", type=int, nargs="+", default=[32],
                   help="Recorded in the config as num_units_rnn_moment; "
                        "the moment net builds no LSTM (the reference's "
                        "does not either)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--shard_stocks", action="store_true",
                   help="Shard the [T,N,F] panel along N over the ranks of "
                        "the torch.distributed group torchrun describes "
                        "(each rank trains on its contiguous stock span); "
                        "without a group, world size 1")
    p.add_argument("--resume", action="store_true",
                   help="Continue from the last resume point recorded in "
                        "save_dir (a phase boundary, or a mid-phase segment "
                        "boundary when --checkpoint_every was used); bit "
                        "for bit an uninterrupted run")
    p.add_argument("--checkpoint_every", type=int, default=None, metavar="K",
                   help="Persist a resumable state every K epochs within "
                        "each phase; bit for bit an uninterrupted run")
    p.add_argument("--stop_after_epochs", type=int, default=None, metavar="E",
                   help="Run at most E more train epochs this invocation "
                        "(checked at segment boundaries), save the mid-phase "
                        "state, and exit 0 — continue with --resume")
    p.add_argument("--profile", type=str, default=None, metavar="TRACE_DIR",
                   help="Capture a torch.profiler trace (CPU and, on the "
                        "card, CUDA activities) of the training into "
                        "TRACE_DIR as a Chrome trace (chrome://tracing, "
                        "ui.perfetto.dev)")
    p.add_argument("--metrics_port", type=int, default=None, metavar="PORT",
                   help="Serve live Prometheus metrics on "
                        "http://127.0.0.1:PORT/metrics while the run trains "
                        "— a read-only sidecar fed from the same call sites "
                        "as events.jsonl (port 0 picks a free one, logged "
                        "at startup)")
    p.add_argument("--no_divergence_guard", action="store_false",
                   dest="divergence_guard",
                   help="Disable the per-segment non-finite loss/grad check "
                        "(reliability/guard.py). Outputs are bit for bit "
                        "the same either way; the guard only decides "
                        "whether a NaN blowup aborts cleanly or poisons the "
                        "checkpoints")
    p.add_argument("--guard_max_trips", type=int, default=3, metavar="K",
                   help="Consecutive non-finite segments before the "
                        "divergence guard aborts the run")
    p.add_argument("--diag_stride", type=int, default=None, metavar="K",
                   help="Fold the model-health diagnostics "
                        "(ops/diagnostics.py: per-moment violation norms, "
                        "SDF/portfolio stats, adversarial gap) into the "
                        "phase-1 and phase-3 epochs every K epochs, landing "
                        "as diag_* history.npz fields. Observationally free: "
                        "trained params and best checkpoints are "
                        "bit-identical with the knob on or off")
    p.add_argument("--no_pipeline", action="store_true",
                   help="Load sequentially (load_splits, then a dense copy "
                        "to the device) instead of through the overlapped "
                        "startup pipeline; the batches are bit for bit the "
                        "same on the f32 wire")
    p.add_argument("--small_sample", action="store_true",
                   help="Train on the first --n_periods periods x the "
                        "--n_stocks stocks with the most valid observations")
    p.add_argument("--n_periods", type=int, default=100)
    p.add_argument("--n_stocks", type=int, default=500)
    add_execution_args(p)
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    exec_cfg = execution_config(args)  # exits naming CUDA without a card
    device = resolve_device(exec_cfg.device)
    backend = None
    if args.shard_stocks:
        # before the event log: its file name carries the rank
        device, backend = collectives.join_process_group(device)
        exec_cfg = dataclasses.replace(exec_cfg, device=str(device))
    try:
        _main(args, argv, exec_cfg, device, backend)
    finally:
        if backend is not None:
            collectives.leave_process_group()


def _main(args, argv, exec_cfg, device, backend):
    rank0 = partition.rank() == 0
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    tcfg = TrainConfig(num_epochs_unc=args.epochs_unc,
                       num_epochs_moment=args.epochs_moment,
                       num_epochs=args.epochs, lr=args.lr,
                       ignore_epoch=args.ignore_epoch, seed=args.seed,
                       print_freq=args.print_freq)
    # telemetry sinks of this run dir: structured events, phase-tagged
    # heartbeats, and the process-0-gated logger
    events = EventLog(save_dir)
    hb = Heartbeat(save_dir / "heartbeat.json", events=events) if rank0 \
        else None
    logger = set_run_logger(RunLogger(events=events))
    if hb is not None:
        hb.beat("setup")
    sidecar = None
    if args.metrics_port is not None and rank0:
        sidecar = MetricsSidecar([events.metrics], port=args.metrics_port)
        port = sidecar.start()
        logger.info(f"metrics sidecar: http://127.0.0.1:{port}/metrics "
                    "(Prometheus text)")
    try:
        _train(args, exec_cfg, device, save_dir, tcfg, events, hb, logger,
               argv, backend)
    finally:
        if sidecar is not None:
            sidecar.stop()
        events.close()


def _train(args, exec_cfg, device, save_dir, tcfg, events, hb, logger, argv,
           backend):
    def make_cfg(macro_dim, individual_dim):
        if args.config:
            return GANConfig.load(args.config)
        return GANConfig(
            macro_feature_dim=macro_dim, individual_feature_dim=individual_dim,
            hidden_dim=tuple(args.hidden_dim), use_rnn=args.use_lstm,
            num_units_rnn=tuple(args.rnn_dim),
            hidden_dim_moment=tuple(args.hidden_dim_moment),
            num_condition_moment=args.num_moments,
            num_units_rnn_moment=tuple(args.rnn_dim_moment),
            dropout=args.dropout)

    names = ("train", "valid", "test")
    use_pipeline = not (args.no_pipeline or args.small_sample)
    mesh = partition.create_mesh() if args.shard_stocks else None
    world, rank0 = partition.world_size(), partition.rank() == 0
    if mesh is not None:
        logger.info(
            f"Sharding the stock axis over {world} ranks ({backend})"
            if backend is not None else
            "--shard_stocks without a process group: world size 1 (the "
            "unsharded route)")
    if use_pipeline:
        # shapes from the npz headers at t≈0: the route's kernels build and
        # plan on a worker thread under the decode and transfer
        shapes = probe_split_shapes(args.data_dir)
        cfg = make_cfg(shapes["train"].get("macro", (0, 0))[1],
                       shapes["train"]["individual"][2])
        bf16_wire = exec_cfg.bf16_wire_ok(cfg)
        with events.span("startup/pipeline"):
            res = StartupPipeline(
                args.data_dir, bf16_wire=bf16_wire, device=device,
                events=events, shapes=shapes, mesh=mesh,
                compile_fn=trainer_precompile_fn(cfg, exec_cfg, events),
            ).start().result()
        train_ds, valid_ds, test_ds = res.datasets
        profile_ds = train_ds if world == 1 else None
        batches = dict(zip(names, res.batches))
        cache_hits = res.cache_hits
        programs = res.compiled["programs"]
        logger.info(f"Loaded through the startup pipeline: panel cache "
                    f"{sum(cache_hits.values())}/{len(cache_hits)} split "
                    f"hits, {'bf16' if bf16_wire else 'f32'} wire")
    else:
        bf16_wire, cache_hits = False, None
        with events.span("data/load"):
            if args.no_pipeline:
                train_ds, valid_ds, test_ds = load_splits(args.data_dir)
            else:
                train_ds, valid_ds, test_ds = load_splits_cached(
                    args.data_dir, events=events)
        if args.small_sample:
            logger.info(f"Using small sample: {args.n_periods} periods, "
                        f"{args.n_stocks} stocks")
            train_ds = train_ds.subsample(args.n_periods, args.n_stocks)
            valid_ds = valid_ds.subsample(min(args.n_periods, valid_ds.T),
                                          args.n_stocks)
            test_ds = test_ds.subsample(min(args.n_periods, test_ds.T),
                                        args.n_stocks)
        cfg = make_cfg(train_ds.macro_feature_dim,
                       train_ds.individual_feature_dim)
        profile_ds = train_ds
        if mesh is not None:
            train_ds, valid_ds, test_ds = (ds.pad_stocks(world) for ds in
                                           (train_ds, valid_ds, test_ds))
        with events.span("data/transfer"):
            if args.no_pipeline:
                batches = {name: ds.to_batch(device) for name, ds in
                           zip(names, (train_ds, valid_ds, test_ds))}
                if mesh is not None:
                    batches = {name: partition.shard_batch(b, mesh)
                               for name, b in batches.items()}
            elif mesh is not None:
                bf16_wire = exec_cfg.bf16_wire_ok(cfg)
                batches = {name: stream_batch_sharded(
                    ds.full_batch(), mesh, events=events, split=name,
                    bf16_wire=bf16_wire, device=device)
                    for name, ds in zip(names, (train_ds, valid_ds, test_ds))}
            else:
                # mask-packed, and the bf16 wire where every consumer of
                # the panel rounds it to bf16 anyway
                bf16_wire = exec_cfg.bf16_wire_ok(cfg)
                batches = {name: device_put_batch(
                    ds.full_batch(), device=device, bf16_wire=bf16_wire)
                    for name, ds in zip(names, (train_ds, valid_ds, test_ds))}
        # the route's launch plans, as the pipeline works them out
        programs = trainer_precompile_fn(cfg, exec_cfg, events)({
            name: {"returns": tuple(b["returns"].shape),
                   **({"macro": tuple(b["macro"].shape)}
                      if "macro" in b else {})}
            for name, b in batches.items()})["programs"]
    logger.info(f"Device: {device}; kernel {exec_cfg.kernel}, compute dtype "
                f"{exec_cfg.compute_dtype}")
    logger.info(f"  Train: {train_ds.T} x {train_ds.N} | Valid: {valid_ds.T}"
                f" x {valid_ds.N} | Test: {test_ds.T} x {test_ds.N}"
                + (" (rank 0's stocks)" if world > 1 and use_pipeline
                   else ""))
    mesh_rec = None
    if mesh is not None:
        # every rank's span of the padded train stock axis, and its device
        n_local = batches["train"]["returns"].shape[1]
        shard = collectives.shard_of(n_local * world)
        exec_cfg = dataclasses.replace(exec_cfg, shard=shard)
        index = (-1 if device.type != "cuda" else device.index
                 if device.index is not None else torch.cuda.current_device())
        rows = collectives.gather_ints([index], shard, device)
        mesh_rec = mesh_record(
            world, backend, [(r * n_local, (r + 1) * n_local)
                             for r in range(world)],
            [f"cuda:{d}" if d >= 0 else "cpu" for (d,) in rows])
        logger.info(f"  rank {shard.rank}: stocks [{shard.start}, "
                    f"{shard.stop}) of {shard.n_global} on {device}")
    if rank0:
        # the manifest: the run dir is self-describing from here on,
        # whatever happens to the training that follows
        write_manifest(save_dir, "train", events=events, config=cfg,
                       tcfg=tcfg, seed=args.seed, data_dir=args.data_dir,
                       argv=argv, mesh=mesh_rec,
                       extra={"resume": bool(args.resume),
                              "startup_pipeline": use_pipeline,
                              "diag_stride": args.diag_stride})
        # the whole train panel's drift profile, sharded or not: what
        # later panels and promotion candidates are scored against;
        # written before training, so even a crashed run leaves it
        with events.span("health/reference_profile"):
            write_profile(save_dir, reference_profile(
                _profile_panel(args.data_dir, profile_ds, train_ds),
                source=str(args.data_dir)))
        update_manifest(save_dir, reference_profile=PROFILE_FILENAME,
                        kernel_programs=programs)

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profile_ctx = profile(activities=acts)
    t0 = time.time()
    with profile_ctx as prof:
        _, final_params, _, trainer = train_3phase(
            cfg, batches["train"], batches["valid"], batches["test"],
            tcfg=tcfg, save_dir=str(save_dir), seed=args.seed,
            exec_cfg=exec_cfg, diag_stride=args.diag_stride,
            resume=args.resume, checkpoint_every=args.checkpoint_every,
            stop_after_epochs=args.stop_after_epochs, events=events,
            heartbeat=hb, divergence_guard=args.divergence_guard,
            guard_max_trips=args.guard_max_trips)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    wall = time.time() - t0
    if world > 1:
        # every rank's final parameters, for a check that the ranks agree
        events.counter("shard/final_params", value=1,
                       sha256=params_sha256(final_params))
    if args.profile and rank0:
        trace_dir = Path(args.profile)
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / "trace.json"))
        # claim a trace only where one was written
        if profile_trace_nonempty(trace_dir):
            logger.info(f"Profiler trace written to {trace_dir}")
        else:
            logger.warning(f"--profile: no trace files found under "
                           f"{trace_dir}", trace_dir=str(trace_dir))
    if trainer.stopped_midphase:
        # the running params are no best-model selection, and a
        # final_metrics.json would clobber a previous complete run's
        logger.info(f"\nStopped mid-phase after {wall:.1f}s; resumable "
                    f"state saved in {save_dir} — continue with --resume")
        # a planned stop, not a death in the last beat's phase
        if hb is not None:
            hb.beat("stopped")
        return
    logger.info("\nBest Model Performance (normalized weights):")
    results = {}
    for name, b in batches.items():
        with events.span(f"eval/{name}"):
            m = trainer.final_eval(b)
        results[name] = m
        logger.info(f"  {name:5s} - Sharpe: {m['sharpe']:7.3f}, MaxDD: "
                    f"{m['max_drawdown']:7.2%}")
    if not rank0:
        return
    (save_dir / "final_metrics.json").write_text(json.dumps(
        {**results, "wall_clock_s": wall, **trainer.timings(),
         "device": str(device),
         "startup": {"pipeline": use_pipeline, "bf16_wire": bf16_wire,
                     "cache_hits": cache_hits}},
        indent=2))
    logger.info(f"\nTotal wall-clock: {wall:.1f}s — checkpoints in "
                f"{save_dir}")


if __name__ == "__main__":
    main()
