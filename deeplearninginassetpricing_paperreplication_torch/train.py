"""Training CLI: the 3-phase GAN on one CUDA card (or, explicitly, the CPU).

    python -m deeplearninginassetpricing_paperreplication_torch.train \\
        --data_dir data/synthetic_data --save_dir ./checkpoints

The counterpart of the JAX package's ``train.py`` for the flags this port
implements (the schedule, the model's widths, dropout and seed), plus the
port's ``--device`` (default cuda: a host without a CUDA device is an
error naming CUDA, never a quiet CPU run), ``--kernel auto|on|off`` and
``--compute_dtype``, and ``--diag_stride``.

The panel loads through the overlapped startup pipeline
(``data/pipeline.py``: decode through the disk cache, streamed mask-packed
transfer, the route's kernels built and planned meanwhile; the bf16 wire
where ``ExecutionConfig.bf16_wire_ok``); ``--no_pipeline`` is the
sequential ``load_splits`` + ``to_batch``; ``--small_sample`` loads through
the cache and keeps ``--n_periods`` × ``--n_stocks``. The startup spans and
``panel_cache`` counters go to ``events.jsonl``. It writes
``reference_profile.json`` (the train split's drift profile, before
training), ``config.json``, ``best_model_loss.pt``, ``best_model_sharpe.pt``,
``final_model.pt``, ``history.npz`` (with ``diag_*`` fields under
``--diag_stride``), ``health.json`` and ``final_metrics.json`` into
``--save_dir``; the port's ``evaluate_ensemble``, server and promotion gate
read that directory.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from .data.panel import load_splits
from .data.pipeline import (
    StartupPipeline,
    load_splits_cached,
    probe_split_shapes,
    trainer_precompile_fn,
)
from .data.transfer import device_put_batch
from .evaluate_ensemble import add_execution_args, execution_config
from .observability.drift import reference_profile, write_profile
from .observability.events import EventLog
from .training.trainer import train_3phase
from .utils.config import GANConfig, TrainConfig, resolve_device


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
    # model (paper defaults)
    p.add_argument("--hidden_dim", type=int, nargs="+", default=[64, 64])
    p.add_argument("--rnn_dim", type=int, nargs="+", default=[4])
    p.add_argument("--num_moments", type=int, default=8)
    p.add_argument("--dropout", type=float, default=0.05)
    p.add_argument("--hidden_dim_moment", type=int, nargs="+", default=[])
    p.add_argument("--seed", type=int, default=42)
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
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    tcfg = TrainConfig(num_epochs_unc=args.epochs_unc,
                       num_epochs_moment=args.epochs_moment,
                       num_epochs=args.epochs, lr=args.lr,
                       ignore_epoch=args.ignore_epoch, seed=args.seed,
                       print_freq=args.print_freq)
    events = EventLog(save_dir)

    def make_cfg(macro_dim, individual_dim):
        if args.config:
            return GANConfig.load(args.config)
        return GANConfig(
            macro_feature_dim=macro_dim, individual_feature_dim=individual_dim,
            hidden_dim=tuple(args.hidden_dim),
            num_units_rnn=tuple(args.rnn_dim),
            hidden_dim_moment=tuple(args.hidden_dim_moment),
            num_condition_moment=args.num_moments, dropout=args.dropout)

    names = ("train", "valid", "test")
    if not (args.no_pipeline or args.small_sample):
        # shapes from the npz headers at t≈0: the route's kernels build and
        # plan on a worker thread under the decode and transfer
        shapes = probe_split_shapes(args.data_dir)
        cfg = make_cfg(shapes["train"].get("macro", (0, 0))[1],
                       shapes["train"]["individual"][2])
        bf16_wire = exec_cfg.bf16_wire_ok(cfg)
        with events.span("startup/pipeline"):
            res = StartupPipeline(
                args.data_dir, bf16_wire=bf16_wire, device=device,
                events=events, shapes=shapes,
                compile_fn=trainer_precompile_fn(cfg, exec_cfg),
            ).start().result()
        train_ds, valid_ds, test_ds = res.datasets
        batches = dict(zip(names, res.batches))
        cache_hits = res.cache_hits
        print(f"Loaded through the startup pipeline: panel cache "
              f"{sum(cache_hits.values())}/{len(cache_hits)} split hits, "
              f"{'bf16' if bf16_wire else 'f32'} wire", flush=True)
    else:
        bf16_wire, cache_hits = False, None
        with events.span("data/load"):
            if args.no_pipeline:
                train_ds, valid_ds, test_ds = load_splits(args.data_dir)
            else:
                train_ds, valid_ds, test_ds = load_splits_cached(
                    args.data_dir, events=events)
        if args.small_sample:
            print(f"Using small sample: {args.n_periods} periods, "
                  f"{args.n_stocks} stocks", flush=True)
            train_ds = train_ds.subsample(args.n_periods, args.n_stocks)
            valid_ds = valid_ds.subsample(min(args.n_periods, valid_ds.T),
                                          args.n_stocks)
            test_ds = test_ds.subsample(min(args.n_periods, test_ds.T),
                                        args.n_stocks)
        cfg = make_cfg(train_ds.macro_feature_dim,
                       train_ds.individual_feature_dim)
        with events.span("data/transfer"):
            if args.no_pipeline:
                batches = {name: ds.to_batch(device) for name, ds in
                           zip(names, (train_ds, valid_ds, test_ds))}
            else:
                # mask-packed, and the bf16 wire where every consumer of
                # the panel rounds it to bf16 anyway
                bf16_wire = exec_cfg.bf16_wire_ok(cfg)
                batches = {name: device_put_batch(
                    ds.full_batch(), device=device, bf16_wire=bf16_wire)
                    for name, ds in zip(names, (train_ds, valid_ds, test_ds))}
    print(f"Device: {device}; kernel {exec_cfg.kernel}, compute dtype "
          f"{exec_cfg.compute_dtype}", flush=True)
    print(f"  Train: {train_ds.T} x {train_ds.N} | Valid: {valid_ds.T} x "
          f"{valid_ds.N} | Test: {test_ds.T} x {test_ds.N}", flush=True)
    # the train panel's drift profile: what later panels and promotion
    # candidates are scored against; written before training, so even a
    # crashed run leaves it
    write_profile(save_dir, reference_profile(train_ds.full_batch(),
                                              source=str(args.data_dir)))
    t0 = time.time()
    gan, _, _, trainer = train_3phase(
        cfg, batches["train"], batches["valid"], batches["test"], tcfg=tcfg,
        save_dir=str(save_dir), seed=args.seed, exec_cfg=exec_cfg,
        diag_stride=args.diag_stride)
    wall = time.time() - t0
    print("\nBest Model Performance (normalized weights):", flush=True)
    results = {}
    for name, b in batches.items():
        m = trainer.final_eval(b)
        results[name] = m
        print(f"  {name:5s} - Sharpe: {m['sharpe']:7.3f}, MaxDD: "
              f"{m['max_drawdown']:7.2%}", flush=True)
    (save_dir / "final_metrics.json").write_text(json.dumps(
        {**results, "wall_clock_s": wall,
         "phase_execute_seconds": trainer.phase_seconds,
         "epoch_ms": trainer.epoch_ms(), "device": str(device),
         "startup": {"pipeline": not (args.no_pipeline or args.small_sample),
                     "bf16_wire": bf16_wire, "cache_hits": cache_hits}},
        indent=2))
    events.close()
    print(f"\nTotal wall-clock: {wall:.1f}s — checkpoints in {save_dir}",
          flush=True)


if __name__ == "__main__":
    main()
