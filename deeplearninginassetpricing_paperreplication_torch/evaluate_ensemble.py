"""Ensemble CLI: evaluate the weight-averaged ensemble of K run dirs, or
train one from seeds and evaluate it.

    python -m deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \\
        --data_dir data/synthetic_data --checkpoint_dirs ckpt_s42 ckpt_s123 ...
    python -m deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \\
        --data_dir data/synthetic_data --train_seeds 42 123 456 --save_dir ens

The counterpart of the JAX package's ``evaluate_ensemble.py``, both modes:

* ``--checkpoint_dirs``: the K members are stacked on a leading axis and
  evaluated together (one fused-FFN launch per split); ``--quorum Q``
  skips absent or corrupt run dirs while at least Q load.
* ``--train_seeds``: the whole ensemble trains at once, members stacked
  (``parallel.ensemble.train_ensemble``: one kernel launch per pass for
  all members), then is evaluated. ``--save_dir`` writes each member as a
  run dir (``seed_<s>/config.json`` + ``best_model_sharpe.pt``) that
  ``--checkpoint_dirs`` reads back, and ``ensemble_report.json`` (atomic,
  with a ``.sha256`` sidecar, through ``reliability/verified.py``).

It runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import sys
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .data.pipeline import load_splits_chunked
from .parallel.ensemble import (
    ensemble_metrics,
    stack_state_dicts,
    train_ensemble,
)
from .reliability.verified import write_verified
from .training.checkpoint import (
    load_checkpoint_dir,
    member_state_dicts,
    save_state_dict,
)
from .utils.config import ExecutionConfig, GANConfig, TrainConfig, resolve_device

PAPER_TEST_SHARPE = 0.75  # Chen-Pelger-Zhu Table 1, GAN test SR (monthly)

# GANConfig fields that fix parameter SHAPES or change the deterministic
# eval-mode forward: members must agree on them to stack
_ARCHITECTURE_FIELDS = (
    "macro_feature_dim", "individual_feature_dim", "hidden_dim", "use_rnn",
    "num_units_rnn", "hidden_dim_moment", "num_condition_moment",
    "normalize_w",
)


def validate_stackable_configs(checkpoint_dirs: List[str]) -> GANConfig:
    """Check that every run dir's ``config.json`` shares one architecture,
    before any weights are read. Architecture mismatches raise a
    field-by-field ValueError naming the directories; other differences
    (dropout, loss shaping) are eval-inert and only warn. Returns the first
    config."""
    cfgs = [GANConfig.load(Path(d) / "config.json") for d in checkpoint_dirs]
    cfg0 = cfgs[0]
    for d, cfg in zip(checkpoint_dirs[1:], cfgs[1:]):
        diffs = [
            f"{f}: {getattr(cfg0, f)!r} (in {checkpoint_dirs[0]}) vs "
            f"{getattr(cfg, f)!r} (in {d})"
            for f in _ARCHITECTURE_FIELDS
            if getattr(cfg, f) != getattr(cfg0, f)
        ]
        if diffs:
            raise ValueError(
                "checkpoint architectures differ — ensemble members must "
                "share parameter shapes and the eval-mode forward to "
                "stack:\n  " + "\n  ".join(diffs))
        if cfg != cfg0:
            other = [f.name for f in dataclasses.fields(GANConfig)
                     if f.name not in _ARCHITECTURE_FIELDS
                     and getattr(cfg, f.name) != getattr(cfg0, f.name)]
            warnings.warn(
                f"checkpoint configs differ in non-architectural fields "
                f"{other} ({checkpoint_dirs[0]} vs {d}); stacking anyway — "
                "these do not affect deterministic evaluation", stacklevel=2)
    return cfg0


# what a corrupt or absent member checkpoint raises when it is read
_UNREADABLE = (OSError, ValueError, RuntimeError, EOFError,
               pickle.UnpicklingError)


def _no_usable(skipped: List[Dict[str, str]]) -> ValueError:
    return ValueError("no usable checkpoint dirs: " + "; ".join(
        f"{s['dir']}: {s['reason']}" for s in skipped))


def stack_checkpoints(
    checkpoint_dirs: List[str],
    which: str = "best_model_sharpe",
    device=None,
    allow_missing: bool = False,
    coverage_out: Optional[Dict] = None,
) -> Tuple[GANConfig, Dict[str, torch.Tensor]]:
    """Load K run dirs and stack their ``state_dict``s on a leading member
    axis: (config, {name: [K, ...] tensor on `device`}). `device` defaults
    to ``ExecutionConfig().device`` (the card; an error naming CUDA
    without one). The architectures are validated from the configs before
    any weights are read.

    `allow_missing` (quorum semantics): member dirs that are absent, whose
    config does not load, or whose checkpoint cannot be read are skipped,
    with one warning listing each and why; architecture mismatches still
    raise. `coverage_out`, when given, is filled with ``used`` and
    ``skipped`` (dir + reason)."""
    device = resolve_device(ExecutionConfig().device if device is None
                            else device)
    skipped: List[Dict[str, str]] = []
    present: List[str] = []
    for d in checkpoint_dirs:
        if allow_missing:
            cfg_path = Path(d) / "config.json"
            try:
                GANConfig.load(cfg_path)
            except Exception as e:  # noqa: BLE001 — absent, torn, invalid
                skipped.append({"dir": str(d), "reason": (
                    f"unusable config.json ({type(e).__name__}: {e})"
                    if cfg_path.exists() else "missing config.json")})
                continue
        present.append(d)
    if not present:
        raise _no_usable(skipped)
    cfg = validate_stackable_configs(present)
    sds, used = [], []
    for d in present:
        try:
            sds.append(load_checkpoint_dir(d, which)[1])
        except _UNREADABLE as e:
            if not allow_missing:
                raise
            skipped.append({"dir": str(d), "reason": str(e)})
            continue
        used.append(str(d))
    if not sds:
        raise _no_usable(skipped)
    if skipped:
        warnings.warn(
            f"skipping {len(skipped)} of {len(checkpoint_dirs)} ensemble "
            "member dirs:\n  " + "\n  ".join(
                f"{s['dir']}: {s['reason']}" for s in skipped), stacklevel=2)
    if coverage_out is not None:
        coverage_out["used"] = used
        coverage_out["skipped"] = skipped
    return cfg, stack_state_dicts(sds, device)


def _split_metrics(cfg: GANConfig, stacked, splits, exec_cfg, device):
    return {name: ensemble_metrics(cfg, stacked, ds.to_batch(device),
                                   exec_cfg)
            for name, ds in zip(("train", "valid", "test"), splits)}


def evaluate_ensemble(
    checkpoint_dirs: List[str],
    data_dir: str,
    exec_cfg: Optional[ExecutionConfig] = None,
    verbose: bool = True,
    quorum: Optional[int] = None,
) -> Dict[str, object]:
    """Train/valid/test ensemble Sharpe and the members' test Sharpes.

    `quorum`: proceed with at least that many loadable members, skipping
    absent or corrupt run dirs (listed in a warning, and in the summary's
    ``used_dirs`` / ``skipped_dirs``); None loads strictly."""
    exec_cfg = exec_cfg or ExecutionConfig()
    device = resolve_device(exec_cfg.device)
    coverage: Dict = {}
    cfg, stacked = stack_checkpoints(
        checkpoint_dirs, device=device, allow_missing=quorum is not None,
        coverage_out=coverage if quorum is not None else None)
    if quorum is not None and len(coverage["used"]) < quorum:
        raise ValueError(
            f"only {len(coverage['used'])} of {len(checkpoint_dirs)} "
            f"ensemble members loadable, quorum is {quorum}; skipped: "
            + "; ".join(f"{s['dir']}: {s['reason']}"
                        for s in coverage["skipped"]))
    # the chunked panel reader: bit for bit load_splits, and a rerun
    # memmaps the cached decode
    results = _split_metrics(cfg, stacked, load_splits_chunked(data_dir),
                             exec_cfg, device)
    n_members = next(iter(stacked.values())).shape[0]
    if verbose:
        _print_report(results, n_members)
    out = {
        "train_sharpe": float(results["train"]["ensemble_sharpe"]),
        "valid_sharpe": float(results["valid"]["ensemble_sharpe"]),
        "test_sharpe": float(results["test"]["ensemble_sharpe"]),
        "individual_sharpes": results["test"]["individual_sharpes"].tolist(),
        "device": str(device),
    }
    if quorum is not None:
        out["used_dirs"] = coverage["used"]
        out["skipped_dirs"] = coverage["skipped"]
    return out


def train_and_evaluate(
    data_dir: str,
    seeds: Sequence[int],
    tcfg: TrainConfig,
    exec_cfg: Optional[ExecutionConfig] = None,
    member_chunk: Optional[int] = None,
    save_dir: Optional[str] = None,
    verbose: bool = True,
) -> Dict[str, object]:
    """Train the ensemble of `seeds` (the paper's model, members stacked),
    evaluate it on every split, and with `save_dir` write one run dir per
    member plus ``ensemble_report.json``. Returns the report."""
    exec_cfg = exec_cfg or ExecutionConfig()
    device = resolve_device(exec_cfg.device)
    seeds = [int(s) for s in seeds]
    splits = load_splits_chunked(data_dir)
    cfg = GANConfig(macro_feature_dim=splits[0].macro_feature_dim,
                    individual_feature_dim=splits[0].individual_feature_dim)
    batches = [ds.to_batch(device) for ds in splits]
    stacked, _ = train_ensemble(cfg, *batches, seeds=seeds, tcfg=tcfg,
                                member_chunk=member_chunk,
                                exec_cfg=exec_cfg, verbose=verbose)
    results = _split_metrics(cfg, stacked, splits, exec_cfg, device)
    if verbose:
        _print_report(results, len(seeds))
    splits_ = ("train", "valid", "test")
    report = {
        "seeds": seeds,
        **{key: {s: float(results[s][key]) for s in splits_}
           for key in ("ensemble_sharpe", "explained_variation",
                       "cross_sectional_r2")},
        "individual_test_sharpes":
            results["test"]["individual_sharpes"].tolist(),
    }
    if save_dir:
        save = Path(save_dir)
        for seed, sd in zip(seeds, member_state_dicts(stacked)):
            mdir = save / f"seed_{seed}"
            mdir.mkdir(parents=True, exist_ok=True)
            cfg.save(mdir / "config.json")
            save_state_dict(mdir / "best_model_sharpe.pt", sd)
        write_verified(save / "ensemble_report.json",
                       json.dumps(report, indent=2).encode())
        if verbose:
            print(f"Saved {len(seeds)} member checkpoints to {save}",
                  flush=True)
    return report


def _print_report(results, n_models):
    indiv = results["test"]["individual_sharpes"]
    print("=" * 70)
    print(f"ENSEMBLE EVALUATION ({n_models} models, averaged weights)")
    print("=" * 70)
    print("\nIndividual model test Sharpes (paper convention, negated):")
    for i, s in enumerate(indiv):
        print(f"  Model {i+1}: {s:.4f}")
    print(f"  mean {indiv.mean():.4f}  std {indiv.std():.4f}")
    print("\nEnsemble (averaged weights):")
    for split in ("train", "valid", "test"):
        print(f"  {split:5s} Sharpe: "
              f"{float(results[split]['ensemble_sharpe']):.4f}")
    test = float(results["test"]["ensemble_sharpe"])
    print("\nRisk-premium metrics (paper Table 1 companions; per-stock OLS "
          "betas):")
    for split in ("train", "valid", "test"):
        print(f"  {split:5s} EV: "
              f"{float(results[split]['explained_variation']):7.4f}"
              f"   XS-R2: {float(results[split]['cross_sectional_r2']):7.4f}")
    print(f"\nPaper GAN test Sharpe: {PAPER_TEST_SHARPE}")
    print(f"Ours / paper: {test / PAPER_TEST_SHARPE:.1%}")
    print("=" * 70)


def add_execution_args(p: argparse.ArgumentParser) -> None:
    """--device / --compute_dtype / --kernel, shared by the CLIs."""
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="run on the CUDA device (default; an error without "
                        "one) or, explicitly, on the CPU")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("float32", "bfloat16"),
                   help="operand dtype of the fused FFN's products (f32 "
                        "accumulation always)")
    p.add_argument("--kernel", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="the CUDA kernels (auto: on a CUDA device) or, with "
                        "off, their plain PyTorch versions")


def execution_config(args) -> ExecutionConfig:
    """The CLIs' ExecutionConfig; exits with a message naming CUDA when
    --device cuda finds no CUDA device. The bf16 panel goes with bf16
    compute (the JAX CLIs' only configuration); ``--compute_dtype
    float32``, the comparison route, keeps the f32 panel."""
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    return ExecutionConfig(kernel=args.kernel,
                           compute_dtype=args.compute_dtype,
                           bf16_panel=args.compute_dtype == "bfloat16",
                           device=args.device)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate (or train) a model ensemble")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--checkpoint_dirs", type=str, nargs="+", default=None)
    p.add_argument("--quorum", type=int, default=None, metavar="Q",
                   help="with --checkpoint_dirs: evaluate with >= Q loadable "
                        "members, skipping absent or corrupt run dirs "
                        "(listed in a warning) instead of failing")
    p.add_argument("--train_seeds", type=int, nargs="+", default=None,
                   help="train the ensemble from these seeds, members "
                        "stacked (one kernel launch per pass for all)")
    p.add_argument("--epochs_unc", type=int, default=256)
    p.add_argument("--epochs_moment", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1024)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ignore_epoch", type=int, default=64)
    p.add_argument("--member_chunk", type=int, default=None,
                   help="train at most this many seeds at a time "
                        "(sequential chunks); the plain route "
                        "(kernel off) keeps [S, T, H, N] activations")
    p.add_argument("--save_dir", type=str, default=None,
                   help="with --train_seeds: write each member as a run dir "
                        "(seed_<s>/config.json + best_model_sharpe.pt) and "
                        "ensemble_report.json")
    add_execution_args(p)
    return p


def main(argv=None):
    p = build_arg_parser()
    args = p.parse_args(argv)
    if (args.checkpoint_dirs is None) == (args.train_seeds is None):
        p.error("pass exactly one of --checkpoint_dirs / --train_seeds")
    exec_cfg = execution_config(args)
    if args.checkpoint_dirs:
        evaluate_ensemble(args.checkpoint_dirs, args.data_dir,
                          exec_cfg=exec_cfg, quorum=args.quorum)
        return
    tcfg = TrainConfig(num_epochs_unc=args.epochs_unc,
                       num_epochs_moment=args.epochs_moment,
                       num_epochs=args.epochs, lr=args.lr,
                       ignore_epoch=args.ignore_epoch)
    train_and_evaluate(args.data_dir, args.train_seeds, tcfg, exec_cfg,
                       member_chunk=args.member_chunk,
                       save_dir=args.save_dir)


if __name__ == "__main__":
    main()
