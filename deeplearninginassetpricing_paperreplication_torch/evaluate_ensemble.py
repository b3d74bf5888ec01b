"""Ensemble evaluation CLI: the weight-averaged ensemble of K run dirs.

    python -m deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \\
        --data_dir data/synthetic_data --checkpoint_dirs ckpt_s42 ckpt_s123 ...

The counterpart of the JAX package's ``evaluate_ensemble.py`` in its
``--checkpoint_dirs`` mode: the K members are stacked on a leading axis and
evaluated together (one fused-FFN launch per split). It runs on the CUDA
device unless ``--device cpu`` is given. Training an ensemble from seeds
(``--train_seeds``) is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .data.panel import load_splits
from .parallel.ensemble import ensemble_metrics, stack_state_dicts
from .training.checkpoint import load_checkpoint_dir
from .utils.config import ExecutionConfig, GANConfig, resolve_device

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


def stack_checkpoints(
    checkpoint_dirs: List[str],
    which: str = "best_model_sharpe",
    device="cpu",
) -> Tuple[GANConfig, Dict[str, torch.Tensor]]:
    """Load K run dirs and stack their ``state_dict``s on a leading member
    axis: (config, {name: [K, ...] tensor on `device`}). The architectures
    are validated from the configs before any weights are read."""
    cfg = validate_stackable_configs(checkpoint_dirs)
    sds = [load_checkpoint_dir(d, which)[1] for d in checkpoint_dirs]
    return cfg, stack_state_dicts(sds, device)


def evaluate_ensemble(
    checkpoint_dirs: List[str],
    data_dir: str,
    exec_cfg: Optional[ExecutionConfig] = None,
    verbose: bool = True,
) -> Dict[str, object]:
    """Train/valid/test ensemble Sharpe and the members' test Sharpes."""
    exec_cfg = exec_cfg or ExecutionConfig()
    device = resolve_device(exec_cfg.device)
    cfg, stacked = stack_checkpoints(checkpoint_dirs, device=device)
    splits = dict(zip(("train", "valid", "test"), load_splits(data_dir)))
    results = {name: ensemble_metrics(cfg, stacked, ds.to_batch(device),
                                      exec_cfg)
               for name, ds in splits.items()}
    if verbose:
        _print_report(results, len(checkpoint_dirs))
    return {
        "train_sharpe": float(results["train"]["ensemble_sharpe"]),
        "valid_sharpe": float(results["valid"]["ensemble_sharpe"]),
        "test_sharpe": float(results["test"]["ensemble_sharpe"]),
        "individual_sharpes": results["test"]["individual_sharpes"].tolist(),
        "device": str(device),
    }


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
    """--device / --compute_dtype, shared by the CLIs."""
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="run on the CUDA device (default; an error without "
                        "one) or, explicitly, on the CPU")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("float32", "bfloat16"),
                   help="operand dtype of the fused FFN's products (f32 "
                        "accumulation always)")


def execution_config(args) -> ExecutionConfig:
    """The CLIs' ExecutionConfig; exits with a message naming CUDA when
    --device cuda finds no CUDA device."""
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    return ExecutionConfig(kernel=getattr(args, "kernel", "auto"),
                           compute_dtype=args.compute_dtype,
                           device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a model ensemble")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--checkpoint_dirs", type=str, nargs="+", required=True)
    add_execution_args(p)
    args = p.parse_args(argv)
    evaluate_ensemble(args.checkpoint_dirs, args.data_dir,
                      exec_cfg=execution_config(args))


if __name__ == "__main__":
    main()
