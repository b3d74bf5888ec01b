"""Paper-style figures and the summary table (the reporting layer).

The counterpart of the JAX package's ``plots.py``: the reference's figures
(cumulative SDF return with split shading, training curves with phase
markers, individual-vs-ensemble Sharpe bars against the paper's 0.75 line,
monthly return histogram + time series, the summary-statistics table) and
the two model-health panels, which draw nothing (return None) on a history
without ``diag_*`` fields.

    python -m deeplearninginassetpricing_paperreplication_torch.plots \\
        --data_dir data/synthetic_data --checkpoint_dirs ckpt_s42 ckpt_s123 \\
        --output_dir plots [--device cpu]

The members are stacked once (``evaluate_ensemble.stack_checkpoints``: the
port's ``.pt`` run dirs and the JAX package's ``.msgpack`` ones alike) and
every figure evaluates them in one fused-FFN call per split, on the CUDA
device unless ``--device cpu`` is given. Dates come from the panel's own
YYYYMM ``date`` arrays. matplotlib is imported only where a figure is
drawn: importing this module and :func:`summary_statistics` need none, and
without it the CLI exits with a message naming it.
"""

from __future__ import annotations

import dataclasses
import sys
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .data.panel import PanelDataset
from .data.pipeline import load_splits_cached
from .evaluate_ensemble import (
    PAPER_TEST_SHARPE,
    add_execution_args,
    execution_config,
    stack_checkpoints,
)
from .parallel.ensemble import ensemble_metrics, member_weights
from .utils.config import ExecutionConfig, GANConfig, resolve_device


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "matplotlib is required for plotting (pip install matplotlib); "
            "summary_statistics needs none") from e
    plt.rcParams.update(
        {
            "figure.figsize": (10, 6),
            "font.size": 12,
            "axes.labelsize": 12,
            "axes.titlesize": 14,
            "legend.fontsize": 10,
            "lines.linewidth": 1.5,
        }
    )
    return plt


def _dates_from_panel(*datasets: PanelDataset) -> List[datetime]:
    """YYYYMM date arrays → datetimes. Panels without a real date column
    (the loader falls back to np.arange) get a synthetic monthly sequence
    starting 1967-03, the reference's convention (plots.py:43-53)."""
    out = []
    counter_year, counter_month = 1967, 3
    for ds in datasets:
        for ymm in np.asarray(ds.dates):
            ymm = int(ymm)
            year, month = ymm // 100, ymm % 100
            if year < 1000 or not 1 <= month <= 12:  # index fallback, not YYYYMM
                year, month = counter_year, counter_month
            out.append(datetime(year, month, 1))
            counter_month += 1
            if counter_month > 12:
                counter_month = 1
                counter_year += 1
    return out


@dataclasses.dataclass
class PlotContext:
    """Checkpoints + panel loaded ONCE and shared by every figure (the
    reference reloads models and data inside each plot function)."""

    cfg: GANConfig
    stacked: Mapping[str, torch.Tensor]
    exec_cfg: ExecutionConfig
    train: PanelDataset
    valid: PanelDataset
    test: PanelDataset

    @classmethod
    def load(cls, checkpoint_dirs: Sequence[str], data_dir: str,
             exec_cfg: Optional[ExecutionConfig] = None) -> "PlotContext":
        exec_cfg = exec_cfg or ExecutionConfig()
        device = resolve_device(exec_cfg.device)
        cfg, stacked = stack_checkpoints(list(checkpoint_dirs), device=device)
        # cache-aware: figures re-load the panel the training run decoded
        train, valid, test = load_splits_cached(data_dir)
        return cls(cfg, stacked, exec_cfg, train, valid, test)

    def _batch(self, ds: PanelDataset):
        return ds.to_batch(resolve_device(self.exec_cfg.device))

    def member_portfolio_returns(self, ds: PanelDataset) -> np.ndarray:
        """[S, T] per-member portfolio returns with normalized weights —
        the quantity the reference's figures average (plots.py:56-71)."""
        w = member_weights(self.cfg, self.stacked, self._batch(ds),
                           self.exec_cfg).cpu().numpy()
        mask = ds.mask.astype(np.float32)
        return (w * ds.returns[None] * mask[None]).sum(axis=2)

    def metrics(self, ds: PanelDataset) -> Dict[str, np.ndarray]:
        return ensemble_metrics(self.cfg, self.stacked, self._batch(ds),
                                self.exec_cfg)


def plot_cumulative_sdf(
    checkpoint_dirs: Sequence[str],
    data_dir: str,
    save_path: Optional[str] = None,
    ctx: Optional[PlotContext] = None,
    exec_cfg: Optional[ExecutionConfig] = None,
):
    """Cumulative SDF return across train/valid/test with shaded splits
    (reference plots.py:74-162). SDF return = NEGATED mean of the members'
    raw portfolio returns (the reference averages member returns here, with
    NO ensemble re-normalization — plots.py:118-123)."""
    plt = _plt()
    ctx = ctx or PlotContext.load(checkpoint_dirs, data_dir, exec_cfg)
    train, valid, test = ctx.train, ctx.valid, ctx.test

    sdf_ret = -np.concatenate(
        [ctx.member_portfolio_returns(ds).mean(axis=0) for ds in (train, valid, test)]
    )
    cumulative = np.cumprod(1.0 + sdf_ret)
    dates = _dates_from_panel(train, valid, test)

    fig, ax = plt.subplots(figsize=(12, 6))
    ax.plot(dates, cumulative, "b-", label="GAN SDF")
    t_end = dates[train.T - 1]
    v_end = dates[train.T + valid.T - 1]
    ax.axvspan(dates[0], t_end, alpha=0.1, color="blue", label="Train")
    ax.axvspan(t_end, v_end, alpha=0.1, color="green", label="Valid")
    ax.axvspan(v_end, dates[-1], alpha=0.1, color="red", label="Test")
    ax.set_xlabel("Date")
    ax.set_ylabel("Cumulative Return")
    ax.set_title("Cumulative SDF Returns (Ensemble)")
    ax.legend(loc="upper left")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig, ax


def plot_training_curves(checkpoint_dir: str, save_path: Optional[str] = None):
    """Loss (log-scale) + Sharpe curves with phase-boundary markers
    (reference plots.py:165-214; Sharpe negated for the paper convention)."""
    plt = _plt()
    hist = np.load(Path(checkpoint_dir) / "history.npz", allow_pickle=True)
    epochs = np.arange(1, len(hist["train_loss"]) + 1)
    phases = np.asarray(hist["phase"])
    # phase boundary: last 'unc' row (phase 2 adds no rows)
    n_unc = int((phases == "unc").sum())

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    axes[0].plot(epochs, hist["train_loss"], "b-", alpha=0.8, label="Train")
    axes[0].plot(epochs, hist["valid_loss"], "g-", alpha=0.8, label="Valid")
    axes[0].set_yscale("log")
    axes[0].set_xlabel("Epoch")
    axes[0].set_ylabel("Loss")
    axes[0].set_title("Training Loss")

    for key, style, label in (
        ("train_sharpe", "b-", "Train"),
        ("valid_sharpe", "g-", "Valid"),
        ("test_sharpe", "r-", "Test"),
    ):
        axes[1].plot(epochs, -np.asarray(hist[key]), style, alpha=0.8, label=label)
    axes[1].set_xlabel("Epoch")
    axes[1].set_ylabel("Sharpe Ratio (Monthly)")
    axes[1].set_title("Sharpe Ratio During Training")

    for ax in axes:
        if 0 < n_unc < len(epochs):
            ax.axvline(n_unc, color="gray", linestyle="--", alpha=0.5)
        ax.legend()
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig, axes


def plot_moment_violations(checkpoint_dir: str, save_path: Optional[str] = None):
    """Per-moment conditional violation norms over training — the
    model-health view of the no-arbitrage claim ``E[h_j · w·R · M] = 0``
    (one curve per h_j plus the max and the unconditional norm), from the
    ``diag_*`` history fields a ``--diag_stride`` run records. Run dirs
    trained without them skip gracefully: returns None, draws
    nothing."""
    hist = np.load(Path(checkpoint_dir) / "history.npz", allow_pickle=True)
    if "diag_moment_violations" not in hist.files:
        print(f"Skipping moment-violation panel: {checkpoint_dir} has no "
              "diag_* history fields (train with --diag_stride)")
        return None
    plt = _plt()
    mv = np.asarray(hist["diag_moment_violations"])  # [E, K]
    # the explicit stride sentinel — NOT a value field, so degenerate
    # (all-NaN) computed epochs still plot instead of vanishing.
    # x positions are HISTORY rows (phases 1+3; phase 2 records no rows),
    # the same convention as plot_training_curves — the dashed line marks
    # the phase-1/3 boundary like it does there
    computed = np.nonzero(np.asarray(hist["diag_computed"]))[0]
    n_unc = int((np.asarray(hist["phase"]) == "unc").sum())
    if computed.size == 0:
        print(f"Skipping moment-violation panel: {checkpoint_dir} recorded "
              "no computed diagnostic epochs")
        return None
    epochs = computed + 1

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    for k in range(mv.shape[1]):
        axes[0].plot(epochs, mv[computed, k], alpha=0.6, linewidth=1,
                     label=f"h{k}" if mv.shape[1] <= 8 else None)
    axes[0].plot(epochs, np.asarray(hist["diag_moment_violation_max"])[computed],
                 "k-", linewidth=2, label="max")
    axes[0].plot(epochs, np.asarray(hist["diag_unc_violation"])[computed],
                 "k--", linewidth=1.5, label="unconditional")
    axes[0].set_yscale("log")
    axes[0].set_xlabel("Epoch")
    axes[0].set_ylabel("Violation Norm")
    axes[0].set_title("Per-Moment Conditional Violations")
    if mv.shape[1] <= 8:
        axes[0].legend(fontsize=8, ncol=2)

    axes[1].plot(epochs, np.asarray(hist["diag_adv_gap"])[computed], "b-",
                 label="cond − unc loss")
    axes[1].axhline(0, color="black", alpha=0.5)
    axes[1].set_xlabel("Epoch")
    axes[1].set_ylabel("Adversarial Gap")
    axes[1].set_title("Generator vs Discriminator Gap")
    axes[1].legend()
    for ax in axes:
        if 0 < n_unc < mv.shape[0]:
            ax.axvline(n_unc, color="gray", linestyle="--", alpha=0.5)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig, axes


def plot_weight_concentration(checkpoint_dir: str,
                              save_path: Optional[str] = None):
    """Portfolio concentration/churn during training: weight HHI and
    max |w| (left), short fraction and month-to-month turnover (right),
    from the ``diag_*`` history fields. Skips gracefully (returns None)
    on run dirs without them."""
    hist = np.load(Path(checkpoint_dir) / "history.npz", allow_pickle=True)
    if "diag_weight_hhi" not in hist.files:
        print(f"Skipping weight-concentration panel: {checkpoint_dir} has "
              "no diag_* history fields (train with --diag_stride)")
        return None
    plt = _plt()
    # history-row x positions + phase-boundary marker: see
    # plot_moment_violations
    computed = np.nonzero(np.asarray(hist["diag_computed"]))[0]
    n_unc = int((np.asarray(hist["phase"]) == "unc").sum())
    n_rows = np.asarray(hist["diag_computed"]).shape[0]
    if computed.size == 0:
        print(f"Skipping weight-concentration panel: {checkpoint_dir} "
              "recorded no computed diagnostic epochs")
        return None
    epochs = computed + 1

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    ax2 = axes[0].twinx()
    axes[0].plot(epochs, np.asarray(hist["diag_weight_hhi"])[computed],
                 "b-", label="HHI")
    ax2.plot(epochs, np.asarray(hist["diag_weight_max_abs"])[computed],
             "r-", alpha=0.7, label="max |w|")
    axes[0].set_xlabel("Epoch")
    axes[0].set_ylabel("HHI (Σ w²)", color="b")
    ax2.set_ylabel("max |w|", color="r")
    axes[0].set_title("Weight Concentration")

    axes[1].plot(epochs, np.asarray(hist["diag_short_fraction"])[computed],
                 "g-", label="short fraction")
    axes[1].plot(epochs, np.asarray(hist["diag_turnover"])[computed],
                 "m-", label="turnover")
    axes[1].set_xlabel("Epoch")
    axes[1].set_ylabel("Fraction of Unit Gross Book")
    axes[1].set_title("Short Fraction & Turnover")
    axes[1].legend()
    for ax in axes:
        if 0 < n_unc < n_rows:
            ax.axvline(n_unc, color="gray", linestyle="--", alpha=0.5)
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig, axes


def plot_sharpe_comparison(
    checkpoint_dirs: Sequence[str],
    data_dir: str,
    save_path: Optional[str] = None,
    ctx: Optional[PlotContext] = None,
    exec_cfg: Optional[ExecutionConfig] = None,
):
    """Per-model vs mean vs ensemble test-Sharpe bars against the paper's
    0.75 line (reference plots.py:217-298)."""
    plt = _plt()
    ctx = ctx or PlotContext.load(checkpoint_dirs, data_dir, exec_cfg)
    m = ctx.metrics(ctx.test)
    indiv = m["individual_sharpes"]
    values = list(indiv) + [float(indiv.mean()), float(m["ensemble_sharpe"])]
    labels = [f"Model {i+1}" for i in range(len(indiv))] + ["Mean", "Ensemble"]

    fig, ax = plt.subplots(figsize=(12, 6))
    colors = ["steelblue"] * len(indiv) + ["forestgreen", "darkred"]
    bars = ax.bar(np.arange(len(values)), values, color=colors, alpha=0.8,
                  edgecolor="black")
    ax.axhline(PAPER_TEST_SHARPE, color="red", linestyle="--", linewidth=2,
               label=f"Paper ({PAPER_TEST_SHARPE})")
    ax.set_xticks(np.arange(len(values)))
    ax.set_xticklabels(labels, rotation=45, ha="right")
    ax.set_ylabel("Test Sharpe Ratio (Monthly)")
    ax.set_title("Individual vs Ensemble Sharpe Ratio")
    ax.legend()
    ax.grid(True, alpha=0.3, axis="y")
    for bar, val in zip(bars, values):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height() + 0.01,
                f"{val:.3f}", ha="center", va="bottom", fontsize=9)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig, ax


def plot_monthly_returns(
    checkpoint_dirs: Sequence[str],
    data_dir: str,
    save_path: Optional[str] = None,
    ctx: Optional[PlotContext] = None,
    exec_cfg: Optional[ExecutionConfig] = None,
):
    """Histogram + time series of monthly test SDF returns
    (reference plots.py:301-365; mean of raw member returns, negated)."""
    plt = _plt()
    ctx = ctx or PlotContext.load(checkpoint_dirs, data_dir, exec_cfg)
    test = ctx.test
    sdf_ret = -ctx.member_portfolio_returns(test).mean(axis=0)
    dates = _dates_from_panel(test)

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    axes[0].hist(sdf_ret, bins=30, density=True, alpha=0.7,
                 color="steelblue", edgecolor="black")
    axes[0].axvline(sdf_ret.mean(), color="red", linestyle="--",
                    label=f"Mean: {sdf_ret.mean():.4f}")
    axes[0].axvline(0, color="black", alpha=0.5)
    axes[0].set_xlabel("Monthly Return")
    axes[0].set_ylabel("Density")
    axes[0].set_title("Distribution of Monthly SDF Returns (Test)")
    axes[0].legend()

    axes[1].plot(dates, sdf_ret, "b-", alpha=0.7, linewidth=1)
    axes[1].axhline(0, color="black", alpha=0.5)
    axes[1].fill_between(dates, sdf_ret, 0, where=sdf_ret > 0, alpha=0.3, color="green")
    axes[1].fill_between(dates, sdf_ret, 0, where=sdf_ret < 0, alpha=0.3, color="red")
    axes[1].set_xlabel("Date")
    axes[1].set_ylabel("Monthly Return")
    axes[1].set_title("Monthly SDF Returns Over Time (Test)")
    for ax in axes:
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig, axes


def summary_statistics(
    checkpoint_dirs: Sequence[str],
    data_dir: str,
    ctx: Optional[PlotContext] = None,
    exec_cfg: Optional[ExecutionConfig] = None,
) -> Dict[str, float]:
    """The summary table's numbers (reference plots.py:368-427): moments,
    monthly+annual Sharpe, cumulative return, max drawdown of the negated
    ensemble (re-normalized averaged-weight) test return."""
    ctx = ctx or PlotContext.load(checkpoint_dirs, data_dir, exec_cfg)
    m = ctx.metrics(ctx.test)
    sdf_ret = -m["ensemble_port_returns"]
    mean, std = sdf_ret.mean(), sdf_ret.std()
    cumulative = np.cumprod(1 + sdf_ret)
    running_max = np.maximum.accumulate(cumulative)
    return {
        "mean_monthly": float(mean),
        "std_monthly": float(std),
        "sharpe_monthly": float(mean / std),
        "sharpe_annual": float(mean / std * np.sqrt(12)),
        "min": float(sdf_ret.min()),
        "max": float(sdf_ret.max()),
        "skewness": float(((sdf_ret - mean) ** 3).mean() / std**3),
        "kurtosis": float(((sdf_ret - mean) ** 4).mean() / std**4 - 3),
        "cumulative_return": float(cumulative[-1] - 1),
        "max_drawdown": float(((cumulative - running_max) / running_max).min()),
        "sharpe_vs_paper": float(mean / std / PAPER_TEST_SHARPE),
        # paper Table-1 companions (EV / XS-R²), from the ensemble SDF factor
        "explained_variation": float(m["explained_variation"]),
        "cross_sectional_r2": float(m["cross_sectional_r2"]),
    }


def plot_summary_statistics(
    checkpoint_dirs: Sequence[str],
    data_dir: str,
    save_path: Optional[str] = None,
    ctx: Optional[PlotContext] = None,
    exec_cfg: Optional[ExecutionConfig] = None,
):
    """Summary-statistics table rendered as a figure (plots.py:368-472)."""
    plt = _plt()
    stats = summary_statistics(checkpoint_dirs, data_dir, ctx=ctx,
                               exec_cfg=exec_cfg)
    rows = [
        ["Mean (Monthly)", f"{stats['mean_monthly']:.4f}"],
        ["Std (Monthly)", f"{stats['std_monthly']:.4f}"],
        ["Sharpe (Monthly)", f"{stats['sharpe_monthly']:.4f}"],
        ["Sharpe (Annual)", f"{stats['sharpe_annual']:.2f}"],
        ["Min", f"{stats['min']:.4f}"],
        ["Max", f"{stats['max']:.4f}"],
        ["Skewness", f"{stats['skewness']:.2f}"],
        ["Kurtosis", f"{stats['kurtosis']:.2f}"],
        ["Cumulative Return", f"{stats['cumulative_return']:.2%}"],
        ["Max Drawdown", f"{stats['max_drawdown']:.2%}"],
        ["Explained Variation", f"{stats['explained_variation']:.4f}"],
        ["Cross-Sectional R2", f"{stats['cross_sectional_r2']:.4f}"],
        ["", ""],
        ["Paper Sharpe (Monthly)", f"{PAPER_TEST_SHARPE}"],
        ["Our Sharpe / Paper", f"{stats['sharpe_vs_paper']:.1%}"],
    ]
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.axis("off")
    table = ax.table(cellText=rows, colLabels=["Metric", "Value"],
                     loc="center", cellLoc="center", colWidths=[0.4, 0.3])
    table.auto_set_font_size(False)
    table.set_fontsize(12)
    table.scale(1.2, 1.8)
    for i in range(2):
        table[(0, i)].set_facecolor("#4472C4")
        table[(0, i)].set_text_props(color="white", fontweight="bold")
    ax.set_title("Summary Statistics — Test Period", fontsize=14,
                 fontweight="bold", pad=20)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig, ax


def generate_all_plots(
    checkpoint_dirs: Sequence[str],
    data_dir: str,
    output_dir: str = "./plots",
    exec_cfg: Optional[ExecutionConfig] = None,
) -> List[str]:
    """Every figure into `output_dir`: the reference's five, then the two
    model-health panels where the first run dir's history has ``diag_*``
    fields. Returns the paths written."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    plt = _plt()
    written = []
    ctx = PlotContext.load(checkpoint_dirs, data_dir, exec_cfg)  # load once
    jobs = [
        ("cumulative_sdf.png", lambda p: plot_cumulative_sdf(
            checkpoint_dirs, data_dir, p, ctx=ctx)),
        ("training_curves.png", lambda p: plot_training_curves(
            checkpoint_dirs[0], p)),
        ("sharpe_comparison.png", lambda p: plot_sharpe_comparison(
            checkpoint_dirs, data_dir, p, ctx=ctx)),
        ("monthly_returns.png", lambda p: plot_monthly_returns(
            checkpoint_dirs, data_dir, p, ctx=ctx)),
        ("summary_statistics.png", lambda p: plot_summary_statistics(
            checkpoint_dirs, data_dir, p, ctx=ctx)),
        # model-health panels: these skip (return None, write nothing) on
        # run dirs whose history.npz has no diag_* fields
        ("moment_violations.png", lambda p: plot_moment_violations(
            checkpoint_dirs[0], p)),
        ("weight_concentration.png", lambda p: plot_weight_concentration(
            checkpoint_dirs[0], p)),
    ]
    for name, fn in jobs:
        path = str(out / name)
        result = fn(path)
        plt.close("all")
        if result is None:
            continue
        written.append(path)
        print(f"Saved: {path}")
    return written


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generate paper-style figures")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--checkpoint_dirs", type=str, nargs="+", required=True)
    p.add_argument("--output_dir", type=str, default="./plots")
    add_execution_args(p)
    args = p.parse_args(argv)
    try:
        _plt()
    except ImportError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None
    generate_all_plots(args.checkpoint_dirs, args.data_dir, args.output_dir,
                       execution_config(args))


if __name__ == "__main__":
    main()
