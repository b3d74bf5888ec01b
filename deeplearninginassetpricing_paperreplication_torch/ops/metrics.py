"""Portfolio metrics: Sharpe, max drawdown, weight normalization, and the
paper's Table-1 companions (EV, cross-sectional R²).

The JAX package's ``ops/metrics.py`` in PyTorch, with its conventions:
Sharpe is monthly (not annualized); training uses ddof=1 (torch ``std``)
and the ensemble evaluator ddof=0 (numpy ``std``), picked with ``ddof``.
EV and XS-R² use the per-stock unconditional OLS beta of R_i on the SDF
factor F over the stock's valid months, masked-panel exact. ``sharpe`` and
``sharpe_monitor`` reduce over the last (period) axis, so a member-stacked
[S, T] series gives one Sharpe per member.

Under a stock shard (``shard``: ``parallel.collectives.StockShard``) the
sums over stocks of the weight normalization, EV and XS-R² go through
``stock_sum``; the per-stock betas are local to their stock.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.collectives import StockShard, is_sharded, stock_sum


def sharpe(returns: torch.Tensor, ddof: int = 1) -> torch.Tensor:
    """Monthly Sharpe mean/std over the last axis; 0 when std < 1e-8."""
    std = returns.std(dim=-1, correction=ddof)
    return torch.where(std < 1e-8, torch.zeros_like(std),
                       returns.mean(dim=-1) / std)


def sharpe_monitor(returns: torch.Tensor) -> torch.Tensor:
    """The in-forward monitoring Sharpe: mean / (std_ddof1 + 1e-8), over
    the last axis."""
    return returns.mean(dim=-1) / (returns.std(dim=-1, correction=1) + 1e-8)


def max_drawdown(returns) -> float:
    """Max drawdown of the cumulative-product wealth curve (host NumPy)."""
    cumulative = np.cumprod(1.0 + np.asarray(returns))
    running_max = np.maximum.accumulate(cumulative)
    return float(((cumulative - running_max) / running_max).min())


def normalize_weights_abs(weights: torch.Tensor, mask: torch.Tensor,
                          shard: Optional[StockShard] = None
                          ) -> torch.Tensor:
    """Per-period scaling so Σ_i |w·m| = 1 (weights already masked); the
    abs-sum is clamped to 1e-8."""
    abs_sum = stock_sum(weights.abs() * mask, -1, shard,
                        keepdim=True).clamp_min(1e-8)
    return weights / abs_sum


def factor_betas(returns: torch.Tensor, factor: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Per-stock OLS slope β_i of R_it on F_t over stock i's valid months:
    returns/mask [T, N], factor [T] → β [N] (0 without variance)."""
    t_i = mask.sum(dim=0).clamp_min(1)
    rbar = (returns * mask).sum(dim=0) / t_i
    fbar = (factor[:, None] * mask).sum(dim=0) / t_i
    f_dev = (factor[:, None] - fbar) * mask
    cov = (f_dev * (returns - rbar)).sum(dim=0) / t_i
    var = (f_dev ** 2).sum(dim=0) / t_i
    return torch.where(var > 1e-12, cov / var.clamp_min(1e-12),
                       torch.zeros_like(var))


def _total(x: torch.Tensor, shard: Optional[StockShard]) -> torch.Tensor:
    """Σ of a [T, N] panel or an [N] vector: the one full reduction, or
    per stock and then over every rank's stocks under a shard."""
    if is_sharded(shard):
        return stock_sum(x.sum(dim=0) if x.dim() == 2 else x, 0, shard)
    return x.sum()


def explained_variation(returns: torch.Tensor, factor: torch.Tensor,
                        mask: torch.Tensor, betas: torch.Tensor = None,
                        shard: Optional[StockShard] = None) -> torch.Tensor:
    """EV = 1 − Σ m·ε² / Σ m·R², ε = R − β_i·F_t."""
    if betas is None:
        betas = factor_betas(returns, factor, mask)
    eps = (returns - betas[None, :] * factor[:, None]) * mask
    total = _total(returns ** 2 * mask, shard).clamp_min(1e-12)
    return 1.0 - _total(eps ** 2, shard) / total


def cross_sectional_r2(returns: torch.Tensor, factor: torch.Tensor,
                       mask: torch.Tensor, betas: torch.Tensor = None,
                       min_obs: int = 1,
                       shard: Optional[StockShard] = None) -> torch.Tensor:
    """XS-R² = 1 − Σ_i T_i·ē_i² / Σ_i T_i·R̄_i² over stocks with ≥ min_obs
    valid months, weighted by their observation counts T_i."""
    if betas is None:
        betas = factor_betas(returns, factor, mask)
    t_i = mask.sum(dim=0)
    keep = (t_i >= min_obs).to(returns.dtype)
    safe_t = t_i.clamp_min(1)
    eps = (returns - betas[None, :] * factor[:, None]) * mask
    ebar = eps.sum(dim=0) / safe_t
    rbar = (returns * mask).sum(dim=0) / safe_t
    num = _total(t_i * ebar ** 2 * keep, shard)
    den = _total(t_i * rbar ** 2 * keep, shard).clamp_min(1e-12)
    return 1.0 - num / den
