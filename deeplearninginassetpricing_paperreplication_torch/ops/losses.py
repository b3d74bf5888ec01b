"""Moment-condition losses as masked reductions over the [T, N] panel.

The JAX package's ``ops/losses.py`` in PyTorch, with its semantics: the
ragged-panel denominators are the per-period valid counts N_t (clamped to
≥ 1) and the per-asset valid lengths T_i (clamped to ≥ 1); ``n_assets`` is
the true asset count when the stock axis is padded, so padded all-masked
columns change nothing.

Notation: weights w [T, N], returns R [T, N], mask m [T, N] (float 0/1),
moments h [K, T, N]. SDF M_t = 1 + F_t with F_t the (optionally N̄/N_t
weighted) aggregate portfolio return.

Every function also takes the weights (and moments) with a leading member
axis, w [S, T, N] and h [S, K, T, N] against the shared R and m [T, N], and
then returns one loss (and one F [S, T]) per member: the reductions run over
the period and stock axes counted from the end.

Under a stock shard (``shard``, a ``parallel.collectives.StockShard`` beyond
one rank) each rank holds its own stocks' columns, and every sum over the
stock axis goes through ``stock_sum``: the weighted returns and N_t of F,
the asset means of both losses (over the true ``n_assets``, the shard's
global count when the batch carries none) and the residual loss's sums.
The sums over periods (T_i) stay local. Without a shard, or at world size
1, every function computes what it did before, op for op.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.collectives import StockShard, is_sharded, stock_sum


def portfolio_returns(weights: torch.Tensor, returns: torch.Tensor,
                      mask: torch.Tensor, weighted: bool = True,
                      shard: Optional[StockShard] = None) -> torch.Tensor:
    """F_t = Σ_i w·R·m, scaled per period by N̄/N_t when `weighted`."""
    weighted_returns = stock_sum(weights * returns * mask, -1, shard)
    if weighted:
        n_per_period = stock_sum(mask, -1, shard).clamp_min(1)  # [T]
        return weighted_returns / n_per_period * n_per_period.mean()
    return weighted_returns


def asset_count(n_assets, shard: Optional[StockShard]):
    """The count an asset mean divides by: the batch's true ``n_assets``,
    else under a shard its global stock count; None is the local mean."""
    if n_assets is None and is_sharded(shard):
        return shard.n_global
    return n_assets


def unconditional_loss(weights: torch.Tensor, returns: torch.Tensor,
                       mask: torch.Tensor, weighted: bool = True,
                       F: Optional[torch.Tensor] = None,
                       n_assets=None, shard: Optional[StockShard] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E_i[(Σ_t R·m·M / T_i)²] with M = 1 + F. Returns (loss, F [T])."""
    if F is None:
        F = portfolio_returns(weights, returns, mask, weighted, shard)
    sdf = 1.0 + F
    t_per_asset = mask.sum(dim=-2).clamp_min(1)  # [N]
    empirical_mean = ((returns * mask * sdf[..., None]).sum(dim=-2)
                      / t_per_asset)
    n_assets = asset_count(n_assets, shard)
    if n_assets is None:
        return (empirical_mean ** 2).mean(dim=-1), F
    return stock_sum(empirical_mean ** 2, -1, shard) / n_assets, F


def conditional_loss(weights: torch.Tensor, returns: torch.Tensor,
                     mask: torch.Tensor, moments: torch.Tensor,
                     weighted: bool = True, F: Optional[torch.Tensor] = None,
                     n_assets=None, shard: Optional[StockShard] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mean_k mean_i (Σ_t h_k·R·m·M / T_i)², one einsum over the moments.
    Returns (loss, F [T])."""
    if F is None:
        F = portfolio_returns(weights, returns, mask, weighted, shard)
    return em_loss(moment_means(returns, mask, moments, F), n_assets,
                   shard), F


def moment_means(returns: torch.Tensor, mask: torch.Tensor,
                 moments: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """The empirical moment means em [..., K, N] = Σ_t h·R·m·(1+F) / T_i of
    the moments h [..., K, T, N], one einsum."""
    t_per_asset = mask.sum(dim=-2).clamp_min(1)  # [N]
    x = returns * mask * (1.0 + F)[..., None]  # [..., T, N]
    return torch.einsum("...ktn,...tn->...kn", moments, x) / t_per_asset


def em_loss(em: torch.Tensor, n_assets=None,
            shard: Optional[StockShard] = None) -> torch.Tensor:
    """mean_k mean_i em² of the empirical moment means em [..., K, N]: the
    conditional loss, whichever route formed em. ``n_assets`` (the true
    asset count under stock padding) divides in place of N."""
    n_assets = asset_count(n_assets, shard)
    if n_assets is None:
        return (em ** 2).mean(dim=(-2, -1))
    if is_sharded(shard):
        return (stock_sum((em ** 2).sum(dim=-2), -1, shard)
                / (em.shape[-2] * n_assets))
    return (em ** 2).sum(dim=(-2, -1)) / (em.shape[-2] * n_assets)


def residual_loss(weights: torch.Tensor, returns: torch.Tensor,
                  mask: torch.Tensor,
                  shard: Optional[StockShard] = None) -> torch.Tensor:
    """E[‖R − proj_w R‖²] / E[‖R‖²], vectorized over periods.

    A period joins the R² average iff it has ≥ 2 valid stocks, and the
    residual average iff also w·w > 1e-8 there. Returns 0 when no period
    contributes a residual."""
    count = stock_sum(mask, -1, shard)  # [T]
    safe_count = count.clamp_min(1)
    has_stocks = count >= 2
    ww = stock_sum(weights * weights * mask, -1, shard)
    rw = stock_sum(returns * weights * mask, -1, shard)
    coef = rw / torch.where(ww > 1e-8, ww, torch.ones_like(ww))
    resid = (returns - coef[..., None] * weights) * mask
    resid_sq = stock_sum(resid ** 2, -1, shard) / safe_count
    r_sq = stock_sum(returns ** 2 * mask, -1, shard) / safe_count
    resid_contrib = has_stocks & (ww > 1e-8)
    n_resid = resid_contrib.sum(dim=-1)
    n_rsq = has_stocks.sum(dim=-1)
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    resid_mean = torch.where(
        n_resid > 0,
        (resid_sq * resid_contrib).sum(dim=-1) / n_resid.clamp_min(1), zero)
    rsq_mean = torch.where(
        n_rsq > 0, (r_sq * has_stocks).sum(dim=-1) / n_rsq.clamp_min(1), zero)
    return torch.where(n_resid > 0, resid_mean / rsq_mean.clamp_min(1e-8),
                       zero)
