"""Model-health diagnostics: the moment-condition residuals as observables.

The counterpart of the JAX package's ``ops/diagnostics.py``. The losses in
:mod:`ops.losses` form every residual the paper's no-arbitrage claim rests
on (``E[h_j · w·R · M] = 0`` per moment function h_j, Chen–Pelger–Zhu JFE
2024); training collapses them into one scalar. These functions keep the
structure: per-moment-function conditional violation norms (one per h_j),
the unconditional pricing-error norm, SDF series statistics, portfolio
concentration and turnover, and the generator-vs-discriminator gap.

Every function is **member-stacked**: weights [S, T, N], moments
[S, K, T, N], F [S, T] against the shared returns and mask [T, N], and every
output carries a leading [S] (``moment_violations`` [S, K]). One call then
serves the trainer (S = 1) and the promotion gate (S = 9), where the JAX
package vmaps. The ragged-panel denominators are those of
:mod:`ops.losses` (T_i clamped to ≥ 1, ``n_assets`` under stock padding),
so ``mean_k violations[k]² == loss_cond`` to f32 ulps.

:func:`diagnostics_members` runs the eval forward through
``GAN.member_terms``: with the default moment net and macro data, the
empirical moment means em [S, K, N] come from the fused conditional-EM (on
the card, one ``cond_em_fwd`` launch beside the one ``sdf_ffn_fwd``) and h
never materializes; the violation norms are ``sqrt(mean_n em²)``, the
number the JAX package gets from h. The JAX ``strided_diagnostics`` (an
XLA ``lax.cond``) is a plain ``epoch % stride`` test in the trainer.

Under a stock shard (``shard``, ``gan.exec_cfg.shard`` in
:func:`diagnostics_members`) every sum over stocks goes through
``stock_sum`` and the largest weight through ``stock_amax``: each rank
reports the whole panel's diagnostics.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..parallel.collectives import StockShard, stock_amax, stock_sum
from .losses import (asset_count, em_loss, moment_means, portfolio_returns,
                     unconditional_loss)
from .metrics import normalize_weights_abs

# the scalar diagnostic keys, in the JAX package's order (history.npz fields
# are 'diag_' + key; 'moment_violations' is the one [K]-vector companion).
# 'computed' is the stride sentinel: 1 on epochs the diagnostics ran, 0 on
# the zero-filled off-stride epochs
SCALAR_KEYS = (
    "computed",
    "moment_violation_max",
    "unc_violation",
    "sdf_mean",
    "sdf_vol",
    "sdf_min",
    "sdf_finite_frac",
    "weight_hhi",
    "weight_max_abs",
    "short_fraction",
    "turnover",
    "adv_gap",
    "loss_unc",
    "loss_cond",
)

Diagnostics = Dict[str, torch.Tensor]


def em_violations(em: torch.Tensor, n_assets=None,
                  shard: Optional[StockShard] = None) -> torch.Tensor:
    """v_k = sqrt(mean_i em_k²) [S, K] (the sum over the true ``n_assets``
    under stock padding), so ``mean_k v_k² == em_loss(em)``."""
    n_assets = asset_count(n_assets, shard)
    if n_assets is None:
        return torch.sqrt((em ** 2).mean(dim=-1))
    return torch.sqrt(stock_sum(em ** 2, -1, shard) / n_assets)


def moment_violations(weights: torch.Tensor, returns: torch.Tensor,
                      mask: torch.Tensor, moments: torch.Tensor,
                      weighted: bool = True, F: Optional[torch.Tensor] = None,
                      n_assets=None, shard: Optional[StockShard] = None
                      ) -> torch.Tensor:
    """Per-moment-function conditional violation norms [S, K]:

        v_k = sqrt( mean_i ( Σ_t h_k·R·m·M / T_i )² )

    the square root of each h_k's share of the conditional loss."""
    if F is None:
        F = portfolio_returns(weights, returns, mask, weighted, shard)
    return em_violations(moment_means(returns, mask, moments, F), n_assets,
                         shard)


def unconditional_violation(weights: torch.Tensor, returns: torch.Tensor,
                            mask: torch.Tensor, weighted: bool = True,
                            F: Optional[torch.Tensor] = None,
                            n_assets=None, shard: Optional[StockShard] = None
                            ) -> torch.Tensor:
    """sqrt of the unconditional pricing-error norm [S]: h ≡ 1's
    violation."""
    loss, _ = unconditional_loss(weights, returns, mask, weighted, F=F,
                                 n_assets=n_assets, shard=shard)
    return torch.sqrt(loss)


def sdf_series_stats(F: torch.Tensor) -> Diagnostics:
    """Stats of each member's SDF series M_t = 1 + F_t [S, T]: mean, vol
    (ddof 0), min and the finite fraction. Non-finite entries are left out
    of the moments, so one NaN month does not erase the rest."""
    m = 1.0 + F
    finite = torch.isfinite(m)
    frac = finite.float().mean(dim=-1)
    safe = torch.where(finite, m, torch.zeros_like(m))
    n = finite.sum(dim=-1).clamp_min(1)
    mean = safe.sum(dim=-1) / n
    vol = torch.sqrt(((((safe - mean[..., None]) * finite) ** 2).sum(dim=-1)
                      / n).clamp_min(0.0))
    mmin = torch.where(finite, m, torch.full_like(m, float("inf"))).amin(
        dim=-1)
    return {"sdf_mean": mean, "sdf_vol": vol, "sdf_min": mmin,
            "sdf_finite_frac": frac}


def portfolio_diagnostics(weights: torch.Tensor, mask: torch.Tensor,
                          shard: Optional[StockShard] = None) -> Diagnostics:
    """Concentration and churn of each member's served portfolio [S], on
    the abs-sum-normalized weights (Σ_i |w·m| = 1 per period):

      * ``weight_hhi``     — mean_t Σ_i (|w|·m)²;
      * ``weight_max_abs`` — max |w·m| over the panel;
      * ``short_fraction`` — mean_t Σ_i max(−w, 0)·m;
      * ``turnover``       — mean_{t≥1} ½ Σ_i |w_t − w_{t−1}|·(m_t·m_{t−1}).
    """
    nw = normalize_weights_abs(weights, mask, shard) * mask
    hhi = stock_sum(nw.abs() ** 2, -1, shard).mean(dim=-1)
    max_abs = stock_amax(nw.abs(), (-2, -1), shard)
    short = stock_sum((-nw).clamp_min(0.0), -1, shard).mean(dim=-1)
    both = mask[1:] * mask[:-1]
    churn = 0.5 * stock_sum(
        (nw[..., 1:, :] - nw[..., :-1, :]).abs() * both, -1, shard)
    turnover = churn.sum(dim=-1) / max(churn.shape[-1], 1)
    return {"weight_hhi": hhi, "weight_max_abs": max_abs,
            "short_fraction": short, "turnover": turnover}


def panel_diagnostics(weights: torch.Tensor, returns: torch.Tensor,
                      mask: torch.Tensor,
                      moments: Optional[torch.Tensor] = None,
                      weighted: bool = True, n_assets=None,
                      F: Optional[torch.Tensor] = None,
                      em: Optional[torch.Tensor] = None,
                      shard: Optional[StockShard] = None) -> Diagnostics:
    """The full diagnostic set of S members from one eval forward's
    outputs: ``moment_violations`` [S, K] and every key of
    :data:`SCALAR_KEYS` [S], f32. The moment side is either the moments h
    [S, K, T, N] or their empirical means em [S, K, N] (the fused route);
    `F` is the portfolio [S, T] when the caller has it. ``adv_gap`` is
    ``loss_cond − loss_unc``: the h-weighted pricing error the
    discriminator finds beyond the unconditional one."""
    if F is None:
        F = portfolio_returns(weights, returns, mask, weighted, shard)
    if em is None:
        em = moment_means(returns, mask, moments, F)
    violations = em_violations(em, n_assets, shard)
    loss_cond = em_loss(em, n_assets, shard)
    loss_unc, _ = unconditional_loss(weights, returns, mask, weighted, F=F,
                                     n_assets=n_assets, shard=shard)
    out = {
        "computed": torch.ones_like(loss_unc),
        "moment_violations": violations,
        "moment_violation_max": violations.amax(dim=-1),
        "unc_violation": torch.sqrt(loss_unc),
        "adv_gap": loss_cond - loss_unc,
        "loss_unc": loss_unc,
        "loss_cond": loss_cond,
    }
    out.update(sdf_series_stats(F))
    out.update(portfolio_diagnostics(weights, mask, shard))
    return {k: v.to(torch.float32) for k, v in out.items()}


@torch.no_grad()
def diagnostics_members(gan, params: Mapping[str, torch.Tensor],
                        batch) -> Diagnostics:
    """:func:`panel_diagnostics` of S members from their eval forward (no
    dropout, no generator drawn from): ``gan.member_terms`` on
    member-stacked params [S, ...], so the default moment net runs the
    fused conditional-EM. Takes the place of the JAX ``make_diag_fn``."""
    batch = gan.prepare_batch(batch)
    weights, F, em, h = gan.member_terms(params, batch)
    return panel_diagnostics(weights, batch["returns"], batch["mask"], h,
                             gan.cfg.weighted_loss,
                             n_assets=batch.get("n_assets"), F=F, em=em,
                             shard=gan.exec_cfg.shard)


def zeros_diagnostics(num_moments: int, S: int = 1) -> Diagnostics:
    """The zero-valued diagnostics of S members (``computed`` 0): an
    off-stride epoch's row."""
    out = {k: torch.zeros(S) for k in SCALAR_KEYS}
    out["moment_violations"] = torch.zeros(S, num_moments)
    return out
