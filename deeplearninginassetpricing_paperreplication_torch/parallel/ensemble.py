"""Paper-protocol ensemble evaluation over a leading member axis.

The counterpart of the evaluation half of the JAX package's
``parallel/ensemble.py``: the members' parameters are stacked on an
explicit leading axis [S, ...] (where JAX vmaps), the macro LSTMs of all
members run together, and the SDF FFN of all members is ONE fused-kernel
launch over one panel read (never a Python loop over members).

The reduction is the reference's: average the members' abs-sum-normalized
weights, re-normalize per period where the abs-sum exceeds 1e-8, form the
portfolio returns, and report the Sharpe of the NEGATED series with
ddof=0. Training the ensemble (members as a leading axis) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..models.networks import (
    macro_states,
    masked_zero_mean,
    sdf_raw_weights,
)
from ..ops import sdf_ffn
from ..ops.metrics import (
    cross_sectional_r2,
    explained_variation,
    factor_betas,
    normalize_weights_abs,
    sharpe,
)
from ..utils.config import ExecutionConfig, GANConfig

Batch = Dict[str, torch.Tensor]
SDF_PREFIX = "sdf_net."


def stack_state_dicts(state_dicts: Sequence[Mapping[str, torch.Tensor]],
                      device) -> Dict[str, torch.Tensor]:
    """Member ``state_dict``s → one dict of [S, ...] float32 tensors on
    `device`."""
    keys = list(state_dicts[0])
    return {k: torch.stack([torch.as_tensor(sd[k], dtype=torch.float32)
                            for sd in state_dicts]).to(device)
            for k in keys}


def sdf_params(stacked: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``sdf_net``-relative entries of a stacked state dict."""
    return {k[len(SDF_PREFIX):]: v for k, v in stacked.items()
            if k.startswith(SDF_PREFIX)}


@torch.inference_mode()
def member_weights(cfg: GANConfig, stacked: Mapping[str, torch.Tensor],
                   batch: Batch, exec_cfg: ExecutionConfig,
                   packed: Optional[sdf_ffn.PackedFfn] = None) -> torch.Tensor:
    """[S, T, N] abs-sum-normalized weights of every member: one member-
    stacked LSTM scan and one fused-FFN call over all S members."""
    params = sdf_params(stacked)
    mask = batch["mask"]
    x_t = batch.get("individual_t")
    if x_t is None:
        x_t = batch["individual"].permute(0, 2, 1).contiguous()
    states = macro_states(params, cfg, batch.get("macro"))
    w = sdf_raw_weights(params, cfg, exec_cfg, x_t, states, packed) * mask
    if cfg.normalize_w:
        w = masked_zero_mean(w, mask)
    return normalize_weights_abs(w, mask)


def _ensemble_math(w: torch.Tensor, batch: Batch) -> Dict[str, torch.Tensor]:
    """The paper-protocol reduction from stacked member weights [S, T, N]:
    mean → guarded re-normalize → portfolio returns → negated ddof=0
    Sharpe, plus EV / XS-R²."""
    mask, returns = batch["mask"], batch["returns"]
    indiv_port = (w * returns * mask).sum(dim=2)  # [S, T]
    indiv_sharpe = torch.stack([sharpe(-r, ddof=0) for r in indiv_port])
    avg = w.mean(dim=0)  # [T, N]
    abs_sum = (avg.abs() * mask).sum(dim=1, keepdim=True)
    avg = torch.where(abs_sum > 1e-8, avg / abs_sum, avg)
    port = (avg * returns * mask).sum(dim=1)  # [T]
    betas = factor_betas(returns, port, mask)
    return {
        "ensemble_sharpe": sharpe(-port, ddof=0),
        "ensemble_port_returns": port,
        "individual_sharpes": indiv_sharpe,
        "avg_weights": avg,
        "explained_variation": explained_variation(returns, port, mask, betas),
        "cross_sectional_r2": cross_sectional_r2(returns, port, mask, betas),
    }


def ensemble_metrics(cfg: GANConfig, stacked: Mapping[str, torch.Tensor],
                     batch: Batch, exec_cfg: ExecutionConfig
                     ) -> Dict[str, np.ndarray]:
    """The reference's ensemble math on one split, as NumPy arrays."""
    with torch.inference_mode():
        out = _ensemble_math(member_weights(cfg, stacked, batch, exec_cfg),
                             batch)
    return {k: v.cpu().numpy() for k, v in out.items()}
