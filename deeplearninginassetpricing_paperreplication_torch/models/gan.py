"""The GAN: the phase-switched training forward and the eval surface.

The counterpart of the JAX package's ``models/gan.py`` ``GAN``. The JAX
class is a pure function of (params, batch); here the parameters live in
the module, and a batch is a dict of tensors on the module's device
(``macro`` [T, M], ``individual`` [T, N, F], ``mask`` and ``returns``
[T, N], the feature-major panel ``individual_t`` [T, F, N] from
:meth:`GAN.prepare_batch`, optionally ``n_assets``).

:meth:`GAN.forward` computes the phase's loss:

    phase='unconditional' → loss = E[w·R·M]² (generator, h ≡ 1)
    phase='moment'        → loss = −E[h·w·R·M]² (discriminator maximizes)
    phase='conditional'   → loss = E[h·w·R·M]² (+ unconditional, monitor)

With the default moment net (no hidden layers) and macro data, the
conditional loss goes through the fused conditional-EM (``ops/cond_em.py``)
and h never materializes; any other moment architecture builds h and calls
``conditional_loss``, as in the JAX package. Phase 1 does not compute h at
all (JAX builds it and jit drops it). The inference-mode ``weights`` and
``moments`` are the serving path's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.cond_em import fused_conditional_em
from ..ops.losses import (
    conditional_loss,
    portfolio_returns,
    residual_loss,
    unconditional_loss,
)
from ..ops.metrics import normalize_weights_abs, sharpe_monitor
from ..utils.config import ExecutionConfig, GANConfig, resolve_device
from .networks import AssetPricingModule, moment_output_params

PHASES = ("unconditional", "moment", "conditional")

Batch = Dict[str, torch.Tensor]


class GAN:
    """A GANConfig with its :class:`AssetPricingModule`. Training or eval
    is chosen per call (a dropout seed or none), not by a module flag."""

    def __init__(self, cfg: GANConfig, exec_cfg: Optional[ExecutionConfig] = None,
                 module: Optional[AssetPricingModule] = None):
        self.cfg = cfg
        self.exec_cfg = exec_cfg or ExecutionConfig()
        self.module = (module if module is not None
                       else AssetPricingModule(cfg, self.exec_cfg))
        self.module.sdf_net.exec_cfg = self.exec_cfg
        self.module.eval()

    @classmethod
    def from_state_dict(cls, cfg: GANConfig, state_dict,
                        exec_cfg: Optional[ExecutionConfig] = None) -> "GAN":
        """Strict load of a reference-layout ``state_dict``, placed on
        ``exec_cfg.device``."""
        exec_cfg = exec_cfg or ExecutionConfig()
        module = AssetPricingModule(cfg, exec_cfg)
        module.load_state_dict(state_dict, strict=True)
        return cls(cfg, exec_cfg, module.to(resolve_device(exec_cfg.device)))

    @torch.inference_mode()
    def weights(self, batch: Batch,
                macro_state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Masked zero-mean weights [T, N]. ``macro_state`` [T, H] bypasses
        the in-module LSTM with a caller-carried state."""
        return self.module.sdf_net(
            batch.get("macro"), batch["individual"], batch["mask"],
            individual_t=batch.get("individual_t"), macro_state=macro_state)

    @torch.inference_mode()
    def moments(self, batch: Batch) -> torch.Tensor:
        """tanh moments h [K, T, N]."""
        return self.module.moment_net(batch.get("macro"), batch["individual"])

    # -- training -----------------------------------------------------------

    @staticmethod
    def prepare_batch(batch: Batch) -> Batch:
        """Add the feature-major panel ``individual_t`` [T, F, N] the
        kernels read (once per split, outside the epoch loop)."""
        if "individual_t" in batch:
            return batch
        return dict(batch, individual_t=batch["individual"].permute(
            0, 2, 1).contiguous())

    def forward(self, batch: Batch, phase: str = "conditional",
                seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Phase-switched forward. `seed` (an int) turns dropout on and
        draws every mask from it (training); None is the eval forward."""
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        cfg = self.cfg
        batch = self.prepare_batch(batch)
        returns, mask = batch["returns"], batch["mask"]
        n_assets = batch.get("n_assets")
        generator = None
        if seed is not None:
            generator = torch.Generator(device=returns.device)
            generator.manual_seed(int(seed))
        weights = self.module.sdf_net(
            batch.get("macro"), batch["individual"], mask,
            individual_t=batch["individual_t"], seed=seed,
            generator=generator)
        zero = weights.new_zeros(())
        if phase == "unconditional":
            loss_unc, F = unconditional_loss(weights, returns, mask,
                                             cfg.weighted_loss,
                                             n_assets=n_assets)
            loss_cond = zero
        elif not cfg.hidden_dim_moment and batch.get("macro") is not None:
            loss_cond, F = self._fused_cond_loss(batch, weights, n_assets)
        else:
            moments = self.module.moment_net(batch.get("macro"),
                                             batch["individual"], generator)
            loss_cond, F = conditional_loss(weights, returns, mask, moments,
                                            cfg.weighted_loss,
                                            n_assets=n_assets)
        if phase == "moment":
            loss_unc = zero
            total = -loss_cond  # the discriminator ascends
        elif phase == "conditional":
            loss_unc, _ = unconditional_loss(weights, returns, mask,
                                             cfg.weighted_loss, F=F,
                                             n_assets=n_assets)
            total = loss_cond
        else:
            total = loss_unc
        total, loss_res = self._residual_term(weights, returns, mask, total)
        return {
            "weights": weights,
            "loss": total,
            "loss_unconditional": loss_unc,
            "loss_conditional": loss_cond,
            "loss_residual": loss_res,
            "sharpe": sharpe_monitor(F),
            "portfolio_returns": F,
        }

    @staticmethod
    def _em_loss(em: torch.Tensor, n_assets) -> torch.Tensor:
        """em [K, N] → conditional loss: mean, or sum / (K·true N) under
        padding."""
        if n_assets is None:
            return (em ** 2).mean()
        return (em ** 2).sum() / (em.shape[0] * n_assets)

    def _residual_term(self, weights, returns, mask, total):
        """(total + λ·residual, residual)."""
        if self.cfg.residual_loss_factor > 0:
            loss_res = residual_loss(weights, returns, mask)
            return total + self.cfg.residual_loss_factor * loss_res, loss_res
        return total, weights.new_zeros(())

    def _fused_cond_loss(self, batch: Batch, weights: torch.Tensor,
                         n_assets, F: Optional[torch.Tensor] = None):
        """Conditional loss through the fused conditional-EM; (loss, F)."""
        cfg = self.cfg
        returns, mask = batch["returns"], batch["mask"]
        k_period, k_stock, bias = moment_output_params(self.module, cfg)
        zp_m = batch["macro"] @ k_period + bias  # [T, K]
        if F is None:
            F = portfolio_returns(weights, returns, mask, cfg.weighted_loss)
        xr = returns * mask * (1.0 + F)[:, None]
        tinv = 1.0 / mask.sum(dim=0).clamp_min(1)
        em = fused_conditional_em(
            batch["individual_t"], zp_m, xr, tinv, k_stock,
            compute_dtype=self.exec_cfg.compute_dtype,
            kernel=self.exec_cfg.kernel)
        return self._em_loss(em, n_assets), F

    # -- eval surface ---------------------------------------------------------

    def normalized_weights(self, batch: Batch,
                           macro_state: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """Weights scaled to Σ|w| = 1 per period."""
        return normalize_weights_abs(self.weights(batch, macro_state),
                                     batch["mask"])

    def sdf_factor(self, batch: Batch, normalized: bool = True) -> torch.Tensor:
        """Portfolio return series [T] of the SDF portfolio."""
        w = (self.normalized_weights(batch) if normalized
             else self.weights(batch))
        return (w * batch["returns"] * batch["mask"]).sum(dim=1)
