"""The GAN: the phase-switched training forward and the eval surface.

The counterpart of the JAX package's ``models/gan.py`` ``GAN``. The JAX
class is a pure function of (params, batch); here the parameters live in
the module, and a batch is a dict of tensors on the module's device
(``macro`` [T, M], ``individual`` [T, N, F], ``mask`` and ``returns``
[T, N], the feature-major panel ``individual_t`` [T, F, N] from
:meth:`GAN.prepare_batch`, optionally ``n_assets``). ``individual_t`` is
bfloat16 where ``ExecutionConfig.stores_bf16_panel`` holds (the JAX
package's default on the kernel route), else float32; ``individual`` is
always f32.

:meth:`GAN.forward_members` computes the phase's loss of S members at
once, from member-stacked parameters [S, ...] (where the JAX package vmaps
``GAN.forward``); :meth:`GAN.forward` is its S = 1 case over the module's
parameters:

    phase='unconditional' → loss = E[w·R·M]² (generator, h ≡ 1)
    phase='moment'        → loss = −E[h·w·R·M]² (discriminator maximizes)
    phase='conditional'   → loss = E[h·w·R·M]² (+ unconditional, monitor)

With the default moment net (no hidden layers) and macro data, the
conditional loss goes through the fused conditional-EM (``ops/cond_em.py``)
and h never materializes; any other moment architecture builds h and calls
``conditional_loss``, as in the JAX package. Phase 1 does not compute h at
all (JAX builds it and jit drops it). One fused-FFN and one fused
conditional-EM call serve all S members. :meth:`GAN.member_terms` forms the
weights, F and em (or h) that both the losses and the model-health
diagnostics (``ops/diagnostics.py``) are built from. The inference-mode
``weights`` and ``moments`` are the serving path's.

Stock-sharded training (``exec_cfg.shard``, a
``parallel.collectives.StockShard``): each rank's batch holds its own
contiguous span of the stocks. The FFN runs on the rank's panel with the
span's start as its dropout offset, the fused conditional-EM on the local
shard (em[k, n] is local to its stock, as are T_i), and every sum over
stocks (zero-mean, F, the losses, the normalized weights) is all-reduced.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from ..ops.cond_em import fused_conditional_em
from ..ops.losses import (
    conditional_loss,
    em_loss,
    portfolio_returns,
    residual_loss,
    unconditional_loss,
)
from ..ops.metrics import normalize_weights_abs, sharpe_monitor
from ..parallel.collectives import stock_sum
from ..utils.config import ExecutionConfig, GANConfig, resolve_device
from .networks import (
    AssetPricingModule,
    macro_states,
    masked_zero_mean,
    moment_h_members,
    moment_output_members,
    sdf_raw_weights,
)

PHASES = ("unconditional", "moment", "conditional")

Batch = Dict[str, torch.Tensor]


def feature_major(batch: Batch) -> Batch:
    """`batch` with the f32 feature-major panel ``individual_t`` [T, F, N]
    (kept where it has an f32 one): the panel of every evaluation and of
    models that never store a bf16 panel (SimpleSDF)."""
    x_t = batch.get("individual_t")
    if x_t is not None and x_t.dtype == torch.float32:
        return batch
    return dict(batch, individual_t=batch["individual"].permute(
        0, 2, 1).contiguous())


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
        self.module.moment_net.exec_cfg = self.exec_cfg
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
        """tanh moments h [K, T, N] (the default moment net reads a bf16
        ``individual_t`` where the batch has one, as in the JAX package)."""
        return self.module.moment_net(batch.get("macro"), batch["individual"],
                                      individual_t=batch.get("individual_t"))

    # -- training -----------------------------------------------------------

    def prepare_batch(self, batch: Batch) -> Batch:
        """Add the feature-major panel ``individual_t`` [T, F, N] the
        kernels read (once per split, outside the epoch loop): in bfloat16
        where ``exec_cfg.stores_bf16_panel(cfg)`` holds (the JAX package's
        ``prepare_batch``), else f32. A batch that has one keeps it."""
        if "individual_t" in batch:
            return batch
        if not self.exec_cfg.stores_bf16_panel(self.cfg):
            return feature_major(batch)
        # transposed and rounded in one copy: no f32 panel in between
        return dict(batch, individual_t=batch["individual"].permute(
            0, 2, 1).to(torch.bfloat16, memory_format=torch.contiguous_format))

    def forward(self, batch: Batch, phase: str = "conditional",
                seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Phase-switched forward of the module's parameters: the S = 1 case
        of :meth:`forward_members`. `seed` (an int) turns dropout on and
        draws every mask from it (training); None is the eval forward."""
        params = {n: p[None] for n, p in self.module.named_parameters()}
        out = self.forward_members(params, batch, phase,
                                   None if seed is None else [seed])
        return {k: v[0] for k, v in out.items()}

    # -- member-stacked training ------------------------------------------------

    def member_terms(self, params: Mapping[str, torch.Tensor], batch: Batch,
                     seeds: Optional[Sequence[int]] = None,
                     moments: bool = True):
        """(weights [S, T, N], F [S, T], em, h): the pieces every loss and
        diagnostic of S members is built from, from member-stacked
        ``state_dict``-keyed params [S, ...] (`seeds` as in
        :meth:`forward_members`; None is the eval forward). With `moments`,
        the default moment net with macro data gives the empirical moment
        means em [S, K, N] = Σ_t h·R·m·(1+F) / T_i from the fused
        conditional-EM (h never materializes) and h None; any other moment
        net gives h [S, K, T, N] and em None. Without `moments` both are
        None and no moment-net work is done."""
        cfg = self.cfg
        shard = self.exec_cfg.shard
        batch = self.prepare_batch(batch)
        returns, mask, macro = batch["returns"], batch["mask"], batch.get(
            "macro")
        sdf = {k[len("sdf_net."):]: v for k, v in params.items()
               if k.startswith("sdf_net.")}
        moment = {k[len("moment_net."):]: v for k, v in params.items()
                  if k.startswith("moment_net.")}
        generators = None
        if seeds is not None:
            seeds = [int(s) for s in seeds]
            generators = [torch.Generator(device=returns.device).manual_seed(s)
                          for s in seeds]
        states = macro_states(sdf, cfg, macro, generators)
        weights = sdf_raw_weights(sdf, cfg, self.exec_cfg,
                                  batch["individual_t"], states, seed=seeds,
                                  offset=shard.start if shard else 0) * mask
        if cfg.normalize_w:
            weights = masked_zero_mean(weights, mask, shard)
        F = portfolio_returns(weights, returns, mask, cfg.weighted_loss,
                              shard)
        em = h = None
        if moments and not cfg.hidden_dim_moment and macro is not None:
            k_period, k_stock, bias = moment_output_members(moment, cfg)
            em = fused_conditional_em(
                batch["individual_t"], macro @ k_period + bias[:, None, :],
                returns * mask * (1.0 + F)[..., None],
                1.0 / mask.sum(dim=0).clamp_min(1), k_stock,
                compute_dtype=self.exec_cfg.compute_dtype,
                kernel=self.exec_cfg.kernel)  # [S, K, N]
        elif moments:
            h = moment_h_members(moment, cfg, macro, batch["individual"],
                                 generators, shard)
        return weights, F, em, h

    def forward_members(self, params: Mapping[str, torch.Tensor],
                        batch: Batch, phase: str = "conditional",
                        seeds: Optional[Sequence[int]] = None
                        ) -> Dict[str, torch.Tensor]:
        """The phase forward of S members at once, from member-stacked
        ``state_dict``-keyed params [S, ...]. `seeds` (one per member) turn
        dropout on: member s draws every mask from seeds[s] (the FFN
        kernels' hash and a generator seeded with it for the LSTM's and the
        moment net's dropout); None is the eval forward. Returns
        per-member losses and monitor Sharpes [S], the portfolio F [S, T]
        and the weights [S, T, N]. The members are independent, so the
        gradient of ``loss.sum()`` gives each member its own gradient."""
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        cfg = self.cfg
        shard = self.exec_cfg.shard
        batch = self.prepare_batch(batch)
        returns, mask = batch["returns"], batch["mask"]
        n_assets = batch.get("n_assets")
        weights, F, em, h = self.member_terms(
            params, batch, seeds, moments=phase != "unconditional")
        zero = weights.new_zeros(weights.shape[0])
        if phase == "unconditional":
            loss_unc, _ = unconditional_loss(weights, returns, mask,
                                             cfg.weighted_loss, F=F,
                                             n_assets=n_assets, shard=shard)
            loss_cond = zero
        elif em is not None:
            loss_cond = em_loss(em, n_assets, shard)
        else:
            loss_cond, _ = conditional_loss(weights, returns, mask, h,
                                            cfg.weighted_loss, F=F,
                                            n_assets=n_assets, shard=shard)
        if phase == "moment":
            loss_unc = zero
            total = -loss_cond  # the discriminator ascends
        elif phase == "conditional":
            loss_unc, _ = unconditional_loss(weights, returns, mask,
                                             cfg.weighted_loss, F=F,
                                             n_assets=n_assets, shard=shard)
            total = loss_cond
        else:
            total = loss_unc
        loss_res = zero
        if cfg.residual_loss_factor > 0:
            loss_res = residual_loss(weights, returns, mask, shard)
            total = total + cfg.residual_loss_factor * loss_res
        return {
            "weights": weights,
            "loss": total,
            "loss_unconditional": loss_unc,
            "loss_conditional": loss_cond,
            "loss_residual": loss_res,
            "sharpe": sharpe_monitor(F),
            "portfolio_returns": F,
        }

    # -- eval surface ---------------------------------------------------------

    def normalized_weights(self, batch: Batch,
                           macro_state: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """Weights scaled to Σ|w| = 1 per period."""
        return normalize_weights_abs(self.weights(batch, macro_state),
                                     batch["mask"], self.exec_cfg.shard)

    def sdf_factor(self, batch: Batch, normalized: bool = True) -> torch.Tensor:
        """Portfolio return series [T] of the SDF portfolio."""
        w = (self.normalized_weights(batch) if normalized
             else self.weights(batch))
        return stock_sum(w * batch["returns"] * batch["mask"], 1,
                         self.exec_cfg.shard)
