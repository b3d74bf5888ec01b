"""The GAN's eval-mode surface: weights, normalized weights, SDF factor.

The counterpart of the JAX package's ``models/gan.py`` ``GAN`` for the
forward the serving and evaluation paths use. The JAX class is a pure
function of (params, batch); here the parameters live in the module, and
a batch is a dict of tensors on the module's device (``macro`` [T, M],
``individual`` [T, N, F], ``mask`` and ``returns`` [T, N], optionally the
feature-major panel ``individual_t`` [T, F, N]). The phase losses come with
the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.metrics import normalize_weights_abs
from ..utils.config import ExecutionConfig, GANConfig, resolve_device
from .networks import AssetPricingModule

Batch = Dict[str, torch.Tensor]


class GAN:
    """A GANConfig with its :class:`AssetPricingModule`, in eval mode."""

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
