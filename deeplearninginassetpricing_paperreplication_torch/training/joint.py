"""The joint (1-phase) trainer and the SimpleSDF baseline trainer.

The counterpart of the JAX package's ``training/joint.py``, the reference
demo notebook's training mode: ONE Adam over ALL the GAN's parameters
(generator and discriminator together) on the conditional forward,
clipped by their joint global norm (5.0), its learning rate scaled by
torch's ``ReduceLROnPlateau(mode='max', factor=0.5, patience=20)`` stepped
on the validation Sharpe; and the SimpleSDF baseline trained with plain
Adam, no clip and no schedule.

The JAX loop is one ``lax.scan`` with no host sync. Here every epoch's
numbers, and the plateau state (scale, best, bad-epoch count), stay 0-d
device tensors updated with ``torch.where``; the history is read once, at
the end. The plateau rule is torch's exactly: an epoch improves iff
``metric > best · (1 + 1e-4)`` (best starts at −inf); after `patience`
epochs without one the scale is multiplied by `factor` and the count
resets (cooldown 0).

Dropout draws one seed per epoch from ``utils/rng.py``'s convention (the
first phase's stream of :func:`phase_epoch_seeds`); the masks are not the
JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gan import GAN, Batch, feature_major
from ..models.networks import SimpleSDF, init_params, simple_sdf_forward
from ..ops.metrics import sharpe
from ..utils.config import ExecutionConfig
from ..utils.rng import phase_epoch_seeds
from .steps import Optimizer, eval_step

PLATEAU_THRESHOLD = 1e-4
JOINT_KEYS = ("train_loss", "train_sharpe", "valid_loss", "valid_sharpe",
              "lr")
SIMPLE_KEYS = ("train_sharpe", "valid_sharpe", "train_loss", "valid_loss")


def _plateau_update(lr_scale, best, bad, metric, factor: float,
                    patience: int, threshold: float):
    """torch ``ReduceLROnPlateau(mode='max', threshold_mode='rel')`` step on
    0-d tensors: improved iff ``metric > best · (1 + threshold)``, then best
    := metric; past `patience` bad epochs the scale shrinks by `factor`
    and the count resets."""
    improved = metric > best * (1.0 + threshold)
    best = torch.where(improved, metric, best)
    bad = torch.where(improved, torch.zeros_like(bad), bad + 1)
    reduce_now = bad > patience
    lr_scale = torch.where(reduce_now, lr_scale * factor, lr_scale)
    bad = torch.where(reduce_now, torch.zeros_like(bad), bad)
    return lr_scale, best, bad


class _ScaledOptimizer(Optimizer):
    """:class:`Optimizer` whose step is ``-lr · scale · adam_update``, with
    `scale` a 0-d device tensor (the plateau schedule's)."""

    def __init__(self, params, lr: float, grad_clip: float,
                 scale: torch.Tensor):
        super().__init__(params, lr, grad_clip)
        self.scale = scale

    def _lr(self, p):
        return self.lr * self.scale


def _grads(loss: torch.Tensor, params) -> list:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _history(rows, keys) -> Dict[str, np.ndarray]:
    """Per-epoch rows of 0-d device tensors → host arrays, one sync."""
    if not rows:
        return {k: np.zeros(0, np.float32) for k in keys}
    table = torch.stack([torch.stack(r) for r in rows]).cpu().numpy()
    return {k: table[:, i] for i, k in enumerate(keys)}


def joint_train(gan: GAN, train_batch: Batch, valid_batch: Batch,
                num_epochs: int = 200, lr: float = 1e-3,
                grad_clip: float = 5.0, plateau_factor: float = 0.5,
                plateau_patience: int = 20, phase: str = "conditional",
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Train every parameter of ``gan.module`` in place with one
    clip-by-joint-global-norm → Adam, dropout on (a seed per epoch), the
    step scaled by the plateau schedule on the eval Sharpe of
    `valid_batch`. Returns the per-epoch history: ``train_loss``,
    ``train_sharpe`` (ddof 1, of the training forward's portfolio),
    ``valid_loss``, ``valid_sharpe`` and the ``lr`` after each epoch's
    plateau step."""
    train_b = gan.prepare_batch(train_batch)
    valid_b = gan.prepare_batch(valid_batch)
    params = list(gan.module.parameters())
    for p in params:
        p.requires_grad_(True)
    dev = params[0].device
    scale = torch.ones((), dtype=torch.float32, device=dev)
    best = torch.full((), -np.inf, dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    opt = _ScaledOptimizer(params, lr, grad_clip, scale)
    rows = []
    for s in phase_epoch_seeds(seed, [num_epochs])[0]:
        out = gan.forward(train_b, phase=phase, seed=s)
        opt.step(_grads(out["loss"], params))
        va = eval_step(gan, valid_b)
        scale, best, bad = _plateau_update(
            scale, best, bad, va["sharpe"], plateau_factor,
            plateau_patience, PLATEAU_THRESHOLD)
        opt.scale = scale
        rows.append((out["loss"].detach(),
                     sharpe(out["portfolio_returns"].detach(), ddof=1),
                     va["loss"], va["sharpe"], lr * scale))
    return _history(rows, JOINT_KEYS)


def fit_simple_sdf(model: SimpleSDF, train_batch: Batch, valid_batch: Batch,
                   num_epochs: int = 200, lr: float = 1e-3,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """Train `model` in place from its current weights (plain Adam, eps
    1e-8, no clip, no schedule; dropout seeds from `seed`), each update
    followed by an eval forward on both batches. Returns the per-epoch
    ``train_sharpe``, ``valid_sharpe`` (ddof 1), ``train_loss`` and
    ``valid_loss``. :func:`train_simple_sdf` is this from a seeded init."""
    # SimpleSDF reads the f32 panel (the JAX package's transposes its own)
    train_b = feature_major(train_batch)
    valid_b = feature_major(valid_batch)
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    opt = Optimizer(params, lr, grad_clip=float("inf"))
    rows = []
    for s in phase_epoch_seeds(seed, [num_epochs])[0]:
        opt.step(_grads(simple_sdf_forward(model, train_b, seed=s)["loss"],
                        params))
        with torch.no_grad():
            tr = simple_sdf_forward(model, train_b)
            va = simple_sdf_forward(model, valid_b)
        rows.append((sharpe(tr["portfolio_returns"], ddof=1),
                     sharpe(va["portfolio_returns"], ddof=1),
                     tr["loss"], va["loss"]))
    return _history(rows, SIMPLE_KEYS)


def train_simple_sdf(macro_dim: int, individual_dim: int,
                     train_batch: Batch, valid_batch: Batch,
                     hidden_dims: Sequence[int] = (32, 16),
                     dropout: float = 0.1, num_epochs: int = 200,
                     lr: float = 1e-3, seed: int = 0,
                     exec_cfg: Optional[ExecutionConfig] = None
                     ) -> Tuple[SimpleSDF, Dict[str, np.ndarray]]:
    """The SimpleSDF baseline (the reference demo notebook's cell 16):
    weights drawn from ``torch.Generator().manual_seed(seed)`` (torch's
    default bounds), placed on the batches' device, then
    :func:`fit_simple_sdf`. Returns (model, history)."""
    model = SimpleSDF(macro_dim, individual_dim, hidden_dims, dropout,
                      exec_cfg)
    init_params(model, torch.Generator().manual_seed(int(seed)))
    model.to(train_batch["individual"].device)
    return model, fit_simple_sdf(model, train_batch, valid_batch,
                                 num_epochs, lr, seed)
