"""Per-phase train and eval steps with a scoped optimizer.

The counterpart of the JAX package's ``training/steps.py``. Each phase
differentiates only its trainable subtree; the frozen side gets
``requires_grad_(False)``, so no gradient is computed for it (in phase 2
the SDF-FFN backward kernel does not run). The update is the JAX
package's optax chain, written out: clip by global norm (optax's formula:
g stays as it is when ‖g‖ < clip, else g / ‖g‖ · clip — not
``torch.nn.utils.clip_grad_norm_``'s 1 / (‖g‖ + 1e-6)), then Adam
(b1 0.9, b2 0.999, eps 1e-8, optax's bias correction).

Phase → (loss, trainable subtree):
    unconditional → E[w·R·M]²,    sdf_net
    moment        → −E[h·w·R·M]², moment_net
    conditional   → E[h·w·R·M]²,  sdf_net

The member-stacked steps (:class:`MemberOptimizer`, :func:`train_step_members`,
:func:`eval_step_members`) train S models whose parameters sit on a leading
axis [S, ...]. optax runs inside the JAX package's vmap, so each member is
clipped by its OWN global norm; :class:`MemberOptimizer` does the same (one
joint norm over the stack would clip every member by all members' norm).

Under a stock shard (``gan.exec_cfg.shard``) each rank's backward gives its
share of the replicated parameters' gradients; the train steps all-reduce
them as one flattened bucket before the clip
(``parallel.collectives.all_reduce_grads``), so every rank clips and steps
on the same true gradient and the parameters stay bit for bit equal across
ranks. The eval steps' portfolio sums run over every rank's stocks.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from ..models.gan import GAN, Batch
from ..ops.metrics import normalize_weights_abs, sharpe
from ..parallel.collectives import all_reduce_grads, stock_sum

_TRAINABLE = {
    "unconditional": "sdf_net",
    "moment": "moment_net",
    "conditional": "sdf_net",
}


def trainable_key(phase: str) -> str:
    return _TRAINABLE[phase]


def subtree_params(gan: GAN, key: str) -> List[torch.nn.Parameter]:
    return list(getattr(gan.module, key).parameters())


class Optimizer:
    """clip-by-global-norm → Adam over one parameter subtree; the state (the
    moments and the step count) lives on the same tensors across phases."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 grad_clip: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.grad_clip = lr, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def _norms(self, grads: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(the pre-clip global norm, that norm as each gradient's clip
        sees it)."""
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
        return gnorm, [gnorm] * len(grads)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update from `grads`; returns the pre-clip global norm."""
        gnorm, norms = self._norms(grads)
        self.count += 1
        dev = gnorm.device
        bc1 = 1 - torch.tensor(self.b1, device=dev) ** self.count
        bc2 = 1 - torch.tensor(self.b2, device=dev) ** self.count
        for p, g, n, mu, nu in zip(self.params, grads, norms, self.mu,
                                   self.nu):
            g = torch.where(n < self.grad_clip, g, g / n * self.grad_clip)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g * g + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-self._lr(p) * update)
        return gnorm

    def _lr(self, p: torch.Tensor):
        return self.lr


class MemberOptimizer(Optimizer):
    """:class:`Optimizer` over member-stacked tensors [S, ...]: member s is
    clipped by the global norm of its own gradients, then the same Adam
    runs elementwise, so each member's update is a one-model
    ``Optimizer.step``. ``step`` returns the [S] pre-clip norms.

    `lr` is one float for every member, or one per member (a sweep
    bucket's grid: the JAX package's vmapped ``inject_hyperparams``
    learning rate). Either is kept as an [S] f32 tensor on the params'
    device and broadcast over each tensor's member axis; f32 times f32,
    so equal values give the one-model step's bits."""

    def __init__(self, params: Sequence[torch.Tensor],
                 lr: Union[float, Sequence[float]], *args, **kw):
        super().__init__(params, lr, *args, **kw)
        S = self.params[0].shape[0]
        lrs = [float(lr)] * S if isinstance(lr, (int, float)) else lr
        self.lr = torch.as_tensor([float(v) for v in lrs],
                                  dtype=torch.float32,
                                  device=self.params[0].device)
        if self.lr.shape[0] != S:
            raise ValueError(f"{self.lr.shape[0]} learning rates for "
                             f"{S} members")

    def _lr(self, p):
        return self.lr.view((-1,) + (1,) * (p.dim() - 1))

    def _norms(self, grads):
        sq = sum((g * g).reshape(g.shape[0], -1).sum(dim=1) for g in grads)
        gnorm = torch.sqrt(sq)  # [S]
        return gnorm, [gnorm.view((-1,) + (1,) * (g.dim() - 1))
                       for g in grads]


def set_trainable(gan: GAN, key: str) -> None:
    """requires_grad on the phase's subtree only."""
    for name, p in gan.module.named_parameters():
        p.requires_grad_(name.startswith(key + "."))


def train_step(gan: GAN, phase: str, opt: Optimizer, batch: Batch,
               seed: Optional[int]) -> Dict[str, torch.Tensor]:
    """One update of the phase's subtree; returns 0-d device tensors (the
    caller syncs once per epoch)."""
    set_trainable(gan, trainable_key(phase))
    out = gan.forward(batch, phase=phase, seed=seed)
    grads = torch.autograd.grad(out["loss"], opt.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(opt.params, grads)]
    grads = all_reduce_grads(grads, gan.exec_cfg.shard)
    grad_norm = opt.step(grads)
    return {
        "loss": out["loss"].detach(),
        "loss_unc": out["loss_unconditional"].detach(),
        "loss_cond": out["loss_conditional"].detach(),
        "loss_residual": out["loss_residual"].detach(),
        # guarded sharpe (0 when std < 1e-8), as the reference logs it
        "sharpe": sharpe(out["portfolio_returns"].detach(), ddof=1),
        "grad_norm": grad_norm,
    }


@torch.no_grad()
def eval_step(gan: GAN, batch: Batch) -> Dict[str, torch.Tensor]:
    """Dropout off: Sharpe (ddof 1) of the abs-sum-normalized weights'
    portfolio, losses from a conditional-phase forward."""
    shard = gan.exec_cfg.shard
    out = gan.forward(batch, phase="conditional", seed=None)
    nw = normalize_weights_abs(out["weights"], batch["mask"], shard)
    port = stock_sum(nw * batch["returns"] * batch["mask"], 1, shard)
    return {
        "loss": out["loss"],
        "loss_unc": out["loss_unconditional"],
        "loss_cond": out["loss_conditional"],
        "sharpe": sharpe(port, ddof=1),
        "mean_return": port.mean(),
        "std_return": port.std(correction=0),
        "portfolio_returns": port,
    }


# -- member-stacked steps ---------------------------------------------------

StackedParams = Mapping[str, torch.Tensor]


def member_subtree(params: StackedParams, key: str) -> List[torch.Tensor]:
    """The stacked tensors of one subtree (``sdf_net`` or ``moment_net``),
    in ``state_dict`` order."""
    return [v for k, v in params.items() if k.startswith(key + ".")]


def train_step_members(gan: GAN, phase: str, opt: MemberOptimizer,
                       params: StackedParams, batch: Batch,
                       seeds: Optional[Sequence[int]]
                       ) -> Dict[str, torch.Tensor]:
    """One update of every member's phase subtree, in place; returns [S]
    device tensors (the caller syncs once per epoch). `seeds` holds one
    dropout seed per member."""
    key = trainable_key(phase)
    for k, p in params.items():
        p.requires_grad_(k.startswith(key + "."))
    out = gan.forward_members(params, batch, phase=phase, seeds=seeds)
    grads = torch.autograd.grad(out["loss"].sum(), opt.params,
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(opt.params, grads)]
    grads = all_reduce_grads(grads, gan.exec_cfg.shard)
    grad_norm = opt.step(grads)
    return {
        "loss": out["loss"].detach(),
        "loss_unc": out["loss_unconditional"].detach(),
        "loss_cond": out["loss_conditional"].detach(),
        "loss_residual": out["loss_residual"].detach(),
        "sharpe": sharpe(out["portfolio_returns"].detach(), ddof=1),
        "grad_norm": grad_norm,
    }


@torch.no_grad()
def eval_step_members(gan: GAN, params: StackedParams, batch: Batch
                      ) -> Dict[str, torch.Tensor]:
    """:func:`eval_step` of every member: [S] metrics, [S, T] portfolio."""
    shard = gan.exec_cfg.shard
    out = gan.forward_members(params, batch, phase="conditional")
    nw = normalize_weights_abs(out["weights"], batch["mask"], shard)
    port = stock_sum(nw * batch["returns"] * batch["mask"], -1, shard)
    return {
        "loss": out["loss"],
        "loss_unc": out["loss_unconditional"],
        "loss_cond": out["loss_conditional"],
        "sharpe": sharpe(port, ddof=1),
        "portfolio_returns": port,
    }
