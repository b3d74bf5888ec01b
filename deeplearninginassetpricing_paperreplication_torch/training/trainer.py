"""The 3-phase GAN trainer: a Python loop over epochs per phase.

The counterpart of the JAX package's ``training/trainer.py`` (``Trainer``,
``train_3phase``), with its selection rules:

* best-by-valid-loss and best-by-valid-sharpe are tracked independently,
  only for epochs with index > ignore_epoch (strict);
* phase 1 selects on valid ``loss_unc``, phase 3 on valid ``loss_cond``;
* phase 2 has no evals; it tracks the highest train ``loss_cond`` for the
  loss checkpoint and hands its LAST-epoch moment params to phase 3;
* the best-sharpe params are reloaded after phase 1, and after phase 3
  through the chain phase-3 best → phase-1 best → running params;
* the sdf Adam state carries from phase 1 into phase 3: best params are
  copied into the live parameters in place, so the optimizer keeps its
  state on the same tensors.

Eager PyTorch runs each epoch as it comes (there is no ``lax.scan``
counterpart); the host syncs once per epoch, when the epoch's metrics are
read. Checkpoints are reference-layout ``state_dict``s, saved on update
only, as the JAX package does.

``diag_stride`` k adds the model-health diagnostics (``ops/diagnostics.py``)
of the valid batch after the train step of every phase-1 and phase-3 epoch
with ``epoch % k == 0`` (phase-local epochs), read in the epoch's one host
sync; off-stride rows are zeros with ``diag_computed`` 0. They land in the
history as ``diag_<key>`` series and a [E, K] ``diag_moment_violations``.
The diagnostics read the parameters and never feed them, and draw from no
generator, so params, best checkpoints and every other history series are
bit for bit those of a run without them. A run with a ``save_dir`` ends by
writing ``health.json`` on the final params and the valid batch, whatever
the stride.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.gan import GAN, Batch
from ..models.networks import AssetPricingModule, init_params
from ..observability.modelhealth import compute_health, write_health
from ..ops.diagnostics import SCALAR_KEYS, diagnostics_members
from ..ops.metrics import (
    cross_sectional_r2,
    explained_variation,
    factor_betas,
    max_drawdown,
)
from ..utils.config import ExecutionConfig, GANConfig, TrainConfig
from ..utils.rng import phase_epoch_seeds
from .checkpoint import save_history, save_state_dict
from .steps import Optimizer, eval_step, subtree_params, train_step

StateDict = Dict[str, torch.Tensor]

# history keys of the sdf phases (phase 2's rows do not join history.npz)
HISTORY_KEYS = ("train_loss", "train_sharpe", "grad_norm", "valid_loss",
                "valid_sharpe", "test_loss", "test_sharpe")
PHASE_SECTIONS = {
    "unconditional": "phase1_unconditional",
    "moment": "phase2_moment",
    "conditional": "phase3_conditional",
}


@dataclasses.dataclass
class Best:
    """A phase's best tracker; params fields start as the entry params."""

    loss: float
    sharpe: float
    params_loss: StateDict
    params_sharpe: StateDict
    updated_loss: bool = False
    updated_sharpe: bool = False


class Trainer:
    """Runs the three phases of one model; owns checkpoint/history IO."""

    def __init__(self, gan: GAN, tcfg: TrainConfig, has_test: bool = True,
                 diag_stride: Optional[int] = None):
        self.gan = gan
        self.tcfg = tcfg
        self.has_test = has_test
        # None or a stride < 1: no diagnostics
        self.diag_stride = (int(diag_stride)
                            if diag_stride and int(diag_stride) > 0 else None)
        self.opt_sdf = Optimizer(subtree_params(gan, "sdf_net"), tcfg.lr,
                                 tcfg.grad_clip)
        self.opt_moment = Optimizer(subtree_params(gan, "moment_net"),
                                    tcfg.lr, tcfg.grad_clip)
        self.phase_seconds: Dict[str, float] = {}

    # -- parameters ------------------------------------------------------------

    def snapshot(self) -> StateDict:
        return {k: v.detach().clone()
                for k, v in self.gan.module.state_dict().items()}

    @torch.no_grad()
    def load(self, params: StateDict) -> None:
        """Copy `params` into the live parameters in place."""
        for k, v in self.gan.module.state_dict().items():
            v.copy_(params[k])

    def diag_keys(self) -> tuple:
        """The ``diag_*`` history fields of this trainer (empty without
        diagnostics): one per :data:`ops.diagnostics.SCALAR_KEYS` and the
        [K]-vector ``diag_moment_violations``."""
        if not self.diag_stride:
            return ()
        return tuple(f"diag_{k}" for k in SCALAR_KEYS) + (
            "diag_moment_violations",)

    def diagnostics(self, batch: Batch) -> torch.Tensor:
        """The diagnostics of the live params on `batch` as one f32 vector
        (:data:`SCALAR_KEYS`, then the K violations), left on the device."""
        params = {n: p[None] for n, p in self.gan.module.named_parameters()}
        d = diagnostics_members(self.gan, params, batch)
        return torch.cat([torch.stack([d[k][0] for k in SCALAR_KEYS]),
                          d["moment_violations"][0]])

    def fresh_best(self, for_moment: bool = False) -> Best:
        entry = self.snapshot()
        return Best(-np.inf if for_moment else np.inf, -np.inf, entry, entry)

    # -- one phase -------------------------------------------------------------

    def run_phase(self, phase: str, seeds: List[int], batches,
                  best: Best) -> Dict[str, np.ndarray]:
        """Epochs of one phase; returns its stacked history."""
        train_b, valid_b, test_b = batches
        opt = self.opt_moment if phase == "moment" else self.opt_sdf
        loss_key = "loss_unc" if phase == "unconditional" else "loss_cond"
        stride = self.diag_stride if phase != "moment" else None
        n_diag = len(SCALAR_KEYS) + self.gan.cfg.num_condition_moment
        rows = []
        t0 = time.perf_counter()
        for epoch, seed in enumerate(seeds):
            tr = train_step(self.gan, phase, opt, train_b, seed)
            if phase == "moment":
                # no per-epoch evals; select the HIGHEST train loss_cond
                loss, loss_cond = torch.stack(
                    [tr["loss"], tr["loss_cond"]]).tolist()
                if loss_cond > best.loss:
                    best.loss, best.params_loss = loss_cond, self.snapshot()
                    best.updated_loss = True
                rows.append((loss, loss_cond))
                continue
            va = eval_step(self.gan, valid_b)
            te = eval_step(self.gan, test_b) if self.has_test else None
            vals = [tr["loss"], tr["sharpe"], tr["grad_norm"], va[loss_key],
                    va["sharpe"]]
            vals += ([te[loss_key], te["sharpe"]] if te is not None
                     else [torch.zeros_like(tr["loss"])] * 2)
            row = torch.stack(vals)
            if stride and epoch % stride == 0:
                row = torch.cat([row, self.diagnostics(valid_b)])
            row = row.tolist()  # the epoch's one host sync
            if stride and epoch % stride:
                row += [0.0] * n_diag  # off-stride: computed = 0
            eligible = epoch > self.tcfg.ignore_epoch
            if eligible and row[3] < best.loss:
                best.loss, best.params_loss = row[3], self.snapshot()
                best.updated_loss = True
            if eligible and row[4] > best.sharpe:
                best.sharpe, best.params_sharpe = row[4], self.snapshot()
                best.updated_sharpe = True
            rows.append(row)
        self.phase_seconds[PHASE_SECTIONS[phase]] = time.perf_counter() - t0
        keys = (("train_loss", "train_loss_cond") if phase == "moment"
                else HISTORY_KEYS + (self.diag_keys()[:-1] if stride else ()))
        width = len(keys) + (self.gan.cfg.num_condition_moment if stride
                             else 0)
        arr = np.asarray(rows, np.float32).reshape(len(rows), width)
        out = {k: arr[:, i] for i, k in enumerate(keys)}
        if stride:
            out["diag_moment_violations"] = arr[:, len(keys):]
        return out

    # -- the 3-phase schedule ----------------------------------------------------

    def train(self, train_b: Batch, valid_b: Batch,
              test_b: Optional[Batch] = None, save_dir: Optional[str] = None,
              verbose: bool = True, seed: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        """Run phases 1-3; the module ends holding the final params.
        Returns the history (sdf phases only, with a ``phase`` label)."""
        tcfg = self.tcfg
        seed = tcfg.seed if seed is None else seed
        prep = self.gan.prepare_batch
        batches = (prep(train_b), prep(valid_b),
                   prep(test_b if test_b is not None else valid_b))
        seeds = phase_epoch_seeds(seed, [tcfg.num_epochs_unc,
                                         tcfg.num_epochs_moment,
                                         tcfg.num_epochs])
        save = Path(save_dir) if save_dir else None
        history: Dict[str, list] = {
            k: [] for k in HISTORY_KEYS + self.diag_keys() + ("phase",)}
        t0 = time.perf_counter()

        def log(msg):
            if verbose:
                print(msg, flush=True)

        def append(h, label):
            for k in HISTORY_KEYS + self.diag_keys():
                history[k].extend(h[k].tolist())
            history["phase"].extend([label] * len(h["train_loss"]))

        # ---- phase 1: sdf on the unconditional loss ----
        log(f"PHASE 1 (unconditional): {tcfg.num_epochs_unc} epochs")
        best1 = self.fresh_best()
        h1 = self.run_phase("unconditional", seeds[0], batches, best1)
        append(h1, "unc")
        self._print_history(log, h1, 1)
        if best1.updated_sharpe:
            self.load(best1.params_sharpe)
        if save is not None:
            if best1.updated_loss:
                save_state_dict(save / "best_model_loss.pt",
                                best1.params_loss)
            if best1.updated_sharpe:
                save_state_dict(save / "best_model_sharpe.pt",
                                best1.params_sharpe)
        log(f"Phase 1 done in {time.perf_counter() - t0:.1f}s; best valid "
            f"sharpe {best1.sharpe:.4f}")

        # ---- phase 2: the moment net maximizes the conditional loss ----
        if tcfg.num_epochs_moment > 0:
            log(f"PHASE 2 (moment update): {tcfg.num_epochs_moment} epochs")
            best2 = self.fresh_best(for_moment=True)
            self.run_phase("moment", seeds[1], batches, best2)
            if save is not None and best2.updated_loss:
                save_state_dict(save / "best_model_loss.pt",
                                best2.params_loss)
            log(f"Phase 2 done; best train cond loss {best2.loss:.6f}")
            # phase 3 continues from the LAST-epoch moment params

        # ---- phase 3: sdf on the conditional loss ----
        log(f"PHASE 3 (conditional): {tcfg.num_epochs} epochs")
        best3 = self.fresh_best()
        h3 = self.run_phase("conditional", seeds[2], batches, best3)
        append(h3, "cond")
        self._print_history(log, h3, 3)
        if best3.updated_sharpe:
            final = best3.params_sharpe
        elif best1.updated_sharpe:
            final = best1.params_sharpe
        else:
            final = self.snapshot()
        self.load(final)
        if save is not None:
            if best3.updated_loss:
                save_state_dict(save / "best_model_loss.pt",
                                best3.params_loss)
            if best3.updated_sharpe:
                save_state_dict(save / "best_model_sharpe.pt", final)
            save_state_dict(save / "final_model.pt", final)
            save_history(save, history)
            self.write_health(save, final, batches[1], history, log)
        log(f"Training complete in {time.perf_counter() - t0:.1f}s "
            f"({tcfg.num_epochs_unc}+{tcfg.num_epochs_moment}+"
            f"{tcfg.num_epochs} epochs)")
        return {k: np.asarray(v) for k, v in history.items()}

    def write_health(self, save: Path, params: StateDict, valid_b: Batch,
                     history, log) -> None:
        """``health.json`` of `params` on the valid batch
        (``observability/modelhealth.py``). Unlike the JAX trainer, which
        swallows every exception here, only the write's ``OSError`` is
        logged and passed over: an error of the diagnostics pass itself (a
        kernel that fails to launch) propagates."""
        health = compute_health(self.gan, params, valid_b, history=history,
                                guard_trips=[], diag_stride=self.diag_stride)
        try:
            write_health(save, health)
        except OSError as e:
            log(f"health.json write failed ({e}); run artifacts are "
                "unaffected")

    def _print_history(self, log, hist, phase_no: int) -> None:
        n, freq = len(hist["train_loss"]), self.tcfg.print_freq
        for e in range(n):
            if e == 0 or (e + 1) % freq == 0:
                log(f"  [P{phase_no}] epoch {e + 1:4d}/{n} | train loss="
                    f"{hist['train_loss'][e]:.4f} sharpe="
                    f"{hist['train_sharpe'][e]:.2f} | valid loss="
                    f"{hist['valid_loss'][e]:.4f} sharpe="
                    f"{hist['valid_sharpe'][e]:.2f} | test sharpe="
                    f"{hist['test_sharpe'][e]:.2f}")

    def epoch_ms(self) -> Dict[str, float]:
        """Wall ms per epoch of each phase that ran."""
        n = {"phase1_unconditional": self.tcfg.num_epochs_unc,
             "phase2_moment": self.tcfg.num_epochs_moment,
             "phase3_conditional": self.tcfg.num_epochs}
        return {k: 1e3 * v / n[k] for k, v in self.phase_seconds.items()
                if n[k]}

    # -- final evaluation -----------------------------------------------------

    @torch.no_grad()
    def final_eval(self, batch: Batch) -> Dict[str, float]:
        """Eval metrics of the module's current params, plus EV, XS-R² and
        the max drawdown (mean/std of the portfolio with ddof 0)."""
        batch = self.gan.prepare_batch(batch)
        m = eval_step(self.gan, batch)
        port = m.pop("portfolio_returns")
        returns, mask = batch["returns"], batch["mask"]
        betas = factor_betas(returns, port, mask)
        m["explained_variation"] = explained_variation(returns, port, mask,
                                                       betas)
        m["cross_sectional_r2"] = cross_sectional_r2(returns, port, mask,
                                                     betas)
        out = {k: float(v) for k, v in m.items()}
        port = port.cpu().numpy()
        out["max_drawdown"] = max_drawdown(port)
        out["mean_return"] = float(port.mean())
        out["std_return"] = float(port.std())
        return out


def train_3phase(config: GANConfig, train_b: Batch, valid_b: Batch,
                 test_b: Optional[Batch] = None,
                 tcfg: Optional[TrainConfig] = None,
                 save_dir: Optional[str] = None, seed: Optional[int] = None,
                 verbose: bool = True,
                 exec_cfg: Optional[ExecutionConfig] = None,
                 state_dict: Optional[StateDict] = None,
                 diag_stride: Optional[int] = None):
    """The functional front door: (gan, final state_dict, history, trainer).

    The model is initialized from ``torch.Generator().manual_seed(seed)``
    (or from `state_dict`, e.g. the JAX package's params through
    ``checkpoint.state_dict_from_jax_params``) on the batches' device.
    `diag_stride`: the model-health diagnostics every that many epochs (see
    the module docstring)."""
    tcfg = tcfg or TrainConfig()
    seed = tcfg.seed if seed is None else seed
    exec_cfg = exec_cfg or ExecutionConfig()
    module = AssetPricingModule(config, exec_cfg)
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
    else:
        init_params(module, torch.Generator().manual_seed(int(seed)))
    gan = GAN(config, exec_cfg, module.to(train_b["returns"].device))
    if save_dir:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        config.save(Path(save_dir) / "config.json")
    trainer = Trainer(gan, tcfg, has_test=test_b is not None,
                      diag_stride=diag_stride)
    history = trainer.train(train_b, valid_b, test_b, save_dir=save_dir,
                            verbose=verbose, seed=seed)
    return gan, trainer.snapshot(), history, trainer
