"""The 3-phase GAN trainer: a Python loop over epochs per phase, in
segments, with a divergence guard and a resumable state.

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

**Segments.** Each phase runs in ``checkpoint_every``-sized segments (one
segment, the rest of the phase, without it); segment ``[e, e+k)`` uses
epochs ``e..e+k-1`` of the phase's one ``phase_epoch_seeds`` draw and the
same absolute epoch indices (eligibility, diagnostics stride), so a
segmented run is bit for bit a whole one. ``stop_after_epochs`` caps the
epochs of one invocation at a segment boundary.

**Divergence guard** (``reliability/guard.py``). Before each segment the
trainer snapshots the rollback point: the live params, both optimizers'
moments and step counts, and the phase's :class:`Best`. After it, the
``trainer/epoch_loop`` fault site fires (``nan_loss`` poisons the live
params and the segment's train loss, as the JAX trainer does), and a
segment whose loss or gradient-norm series holds a non-finite value is
rolled back — copied back **in place**, so the optimizers keep stepping
the same tensors — and retried; ``guard_max_trips`` consecutive trips
raise :class:`DivergenceError` before any checkpoint of that phase is
written. The trips land in ``history.npz`` (``divergence_trips``, [n, 3]
f32) and ``health.json``.

**Resume.** With a ``save_dir``, a resumable state is written at every
phase boundary and at each interior segment boundary: params, both
optimizers' moments and step counts, ``best1`` (and mid-phase the running
phase's ``Best`` with its update flags), the history so far and the
partial phase history — ``resume_state.pt`` through the verified writer,
paired with ``resume_meta.json`` by ``state_sha256``. A torn newest pair
falls back one generation; nothing usable starts fresh. The meta carries
the JAX keys plus the port's route (``kernel``, ``compute_dtype``,
``device``): the routes differ in summation order, so a continuation on
another route is refused, as is one with another schedule, model, seed or
``diag_stride``. A finished run clears every generation. The
``trainer/phase_boundary`` fault site fires after each phase's boundary
save (phase 3's before the state clears), as in the JAX trainer: a
supervisor that restarts a run killed or hung there appends ``--resume``.

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

Telemetry: the ``epochs_dispatched`` and ``guard/trip`` counters and the
``phase/*`` spans go to the trainer's ``EventLog``; a heartbeat at each
phase start, with a device-memory snapshot at each segment end and at
``finalize``; one ``metrics.jsonl`` row per epoch, tagged with the run id
(truncated on a fresh run; a resumed run appends only its own phases).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.gan import GAN, Batch
from ..models.networks import AssetPricingModule, init_params
from ..observability.events import EventLog
from ..observability.heartbeat import Heartbeat
from ..observability.logging import RunLogger
from ..observability.memory import device_memory_snapshot, log_memory
from ..observability.modelhealth import compute_health, write_health
from ..ops.diagnostics import SCALAR_KEYS, diagnostics_members
from ..ops.metrics import (
    cross_sectional_r2,
    explained_variation,
    factor_betas,
    max_drawdown,
)
from ..reliability import verified
from ..reliability.faults import inject
from ..reliability.guard import DivergenceError, segment_nonfinite
from ..utils.config import ExecutionConfig, GANConfig, TrainConfig
from ..utils.rng import phase_epoch_seeds
from .checkpoint import save_history, save_state_dict
from .steps import Optimizer, eval_step, subtree_params, train_step

StateDict = Dict[str, torch.Tensor]

# history keys of the sdf phases (phase 2's rows do not join history.npz)
HISTORY_KEYS = ("train_loss", "train_sharpe", "grad_norm", "valid_loss",
                "valid_sharpe", "test_loss", "test_sharpe")
MOMENT_KEYS = ("train_loss", "train_loss_cond")
PHASE_SECTIONS = {
    "unconditional": "phase1_unconditional",
    "moment": "phase2_moment",
    "conditional": "phase3_conditional",
}
PHASE_NUMBERS = {"unconditional": 1, "moment": 2, "conditional": 3}
PHASE_LABELS = {"unconditional": "unc", "moment": "moment",
                "conditional": "cond"}
RESUME_STATE = "resume_state.pt"
RESUME_META = "resume_meta.json"


@dataclasses.dataclass
class Best:
    """A phase's best tracker; params fields start as the entry params."""

    loss: float
    sharpe: float
    params_loss: StateDict
    params_sharpe: StateDict
    updated_loss: bool = False
    updated_sharpe: bool = False

    def restore(self, other: "Best") -> None:
        """Take `other`'s fields, keeping this object (the caller's
        reference): the guard's rollback."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(other, f.name))


def _concat_hists(hists: List[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Per-segment stacked histories joined along the epoch axis."""
    return {k: np.concatenate([h[k] for h in hists], axis=0)
            for k in hists[0]}


class Trainer:
    """Runs the three phases of one model; owns checkpoint/history IO."""

    def __init__(self, gan: GAN, tcfg: TrainConfig, has_test: bool = True,
                 diag_stride: Optional[int] = None,
                 events: Optional[EventLog] = None,
                 heartbeat: Optional[Heartbeat] = None,
                 divergence_guard: bool = True, guard_max_trips: int = 3):
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
        # telemetry sinks: a sinkless log still times the phase spans
        self.events = events if events is not None else EventLog()
        self.hb = heartbeat
        self.divergence_guard = divergence_guard
        self.guard_max_trips = guard_max_trips
        self.divergence_trips: List[tuple] = []  # (phase_no, start, end)
        # True after a train() that stopped on its stop_after_epochs budget:
        # the returned params are the running ones, not a best selection
        self.stopped_midphase = False
        # wall seconds and epochs run (retried segments included) of each
        # phase in this invocation
        self.phase_seconds: Dict[str, float] = {}
        self.phase_epochs: Dict[str, int] = {}

    # -- parameters ------------------------------------------------------------

    def snapshot(self) -> StateDict:
        return {k: v.detach().clone()
                for k, v in self.gan.module.state_dict().items()}

    @torch.no_grad()
    def load(self, params: StateDict) -> None:
        """Copy `params` into the live parameters in place."""
        for k, v in self.gan.module.state_dict().items():
            v.copy_(params[k])

    @staticmethod
    def opt_state(opt: Optimizer) -> Dict[str, Any]:
        """Copies of an optimizer's moments and its step count."""
        return {"mu": [m.detach().clone() for m in opt.mu],
                "nu": [n.detach().clone() for n in opt.nu],
                "count": int(opt.count)}

    @staticmethod
    @torch.no_grad()
    def set_opt_state(opt: Optimizer, state: Dict[str, Any]) -> None:
        """Copy a saved state into the optimizer's own tensors in place
        (the step count sets Adam's bias correction)."""
        for dst, src in zip(opt.mu + opt.nu, state["mu"] + state["nu"]):
            dst.copy_(src)
        opt.count = int(state["count"])

    @torch.no_grad()
    def _poison(self) -> None:
        """The ``nan_loss`` fault: every live float parameter times NaN."""
        for v in self.gan.module.state_dict().values():
            if v.is_floating_point():
                v.mul_(float("nan"))

    def diag_keys(self) -> tuple:
        """The ``diag_*`` history fields of this trainer (empty without
        diagnostics): one per :data:`ops.diagnostics.SCALAR_KEYS` and the
        [K]-vector ``diag_moment_violations``."""
        if not self.diag_stride:
            return ()
        return tuple(f"diag_{k}" for k in SCALAR_KEYS) + (
            "diag_moment_violations",)

    def history_state_keys(self) -> tuple:
        return HISTORY_KEYS + self.diag_keys()

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

    def _beat(self, section: str, memory: bool = False) -> None:
        """Phase-tagged liveness (+ optional device-memory snapshot)."""
        if self.hb is not None:
            self.hb.beat(section, memory=memory)
        elif memory and self.events.enabled:
            log_memory(self.events, section=section)

    # -- one phase -------------------------------------------------------------

    def _epochs(self, phase: str, seeds: List[int], start: int, batches,
                best: Best) -> List[list]:
        """Epochs ``start .. start + len(seeds) - 1`` of one phase (the
        absolute indices decide eligibility and the diagnostics stride);
        `best` is updated in place. Returns the epochs' rows."""
        train_b, valid_b, test_b = batches
        opt = self.opt_moment if phase == "moment" else self.opt_sdf
        loss_key = "loss_unc" if phase == "unconditional" else "loss_cond"
        stride = self.diag_stride if phase != "moment" else None
        n_diag = len(SCALAR_KEYS) + self.gan.cfg.num_condition_moment
        rows = []
        for epoch, seed in enumerate(seeds, start):
            tr = train_step(self.gan, phase, opt, train_b, seed)
            if phase == "moment":
                # no per-epoch evals; select the HIGHEST train loss_cond
                loss, loss_cond = torch.stack(
                    [tr["loss"], tr["loss_cond"]]).tolist()
                if loss_cond > best.loss:
                    best.loss, best.params_loss = loss_cond, self.snapshot()
                    best.updated_loss = True
                rows.append([loss, loss_cond])
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
        return rows

    def _stack(self, phase: str, rows: List[list]) -> Dict[str, np.ndarray]:
        """Rows of one phase as its stacked history (f32 [E] series, and
        the [E, K] ``diag_moment_violations`` under diagnostics)."""
        stride = self.diag_stride if phase != "moment" else None
        keys = (MOMENT_KEYS if phase == "moment"
                else HISTORY_KEYS + (self.diag_keys()[:-1] if stride else ()))
        width = len(keys) + (self.gan.cfg.num_condition_moment if stride
                             else 0)
        arr = np.asarray(rows, np.float32).reshape(len(rows), width)
        out = {k: arr[:, i] for i, k in enumerate(keys)}
        if stride:
            out["diag_moment_violations"] = arr[:, len(keys):]
        return out

    def run_phase(self, phase: str, seeds: List[int], batches, best: Best,
                  start_epoch: int = 0,
                  partial: Optional[Dict[str, np.ndarray]] = None,
                  checkpoint_every: Optional[int] = None,
                  midphase_save: Optional[Callable] = None,
                  budget: Optional[list] = None):
        """Epochs ``[start_epoch, len(seeds))`` of one phase (`seeds`: the
        whole phase's per-epoch seeds), in `checkpoint_every`-sized
        segments under the divergence guard, with
        ``midphase_save(epochs_done, best, hist_so_far)`` at each interior
        boundary. `budget`: a one-element list of epochs this invocation
        may still run, decremented in place; the phase stops at a segment
        boundary when it runs out.

        Returns ``(hist, epochs_done, stopped)``: the stacked history of
        epochs ``[0, epochs_done)``, the resumed `partial` prefix
        included."""
        section = PHASE_SECTIONS[phase]
        self._beat(section)
        total = len(seeds)
        hists = [partial] if partial is not None else [self._stack(phase, [])]
        seg = checkpoint_every if checkpoint_every and checkpoint_every > 0 \
            else None
        e, trips, stopped, n_run = start_epoch, 0, False, 0
        t0 = time.perf_counter()
        while e < total:
            if budget is not None and budget[0] <= 0:
                stopped = True
                break
            k = total - e if seg is None else min(seg, total - e)
            if budget is not None:
                k = min(k, budget[0])
            if self.divergence_guard:
                # the rollback point, copied: the segment updates the live
                # tensors and the tracker in place
                rollback = (self.snapshot(), self.opt_state(self.opt_sdf),
                            self.opt_state(self.opt_moment),
                            dataclasses.replace(best))
            h = self._stack(phase, self._epochs(phase, seeds[e:e + k], e,
                                                batches, best))
            n_run += k
            # fault site: nan_loss poisons this segment's outputs (the
            # guard's exercise path); raise/kill die here
            if inject("trainer/epoch_loop", phase=section,
                      epochs_done=e + k) == "nan_loss":
                self._poison()
                h["train_loss"] = np.full_like(h["train_loss"], np.nan)
            if self.divergence_guard and segment_nonfinite(h):
                trips += 1
                self.divergence_trips.append((PHASE_NUMBERS[phase], e, e + k))
                self.events.counter("guard/trip", phase=section,
                                    start_epoch=e, end_epoch=e + k,
                                    consecutive=trips)
                if trips >= self.guard_max_trips:
                    self.events.log(
                        f"divergence guard: non-finite loss/grads in "
                        f"{section} epochs [{e}, {e + k}) persisted through "
                        f"{trips} consecutive attempts; aborting",
                        level="error")
                    raise DivergenceError(
                        f"{section}: non-finite loss/grads in epochs "
                        f"[{e}, {e + k}) after {trips} consecutive "
                        f"attempts — aborting instead of writing NaN "
                        f"checkpoints (last good state: epoch {e})")
                params, opt_sdf, opt_moment, saved = rollback
                self.load(params)
                self.set_opt_state(self.opt_sdf, opt_sdf)
                self.set_opt_state(self.opt_moment, opt_moment)
                best.restore(saved)
                continue
            trips = 0
            hists.append(h)
            e += k
            self.events.counter("epochs_dispatched", value=k, phase=section,
                                epochs_done=e)
            # a host-side counter read, never a device sync
            self._beat(section, memory=True)
            if budget is not None:
                budget[0] -= k
            if midphase_save is not None and e < total:
                midphase_save(e, best, _concat_hists(hists))
        self.phase_seconds[section] = time.perf_counter() - t0
        self.phase_epochs[section] = n_run
        return _concat_hists(hists), e, stopped

    # -- the 3-phase schedule ----------------------------------------------------

    def train(self, train_b: Batch, valid_b: Batch,
              test_b: Optional[Batch] = None, save_dir: Optional[str] = None,
              verbose: bool = True, seed: Optional[int] = None,
              resume: bool = False, stop_after_phase: Optional[int] = None,
              checkpoint_every: Optional[int] = None,
              stop_after_epochs: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
        """Run phases 1-3; the module ends holding the final params (the
        running params after a ``stop_after_epochs`` stop). Returns the
        history (sdf phases only, with a ``phase`` label).

        `resume` (requires `save_dir`): continue from the last resume point
        recorded there — a phase boundary, or a mid-phase segment boundary
        — bit for bit an uninterrupted run. `checkpoint_every` (with a
        `save_dir`): segments of this many epochs, with a resumable state
        after each. `stop_after_epochs`: run at most this many more epochs
        in this invocation (checked at segment boundaries), persist the
        mid-phase state and return. `stop_after_phase` ends the run after
        that phase's boundary state."""
        tcfg = self.tcfg
        seed = tcfg.seed if seed is None else seed
        if stop_after_epochs is not None and not save_dir:
            raise ValueError(
                "stop_after_epochs requires save_dir — without it the "
                "mid-phase state cannot be persisted and the partial "
                "training would be unrecoverable")
        if stop_after_epochs is not None and stop_after_epochs <= 0:
            raise ValueError(
                f"stop_after_epochs must be positive, got {stop_after_epochs}")
        if resume and not save_dir:
            raise ValueError("resume=True requires save_dir")
        self.stopped_midphase = False
        self.divergence_trips = []
        prep = self.gan.prepare_batch
        batches = (prep(train_b), prep(valid_b),
                   prep(test_b if test_b is not None else valid_b))
        seeds = phase_epoch_seeds(seed, [tcfg.num_epochs_unc,
                                         tcfg.num_epochs_moment,
                                         tcfg.num_epochs])
        save = Path(save_dir) if save_dir else None
        seg = checkpoint_every if save is not None else None
        history: Dict[str, list] = {
            k: [] for k in self.history_state_keys() + ("phase",)}
        logger = RunLogger(self.events, verbose=verbose)
        log = logger.info
        t0 = time.perf_counter()

        completed, in_phase, e_in = 0, 0, 0
        best_loaded, partial, best1 = None, None, None
        resumed = False
        if resume:
            loaded = self._load_resume(save, seed)
            if loaded is not None:
                (completed, best1, history, in_phase, e_in, best_loaded,
                 partial) = loaded
                resumed = True
                where = (f"mid-phase {in_phase} at epoch {e_in}" if in_phase
                         else f"after phase {completed}")
                log(f"Resuming {where} ({len(history['train_loss'])} epochs "
                    "of completed history)")
        budget = [stop_after_epochs] if stop_after_epochs is not None else None
        if save is not None and not resumed:
            # a fresh run: a stale log must not double-count epochs
            open(save / "metrics.jsonl", "w").close()

        def saver(phase_no):
            """The mid-phase state writer of phase `phase_no`: for phase 1
            the running tracker IS best1; phases 2/3 keep the final phase-1
            tracker beside their own."""
            if save is None:
                return None

            def midphase_save(e, best, hist_so_far):
                self._save_resume(
                    save, phase_no - 1, best if phase_no == 1 else best1,
                    history, seed, in_phase=phase_no, epochs_in_phase=e,
                    best_phase=best, partial_hist=hist_so_far)

            return midphase_save

        def run(phase, best):
            no = PHASE_NUMBERS[phase]
            start = e_in if in_phase == no else 0
            with self.events.span(f"phase/{PHASE_SECTIONS[phase]}",
                                  epochs=len(seeds[no - 1]),
                                  start_epoch=start):
                h, e_done, stopped = self.run_phase(
                    phase, seeds[no - 1], batches, best, start_epoch=start,
                    partial=partial if in_phase == no else None,
                    checkpoint_every=seg, midphase_save=saver(no),
                    budget=budget)
            if stopped:
                self.stopped_midphase = True
                log(f"Stopping mid-phase {no} at epoch {e_done} "
                    "(stop_after_epochs); resumable state saved — the "
                    "returned params are the RUNNING state, not a "
                    "best-model selection")
            elif save is not None:
                self._write_jsonl(save, h, PHASE_LABELS[phase])
            return h, stopped

        def result():
            return {k: np.asarray(v) for k, v in history.items()}

        # ---- phase 1: sdf on the unconditional loss ----
        if completed < 1:
            log(f"PHASE 1 (unconditional): {tcfg.num_epochs_unc} epochs"
                + (f" (resuming at {e_in})" if in_phase == 1 else ""))
            best1 = best_loaded if in_phase == 1 else self.fresh_best()
            h1, stopped = run("unconditional", best1)
            if stopped:
                return result()
            self._append(history, h1, "unc")
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
                self._save_resume(save, 1, best1, history, seed)
            inject("trainer/phase_boundary", phase=1)
            log(f"Phase 1 done in {time.perf_counter() - t0:.1f}s; best "
                f"valid sharpe {best1.sharpe:.4f}")
        if stop_after_phase == 1:
            log("Stopping after phase 1 (stop_after_phase)")
            return result()

        # ---- phase 2: the moment net maximizes the conditional loss ----
        if completed < 2 and tcfg.num_epochs_moment > 0:
            log(f"PHASE 2 (moment update): {tcfg.num_epochs_moment} epochs"
                + (f" (resuming at {e_in})" if in_phase == 2 else ""))
            best2 = (best_loaded if in_phase == 2
                     else self.fresh_best(for_moment=True))
            _, stopped = run("moment", best2)
            if stopped:
                return result()
            if save is not None:
                if best2.updated_loss:
                    save_state_dict(save / "best_model_loss.pt",
                                    best2.params_loss)
                self._save_resume(save, 2, best1, history, seed)
            inject("trainer/phase_boundary", phase=2)
            log(f"Phase 2 done; best train cond loss {best2.loss:.6f}")
            # phase 3 continues from the LAST-epoch moment params
        if stop_after_phase == 2:
            log("Stopping after phase 2 (stop_after_phase)")
            return result()

        # ---- phase 3: sdf on the conditional loss ----
        log(f"PHASE 3 (conditional): {tcfg.num_epochs} epochs"
            + (f" (resuming at {e_in})" if in_phase == 3 else ""))
        best3 = best_loaded if in_phase == 3 else self.fresh_best()
        h3, stopped = run("conditional", best3)
        if stopped:
            return result()
        self._append(history, h3, "cond")
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
            self._save_history(save, history)
            self.write_health(save, final, batches[1], history, log)
            # the boundary's fault site BEFORE the resume state clears: a
            # kill here restarts with --resume from the phase-2 boundary
            # and rewrites the same final files
            inject("trainer/phase_boundary", phase=3)
            self._clear_resume(save)
        else:
            inject("trainer/phase_boundary", phase=3)
        # the final boundary: liveness and the run's closing memory marks
        self._beat("finalize", memory=True)
        log(f"Training complete in {time.perf_counter() - t0:.1f}s "
            f"({tcfg.num_epochs_unc}+{tcfg.num_epochs_moment}+"
            f"{tcfg.num_epochs} epochs)")
        return result()

    def _append(self, history, h, label: str) -> None:
        for k in self.history_state_keys():
            history[k].extend(h[k].tolist())
        history["phase"].extend([label] * len(h["train_loss"]))

    def _save_history(self, save: Path, history) -> None:
        """``history.npz``; the divergence-guard trips ride along as a
        [n, 3] f32 (phase_no, start_epoch, end_epoch) array when any
        occurred."""
        arrays = dict(history)
        if self.divergence_trips:
            arrays["divergence_trips"] = np.asarray(self.divergence_trips,
                                                    np.float32)
        save_history(save, arrays)

    def write_health(self, save: Path, params: StateDict, valid_b: Batch,
                     history, log) -> None:
        """``health.json`` of `params` on the valid batch
        (``observability/modelhealth.py``), with the divergence-guard
        trips. Unlike the JAX trainer, which swallows every exception here,
        only the write's ``OSError`` is logged and passed over: an error of
        the diagnostics pass itself (a kernel that fails to launch)
        propagates."""
        health = compute_health(self.gan, params, valid_b, history=history,
                                guard_trips=self.divergence_trips,
                                diag_stride=self.diag_stride)
        try:
            write_health(save, health)
        except OSError as e:
            log(f"health.json write failed ({e}); run artifacts are "
                "unaffected")
            return
        self.events.counter(
            "health/written", finite=health["finite"],
            moment_violation_max=health["diagnostics"].get(
                "moment_violation_max"),
            guard_trips=health["guard_trips"])

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

    # -- observability --------------------------------------------------------

    def _write_jsonl(self, save: Path, hist, label: str) -> None:
        """One ``metrics.jsonl`` row per epoch of a finished phase, tagged
        with the run id, appended phase by phase (a crash keeps what was
        logged; a resumed run appends only its own phases). Only scalar
        series land in rows."""
        n = len(hist["train_loss"])
        with open(save / "metrics.jsonl", "a") as f:
            for e in range(n):
                f.write(json.dumps(
                    {"phase": label, "epoch": e, "run_id": self.events.run_id,
                     **{k: float(v[e]) for k, v in hist.items()
                        if v.ndim == 1}}) + "\n")

    def epoch_ms(self) -> Dict[str, float]:
        """Wall ms per epoch of each phase that ran epochs in this
        invocation."""
        return {k: 1e3 * v / self.phase_epochs[k]
                for k, v in self.phase_seconds.items()
                if self.phase_epochs.get(k)}

    def timings(self) -> Dict[str, Any]:
        """Per-phase wall seconds and ms per epoch, and the device memory
        (``{"n_devices", "totals", "per_device"}``): written into
        ``final_metrics.json`` by the CLI."""
        return {"phase_execute_seconds": dict(self.phase_seconds),
                "epoch_ms": self.epoch_ms(),
                "device_memory": device_memory_snapshot()}

    # -- the resumable state --------------------------------------------------

    def _route(self) -> Dict[str, str]:
        """The execution route a continuation must share: the kernel
        setting, the compute dtype and the device type."""
        ec = self.gan.exec_cfg
        return {"kernel": ec.kernel, "compute_dtype": ec.compute_dtype,
                "device": next(self.gan.module.parameters()).device.type}

    @staticmethod
    def _best_state(best: Best) -> Dict[str, Any]:
        cpu = lambda sd: {k: v.cpu() for k, v in sd.items()}  # noqa: E731
        return {"loss": float(best.loss), "sharpe": float(best.sharpe),
                "params_loss": cpu(best.params_loss),
                "params_sharpe": cpu(best.params_sharpe),
                "updated_loss": bool(best.updated_loss),
                "updated_sharpe": bool(best.updated_sharpe)}

    def _save_resume(self, save: Path, completed_phase: int, best1: Best,
                     history, seed: int, in_phase: int = 0,
                     epochs_in_phase: int = 0,
                     best_phase: Optional[Best] = None,
                     partial_hist: Optional[Dict[str, np.ndarray]] = None
                     ) -> None:
        """Everything a later process needs to continue from here: at a
        phase boundary (``in_phase`` 0) the params, both optimizers, the
        phase-1 tracker and the history so far; mid-phase also the running
        phase's tracker and its partial history over epochs
        ``[0, epochs_in_phase)``. The state's sha256 is embedded in the
        meta, binding the two files: a kill between the two writes leaves
        an unmatched pair that the load skips for the ``.g1`` one."""
        cpu_opt = lambda o: {**o, "mu": [m.cpu() for m in o["mu"]],  # noqa: E731
                             "nu": [n.cpu() for n in o["nu"]]}
        state = {
            "params": {k: v.cpu() for k, v in self.snapshot().items()},
            "opt_sdf": cpu_opt(self.opt_state(self.opt_sdf)),
            "opt_moment": cpu_opt(self.opt_state(self.opt_moment)),
            "best1": self._best_state(best1),
            "history": {k: torch.from_numpy(np.asarray(history[k],
                                                       np.float32))
                        for k in self.history_state_keys()},
        }
        if in_phase:
            state["best_phase"] = self._best_state(best_phase)
            state["partial_hist"] = {k: torch.from_numpy(np.array(v))
                                     for k, v in partial_hist.items()}
        buf = io.BytesIO()
        torch.save(state, buf)
        state_sha = verified.write_verified(save / RESUME_STATE,
                                            buf.getvalue())
        meta = {
            "completed_phase": completed_phase,
            "seed": int(seed),
            "tcfg": dataclasses.asdict(self.tcfg),
            "gan_config": self.gan.cfg.to_dict(),
            "history_phases": list(history["phase"]),
            "in_phase": int(in_phase),
            "epochs_in_phase": int(epochs_in_phase),
            "partial_hist_keys": sorted(partial_hist) if in_phase else [],
            # the JAX package's shared phase-1/3 XLA program has no
            # counterpart here: every run is on the dedicated route
            "share_sdf_program": False,
            # diag fields change the history schema: a continuation must
            # keep the same setting
            "diag_stride": self.diag_stride,
            **self._route(),
            "state_sha256": state_sha,
        }
        verified.write_verified(save / RESUME_META,
                                json.dumps(meta).encode("utf-8"))

    def _clear_resume(self, save: Path) -> None:
        """A finished run leaves nothing to resume (all generations)."""
        verified.clear_generations(save / RESUME_STATE)
        verified.clear_generations(save / RESUME_META)

    def _read_resume(self, save: Path):
        """The newest (meta, state bytes) pair whose digests verify and
        whose state matches the meta's ``state_sha256``, a torn newest
        pair falling back one generation (``checkpoint/fallback``); None
        when no meta exists; a warning, ``checkpoint/unusable`` and None
        when nothing is usable."""
        meta_path, state_path = save / RESUME_META, save / RESUME_STATE
        metas = [p for p in verified.generation_candidates(meta_path)
                 if p.exists()]
        if not metas:
            return None
        errors = []
        for mp in metas:
            raw = mp.read_bytes()
            ok, why = verified.check_digest(mp, raw)
            if not ok:
                errors.append(f"{mp.name}: {why}")
                continue
            try:
                meta = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, ValueError) as e:
                errors.append(f"{mp.name}: {e}")
                continue
            for sp in verified.generation_candidates(state_path):
                if not sp.exists():
                    continue
                data = sp.read_bytes()
                ok, why = verified.check_digest(sp, data)
                if not ok:
                    errors.append(f"{sp.name}: {why}")
                    continue
                if hashlib.sha256(data).hexdigest() != meta.get(
                        "state_sha256"):
                    errors.append(f"{sp.name}: does not pair with "
                                  f"{mp.name} (state_sha256 mismatch)")
                    continue
                if mp != meta_path or sp != state_path:
                    self.events.counter("checkpoint/fallback",
                                        path=str(state_path),
                                        errors="; ".join(errors))
                return meta, data
        warnings.warn(
            f"resume state in {save} unusable "
            f"({'; '.join(errors) or 'no state file'}); starting from "
            "scratch — the rerun converges to identical final artifacts",
            stacklevel=3)
        self.events.counter("checkpoint/unusable", path=str(state_path),
                            errors=len(errors))
        return None

    def _load_resume(self, save: Path, seed: int):
        """Load the resumable state into the live params and optimizers (in
        place) and return ``(completed_phase, best1, history, in_phase,
        epochs_in_phase, best_phase, partial_hist)``, or None when there
        is nothing usable. A state written for another schedule, model,
        seed, ``diag_stride`` or route raises ``ValueError``."""
        found = self._read_resume(save)
        if found is None:
            return None
        meta, data = found
        current = dataclasses.asdict(self.tcfg)
        for field, saved in meta["tcfg"].items():
            if current.get(field) != saved:
                raise ValueError(
                    f"resume state tcfg.{field}={saved} does not match the "
                    f"current value {current.get(field)}")
        if meta["gan_config"] != self.gan.cfg.to_dict():
            raise ValueError("resume state model config does not match the "
                             "current GANConfig")
        if meta["seed"] != int(seed):
            raise ValueError(f"resume state seed={meta['seed']} does not "
                             f"match the requested seed {seed}")
        if meta.get("diag_stride") != self.diag_stride:
            raise ValueError(
                f"resume state diag_stride={meta.get('diag_stride')} does "
                f"not match {self.diag_stride}: the history schema would "
                "change mid-run")
        for key, value in self._route().items():
            if meta.get(key) != value:
                raise ValueError(
                    f"resume state {key}={meta.get(key)!r} does not match "
                    f"the current {value!r}: the routes differ in summation "
                    "order, so the continuation would not be bit for bit")
        dev = next(self.gan.module.parameters()).device
        try:
            state = torch.load(io.BytesIO(data), map_location=dev,
                               weights_only=True)
        except Exception as e:  # noqa: BLE001 — any deserialization failure
            raise ValueError(
                f"corrupt resume state in {save} (digest verified but "
                f"torch.load failed): {type(e).__name__}: {e}") from e
        self.load(state["params"])
        self.set_opt_state(self.opt_sdf, state["opt_sdf"])
        self.set_opt_state(self.opt_moment, state["opt_moment"])
        history = {k: v.tolist() for k, v in state["history"].items()}
        history["phase"] = list(meta["history_phases"])
        in_phase = int(meta["in_phase"])
        best_phase = partial = None
        if in_phase:
            best_phase = Best(**state["best_phase"])
            partial = {k: v.cpu().numpy()
                       for k, v in state["partial_hist"].items()}
        return (int(meta["completed_phase"]), Best(**state["best1"]),
                history, in_phase, int(meta["epochs_in_phase"]), best_phase,
                partial)

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
                 diag_stride: Optional[int] = None,
                 resume: bool = False,
                 stop_after_phase: Optional[int] = None,
                 checkpoint_every: Optional[int] = None,
                 stop_after_epochs: Optional[int] = None,
                 events: Optional[EventLog] = None,
                 heartbeat: Optional[Heartbeat] = None,
                 divergence_guard: bool = True, guard_max_trips: int = 3):
    """The functional front door: (gan, final state_dict, history, trainer).

    The model is initialized from ``torch.Generator().manual_seed(seed)``
    (or from `state_dict`, e.g. the JAX package's params through
    ``checkpoint.state_dict_from_jax_params``) on the batches' device.
    `diag_stride`: the model-health diagnostics every that many epochs;
    `resume`, `stop_after_phase`, `checkpoint_every`, `stop_after_epochs`:
    see :meth:`Trainer.train`; `events`/`heartbeat`: the telemetry sinks
    the CLIs create; `divergence_guard`/`guard_max_trips`: the non-finite
    segment check (on by default; outputs are bit for bit the same with it
    on or off). See the module docstring."""
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
                      diag_stride=diag_stride, events=events,
                      heartbeat=heartbeat, divergence_guard=divergence_guard,
                      guard_max_trips=guard_max_trips)
    history = trainer.train(train_b, valid_b, test_b, save_dir=save_dir,
                            verbose=verbose, seed=seed, resume=resume,
                            stop_after_phase=stop_after_phase,
                            checkpoint_every=checkpoint_every,
                            stop_after_epochs=stop_after_epochs)
    return gan, trainer.snapshot(), history, trainer
