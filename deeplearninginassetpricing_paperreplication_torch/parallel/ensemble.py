"""Multi-seed ensembles over a leading member axis: training and
paper-protocol evaluation.

The counterpart of the JAX package's ``parallel/ensemble.py``. The members'
parameters are stacked on an explicit leading axis [S, ...] (where JAX
vmaps), the macro LSTMs of all members run together, and every SDF-FFN and
conditional-EM pass of all members is ONE fused-kernel launch over one
panel read (never a Python loop over members).

Training (:func:`train_ensemble`, through the runner :func:`train_members`
that the sweep's buckets share) runs the 3-phase schedule of
``training/trainer.py`` for S seeds at once, with its selection rules kept
per member: best-by-valid tracking after ``ignore_epoch``, the reload after
phase 1, phase 3 starting from phase 2's last-epoch moment params, and the
final chain phase-3 best → phase-1 best → running params. Each member
clips by its own gradient norm and draws its dropout masks from its own
seeds, so member s trains as ``train_3phase(seed=s)`` does, up to the
summation order of the batched kernels. The host syncs once per epoch,
through one [S, 7] stack.

Evaluation is the reference's reduction: average the members'
abs-sum-normalized weights, re-normalize per period where the abs-sum
exceeds 1e-8, form the portfolio returns, and report the Sharpe of the
NEGATED series with ddof=0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.gan import GAN, feature_major
from ..models.networks import (
    init_member_params,
    macro_states,
    masked_zero_mean,
    sdf_raw_weights,
)
from ..observability.logging import get_run_logger
from ..ops import sdf_ffn
from ..ops.metrics import (
    cross_sectional_r2,
    explained_variation,
    factor_betas,
    normalize_weights_abs,
    sharpe,
)
from ..training.steps import (
    MemberOptimizer,
    eval_step_members,
    member_subtree,
    train_step_members,
)
from ..training.trainer import HISTORY_KEYS, PHASE_SECTIONS
from ..utils.config import ExecutionConfig, GANConfig, TrainConfig
from ..utils.rng import phase_epoch_seeds

Batch = Dict[str, torch.Tensor]
Stacked = Dict[str, torch.Tensor]
SDF_PREFIX = "sdf_net."
# the paper's nine seeds (the JAX package's train_ensemble default)
PAPER_SEEDS = (42, 123, 456, 789, 1000, 2000, 3000, 4000, 5000)


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
    stacked LSTM scan and one fused-FFN call over all S members. On the f32
    panel always: a batch prepared for training with a bf16 panel
    (``ExecutionConfig.bf16_panel``) has it rebuilt in f32, so reported
    metrics do not depend on that training-side storage (the JAX package's
    ``member_weights``)."""
    params = sdf_params(stacked)
    mask = batch["mask"]
    x_t = feature_major(batch)["individual_t"]
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


# -- training ---------------------------------------------------------------


@dataclasses.dataclass
class MemberBest:
    """A phase's per-member best tracker ([S] host arrays); the params
    fields start as the entry params."""

    loss: np.ndarray
    sharpe: np.ndarray
    params_loss: Stacked
    params_sharpe: Stacked
    updated_loss: np.ndarray
    updated_sharpe: np.ndarray

    @classmethod
    def fresh(cls, params: Stacked) -> "MemberBest":
        S = next(iter(params.values())).shape[0]
        entry = snapshot(params)
        return cls(np.full(S, np.inf), np.full(S, -np.inf), entry, entry,
                   np.zeros(S, bool), np.zeros(S, bool))


def snapshot(params: Stacked) -> Stacked:
    return {k: v.detach().clone() for k, v in params.items()}


def vselect(pred: np.ndarray, new: Stacked, old: Stacked) -> Stacked:
    """Per-member select: member s from `new` where pred[s], else `old`
    (the JAX package's ``_vselect``)."""
    out = {}
    for k, a in new.items():
        p = torch.as_tensor(pred, device=a.device).view(
            (-1,) + (1,) * (a.dim() - 1))
        out[k] = torch.where(p, a.detach(), old[k].detach())
    return out


@torch.no_grad()
def load_members(params: Stacked, pred: np.ndarray, new: Stacked) -> None:
    """Copy member s of `new` into the live params in place where pred[s]
    (the optimizers keep their state on the same tensors)."""
    if pred.any():
        for k, v in vselect(pred, new, params).items():
            params[k].copy_(v)


def run_phase(gan: GAN, phase: str, opt: MemberOptimizer, params: Stacked,
              epoch_seeds: Sequence[Sequence[int]], batches,
              best: Optional[MemberBest], ignore_epoch: int,
              has_test: bool = True) -> Dict[str, np.ndarray]:
    """Epochs of one phase for every member; returns its history [S, E]
    per key. Phases 1 and 3 track per member the best valid loss
    (``loss_unc`` / ``loss_cond``) and valid Sharpe in `best`, for epochs
    past `ignore_epoch`. Phase 2 runs no evals and selects nothing (phase 3
    starts from its last epoch; its best-loss pick only names a checkpoint
    file in single-model training), so it takes no `best`."""
    train_b, valid_b, test_b = batches
    loss_key = "loss_unc" if phase == "unconditional" else "loss_cond"
    rows = []
    for epoch, seeds in enumerate(epoch_seeds):
        tr = train_step_members(gan, phase, opt, params, train_b, seeds)
        if phase == "moment":
            rows.append(np.asarray(torch.stack(
                [tr["loss"], tr["loss_cond"]], dim=1).tolist()))
            continue
        va = eval_step_members(gan, params, valid_b)
        te = eval_step_members(gan, params, test_b) if has_test else None
        vals = [tr["loss"], tr["sharpe"], tr["grad_norm"], va[loss_key],
                va["sharpe"]]
        vals += ([te[loss_key], te["sharpe"]] if te is not None
                 else [torch.zeros_like(tr["loss"])] * 2)
        # the epoch's one host sync: every member's row at once
        row = np.asarray(torch.stack(vals, dim=1).tolist())  # [S, 7]
        if epoch > ignore_epoch:
            better = row[:, 3] < best.loss
            if better.any():
                best.loss = np.where(better, row[:, 3], best.loss)
                best.params_loss = vselect(better, params, best.params_loss)
                best.updated_loss |= better
            better = row[:, 4] > best.sharpe
            if better.any():
                best.sharpe = np.where(better, row[:, 4], best.sharpe)
                best.params_sharpe = vselect(better, params,
                                             best.params_sharpe)
                best.updated_sharpe |= better
        rows.append(row)
    keys = (("train_loss", "train_loss_cond") if phase == "moment"
            else HISTORY_KEYS)
    S = next(iter(params.values())).shape[0]
    arr = np.zeros((S, len(rows), len(keys)), np.float32)
    if rows:
        arr[:] = np.stack(rows, axis=1)
    return {k: arr[:, :, i] for i, k in enumerate(keys)}


def run_member_chunks(run_one: Callable, items: Sequence, chunk: int):
    """Run `run_one(sub_items)` over `items` in `chunk`-sized groups and
    concatenate the results (dicts, nested, of tensors or arrays) along
    axis 0: the member-chunking primitive (caps the member axis so the
    plain route's activations fit the device)."""
    parts = [run_one(items[i:i + chunk]) for i in range(0, len(items), chunk)]

    def cat(xs):
        if isinstance(xs[0], Mapping):
            return {k: cat([x[k] for x in xs]) for k in xs[0]}
        if isinstance(xs[0], np.ndarray):
            return np.concatenate(xs, axis=0)
        return torch.cat(xs, dim=0)

    return cat(parts)


def init_ensemble_params(cfg: GANConfig, seeds: Sequence[int],
                         device="cpu") -> Stacked:
    """Member-stacked init params [S, ...] on `device`: member s is what
    ``train_3phase(seed=seeds[s])`` starts from."""
    return {k: v.to(device) for k, v in init_member_params(cfg, seeds).items()}


def train_ensemble(config: GANConfig, train_b: Batch, valid_b: Batch,
                   test_b: Optional[Batch] = None,
                   seeds: Sequence[int] = PAPER_SEEDS,
                   tcfg: Optional[TrainConfig] = None,
                   member_chunk: Optional[int] = None,
                   exec_cfg: Optional[ExecutionConfig] = None,
                   state_dicts=None, verbose: bool = True
                   ) -> Tuple[Stacked, Dict[str, np.ndarray]]:
    """Train len(seeds) models with the 3-phase schedule, members stacked.

    Every FFN and conditional-EM pass is one launch for all members.
    Parameters start from ``init_ensemble_params(seeds)`` or from
    `state_dicts` (a member-stacked dict, e.g. the JAX package's params
    through ``checkpoint.stacked_state_dict_from_jax_params``, or a list of
    per-member ``state_dict``s), on the batches' device. `member_chunk`
    trains at most that many members at a time and concatenates.

    Returns (the final params, stacked [S, ...] with the reference's
    ``state_dict`` keys; the history {key: [S, E]} over phases 1 and 3)."""
    out = train_members(config, train_b, valid_b, test_b, seeds, tcfg,
                        member_chunk=member_chunk, exec_cfg=exec_cfg,
                        state_dicts=state_dicts, verbose=verbose)
    return out["params"], out["history"]


def train_members(config: GANConfig, train_b: Batch, valid_b: Batch,
                  test_b: Optional[Batch], seeds: Sequence[int],
                  tcfg: Optional[TrainConfig] = None,
                  lrs: Optional[Sequence[float]] = None,
                  dropout_seeds: Optional[Sequence[int]] = None,
                  member_chunk: Optional[int] = None,
                  exec_cfg: Optional[ExecutionConfig] = None,
                  state_dicts=None, verbose: bool = True) -> Dict:
    """The member-stacked 3-phase runner behind :func:`train_ensemble` and
    the sweep's buckets (``parallel/sweep.py``).

    Member s starts from ``seeds[s]`` (or `state_dicts`), trains at
    ``lrs[s]`` (default: ``tcfg.lr`` for every member) and draws its
    dropout from the base seed ``dropout_seeds[s]`` (default ``seeds[s]``,
    as ``train_3phase(seed=s)`` does). Without `test_b` no test evals run (the history's test columns
    are 0).

    Returns {"params": the final params [S, ...], "history": {key: [S, E]}
    over phases 1 and 3, "best_valid_sharpe": [S]: the valid Sharpe of the
    params the final chain picked — phase 3's best where its tracker
    updated, else phase 1's, else -inf}."""
    tcfg = tcfg or TrainConfig()
    seeds = [int(s) for s in seeds]
    S = len(seeds)
    dropout_seeds = seeds if dropout_seeds is None else [
        int(s) for s in dropout_seeds]
    if state_dicts is not None and not isinstance(state_dicts, Mapping):
        state_dicts = stack_state_dicts(list(state_dicts), "cpu")
    if member_chunk is not None and 0 < member_chunk < S:
        def run_one(idx):
            sub = (None if state_dicts is None else
                   {k: v[idx] for k, v in state_dicts.items()})
            return train_members(
                config, train_b, valid_b, test_b, [seeds[i] for i in idx],
                tcfg, None if lrs is None else [lrs[i] for i in idx],
                [dropout_seeds[i] for i in idx], None, exec_cfg, sub,
                verbose)

        return run_member_chunks(run_one, list(range(S)), member_chunk)

    gan = GAN(config, exec_cfg or ExecutionConfig())
    device = train_b["returns"].device
    has_test = test_b is not None
    prep = gan.prepare_batch
    batches = (prep(train_b), prep(valid_b),
               prep(test_b) if has_test else prep(valid_b))
    start = (state_dicts if state_dicts is not None
             else init_member_params(config, seeds))
    params = {k: v.detach().to(device, torch.float32).clone().contiguous()
              for k, v in start.items()}
    opts = {key: MemberOptimizer(member_subtree(params, key),
                                 lrs or [tcfg.lr] * S,
                                 tcfg.grad_clip)
            for key in ("sdf_net", "moment_net")}
    # per member, per phase, per epoch: the seeds train_3phase(seed=s) draws
    member_seeds = [phase_epoch_seeds(s, [tcfg.num_epochs_unc,
                                          tcfg.num_epochs_moment,
                                          tcfg.num_epochs])
                    for s in dropout_seeds]
    phase_seeds = [list(zip(*(m[p] for m in member_seeds)))
                   for p in range(3)]

    # human lines from process 0 only; every process keeps its copy in
    # its own events.jsonl
    logger = get_run_logger()

    def log(msg):
        logger.info(msg, verbose=verbose)

    def run(phase, best, p):
        t0 = time.perf_counter()
        h = run_phase(gan, phase, opts["moment_net" if phase == "moment"
                                       else "sdf_net"],
                      params, phase_seeds[p], batches, best,
                      tcfg.ignore_epoch, has_test)
        log(f"  {PHASE_SECTIONS[phase]}: {len(phase_seeds[p])} epochs × {S} "
            f"members in {time.perf_counter() - t0:.1f}s")
        return h

    log(f"Ensemble: {S} seeds × ({tcfg.num_epochs_unc}+"
        f"{tcfg.num_epochs_moment}+{tcfg.num_epochs}) epochs, members "
        f"stacked")
    best1 = MemberBest.fresh(params)
    h1 = run("unconditional", best1, 0)
    load_members(params, best1.updated_sharpe, best1.params_sharpe)
    phase1 = snapshot(params)
    if tcfg.num_epochs_moment > 0:
        # phase 3 continues from the LAST-epoch moment params
        run("moment", None, 1)
    best3 = MemberBest.fresh(params)
    h3 = run("conditional", best3, 2)
    final = vselect(best3.updated_sharpe, best3.params_sharpe,
                    vselect(best1.updated_sharpe, phase1, snapshot(params)))
    reported = np.where(best3.updated_sharpe, best3.sharpe,
                        np.where(best1.updated_sharpe, best1.sharpe,
                                 -np.inf))
    history = {k: np.concatenate([h1[k], h3[k]], axis=1) for k in h1}
    log("Ensemble training complete")
    return {"params": final, "history": history,
            "best_valid_sharpe": reported}


# -- quorum -----------------------------------------------------------------


class QuorumError(RuntimeError):
    """Fewer ensemble members survived than the quorum requires."""


def member_validity(stacked: Mapping[str, torch.Tensor]) -> np.ndarray:
    """[S] bool: is every parameter of member s finite? A diverged member
    would make the weight-averaged ensemble NaN."""
    ok = None
    for v in stacked.values():
        v = torch.as_tensor(v)
        fin = torch.isfinite(v.reshape(v.shape[0], -1)).all(dim=1)
        ok = fin if ok is None else ok & fin
    return ok.cpu().numpy()


def apply_quorum(stacked: Mapping[str, torch.Tensor], seeds: Sequence[int],
                 quorum: int):
    """Drop non-finite members and proceed when at least `quorum` survive:
    (surviving stacked params, kept seeds, dropped seeds). Raises
    :class:`QuorumError`, naming the dropped seeds, below the quorum. With
    every member finite, `stacked` passes through as it is."""
    seeds = [int(s) for s in seeds]
    ok = member_validity(stacked)
    if ok.all():
        return stacked, seeds, []
    kept = [s for s, good in zip(seeds, ok) if good]
    dropped = [s for s, good in zip(seeds, ok) if not good]
    if len(kept) < quorum:
        raise QuorumError(
            f"only {len(kept)} of {len(seeds)} ensemble members survived "
            f"(non-finite params in seeds {dropped}); quorum is {quorum}")
    idx = torch.as_tensor(np.flatnonzero(ok))
    return ({k: torch.as_tensor(v)[idx.to(torch.as_tensor(v).device)]
             for k, v in stacked.items()}, kept, dropped)


def ensemble_metrics_from_weights(member_w: torch.Tensor, batch: Batch
                                  ) -> Dict[str, np.ndarray]:
    """:func:`ensemble_metrics` from stacked per-member normalized weights
    [S, T, N] instead of params: how members of different architectures
    ensemble (the reference averages weight matrices, never params)."""
    with torch.inference_mode():
        out = _ensemble_math(torch.as_tensor(member_w), batch)
    return {k: v.cpu().numpy() for k, v in out.items()}
