"""InferenceEngine: an ensemble of run directories as a long-lived,
low-latency query object on one device.

The counterpart of the JAX package's ``serving/engine.py``. It turns K
checkpoints (``evaluate_ensemble.stack_checkpoints``) into the queryable
SDF: the ensemble's portfolio weights and the factor ``F_{t+1}`` for any
month of firm characteristics.

* **Stacked members, one fused FFN.** The K members' SDF parameters sit on
  a leading axis and are packed once, at load, in the kernel's layout; a
  request is one member-stacked FFN launch (``ops/sdf_ffn.py``) followed by
  the paper-protocol reduction of ``parallel.ensemble._ensemble_math``
  (mean of the members' normalized weights → guarded re-normalize →
  portfolio return).
* **Incremental macro state.** The macro LSTM runs once over the
  historical series at load; every new month is an O(1) cell step per
  layer (``models/recurrent.stacked_lstm_step``).
* **Buckets.** A request's stock axis is padded with masked-out zeros to
  the smallest stock bucket that holds it, and a micro-batch of months to a
  batch bucket; months ride the panel's time axis, so B month-queries are
  one T = B forward. Host staging buffers are allocated once per bucket
  (pinned on a CUDA device) and reused.

Left for later slices: the device mesh, input donation and AOT programs
(CUDA graphs stand in for them), per-span staging, hot ``reload`` and its
canary.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evaluate_ensemble import stack_checkpoints
from ..models.networks import (
    masked_zero_mean,
    pack_sdf_ffn,
    sdf_raw_weights,
)
from ..models.recurrent import (
    layer_params,
    stacked_lstm_scan,
    stacked_lstm_step,
)
from ..ops import sdf_ffn
from ..ops.metrics import normalize_weights_abs
from ..parallel.ensemble import sdf_params
from ..utils.config import ExecutionConfig, GANConfig, resolve_device

# Stock-axis buckets: powers of two from 64 to 16384 cover the 500-stock
# synthetic panel through the ~10k-stock real one with ≤ 2× padding.
DEFAULT_STOCK_BUCKETS = tuple(64 * 2**i for i in range(9))
DEFAULT_BATCH_BUCKETS = (1, 4)


def config_hash(cfg: GANConfig) -> str:
    """sha256 of the canonical (sorted-key) JSON of the config."""
    blob = json.dumps(cfg.to_dict(), sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def params_digest(stacked: Dict[str, torch.Tensor]) -> str:
    """sha256 over the stacked parameters' bytes — the served weights'
    identity."""
    h = hashlib.sha256()
    for k in sorted(stacked):
        a = stacked[k].detach().cpu().numpy()
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n; an error when the request exceeds every bucket
    (the server answers 400 instead of serving an unbounded shape)."""
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(
        f"request size {n} exceeds the largest configured bucket "
        f"{max(buckets)}; raise stock_buckets/batch_buckets at engine load")


@dataclasses.dataclass
class InferenceRequest:
    """One month-query: firm characteristics (+ optional mask / realized
    next-month returns) against the macro state of `month` (-1 = latest)."""

    individual: np.ndarray  # [N, F] float32
    mask: Optional[np.ndarray] = None  # [N]; default all-valid
    returns: Optional[np.ndarray] = None  # [N]; enables the SDF factor
    month: int = -1


@dataclasses.dataclass
class InferenceResult:
    weights: np.ndarray  # [N] ensemble portfolio weights (Σ|w| = 1)
    sdf: Optional[float]  # F_{t+1} = Σ w·R·mask, None without returns
    member_sdf: Optional[np.ndarray]  # [K] per-member factors
    month: int
    n: int
    bucket: int
    batch_bucket: int


class InferenceEngine:
    """K stacked checkpoints + macro history → month-query object.

    Thread-safety: :meth:`infer` and :meth:`append_month` may be called from
    any thread; staging fill + dispatch and macro-state appends are
    serialized by one lock.
    """

    def __init__(
        self,
        checkpoint_dirs: Sequence[str],
        macro_history: Optional[np.ndarray] = None,  # [T, M], NORMALIZED
        macro_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        stock_buckets: Optional[Sequence[int]] = None,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        which: str = "best_model_sharpe",
        exec_cfg: Optional[ExecutionConfig] = None,
    ):
        self.exec_cfg = exec_cfg or ExecutionConfig()
        self.device = resolve_device(self.exec_cfg.device)
        self.checkpoint_dirs = [str(d) for d in checkpoint_dirs]
        cfg, stacked = stack_checkpoints(self.checkpoint_dirs, which,
                                         device=self.device)
        self.cfg = cfg
        self.config_hash = config_hash(cfg)
        self.params_fingerprint = params_digest(stacked)
        self.n_members = len(self.checkpoint_dirs)
        self.params = sdf_params(stacked)
        # packed once: the kernel reads these bytes on every request
        self._packed = (pack_sdf_ffn(self.params, cfg,
                                     self.exec_cfg.compute_dtype)
                        if cfg.hidden_dim else None)
        self.stock_buckets = tuple(sorted(
            stock_buckets if stock_buckets is not None
            else DEFAULT_STOCK_BUCKETS))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self._lock = threading.Lock()
        self._staging: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}
        self._dispatches = 0
        self._macro_stats = macro_stats
        self._uses_state = cfg.macro_feature_dim > 0
        self._uses_lstm = self._uses_state and cfg.use_rnn
        self._layers = (layer_params(self.params, len(cfg.num_units_rnn),
                                     "macro_lstm.lstm.")
                        if self._uses_lstm else None)
        self._carries = None
        self._hs: Optional[torch.Tensor] = None  # [K, T, Dp] on device
        self._macro_raw: Optional[np.ndarray] = None  # [T, M] normalized
        if self._uses_state:
            if macro_history is None:
                raise ValueError(
                    "config has macro_feature_dim "
                    f"{cfg.macro_feature_dim} > 0: pass macro_history "
                    "([T, M], normalized with the TRAIN split's stats)")
            self._init_macro_state(np.asarray(macro_history, np.float32))

    # -- macro state ---------------------------------------------------------

    @property
    def state_dim(self) -> int:
        """Per-month macro-state width the forward consumes."""
        if not self._uses_state:
            return 0
        return (self.cfg.num_units_rnn[-1] if self._uses_lstm
                else self.cfg.macro_feature_dim)

    @property
    def months(self) -> int:
        """Number of macro months the engine holds state for."""
        return 0 if self._hs is None else self._hs.shape[1]

    @torch.inference_mode()
    def _init_macro_state(self, macro: np.ndarray) -> None:
        if macro.ndim != 2 or macro.shape[1] != self.cfg.macro_feature_dim:
            raise ValueError(
                f"macro_history must be [T, {self.cfg.macro_feature_dim}]; "
                f"got {macro.shape}")
        self._macro_raw = np.array(macro, np.float32)
        x = torch.as_tensor(self._macro_raw, device=self.device)
        if not self._uses_lstm:
            # no recurrence: the state is the normalized macro row itself
            self._hs = x.expand(self.n_members, *x.shape).clone()
            return
        self._hs, self._carries = stacked_lstm_scan(self._layers, x)

    @torch.inference_mode()
    def append_month(self, macro_row: np.ndarray, raw: bool = False) -> int:
        """Advance the macro state by one month — one cell step per layer,
        never a re-scan. ``raw=True`` z-scores the row with the train stats
        the engine was built with. Returns the new month's index."""
        if not self._uses_state:
            raise ValueError("this config consumes no macro series")
        row = np.asarray(macro_row, np.float32).reshape(-1)
        if row.shape[0] != self.cfg.macro_feature_dim:
            raise ValueError(
                f"macro row must have {self.cfg.macro_feature_dim} series; "
                f"got {row.shape[0]}")
        if raw:
            if self._macro_stats is None:
                raise ValueError("raw=True requires macro_stats=(mean, std) "
                                 "at engine construction")
            mean, std = self._macro_stats
            row = ((row - np.asarray(mean).reshape(-1))
                   / np.asarray(std).reshape(-1)).astype(np.float32)
        with self._lock:
            x = torch.as_tensor(row, device=self.device)
            if self._uses_lstm:
                h, self._carries = stacked_lstm_step(self._layers,
                                                     self._carries, x)
            else:
                h = x.expand(self.n_members, x.shape[0])
            self._hs = torch.cat([self._hs, h[:, None, :]], dim=1)
            self._macro_raw = np.concatenate([self._macro_raw, row[None]])
            self._dispatches += 1
            return self._hs.shape[1] - 1

    def macro_state_for_month(self, month: int) -> np.ndarray:
        """[K, Dp] per-member macro state at `month` (negative = from end)."""
        if self._hs is None:
            raise ValueError("this config consumes no macro series")
        return self._hs[:, month].cpu().numpy()

    # -- the forward ---------------------------------------------------------

    @torch.inference_mode()
    def _fwd(self, state: Optional[torch.Tensor], x_t: torch.Tensor,
             mask: torch.Tensor, returns: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """state [K, B, Dp] or None; x_t [B, F, Nb]; mask/returns [B, Nb]
        → the paper-protocol ensemble reduction per month."""
        w = sdf_raw_weights(self.params, self.cfg, self.exec_cfg, x_t, state,
                            self._packed) * mask  # [K, B, Nb]
        if self.cfg.normalize_w:
            w = masked_zero_mean(w, mask)
        w = normalize_weights_abs(w, mask)
        # ensemble math exactly as parallel.ensemble._ensemble_math
        avg = w.mean(dim=0)
        abs_sum = (avg.abs() * mask).sum(dim=1, keepdim=True)
        avg = torch.where(abs_sum > 1e-8, avg / abs_sum, avg)
        member_sdf = (w * returns * mask).sum(dim=2)  # [K, B]
        sdf = (avg * returns * mask).sum(dim=1)  # [B]
        return {"weights": avg, "sdf": sdf, "member_sdf": member_sdf}

    def _staging_buffers(self, nb: int, b: int) -> Tuple[torch.Tensor, ...]:
        """Host staging for one (stock bucket, batch bucket): the
        feature-major panel [B, F, Nb], mask and returns [B, Nb], zeroed and
        reused (pinned on a CUDA device). Callers hold the lock."""
        key = (nb, b)
        stage = self._staging.get(key)
        if stage is None:
            pin = self.device.type == "cuda"
            f = self.cfg.individual_feature_dim
            stage = (torch.zeros((b, f, nb), pin_memory=pin),
                     torch.zeros((b, nb), pin_memory=pin),
                     torch.zeros((b, nb), pin_memory=pin))
            self._staging[key] = stage
        else:
            for a in stage:
                a.zero_()
        return stage

    def warmup(self) -> int:
        """Run every (stock bucket, batch bucket) forward once on zeros —
        builds the kernel and allocates every staging buffer before traffic.
        Returns the number of buckets warmed."""
        n = 0
        for nb in self.stock_buckets:
            for b in self.batch_buckets:
                with self._lock:
                    x_t, mask, returns = self._staging_buffers(nb, b)
                    state = (self._hs[:, [0] * b]
                             if self._uses_state and self.months else None)
                    self._fwd(state, x_t.to(self.device), mask.to(self.device),
                              returns.to(self.device))
                n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def _resolve_months(self, requests: List[InferenceRequest]) -> List[int]:
        months = []
        for i, r in enumerate(requests):
            m = r.month
            if self._uses_state:
                m = m if m >= 0 else self.months + m
                if not 0 <= m < self.months:
                    raise ValueError(
                        f"request {i}: month {r.month} outside the engine's "
                        f"{self.months} macro months")
            months.append(m)
        return months

    def infer(self, requests: List[InferenceRequest]) -> List[InferenceResult]:
        """Serve a micro-batch: every request pads to the largest one's
        stock bucket, the batch to its batch bucket."""
        if not requests:
            return []
        b = bucket_for(len(requests), self.batch_buckets)
        f = self.cfg.individual_feature_dim
        inds = []
        for r in requests:
            ind = np.asarray(r.individual, np.float32)
            if ind.ndim != 2 or ind.shape[1] != f:
                raise ValueError(f"individual must be [N, {f}]; got "
                                 f"{ind.shape}")
            inds.append(ind)
        nb = bucket_for(max(a.shape[0] for a in inds), self.stock_buckets)
        with self._lock:
            months = self._resolve_months(requests)
            x_t, mask, returns = self._staging_buffers(nb, b)
            xv, mv, rv = x_t.numpy(), mask.numpy(), returns.numpy()
            for i, (r, ind) in enumerate(zip(requests, inds)):
                n = ind.shape[0]
                xv[i, :, :n] = ind.T
                mv[i, :n] = (1.0 if r.mask is None
                             else np.asarray(r.mask, np.float32))
                if r.returns is not None:
                    rv[i, :n] = np.asarray(r.returns, np.float32)
            state = None
            if self._uses_state:
                # padded batch slots reuse the first request's month (their
                # outputs are dropped below)
                idx = months + [months[0]] * (b - len(requests))
                state = self._hs[:, idx]  # [K, B, Dp]
            dev = self.device
            out = self._fwd(state, x_t.to(dev, non_blocking=True),
                            mask.to(dev, non_blocking=True),
                            returns.to(dev, non_blocking=True))
            out = {k: v.cpu().numpy() for k, v in out.items()}
            self._dispatches += 1

        results = []
        for i, (r, ind) in enumerate(zip(requests, inds)):
            n = ind.shape[0]
            has_ret = r.returns is not None
            results.append(InferenceResult(
                weights=out["weights"][i, :n],
                sdf=float(out["sdf"][i]) if has_ret else None,
                member_sdf=out["member_sdf"][:, i] if has_ret else None,
                month=months[i], n=n, bucket=nb, batch_bucket=b))
        return results

    def infer_one(self, request: InferenceRequest) -> InferenceResult:
        return self.infer([request])[0]

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "n_members": self.n_members,
                "config_hash": self.config_hash,
                "params_fingerprint": self.params_fingerprint[:16],
                "stock_buckets": list(self.stock_buckets),
                "batch_buckets": list(self.batch_buckets),
                "months": self.months,
                "dispatches": self._dispatches,
                "staging_buffers": len(self._staging),
                "device": str(self.device),
                "ffn_route": ("plain" if self.exec_cfg.kernel == "off"
                              or self.device.type == "cpu" else "cuda"),
                "compute_dtype": self.exec_cfg.compute_dtype,
                "kernel_launches": sdf_ffn.launches,
            }
