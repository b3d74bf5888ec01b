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
* **Buckets and CUDA graphs.** A request's stock axis is padded with
  masked-out zeros to the smallest stock bucket that holds it, and a
  micro-batch of months to a batch bucket; months ride the panel's time
  axis, so B month-queries are one T = B forward. Host staging is in the
  request's layout ([B, Nb, F], a row copy per request); the forward
  transposes to the kernel's feature-major panel on the device. On a CUDA
  device, :meth:`warmup` captures one ``torch.cuda.CUDAGraph`` per (stock
  bucket, batch bucket) — the forward from static device inputs to static
  device outputs, in place of the JAX engine's AOT programs with donated
  inputs — and a flush fills the bucket's pinned host staging, copies it
  and the months' macro states into the graph's static inputs, replays
  the graph and copies the outputs back, all under the dispatch lock. After
  warmup the serve path captures nothing and allocates no host memory
  (``stats()["steady_state_captures"]`` is 0). On the CPU there are no
  graphs: the forward runs eagerly.
* **Hot reload.** :meth:`reload` swaps new member params in — all or
  nothing, same architecture and member count — by copying them INTO the
  tensors the graphs captured (the packed FFN buffer too), never by
  rebinding, and re-derives the macro state; :meth:`snapshot_params`
  clones what a reload overwrites so the canary's :meth:`restore_params`
  can put it back.
* **The device mesh.** ``mesh=`` (a spec string such as ``"stocks=4"`` or
  ``"members=2,stocks=2"``, a ``MeshConfig`` or a built ``Mesh``) lays the
  forward over a grid of this process's devices
  (``parallel/partition.local_devices``). The ``stocks`` axis cuts every
  stock bucket into contiguous spans; an optional ``members`` axis cuts the
  stacked members. Each position holds its members' weights on its own
  device, pinned host staging and device inputs for its span
  (:meth:`_span_staging`, :meth:`_fill`, :meth:`_put_spans`) and, on
  a CUDA device, a graph per (stock bucket, batch bucket, position). The
  members' weights before the cross-section are gathered onto the first
  position, whose graph then runs the cross-sectional steps (the masked
  zero mean, Σ|w| = 1, the sums over stocks) over the whole bucket in the
  one-device engine's order. A reload copies into every position's
  tensors. Without a mesh the engine is the one-device engine, bit for
  bit; a one-position mesh is the one-device engine on that position's
  device.
"""

from __future__ import annotations

import dataclasses
import hashlib
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
from ..observability import EventLog
from ..observability.manifest import config_hash
from ..ops import sdf_ffn
from ..ops.metrics import normalize_weights_abs
from ..parallel import partition
from ..parallel.ensemble import sdf_params
from ..reliability.faults import inject
from ..utils.config import ExecutionConfig, resolve_device

# Stock-axis buckets: powers of two from 64 to 16384 cover the 500-stock
# synthetic panel through the ~10k-stock real one with ≤ 2× padding.
DEFAULT_STOCK_BUCKETS = tuple(64 * 2**i for i in range(9))
DEFAULT_BATCH_BUCKETS = (1, 4)

def params_digest(stacked: Dict[str, torch.Tensor]) -> str:
    """sha256 over the stacked parameters' bytes — the served weights'
    identity. Result caches key on it, so a hot swap (:meth:`reload`) can
    never serve a stale entry."""
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


@dataclasses.dataclass
class _BucketGraph:
    """One captured (stock bucket, batch bucket) forward: the graph and the
    static device tensors it reads and writes."""

    graph: Any  # torch.cuda.CUDAGraph
    individual: torch.Tensor  # [B, Nb, F]
    mask: torch.Tensor  # [B, Nb]
    returns: torch.Tensor  # [B, Nb]
    state: Optional[torch.Tensor]  # [K, B, Dp]
    out: Dict[str, torch.Tensor]  # weights [B, Nb], sdf [B], member_sdf [K, B]


@dataclasses.dataclass
class _SpanGraph:
    """One captured (stock bucket, batch bucket, mesh position) forward:
    the graph, the position's static inputs on its device and its output,
    the members' weights over its span ({"w": [K_p, B, span]}). The first
    position's graph also runs the cross-section over the whole bucket:
    its ``out`` is the bucket's outputs, and it owns the gathered weights
    and the bucket's mask and returns on its device."""

    graph: Any  # torch.cuda.CUDAGraph
    individual: torch.Tensor  # [B, span, F]
    mask: torch.Tensor  # [B, span]
    state: Optional[torch.Tensor]  # [K_p, B, Dp]
    out: Dict[str, torch.Tensor]
    gathered: Optional[torch.Tensor] = None  # [K, B, Nb]
    mask_all: Optional[torch.Tensor] = None  # [B, Nb]
    returns_all: Optional[torch.Tensor] = None  # [B, Nb]


@dataclasses.dataclass
class _Position:
    """One position of the serving mesh: its device, its members [m0, m1)
    and stock part, and its own copy of their weights (the packed FFN
    buffer too, whose plain-route pieces are views of ``params``)."""

    device: torch.device
    members: Tuple[int, int]
    stock_part: int
    params: Dict[str, torch.Tensor]
    packed: Optional[sdf_ffn.PackedFfn]


class InferenceEngine:
    """K stacked checkpoints + macro history → month-query object.

    Thread-safety: :meth:`infer`, :meth:`append_month`, :meth:`reload` and
    :meth:`restore_params` may be called from any thread. Staging fill,
    graph replay (or the eager forward) and the output copy, macro-state
    appends and the whole of a params swap are serialized by the dispatch
    lock (``_infer_lock``), so a flush runs fully before or fully after a
    swap; counters and the generation-quality aggregates sit behind a
    second, short-held lock (``_lock``). The graphs and static buffers
    belong to the engine, not to a thread: the continuous batcher replays
    them from its dispatch thread.
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
        events: Optional[EventLog] = None,
        mesh=None,
    ):
        self.exec_cfg = exec_cfg or ExecutionConfig()
        self.device = resolve_device(self.exec_cfg.device)
        self._mesh = (self._build_mesh(mesh) if mesh is not None
                      else partition.device_mesh(self.device))
        if mesh is not None:
            # the first position's device holds the stacked params, the
            # macro state and the cross-sectional steps
            self.device = partition.position_device(
                self._mesh.devices.flat[0])
        self.events = events if events is not None else EventLog()
        self.checkpoint_dirs = [str(d) for d in checkpoint_dirs]
        self._which = which
        cfg, stacked = stack_checkpoints(self.checkpoint_dirs, which,
                                         device=self.device)
        self.cfg = cfg
        self.config_hash = config_hash(cfg)
        self.params_fingerprint = params_digest(stacked)
        self.params_generation = 0
        self.n_members = len(self.checkpoint_dirs)
        self.params = sdf_params(stacked)
        # packed once: the kernel (and every captured graph) reads these
        # bytes on every request; a reload copies new values into them
        self._packed = (pack_sdf_ffn(self.params, cfg,
                                     self.exec_cfg.compute_dtype)
                        if cfg.hidden_dim else None)
        self.stock_buckets = tuple(sorted(
            stock_buckets if stock_buckets is not None
            else DEFAULT_STOCK_BUCKETS))
        self.batch_buckets = tuple(sorted(batch_buckets))
        self._lock = threading.Lock()
        self._infer_lock = threading.Lock()
        self._staging: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}
        self._graphs: Dict[Tuple[int, int], _BucketGraph] = {}
        self._init_positions(mesh is not None)
        self._span_plans: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._span_graphs: Dict[Tuple[int, int], List[_SpanGraph]] = {}
        self._captures = 0
        # captures at the end of warmup(): everything past this marker is a
        # steady-state capture (stats()["steady_state_captures"])
        self._warmup_captures: Optional[int] = None
        self._replays = 0
        self._dispatches = 0
        # per-GENERATION served-output quality (the dlap_model_* gauges),
        # reset on every swap so a scrape describes the weights serving now
        self._gen_quality: Dict[str, float] = self._fresh_gen_quality()
        self._macro_stats = macro_stats
        self._uses_state = cfg.macro_feature_dim > 0
        self._uses_lstm = self._uses_state and cfg.use_rnn
        # views of self.params: a reload's in-place copy updates them too
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

    @property
    def uses_graphs(self) -> bool:
        """True on a CUDA device: every bucket is served by graph replay."""
        return self.device.type == "cuda"

    # -- the device mesh -----------------------------------------------------

    def _build_mesh(self, mesh) -> partition.Mesh:
        """A spec string, a ``MeshConfig`` (without devices: the route's
        local devices) or a ``Mesh`` → the built mesh, every position on a
        device of the engine's route."""
        if isinstance(mesh, str):
            mesh = partition.parse_mesh_spec(
                mesh, partition.local_devices(self.device))
        if isinstance(mesh, partition.MeshConfig):
            if mesh.devices is None:
                mesh = dataclasses.replace(
                    mesh, devices=partition.local_devices(self.device))
            mesh = mesh.build()
        for _, dev in mesh.positions():
            if partition.position_device(dev).type != self.device.type:
                raise ValueError(
                    f"mesh device {dev} is not on the engine's route "
                    f"{self.device.type}")
        return mesh

    def _init_positions(self, meshed: bool) -> None:
        """Validate the mesh against the buckets and the ensemble, and
        give each position its members' weights on its device."""
        shape = self._mesh.shape
        self._stock_shards = int(shape.get(partition.STOCK_AXIS, 1))
        try:
            self._member_axis = partition.member_axis_name(self._mesh)
        except ValueError:
            self._member_axis = None
        for axis in shape:
            if axis not in (partition.STOCK_AXIS, self._member_axis):
                raise ValueError(
                    f"mesh axis {axis!r}: the serving mesh lays out "
                    f"'{partition.STOCK_AXIS}' and one member axis only")
        for nb in self.stock_buckets:
            if nb % self._stock_shards:
                raise ValueError(
                    f"stock bucket {nb} is not divisible by the mesh's "
                    f"{self._stock_shards}-way '{partition.STOCK_AXIS}' "
                    "axis: every bucket shards evenly or the padded spans "
                    "would straddle devices")
        parts = (int(shape[self._member_axis])
                 if self._member_axis is not None else 1)
        if parts == 1:
            # a member axis of one (or none) replicates the members
            self._member_axis = None
        elif self.n_members % parts:
            raise ValueError(
                f"mesh '{self._member_axis}' axis size {parts} does not "
                f"divide the {self.n_members}-member ensemble")
        # the span path for more than one position; one position is the
        # one-device engine on that position's device
        self._sharded_dispatch = meshed and self._mesh.devices.size > 1
        self._positions: List[_Position] = []
        if not self._sharded_dispatch:
            return
        k = self.n_members // parts
        for coords, dev in self._mesh.positions():
            m = coords.get(self._member_axis, 0) if parts > 1 else 0
            dev = partition.position_device(dev)
            params = {key: v[m * k:(m + 1) * k].to(dev, copy=True)
                      for key, v in self.params.items()}
            self._positions.append(_Position(
                dev, (m * k, (m + 1) * k),
                coords.get(partition.STOCK_AXIS, 0), params,
                pack_sdf_ffn(params, self.cfg, self.exec_cfg.compute_dtype)
                if self.cfg.hidden_dim else None))

    @torch.inference_mode()
    def _sync_positions(self) -> None:
        """Copy the engine's params and packed buffer into every
        position's own tensors (a reload, a restore)."""
        for pos in self._positions:
            m0, m1 = pos.members
            for key, v in pos.params.items():
                v.copy_(self.params[key][m0:m1])
            if pos.packed is not None:
                pos.packed.params.copy_(self._packed.params[m0:m1])

    # -- generation quality --------------------------------------------------

    @staticmethod
    def _fresh_gen_quality() -> Dict[str, float]:
        return {"outputs": 0, "nonfinite_outputs": 0,
                "sdf_n": 0, "sdf_sum": 0.0, "sdf_sumsq": 0.0,
                "weight_norm_sum": 0.0, "weight_max_abs": 0.0}

    def _observe_outputs(self, requests: List[InferenceRequest],
                         out: Dict[str, np.ndarray]) -> None:
        """Fold one micro-batch's served outputs into the generation-
        quality aggregates (host numpy over the already-fetched result —
        no extra device work)."""
        q = self._fresh_gen_quality()
        for i, r in enumerate(requests):
            n = np.asarray(r.individual).shape[0]
            w = out["weights"][i, :n]
            finite = bool(np.isfinite(w).all())
            q["outputs"] += 1
            q["weight_norm_sum"] += float(np.abs(w).sum())
            if w.size:
                q["weight_max_abs"] = max(q["weight_max_abs"],
                                          float(np.abs(w).max()))
            if r.returns is not None:
                s = float(out["sdf"][i])
                if np.isfinite(s):
                    q["sdf_n"] += 1
                    q["sdf_sum"] += s
                    q["sdf_sumsq"] += s * s
                else:
                    finite = False
            if not finite:
                q["nonfinite_outputs"] += 1
        with self._lock:
            g = self._gen_quality
            for k, v in q.items():
                g[k] = max(g[k], v) if k == "weight_max_abs" else g[k] + v

    def generation_quality(self) -> Dict[str, Any]:
        """Summary of what the CURRENT params generation has served — the
        ``dlap_model_*`` gauge source. ``finite_fraction`` is 1.0 for a
        generation that has served nothing (no evidence ≠ bad evidence)."""
        with self._lock:
            g = dict(self._gen_quality)
            generation = self.params_generation
        n = g["outputs"]
        sdf_mean = sdf_vol = None
        if g["sdf_n"]:
            sdf_mean = g["sdf_sum"] / g["sdf_n"]
            var = g["sdf_sumsq"] / g["sdf_n"] - sdf_mean * sdf_mean
            sdf_vol = float(np.sqrt(max(var, 0.0)))
        return {
            "generation": generation,
            "outputs": n,
            "nonfinite_outputs": g["nonfinite_outputs"],
            "finite_fraction": (round(1.0 - g["nonfinite_outputs"] / n, 6)
                                if n else 1.0),
            "weight_norm_mean": (round(g["weight_norm_sum"] / n, 6)
                                 if n else None),
            "weight_max_abs": round(g["weight_max_abs"], 6) if n else None,
            "sdf_mean": round(sdf_mean, 6) if sdf_mean is not None else None,
            "sdf_vol": round(sdf_vol, 6) if sdf_vol is not None else None,
        }

    # -- hot reload ----------------------------------------------------------

    def reload(self, checkpoint_dirs: Optional[Sequence[str]] = None
               ) -> Dict[str, Any]:
        """Hot-swap params in place — from the SAME checkpoint dirs (new
        verified checkpoints written under them) or from `checkpoint_dirs`
        (a promotion pointer's member set). The captured graphs read the
        engine's parameter tensors and packed FFN buffer by address, so the
        new values are copied INTO those tensors; a reload never changes
        shapes — an architecture or member-count change raises and leaves
        the engine serving. The macro state is params-dependent and is
        re-derived over the full (initial + appended) normalized series.
        Bumps ``params_generation`` and ``params_fingerprint``; result
        caches keyed on the fingerprint drop every stale entry.

        ALL-OR-NOTHING: a failure (a member dir whose every generation is
        corrupt, an architecture mismatch, a macro re-scan error) leaves
        the engine serving its current params. A reload whose loaded bytes
        hash to the CURRENT fingerprint is a no-op (``swapped: False``):
        no generation bump, no re-scan."""
        dirs = (self.checkpoint_dirs if checkpoint_dirs is None
                else [str(d) for d in checkpoint_dirs])
        if len(dirs) != self.n_members:
            raise ValueError(
                f"reload got {len(dirs)} checkpoint dirs but the captured "
                f"graphs serve a {self.n_members}-member ensemble — start a "
                "fresh engine to change the member count")
        cfg, stacked = stack_checkpoints(dirs, self._which,
                                         device=self.device)
        if config_hash(cfg) != self.config_hash:
            raise ValueError(
                "reload found a different architecture (config hash "
                f"{config_hash(cfg)[:12]} != {self.config_hash[:12]}); the "
                "captured graphs only serve the architecture they were "
                "captured for — start a fresh engine instead")
        fingerprint = params_digest(stacked)
        if fingerprint == self.params_fingerprint:
            self.checkpoint_dirs = dirs
            self.events.counter("serve/reload",
                                generation=self.params_generation,
                                fingerprint=fingerprint[:16], swapped=False)
            return {"params_fingerprint": fingerprint,
                    "params_generation": self.params_generation,
                    "swapped": False}
        new = sdf_params(stacked)
        packed = (pack_sdf_ffn(new, cfg, self.exec_cfg.compute_dtype)
                  if cfg.hidden_dim else None)
        with self._infer_lock:
            # the WHOLE swap — params AND the re-derived macro state —
            # under the dispatch lock: a flush never sees new params
            # against old LSTM state
            old = self._snapshot_locked()
            self._copy_params(new, packed)
            self.params_fingerprint = fingerprint
            try:
                if self._uses_state:
                    self._init_macro_state(self._macro_raw)
            except BaseException:
                self._restore_locked(old)
                raise
            with self._lock:
                self.params_generation += 1
                self._gen_quality = self._fresh_gen_quality()
        self.checkpoint_dirs = dirs
        self.events.counter("serve/reload",
                            generation=self.params_generation,
                            fingerprint=fingerprint[:16], swapped=True)
        return {"params_fingerprint": fingerprint,
                "params_generation": self.params_generation,
                "swapped": True}

    @torch.inference_mode()
    def _copy_params(self, params: Dict[str, torch.Tensor],
                     packed: Optional[sdf_ffn.PackedFfn]) -> None:
        """Copy member params (and their packed FFN buffer) into the
        engine's own tensors, whose addresses the graphs captured."""
        for k, v in self.params.items():
            v.copy_(params[k])
        if self._packed is not None:
            self._packed.params.copy_(packed.params)
        self._sync_positions()

    def _snapshot_locked(self) -> Tuple:
        # params and the packed buffer are overwritten in place by a
        # reload, so they are CLONED; the macro state is rebound (never
        # mutated in place) on every transition, so references suffice
        with torch.inference_mode():
            params = {k: v.clone() for k, v in self.params.items()}
            packed = (self._packed.params.clone()
                      if self._packed is not None else None)
        return (params, packed, self.params_fingerprint, self._carries,
                self._hs, self._macro_raw, list(self.checkpoint_dirs))

    def _restore_locked(self, snapshot: Tuple) -> None:
        params, packed, fingerprint, carries, hs, macro_raw, _ = snapshot
        with torch.inference_mode():
            for k, v in self.params.items():
                v.copy_(params[k])
            if packed is not None:
                self._packed.params.copy_(packed)
        self._sync_positions()
        self.params_fingerprint = fingerprint
        self._carries, self._hs, self._macro_raw = carries, hs, macro_raw

    def snapshot_params(self) -> Tuple:
        """Opaque in-memory snapshot of the serving generation (params,
        packed FFN buffer, fingerprint, the FULL macro state incl. the raw
        series, dirs) for the post-reload canary's REVERT: an in-place
        reload (new bytes under the same dirs) cannot be undone by
        reloading those dirs — the old params may exist nowhere on disk —
        so the revert restores the held state. The tensors a reload
        overwrites in place are cloned (a few hundred KB at paper width)."""
        with self._infer_lock:
            return self._snapshot_locked()

    def restore_params(self, snapshot: Tuple) -> None:
        """Copy a :meth:`snapshot_params` state back in, atomically under
        the dispatch lock (the counterpart of :meth:`reload`'s swap). The
        WHOLE macro state (carries, per-month states, raw series) restores
        together. Bumps the generation and emits ``serve/restore`` (not
        ``serve/reload``: a revert is not a new hot swap)."""
        with self._infer_lock:
            self._restore_locked(snapshot)
            with self._lock:
                self.params_generation += 1
                self._gen_quality = self._fresh_gen_quality()
        self.checkpoint_dirs = list(snapshot[-1])
        self.events.counter("serve/restore",
                            generation=self.params_generation,
                            fingerprint=self.params_fingerprint[:16])

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
        macro_raw = np.array(macro, np.float32)
        x = torch.as_tensor(macro_raw, device=self.device)
        with self.events.span("serve/macro_scan", months=int(x.shape[0])):
            if not self._uses_lstm:
                # no recurrence: the state is the normalized macro row
                hs, carries = x.expand(self.n_members, *x.shape).clone(), None
            else:
                hs, carries = stacked_lstm_scan(self._layers, x)
        self._macro_raw, self._hs, self._carries = macro_raw, hs, carries

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
        # the dispatch lock: the macro state must not advance while a
        # reload is mid-rescan
        with self._infer_lock:
            x = torch.as_tensor(row, device=self.device)
            if self._uses_lstm:
                h, self._carries = stacked_lstm_step(self._layers,
                                                     self._carries, x)
            else:
                h = x.expand(self.n_members, x.shape[0])
            self._hs = torch.cat([self._hs, h[:, None, :]], dim=1)
            self._macro_raw = np.concatenate([self._macro_raw, row[None]])
            month = self._hs.shape[1] - 1
        with self._lock:
            self._dispatches += 1
        self.events.counter("serve/macro_append", month=month)
        return month

    def macro_state_for_month(self, month: int) -> np.ndarray:
        """[K, Dp] per-member macro state at `month` (negative = from end)."""
        if self._hs is None:
            raise ValueError("this config consumes no macro series")
        return self._hs[:, month].cpu().numpy()

    # -- the forward ---------------------------------------------------------

    @torch.inference_mode()
    def _fwd(self, state: Optional[torch.Tensor], individual: torch.Tensor,
             mask: torch.Tensor, returns: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        """state [K, B, Dp] or None; individual [B, Nb, F]; mask/returns
        [B, Nb] → the paper-protocol ensemble reduction per month."""
        w = self._raw(self.params, self._packed, state, individual, mask)
        return self._join(w, mask, returns)

    def _raw(self, params: Dict[str, torch.Tensor],
             packed: Optional[sdf_ffn.PackedFfn],
             state: Optional[torch.Tensor], individual: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """The members' masked weights [K, B, n] before the cross-section:
        per stock, so a span's are the whole bucket's over that span."""
        # the kernel's feature-major panel, transposed on the device
        # [B, F, n], f32 always: the engine serves on the f32 panel whatever
        # exec_cfg.bf16_panel says (the JAX engine's _load_stacked)
        x_t = individual.transpose(1, 2).contiguous()
        return sdf_raw_weights(params, self.cfg, self.exec_cfg, x_t, state,
                               packed) * mask

    def _join(self, w: torch.Tensor, mask: torch.Tensor,
              returns: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The cross-sectional steps over a whole bucket's [K, B, Nb]."""
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
        """Host staging for one (stock bucket, batch bucket): the panel
        [B, Nb, F], mask and returns [B, Nb], zeroed and reused (pinned on
        a CUDA device). Callers hold the dispatch lock."""
        key = (nb, b)
        stage = self._staging.get(key)
        if stage is None:
            pin = self.device.type == "cuda"
            f = self.cfg.individual_feature_dim
            stage = (torch.zeros((b, nb, f), pin_memory=pin),
                     torch.zeros((b, nb), pin_memory=pin),
                     torch.zeros((b, nb), pin_memory=pin))
            self._staging[key] = stage
        else:
            for a in stage:
                a.zero_()
        return stage

    def _capture(self, nb: int, b: int) -> _BucketGraph:
        """Capture the (nb, b) bucket's forward as a CUDA graph over static
        device inputs. The forward runs once uncaptured first, on the
        capture's side stream (the kernel library loads, its launch plan is
        looked up and its shared-memory attribute set outside the capture),
        then is captured on that stream. A failure raises: the engine never
        quietly serves a bucket eagerly. Callers hold the dispatch lock."""
        dev = self.device
        f = self.cfg.individual_feature_dim
        individual = torch.zeros((b, nb, f), device=dev)
        mask = torch.zeros((b, nb), device=dev)
        returns = torch.zeros((b, nb), device=dev)
        state = None
        if self._uses_state:
            state = torch.zeros((self.n_members, b, self.state_dim),
                                device=dev)
            state.copy_(self._hs[:, :1].expand(-1, b, -1))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._fwd(state, individual, mask, returns)
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        with self.events.span("serve/capture", bucket=nb, batch=b):
            # thread_local: a bucket captured on first use (no warmup)
            # must not fail because another thread of the server (a
            # reload's checkpoint load) touches the device meanwhile
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out = self._fwd(state, individual, mask, returns)
        torch.cuda.current_stream(dev).wait_stream(side)
        g = _BucketGraph(graph, individual, mask, returns, state, out)
        self._graphs[(nb, b)] = g
        with self._lock:
            self._captures += 1
        self.events.counter("serve/capture", bucket=nb, batch=b)
        return g

    # -- the mesh's per-span staging and dispatch -----------------------------

    def _span_staging(self, nb: int, b: int) -> Dict[str, Any]:
        """Host staging for one (stock bucket, batch bucket) on the mesh:
        each position's stock span, and one zeroed, reused (individual,
        mask, returns) triple per UNIQUE span, pinned on a CUDA device —
        positions that share a span across the member axis share its
        buffers. Callers hold the dispatch lock."""
        key = (nb, b)
        plan = self._span_plans.get(key)
        if plan is None:
            w = nb // self._stock_shards
            spans = [(p.stock_part * w, (p.stock_part + 1) * w)
                     for p in self._positions]
            unique = sorted(set(spans))
            pin = self.device.type == "cuda"
            f = self.cfg.individual_feature_dim
            plan = {
                "spans": unique,
                "span_ix": [unique.index(sp) for sp in spans],
                "buffers": [
                    (torch.zeros((b, a1 - a0, f), pin_memory=pin),
                     torch.zeros((b, a1 - a0), pin_memory=pin),
                     torch.zeros((b, a1 - a0), pin_memory=pin))
                    for a0, a1 in unique],
            }
            self._span_plans[key] = plan
        else:
            for triple in plan["buffers"]:
                for a in triple:
                    a.zero_()
        return plan

    @staticmethod
    def _fill(spans: List[Tuple[int, int]],
              bufs: List[Tuple[torch.Tensor, ...]],
              requests: List[InferenceRequest],
              inds: List[np.ndarray]) -> None:
        """Write each request's rows into the staging: one (individual,
        mask, returns) triple per stock span, sorted (the one-device
        engine's is the one span (0, Nb)); padded tails stay zero."""
        views = [tuple(a.numpy() for a in t) for t in bufs]
        for i, (r, ind) in enumerate(zip(requests, inds)):
            n = ind.shape[0]
            m = None if r.mask is None else np.asarray(r.mask, np.float32)
            ret = (None if r.returns is None
                   else np.asarray(r.returns, np.float32))
            for (a0, a1), (bi, bm, br) in zip(spans, views):
                hi = min(n, a1)
                if hi <= a0:
                    break  # nothing of this request left
                bi[i, :hi - a0] = ind[a0:hi]
                bm[i, :hi - a0] = 1.0 if m is None else m[a0:hi]
                if ret is not None:
                    br[i, :hi - a0] = ret[a0:hi]

    def _put_spans(self, plan: Dict[str, Any], nb: int
                   ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                              torch.Tensor, torch.Tensor]:
        """The eager route's device inputs: each position's (individual,
        mask) span on its device, and the whole bucket's mask and returns
        on the first position's."""
        spans = []
        for pos, ix in zip(self._positions, plan["span_ix"]):
            bi, bm, _ = plan["buffers"][ix]
            spans.append((bi.to(pos.device, non_blocking=True),
                          bm.to(pos.device, non_blocking=True)))
        mask = torch.cat([t[1] for t in plan["buffers"]], dim=1)
        returns = torch.cat([t[2] for t in plan["buffers"]], dim=1)
        return (spans, mask.to(self.device, non_blocking=True),
                returns.to(self.device, non_blocking=True))

    def _span_state(self, pos: _Position, idx: List[int]
                    ) -> Optional[torch.Tensor]:
        if not self._uses_state:
            return None
        m0, m1 = pos.members
        return self._hs[m0:m1][:, idx].to(pos.device)

    @torch.inference_mode()
    def _forward_spans(self, plan: Dict[str, Any], nb: int, b: int,
                       idx: List[int]) -> Dict[str, torch.Tensor]:
        """The eager forward over the mesh: every position's weights on
        its device, gathered onto the first, then the cross-section."""
        spans, mask, returns = self._put_spans(plan, nb)
        gathered = torch.zeros((self.n_members, b, nb), device=self.device)
        for pos, ix, (ind, m) in zip(self._positions, plan["span_ix"],
                                     spans):
            with partition.on_device(pos.device):
                w = self._raw(pos.params, pos.packed,
                              self._span_state(pos, idx), ind, m)
            a0, a1 = plan["spans"][ix]
            gathered[pos.members[0]:pos.members[1], :, a0:a1].copy_(w)
        return self._join(gathered, mask, returns)

    def _capture_spans(self, nb: int, b: int) -> List[_SpanGraph]:
        """Capture one graph per position for the (nb, b) bucket: each
        position's weights over its span into a static output; the first
        position's graph also copies its own into the gathered [K, B, Nb]
        buffer (the others are copied there between replays) and runs the
        cross-section. Each forward runs once uncaptured first, as in
        :meth:`_capture`. Callers hold the dispatch lock."""
        f = self.cfg.individual_feature_dim
        w = nb // self._stock_shards
        dev0 = self.device
        gathered = torch.zeros((self.n_members, b, nb), device=dev0)
        mask_all = torch.zeros((b, nb), device=dev0)
        returns_all = torch.zeros((b, nb), device=dev0)
        graphs: List[Optional[_SpanGraph]] = [None] * len(self._positions)
        # the first position last: its graph reads what the others wrote
        for p in list(range(1, len(self._positions))) + [0]:
            pos = self._positions[p]
            dev = pos.device
            a0 = pos.stock_part * w
            m0, m1 = pos.members
            ind = torch.zeros((b, w, f), device=dev)
            mask = torch.zeros((b, w), device=dev)
            state = None
            if self._uses_state:
                state = torch.zeros((m1 - m0, b, self.state_dim),
                                    device=dev)
                state.copy_(self._hs[m0:m1, :1].expand(-1, b, -1))

            def body(pos=pos, ind=ind, mask=mask, state=state, p=p,
                     a0=a0, m0=m0, m1=m1):
                out_w = self._raw(pos.params, pos.packed, state, ind, mask)
                if p:
                    return {"w": out_w}
                gathered[m0:m1, :, a0:a0 + w].copy_(out_w)
                return self._join(gathered, mask_all, returns_all)

            with partition.on_device(dev):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side), torch.inference_mode():
                    body()
                side.synchronize()
                graph = torch.cuda.CUDAGraph()
                with self.events.span("serve/capture", bucket=nb, batch=b,
                                      position=p):
                    with torch.cuda.graph(graph, stream=side,
                                          capture_error_mode="thread_local"), \
                            torch.inference_mode():
                        out = body()
                torch.cuda.current_stream(dev).wait_stream(side)
            graphs[p] = _SpanGraph(graph, ind, mask, state, out)
            with self._lock:
                self._captures += 1
            self.events.counter("serve/capture", bucket=nb, batch=b,
                                position=p)
        graphs[0].gathered = gathered
        graphs[0].mask_all = mask_all
        graphs[0].returns_all = returns_all
        self._span_graphs[(nb, b)] = graphs
        return graphs

    @torch.inference_mode()
    def _dispatch_spans(self, nb: int, b: int, months: List[int],
                        plan: Dict[str, Any], graphs: bool
                        ) -> Dict[str, np.ndarray]:
        """One forward of filled span staging → host outputs. Callers
        hold the dispatch lock. ``graphs``: replay each position's graph
        (the first last); False runs the same steps eagerly."""
        idx = months + [months[0]] * (b - len(months))
        if not graphs:
            out = self._forward_spans(plan, nb, b, idx)
            return {k: v.cpu().numpy() for k, v in out.items()}
        gs = self._span_graphs.get((nb, b)) or self._capture_spans(nb, b)
        g0 = gs[0]
        for (a0, a1), (_, bm, br) in zip(plan["spans"], plan["buffers"]):
            g0.mask_all[:, a0:a1].copy_(bm, non_blocking=True)
            g0.returns_all[:, a0:a1].copy_(br, non_blocking=True)
        for p in list(range(1, len(gs))) + [0]:
            g, pos = gs[p], self._positions[p]
            bi, bm, _ = plan["buffers"][plan["span_ix"][p]]
            with partition.on_device(pos.device):
                g.individual.copy_(bi, non_blocking=True)
                g.mask.copy_(bm, non_blocking=True)
                if g.state is not None:
                    m0, m1 = pos.members
                    for i, m in enumerate(idx):
                        g.state[:, i].copy_(self._hs[m0:m1, m])
                g.graph.replay()
            if p:
                a0, a1 = plan["spans"][plan["span_ix"][p]]
                m0, m1 = pos.members
                g0.gathered[m0:m1, :, a0:a1].copy_(g.out["w"])
        out = {k: v.cpu().numpy() for k, v in g0.out.items()}
        with self._lock:
            self._replays += 1
        return out

    def warmup(self) -> int:
        """Allocate every (stock bucket, batch bucket)'s host staging and,
        on a CUDA device, capture its graph (one per mesh position) — so
        steady-state serving captures nothing and allocates no host memory.
        Returns the number of buckets warmed."""
        n = 0
        for nb in self.stock_buckets:
            for b in self.batch_buckets:
                with self._infer_lock:
                    if self._sharded_dispatch:
                        self._span_staging(nb, b)
                        if (self.uses_graphs
                                and (nb, b) not in self._span_graphs):
                            self._capture_spans(nb, b)
                    else:
                        self._staging_buffers(nb, b)
                        if self.uses_graphs and (nb, b) not in self._graphs:
                            with partition.on_device(self.device):
                                self._capture(nb, b)
                n += 1
        if self.uses_graphs:
            for dev in {p.device for p in self._positions} | {self.device}:
                torch.cuda.synchronize(dev)
        with self._lock:
            self._warmup_captures = self._captures
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

    @torch.inference_mode()
    def _dispatch(self, nb: int, b: int, months: List[int],
                  stage: Tuple[torch.Tensor, ...], graphs: bool
                  ) -> Dict[str, np.ndarray]:
        """One forward of a filled staging set → host outputs. Callers hold
        the dispatch lock. ``graphs``: replay the bucket's graph (captured
        now if warmup did not); False runs the same forward eagerly."""
        dev = self.device
        individual, mask, returns = stage
        # padded batch slots reuse the first request's month (their outputs
        # are dropped)
        idx = months + [months[0]] * (b - len(months))
        if not graphs:
            state = self._hs[:, idx] if self._uses_state else None
            out = self._fwd(state, individual.to(dev, non_blocking=True),
                            mask.to(dev, non_blocking=True),
                            returns.to(dev, non_blocking=True))
            return {k: v.cpu().numpy() for k, v in out.items()}
        with partition.on_device(dev):
            g = self._graphs.get((nb, b)) or self._capture(nb, b)
            g.individual.copy_(individual, non_blocking=True)
            g.mask.copy_(mask, non_blocking=True)
            g.returns.copy_(returns, non_blocking=True)
            if g.state is not None:
                # the macro state lives outside the graph (append_month
                # rebinds it): gather the months' rows into the static input
                for i, m in enumerate(idx):
                    g.state[:, i].copy_(self._hs[:, m])
            g.graph.replay()
        out = {k: v.cpu().numpy() for k, v in g.out.items()}
        with self._lock:
            self._replays += 1
        return out

    def infer(self, requests: List[InferenceRequest],
              flush: Optional[int] = None, observe: bool = True,
              graphs: bool = True) -> List[InferenceResult]:
        """Serve a micro-batch: every request pads to the largest one's
        stock bucket, the batch to its batch bucket. ``flush``: the batcher
        flush id, stamped onto the ``serve/dispatch`` span. ``observe=False``
        keeps the outputs out of the generation-quality gauges (the
        canary replay's route). ``graphs=False`` runs the bucket's forward
        eagerly instead of replaying its graph (on a CUDA device; the CPU
        has no graphs): the same kernels in the same order, for holding
        the two against each other."""
        if not requests:
            return []
        # fault-injection site: one hit per served micro-batch
        inject("serving/infer", n_requests=len(requests))
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
        attrs: Dict[str, Any] = dict(bucket=nb, batch=b,
                                     n_requests=len(requests))
        if flush is not None:
            attrs["flush"] = flush
        with self._infer_lock:
            months = self._resolve_months(requests)
            if self._sharded_dispatch:
                plan = self._span_staging(nb, b)
                self._fill(plan["spans"], plan["buffers"], requests, inds)
                attrs["shards"] = len(self._positions)
                with self.events.span("serve/dispatch", **attrs):
                    out = self._dispatch_spans(nb, b, months, plan,
                                               graphs and self.uses_graphs)
            else:
                stage = self._staging_buffers(nb, b)
                self._fill([(0, nb)], [stage], requests, inds)
                with self.events.span("serve/dispatch", **attrs):
                    out = self._dispatch(nb, b, months, stage,
                                         graphs and self.uses_graphs)
            # merged INSIDE the dispatch lock: a reload's quality reset
            # also runs under it, so a pre-swap batch never leaks its
            # stats into the post-swap generation's gauges
            if observe:
                self._observe_outputs(requests, out)
        with self._lock:
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

    def infer_one(self, request: InferenceRequest,
                  observe: bool = True) -> InferenceResult:
        return self.infer([request], observe=observe)[0]

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "n_members": self.n_members,
                "config_hash": self.config_hash,
                "params_fingerprint": self.params_fingerprint[:16],
                "params_generation": self.params_generation,
                "stock_buckets": list(self.stock_buckets),
                "batch_buckets": list(self.batch_buckets),
                "months": self.months,
                "cuda_graphs": self.uses_graphs,
                "captures": self._captures,
                # None before warmup() establishes the steady-state marker
                "steady_state_captures": (
                    self._captures - self._warmup_captures
                    if self._warmup_captures is not None else None),
                "captured_graphs": len(self._graphs) + sum(
                    len(g) for g in self._span_graphs.values()),
                "replays": self._replays,
                "dispatches": self._dispatches,
                "staging_buffers": len(self._staging) + len(
                    self._span_plans),
                "device": str(self.device),
                # the serving mesh: axes as laid out, its positions, and
                # whether dispatch stages per-position spans (False on the
                # one-device engine)
                "mesh": partition.mesh_spec_str(self._mesh),
                "mesh_devices": int(self._mesh.devices.size),
                "stock_shards": self._stock_shards,
                "member_axis": self._member_axis,
                "sharded_dispatch": self._sharded_dispatch,
                "ffn_route": ("plain" if self.exec_cfg.kernel == "off"
                              or self.device.type == "cpu" else "cuda"),
                "compute_dtype": self.exec_cfg.compute_dtype,
                "kernel_launches": sdf_ffn.launches,
                "kernel_launches_stream": sdf_ffn.launches_stream,
                "kernel_launches_stream_tiled":
                    sdf_ffn.launches_stream_tiled,
            }
