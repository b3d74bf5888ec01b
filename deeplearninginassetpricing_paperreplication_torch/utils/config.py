"""Typed, validated model configuration, and how to execute it.

:class:`GANConfig` is field for field the JAX package's: the same
``config.json`` keys (the reference's), the same legacy aliases and derived
keys, the same strictness (unknown keys raise, or warn when loading a file).
Checkpoint directories are interchangeable between the two packages.

:class:`ExecutionConfig` is the port's own: which device, whether the SDF
FFN runs in the CUDA kernel, and the kernel's operand dtype.

:class:`TrainConfig` is the 3-phase schedule, field for field the JAX
package's, with its validation.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import torch


def _as_tuple(x: Union[int, Sequence[int], None]) -> Tuple[int, ...]:
    if x is None:
        return ()
    if isinstance(x, int):
        return (x,)
    return tuple(int(v) for v in x)


# Keys the reference accepts but never reads, and keys it derives from
# others: accepted for config.json compatibility, carrying no information.
_DERIVED_KEYS = {
    "num_layers",
    "num_layers_rnn",
    "num_layers_moment",
    "num_layers_rnn_moment",
    "cell_type_rnn",
    "cell_type_rnn_moment",
}

# Misnamed keys seen in the reference's notebooks → the canonical key.
_LEGACY_ALIASES = {
    "rnn_hidden_dim": "num_units_rnn",
    "rnn_hidden_dim_moment": "num_units_rnn_moment",
    "num_moments": "num_condition_moment",
}


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """Configuration of the SDF-GAN (generator + discriminator)."""

    macro_feature_dim: int
    individual_feature_dim: int

    # SDF network (generator). Paper: [64, 64] hidden, LSTM [4] over macro.
    hidden_dim: Tuple[int, ...] = (64, 64)
    use_rnn: bool = True
    num_units_rnn: Tuple[int, ...] = (4,)

    # Moment network (discriminator). Paper: no hidden layers, 8 moments.
    hidden_dim_moment: Tuple[int, ...] = ()
    num_condition_moment: int = 8
    # accepted but inert in the reference: no RNN is built for the moment net
    use_rnn_moment: bool = True
    num_units_rnn_moment: Tuple[int, ...] = (32,)

    # Regularization / loss shaping.
    dropout: float = 0.05
    normalize_w: bool = True
    weighted_loss: bool = True
    residual_loss_factor: float = 0.0

    def __post_init__(self):
        if self.macro_feature_dim < 0 or self.individual_feature_dim <= 0:
            raise ValueError(
                f"Invalid feature dims: macro={self.macro_feature_dim}, "
                f"individual={self.individual_feature_dim}"
            )
        object.__setattr__(self, "hidden_dim", _as_tuple(self.hidden_dim))
        object.__setattr__(self, "num_units_rnn", _as_tuple(self.num_units_rnn))
        object.__setattr__(self, "hidden_dim_moment",
                           _as_tuple(self.hidden_dim_moment))
        object.__setattr__(self, "num_units_rnn_moment",
                           _as_tuple(self.num_units_rnn_moment))
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1): {self.dropout}")
        if self.num_condition_moment <= 0:
            raise ValueError(
                f"num_condition_moment must be > 0: {self.num_condition_moment}")
        if self.use_rnn and not self.num_units_rnn:
            raise ValueError("use_rnn=True requires non-empty num_units_rnn")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], strict: bool = True) -> "GANConfig":
        """Build from a reference-style config dict. Unknown keys raise
        (strict=True) or warn; legacy aliases map with a warning."""
        known = {f.name for f in dataclasses.fields(cls)}
        clean: Dict[str, Any] = {}
        for k, v in d.items():
            if k in known:
                clean[k] = v
            elif k in _LEGACY_ALIASES:
                canonical = _LEGACY_ALIASES[k]
                warnings.warn(
                    f"Config key {k!r} is a known misnaming of {canonical!r} "
                    f"(the reference silently ignores it); mapping it."
                )
                clean.setdefault(canonical, v)
            elif k in _DERIVED_KEYS:
                continue  # informational only; re-derived on to_dict()
            elif strict:
                raise KeyError(
                    f"Unknown config key {k!r}. Known keys: {sorted(known)}; "
                    f"legacy aliases: {sorted(_LEGACY_ALIASES)}"
                )
            else:
                warnings.warn(f"Ignoring unknown config key {k!r}")
        return cls(**clean)

    def to_dict(self) -> Dict[str, Any]:
        """Dict shaped like the reference's config.json (incl. derived keys)."""
        d = dataclasses.asdict(self)
        for k in ("hidden_dim", "num_units_rnn", "hidden_dim_moment",
                  "num_units_rnn_moment"):
            d[k] = list(getattr(self, k))
        d["num_layers"] = len(self.hidden_dim)
        d["num_layers_rnn"] = len(self.num_units_rnn)
        d["num_layers_moment"] = len(self.hidden_dim_moment)
        d["num_layers_rnn_moment"] = len(self.num_units_rnn_moment)
        d["cell_type_rnn"] = "lstm"
        d["cell_type_rnn_moment"] = "lstm"
        return d

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: Union[str, Path]) -> "GANConfig":
        return cls.from_dict(json.loads(Path(path).read_text()), strict=False)

    @property
    def sdf_input_dim(self) -> int:
        macro = (
            self.num_units_rnn[-1]
            if (self.use_rnn and self.macro_feature_dim > 0)
            else self.macro_feature_dim
        )
        return macro + self.individual_feature_dim

    @property
    def moment_input_dim(self) -> int:
        # the moment net reads the RAW macro, not the LSTM state
        return self.macro_feature_dim + self.individual_feature_dim


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on. Asking for CUDA on a host without
    a CUDA device is an error, never a quiet move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch finds no CUDA "
            "device; pass --device cpu (device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu: {str(device)!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """How to execute the model — NOT a model hyperparameter.

    kernel: "auto" runs the SDF FFN in the CUDA kernel
        (ops/sdf_ffn.py) on a CUDA device and in its plain PyTorch version
        on the CPU; "on" insists on the kernel (a CPU tensor is an error);
        "off" runs the plain version on any device. The counterpart of the
        JAX package's ``ExecutionConfig.pallas_ffn``.
    compute_dtype: operand dtype of the kernel's products (f32
        accumulation always); bfloat16 is the JAX package's default too.
    bf16_panel: store the feature-major panel ``individual_t`` in bfloat16
        on the kernel route (:meth:`stores_bf16_panel`), halving its bytes,
        as the JAX package's ``ExecutionConfig.bf16_panel`` does (its
        default, True, too); ``individual`` stays f32. Under bf16 compute
        the kernels round x to bf16 before every product anyway, so the
        bf16 panel changes no number there; under f32 compute it rounds the
        panel. Set False for bit-level f32 comparisons (the CLIs' f32
        compute does). Evaluation and serving rebuild an f32 panel.
    device: where the entry points put the model and the data.
    shard: this rank's place in a stock-sharded run
        (``parallel.collectives.StockShard``: its span of the padded stock
        axis, the world size, the process group), or None. Under it every
        sum over stocks is all-reduced and the FFN's dropout hash keys on
        the global stock index; None, or a world of 1, is the unsharded
        route (the counterpart of the JAX package's ``shard_mesh`` and
        ``shard_axis``).
    """

    kernel: str = "auto"
    compute_dtype: str = "bfloat16"
    bf16_panel: bool = True
    device: str = "cuda"
    shard: Any = None

    def __post_init__(self):
        if self.kernel not in ("auto", "on", "off"):
            raise ValueError(f"kernel must be auto|on|off: {self.kernel!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32|bfloat16: "
                             f"{self.compute_dtype!r}")

    def stores_bf16_panel(self, cfg: GANConfig) -> bool:
        """Does ``GAN.prepare_batch`` store ``individual_t`` in bfloat16 for
        `cfg`? The JAX package's ``bf16_panel and
        use_pallas(cfg.hidden_dim)``: the flag is set, the SDF net has
        hidden layers (the fused FFN runs) and the kernel route is on:
        ``kernel="on"``, or ``"auto"`` on a CUDA device (JAX's ``"auto"``
        means a TPU). On the CPU ``"auto"`` is the plain route, so the panel
        stays f32 there."""
        kernel_route = self.kernel == "on" or (
            self.kernel == "auto" and torch.device(self.device).type == "cuda")
        return self.bf16_panel and bool(cfg.hidden_dim) and kernel_route

    def bf16_wire_ok(self, cfg: GANConfig) -> bool:
        """May the panel ship bfloat16 to the device for `cfg`
        (``data/transfer.py``)? Only where every consumer of `individual`
        rounds it to bf16 (round to nearest even) before any product, so a
        bf16-rounded f32 panel computes bit for bit what the f32 panel
        does. The kernel route on a CUDA device with compute_dtype bfloat16
        gives that, where:

        * the SDF net has hidden layers the fused FFN's kernel route takes
          (``sdf_ffn.kernel_route_takes``: the resident kernels, or past
          them the streamed-weight route, up to its width, depth and F):
          both routes' forward and dW backward round x as they read it
          (``ops/sdf_ffn.py``); with no hidden layer
          ``models/networks.sdf_raw_weights`` reads x in f32;
        * the moment net is the default one (no hidden layer) with macro
          data, at any number of moments: the fused conditional-EM rounds x
          in every launch, and above ``MAX_MOMENTS`` every moment chunk's
          launch does (its panel cotangent reads the panel widened to f32,
          exactly) (``ops/cond_em.py``); any other moment net goes through
          ``moment_h_members``, which reads x in f32.

        The plain route (a CPU device or ``kernel="off"``) is excluded: it
        is the route the f32 checks read. Under a stock shard the same
        holds per shard: each rank's kernels read only its own span."""
        from ..ops import sdf_ffn

        if (self.kernel == "off" or self.compute_dtype != "bfloat16"
                or torch.device(self.device).type != "cuda"):
            return False
        if not cfg.hidden_dim or not sdf_ffn.kernel_route_takes(
                cfg.individual_feature_dim, cfg.hidden_dim):
            return False
        return (not cfg.hidden_dim_moment and cfg.macro_feature_dim > 0
                and cfg.num_condition_moment >= 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """3-phase training schedule (the reference CLI's defaults)."""

    num_epochs_unc: int = 256
    num_epochs_moment: int = 64
    num_epochs: int = 1024
    lr: float = 1e-3
    grad_clip: float = 1.0
    ignore_epoch: int = 64
    seed: int = 42
    print_freq: int = 128

    def __post_init__(self):
        for name in ("num_epochs_unc", "num_epochs_moment", "num_epochs"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.lr <= 0:
            raise ValueError("lr must be > 0")
