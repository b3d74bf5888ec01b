"""Checkpoints: reference ``.pt`` run directories (load and save), and the
weight bridge from the JAX package's parameter tree.

A run directory holds ``config.json`` (the reference's keys) beside
``best_model_sharpe.pt`` / ``best_model_loss.pt`` / ``final_model.pt``, each
a reference ``AssetPricingGAN.state_dict()``. The port's
``models.networks.AssetPricingModule`` carries the reference's module
names, so these load with ``load_state_dict(strict=True)``.

The trainer writes the same layout (:func:`save_state_dict`,
:func:`save_history`), so its run directories load back strictly. Every
``.pt`` the port writes goes through ``reliability/verified.py``, as the JAX
package's ``save_params`` does: tmp + ``os.replace``, a ``.sha256``
sidecar, and the previous file rotated to ``.g1``; a load falls back a
generation past a corrupt newest file. Files without a sidecar (the
reference's ``ref_runs/*/*.pt``) load unchecked. The JAX package's flax
``.msgpack`` checkpoints load too (:func:`load_params`): a stdlib reader
(``utils/flax_msgpack.py``) decodes them and the weight bridge maps the
tree, so a run directory either package wrote serves, evaluates and gates
here.

A trained ensemble is a member-stacked dict (the same keys, each tensor
[S, ...]): :func:`stacked_state_dict_from_jax_params` bridges the JAX
package's vmapped params into one, and :func:`member_state_dicts` splits
one into per-member ``state_dict``s for saving, one run directory each.
"""

from __future__ import annotations

import io
import os
import warnings
from pathlib import Path
from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from ..reliability.verified import (
    load_verified,
    verified_exists,
    write_verified,
)
from ..utils import flax_msgpack
from ..utils.config import GANConfig


def load_checkpoint_dir(
    ckpt_dir: Union[str, Path],
    which: str = "best_model_sharpe",
) -> Tuple[GANConfig, Dict[str, torch.Tensor]]:
    """(config, state_dict) from a run directory, in the JAX package's
    candidate order: the requested artifact as flax ``.msgpack``, then as
    ``.pt``, then, for a ``best_model*`` request only, ``final_model``'s
    (a run whose schedule never passed ``ignore_epoch`` writes no best
    model), with a warning. Either format may survive only as a ``.g1``
    generation. Reads through ``load_verified``: a newest file whose digest
    or parse fails falls back to ``.g1``; when every generation is unusable
    the ``ValueError`` names each file."""
    ckpt_dir = Path(ckpt_dir)
    cfg = GANConfig.load(ckpt_dir / "config.json")
    names = [which] + (["final_model"] if which.startswith("best_model")
                       else [])
    for name in names:
        for suffix in (".msgpack", ".pt"):
            path = ckpt_dir / f"{name}{suffix}"
            if not verified_exists(path):
                continue
            if name != which:
                warnings.warn(f"{which} absent in {ckpt_dir} (best tracker "
                              f"never updated); using {path.name}")
            if suffix == ".msgpack":
                return cfg, load_params(path, cfg)
            sd, _ = load_verified(path, _parse_state_dict)
            return cfg, sd
    raise FileNotFoundError(f"no {which}(.msgpack|.pt) or final_model "
                            f"fallback in {ckpt_dir}")


def read_flax_params(path: Union[str, Path]) -> Dict[str, Any]:
    """The JAX package's params tree (NumPy leaves) from a flax ``.msgpack``
    written by its ``save_params``, through ``load_verified`` (sidecar
    checked, ``.g1`` fallback). A file that does not decode raises a
    ``ValueError`` naming it."""
    path = Path(path)

    def parse(data: bytes) -> Dict[str, Any]:
        try:
            tree = flax_msgpack.loads(data)
        except ValueError as e:
            raise ValueError(f"corrupt or truncated checkpoint msgpack "
                             f"{path}: {e}") from None
        if not isinstance(tree, dict):
            raise ValueError(f"checkpoint msgpack {path} holds no params "
                             "tree")
        return tree

    tree, _ = load_verified(path, parse)
    return tree


def load_params(path: Union[str, Path],
                cfg: GANConfig) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of the GAN whose JAX params the flax
    ``.msgpack`` at `path` holds (:func:`read_flax_params`, then
    :func:`state_dict_from_jax_params`). A tree that does not fit `cfg`
    raises a ``ValueError`` naming the file."""
    tree = read_flax_params(path)
    try:
        return state_dict_from_jax_params(tree, cfg)
    except (KeyError, TypeError) as e:
        raise ValueError(f"checkpoint msgpack {path} does not fit the "
                         f"config: missing {e}") from None


def _parse_state_dict(data: bytes) -> Dict[str, torch.Tensor]:
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)


def state_dict_from_jax_params(params_np: Mapping[str, Any],
                               cfg: GANConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's params tree (as NumPy arrays) → the port's
    ``state_dict``.

    JAX tree (flax): ``sdf_net/{macro_lstm/{w_ih_l0, w_hh_l0, b_ih_l0,
    b_hh_l0}, TorchDense_i/Dense_0/{kernel, bias}, output_proj/Dense_0/...}``
    and ``moment_net/{TorchDense_i, output_proj}/Dense_0/...``; kernels are
    [fan_in, fan_out], so torch weights are their transposes. The Linear of
    hidden layer i sits at index 3·i of ``fc_layers`` (Linear, ReLU,
    Dropout).
    """
    sd: Dict[str, torch.Tensor] = {}

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def put_dense(prefix: str, tree: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = t(np.asarray(tree["Dense_0"]["kernel"]).T)
        sd[f"{prefix}.bias"] = t(tree["Dense_0"]["bias"])

    sdf = params_np["sdf_net"]
    if cfg.use_rnn and cfg.macro_feature_dim > 0:
        lstm = sdf["macro_lstm"]
        for li in range(len(cfg.num_units_rnn)):
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                sd[f"sdf_net.macro_lstm.lstm.{theirs}_l{li}"] = t(
                    lstm[f"{ours}_l{li}"])
    for i in range(len(cfg.hidden_dim)):
        put_dense(f"sdf_net.fc_layers.{3 * i}", sdf[f"TorchDense_{i}"])
    put_dense("sdf_net.output_proj", sdf["output_proj"])
    moment = params_np["moment_net"]
    for i in range(len(cfg.hidden_dim_moment)):
        put_dense(f"moment_net.fc_layers.{3 * i}", moment[f"TorchDense_{i}"])
    put_dense("moment_net.output_proj", moment["output_proj"])
    return sd


def simple_sdf_state_dict_from_jax_params(params_np: Mapping[str, Any],
                                          n_hidden: int
                                          ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``SimpleSDF`` params (``TorchDense_i/Dense_0/
    {kernel, bias}`` for i = 0…n_hidden, the last one the output layer, as
    NumPy arrays) → the port's :class:`~..models.networks.SimpleSDF`
    ``state_dict`` (``fc_layers.{3i}`` and ``output_proj``)."""
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for i in range(n_hidden + 1):
        dense = params_np[f"TorchDense_{i}"]["Dense_0"]
        prefix = "output_proj" if i == n_hidden else f"fc_layers.{3 * i}"
        sd[f"{prefix}.weight"] = t(np.asarray(dense["kernel"]).T)
        sd[f"{prefix}.bias"] = t(dense["bias"])
    return sd


def _member_tree(tree: Mapping[str, Any], s: int) -> Dict[str, Any]:
    return {k: _member_tree(v, s) if isinstance(v, Mapping)
            else np.asarray(v)[s] for k, v in tree.items()}


def _first_leaf(tree: Mapping[str, Any]):
    v = next(iter(tree.values()))
    return _first_leaf(v) if isinstance(v, Mapping) else v


def stacked_state_dict_from_jax_params(vparams_np: Mapping[str, Any],
                                       cfg: GANConfig
                                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's member-stacked params tree (every leaf [S, ...],
    as NumPy arrays, e.g. ``jax.device_get`` of ``train_ensemble``'s
    params) → the port's member-stacked ``state_dict`` [S, ...]: member s
    is :func:`state_dict_from_jax_params` of the tree's slice s."""
    S = np.shape(_first_leaf(vparams_np))[0]
    sds = [state_dict_from_jax_params(_member_tree(vparams_np, s), cfg)
           for s in range(S)]
    return {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}


def member_state_dicts(stacked: Mapping[str, torch.Tensor]
                       ) -> List[Dict[str, torch.Tensor]]:
    """A member-stacked ``state_dict`` [S, ...] → S reference-layout
    ``state_dict``s (CPU tensors), member order kept."""
    S = next(iter(stacked.values())).shape[0]
    return [{k: v[s].detach().cpu().clone() for k, v in stacked.items()}
            for s in range(S)]


def save_state_dict(path: Union[str, Path],
                    state_dict: Mapping[str, torch.Tensor]) -> None:
    """A reference-layout ``state_dict`` as a ``.pt`` file (CPU tensors),
    through ``write_verified``: atomic, with a ``.sha256`` sidecar, the
    previous file kept as ``.g1``."""
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu().clone() for k, v in state_dict.items()},
               buf)
    write_verified(Path(path), buf.getvalue())


def save_history(save_dir: Union[str, Path],
                 history: Mapping[str, Any]) -> None:
    """``history.npz`` (the per-epoch series and the ``phase`` labels),
    written atomically."""
    save_dir = Path(save_dir)
    tmp = save_dir / "history.npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in history.items()})
    os.replace(tmp, save_dir / "history.npz")
