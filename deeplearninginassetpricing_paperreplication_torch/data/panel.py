"""Panel dataset: the canonical [T, N, F] batch for the SDF-GAN.

NumPy only, as in the JAX package (``data/panel.py``), so the arrays are
identical; the port turns them into tensors on its device at the point of
use (:meth:`PanelDataset.to_batch`)::

    {"macro":      float32 [T, M]      (z-scored with TRAIN-set stats),
     "individual": float32 [T, N, F]   (0 where masked),
     "returns":    float32 [T, N]      (0 where masked),
     "mask":       float32 [T, N]      (1 = valid observation)}

An observation is valid iff the return is > -98.99 (sentinel -99.99 + 1),
not NaN, and every individual feature is > -98.99. Masked entries are
zero-filled so they are inert in the masked reductions downstream. The
decode runs in the native codec (``data/native.py``) when it is built,
else in NumPy; the two are bit for bit alike.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MISSING_VALUE = -99.99
_MISSING_THRESHOLD = MISSING_VALUE + 1  # reference: `> MISSING_VALUE + 1`

Batch = Dict[str, np.ndarray]


@dataclasses.dataclass
class PanelDataset:
    """A (T periods) × (N stocks) panel of returns + characteristics + macro."""

    returns: np.ndarray  # [T, N] float32, zero-filled where invalid
    individual: np.ndarray  # [T, N, F] float32, zero-filled where invalid
    mask: np.ndarray  # [T, N] bool
    macro: Optional[np.ndarray]  # [T, M] float32 (normalized) or None
    dates: np.ndarray  # [T] int64 YYYYMM
    variable_names: Optional[np.ndarray] = None
    mean_macro: Optional[np.ndarray] = None  # [1, M] stats used to normalize
    std_macro: Optional[np.ndarray] = None
    # true asset count when the stock axis has been padded (pad_stocks);
    # None = no padding. Exported into the batch so the losses divide their
    # asset-mean by the real N, keeping padded runs bit-equal to unpadded.
    n_assets: Optional[int] = None

    @property
    def T(self) -> int:
        return self.returns.shape[0]

    @property
    def N(self) -> int:
        return self.returns.shape[1]

    @property
    def individual_feature_dim(self) -> int:
        return self.individual.shape[2]

    @property
    def macro_feature_dim(self) -> int:
        return 0 if self.macro is None else self.macro.shape[1]

    def full_batch(self) -> Batch:
        """The whole panel as one batch of NumPy arrays."""
        batch = {
            "individual": self.individual,
            "returns": self.returns,
            "mask": self.mask.astype(np.float32),
        }
        if self.macro is not None:
            batch["macro"] = self.macro
        if self.n_assets is not None and self.n_assets != self.N:
            batch["n_assets"] = np.float32(self.n_assets)
        return batch

    def to_batch(self, device: Union[str, torch.device]
                 ) -> Dict[str, torch.Tensor]:
        """:meth:`full_batch` as float32 tensors on `device` (``n_assets``
        a 0-d tensor): a dense copy from pageable memory, the reference
        every route of ``data/transfer.py`` is held against. A read-only
        array (a cache hit's memmap) is copied first: a CPU tensor would
        otherwise alias it."""
        out = {}
        for k, v in self.full_batch().items():
            v = np.asarray(v)
            out[k] = torch.as_tensor(v if v.flags.writeable else v.copy(),
                                     dtype=torch.float32, device=device)
        return out

    def valid_per_period(self) -> np.ndarray:
        """N_t: count of valid stocks per period."""
        return self.mask.sum(axis=1).astype(np.float32)

    def macro_stats(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        return self.mean_macro, self.std_macro

    def subsample(self, n_periods: int, n_stocks: int) -> "PanelDataset":
        """First `n_periods` periods × the `n_stocks` stocks with most valid
        observations (the reference's create_small_sample)."""
        T = min(n_periods, self.T)
        N = min(n_stocks, self.N)
        valid_counts = self.mask.sum(axis=0)
        top = np.argsort(valid_counts)[-N:]
        return PanelDataset(
            returns=self.returns[:T, top],
            individual=self.individual[:T, top, :],
            mask=self.mask[:T, top],
            macro=None if self.macro is None else self.macro[:T],
            dates=self.dates[:T],
            variable_names=self.variable_names,
            mean_macro=self.mean_macro,
            std_macro=self.std_macro,
            # padded columns have no valid observation, so they rank lowest
            # and are kept only when N exceeds the real count; then the
            # losses must still divide by the real n_assets. When every
            # kept column is real, min() collapses to N and full_batch()
            # leaves the key out, as for an unpadded panel.
            n_assets=None if self.n_assets is None else min(self.n_assets, N),
        )

    def pad_stocks(self, multiple: int) -> "PanelDataset":
        """Pad the stock axis with masked-out zeros to a multiple of
        `multiple`. Padded entries have mask 0, so every masked reduction is
        unchanged, and the batch carries the real ``n_assets``."""
        pad = (-self.N) % multiple
        if pad == 0:
            return self
        return PanelDataset(
            returns=np.pad(self.returns, ((0, 0), (0, pad))),
            individual=np.pad(self.individual, ((0, 0), (0, pad), (0, 0))),
            mask=np.pad(self.mask, ((0, 0), (0, pad))),
            macro=self.macro,
            dates=self.dates,
            variable_names=self.variable_names,
            mean_macro=self.mean_macro,
            std_macro=self.std_macro,
            n_assets=self.n_assets if self.n_assets is not None else self.N,
        )


def _build_mask(returns: np.ndarray, individual: np.ndarray) -> np.ndarray:
    mask = (returns > _MISSING_THRESHOLD) & ~np.isnan(returns)
    mask &= np.all(individual > _MISSING_THRESHOLD, axis=2)
    return mask


def numpy_decode(data: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """data [T, N, 1+F] -> (returns [T, N], individual [T, N, F], mask
    [T, N] bool), masked entries zero-filled: the NumPy decode the native
    codec is held against."""
    returns = data[:, :, 0].astype(np.float32)
    individual = data[:, :, 1:].astype(np.float32)
    mask = _build_mask(returns, individual)
    returns = np.where(mask, returns, 0.0).astype(np.float32)
    individual = np.where(mask[:, :, None], individual, 0.0).astype(np.float32)
    return returns, individual, mask


def macro_train_stats(macro: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The train split's z-score stats."""
    mean = macro.mean(axis=0, keepdims=True)
    std = macro.std(axis=0, keepdims=True) + 1e-8
    return mean, std


def normalize_macro_with(
    macro: np.ndarray, mean: np.ndarray, std: np.ndarray
) -> np.ndarray:
    """Apply shared z-score stats (the one expression every split uses)."""
    return ((macro - mean) / std).astype(np.float32)


def load_panel(
    char_path: Union[str, Path],
    macro_path: Optional[Union[str, Path]] = None,
    macro_idx: Optional[Sequence[int]] = None,
    mean_macro: Optional[np.ndarray] = None,
    std_macro: Optional[np.ndarray] = None,
    normalize_macro: bool = True,
) -> PanelDataset:
    """Load one split from .npz files.

    The char .npz holds `data` [T, N, 1+F] with returns in channel 0, plus
    `date` and `variable`. The macro .npz holds `data` [T, M] and `date`;
    `macro_idx` keeps those series. With `normalize_macro` the macro series
    are z-scored: with `mean_macro`/`std_macro` when given (the train
    split's, for valid and test; both or neither), else with this split's
    own stats.
    """
    with np.load(char_path, allow_pickle=True) as f:
        data = f["data"]
        dates = f["date"] if "date" in f.files else np.arange(data.shape[0])
        variables = f["variable"] if "variable" in f.files else None

    decoded = None
    if data.dtype == np.float32:
        # the native one-pass codec; None while it builds or without a C++
        # toolchain, and then the NumPy decode
        from .native import decode_panel

        decoded = decode_panel(data, _MISSING_THRESHOLD)
    returns, individual, mask = (decoded if decoded is not None
                                 else numpy_decode(data))

    macro = None
    out_mean = out_std = None
    if macro_path is not None:
        with np.load(macro_path, allow_pickle=True) as f:
            macro = f["data"].astype(np.float32)
        if macro_idx is not None:
            macro = macro[:, list(macro_idx)]
        if normalize_macro:
            if (mean_macro is None) != (std_macro is None):
                raise ValueError(
                    "mean_macro and std_macro must be provided together "
                    f"(got mean={'set' if mean_macro is not None else 'None'}, "
                    f"std={'set' if std_macro is not None else 'None'})"
                )
            if mean_macro is None:
                out_mean, out_std = macro_train_stats(macro)
            else:
                out_mean, out_std = mean_macro, std_macro
            macro = normalize_macro_with(macro, out_mean, out_std)

    return PanelDataset(
        returns=returns,
        individual=individual,
        mask=mask,
        macro=macro,
        dates=np.asarray(dates),
        variable_names=variables,
        mean_macro=out_mean,
        std_macro=out_std,
    )


def load_splits(
    data_dir: Union[str, Path],
    macro_idx: Optional[Sequence[int]] = None,
) -> Tuple[PanelDataset, PanelDataset, PanelDataset]:
    """Load train/valid/test with train-set macro normalization applied to
    all three. Expects ``data_dir/char/Char_{split}.npz`` and
    ``data_dir/macro/macro_{split}.npz``."""
    data_dir = Path(data_dir)

    def load(name, normalize):
        return load_panel(data_dir / "char" / f"Char_{name}.npz",
                          data_dir / "macro" / f"macro_{name}.npz",
                          macro_idx=macro_idx, normalize_macro=normalize)

    # the splits are independent I/O + decode jobs (np.load and the native
    # codec release the GIL for the heavy parts)
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        f_train = ex.submit(load, "train", True)
        f_valid = ex.submit(load, "valid", False)
        f_test = ex.submit(load, "test", False)
        train, valid, test = (f_train.result(), f_valid.result(),
                              f_test.result())
    mean, std = train.macro_stats()
    for ds in (valid, test):
        if ds.macro is not None and mean is not None:
            ds.macro = normalize_macro_with(ds.macro, mean, std)
            ds.mean_macro, ds.std_macro = mean, std
    return train, valid, test
