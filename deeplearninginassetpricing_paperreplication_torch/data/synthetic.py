"""Seeded synthetic panel generator — fixture factory for tests and benches.

The JAX package's ``data/synthetic.py``, NumPy only: the same seed writes
the same .npz payloads in both packages.

Produces .npz files with the exact schema the loader expects (and the
reference ships: its ``src/generate_synthetic_data.py``): a latent
factor model with predictive characteristics, AR(1) macro series, realistic
entry/exit/gap missingness, and the -99.99 sentinel. The implementation here
is vectorized NumPy (the reference loops in Python over t, stocks, features);
outputs are schema-compatible, not bit-identical.

Schema:
    char/Char_{split}.npz : data [T, N, 1+F] (returns in channel 0), date [T]
                            int YYYYMM, variable [1+F] str
    macro/macro_{split}.npz : data [T, M], date [T]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

MISSING_VALUE = -99.99


def _ar1(rng: np.random.Generator, T: int, n: int, phi: np.ndarray, vol: np.ndarray) -> np.ndarray:
    """Vectorized AR(1): x_t = phi * x_{t-1} + vol * eps_t, x_0 = vol * eps_0."""
    eps = rng.standard_normal((T, n)) * vol
    out = np.empty((T, n))
    out[0] = eps[0]
    # scan over time (T is small; this loop is O(T) numpy ops, not O(T*n))
    for t in range(1, T):
        out[t] = phi * out[t - 1] + eps[t]
    return out


def _factor_returns(rng: np.random.Generator, T: int, n_factors: int, monthly_vol: float) -> np.ndarray:
    vols = monthly_vol * np.array([1.0, 0.6, 0.5, 0.7, 0.4])[:n_factors]
    return _ar1(rng, T, n_factors, np.full(n_factors, 0.1), vols)


def _loadings(rng: np.random.Generator, N: int, n_factors: int) -> np.ndarray:
    B = rng.standard_normal((N, n_factors))
    B[:, 0] = np.abs(B[:, 0]) + 0.5  # positive market beta
    return B


def _returns(rng: np.random.Generator, F: np.ndarray, B: np.ndarray, idio_vol: float) -> np.ndarray:
    T, N = F.shape[0], B.shape[0]
    idio = rng.standard_normal((T, N)) * (idio_vol * (0.5 + rng.random(N)))
    return F @ B.T + idio


def _characteristics(
    rng: np.random.Generator, T: int, N: int, n_feat: int, B: np.ndarray, noise: float
) -> np.ndarray:
    """Noisy proxies of loadings (predictive) + pure-noise features, then
    winsorized at [5, 95] pct and z-scored cross-sectionally per (t, feature)."""
    n_factors = B.shape[1]
    n_pred = min(n_factors * 2, n_feat // 2)
    chars = rng.standard_normal((T, N, n_feat))
    for i in range(n_pred):
        chars[:, :, i] = (
            B[None, :, i % n_factors]
            + rng.standard_normal((T, N)) * noise
            + rng.standard_normal((T, 1)) * 0.1
        )
    # winsorize + standardize, vectorized over (T, n_feat)
    lo = np.percentile(chars, 5, axis=1, keepdims=True)
    hi = np.percentile(chars, 95, axis=1, keepdims=True)
    chars = np.clip(chars, lo, hi)
    chars = (chars - chars.mean(axis=1, keepdims=True)) / (
        chars.std(axis=1, keepdims=True) + 1e-8
    )
    return chars


def _macro(rng: np.random.Generator, T: int, n_macro: int, F: np.ndarray) -> np.ndarray:
    phi = np.array([0.95, 0.90, 0.98, 0.85, 0.80, 0.92, 0.75, 0.70])
    phi = np.resize(phi, n_macro)
    m = _ar1(rng, T, n_macro, phi, np.full(n_macro, 0.1))
    # a few macro series lead the factors
    k = min(3, n_macro, F.shape[1])
    m[1:, :k] += 0.3 * F[:-1, :k]
    return m


def _missing_mask(
    rng: np.random.Generator, T: int, N: int, avg_coverage: float = 0.7, min_history: int = 12
) -> np.ndarray:
    """Entry/exit spans + random gaps + a per-period coverage floor."""
    max_start = max(0, T - min_history)
    starts = rng.integers(0, max_start + 1, size=N)
    ends = np.array(
        [rng.integers(min(T, s + min_history), T + 1) for s in starts]
    )
    t_idx = np.arange(T)[:, None]
    mask = (t_idx >= starts[None, :]) & (t_idx < ends[None, :])
    # random gaps for long-lived stocks
    for i in np.nonzero(ends - starts > 24)[0]:
        for _ in range(rng.integers(0, 3)):
            g0 = rng.integers(starts[i] + 6, ends[i] - 6)
            mask[g0 : min(g0 + rng.integers(1, 4), ends[i]), i] = False
    # coverage floor
    floor = avg_coverage * 0.5
    for t in range(T):
        short = int(N * floor - mask[t].sum())
        if short > 0:
            off = np.nonzero(~mask[t])[0]
            mask[t, rng.choice(off, min(short, off.size), replace=False)] = True
    return mask


def _dates(start_date: int, T: int) -> np.ndarray:
    year, month = divmod(start_date, 100)
    months = np.arange(T) + (month - 1)
    return (year + months // 12) * 100 + (months % 12 + 1)


def generate_dataset(
    n_periods: int,
    n_stocks: int,
    n_features: int = 46,
    n_macro: int = 8,
    n_factors: int = 5,
    seed: int = 42,
    start_date: int = 196703,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """One split's (char_dict, macro_dict), ready for np.savez."""
    rng = np.random.default_rng(seed)
    F = _factor_returns(rng, n_periods, n_factors, monthly_vol=0.02)
    B = _loadings(rng, n_stocks, n_factors)
    ret = _returns(rng, F, B, idio_vol=0.08)
    chars = _characteristics(rng, n_periods, n_stocks, n_features, B, noise=0.5)
    macro = _macro(rng, n_periods, n_macro, F)
    mask = _missing_mask(rng, n_periods, n_stocks)

    data = np.concatenate([ret[:, :, None], chars], axis=2).astype(np.float32)
    data = np.where(mask[:, :, None], data, np.float32(MISSING_VALUE))
    char_dict = {
        "data": data,
        "date": _dates(start_date, n_periods),
        "variable": np.array(["RET"] + [f"char_{i+1}" for i in range(n_features)]),
    }
    macro_dict = {"data": macro.astype(np.float32), "date": _dates(start_date, n_periods)}
    return char_dict, macro_dict


def generate_all_splits(
    output_dir,
    n_periods_train: int = 120,
    n_periods_valid: int = 30,
    n_periods_test: int = 60,
    n_stocks: int = 1000,
    n_features: int = 46,
    n_macro: int = 8,
    seed: int = 42,
    verbose: bool = True,
    compress: bool = True,
) -> Path:
    """Simulate ONE long panel and slice it into train/valid/test so the three
    splits share factors/loadings/missingness (reference
    generate_synthetic_data.py:482-531 does the same)."""
    output_dir = Path(output_dir)
    (output_dir / "char").mkdir(parents=True, exist_ok=True)
    (output_dir / "macro").mkdir(parents=True, exist_ok=True)

    T_total = n_periods_train + n_periods_valid + n_periods_test
    rng = np.random.default_rng(seed)
    F = _factor_returns(rng, T_total, 5, monthly_vol=0.02)
    B = _loadings(rng, n_stocks, 5)
    ret = _returns(rng, F, B, idio_vol=0.08)
    chars = _characteristics(rng, T_total, n_stocks, n_features, B, noise=0.5)
    macro = _macro(rng, T_total, n_macro, F)
    mask = _missing_mask(rng, T_total, n_stocks)

    bounds = {
        "train": (0, n_periods_train),
        "valid": (n_periods_train, n_periods_train + n_periods_valid),
        "test": (n_periods_train + n_periods_valid, T_total),
    }
    # compress=False writes plain .npz — at real-panel sizes (~0.5 GB/split)
    # single-core deflate dominates generation time for no benefit on a bench
    savez = np.savez_compressed if compress else np.savez
    for split, (a, b) in bounds.items():
        data = np.concatenate([ret[a:b, :, None], chars[a:b]], axis=2).astype(np.float32)
        data = np.where(mask[a:b, :, None], data, np.float32(MISSING_VALUE))
        start = int(_dates(196703, T_total)[a])
        savez(
            output_dir / "char" / f"Char_{split}.npz",
            data=data,
            date=_dates(start, b - a),
            variable=np.array(["RET"] + [f"char_{i+1}" for i in range(n_features)]),
        )
        savez(
            output_dir / "macro" / f"macro_{split}.npz",
            data=macro[a:b].astype(np.float32),
            date=_dates(start, b - a),
        )
        if verbose:
            print(f"  wrote {split}: T={b-a}, N={n_stocks}, F={n_features}, M={n_macro}")
    return output_dir


def generate_panel_split(
    output_dir,
    split: str = "train",
    *,
    n_periods: int,
    n_stocks: int,
    n_features: int = 46,
    n_macro: int = 8,
    seed: int = 42,
    compress: bool = False,
    verbose: bool = False,
) -> Path:
    """ONE split's npz pair at an arbitrary — possibly very large — N: the
    dataplane bench's fixture factory (a 100k-stock panel is ~0.5 GB; three
    shared-factor splits would triple the generation and disk cost for a
    bench that only loads one). Uncompressed by default: single-core
    deflate of hundreds of MB would dominate the bench setup for nothing."""
    output_dir = Path(output_dir)
    (output_dir / "char").mkdir(parents=True, exist_ok=True)
    (output_dir / "macro").mkdir(parents=True, exist_ok=True)
    char_dict, macro_dict = generate_dataset(
        n_periods, n_stocks, n_features, n_macro, seed=seed
    )
    savez = np.savez_compressed if compress else np.savez
    savez(output_dir / "char" / f"Char_{split}.npz", **char_dict)
    savez(output_dir / "macro" / f"macro_{split}.npz", **macro_dict)
    if verbose:
        print(f"  wrote {split}: T={n_periods}, N={n_stocks}, "
              f"F={n_features}, M={n_macro}")
    return output_dir


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate synthetic asset-pricing panel data")
    p.add_argument("--output_dir", type=str, default="./synthetic_data")
    p.add_argument("--n_periods_train", type=int, default=120)
    p.add_argument("--n_periods_valid", type=int, default=30)
    p.add_argument("--n_periods_test", type=int, default=60)
    p.add_argument("--n_stocks", type=int, default=1000)
    p.add_argument("--n_features", type=int, default=46)
    p.add_argument("--n_macro", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    out = generate_all_splits(
        args.output_dir,
        n_periods_train=args.n_periods_train,
        n_periods_valid=args.n_periods_valid,
        n_periods_test=args.n_periods_test,
        n_stocks=args.n_stocks,
        n_features=args.n_features,
        n_macro=args.n_macro,
        seed=args.seed,
    )
    print(f"Synthetic data written to {out.resolve()}")


if __name__ == "__main__":
    main()
