"""The PyTorch port's losses (ops/losses.py) and training metrics against
the JAX package's, on the same numpy-seeded ragged panel.

Tolerance: rtol 1e-5 (f32 reductions of a few hundred terms, only the
summation order differs), atol 1e-9 for the losses' tiny magnitudes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.ops import losses
from deeplearninginassetpricing_paperreplication_torch.ops import metrics
from deeplearninginassetpricing_paperreplication_tpu.ops import (
    losses as jlosses,
)
from deeplearninginassetpricing_paperreplication_tpu.ops import (
    metrics as jmetrics,
)

T, N, K = 9, 23, 4
TOL = dict(rtol=1e-5, atol=1e-9)


def _panel(seed=0, padded=0):
    """weights, returns, mask [T, N + padded] and moments; the padded
    columns are all-masked, as pad_stocks leaves them."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((T, N)) > 0.3).astype(np.float32)
    mask[0, :] = 0.0  # an empty period: N_t clamps to 1
    mask[:, 1] = 0.0  # an asset never observed: T_i clamps to 1
    w = rng.standard_normal((T, N)).astype(np.float32) * mask
    r = (0.1 * rng.standard_normal((T, N))).astype(np.float32) * mask
    h = np.tanh(rng.standard_normal((K, T, N))).astype(np.float32)
    pad = ((0, 0), (0, padded))
    return (np.pad(w, pad), np.pad(r, pad), np.pad(mask, pad),
            np.pad(h, ((0, 0),) + pad))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("weighted", [True, False])
def test_portfolio_returns_matches_jax(weighted):
    (jw, jr, jm, _), (w, r, m, _) = _both(*_panel())
    np.testing.assert_allclose(
        losses.portfolio_returns(w, r, m, weighted).numpy(),
        np.asarray(jlosses.portfolio_returns(jw, jr, jm, weighted)), **TOL)


@pytest.mark.parametrize("padded", [0, 9], ids=["n_assets_none",
                                                "n_assets_padded"])
@pytest.mark.parametrize("weighted", [True, False])
def test_unconditional_and_conditional_losses_match_jax(weighted, padded):
    (jw, jr, jm, jh), (w, r, m, h) = _both(*_panel(1, padded))
    n_assets = N if padded else None
    lu, F = losses.unconditional_loss(w, r, m, weighted, n_assets=n_assets)
    jlu, jF = jlosses.unconditional_loss(jw, jr, jm, weighted,
                                         n_assets=n_assets)
    np.testing.assert_allclose(float(lu), float(jlu), **TOL)
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), **TOL)
    lc, _ = losses.conditional_loss(w, r, m, h, weighted, F=F,
                                    n_assets=n_assets)
    jlc, _ = jlosses.conditional_loss(jw, jr, jm, jh, weighted, F=jF,
                                      n_assets=n_assets)
    np.testing.assert_allclose(float(lc), float(jlc), **TOL)


def test_padding_with_n_assets_leaves_the_losses_unchanged():
    _, (w, r, m, h) = _both(*_panel(2))
    _, (wp, rp, mp, hp) = _both(*_panel(2, padded=9))
    a, _ = losses.unconditional_loss(w, r, m)
    b, _ = losses.unconditional_loss(wp, rp, mp, n_assets=N)
    c, _ = losses.conditional_loss(w, r, m, h)
    d, _ = losses.conditional_loss(wp, rp, mp, hp, n_assets=N)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    np.testing.assert_allclose(float(c), float(d), rtol=1e-6)


@pytest.mark.parametrize("case", ["ragged", "zero_weights", "one_stock"])
def test_residual_loss_matches_jax(case):
    wn, rn, mn, _ = _panel(3)
    if case == "zero_weights":
        wn = wn.copy()
        wn[2:5] = 0.0  # w·w ≤ 1e-8: those periods leave the residual mean
    elif case == "one_stock":
        mn = np.zeros_like(mn)
        mn[:, 3] = 1.0  # < 2 stocks everywhere: the loss is 0
    (jw, jr, jm), (w, r, m) = _both(wn, rn, mn)
    got = float(losses.residual_loss(w, r, m))
    np.testing.assert_allclose(got, float(jlosses.residual_loss(jw, jr, jm)),
                               **TOL)
    if case == "one_stock":
        assert got == 0.0


def test_sharpe_monitor_and_max_drawdown_match_jax():
    rng = np.random.default_rng(4)
    x = (0.05 * rng.standard_normal(30)).astype(np.float32)
    np.testing.assert_allclose(
        float(metrics.sharpe_monitor(torch.from_numpy(x))),
        float(jmetrics.sharpe_monitor(jnp.asarray(x))), rtol=1e-5)
    assert metrics.max_drawdown(x) == pytest.approx(
        jmetrics.max_drawdown(x), rel=1e-12)
    assert metrics.max_drawdown(np.abs(x)) == 0.0
