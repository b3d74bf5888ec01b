"""The port's SimpleSDF baseline against the JAX package's, on the CPU.

The same numpy panel, the JAX ``SimpleSDF.init`` params bridged through
``simple_sdf_state_dict_from_jax_params``, f32, dropout 0:

* ``SimpleSDF`` and ``simple_sdf_forward`` with and without macro, at the
  default widths (32, 16) and with no hidden layer, on a panel with whole
  masked rows: weights atol 1e-6; loss, monitor Sharpe and portfolio
  returns rtol 2e-4.
* ``fit_simple_sdf`` from the JAX init against ``train_simple_sdf``: 10
  epochs, every history key every epoch at rtol 2e-4 (losses) and 1e-3
  (Sharpes).
* The public ``train_simple_sdf`` from a seed: finite, and bit for bit
  repeatable with dropout.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.networks import (
    SimpleSDF,
    simple_sdf_forward,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    simple_sdf_state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.training.joint import (
    SIMPLE_KEYS,
    fit_simple_sdf,
    train_simple_sdf,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.networks import (
    SimpleSDF as JSimpleSDF,
)
from deeplearninginassetpricing_paperreplication_tpu.models.networks import (
    simple_sdf_forward as jsimple_sdf_forward,
)
from deeplearninginassetpricing_paperreplication_tpu.training.joint import (
    train_simple_sdf as jtrain_simple_sdf,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
T, N, F, M = 10, 24, 4, 3


def panel(macro=True, masked_rows=False, seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.random((T, N)) > 0.3).astype(np.float32)
    if masked_rows:
        mask[3] = 0.0  # a period with no valid stock
        mask[:, 5] = 0.0  # a stock never valid
    batch = {
        "individual": (rng.standard_normal((T, N, F))
                       * mask[:, :, None]).astype(np.float32),
        "returns": (rng.standard_normal((T, N)) * 0.05
                    * mask).astype(np.float32),
        "mask": mask,
    }
    if macro:
        batch["macro"] = rng.standard_normal((T, M)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _pair(batch, hidden, seed=3):
    """(JAX model, JAX params, port model) from the same start."""
    md = M if "macro" in batch else 0
    jm = JSimpleSDF(macro_dim=md, individual_dim=F, hidden_dims=hidden,
                    dropout=0.0)
    params = jm.init({"params": jax.random.key(seed)}, batch.get("macro"),
                     batch["individual"], batch["mask"], True)["params"]
    model = SimpleSDF(md, F, hidden, 0.0, CPU_F32)
    model.load_state_dict(simple_sdf_state_dict_from_jax_params(
        jax.device_get(params), len(hidden)))
    return jm, params, model


CASES = [(macro, hidden, rows) for macro in (True, False)
         for hidden in ((32, 16), ()) for rows in (False, True)]


@pytest.mark.parametrize("macro,hidden,masked_rows", CASES,
                         ids=[f"{'macro' if m else 'nomacro'}-h{len(h)}-"
                              f"{'rows' if r else 'dense'}"
                              for m, h, r in CASES])
def test_forward_matches_jax(macro, hidden, masked_rows):
    batch = panel(macro, masked_rows)
    jm, params, model = _pair(batch, hidden)
    jout = jsimple_sdf_forward(jm, params, batch)
    with torch.no_grad():
        out = simple_sdf_forward(model, _tb(batch))
    np.testing.assert_allclose(out["weights"].numpy(),
                               np.asarray(jout["weights"]), atol=1e-6)
    for k in ("loss", "sharpe", "portfolio_returns"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=2e-4, atol=1e-9, err_msg=k)
    if masked_rows:
        assert float(out["weights"][3].abs().max()) == 0.0


@pytest.mark.parametrize("macro", [True, False], ids=["macro", "nomacro"])
def test_training_matches_jax(macro):
    batch = panel(macro)
    _, _, model = _pair(batch, (32, 16))
    md = M if macro else 0
    _, _, jhist = jtrain_simple_sdf(md, F, batch, batch, hidden_dims=(32, 16),
                                    dropout=0.0, num_epochs=10, seed=3)
    hist = fit_simple_sdf(model, _tb(batch), _tb(batch), num_epochs=10,
                          seed=3)
    assert set(hist) == set(jhist) == set(SIMPLE_KEYS)
    for k in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=2e-4, err_msg=k)
    for k in ("train_sharpe", "valid_sharpe"):
        np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-3, err_msg=k)


def test_train_simple_sdf_from_a_seed_repeats():
    batch = _tb(panel(seed=2))
    runs = [train_simple_sdf(M, F, batch, batch, dropout=0.1, num_epochs=5,
                             seed=4, exec_cfg=CPU_F32) for _ in range(2)]
    (m0, h0), (m1, h1) = runs
    assert isinstance(m0, SimpleSDF) and m0.hidden_dims == (32, 16)
    for k in SIMPLE_KEYS:
        assert h0[k].shape == (5,) and np.isfinite(h0[k]).all(), k
        np.testing.assert_array_equal(h0[k], h1[k], err_msg=k)
    for (k, a), b in zip(m0.state_dict().items(), m1.state_dict().values()):
        assert torch.equal(a, b), k


def test_macro_mismatch_is_refused():
    batch = _tb(panel(macro=False))
    model = SimpleSDF(M, F, (8,), 0.0, CPU_F32)
    with pytest.raises(ValueError, match="macro_dim 3"):
        simple_sdf_forward(model, batch)
