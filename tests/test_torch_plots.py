"""The port's figures and summary table against the JAX package's ``plots``.

Two run directories trained by the JAX package (its ``train_3phase``, the
first with ``diag_stride`` 2, so its history carries the model-health
fields) are read by both packages; the port reads their flax ``.msgpack``
files through its stdlib reader.

* ``summary_statistics``: every number against the JAX one, f32, rtol
  1e-5 (atol 1e-8, the f32 resolution of these returns: std 2e-2 × 2⁻²³).
* ``_dates_from_panel``: exact, on the panel's YYYYMM dates and on index
  dates (the 1967-03 fallback).
* ``generate_all_plots``: 5 + 2 figures when the first run dir's history
  has ``diag_*`` fields, 5 when it has none.
* Without matplotlib (``sys.modules['matplotlib'] = None``),
  ``summary_statistics`` still runs and the CLI exits non-zero naming it.
"""

import sys
import types

import jax
import numpy as np
import pytest

from deeplearninginassetpricing_paperreplication_torch import plots
from deeplearninginassetpricing_paperreplication_torch.data.panel import (
    load_splits,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu import plots as jplots
from deeplearninginassetpricing_paperreplication_tpu.data.panel import (
    load_splits as jload_splits,
)
from deeplearninginassetpricing_paperreplication_tpu.training.trainer import (
    train_3phase,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig,
    TrainConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
SCHEDULE = TrainConfig(num_epochs_unc=4, num_epochs_moment=2, num_epochs=4,
                       ignore_epoch=1)


@pytest.fixture(scope="module")
def run_dirs(synthetic_dir, tmp_path_factory):
    """[with diag_* history, without]: JAX-trained msgpack run dirs."""
    out = tmp_path_factory.mktemp("jax_runs")
    train, valid, test = jload_splits(synthetic_dir)
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim,
                    hidden_dim=(8, 8), num_units_rnn=(4,), dropout=0.0)

    def batch(ds):
        return {k: jax.numpy.asarray(v) for k, v in ds.full_batch().items()}

    dirs = []
    for seed, stride in ((1, 2), (2, None)):
        d = out / f"run_{seed}"
        train_3phase(cfg, batch(train), batch(valid), batch(test), SCHEDULE,
                     save_dir=str(d), seed=seed, verbose=False,
                     diag_stride=stride)
        assert (d / "best_model_sharpe.msgpack").exists()
        assert not list(d.glob("*.pt"))
        dirs.append(str(d))
    return dirs


def test_summary_statistics_matches_jax(run_dirs, synthetic_dir):
    want = jplots.summary_statistics(run_dirs, str(synthetic_dir))
    got = plots.summary_statistics(run_dirs, str(synthetic_dir),
                                   exec_cfg=CPU_F32)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)


def test_dates_from_panel_matches_jax(synthetic_dir):
    ours, theirs = load_splits(synthetic_dir), jload_splits(synthetic_dir)
    assert plots._dates_from_panel(*ours) == jplots._dates_from_panel(*theirs)
    fake = [types.SimpleNamespace(dates=d) for d in (
        np.arange(14), np.array([196703, 196712, 200001, 7]))]
    got = plots._dates_from_panel(*fake)
    assert got == jplots._dates_from_panel(*fake)
    assert (got[0].year, got[0].month) == (1967, 3)


@pytest.mark.parametrize("order", ["diag_first", "plain_first"])
def test_generate_all_plots_writes_the_figures(run_dirs, synthetic_dir,
                                               tmp_path, order, capsys):
    dirs = run_dirs if order == "diag_first" else run_dirs[::-1]
    written = plots.generate_all_plots(dirs, str(synthetic_dir),
                                       str(tmp_path / "figs"), CPU_F32)
    names = [p.split("/")[-1] for p in written]
    base = ["cumulative_sdf.png", "training_curves.png",
            "sharpe_comparison.png", "monthly_returns.png",
            "summary_statistics.png"]
    health = ["moment_violations.png", "weight_concentration.png"]
    assert names == (base + health if order == "diag_first" else base)
    for p in written:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    if order == "plain_first":
        assert "Skipping moment-violation panel" in capsys.readouterr().out


def test_without_matplotlib(run_dirs, synthetic_dir, tmp_path, monkeypatch,
                            capsys):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    stats = plots.summary_statistics(run_dirs, str(synthetic_dir),
                                     exec_cfg=CPU_F32)
    assert np.isfinite(stats["sharpe_monthly"])
    with pytest.raises(SystemExit) as e:
        plots.main(["--data_dir", str(synthetic_dir), "--checkpoint_dirs",
                    *run_dirs, "--output_dir", str(tmp_path / "figs"),
                    "--device", "cpu"])
    assert e.value.code != 0
    assert "matplotlib" in capsys.readouterr().err
    assert not (tmp_path / "figs").exists()
