"""The PyTorch port's data layer against the JAX package's: the synthetic
generator writes the same .npz payloads for the same seed, and load_splits
gives equal arrays (exact: both are the same NumPy arithmetic)."""

import zipfile

import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.data import (
    synthetic as psyn,
)
from deeplearninginassetpricing_paperreplication_torch.data.panel import (
    load_splits,
)
from deeplearninginassetpricing_paperreplication_tpu.data import (
    synthetic as jsyn,
)
from deeplearninginassetpricing_paperreplication_tpu.data.panel import (
    load_splits as jload_splits,
)

SMALL = dict(n_periods_train=10, n_periods_valid=4, n_periods_test=6,
             n_stocks=40, n_features=7, n_macro=5, seed=11, verbose=False)


def _members(path):
    """{archive member: its bytes} of an .npz — the payload, without the
    zip headers' write timestamps."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("compress", [True, False])
def test_synthetic_writes_the_same_npz_payloads(tmp_path, compress):
    jsyn.generate_all_splits(tmp_path / "jax", compress=compress, **SMALL)
    psyn.generate_all_splits(tmp_path / "port", compress=compress, **SMALL)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*.npz"))
    assert len(files) == 6
    for rel in files:
        assert _members(tmp_path / "jax" / rel) == _members(
            tmp_path / "port" / rel), rel


def test_generate_dataset_and_single_split_match(tmp_path):
    cj, mj = jsyn.generate_dataset(9, 30, n_features=6, n_macro=4, seed=3)
    cp, mp = psyn.generate_dataset(9, 30, n_features=6, n_macro=4, seed=3)
    for a, b in ((cj, cp), (mj, mp)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    kw = dict(n_periods=5, n_stocks=25, n_features=4, n_macro=3, seed=5)
    jsyn.generate_panel_split(tmp_path / "j", "test", **kw)
    psyn.generate_panel_split(tmp_path / "p", "test", **kw)
    for rel in ("char/Char_test.npz", "macro/macro_test.npz"):
        assert _members(tmp_path / "j" / rel) == _members(tmp_path / "p" / rel)


def _assert_splits_equal(jax_splits, port_splits):
    for j, p in zip(jax_splits, port_splits):
        for name in ("returns", "individual", "mask", "macro", "dates",
                     "mean_macro", "std_macro"):
            a, b = getattr(j, name), getattr(p, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.dtype == b.dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
        for k, v in j.full_batch().items():
            np.testing.assert_array_equal(p.full_batch()[k], v, err_msg=k)


def test_load_splits_equals_jax_on_the_fixture(synthetic_dir):
    _assert_splits_equal(jload_splits(synthetic_dir),
                         load_splits(synthetic_dir))


def test_load_splits_equals_jax_on_the_demo_panel():
    """data/synthetic_demo: 120 periods x 500 stocks x 46 features, macro
    8, with the -99.99 sentinel and train-stat macro normalization."""
    jax_splits = jload_splits("data/synthetic_demo")
    port_splits = load_splits("data/synthetic_demo")
    _assert_splits_equal(jax_splits, port_splits)
    train, _, test = port_splits
    assert not train.mask.all()  # the sentinel masks observations
    np.testing.assert_allclose(train.macro.mean(axis=0), 0.0, atol=1e-5)
    batch = test.to_batch("cpu")
    assert set(batch) == {"individual", "returns", "mask", "macro"}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in batch.values())
