"""The PyTorch port's data layer against the JAX package's: the synthetic
generator writes the same .npz payloads for the same seed, and load_splits
gives equal arrays (exact: both are the same NumPy arithmetic)."""

import shutil
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


# -- the PanelDataset extras and load_panel's options -------------------------

from deeplearninginassetpricing_paperreplication_torch.data import (  # noqa: E402
    native as pnative,
)
from deeplearninginassetpricing_paperreplication_torch.data.panel import (  # noqa: E402
    load_panel,
    numpy_decode,
)
from deeplearninginassetpricing_paperreplication_tpu.data import (  # noqa: E402
    native as jnative,
)
from deeplearninginassetpricing_paperreplication_tpu.data.panel import (  # noqa: E402
    load_panel as jload_panel,
)

FIELDS = ("returns", "individual", "mask", "macro", "dates", "mean_macro",
          "std_macro", "n_assets")


def _assert_ds_equal(j, p):
    for name in FIELDS:
        a, b = getattr(j, name), getattr(p, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.asarray(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    jb, pb = j.full_batch(), p.full_batch()
    assert jb.keys() == pb.keys()
    for k in jb:
        assert np.asarray(jb[k]).dtype == np.asarray(pb[k]).dtype, k
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)


def _paths(d, split):
    return d / "char" / f"Char_{split}.npz", d / "macro" / f"macro_{split}.npz"


@pytest.mark.parametrize("macro_idx", [None, [0, 2, 5], [4]])
def test_load_panel_macro_idx_equals_jax(synthetic_dir, macro_idx):
    char, macro = _paths(synthetic_dir, "train")
    _assert_ds_equal(jload_panel(char, macro, macro_idx=macro_idx),
                     load_panel(char, macro, macro_idx=macro_idx))


@pytest.mark.parametrize("macro_idx", [None, [1, 3]])
def test_load_panel_with_given_stats_equals_jax(synthetic_dir, macro_idx):
    train = jload_panel(*_paths(synthetic_dir, "train"), macro_idx=macro_idx)
    for split in ("valid", "test"):
        char, macro = _paths(synthetic_dir, split)
        kw = dict(macro_idx=macro_idx, mean_macro=train.mean_macro,
                  std_macro=train.std_macro)
        _assert_ds_equal(jload_panel(char, macro, **kw),
                         load_panel(char, macro, **kw))


def test_load_splits_macro_idx_equals_jax(synthetic_dir):
    _assert_splits_equal(jload_splits(synthetic_dir, macro_idx=[0, 4]),
                         load_splits(synthetic_dir, macro_idx=[0, 4]))


@pytest.mark.parametrize("given", ["mean", "std"])
def test_load_panel_refuses_unpaired_stats(synthetic_dir, given):
    char, macro = _paths(synthetic_dir, "train")
    stats = {f"{given}_macro": np.zeros((1, 6), np.float32)}
    with pytest.raises(ValueError, match="provided together"):
        jload_panel(char, macro, **stats)
    with pytest.raises(ValueError, match="provided together"):
        load_panel(char, macro, **stats)


@pytest.mark.parametrize("n_periods,n_stocks,pad", [
    (10, 16, None), (100, 1000, None), (24, 80, 100), (10, 32, 100)])
def test_subsample_equals_jax(splits, n_periods, n_stocks, pad):
    """subsample (and its n_assets rule on a padded panel) bit for bit the
    JAX package's."""
    from deeplearninginassetpricing_paperreplication_torch.data.panel import (
        PanelDataset,
    )

    j = splits[0] if pad is None else splits[0].pad_stocks(pad)
    p = PanelDataset(**{f.name: getattr(j, f.name)
                        for f in j.__dataclass_fields__.values()})
    _assert_ds_equal(j.subsample(n_periods, n_stocks),
                     p.subsample(n_periods, n_stocks))


@pytest.mark.parametrize("multiple", [1, 48, 100])
def test_pad_stocks_and_valid_per_period_equal_jax(synthetic_dir, multiple):
    j = jload_splits(synthetic_dir)[0]
    p = load_splits(synthetic_dir)[0]
    jp, pp = j.pad_stocks(multiple), p.pad_stocks(multiple)
    _assert_ds_equal(jp, pp)
    np.testing.assert_array_equal(jp.valid_per_period(), pp.valid_per_period())
    if multiple == 1:
        assert pp is p
    else:
        assert pp.n_assets == p.N
        assert float(pp.to_batch("cpu")["n_assets"]) == p.N
        assert pp.to_batch("cpu")["n_assets"].shape == ()


@pytest.mark.parametrize("phase", ["unconditional", "moment", "conditional"])
def test_pad_stocks_leaves_the_losses_unchanged(synthetic_dir, phase):
    """The GAN's losses on a stock-padded batch (which carries n_assets)
    equal the unpadded ones: the padded columns are masked out and the
    losses divide by the real asset count. rtol 1e-6, the JAX package's bar
    for the same property (tests/test_pallas.py): mean and sum/n_assets
    differ in summation order."""
    from deeplearninginassetpricing_paperreplication_torch.models.gan import (
        GAN,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config import (
        ExecutionConfig,
        GANConfig,
    )

    train = load_splits(synthetic_dir)[0]
    cfg = GANConfig(macro_feature_dim=train.macro_feature_dim,
                    individual_feature_dim=train.individual_feature_dim,
                    hidden_dim=(8, 4), num_units_rnn=(3,),
                    num_condition_moment=3, dropout=0.0)
    torch.manual_seed(0)
    gan = GAN(cfg, ExecutionConfig(device="cpu", compute_dtype="float32"))
    with torch.no_grad():
        a = gan.forward(train.to_batch("cpu"), phase)
        b = gan.forward(train.pad_stocks(48).to_batch("cpu"), phase)
    for k in ("loss", "loss_unconditional", "loss_conditional", "sharpe"):
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-6,
                                   atol=0, err_msg=k)
    w = b["weights"].numpy()
    np.testing.assert_array_equal(w[:, train.N:], 0.0)
    np.testing.assert_allclose(w[:, :train.N], a["weights"].numpy(),
                               rtol=1e-6, atol=1e-9)


def _codec_input(seed=5, shape=(6, 40, 8)):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal(shape).astype(np.float32)
    data[rng.random(shape[:2]) < 0.3, 0] = -99.99
    data[rng.random(shape) < 0.05] = -99.99
    data[rng.random(shape[:2]) < 0.02, 0] = np.nan
    return data


def test_port_codec_builds_and_matches_numpy_and_jax():
    """The port's own codec build (into data/_build/, never the source
    tree) decodes bit for bit like the NumPy decode and the JAX package's
    codec."""
    if not pnative.native_available():
        pytest.skip("no C++ toolchain to build the codec")
    assert pnative.so_path().parent == pnative.BUILD_DIR
    assert pnative.so_path().exists()
    data = _codec_input()
    got = pnative.decode_panel(data, -98.99)
    assert got is not None
    ref = numpy_decode(data)
    jref = jnative.decode_panel(data, -98.99)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if jref is not None:
        for a, b in zip(got, jref):
            np.testing.assert_array_equal(a, b)


def test_codec_build_runs_in_the_background(monkeypatch, tmp_path):
    """A missing library starts a background build; the decode falls to
    NumPy without waiting, and native_available() joins the build."""
    import threading
    import time

    release = threading.Event()

    def slow_failing_build(path):
        release.wait(10.0)
        return False

    monkeypatch.setattr(pnative, "_build", slow_failing_build)
    monkeypatch.setattr(pnative, "so_path", lambda: tmp_path / "absent.so")
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "_FAILED", False)
    monkeypatch.setattr(pnative, "_BUILD_THREAD", None)
    t0 = time.monotonic()
    assert pnative.decode_panel(np.zeros((1, 2, 3), np.float32), -98.99) is None
    assert time.monotonic() - t0 < 5.0
    release.set()
    assert pnative.native_available() is False
    assert pnative._FAILED is True


def test_codec_off_switch(monkeypatch):
    monkeypatch.setenv("DLAP_NO_NATIVE", "1")
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "_FAILED", False)
    monkeypatch.setattr(pnative, "_BUILD_THREAD", None)
    assert pnative.native_available() is False
    assert pnative.decode_panel(_codec_input(), -98.99) is None


def test_load_panel_numpy_route_equals_jax(synthetic_dir, monkeypatch):
    """With the codec switched off load_panel decodes in NumPy: the same
    arrays as the JAX package's loader."""
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "_FAILED", True)
    char, macro = _paths(synthetic_dir, "test")
    _assert_ds_equal(jload_panel(char, macro), load_panel(char, macro))


def test_to_batch_copies_a_read_only_array(splits):
    from deeplearninginassetpricing_paperreplication_torch.data.panel import (
        PanelDataset,
    )

    j = splits[0]
    ind = j.individual.copy()
    ind.flags.writeable = False
    p = PanelDataset(returns=j.returns, individual=ind, mask=j.mask,
                     macro=j.macro, dates=j.dates)
    b = p.to_batch("cpu")
    b["individual"] += 1.0  # writable, and the array is untouched
    np.testing.assert_array_equal(ind, j.individual)


# -- download.py, offline --------------------------------------------------------

from deeplearninginassetpricing_paperreplication_torch.data import (  # noqa: E402
    download as pdl,
)
from deeplearninginassetpricing_paperreplication_tpu.data import (  # noqa: E402
    download as jdl,
)


def test_download_tables_equal_jax():
    assert pdl.REQUIRED_FILES == jdl.REQUIRED_FILES
    assert pdl.EXPECTED_SIZES_BYTES == jdl.EXPECTED_SIZES_BYTES
    assert (pdl.DATASETS_ZIP_ID, pdl.GDRIVE_FOLDER_ID) == (
        jdl.DATASETS_ZIP_ID, jdl.GDRIVE_FOLDER_ID)


def test_download_existence_and_size_checks(synthetic_dir, tmp_path):
    assert pdl.check_data_exists(synthetic_dir, verbose=False)
    assert not pdl.check_data_exists(tmp_path, verbose=False)
    (tmp_path / "char").mkdir()
    (tmp_path / "char" / "Char_train.npz").write_bytes(b"x" * 100)
    assert not pdl.check_data_exists(tmp_path, verbose=False)
    sizes = pdl.validate_sizes(tmp_path)
    assert sizes == jdl.validate_sizes(tmp_path)
    assert sizes["Char_train.npz"] is False and sizes["Char_test.npz"] is False


def test_download_schema_check_equals_jax(synthetic_dir, tmp_path):
    ok, report = pdl.validate_schema(synthetic_dir, verbose=False)
    assert ok, report
    assert (ok, report) == jdl.validate_schema(synthetic_dir, verbose=False)
    bad = tmp_path / "bad"
    shutil.copytree(synthetic_dir, bad)
    with np.load(bad / "char" / "Char_train.npz") as z:
        char = {k: z[k].copy() for k in z.files}
    char["data"][0, 0, 1] = np.nan
    np.savez(bad / "char" / "Char_train.npz", **char)
    ok, report = pdl.validate_schema(bad, verbose=False)
    assert not ok
    assert any("sentinel" in e for e in report["Char_train.npz"]["errors"])
    assert (ok, report) == jdl.validate_schema(bad, verbose=False)


def test_restructure_zip_on_a_fixture(synthetic_dir, tmp_path):
    """The authors' archive layout (npz files in nested folders) lands as
    char/ and macro/ under the data dir."""
    zpath = tmp_path / "datasets.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for sub, name in pdl.REQUIRED_FILES:
            z.write(synthetic_dir / sub / name, f"datasets/{sub}x/{name}")
    out = tmp_path / "data"
    pdl.restructure_zip(zpath, out)
    assert pdl.check_data_exists(out, verbose=False)
    assert not (out / "_extract").exists()
    for sub, name in pdl.REQUIRED_FILES:
        assert (out / sub / name).read_bytes() == (
            synthetic_dir / sub / name).read_bytes()


def test_download_is_gated_on_gdown(tmp_path):
    """Every network call sits behind _require_gdown: without gdown the
    download raises the gated ImportError naming the synthetic generator,
    and reaches no network."""
    try:
        import gdown  # noqa: F401

        pytest.skip("gdown installed; gate not exercised")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="synthetic"):
        pdl._require_gdown()
    for fn in (pdl.download_from_zip, pdl.download_from_folder):
        with pytest.raises(ImportError, match="synthetic"):
            fn(tmp_path)
    with pytest.raises(ImportError, match="torch.data.synthetic"):
        pdl.download_all_data(tmp_path, force=True)
    with pytest.raises(ValueError, match="method"):
        pdl.download_all_data(tmp_path, method="ftp")
