"""The port reads the JAX package's flax ``.msgpack`` run directories.

* ``utils/flax_msgpack.loads`` on files the JAX ``save_params`` writes here
  (the GAN at two configs, the SimpleSDF baseline), and on chunked arrays
  (flax's ``MAX_CHUNK_SIZE`` patched down): the tree
  ``flax.serialization.msgpack_restore`` gives, leaf for leaf bitwise.
* ``load_params`` bitwise ``state_dict_from_jax_params`` of the same tree;
  truncated and garbage bytes raise a ``ValueError`` naming the file; a
  torn newest file loads ``.g1``.
* ``load_checkpoint_dir``'s candidate order: the JAX package's six cases
  (``tests/test_training.py``), one parametrised test.
* The port's ``evaluate_ensemble`` on JAX-written msgpack run dirs against
  the JAX ``evaluate_ensemble`` on the same dirs (f32, Sharpe rtol 1e-3).
* The checked-in run dirs ``tests/fixtures/jax_run_{msgpack,pt}`` are what
  ``tools/write_jax_run_fixtures.py`` writes now, and load to one
  ``state_dict`` bit for bit.
"""

import importlib.util
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from deeplearninginassetpricing_paperreplication_torch import (
    evaluate_ensemble as port_eval,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    load_checkpoint_dir,
    load_params,
    read_flax_params,
    simple_sdf_state_dict_from_jax_params,
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.utils import (
    flax_msgpack,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu import (
    evaluate_ensemble as jax_eval,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.models.networks import (
    SimpleSDF as JSimpleSDF,
)
from deeplearninginassetpricing_paperreplication_tpu.training.checkpoint import (
    load_checkpoint_dir as jax_load_checkpoint_dir,
)
from deeplearninginassetpricing_paperreplication_tpu.training.checkpoint import (
    save_params,
    torch_state_dict_from_params,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"
CONFIGS = {
    "lstm": dict(macro_feature_dim=6, individual_feature_dim=10,
                 hidden_dim=(8, 8), num_units_rnn=(4,),
                 num_condition_moment=8),
    "moment_hidden": dict(macro_feature_dim=6, individual_feature_dim=10,
                          hidden_dim=(8,), use_rnn=False,
                          hidden_dim_moment=(5,), num_condition_moment=4),
}


def _jax_params(kind, seed=0):
    return JGAN(JGANConfig(**CONFIGS[kind])).init(jax.random.key(seed))


def _leaves_equal(a, b):
    la, lb = (jax.tree_util.tree_leaves_with_path(t) for t in (a, b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _simple_sdf_params():
    rng = np.random.default_rng(0)
    model = JSimpleSDF(macro_dim=3, individual_dim=4, hidden_dims=(32, 16))
    return model.init({"params": jax.random.key(1)},
                      rng.standard_normal((5, 3)).astype(np.float32),
                      rng.standard_normal((5, 7, 4)).astype(np.float32),
                      np.ones((5, 7), np.float32), True)["params"]


@pytest.mark.parametrize("kind", ["lstm", "moment_hidden", "simple_sdf"])
def test_reader_matches_flax(kind, tmp_path):
    params = (_simple_sdf_params() if kind == "simple_sdf"
              else _jax_params(kind))
    path = tmp_path / "p.msgpack"
    save_params(path, params)
    data = path.read_bytes()
    _leaves_equal(flax_msgpack.loads(data), serialization.msgpack_restore(data))
    _leaves_equal(read_flax_params(path), jax.device_get(params))
    if kind == "simple_sdf":
        sd = simple_sdf_state_dict_from_jax_params(read_flax_params(path), 2)
        assert list(sd) == ["fc_layers.0.weight", "fc_layers.0.bias",
                            "fc_layers.3.weight", "fc_layers.3.bias",
                            "output_proj.weight", "output_proj.bias"]
        assert tuple(sd["fc_layers.0.weight"].shape) == (32, 7)


def test_reader_unchunks_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    params = jax.device_get(_jax_params("lstm"))
    data = serialization.to_bytes(params)
    assert b"__msgpack_chunked_array__" in data
    restored = serialization.msgpack_restore(data)
    _leaves_equal(flax_msgpack.loads(data), restored)
    _leaves_equal(flax_msgpack.loads(data), params)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_load_params_is_the_bridge(kind, tmp_path):
    params = _jax_params(kind, seed=3)
    path = tmp_path / "best_model_sharpe.msgpack"
    save_params(path, params)
    cfg = GANConfig(**CONFIGS[kind])
    got = load_params(path, cfg)
    want = state_dict_from_jax_params(jax.device_get(params), cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("damage", ["truncated", "garbage"])
def test_damaged_msgpack_raises_naming_the_file(damage, tmp_path):
    path = tmp_path / "best_model_sharpe.msgpack"
    data = serialization.to_bytes(jax.device_get(_jax_params("lstm")))
    path.write_bytes(data[:len(data) // 2] if damage == "truncated"
                     else b"\xc1 not a checkpoint")
    with pytest.raises(ValueError, match="best_model_sharpe.msgpack"):
        load_params(path, GANConfig(**CONFIGS["lstm"]))


def test_torn_newest_file_loads_g1(tmp_path):
    path = tmp_path / "best_model_sharpe.msgpack"
    cfg = GANConfig(**CONFIGS["lstm"])
    first, second = _jax_params("lstm", 4), _jax_params("lstm", 5)
    save_params(path, first)
    save_params(path, second)  # rotates the first to .g1
    data = path.read_bytes()
    path.write_bytes(data[: len(data) - 100])  # torn: the digest fails
    with pytest.warns(UserWarning, match="fell back"):
        got = load_params(path, cfg)
    want = state_dict_from_jax_params(jax.device_get(first), cfg)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a msgpack surviving only as .g1 is still a candidate of the run dir
    path.unlink()
    cfg.save(tmp_path / "config.json")
    with pytest.warns(UserWarning, match="fell back"):
        _, sd = load_checkpoint_dir(tmp_path)
    assert torch.equal(sd["sdf_net.output_proj.bias"],
                       want["sdf_net.output_proj.bias"])


# -- load_checkpoint_dir's candidate order -----------------------------------

ORDER_CASES = {
    # files present → (request, expected params or an error, warns)
    "requested_msgpack_wins_over_final": (
        {"best_model_sharpe.msgpack": "best", "final_model.msgpack": "final"},
        "best_model_sharpe", "best", False),
    "fallback_to_final_model_warns": (
        {"final_model.msgpack": "final"}, "best_model_sharpe", "final",
        True),
    "final_model_direct_request_no_warning": (
        {"final_model.msgpack": "final"}, "final_model", "final", False),
    "no_final_for_non_best_request": (
        {"final_model.msgpack": "final"}, "some_other_artifact",
        FileNotFoundError, False),
    "empty_dir_raises_with_candidates_named": (
        {}, "best_model_sharpe", FileNotFoundError, False),
    "reference_pt_preferred_over_final_msgpack": (
        {"best_model_sharpe.pt": "best", "final_model.msgpack": "final"},
        "best_model_sharpe", "best", False),
}


@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_candidate_order_matches_jax(case, tmp_path):
    files, which, expect, warns = ORDER_CASES[case]
    kw = CONFIGS["lstm"]
    cfg = GANConfig(**kw)
    cfg.save(tmp_path / "config.json")
    params = {"best": _jax_params("lstm", 21), "final": _jax_params("lstm", 22)}
    for name, which_params in files.items():
        path = tmp_path / name
        if name.endswith(".msgpack"):
            save_params(path, params[which_params])
        else:
            torch.save(torch_state_dict_from_params(
                params[which_params], JGANConfig(**kw)), path)
    jax_loader = jax_load_checkpoint_dir
    if isinstance(expect, type):
        with pytest.raises(expect, match=which):
            load_checkpoint_dir(tmp_path, which)
        with pytest.raises(expect, match=which):
            jax_loader(tmp_path, which)
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, sd = load_checkpoint_dir(tmp_path, which)
    assert any("absent" in str(w.message) for w in caught) == warns
    _, jparams = jax_loader(tmp_path, which)
    for want in (state_dict_from_jax_params(jax.device_get(params[expect]),
                                            cfg),
                 state_dict_from_jax_params(jax.device_get(jparams), cfg)):
        for k in want:
            assert torch.equal(sd[k], want[k]), k


def test_evaluate_ensemble_on_jax_run_dirs_matches_jax(synthetic_dir,
                                                       tmp_path, capsys):
    kw = CONFIGS["lstm"]
    dirs = []
    for seed in (1, 2, 3):
        d = tmp_path / f"seed_{seed}"
        d.mkdir()
        JGANConfig(**kw).save(d / "config.json")
        save_params(d / "best_model_sharpe.msgpack", _jax_params("lstm", seed))
        dirs.append(str(d))
    want = jax_eval.evaluate_ensemble(dirs, str(synthetic_dir),
                                      verbose=False)
    got = port_eval.evaluate_ensemble(
        dirs, str(synthetic_dir),
        exec_cfg=ExecutionConfig(device="cpu", compute_dtype="float32"),
        verbose=False)
    for k in ("train_sharpe", "valid_sharpe", "test_sharpe"):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-5), k
    np.testing.assert_allclose(got["individual_sharpes"],
                               want["individual_sharpes"], rtol=1e-3,
                               atol=1e-5)
    capsys.readouterr()


# -- the checked-in JAX run dirs ----------------------------------------------


def _fixture_writer():
    spec = importlib.util.spec_from_file_location(
        "write_jax_run_fixtures", ROOT / "tools" / "write_jax_run_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_run_dirs_are_what_the_writer_writes(tmp_path):
    writer = _fixture_writer()
    writer.write(tmp_path)
    for name in writer.NAMES:
        ours = sorted(p.name for p in (FIXTURES / name).iterdir())
        fresh = sorted(p.name for p in (tmp_path / name).iterdir())
        assert ours == fresh, name
        for f in ours:
            assert (FIXTURES / name / f).read_bytes() == (
                tmp_path / name / f).read_bytes(), f"{name}/{f}"


def test_fixture_run_dirs_load_to_one_state_dict():
    cfg_m, sd_m = load_checkpoint_dir(FIXTURES / "jax_run_msgpack")
    cfg_p, sd_p = load_checkpoint_dir(FIXTURES / "jax_run_pt")
    assert cfg_m == cfg_p
    assert (cfg_m.individual_feature_dim, cfg_m.macro_feature_dim,
            tuple(cfg_m.hidden_dim), tuple(cfg_m.num_units_rnn),
            cfg_m.num_condition_moment) == (46, 178, (64, 64), (4,), 8)
    assert list(sd_m) == list(sd_p)
    for k in sd_p:
        assert torch.equal(sd_m[k], sd_p[k]), k
