"""The PyTorch port's rolling refit (``refit.py``) against the JAX
package's, on the CPU.

* ``refit_months`` (explicit months, start/count/stride, and both errors)
  and ``build_refit_items`` (order, months, ``bucket_key`` strings) equal
  the JAX package's;
* ``train_refit_bucket`` against the JAX one on the same panel window
  (month 12, seeds 1 and 2), each member started from the JAX init through
  the ``init`` hook, at the sweep test's model and schedule (hidden (8, 8),
  LSTM (4,), K = 4, dropout 0, 8/4/16, ignore 2): each member's best valid
  Sharpe at rtol 2e-4 / atol 1e-5 and its ``best_model_sharpe`` params at
  rtol 2e-4 / atol 2e-5 (the sweep test's bars); the window's ``reference_profile.json`` equal to the JAX one's
  but for its write time; every artifact matching its recorded sha256;
* the port's counterparts of the JAX package's
  ``test_refit_rolls_ledger_buckets_into_the_gate`` and
  ``test_promote_completed_skips_months_aged_out_of_history``
  (``tests/test_promotion.py``), with the same arguments;
* the queue's execution: a resume at another kernel route or dtype resets
  the ledger, and a worker refuses a queue written for another execution;
* the CLI without a card and without ``--device cpu`` exits non-zero.

The CLI runs: the JAX test's arguments (hidden (8,), LSTM (4,), K = 4,
dropout 0, 2/1/3, ignore 0), f32.
"""

import hashlib
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch import refit
from deeplearninginassetpricing_paperreplication_torch.data.panel import (
    load_splits,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.ledger import (
    SweepLedger,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.promotion import (
    read_pointer,
    write_pointer,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    state_dict_from_jax_params,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
)
from deeplearninginassetpricing_paperreplication_tpu import refit as jrefit
from deeplearninginassetpricing_paperreplication_tpu.data.pipeline import (
    stream_batch as jstream_batch,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import GAN as JGAN
from deeplearninginassetpricing_paperreplication_tpu.training.checkpoint import (
    load_checkpoint_dir,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    TrainConfig as JTrainConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
# the JAX package's REFIT_ARGS (tests/test_promotion.py), on the CPU in f32
REFIT_ARGS = [
    "--months", "3", "4", "--seeds", "1",
    "--epochs_unc", "2", "--epochs_moment", "1", "--epochs", "3",
    "--ignore_epoch", "0", "--hidden_dim", "8", "--rnn_dim", "4",
    "--num_moments", "4", "--dropout", "0.0",
    "--device", "cpu", "--compute_dtype", "float32",
]
# the bucket comparison: the sweep test's model and schedule
# (tests/test_torch_sweep.py)
SCHEDULE = dict(num_epochs_unc=8, num_epochs_moment=4, num_epochs=16,
                ignore_epoch=2)
MODEL = dict(hidden_dim=(8, 8), num_units_rnn=(4,), num_condition_moment=4,
             dropout=0.0)
BUCKET_MONTH, BUCKET_SEEDS = 12, [1, 2]
PARAM_FILES = ("best_model_sharpe", "best_model_loss", "final_model")


def _cfg(ds, cls=GANConfig):
    return cls(macro_feature_dim=ds.macro_feature_dim,
               individual_feature_dim=ds.individual_feature_dim, **MODEL)


def _record_digests(run_dir):
    """{month: {artifact path: recorded sha256}} from the ledger records."""
    ledger = SweepLedger(Path(run_dir) / "sweep_ledger")
    out = {}
    for key in ledger.keys():
        rec = ledger.load(key)
        out[rec["month"]] = {
            str(Path(m["dir"]) / m["file"]): m["sha256"]
            for m in rec["members"]}
    return out


def _assert_checkpoints_match_records(run_dir):
    """Byte-identity evidence: every artifact's on-disk sha256 equals the
    digest its ledger record captured at train time."""
    digests = _record_digests(run_dir)
    assert digests
    for per_month in digests.values():
        for path, sha in per_month.items():
            assert hashlib.sha256(
                Path(path).read_bytes()).hexdigest() == sha
    return digests


# -- months and keys ------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(months=[3, 4, 12]),
    dict(months=None, start_month=12, n_refits=4, stride=1),
    dict(months=None, start_month=6, n_refits=3, stride=5),
    dict(months=[], start_month=2, n_refits=2, stride=2),
], ids=["explicit", "default", "stride", "empty_months"])
def test_refit_months_equal_the_jax_package(kw):
    args = types.SimpleNamespace(**{"months": None, "start_month": 12,
                                    "n_refits": 4, "stride": 1, **kw})
    assert refit.refit_months(args) == jrefit.refit_months(args)


@pytest.mark.parametrize("months,match", [
    ([4, 3], "strictly increasing"),
    ([3, 3], "strictly increasing"),
    ([1, 4], "at least 2 train months"),
])
def test_refit_months_errors_equal_the_jax_package(months, match):
    args = types.SimpleNamespace(months=months, start_month=12, n_refits=4,
                                 stride=1)
    with pytest.raises(ValueError, match=match) as ours:
        refit.refit_months(args)
    with pytest.raises(ValueError) as theirs:
        jrefit.refit_months(args)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("seeds", [[1], [1, 2], [42, 123, 456]])
def test_refit_items_and_keys_equal_the_jax_package(splits, seeds):
    months = [3, 4, 12, 24]
    ours = refit.build_refit_items(_cfg(splits[0]), months, seeds,
                                   TrainConfig(**SCHEDULE))
    theirs = jrefit.build_refit_items(_cfg(splits[0], JGANConfig), months,
                                      seeds, JTrainConfig(**SCHEDULE))
    assert ours == theirs
    assert [it["month"] for it in ours] == months
    assert len({it["key"] for it in ours}) == len(months)


# -- one bucket against the JAX bucket ----------------------------------------


@pytest.fixture(scope="module")
def buckets(splits, synthetic_dir, tmp_path_factory):
    """Both packages' train_refit_bucket on the same month window, each
    port member started from the JAX init of its seed."""
    jtrain, jvalid, _ = splits
    jcfg = _cfg(jtrain, JGANConfig)
    jdir = tmp_path_factory.mktemp("jax_refit")
    jout = jrefit.train_refit_bucket(
        jcfg, BUCKET_MONTH, BUCKET_SEEDS, jtrain,
        jstream_batch(jvalid.full_batch()), JTrainConfig(**SCHEDULE), jdir)
    train, valid, _ = load_splits(synthetic_dir)
    cfg = _cfg(train)
    jgan = JGAN(jcfg)

    def init(seed):
        return state_dict_from_jax_params(
            jax.device_get(jgan.init(jax.random.key(seed))), cfg)

    pdir = tmp_path_factory.mktemp("port_refit")
    out = refit.train_refit_bucket(
        cfg, BUCKET_MONTH, BUCKET_SEEDS, train, valid.to_batch("cpu"),
        TrainConfig(**SCHEDULE), pdir, exec_cfg=CPU_F32, init=init)
    return out, jout, cfg


def test_refit_bucket_member_sharpes_match_jax(buckets):
    out, jout, _ = buckets
    assert [Path(d).name for d in out["dirs"]] == [
        Path(d).name for d in jout["dirs"]] == ["seed1", "seed2"]
    assert all(s is not None for s in out["valid_sharpe"])
    np.testing.assert_allclose(out["valid_sharpe"], jout["valid_sharpe"],
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("member", [0, 1])
def test_refit_bucket_member_params_match_jax(buckets, member):
    out, jout, cfg = buckets
    _, jparams = load_checkpoint_dir(jout["dirs"][member])
    ref = state_dict_from_jax_params(jax.device_get(jparams), cfg)
    got = torch.load(Path(out["dirs"][member]) / "best_model_sharpe.pt",
                     weights_only=True)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("member", [0, 1])
def test_refit_bucket_reference_profile_equals_jax(buckets, member):
    out, jout, _ = buckets
    ours = json.loads(
        (Path(out["dirs"][member]) / "reference_profile.json").read_text())
    theirs = json.loads(
        (Path(jout["dirs"][member]) / "reference_profile.json").read_text())
    assert ours.pop("written_at") and theirs.pop("written_at")
    assert ours == theirs
    assert ours["source"] == f"month{BUCKET_MONTH:04d}"
    assert ours["n_periods"] == BUCKET_MONTH


def test_refit_bucket_members_carry_their_artifacts(buckets):
    out, _, _ = buckets
    assert [m["dir"] for m in out["members"]] == out["dirs"]
    for m, d in zip(out["members"], out["dirs"]):
        data = (Path(d) / m["file"]).read_bytes()
        assert m["file"] == "best_model_sharpe.pt"
        assert m["sha256"] == hashlib.sha256(data).hexdigest()
        assert m["bytes"] == len(data)
        for name in PARAM_FILES:
            assert (Path(d) / f"{name}.pt").exists()
        assert (Path(d) / "history.npz").exists()


# -- the CLI, in process ---------------------------------------------------------


def test_refit_rolls_ledger_buckets_into_the_gate(tmp_path, synthetic_dir):
    """In-process rolling refit: every month trains as a ledger bucket,
    lands verified member checkpoints, and walks through the promotion
    gate in month order; a --resume-from-ledger re-run retrains NOTHING
    and re-promotes nothing (idempotent by source)."""
    run_dir = tmp_path / "refit_run"
    rc = refit.main(["--data_dir", str(synthetic_dir),
                     "--run_dir", str(run_dir), *REFIT_ARGS])
    assert rc == 0
    digests = _assert_checkpoints_match_records(run_dir)
    assert set(digests) == {3, 4}
    pointer = read_pointer(run_dir)
    assert pointer is not None
    assert pointer["source"] in ("month0003", "month0004")
    assert pointer["generation"] >= 1
    # gate evidence in the events: one advance per promoted month
    rows = [json.loads(line) for line in
            (run_dir / "events.jsonl").read_text().splitlines()]
    advances = [r for r in rows if r.get("kind") == "counter"
                and r.get("name") == "promote/advance"]
    rejects = [r for r in rows if r.get("kind") == "counter"
               and r.get("name") == "promote/reject"]
    assert len(advances) + len(rejects) == 2
    assert len(advances) >= 1
    # each record says how its month ran
    ledger = SweepLedger(run_dir / "sweep_ledger")
    assert all(ledger.load(k)["execution"] == {
        "compute_dtype": "float32", "kernel": "auto"} for k in ledger.keys())

    # resume: ledger hits for every month, checkpoints untouched,
    # promotion idempotent
    before = {p: Path(p).stat().st_mtime_ns
              for per in digests.values() for p in per}
    rc = refit.main(["--data_dir", str(synthetic_dir),
                     "--run_dir", str(run_dir), *REFIT_ARGS,
                     "--resume-from-ledger"])
    assert rc == 0
    after = {p: Path(p).stat().st_mtime_ns for p in before}
    assert after == before  # zero retrains: files never rewritten
    assert read_pointer(run_dir)["generation"] == pointer["generation"]
    _assert_checkpoints_match_records(run_dir)


def test_promote_completed_skips_months_aged_out_of_history(tmp_path):
    """The pointer's embedded history is bounded (history_keep), so on a
    long rolling run old month sources age out of it — a restarted
    coordinator must STILL not re-promote them (the monotone month
    cutoff), else the pointer head would regress to a months-stale
    model."""
    ctl = tmp_path / "ctl"
    # the head names month0016 and every older source has aged out
    write_pointer(ctl, {"checkpoint_dirs": ["x"], "source": "month0016"})

    class _Ledger:
        @staticmethod
        def has(key):
            return True

        @staticmethod
        def load(key):
            raise AssertionError(
                "an already-promoted month reached the gate")

    class _Queue:
        ledger = _Ledger()

        @staticmethod
        def items():
            return [{"key": "k12", "index": 0, "month": 12},
                    {"key": "k16", "index": 1, "month": 16}]

    out = refit.promote_completed(_Queue(), ctl, None, 0.05)
    assert out == {"promoted": [], "rejected": [], "skipped": [12, 16]}
    assert read_pointer(ctl)["source"] == "month0016"


@pytest.mark.parametrize("change", [
    ["--kernel", "off"], ["--compute_dtype", "bfloat16"]],
    ids=["kernel", "dtype"])
def test_resume_at_another_execution_resets_the_ledger(
        tmp_path, synthetic_dir, change):
    """A ledger written at one execution is not reused at another: its
    months retrain (the bucket keys leave the execution out, as the JAX
    package's do)."""
    run_dir = tmp_path / "refit_run"
    args = ["--data_dir", str(synthetic_dir), "--run_dir", str(run_dir),
            *REFIT_ARGS, "--months", "3", "--no_promote"]
    assert refit.main(args) == 0
    path = next(iter(_record_digests(run_dir)[3]))
    before = Path(path).stat().st_mtime_ns
    assert refit.main(args + ["--resume-from-ledger"]) == 0
    assert Path(path).stat().st_mtime_ns == before
    assert refit.main(args + ["--resume-from-ledger", *change]) == 0
    assert Path(path).stat().st_mtime_ns != before
    meta = json.loads((run_dir / "sweep_ledger" / "queue.json").read_text())
    flag, value = change
    assert meta["execution"][flag[2:]] == value


def test_worker_refuses_a_queue_of_another_execution(tmp_path,
                                                     synthetic_dir):
    run_dir = tmp_path / "refit_run"
    assert refit.main(["--data_dir", str(synthetic_dir), "--run_dir",
                       str(run_dir), *REFIT_ARGS, "--months", "3",
                       "--no_promote"]) == 0
    with pytest.raises(SystemExit, match="the queue was written for"):
        refit.main(["--worker", "--worker_id", "w0", "--data_dir",
                    str(synthetic_dir), "--run_dir", str(run_dir),
                    "--device", "cpu", "--compute_dtype", "bfloat16"])


@pytest.mark.parametrize("role", ["coordinator", "worker"])
def test_refit_cli_refuses_cuda_without_a_card(tmp_path, synthetic_dir,
                                               role):
    """Without --device cpu the CLI runs on the card; without one it exits
    non-zero naming CUDA rather than train on the CPU."""
    assert not torch.cuda.is_available()
    argv = ["--data_dir", str(synthetic_dir), "--run_dir",
            str(tmp_path / "r"), "--months", "3"]
    if role == "worker":
        argv += ["--worker", "--worker_id", "w0"]
    with pytest.raises(SystemExit) as exc:
        refit.main(argv)
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "r" / "sweep_ledger").exists()
