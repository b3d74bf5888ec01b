"""The port's divergence guard against the JAX package's, on the CPU.

The shared synthetic fixture, a small model (hidden [8], LSTM [4], K = 4),
dropout 0.05, schedule 4/2/6, segments of 2 epochs:

* a ``nan_loss`` fault at the second segment trips the guard, which rolls
  the segment back in place and retries: trips ``[(1, 2, 4)]``, and
  params, history and every ``.pt``'s bytes are a clean run's; the trip
  rides ``history.npz``, ``health.json`` and a ``guard/trip`` counter;
* three consecutive trips raise ``DivergenceError`` before any ``.pt``;
* with the guard off the NaN is let through;
* the same fault plan on the JAX ``Trainer`` trips the same segments;
* ``segment_nonfinite`` agrees with the JAX one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.observability.events import (
    EventLog,
)
from deeplearninginassetpricing_paperreplication_torch.reliability import (
    faults,
    guard,
)
from deeplearninginassetpricing_paperreplication_torch.training.trainer import (
    train_3phase,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.reliability import (
    faults as jfaults,
)
from deeplearninginassetpricing_paperreplication_tpu.reliability import (
    guard as jguard,
)
from deeplearninginassetpricing_paperreplication_tpu.training.trainer import (
    Trainer as JTrainer,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    TrainConfig as JTrainConfig,
)

CPU = ExecutionConfig(device="cpu", compute_dtype="float32")
SCHEDULE = dict(num_epochs_unc=4, num_epochs_moment=2, num_epochs=6,
                ignore_epoch=0, print_freq=100)
NAN_AT_2 = [{"site": "trainer/epoch_loop", "action": "nan_loss",
             "trigger_count": 2}]


def _cfg_kw(ds):
    return dict(macro_feature_dim=ds.macro_feature_dim,
                individual_feature_dim=ds.individual_feature_dim,
                hidden_dim=(8,), num_units_rnn=(4,),
                num_condition_moment=4, dropout=0.05)


@pytest.fixture(scope="module")
def batches(splits):
    return [{k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in ds.full_batch().items()} for ds in splits]


@pytest.fixture()
def plan(monkeypatch):
    """Set a fault plan for both packages' injectors (None: no plan)."""
    def set_plan(p):
        if p is None:
            monkeypatch.delenv(faults.ENV_PLAN, raising=False)
        else:
            monkeypatch.setenv(faults.ENV_PLAN, json.dumps(p))
        faults.reset_injector()
        jfaults.reset_injector()

    for name in ("DLAP_FAULT_STATE", "DLAP_FAULT_EVENTS"):
        monkeypatch.delenv(name, raising=False)
    set_plan(None)
    yield set_plan
    set_plan(None)


def _train(splits, batches, save, **kw):
    cfg = GANConfig(**_cfg_kw(splits[0]))
    return train_3phase(cfg, *batches, tcfg=TrainConfig(**SCHEDULE), seed=3,
                        save_dir=str(save), verbose=False, exec_cfg=CPU,
                        checkpoint_every=2, **kw)


def _assert_same(a, b):
    (pa, ha, da), (pb, hb, db) = a, b
    assert list(pa) == list(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert set(ha) == set(hb)
    for k in ha:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    pts = sorted(p.name for p in da.glob("*.pt"))
    assert pts == sorted(p.name for p in db.glob("*.pt")) and pts
    for name in pts:
        assert (da / name).read_bytes() == (db / name).read_bytes(), name


def test_guard_rolls_back_an_injected_nan_bit_for_bit(splits, batches,
                                                      tmp_path, plan):
    _, clean_p, clean_h, _ = _train(splits, batches, tmp_path / "clean",
                                    divergence_guard=False)
    plan(NAN_AT_2)
    events = EventLog(tmp_path / "guarded")
    _, p, h, trainer = _train(splits, batches, tmp_path / "guarded",
                              events=events)
    events.close()
    assert trainer.divergence_trips == [(1, 2, 4)]
    _assert_same((clean_p, clean_h, tmp_path / "clean"),
                 (p, h, tmp_path / "guarded"))
    with np.load(tmp_path / "guarded" / "history.npz") as f:
        np.testing.assert_array_equal(f["divergence_trips"],
                                      np.asarray([[1.0, 2.0, 4.0]]))
        assert f["divergence_trips"].dtype == np.float32
    health = json.loads((tmp_path / "guarded" / "health.json").read_text())
    assert health["guard_trips"] == 1
    assert health["divergence_trips"] == [[1, 2, 4]]
    rows = [json.loads(x) for x in
            (tmp_path / "guarded" / "events.jsonl").read_text().splitlines()]
    trips = [r for r in rows if r["name"] == "guard/trip"]
    assert [(r["phase"], r["start_epoch"], r["end_epoch"], r["consecutive"])
            for r in trips] == [("phase1_unconditional", 2, 4, 1)]
    # the epochs of the kept segments only: 12, the retried two not again
    assert sum(r["value"] for r in rows
               if r["name"] == "epochs_dispatched") == 12


def test_guard_aborts_after_consecutive_trips_without_checkpoints(
        splits, batches, tmp_path, plan):
    plan([{"site": "trainer/epoch_loop", "action": "nan_loss",
           "trigger_count": n} for n in (1, 2, 3)])
    with pytest.raises(guard.DivergenceError, match="phase1_unconditional"):
        _train(splits, batches, tmp_path / "aborted", guard_max_trips=3)
    assert not list((tmp_path / "aborted").glob("*.pt*"))


def test_guard_off_lets_nans_through(splits, batches, tmp_path, plan):
    plan(NAN_AT_2)
    _, _, hist, trainer = _train(splits, batches, tmp_path / "unguarded",
                                 divergence_guard=False)
    assert trainer.divergence_trips == []
    assert not np.all(np.isfinite(hist["train_loss"]))


def test_guard_trips_match_the_jax_trainer(splits, batches, tmp_path, plan):
    """One plan, both trainers, the same segments: the port's trips are
    the JAX trainer's."""
    train, valid, _ = splits
    jgan = JGAN(JGANConfig(**_cfg_kw(train)))
    jtr = JTrainer(jgan, JTrainConfig(**SCHEDULE), has_test=False)
    jb = [{k: jnp.asarray(v) for k, v in ds.full_batch().items()}
          for ds in (train, valid)]
    plan(NAN_AT_2 + [{"site": "trainer/epoch_loop", "action": "nan_loss",
                      "trigger_count": 4}])
    (tmp_path / "j").mkdir()
    jtr.train(jgan.init(jax.random.key(3)), *jb, save_dir=str(tmp_path / "j"),
              verbose=False, precompile=False, checkpoint_every=2)
    cfg = GANConfig(**_cfg_kw(train))
    _, _, _, trainer = train_3phase(
        cfg, *batches[:2], tcfg=TrainConfig(**SCHEDULE), seed=3,
        save_dir=str(tmp_path / "p"), verbose=False, exec_cfg=CPU,
        checkpoint_every=2)
    assert trainer.divergence_trips == jtr.divergence_trips
    assert trainer.divergence_trips == [(1, 2, 4), (2, 0, 2)]


@pytest.mark.parametrize("hist,bad", [
    ({"train_loss": [0.1, 0.2], "grad_norm": [1.0, 2.0]}, False),
    ({"train_loss": [0.1, float("nan")]}, True),
    ({"train_loss_cond": [float("inf")]}, True),
    ({"grad_norm": [1.0, -float("inf")]}, True),
    ({"valid_loss": [float("nan")], "train_loss": [0.0]}, False),
    ({"train_loss": []}, False),
], ids=["finite", "nan_loss", "inf_cond", "neg_inf_grad", "unguarded_key",
        "empty"])
def test_segment_nonfinite_agrees_with_jax(hist, bad):
    arrays = {k: np.asarray(v, np.float32) for k, v in hist.items()}
    assert guard.segment_nonfinite(arrays) is bad
    assert jguard.segment_nonfinite(arrays) is bad
    assert guard.segment_nonfinite(hist) is bad
    assert guard.GUARD_KEYS == jguard.GUARD_KEYS
