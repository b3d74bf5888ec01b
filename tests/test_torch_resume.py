"""The port's resumable training against the JAX package's, on the CPU.

The shared synthetic fixture, a small model (hidden [8], LSTM [4], K = 4),
dropout 0.05 (so the per-epoch seeds are held too):

* ``stop_after_phase`` 1 and 2, then ``resume``: params, history and every
  ``.pt``'s bytes bit for bit an uninterrupted run;
* ``stop_after_epochs`` 3 (inside phase 1), 6 (inside phase 2), 8 and 12
  (inside phase 3) with ``checkpoint_every`` 2, then ``resume``, bit for
  bit (schedule 5/2/7, the JAX tests'); a resume without
  ``checkpoint_every``; a segmented run bit for bit a whole one;
* a state written for another schedule, seed, kernel setting or dtype is
  refused;
* a torn newest ``resume_state.pt`` falls back one generation and the run
  finishes bit for bit; an unusable state warns and starts fresh;
* ``resume_meta.json`` has the JAX package's keys and the port's route.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.observability.events import (
    EventLog,
)
from deeplearninginassetpricing_paperreplication_torch.reliability import (
    faults,
    verified,
)
from deeplearninginassetpricing_paperreplication_torch.training.trainer import (
    train_3phase,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
    TrainConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.training.trainer import (
    train_3phase as jtrain_3phase,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    TrainConfig as JTrainConfig,
)

CPU = ExecutionConfig(device="cpu", compute_dtype="float32")
SHORT = dict(num_epochs_unc=4, num_epochs_moment=2, num_epochs=6,
             ignore_epoch=1, seed=3, print_freq=100)
LONG = dict(num_epochs_unc=5, num_epochs_moment=2, num_epochs=7,
            ignore_epoch=1, seed=11, print_freq=100)


def _cfg_kw(ds):
    return dict(macro_feature_dim=ds.macro_feature_dim,
                individual_feature_dim=ds.individual_feature_dim,
                hidden_dim=(8,), num_units_rnn=(4,),
                num_condition_moment=4, dropout=0.05)


@pytest.fixture(scope="module")
def batches(splits):
    return [{k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in ds.full_batch().items()} for ds in splits]


@pytest.fixture(autouse=True)
def no_plan(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    faults.reset_injector()
    yield
    faults.reset_injector()


def _train(splits, batches, save, sched=SHORT, exec_cfg=CPU, **kw):
    cfg = GANConfig(**_cfg_kw(splits[0]))
    _, params, hist, trainer = train_3phase(
        cfg, *batches, tcfg=TrainConfig(**sched), save_dir=str(save),
        verbose=False, exec_cfg=exec_cfg, **kw)
    return (params, hist, save), trainer


@pytest.fixture(scope="module")
def full(splits, batches, tmp_path_factory):
    """The uninterrupted whole-phase runs of both schedules."""
    root = tmp_path_factory.mktemp("full")
    return {name: _train(splits, batches, root / name, sched)[0]
            for name, sched in (("short", SHORT), ("long", LONG))}


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
    for f in ("history.npz",):
        with np.load(da / f) as x, np.load(db / f) as y:
            assert x.files == y.files
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert not list(db.glob("resume_*"))


@pytest.mark.parametrize("phase", [1, 2])
def test_stop_after_phase_then_resume_bit_for_bit(splits, batches, full,
                                                 tmp_path, phase):
    run = tmp_path / "run"
    _train(splits, batches, run, stop_after_phase=phase)
    meta = json.loads((run / "resume_meta.json").read_text())
    assert meta["completed_phase"] == phase and meta["in_phase"] == 0
    out, trainer = _train(splits, batches, run, resume=True)
    _assert_same(full["short"], out)
    # a resumed run's metrics.jsonl holds one row per epoch of every phase
    rows = (run / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 4 + 2 + 6
    assert trainer.epoch_ms().keys() == {
        "phase1_unconditional", "phase2_moment",
        "phase3_conditional"}.difference(
            ["phase1_unconditional", "phase2_moment"][:phase])


@pytest.mark.parametrize("stop_at", [3, 6, 8, 12])
def test_stop_after_epochs_then_resume_bit_for_bit(splits, batches, full,
                                                  tmp_path, stop_at):
    """3 stops inside phase 1, 6 inside phase 2 (its moment params and
    best tracker), 8 and 12 inside phase 3 (after 5 + 2)."""
    run = tmp_path / "run"
    _, trainer = _train(splits, batches, run, LONG, checkpoint_every=2,
                        stop_after_epochs=stop_at)
    assert trainer.stopped_midphase
    meta = json.loads((run / "resume_meta.json").read_text())
    assert meta["in_phase"] == (1 if stop_at < 5 else 2 if stop_at < 7
                                else 3)
    assert meta["in_phase"] == meta["completed_phase"] + 1
    assert not (run / "final_model.pt").exists()
    out, trainer = _train(splits, batches, run, LONG, checkpoint_every=2,
                          resume=True)
    assert not trainer.stopped_midphase
    _assert_same(full["long"], out)


def test_midphase_resume_without_checkpoint_every(splits, batches, full,
                                                  tmp_path):
    run = tmp_path / "run"
    _train(splits, batches, run, LONG, checkpoint_every=2,
           stop_after_epochs=9)
    out, _ = _train(splits, batches, run, LONG, resume=True)
    _assert_same(full["long"], out)


def test_segmented_run_bit_for_bit_a_whole_one(splits, batches, full,
                                               tmp_path):
    out, _ = _train(splits, batches, tmp_path / "seg", LONG,
                    checkpoint_every=3)  # 5 → 3+2, 2 → 2, 7 → 3+3+1
    _assert_same(full["long"], out)


@pytest.mark.parametrize("change", ["schedule", "seed", "kernel", "dtype"])
def test_resume_refuses_a_mismatch(splits, batches, tmp_path, change):
    run = tmp_path / "run"
    _train(splits, batches, run, stop_after_phase=1)
    sched, exec_cfg, kw = dict(SHORT), CPU, {}
    if change == "schedule":
        sched["num_epochs"] = 7
    elif change == "seed":
        kw["seed"] = 4
    elif change == "kernel":
        exec_cfg = dataclasses.replace(CPU, kernel="off")
    else:
        exec_cfg = dataclasses.replace(CPU, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="does not match"):
        _train(splits, batches, run, sched, exec_cfg, resume=True, **kw)


def test_torn_newest_state_falls_back_one_generation(splits, batches, full,
                                                     tmp_path, monkeypatch):
    """The newest resume_state.pt torn after its digest landed: the resume
    takes the .g1 pair, counts checkpoint/fallback, replays from there and
    finishes bit for bit."""
    run = tmp_path / "run"
    monkeypatch.setenv(faults.ENV_PLAN, json.dumps(
        [{"site": "checkpoint/saved", "action": "truncate_file",
          "match": "resume_state.pt", "trigger_count": 4}]))
    faults.reset_injector()
    # saves: phase 1 at epoch 2, its boundary, phase 2's boundary, then
    # phase 3 at epoch 2 (4 + 2 + 2): the 4th is the newest
    _train(splits, batches, run, checkpoint_every=2, stop_after_epochs=8)
    monkeypatch.delenv(faults.ENV_PLAN)
    faults.reset_injector()
    state = run / "resume_state.pt"
    assert not verified.check_digest(state, state.read_bytes())[0]
    assert verified.generation_path(state, 1).exists()
    events = EventLog(run)
    out, _ = _train(splits, batches, run, checkpoint_every=2, resume=True,
                    events=events)
    events.close()
    _assert_same(full["short"], out)
    rows = [json.loads(x) for x in (run / "events.jsonl").read_text()
            .splitlines()]
    assert any(r["name"] == "checkpoint/fallback" for r in rows)


def test_unusable_state_warns_and_starts_fresh(splits, batches, full,
                                               tmp_path):
    run = tmp_path / "run"
    _train(splits, batches, run, stop_after_phase=1)
    for p in verified.generation_candidates(run / "resume_state.pt"):
        if p.exists():
            p.write_bytes(b"torn")
    with pytest.warns(UserWarning, match="unusable"):
        out, _ = _train(splits, batches, run, resume=True)
    _assert_same(full["short"], out)


def test_resume_meta_keys_are_the_jax_set_and_the_route(splits, batches,
                                                        tmp_path):
    train, valid, test = splits
    jb = [{k: jnp.asarray(v) for k, v in ds.full_batch().items()}
          for ds in splits]
    jtrain_3phase(JGANConfig(**_cfg_kw(train)), *jb,
                  tcfg=JTrainConfig(**SHORT), save_dir=str(tmp_path / "j"),
                  verbose=False, stop_after_phase=1)
    _train(splits, batches, tmp_path / "p", stop_after_phase=1)
    jmeta = json.loads((tmp_path / "j" / "resume_meta.json").read_text())
    meta = json.loads((tmp_path / "p" / "resume_meta.json").read_text())
    assert set(meta) == set(jmeta) | {"kernel", "compute_dtype", "device"}
    assert (meta["kernel"], meta["compute_dtype"], meta["device"]) == (
        "auto", "float32", "cpu")
    for k in ("completed_phase", "seed", "tcfg", "gan_config",
              "history_phases", "in_phase", "epochs_in_phase",
              "partial_hist_keys", "share_sdf_program", "diag_stride"):
        assert meta[k] == jmeta[k], k


def test_stop_after_epochs_argument_checks(splits, batches, tmp_path):
    cfg = GANConfig(**_cfg_kw(splits[0]))
    with pytest.raises(ValueError, match="requires save_dir"):
        train_3phase(cfg, *batches, tcfg=TrainConfig(**SHORT),
                     verbose=False, exec_cfg=CPU, stop_after_epochs=3)
    with pytest.raises(ValueError, match="must be positive"):
        _train(splits, batches, tmp_path / "r", stop_after_epochs=0)
    with pytest.raises(ValueError, match="requires save_dir"):
        train_3phase(cfg, *batches, tcfg=TrainConfig(**SHORT),
                     verbose=False, exec_cfg=CPU, resume=True)
