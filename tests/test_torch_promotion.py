"""The port's promotion gate and the checkpoint repair beneath it, on the
CPU.

* Every ``.pt`` the port writes has a ``.sha256`` sidecar and a ``.g1``
  predecessor (``reliability/verified.py``); a torn newest checkpoint loads
  from ``.g1``, and the reference's sidecar-less ``ref_runs/*/*.pt`` still
  load strictly.
* The pointer advances with its history and rolls back; each gate
  rejection carries the JAX package's slug; a SIGKILL at every fault site
  of the port's promote CLI leaves the old pointer or the new one, never a
  torn one (the JAX package's kill matrix, through the port's CLI in a
  subprocess with ``--device cpu``; the kill shows as the child's -9).
* The gate's modules import no torch, and one pointer file is read by both
  packages.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.models.networks import (
    AssetPricingModule,
    init_params,
)
from deeplearninginassetpricing_paperreplication_torch.observability.drift import (
    reference_profile,
    write_profile,
)
from deeplearninginassetpricing_paperreplication_torch.reliability import (
    promotion,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.verified import (
    digest_path,
    generation_path,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    load_checkpoint_dir,
    save_state_dict,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.reliability import (
    promotion as jpromotion,
)

REPO = Path(__file__).resolve().parents[1]
PKG = "deeplearninginassetpricing_paperreplication_torch"
CPU = ExecutionConfig(device="cpu", compute_dtype="float32")
T, N, F, M = 10, 32, 10, 6


def _cfg(**kw):
    base = dict(macro_feature_dim=M, individual_feature_dim=F,
                hidden_dim=(8, 8), num_units_rnn=(4,))
    return GANConfig(**dict(base, **kw))


def _state_dict(cfg, seed, nan=False):
    module = AssetPricingModule(cfg)
    init_params(module, torch.Generator().manual_seed(seed))
    sd = module.state_dict()
    return {k: v * float("nan") for k, v in sd.items()} if nan else sd


def _write_member(d: Path, cfg, seed, nan=False, profile=None):
    d.mkdir(parents=True, exist_ok=True)
    cfg.save(d / "config.json")
    save_state_dict(d / "best_model_sharpe.pt", _state_dict(cfg, seed, nan))
    if profile is not None:
        write_profile(d, profile)
    return str(d)


def _members(root: Path, cfg, seeds, **kw):
    return [_write_member(root / f"m{s}", cfg, s, **kw) for s in seeds]


@pytest.fixture(scope="module")
def panel():
    rng = np.random.default_rng(11)
    return {
        "macro": rng.standard_normal((T, M)).astype(np.float32),
        "individual": rng.standard_normal((T, N, F)).astype(np.float32),
        "returns": (rng.standard_normal((T, N)) * 0.05).astype(np.float32),
        "mask": (rng.random((T, N)) > 0.1).astype(np.float32),
    }


def _promote(ctl, dirs, **kw):
    return promotion.promote(ctl, dirs, exec_cfg=CPU, **kw)


# -- the repair: verified checkpoints ---------------------------------------


def test_save_state_dict_writes_a_sidecar_and_rotates(tmp_path):
    cfg = _cfg()
    path = tmp_path / "best_model_sharpe.pt"
    save_state_dict(path, _state_dict(cfg, 1))
    meta = json.loads(digest_path(path).read_text())
    assert meta["bytes"] == path.stat().st_size
    save_state_dict(path, _state_dict(cfg, 2))
    assert generation_path(path, 1).exists()
    assert digest_path(generation_path(path, 1)).exists()
    cfg.save(tmp_path / "config.json")
    got = load_checkpoint_dir(tmp_path)[1]
    want = _state_dict(cfg, 2)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_truncated_newest_checkpoint_loads_from_g1(tmp_path):
    cfg = _cfg()
    _write_member(tmp_path, cfg, 1)
    save_state_dict(tmp_path / "best_model_sharpe.pt", _state_dict(cfg, 2))
    path = tmp_path / "best_model_sharpe.pt"
    with open(path, "r+b") as f:
        f.truncate(path.stat().st_size // 2)
    with pytest.warns(UserWarning, match="fell back to best_model_sharpe"):
        _, sd = load_checkpoint_dir(tmp_path)
    want = _state_dict(cfg, 1)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    # every generation unusable: the error names each file
    g1 = generation_path(path, 1)
    g1.write_bytes(b"junk")
    with pytest.raises(ValueError) as e:
        load_checkpoint_dir(tmp_path)
    assert str(path) in str(e.value) and str(g1) in str(e.value)


@pytest.mark.parametrize("which", ["best_model_sharpe", "best_model_loss",
                                   "final_model"])
def test_ref_runs_without_sidecars_load_strictly(which):
    d = REPO / "ref_runs" / "w500"
    assert not digest_path(d / f"{which}.pt").exists()
    cfg, sd = load_checkpoint_dir(d, which)
    AssetPricingModule(cfg).load_state_dict(sd, strict=True)


# -- the pointer --------------------------------------------------------------


def test_promote_advances_pointer_with_history_and_rollback(tmp_path, panel):
    ctl = tmp_path / "ctl"
    cfg = _cfg()
    v1 = _members(tmp_path / "v1", cfg, (1, 2))
    v2 = _members(tmp_path / "v2", cfg, (11, 12))
    with pytest.raises(promotion.PromotionError):
        promotion.rollback(ctl)
    assert promotion.read_pointer(ctl) is None
    p1 = _promote(ctl, v1, valid_batch=panel, source="v1")
    assert p1["generation"] == 1 and p1["history"] == []
    assert np.isfinite(p1["valid_sharpe"])
    assert [m["file"] for m in p1["members"]] == ["best_model_sharpe.pt"] * 2
    p2 = _promote(ctl, v2, valid_batch=panel, source="v2",
                  sharpe_tolerance=None)
    assert p2["generation"] == 2
    assert p2["history"][0]["generation"] == 1
    assert p2["history"][0]["checkpoint_dirs"] == v1
    assert promotion.verify_pointer_members(p2) == []
    back = promotion.rollback(ctl, reason="test")
    assert back["generation"] == 3 and back["rolled_back_from"] == 2
    assert back["checkpoint_dirs"] == v1
    assert back["params_fingerprint"] == p1["params_fingerprint"]
    assert promotion.read_pointer(ctl) == back
    # a member torn after promotion fails the reload-time check
    Path(v1[0], "best_model_sharpe.pt").write_bytes(b"torn")
    assert len(promotion.verify_pointer_members(back)) == 1


def test_candidate_valid_sharpe_is_the_ensemble_metric(tmp_path, panel):
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble import (
        stack_checkpoints,
    )
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble import (
        ensemble_metrics,
    )

    cfg = _cfg()
    v1 = _members(tmp_path / "v1", cfg, (1, 2, 3))
    ev = promotion.evaluate_candidate(v1, panel, with_moments=True,
                                      exec_cfg=CPU)
    scfg, stacked = stack_checkpoints(v1, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in panel.items()}
    want = float(ensemble_metrics(scfg, stacked, batch, CPU)[
        "ensemble_sharpe"])
    assert ev["valid_sharpe"] == want
    assert ev["finite_params"] and ev["finite_outputs"]
    assert len(ev["moment_violations"]) == cfg.num_condition_moment
    assert ev["moment_violation_max"] == max(ev["moment_violations"])


# -- the gate's rejections, by slug -------------------------------------------


def _rejected(fn):
    with pytest.raises(promotion.GateRejection) as e:
        fn()
    return e.value.reason


def test_gate_rejects_a_torn_member_as_digest_mismatch(tmp_path, panel):
    ctl = tmp_path / "ctl"
    bad = _members(tmp_path / "bad", _cfg(), (1, 2))
    path = Path(bad[1]) / "best_model_sharpe.pt"
    with open(path, "r+b") as f:
        f.truncate(path.stat().st_size // 2)
    assert _rejected(lambda: _promote(ctl, bad, valid_batch=panel)) \
        == "digest_mismatch"
    assert promotion.read_pointer(ctl) is None


@pytest.mark.parametrize("tolerance,reason", [
    (1.0, "moment_violation"), (None, "nonfinite_params")])
def test_gate_rejects_nan_params(tmp_path, panel, tolerance, reason):
    ctl = tmp_path / "ctl"
    cfg = _cfg()
    dirs = _members(tmp_path / "ok", cfg, (1,)) + _members(
        tmp_path / "nan", cfg, (2,), nan=True)
    assert _rejected(lambda: _promote(ctl, dirs, valid_batch=panel,
                                      moment_tolerance=tolerance)) == reason


def test_gate_rejects_a_sharpe_regression(tmp_path, panel):
    ctl = tmp_path / "ctl"
    v1 = _members(tmp_path / "v1", _cfg(), (1,))
    p1 = _promote(ctl, v1, valid_batch=panel)
    # the incumbent's bar above the candidate's Sharpe + tolerance
    head = {k: p1[k] for k in promotion._HEAD_KEYS if k in p1}
    promotion.write_pointer(ctl, dict(head, valid_sharpe=p1[
        "valid_sharpe"] + 1.0))
    assert _rejected(lambda: _promote(ctl, v1, valid_batch=panel)) \
        == "sharpe_regression"
    assert _promote(ctl, v1, valid_batch=panel,
                    sharpe_tolerance=None)["generation"] == 3


def test_gate_rejects_another_width(tmp_path, panel):
    ctl = tmp_path / "ctl"
    _promote(ctl, _members(tmp_path / "v1", _cfg(), (1,)))
    wide = _members(tmp_path / "wide", _cfg(hidden_dim=(16, 16)), (2,))
    assert _rejected(lambda: _promote(ctl, wide)) == "architecture_mismatch"


def test_gate_rejects_members_that_do_not_stack(tmp_path):
    dirs = (_members(tmp_path / "a", _cfg(), (1,))
            + _members(tmp_path / "b", _cfg(hidden_dim=(16, 16)), (2,)))
    assert _rejected(lambda: _promote(tmp_path / "ctl", dirs)) \
        == "stack_error"


@pytest.mark.parametrize("stage", ["candidate_diagnostics",
                                   "ensemble_metrics"])
def test_gate_lets_a_failing_pass_propagate(tmp_path, panel, monkeypatch,
                                            stage):
    """An error of the validation pass (a kernel that fails to launch) is
    no candidate rejection: it propagates, and the pointer stays unset."""
    from deeplearninginassetpricing_paperreplication_torch.observability \
        import modelhealth
    from deeplearninginassetpricing_paperreplication_torch.parallel import \
        ensemble

    def fail(*a, **k):
        raise ValueError("kernel failed to launch")

    monkeypatch.setattr(modelhealth if stage == "candidate_diagnostics"
                        else ensemble, stage, fail)
    ctl = tmp_path / "ctl"
    dirs = _members(tmp_path / "v", _cfg(), (1,))
    with pytest.raises(ValueError, match="kernel failed to launch"):
        _promote(ctl, dirs, valid_batch=panel, moment_tolerance=1.0)
    assert promotion.read_pointer(ctl) is None


def test_gate_rejects_a_drifted_panel(tmp_path, panel):
    prof = reference_profile(panel, source="fixture")
    dirs = _members(tmp_path / "v", _cfg(), (1,), profile=prof)
    ctl = tmp_path / "ctl"
    sd = panel["individual"][panel["mask"] > 0].std(axis=0)
    shifted = dict(panel, individual=(panel["individual"] + 3 * sd).astype(
        np.float32))
    assert _rejected(lambda: _promote(ctl, dirs, valid_batch=shifted,
                                      drift_threshold=0.25)) == "data_drift"
    p = _promote(ctl, dirs, valid_batch=panel, drift_threshold=0.25)
    assert p["drift_max_psi"] is not None and p["drift_max_psi"] <= 0.25


def test_gate_rejects_no_dirs_and_absent_members(tmp_path):
    ctl = tmp_path / "ctl"
    assert _rejected(lambda: _promote(ctl, [])) == "missing_member"
    d = tmp_path / "empty"
    d.mkdir()
    _cfg().save(d / "config.json")
    assert _rejected(lambda: _promote(ctl, [str(d)])) == "missing_member"
    (d / "config.json").write_text("{")
    assert _rejected(lambda: _promote(ctl, [str(d)])) == "config_unreadable"


# -- crash consistency: a kill at every site of the promote CLI ---------------


PROMOTE_KILL_SITES = [
    ("promote/validate", None),
    ("promote/write", "serving_current"),
    ("checkpoint/save", "serving_current"),
    ("checkpoint/saved", "serving_current"),
]


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.reliability.promotion", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=env or dict(os.environ))


@pytest.mark.parametrize("site,match", PROMOTE_KILL_SITES,
                         ids=[s for s, _ in PROMOTE_KILL_SITES])
def test_pointer_crash_consistent_at_every_site(tmp_path, site, match):
    ctl = tmp_path / "ctl"
    cfg = _cfg()
    v1 = _members(tmp_path / "v1", cfg, (1,))
    v2 = _members(tmp_path / "v2", cfg, (2,))
    old = _promote(ctl, v1, source="v1")
    plan = [{"site": site, "action": "kill"}]
    if match:
        plan[0]["match"] = match
    proc = _cli("promote", "--root", str(ctl), "--candidates", *v2,
                "--source", "v2", "--sharpe_tolerance", "-1", "--device",
                "cpu", env=dict(os.environ, DLAP_FAULT_PLAN=json.dumps(plan)))
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
    pointer = promotion.read_pointer(ctl)  # parses + verifies or raises
    assert pointer["generation"] in (1, 2)
    assert pointer["checkpoint_dirs"] in (v1, v2)
    if pointer["generation"] == 1:
        assert pointer["params_fingerprint"] == old["params_fingerprint"]
    assert promotion.verify_pointer_members(pointer) == []
    after = _promote(ctl, v2, source="v2-after", sharpe_tolerance=None)
    assert after["checkpoint_dirs"] == v2


def test_promotion_cli_promote_show_reject(tmp_path, panel):
    ctl = tmp_path / "ctl"
    v1 = _members(tmp_path / "v1", _cfg(), (1, 2))
    npz = tmp_path / "valid.npz"
    np.savez(npz, **panel)
    assert _cli("show", "--root", str(ctl)).returncode == 1
    out = _cli("promote", "--root", str(ctl), "--candidates", *v1,
               "--valid_npz", str(npz), "--moment_tolerance", "1.0",
               "--device", "cpu", "--compute_dtype", "float32")
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["generation"] == 1 and np.isfinite(res["valid_sharpe"])
    shown = _cli("show", "--root", str(ctl))
    assert shown.returncode == 0
    assert json.loads(shown.stdout)["generation"] == 1
    path = Path(v1[0]) / "best_model_sharpe.pt"
    with open(path, "r+b") as f:
        f.truncate(path.stat().st_size // 2)
    rejected = _cli("promote", "--root", str(ctl), "--candidates", *v1,
                    "--device", "cpu")
    assert rejected.returncode == 1
    assert json.loads(rejected.stdout.splitlines()[-1])["rejected"] \
        == "digest_mismatch"
    back = _cli("rollback", "--root", str(ctl))
    assert back.returncode != 0  # one generation: nothing to roll back to


def test_promotion_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    v1 = _members(tmp_path / "v1", _cfg(), (1,))
    out = _cli("promote", "--root", str(tmp_path / "ctl"), "--candidates",
               *v1)
    assert out.returncode == 2 and "CUDA" in out.stderr
    assert not (tmp_path / "ctl").exists()


def test_gate_modules_import_no_torch():
    code = ("import sys\n"
            f"import {PKG}.reliability.promotion\n"
            f"import {PKG}.observability.modelhealth\n"
            f"import {PKG}.observability.drift\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'jax')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_one_pointer_file_is_read_by_both_packages(tmp_path, panel):
    ctl = tmp_path / "port"
    v1 = _members(tmp_path / "v1", _cfg(), (1,))
    ours = _promote(ctl, v1, valid_batch=panel)
    assert jpromotion.read_pointer(ctl) == ours
    jctl = tmp_path / "jax"
    head = {"checkpoint_dirs": v1, "config_hash": "c" * 64,
            "params_fingerprint": "f" * 64, "valid_sharpe": 0.5,
            "source": "jax", "promoted_at": 1.0, "members": []}
    theirs = jpromotion.write_pointer(jctl, head)
    assert promotion.read_pointer(jctl) == theirs
    assert set(ours) == set(theirs) | {"moment_violation_max",
                                       "drift_max_psi"}
    # the torch checkpoint bytes are what the pointer's digests name
    data = Path(v1[0], "best_model_sharpe.pt").read_bytes()
    assert torch.load(io.BytesIO(data), weights_only=True)


# -- the gate's counters in the events log ------------------------------------


def _counters(run_dir):
    drop = {"schema", "kind", "name", "run_id", "process_index", "tid",
            "seq", "ts", "mono", "value"}
    return [(r["name"], {k: v for k, v in r.items() if k not in drop})
            for r in map(json.loads, (run_dir / "events.jsonl").read_text()
                         .splitlines()) if r["kind"] == "counter"]


def test_gate_counters_carry_the_jax_names_and_attributes(tmp_path, panel):
    """promote/advance, promote/reject and promote/rollback with the JAX
    package's attributes. A rejection before any member loads, and a
    rollback of one pointer file, are counted by both packages alike."""
    from deeplearninginassetpricing_paperreplication_torch.observability.events import (
        EventLog,
    )
    from deeplearninginassetpricing_paperreplication_tpu.observability.events import (
        EventLog as JEventLog,
    )

    ctl = tmp_path / "ctl"
    cfg = _cfg()
    ev = EventLog(tmp_path / "ev")
    p1 = _promote(ctl, _members(tmp_path / "v1", cfg, (1,)),
                  valid_batch=panel, source="v1", events=ev)
    _promote(ctl, _members(tmp_path / "v2", cfg, (2,)), valid_batch=panel,
             source="v2", sharpe_tolerance=None, events=ev)
    with pytest.raises(promotion.GateRejection):
        _promote(ctl, [], source="none", events=ev)
    back = promotion.rollback(ctl, reason="drill", events=ev)
    ev.close()
    got = _counters(tmp_path / "ev")
    assert [n for n, _ in got] == ["promote/advance", "promote/advance",
                                   "promote/reject", "promote/rollback"]
    assert got[0][1] == {"generation": 1, "source": "v1",
                         "fingerprint": p1["params_fingerprint"][:16],
                         "sharpe": p1["valid_sharpe"]}
    assert got[2][1] == {"reason": "missing_member", "source": "none"}
    assert got[3][1] == {"generation": 3, "rolled_back_from": 2,
                         "fingerprint": back["params_fingerprint"][:16],
                         "reason": "drill"}
    # the JAX gate on the same pointer file and the same empty candidate
    jev = JEventLog(tmp_path / "jev")
    with pytest.raises(jpromotion.GateRejection):
        jpromotion.promote(ctl, [], source="none", events=jev)
    jpromotion.rollback(ctl, reason="drill", events=jev)
    jev.close()
    want = _counters(tmp_path / "jev")
    assert want[0] == got[2]
    assert want[1][0] == "promote/rollback"
    assert set(want[1][1]) == set(got[3][1])
