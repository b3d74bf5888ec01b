"""The port's copies of the JAX package's stdlib reliability modules
(``reliability/{faults,verified,ledger}.py``), on the CPU.

Each case of ``tests/test_reliability.py`` (the fault injector and the
verified file IO) and of ``tests/test_elastic.py`` (the ledger's records)
that concerns these modules runs against both packages' copies, so the
port is held to the JAX package's behaviour case by case; the bucket keys,
sidecars and records are also compared across the two directly, and each
copy loads without torch or jax.
"""

import hashlib
import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKGS = {"torch": "deeplearninginassetpricing_paperreplication_torch",
        "jax": "deeplearninginassetpricing_paperreplication_tpu"}


def _mods(which):
    pkg = PKGS[which]
    return tuple(importlib.import_module(f"{pkg}.reliability.{m}")
                 for m in ("faults", "verified", "ledger"))


@pytest.fixture(params=sorted(PKGS))
def rel(request, monkeypatch):
    """(faults, verified, ledger) of one package, with no fault plan in the
    environment and an unresolved injector singleton."""
    faults, verified, ledger = _mods(request.param)
    for name in ("DLAP_FAULT_PLAN", "DLAP_FAULT_STATE", "DLAP_FAULT_EVENTS"):
        monkeypatch.delenv(name, raising=False)
    faults.reset_injector()
    yield faults, verified, ledger
    faults.reset_injector()


# -- the fault injector -----------------------------------------------------------


def test_inject_without_plan_is_inert(rel):
    faults = rel[0]
    assert faults.get_injector() is None
    assert faults.inject("sweep/bucket", bucket=1) is None


def test_plan_from_env_inline_and_file(rel, monkeypatch, tmp_path):
    faults = rel[0]
    monkeypatch.setenv(faults.ENV_PLAN,
                       json.dumps([{"site": "a/b", "action": "raise"}]))
    assert [f["site"] for f in faults.FaultInjector.from_env().plan] == [
        "a/b"]
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps({"site": "c/d", "action": "kill",
                                     "trigger_count": 3}))
    monkeypatch.setenv(faults.ENV_PLAN, str(plan_file))
    inj = faults.FaultInjector.from_env()
    assert (inj.plan[0]["site"], inj.plan[0]["trigger_count"]) == ("c/d", 3)


def test_bad_plan_raises_plan_error(rel):
    faults = rel[0]
    with pytest.raises(faults.FaultPlanError, match="unknown action"):
        faults.FaultInjector([{"site": "x", "action": "explode"}])
    with pytest.raises(faults.FaultPlanError, match="no 'site'"):
        faults.FaultInjector([{"action": "raise"}])


def test_trigger_count_fires_on_nth_matching_hit(rel):
    faults = rel[0]
    inj = faults.FaultInjector(
        [{"site": "s", "action": "raise", "trigger_count": 3}])
    inj.fire("s")
    inj.fire("other")  # different site: not counted
    inj.fire("s")
    with pytest.raises(faults.FaultInjected, match="injected raise at s"):
        inj.fire("s")
    inj.fire("s")  # count 4 != 3: past the trigger, never fires again


def test_persistent_entry_fires_on_every_hit_from_nth(rel):
    faults = rel[0]
    inj = faults.FaultInjector([{"site": "sweep/bucket", "action": "raise",
                                 "trigger_count": 2, "persistent": True}])
    inj.fire("sweep/bucket")
    for _ in range(3):
        with pytest.raises(faults.FaultInjected):
            inj.fire("sweep/bucket")


def test_match_filters_on_path_context(rel, tmp_path):
    faults = rel[0]
    target = tmp_path / "sweep_ranking.json"
    target.write_bytes(b"x" * 100)
    other = tmp_path / "report.json"
    other.write_bytes(b"y" * 100)
    inj = faults.FaultInjector([{
        "site": "checkpoint/saved", "action": "truncate_file",
        "match": "sweep_ranking",
    }])
    inj.fire("checkpoint/saved", path=str(other))  # filtered: not counted
    assert other.stat().st_size == 100
    inj.fire("checkpoint/saved", path=str(target))
    assert target.stat().st_size == 50  # truncated to half


def test_an_entry_counts_its_own_hits(rel):
    """Two entries on one site see the same hits; each counts them, and a
    firing entry does not stop the other's count."""
    faults = rel[0]
    inj = faults.FaultInjector([
        {"site": "s", "action": "raise", "trigger_count": 1},
        {"site": "s", "action": "raise", "trigger_count": 2}])
    for n in (1, 2):
        with pytest.raises(faults.FaultInjected):
            inj.fire("s")
        assert inj.counts == [n, n]
    inj.fire("s")


def test_truncate_file_keeps_the_bytes_asked_for(rel, tmp_path):
    faults = rel[0]
    target = tmp_path / "report.json"
    target.write_bytes(b"z" * 64)
    faults.FaultInjector([{"site": "checkpoint/saved",
                           "action": "truncate_file", "keep_bytes": 5,
                           "path": str(target)}]).fire("checkpoint/saved")
    assert target.read_bytes() == b"z" * 5


@pytest.mark.parametrize("action", ["hang", "nan_loss"])
def test_port_refuses_the_supervisor_actions(action):
    """Both actions once served only the JAX package's supervisor and
    divergence guard; the port now has both, and accepts each plan as the
    JAX injector does. hang serves the supervisor's stale-heartbeat check:
    both packages' injectors take the plan, and a hit of another site or
    below the trigger count returns without firing (a fired hang never
    returns, so it is fired only in supervised child processes, in
    tests/test_torch_supervisor.py and tests/test_torch_elastic.py).
    nan_loss serves the training loop's divergence guard: the hit returns
    the token, as the JAX injector's does."""
    faults = _mods("torch")[0]
    jfaults = _mods("jax")[0]
    plan = [{"site": "trainer/epoch_loop", "action": action}]
    if action == "hang":
        plan[0]["trigger_count"] = 2
        for mod in (faults, jfaults):
            assert action in mod.ACTIONS
            inj = mod.FaultInjector(plan)
            assert inj.plan[0]["action"] == "hang"
            assert inj.fire("trainer/phase_boundary", phase=1) is None
            assert inj.fire("trainer/epoch_loop", phase="p",
                            epochs_done=2) is None
            assert inj.counts == [1]
        return
    for mod in (faults, jfaults):
        inj = mod.FaultInjector(plan)
        assert inj.fire("trainer/epoch_loop", phase="p",
                        epochs_done=2) == "nan_loss"
        assert inj.fire("trainer/epoch_loop", phase="p",
                        epochs_done=4) is None


def test_env_plan_reaches_the_module_singleton(rel, monkeypatch):
    faults = rel[0]
    monkeypatch.setenv(faults.ENV_PLAN, json.dumps(
        {"site": "sweep/bucket", "action": "raise", "match": "k2"}))
    faults.reset_injector()
    assert faults.inject("sweep/bucket", path="k1") is None
    with pytest.raises(faults.FaultInjected):
        faults.inject("sweep/bucket", path="k2")


@pytest.mark.parametrize("which", sorted(PKGS))
def test_faults_module_is_stdlib_only_by_path(which):
    """A thin parent can load faults.py by path: neither torch nor jax
    comes with it."""
    path = REPO / PKGS[which] / "reliability" / "faults.py"
    script = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('f', {str(path)!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "assert not {'torch', 'jax', 'flax'} & set(sys.modules)\n"
        "assert m.inject('any/site') is None\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-S", "-c", script],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_reliability_imports_no_torch():
    mods = [f"{PKGS['torch']}.reliability.{m}"
            for m in ("faults", "verified", "ledger")]
    script = ("import importlib, sys\n"
              f"for m in {mods!r}: importlib.import_module(m)\n"
              "print(sorted({'torch', 'jax'} & set(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- verified file IO ------------------------------------------------------------


def test_write_verified_is_atomic_with_sidecar(rel, tmp_path):
    verified = rel[1]
    p = tmp_path / "report.json"
    sha = verified.write_verified(p, b"payload")
    assert p.read_bytes() == b"payload"
    assert sha == hashlib.sha256(b"payload").hexdigest()
    sidecar = json.loads(verified.digest_path(p).read_text())
    assert sidecar == {"sha256": sha, "bytes": 7}
    assert not p.with_name(p.name + ".tmp").exists()


def test_rotation_keeps_previous_generation(rel, tmp_path):
    verified = rel[1]
    p = tmp_path / "report.json"
    for data in (b"one", b"two", b"three"):
        verified.write_verified(p, data)
    assert p.read_bytes() == b"three"
    assert verified.generation_path(p, 1).read_bytes() == b"two"
    # the default keeps current + one predecessor; "one" rotated away
    assert not verified.generation_path(p, 2).exists()


def test_corrupt_newest_falls_back_and_all_corrupt_names_files(rel,
                                                               tmp_path):
    verified = rel[1]
    p = tmp_path / "a.json"
    verified.write_verified(p, b"good-old")
    verified.write_verified(p, b"good-new")
    with open(p, "r+b") as f:  # torn write / bit rot on the newest
        f.truncate(3)
    with pytest.warns(UserWarning, match="fell back"):
        value, used = verified.load_verified(p, bytes)
    assert value == b"good-old" and used.name == "a.json.g1"
    with open(used, "r+b") as f:  # now both generations are bad
        f.truncate(3)
    with pytest.raises(ValueError, match="a.json.*sha256 mismatch"):
        verified.load_verified(p, bytes)
    verified.clear_generations(p)
    assert not verified.verified_exists(p)
    with pytest.raises(FileNotFoundError):
        verified.load_verified(p, bytes)


def test_sidecars_are_interchangeable(tmp_path):
    """A file the port writes verifies through the JAX package's reader, and
    the other way round."""
    (_, v_t, _), (_, v_j, _) = _mods("torch"), _mods("jax")
    for writer, reader, name in ((v_t, v_j, "a"), (v_j, v_t, "b")):
        writer.write_verified(tmp_path / name, b"bytes " + name.encode())
        assert reader.load_verified(tmp_path / name, bytes)[0] == (
            b"bytes " + name.encode())


# -- the ledger's records ----------------------------------------------------------


def _cfg_dict():
    return {"hidden_dim": [8], "num_units_rnn": [3], "dropout": 0.05,
            "num_condition_moment": 4}


def _record(ledger, *args):
    """make_record of either package (the port's takes the execution)."""
    if ledger.__name__.startswith(PKGS["torch"]):
        return ledger.make_record(*args, execution={})
    return ledger.make_record(*args)


def test_bucket_key_is_content_addressed(rel):
    ledger = rel[2]
    cfg, tcfg = _cfg_dict(), {"num_epochs": 4}
    k = ledger.bucket_key(cfg, [1e-3, 5e-4], [7], tcfg)
    assert k == ledger.bucket_key(dict(cfg), [1e-3, 5e-4], [7], dict(tcfg))
    # lr ORDER is part of the identity (it fixes the grid's member layout)
    assert k != ledger.bucket_key(cfg, [5e-4, 1e-3], [7], tcfg)
    assert k != ledger.bucket_key(cfg, [1e-3, 5e-4], [8], tcfg)
    assert k != ledger.bucket_key(cfg, [1e-3, 5e-4], [7], {"num_epochs": 5})
    assert k != ledger.bucket_key(dict(cfg, dropout=0.1), [1e-3, 5e-4], [7],
                                  tcfg)
    # the same content gives the other package's key, byte for byte
    other = _mods("jax" if ledger.__name__.startswith(PKGS["torch"])
                  else "torch")[2]
    assert k == other.bucket_key(cfg, [1e-3, 5e-4], [7], tcfg)


def test_ledger_records_verified_with_generation_fallback(rel, tmp_path):
    _, verified, ledger = rel
    led = ledger.SweepLedger(tmp_path)
    rec = _record(ledger, "k1", 0, _cfg_dict(), [1e-3], [7], [[1e-3, 7]],
                  [0.1])
    led.write("k1", rec)
    assert led.has("k1") and led.writes == 1
    back = ledger.SweepLedger(tmp_path)
    assert back.load("k1")["best_valid_sharpe"] == [0.1]
    # non-finite Sharpes serialize as null (→ -inf on a ranking rebuild)
    assert _record(ledger, "k2", 1, {}, [1e-3], [7], [[1e-3, 7]],
                   [float("-inf")])["best_valid_sharpe"] == [None]
    led.write("k1", rec)  # rotates the first write to .g1
    path = led.record_path("k1")
    with open(path, "r+b") as f:
        f.truncate(5)
    with pytest.warns(UserWarning, match="fell back"):
        assert led.load("k1")["key"] == "k1"
    with open(verified.generation_path(path, 1), "r+b") as f:
        f.truncate(5)
    with pytest.raises(ValueError, match="k1.json"):
        led.load("k1")


def test_ledger_reset_drops_records(rel, tmp_path):
    ledger = rel[2]
    led = ledger.SweepLedger(tmp_path)
    led.write("ka", _record(ledger, "ka", 0, {}, [1e-3], [7], [[1e-3, 7]],
                            [0.2]))
    led.reset()
    assert not led.has("ka")
    assert not list(led.records_dir.glob("*.json"))


def test_ledger_write_site_fires_before_any_byte(rel, tmp_path):
    faults, _, ledger = rel
    led = ledger.SweepLedger(tmp_path)
    faults._injector = faults.FaultInjector(
        [{"site": "sweep/ledger_write", "action": "raise"}])
    with pytest.raises(faults.FaultInjected):
        led.write("kz", _record(ledger, "kz", 0, {}, [1e-3], [7],
                                [[1e-3, 7]], [0.3]))
    assert not led.has("kz") and led.writes == 0


def test_records_match_field_for_field(tmp_path):
    """The port's record of a bucket is the JAX package's, worker
    included, but for the completion time and the port's ``execution``."""
    args = ("k", 3, _cfg_dict(), [1e-3, 5e-4], [7],
            [[1e-3, 7.0], [5e-4, 7.0]], [0.25, float("nan")])
    execution = {"compute_dtype": "float32", "kernel": "auto"}
    a = _mods("torch")[2].make_record(*args, execution=execution,
                                      worker="w", seconds=1.23456)
    b = _mods("jax")[2].make_record(*args, worker="w", seconds=1.23456)
    a.pop("completed_at"), b.pop("completed_at")
    assert a.pop("execution") == execution and a["worker"] == "w"
    assert a == b
    assert _mods("torch")[2].make_record(
        *args, execution=execution)["worker"] is None
