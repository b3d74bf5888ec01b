"""The port's leased work queue, ledger quarantine and fleet-wide fault
counters (``reliability/{scheduler,ledger,faults}.py``,
``parallel/sweep.py``'s elastic half) against the JAX package's, on the
CPU.

  * the queue unit cases of ``tests/test_elastic.py`` (claims, leases,
    takeover, retry backoff, quarantine after K failed claims, the lease
    keeper, the coverage manifest, persistent and fleet-wide fault
    counters) run against both packages' copies, so the port is held to
    the JAX package's behaviour case by case;
  * queues and ledgers written by one package open in the other, with the
    same ``status()`` and the same ``ranking_from_ledger`` ranking and
    coverage;
  * ``DLAP_FAULT_STATE`` counts hits across processes: a ``kill``
    persists its count before it executes, so it fires once across a
    restart, and two processes share one hit stream;
  * the port's worker (``run_sweep_worker``, in process, from the JAX
    init) gives the JAX ``run_sweep`` ranking at the sweep test's bars
    (valid Sharpe rtol 2e-4, atol 1e-5).
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PKGS = {"torch": "deeplearninginassetpricing_paperreplication_torch",
        "jax": "deeplearninginassetpricing_paperreplication_tpu"}


class Pkg:
    """One package's reliability modules and its ``ranking_from_ledger``."""

    def __init__(self, which):
        self.which = which
        mod = lambda m: importlib.import_module(f"{PKGS[which]}.{m}")  # noqa: E731
        self.faults = mod("reliability.faults")
        self.ledger = mod("reliability.ledger")
        self.scheduler = mod("reliability.scheduler")
        self.supervisor = mod("reliability.supervisor")
        self.sweep = mod("parallel.sweep")
        self.config = mod("utils.config")

    def record(self, key, i, worker="t"):
        kw = dict(worker=worker)
        if self.which == "torch":
            kw["execution"] = {"compute_dtype": "float32", "kernel": "auto"}
        return self.ledger.make_record(key, i, _tiny_cfg(self).to_dict(),
                                       [1e-3], [7], [[1e-3, 7]],
                                       [0.1 * (i + 1)], **kw)

    def queue(self, root, events=None, **kw):
        kw.setdefault("lease_timeout_s", 30.0)
        kw.setdefault("max_attempts", 3)
        kw.setdefault("backoff", self.supervisor.RestartPolicy(
            backoff_base_s=0.0, backoff_max_s=0.0, jitter_frac=0.0))
        return self.scheduler.WorkQueue(root, events=events, **kw)


def _tiny_cfg(pkg):
    return pkg.config.GANConfig(
        macro_feature_dim=0, individual_feature_dim=4, hidden_dim=(4,),
        use_rnn=False, hidden_dim_moment=(), num_condition_moment=2)


def _items(pkg, n):
    config = _tiny_cfg(pkg).to_dict()
    return [{"key": f"k{i}", "index": i, "config": config, "lrs": [1e-3]}
            for i in range(n)]


@pytest.fixture(params=sorted(PKGS))
def pk(request, monkeypatch):
    p = Pkg(request.param)
    for name in ("DLAP_FAULT_PLAN", "DLAP_FAULT_STATE", "DLAP_FAULT_EVENTS"):
        monkeypatch.delenv(name, raising=False)
    p.faults.reset_injector()
    yield p
    p.faults.reset_injector()


class _Counters:
    """Stub events sink capturing counter rows (the WorkQueue contract)."""

    def __init__(self):
        self.rows = []

    def counter(self, name, value=1, **attrs):
        self.rows.append(dict(attrs, name=name, value=value))

    def named(self, name):
        return [r for r in self.rows if r["name"] == name]


# -- the ledger's quarantine ----------------------------------------------------


def test_ledger_quarantine_keys_and_reset(pk, tmp_path):
    led = pk.ledger.SweepLedger(tmp_path)
    led.write("ka", pk.record("ka", 0))
    led.write("kc", pk.record("kc", 2))
    led.quarantine("kb", {"attempts": 2, "index": 1})
    assert led.keys() == ["ka", "kc"]
    assert led.is_quarantined("kb") and not led.is_quarantined("ka")
    assert led.quarantined()["kb"]["attempts"] == 2
    assert led.load("ka")["worker"] == "t" and led.hits == 1
    (tmp_path / "leases").mkdir()
    (tmp_path / "leases" / "kc.json").write_text("{}")
    pk.queue(tmp_path).write_manifest(_items(pk, 1), {})
    led.reset()
    assert not led.has("ka") and not led.is_quarantined("kb")
    assert led.keys() == [] and not (tmp_path / "leases").exists()
    assert not (tmp_path / "queue.json").exists()


# -- the work queue -----------------------------------------------------------


def test_queue_claims_are_exclusive_and_drain(pk, tmp_path):
    q = pk.queue(tmp_path)
    q.write_manifest(_items(pk, 2), {"kind": "sweep_queue"})
    s, a = q.claim("w0")
    assert s == "claimed" and a["index"] == 0 and a["attempt"] == 1
    s, b = q.claim("w1")
    assert s == "claimed" and b["index"] == 1  # never the same bucket twice
    assert q.claim("w2") == ("wait", None)  # all leased, none done
    q.ledger.write(a["key"], pk.record(a["key"], 0))
    q.complete(a["key"], "w0")
    assert q.claim("w0") == ("wait", None)  # b still leased by w1
    q.ledger.write(b["key"], pk.record(b["key"], 1))
    q.complete(b["key"], "w1")
    assert q.claim("w0") == ("drained", None)
    assert q.status() == {"total": 2, "completed": 2, "quarantined": 0,
                          "leased": 0, "pending": 0}


def test_queue_lease_expiry_is_taken_over_and_counted(pk, tmp_path):
    ev = _Counters()
    q = pk.queue(tmp_path, events=ev, lease_timeout_s=0.2)
    q.write_manifest(_items(pk, 1), {})
    s, a = q.claim("w0")
    assert s == "claimed"
    assert q.claim("w1") == ("wait", None)  # lease still live
    time.sleep(0.25)  # w0 presumed dead: its lease expired
    s, b = q.claim("w1")
    assert s == "claimed" and b["attempt"] == 2
    assert len(ev.named("sweep/lease_takeover")) == 1
    assert ev.named("sweep/lease_takeover")[0]["from_worker"] == "w0"
    assert len(ev.named("sweep/retry")) == 1
    assert len(ev.named("sweep/claim")) == 2


def test_expired_own_lease_defers_to_a_sibling_for_the_grace(pk, tmp_path):
    q = pk.queue(tmp_path, lease_timeout_s=0.1, self_reclaim_grace_s=0.3)
    q.write_manifest(_items(pk, 1), {})
    assert q.claim("w0")[0] == "claimed"
    time.sleep(0.15)  # expired in w0's hands
    assert q.claim("w0") == ("wait", None)  # w0 defers inside the grace
    assert 0.01 <= q.next_wake_delay(1.0, worker="w0") <= 0.3
    s, b = q.claim("w1")  # a live sibling takes it over at once
    assert s == "claimed" and b["attempt"] == 2


def test_queue_failed_claims_quarantine_poison_bucket(pk, tmp_path):
    ev = _Counters()
    q = pk.queue(tmp_path, events=ev, max_attempts=2, lease_timeout_s=30.0)
    q.write_manifest(_items(pk, 1), {})
    for attempt in (1, 2):
        s, a = q.claim("w0")
        assert s == "claimed" and a["attempt"] == attempt
        q.fail(a["key"], "w0", error="synthetic poison")
    # third scan: 2 attempts consumed without completing → quarantine
    assert q.claim("w0") == ("drained", None)
    assert q.ledger.is_quarantined("k0")
    marker = q.ledger.quarantined()["k0"]
    assert marker["attempts"] == 2
    assert marker["history"][-1]["error"] == "synthetic poison"
    assert len(ev.named("sweep/quarantine")) == 1
    assert q.status()["quarantined"] == 1


def test_queue_retry_backoff_gates_reclaim(pk, tmp_path):
    q = pk.queue(tmp_path, max_attempts=5,
                 backoff=pk.supervisor.RestartPolicy(
                     backoff_base_s=0.3, backoff_max_s=0.3, jitter_frac=0.0))
    q.write_manifest(_items(pk, 1), {})
    s, a = q.claim("w0")
    q.fail(a["key"], "w0", error="boom")
    # inside the backoff window the bucket is pending, not claimable
    assert q.claim("w0") == ("wait", None)
    time.sleep(0.35)
    s, b = q.claim("w0")
    assert s == "claimed" and b["attempt"] == 2


def test_queue_fail_restamps_backoff_from_failure_time(pk, tmp_path):
    q = pk.queue(tmp_path, max_attempts=5,
                 backoff=pk.supervisor.RestartPolicy(
                     backoff_base_s=0.3, backoff_max_s=0.3, jitter_frac=0.0))
    q.write_manifest(_items(pk, 1), {})
    s, a = q.claim("w0")
    time.sleep(0.35)  # the claim-time window (0.3 s) elapsed "training"
    q.fail(a["key"], "w0", error="slow crash")
    assert q.claim("w0") == ("wait", None)  # still gated, from fail time
    time.sleep(0.35)
    s, b = q.claim("w0")
    assert s == "claimed" and b["attempt"] == 2


def test_lease_keeper_renews_and_flags_loss(pk, tmp_path):
    q = pk.queue(tmp_path, lease_timeout_s=0.3)
    q.write_manifest(_items(pk, 1), {})
    s, a = q.claim("w0")
    with pk.scheduler.LeaseKeeper(q, a["key"], "w0") as keeper:
        time.sleep(0.5)  # past the timeout: only renewal keeps it alive
        assert q.claim("w1") == ("wait", None)
        assert not keeper.lost
        # another worker takes the lease (as after a presumed death)
        (q.leases_dir / f"{a['key']}.json").write_text(json.dumps(
            {"worker": "w1", "ts": time.time()}))
        deadline = time.time() + 5.0
        while not keeper.lost and time.time() < deadline:
            time.sleep(0.05)
        assert keeper.lost
    lease = json.loads((q.leases_dir / f"{a['key']}.json").read_text())
    assert lease["worker"] == "w1"
    with pytest.raises(pk.scheduler.LeaseLost):
        q.renew(a["key"], "w0")


def test_lease_keeper_beats_heartbeat_until_budget_expires(pk, tmp_path):
    class _Beats:
        def __init__(self):
            self.sections = []

        def beat(self, section, **kw):
            self.sections.append(section)

    hb = _Beats()
    q = pk.queue(tmp_path, lease_timeout_s=0.3)
    q.write_manifest(_items(pk, 1), {})
    s, a = q.claim("w0")
    with pk.scheduler.LeaseKeeper(q, a["key"], "w0", heartbeat=hb,
                                  max_lifetime_s=0.6) as keeper:
        time.sleep(0.45)
        assert hb.sections and set(hb.sections) == {"sweep_bucket"}
        n_before = len(hb.sections)
        deadline = time.monotonic() + 10.0
        while not keeper.expired and time.monotonic() < deadline:
            time.sleep(0.05)
        assert keeper.expired
        n_after = len(hb.sections)
    time.sleep(0.35)
    assert len(hb.sections) == n_after >= n_before  # silent after expiry
    s, b = q.claim("w1")
    assert s == "claimed" and b["attempt"] == 2


def test_device_slice_leases_are_exclusive(pk, tmp_path):
    q = pk.queue(tmp_path, lease_timeout_s=0.2)
    assert q.claim_device_slice("w0", 2) == 0
    assert q.claim_device_slice("w1", 2) == 1
    assert q.claim_device_slice("w2", 2) is None
    assert q.claim_device_slice("w0", 2) == 0  # its own, re-leased
    time.sleep(0.25)
    assert q.claim_device_slice("w2", 2) == 0  # w0's expired: taken over
    with pytest.raises(pk.scheduler.LeaseLost):
        q.renew_device_slice(0, "w0")
    q.release_device_slice(1, "w1")
    assert q.claim_device_slice("w3", 2) == 1


def test_ranking_from_ledger_coverage_manifest(pk, tmp_path):
    q = pk.queue(tmp_path)
    q.write_manifest(_items(pk, 3), {})
    q.ledger.write("k0", pk.record("k0", 0))
    q.ledger.write("k2", pk.record("k2", 2))
    q.ledger.quarantine("k1", {"attempts": 2, "index": 1})
    ranked, coverage = pk.sweep.ranking_from_ledger(q)
    assert [r["valid_sharpe"] for r in ranked] == [pytest.approx(0.3),
                                                   pytest.approx(0.1)]
    assert coverage["n_buckets"] == 3 and coverage["completed"] == 2
    assert not coverage["complete"] and coverage["coverage"] == 0.6667
    assert [qq["index"] for qq in coverage["quarantined"]] == [1]
    assert coverage["quarantined"][0]["attempts"] == 2
    assert coverage["missing"] == []


def test_open_work_queue_takes_the_fleet_settings(pk, tmp_path):
    q = pk.queue(tmp_path / pk.ledger.LEDGER_DIRNAME)
    q.write_manifest(_items(pk, 1), {"lease_timeout_s": 7.5,
                                     "max_attempts": 4,
                                     "retry_backoff_s": 0.25})
    back = pk.sweep.open_work_queue(tmp_path)
    assert back.lease_timeout_s == 7.5 and back.max_attempts == 4
    assert back.backoff.backoff_s(1, rng=lambda: 0.0) == 0.25
    assert back.backoff.backoff_max_s == 30.0


# -- fault counters: persistent entries, fleet-wide state -----------------------


def test_fault_persistent_entry_fires_on_every_hit_from_nth(pk):
    inj = pk.faults.FaultInjector(
        [{"site": "s", "action": "raise", "trigger_count": 2,
          "persistent": True}])
    inj.fire("s")  # hit 1: below trigger
    for _ in range(3):  # hits 2, 3, 4: a poison site keeps firing
        with pytest.raises(pk.faults.FaultInjected):
            inj.fire("s")


def test_fault_state_is_fleetwide_across_live_instances(pk, tmp_path):
    state = tmp_path / "fault_state.json"
    events = tmp_path / "events.faults.jsonl"
    plan = [{"site": "s", "action": "raise", "trigger_count": 2}]
    inj1 = pk.faults.FaultInjector(plan, state_path=state,
                                   events_path=events)
    inj2 = pk.faults.FaultInjector(plan, state_path=state,
                                   events_path=events)
    inj1.fire("s")  # fleet hit 1
    with pytest.raises(pk.faults.FaultInjected):
        inj2.fire("s", path="k9")  # fleet hit 2 fires HERE
    inj1.fire("s")  # fleet hit 3: past the trigger, never again
    inj2.fire("s")
    assert json.loads(state.read_text()) == {"counts": [4]}
    rows = [json.loads(x) for x in events.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["name"] == "fault/injected"
    assert (rows[0]["site"], rows[0]["action"], rows[0]["path"]) == (
        "s", "raise", "k9")


def test_env_names_the_state_and_events_files(pk, tmp_path, monkeypatch):
    monkeypatch.setenv(pk.faults.ENV_PLAN, json.dumps(
        {"site": "s", "action": "truncate_file", "trigger_count": 1}))
    monkeypatch.setenv(pk.faults.ENV_STATE, str(tmp_path / "st.json"))
    monkeypatch.setenv(pk.faults.ENV_EVENTS, str(tmp_path / "ev.jsonl"))
    pk.faults.reset_injector()
    assert pk.faults.inject("s", path=str(tmp_path / "missing")) is None
    assert json.loads((tmp_path / "st.json").read_text()) == {"counts": [1]}
    assert "fault/injected" in (tmp_path / "ev.jsonl").read_text()


@pytest.mark.parametrize("which", sorted(PKGS))
def test_a_kill_persists_its_count_before_it_fires(which, tmp_path):
    """Two processes loading faults.py by path share one state file: the
    first dies -9 at the planned hit, having persisted the count first;
    the second (a restart) replays the same hits and does not die."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('f', sys.argv[1])\n"
        "f = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(f)\n"
        "for _ in range(3):\n"
        "    f.inject('sweep/claim', path='k')\n"
        "print('survived')\n")
    path = REPO / PKGS[which] / "reliability" / "faults.py"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLAP_FAULT_")}
    env.update(DLAP_FAULT_PLAN=json.dumps(
        [{"site": "sweep/claim", "action": "kill", "trigger_count": 2}]),
        DLAP_FAULT_STATE=str(tmp_path / "state.json"),
        DLAP_FAULT_EVENTS=str(tmp_path / "events.jsonl"))
    runs = [subprocess.run([sys.executable, "-S", "-c", code, str(path)],
                           env=env, capture_output=True, text=True,
                           timeout=60) for _ in range(2)]
    assert runs[0].returncode == -9 and "survived" not in runs[0].stdout
    assert runs[1].returncode == 0 and "survived" in runs[1].stdout
    assert json.loads((tmp_path / "state.json").read_text()) == {
        "counts": [5]}
    rows = (tmp_path / "events.jsonl").read_text().splitlines()
    assert len(rows) == 1 and json.loads(rows[0])["action"] == "kill"


# -- queues and ledgers interchange between the packages -------------------------


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_queue_and_ledger_open_in_the_other_package(writer, reader,
                                                    tmp_path):
    w, r = Pkg(writer), Pkg(reader)
    items = _items(w, 4)
    q = w.queue(tmp_path / "sweep_ledger", lease_timeout_s=60.0)
    q.write_manifest(items, {"kind": "sweep_queue", "lease_timeout_s": 60.0,
                             "max_attempts": 3})
    q.ledger.write("k0", w.record("k0", 0, worker="w0"))
    q.ledger.write("k3", w.record("k3", 3, worker="w1"))
    q.ledger.quarantine("k1", {"attempts": 3, "index": 1})
    assert q.claim("w1")[1]["key"] == "k2"  # k2 leased
    want_status = q.status()
    want_rank, want_cov = w.sweep.ranking_from_ledger(q)

    other = r.sweep.open_work_queue(tmp_path)  # settings from the manifest
    assert (other.lease_timeout_s, other.max_attempts) == (60.0, 3)
    assert other.status() == want_status == {
        "total": 4, "completed": 2, "quarantined": 1, "leased": 1,
        "pending": 0}
    got_rank, got_cov = r.sweep.ranking_from_ledger(other)
    assert got_cov == want_cov
    assert ([(e["config"].to_dict(), e["lr"], e["seed"], e["valid_sharpe"])
             for e in got_rank]
            == [(e["config"].to_dict(), e["lr"], e["seed"], e["valid_sharpe"])
                for e in want_rank])
    assert other.ledger.load("k3")["worker"] == "w1"
    assert other.ledger.keys() == ["k0", "k3"]
    # the reader's queue goes on where the writer's left off
    assert other.claim("w1") == ("wait", None)
    other.ledger.write("k2", r.record("k2", 2, worker="w1"))
    other.complete("k2", "w1")
    assert other.claim("w0") == ("drained", None)
    assert q.status()["completed"] == 3


# -- the port's worker against the JAX run_sweep ---------------------------------


def test_port_worker_ranking_holds_the_jax_run_sweep(splits, tmp_path):
    """Two buckets × two lrs × one seed, dropout 0, the port started from
    the JAX init: the port's worker trains every bucket from the queue,
    its records (each naming the worker) rank as the JAX in-process
    sweep does, within the sweep test's bars."""
    import jax
    import torch

    from deeplearninginassetpricing_paperreplication_torch.parallel import (
        sweep as sw,
    )
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        import scheduler
    from deeplearninginassetpricing_paperreplication_torch.training \
        .checkpoint import stacked_state_dict_from_jax_params
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig, GANConfig, TrainConfig
    from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
        GAN as JGAN,
    )
    from deeplearninginassetpricing_paperreplication_tpu.parallel import (
        ensemble as jens,
    )
    from deeplearninginassetpricing_paperreplication_tpu.parallel import (
        sweep as jsw,
    )
    from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
        GANConfig as JGANConfig,
    )
    from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
        TrainConfig as JTrainConfig,
    )

    train, valid, _ = splits
    sched = dict(num_epochs_unc=4, num_epochs_moment=2, num_epochs=8,
                 ignore_epoch=1)
    grid_kw = dict(hidden_dims=((8, 8), (6,)), rnn_units=((4,),),
                   num_moments=(4,), dropouts=(0.0,), lrs=(1e-3, 5e-3))
    seeds = [11]
    dims = dict(macro_feature_dim=train.macro_feature_dim,
                individual_feature_dim=train.individual_feature_dim)
    tcfg = TrainConfig(**sched)
    configs = sw.grid_configs(GANConfig(**dims), **grid_kw)

    queue = scheduler.WorkQueue(tmp_path / "sweep_ledger")
    queue.write_manifest(sw.bucket_work_items(configs, seeds, tcfg), {
        "kind": "sweep_queue", "tcfg": dataclasses.asdict(tcfg),
        "seeds": seeds, "member_chunk": None})

    def jax_init(cfg, grid_seeds):
        jgan = JGAN(JGANConfig(**dataclasses.asdict(cfg)))
        return stacked_state_dict_from_jax_params(
            jax.device_get(jens.init_ensemble_params(jgan, grid_seeds)), cfg)

    real_train_bucket = sw.train_bucket

    def from_jax_init(*a, **kw):
        return real_train_bucket(*a, init=jax_init, **kw)

    tb = {k: torch.from_numpy(np.asarray(v, np.float32))
          for k, v in train.full_batch().items()}
    vb = {k: torch.from_numpy(np.asarray(v, np.float32))
          for k, v in valid.full_batch().items()}
    sw.train_bucket = from_jax_init
    try:
        n = sw.run_sweep_worker(
            queue, "w0", tb, vb, verbose=False,
            exec_cfg=ExecutionConfig(device="cpu", compute_dtype="float32"))
    finally:
        sw.train_bucket = real_train_bucket
    assert n == 2 and queue.status()["completed"] == 2
    assert {queue.ledger.load(k)["worker"] for k in queue.ledger.keys()} \
        == {"w0"}
    ranked, coverage = sw.ranking_from_ledger(queue)
    assert coverage["complete"] and coverage["coverage"] == 1.0

    jb = {k: jax.numpy.asarray(v) for k, v in train.full_batch().items()}
    jvb = {k: jax.numpy.asarray(v) for k, v in valid.full_batch().items()}
    jranked = jsw.run_sweep(
        jsw.grid_configs(JGANConfig(**dims), **grid_kw), seeds, jb, jvb,
        tcfg=JTrainConfig(**sched), top_k=None, verbose=False)

    def key(e):
        return (str(e["config"].hidden_dim), e["lr"], e["seed"])

    want = {key(e): e["valid_sharpe"] for e in jranked}
    got = {key(e): e["valid_sharpe"] for e in ranked}
    assert set(got) == set(want) and len(got) == 4
    ks = sorted(want)
    np.testing.assert_allclose([got[k] for k in ks], [want[k] for k in ks],
                               rtol=2e-4, atol=1e-5)


def test_sweep_cli_takes_the_jax_elastic_flags():
    """Every flag of the JAX sweep CLI, the mesh-packed search's
    --device_slices and --slice_width included, with their defaults; the
    port adds its execution flags."""
    from deeplearninginassetpricing_paperreplication_torch import sweep
    from deeplearninginassetpricing_paperreplication_tpu import (
        sweep as jsweep,
    )

    def flags(parser):
        return {a.dest for a in parser._actions} - {"help"}

    ours, theirs = flags(sweep.build_arg_parser()), flags(
        jsweep.build_arg_parser())
    assert theirs - ours == set()
    assert ours - theirs == {"device", "compute_dtype", "kernel"}
    defaults = [{a.dest: a.default for a in p._actions} for p in (
        sweep.build_arg_parser(), jsweep.build_arg_parser())]
    for dest in ("device_slices", "slice_width"):
        assert defaults[0][dest] == defaults[1][dest], dest
