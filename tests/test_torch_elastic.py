"""The port's elastic sweep and supervised training, end to end on the CPU.

The CLI scenarios of ``tests/test_elastic.py`` (the headline fault
matrix), run through the port's entry points with ``--device cpu`` on the
shared synthetic panel:

  * a supervised ``--workers 2`` sweep killed once each at
    ``sweep/claim`` (an orphaned lease: expiry and takeover), mid-bucket
    (``sweep/bucket``, lease held) and ``sweep/ledger_write`` (trained
    but not recorded: retrained) writes a ``sweep_ranking.json``
    byte-identical to the uninterrupted ``--workers 0`` run, and retrains
    no completed bucket (one ledger write per bucket, each record naming
    its worker);
  * a poison bucket (a persistent ``raise``) is quarantined after
    ``--max_bucket_attempts`` claims and the ranking ships degraded, with
    an accurate ``sweep_coverage.json`` and the surviving bucket's entries
    bit for bit;
  * a supervised single-process sweep killed before its second bucket
    restarts with ``--resume-from-ledger`` and retrains only that bucket;
  * a supervised train CLI killed at ``trainer/phase_boundary`` restarts
    with ``--resume`` and ends with ``history.npz`` and ``final_model.pt``
    bit for bit a clean run's.

Every child runs with one intra-op thread (the fleet shares the runner's
cores) and a ``timeout``; leases, backoffs and uptimes are sub-second to
a few seconds. Port against port the comparisons are bit for bit; the
port's worker against the JAX package's sweep is held in
``tests/test_torch_scheduler.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

PKG = "deeplearninginassetpricing_paperreplication_torch"
CHILD_TIMEOUT = 240

ELASTIC_ARGS = [
    "--workers", "2", "--lease_timeout", "2",
    "--worker_min_uptime", "0.2", "--worker_backoff", "0.1",
    "--worker_max_restarts", "8", "--retry_backoff", "0.2",
]


def _env(plan=None, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLAP_FAULT_")}
    env["OMP_NUM_THREADS"] = "1"
    if plan is not None:
        env["DLAP_FAULT_PLAN"] = json.dumps(plan)
    return dict(env, **extra)


def _run(cmd, plan=None, **extra):
    return subprocess.run(cmd, env=_env(plan, **extra), capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT)


def _sweep_cli(data_dir, save_dir, *extra):
    return [sys.executable, "-m", f"{PKG}.sweep",
            "--data_dir", str(data_dir), "--save_dir", str(save_dir),
            "--quick", "--search_only", "--device", "cpu",
            "--compute_dtype", "float32"] + list(extra)


def _count_events(run_dir, name):
    n = 0
    for p in Path(run_dir).glob("events*.jsonl"):
        for line in p.read_text().splitlines():
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row.get("kind") == "counter" and row.get("name") == name:
                n += int(row.get("value", 1))
    return n


def _records(run_dir):
    recs = sorted((run_dir / "sweep_ledger" / "records").glob("*.json"))
    return [json.loads(p.read_text()) for p in recs]


@pytest.fixture(scope="module")
def quick_ref(synthetic_dir, tmp_path_factory):
    """The uninterrupted single-process quick search: the byte-level
    reference every elastic or faulted run must reproduce."""
    ref_dir = tmp_path_factory.mktemp("quick_ref")
    out = _run(_sweep_cli(synthetic_dir, ref_dir))
    assert out.returncode == 0, out.stdout + out.stderr
    return ref_dir, (ref_dir / "sweep_ranking.json").read_bytes()


def test_fault_matrix_2worker_sweep_kills_bit_identical(
        synthetic_dir, quick_ref, tmp_path):
    """One kill each at sweep/claim, mid-bucket and sweep/ledger_write,
    counted fleet-wide: the supervised workers restart, the queue drains,
    and the ranking is byte-identical to --workers 0 with no completed
    bucket retrained."""
    _, ref_bytes = quick_ref
    plan = [
        {"site": "sweep/claim", "action": "kill", "trigger_count": 1},
        {"site": "sweep/bucket", "action": "kill", "trigger_count": 2},
        {"site": "sweep/ledger_write", "action": "kill", "trigger_count": 2},
    ]
    run_dir = tmp_path / "faulted"
    # each kill consumes one of its bucket's claim attempts, and all three
    # may land on one bucket: the budget must exceed that
    counts = tmp_path / "launches.jsonl"
    out = _run(_sweep_cli(synthetic_dir, run_dir, *ELASTIC_ARGS,
                          "--max_bucket_attempts", "6"), plan,
               DLAP_LAUNCH_COUNTS=str(counts))
    assert out.returncode == 0, out.stdout + out.stderr
    assert (run_dir / "sweep_ranking.json").read_bytes() == ref_bytes

    fault_rows = [json.loads(x) for x in
                  (run_dir / "events.faults.jsonl").read_text().splitlines()]
    assert sorted((r["site"], r["action"]) for r in fault_rows) == [
        ("sweep/bucket", "kill"), ("sweep/claim", "kill"),
        ("sweep/ledger_write", "kill")]
    # no completed bucket retrained: one successful record write per
    # bucket, each record naming the worker that trained it
    assert _count_events(run_dir, "sweep/ledger_write") == 2
    recs = _records(run_dir)
    assert len(recs) == 2 and {r["worker"] for r in recs} <= {"w0", "w1"}
    assert all(r["execution"] == {"compute_dtype": "float32",
                                  "kernel": "auto"} for r in recs)
    coverage = json.loads((run_dir / "sweep_coverage.json").read_text())
    assert coverage["complete"] and coverage["completed"] == 2
    # three deaths, each followed by a supervised restart
    restarts = _count_events(run_dir, "supervise/restart")
    assert restarts == 3
    assert _count_events(run_dir, "sweep/lease_takeover") >= 1
    # each worker's manifest names its route: the plain one on the CPU
    for wid in ("w0", "w1"):
        m = json.loads((run_dir / f"manifest.{wid}.json").read_text())
        assert m["kind"] == "sweep_worker" and m["device"] == "cpu"
        assert m["kernel_route"] == "plain" and m["kernel_programs"] == {}
    # every process that exited normally left its launch counts (none on
    # the CPU: the plain route launches no kernel); the killed ones none
    rows = [json.loads(x) for x in counts.read_text().splitlines()]
    workers = [r for r in rows if "--worker" in r["argv"]]
    assert len(workers) == 2 and len(rows) == 3
    assert all(r[k] == 0 for r in rows for k in r if k not in ("pid", "argv"))


def test_poison_bucket_quarantines_and_ships_degraded(
        synthetic_dir, quick_ref, tmp_path):
    """A bucket that kills every worker that claims it is quarantined
    after K attempts; the ranking ships degraded with a coverage manifest
    naming it, and the surviving bucket's entries are the uninterrupted
    run's."""
    from deeplearninginassetpricing_paperreplication_torch.parallel.sweep \
        import bucket_work_items, grid_configs
    from deeplearninginassetpricing_paperreplication_torch.sweep import (
        QUICK_GRID_KW,
        QUICK_SEARCH_SCHEDULE,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import GANConfig, TrainConfig

    _, ref_bytes = quick_ref
    meta = json.loads((quick_ref[0] / "sweep_ledger" / "queue.json")
                      .read_text())
    base = GANConfig(macro_feature_dim=6, individual_feature_dim=10)
    items = bucket_work_items(grid_configs(base, **QUICK_GRID_KW), [42],
                              TrainConfig(**QUICK_SEARCH_SCHEDULE, seed=42))
    assert [it["key"] for it in items] == [it["key"]
                                           for it in meta["items"]]
    poison_key = items[1]["key"]
    plan = [{"site": "sweep/bucket", "action": "raise",
             "match": poison_key, "persistent": True}]
    run_dir = tmp_path / "poison"
    out = _run(_sweep_cli(synthetic_dir, run_dir, *ELASTIC_ARGS,
                          "--max_bucket_attempts", "2"), plan)
    assert out.returncode == 0, out.stdout + out.stderr  # fleet not sunk

    coverage = json.loads((run_dir / "sweep_coverage.json").read_text())
    assert not coverage["complete"]
    assert coverage["completed"] == 1 and coverage["n_buckets"] == 2
    assert coverage["coverage"] == 0.5
    assert [q["key"] for q in coverage["quarantined"]] == [poison_key]
    assert coverage["quarantined"][0]["attempts"] == 2
    assert coverage["missing"] == []
    assert (run_dir / "sweep_coverage.json.sha256").exists()
    ref_rows = json.loads(ref_bytes)
    survivors = [r for r in ref_rows if r["config"] != items[1]["config"]]
    got = json.loads((run_dir / "sweep_ranking.json").read_text())
    assert ([(r["config"], r["lr"], r["seed"], r["valid_sharpe"])
             for r in got]
            == [(r["config"], r["lr"], r["seed"], r["valid_sharpe"])
                for r in survivors])
    manifest = json.loads((run_dir / "manifest.json").read_text())
    assert manifest["search_coverage"]["completed"] == 1


def test_supervised_single_sweep_resumes_from_ledger(
        synthetic_dir, quick_ref, tmp_path):
    """Killed before its second bucket, a supervised single-process sweep
    restarts with --resume-from-ledger, reuses bucket 1 from its record
    and writes the uninterrupted ranking."""
    _, ref_bytes = quick_ref
    run_dir = tmp_path / "resumed"
    cmd = [sys.executable, "-m", f"{PKG}.supervise",
           "--run_dir", str(run_dir), "--timeout", "120", "--poll", "0.1",
           "--backoff", "0.1", "--jitter", "0", "--min_uptime", "0.5",
           "--max_restarts", "4", "--"] + _sweep_cli(synthetic_dir, run_dir)
    plan = [{"site": "sweep/bucket", "action": "kill", "trigger_count": 2}]
    out = _run(cmd, plan)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["outcome"] == "success" and summary["restarts"] == 1
    assert summary["deaths"][0]["section"] == "sweep_bucket"
    assert (run_dir / "sweep_ranking.json").read_bytes() == ref_bytes
    assert _count_events(run_dir, "sweep/ledger_hit") == 1
    assert _count_events(run_dir, "sweep/ledger_write") == 2
    sup_rows = [json.loads(x) for x in
                (run_dir / "events.supervisor.jsonl").read_text().splitlines()]
    children = [r for r in sup_rows if r.get("kind") == "span_begin"
                and r.get("name") == "supervise/child"]
    assert [(r["attempt"], r["resumed"]) for r in children] == [
        (1, False), (2, True)]
    argv = json.loads((run_dir / "manifest.json").read_text())["argv"]
    assert "--resume-from-ledger" in argv


TRAIN_ARGS = ["--epochs_unc", "4", "--epochs_moment", "2", "--epochs", "6",
              "--ignore_epoch", "1", "--hidden_dim", "8", "--rnn_dim", "4",
              "--num_moments", "4", "--print_freq", "100", "--device", "cpu",
              "--checkpoint_every", "2"]


def test_supervised_train_killed_at_phase_boundary_resumes(synthetic_dir,
                                                           tmp_path):
    """A kill at the phase-2 boundary (resume state saved): the
    supervisor restarts the train CLI with --resume, once, and the run
    dir ends bit for bit the unsupervised clean run's."""
    train = [sys.executable, "-m", f"{PKG}.train",
             "--data_dir", str(synthetic_dir)] + TRAIN_ARGS
    clean, run = tmp_path / "clean", tmp_path / "run"
    out = _run(train + ["--save_dir", str(clean)])
    assert out.returncode == 0, out.stderr
    cmd = [sys.executable, "-m", f"{PKG}.supervise", "--run_dir", str(run),
           "--timeout", "120", "--poll", "0.1", "--backoff", "0.1",
           "--jitter", "0", "--min_uptime", "0.5", "--"] + train + [
        "--save_dir", str(run)]
    plan = [{"site": "trainer/phase_boundary", "action": "kill",
             "trigger_count": 2}]
    out = _run(cmd, plan)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["restarts"] == 1 and summary["hang_kills"] == 0
    assert summary["deaths"][0]["rc"] == -9
    assert summary["deaths"][0]["section"] == "phase2_moment"
    # the fault fired once across the restart (the supervisor's state file)
    state = json.loads((run / "fault_state.json").read_text())
    assert state["counts"] == [3]
    rows = [json.loads(x) for x in
            (run / "events.faults.jsonl").read_text().splitlines()]
    assert [(r["site"], r["phase"]) for r in rows] == [
        ("trainer/phase_boundary", 2)]
    assert "--resume" in json.loads(
        (run / "manifest.json").read_text())["argv"]
    with np.load(clean / "history.npz") as a, \
            np.load(run / "history.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("final_model.pt", "best_model_sharpe.pt",
                 "best_model_loss.pt"):
        assert (clean / name).read_bytes() == (run / name).read_bytes(), name
    assert not list(run.glob("resume_*"))


def test_worker_without_a_card_fails_rather_than_train_on_the_cpu(
        synthetic_dir, quick_ref, tmp_path):
    """A worker (or the coordinator) started without --device cpu on a
    host with no card exits non-zero naming CUDA: nothing falls back to
    the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without a CUDA device")
    ref_dir, _ = quick_ref
    worker = [sys.executable, "-m", f"{PKG}.sweep", "--worker",
              "--worker_id", "w9", "--data_dir", str(synthetic_dir),
              "--save_dir", str(ref_dir)]
    out = _run(worker)
    assert out.returncode == 2 and "CUDA" in out.stderr
    assert not (ref_dir / "heartbeat.w9.json").exists()
