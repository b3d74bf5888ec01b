"""The PyTorch port's elastic rolling refit on the CPU: the counterpart of
the JAX package's ``test_refit_worker_killed_resumes_with_zero_retrains``
(``tests/test_promotion.py``), with the same arguments.

A supervised ``--workers 1`` refit whose worker is SIGKILLed at its second
bucket claim (month 3 already recorded): the supervisor restarts it with
``--resume-from-ledger``, the restarted worker skips month 3 through the
ledger and completes month 4. Both months are recorded, every artifact
matches its record's sha256, one fault fired, and the port's report reads
the run: two buckets completed, one restart, at least one promotion.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from deeplearninginassetpricing_paperreplication_torch.observability.report import (
    format_summary,
    load_run,
    summarize_run,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.ledger import (
    SweepLedger,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.promotion import (
    read_pointer,
)

PKG = "deeplearninginassetpricing_paperreplication_torch"
REPO = Path(__file__).resolve().parents[1]
REFIT_ARGS = [
    "--months", "3", "4", "--seeds", "1",
    "--epochs_unc", "2", "--epochs_moment", "1", "--epochs", "3",
    "--ignore_epoch", "0", "--hidden_dim", "8", "--rnn_dim", "4",
    "--num_moments", "4", "--dropout", "0.0",
    "--device", "cpu", "--compute_dtype", "float32",
]


@pytest.fixture(scope="module")
def killed_fleet(synthetic_dir, tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("refit_elastic") / "refit_run"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLAP_FAULT_")}
    env["DLAP_FAULT_PLAN"] = json.dumps([{
        "site": "sweep/claim", "action": "kill", "trigger_count": 2}])
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.refit",
         "--data_dir", str(synthetic_dir), "--run_dir", str(run_dir),
         *REFIT_ARGS, "--workers", "1", "--lease_timeout", "5",
         "--worker_min_uptime", "0.5", "--worker_backoff", "0.2"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return run_dir


def test_refit_worker_killed_records_both_months(killed_fleet):
    """Both months recorded, artifacts byte-identical to their records."""
    ledger = SweepLedger(killed_fleet / "sweep_ledger")
    records = {ledger.load(k)["month"]: ledger.load(k) for k in ledger.keys()}
    assert set(records) == {3, 4}
    for rec in records.values():
        assert rec["worker"] == "w0"
        assert rec["execution"] == {"compute_dtype": "float32",
                                    "kernel": "auto"}
        for m in rec["members"]:
            data = (Path(m["dir"]) / m["file"]).read_bytes()
            assert hashlib.sha256(data).hexdigest() == m["sha256"]
    # exactly one planned kill fired, at the second claim
    fault_rows = [json.loads(line) for line in (
        killed_fleet / "events.faults.jsonl").read_text().splitlines()]
    assert [r["site"] for r in fault_rows] == ["sweep/claim"]
    # the restarted worker resumed from the ledger, never --resume
    rows = [json.loads(line) for line in (
        killed_fleet / "events.supervisor.w0.jsonl").read_text().splitlines()]
    children = [r for r in rows if r.get("kind") == "span_begin"
                and r.get("name") == "supervise/child"]
    assert [(c["attempt"], c["resumed"]) for c in children] == [
        (1, False), (2, True)]
    worker = json.loads((killed_fleet / "manifest.w0.json").read_text())
    assert "--resume-from-ledger" in worker["argv"]
    assert "--resume" not in worker["argv"]
    assert worker["kernel_route"] == "plain"


def test_refit_worker_killed_reads_through_the_report(killed_fleet):
    """Zero retrains: each bucket was recorded exactly once, fleet-wide,
    and the completed refits reached the gate."""
    summary = summarize_run(load_run(killed_fleet))
    assert summary["elastic"]["buckets_completed"] == 2
    assert summary["reliability"]["restarts"] == 1
    assert summary["promotion"]["promotions"] >= 1
    assert read_pointer(killed_fleet) is not None
    text = format_summary(summary)
    assert "elastic sweep:" in text and "reliability:" in text
    assert "promotion:" in text
