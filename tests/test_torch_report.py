"""The PyTorch port's report CLI, trace assembly and budget gate
(``observability/{report,trace,budgets}.py``, ``report.py``) against the JAX
package's, on the CPU.

On the same run dirs, the port's ``summarize_run``, ``format_summary``,
``assemble_trace`` and ``check_budgets`` give what the JAX package's give.
The run dirs: the hand-written event rows of the JAX package's report and
telemetry tests (``tests/test_observability.py``,
``tests/test_telemetry.py``: compile windows, resumed and budget-stopped
phases, latest-run scoping, multi-file traces, clock alignment, dangling
spans, thread lanes, fault rows without a monotonic clock), one dir per
report section (startup, serving with a metrics snapshot, reliability,
elastic with a ledger, promotion with a pointer, model health), a port
train-CLI run dir and a port refit dir.

The one stated difference: the JAX report's AOT-program section
(``xla_programs``, XLA's cost analysis) is the port's kernel-plans section
(``kernel_programs``, each kernel's launch plan as the card holds it), so
both are taken out before the comparison and the port's is checked on its
own. The port also has no SLO section yet (its status board is not
ported); no run dir here carries SLO rows but the one that checks that.

Then the CLI's exit codes, the port's against the JAX package's: a budget
regression, a missing parity baseline, a malformed spec, no run dir, a
trace of nothing.
"""

import json
import time
from collections import namedtuple
from pathlib import Path

import pytest

from deeplearninginassetpricing_paperreplication_torch import refit, train
from deeplearninginassetpricing_paperreplication_torch.observability import (
    budgets,
    programs,
    report,
    trace,
)
from deeplearninginassetpricing_paperreplication_torch.observability.drift import (
    write_profile,
)
from deeplearninginassetpricing_paperreplication_torch.observability.events import (
    EventLog,
)
from deeplearninginassetpricing_paperreplication_torch.observability.manifest import (
    update_manifest,
    write_manifest,
)
from deeplearninginassetpricing_paperreplication_torch.observability.modelhealth import (
    write_health,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.ledger import (
    SweepLedger,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.promotion import (
    write_pointer,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.scheduler import (
    WorkQueue,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    GANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    budgets as jbudgets,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    report as jreport,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    trace as jtrace,
)

REPO = Path(__file__).resolve().parents[1]
# the sections that differ by design: (port summary key, JAX summary key),
# and the text blocks that render them
PLANS_KEYS = ("kernel_programs", "xla_programs")
PLANS_HEADERS = ("  kernel launch plans", "  AOT programs")


def _row(kind, name, ts, mono, run_id="r1", tid=0, **extra):
    return {"kind": kind, "name": name, "ts": ts, "mono": mono,
            "run_id": run_id, "tid": tid, "process_index": 0, **extra}


def _write_rows(path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


# -- the run dirs ------------------------------------------------------------------


def _synthetic_train(run):
    """Every input path of a train run dir (the JAX test's
    ``_synthetic_run_dir``)."""
    ev = EventLog(run, process_index=0)
    with ev.span("compile/phase_unconditional"):
        pass
    with ev.span("compile/phase_conditional"):
        pass
    with ev.span("phase/phase1_unconditional", epochs=2):
        time.sleep(0.01)
    with ev.span("phase/phase3_conditional", epochs=3):
        time.sleep(0.01)
    ev.emit("memory", "device_memory", n_devices=2,
            totals={"bytes_in_use": 3 << 20, "peak_bytes_in_use": 5 << 20},
            per_device=[])
    write_manifest(run, "train", events=ev,
                   config=GANConfig(macro_feature_dim=2,
                                    individual_feature_dim=3), seed=1)
    with open(run / "metrics.jsonl", "w") as f:
        for phase, n in (("unc", 2), ("cond", 3)):
            for e in range(n):
                f.write(json.dumps({"phase": phase, "epoch": e,
                                    "train_loss": 0.1}) + "\n")
    (run / "final_metrics.json").write_text(json.dumps({
        "train": {"sharpe": -1.0}, "valid": {"sharpe": 0.36},
        "test": {"sharpe": 0.08}, "wall_clock_s": 12.5,
        "compile_seconds": {}, "phase_execute_seconds": {},
        "device_memory": {"totals": {"bytes_in_use": 1 << 20}},
    }))
    ev.close()


def _resumed_phase(run):
    ev = EventLog(run, process_index=0)
    with ev.span("phase/phase1_unconditional", epochs=256, start_epoch=200):
        time.sleep(0.01)
    ev.close()
    with open(run / "metrics.jsonl", "w") as f:
        for e in range(256):
            f.write(json.dumps({"phase": "unc", "epoch": e,
                                "run_id": ev.run_id}) + "\n")


def _compile_window(run):
    rows = []
    for i, name in enumerate(("compile/a", "compile/b", "compile/c")):
        rows.append({"kind": "span_begin", "name": name, "run_id": "r",
                     "process_index": 0, "seq": i + 1, "ts": 0.0,
                     "mono": 100.0 + i})
    for i, name in enumerate(("compile/a", "compile/b", "compile/c")):
        rows.append({"kind": "span_end", "name": name, "run_id": "r",
                     "process_index": 0, "seq": i + 4, "ts": 0.0,
                     "mono": 108.0 + i, "duration_s": 8.0})
    _write_rows(run / "events.jsonl", rows)


def _null_sharpe(run):
    run.mkdir(parents=True)
    (run / "final_metrics.json").write_text(json.dumps({
        "test": {"sharpe": None}, "valid": {"sharpe": 0.3}}))


def _dispatch_counters(run):
    ev = EventLog(run, process_index=0)
    with ev.span("phase/phase1_unconditional", epochs=256, start_epoch=0):
        ev.counter("epochs_dispatched", value=10,
                   phase="phase1_unconditional", epochs_done=10)
        time.sleep(0.01)
    ev.close()


def _latest_run_scoping(run):
    ev_old = EventLog(run, run_id="run-old", process_index=0)
    with ev_old.span("phase/phase1_unconditional", epochs=8):
        pass
    ev_old.close()
    ev_new = EventLog(run, run_id="run-new", process_index=0)
    with ev_new.span("phase/phase1_unconditional", epochs=2):
        time.sleep(0.01)
    write_manifest(run, "train", events=ev_new)
    ev_new.close()
    EventLog(run, run_id="run-worker", process_index=1).log("worker alive")
    with open(run / "metrics.jsonl", "w") as f:
        for rid, n in (("run-old", 8), ("run-new", 2)):
            for e in range(n):
                f.write(json.dumps({"phase": "unc", "epoch": e,
                                    "run_id": rid}) + "\n")


def _empty(run):
    run.mkdir(parents=True)


def _trace_family(run):
    log = EventLog(run)
    with log.span("phase/one"):
        log.counter("epochs_dispatched", value=4, phase="p1")
    log.gauge("startup/peak_rss", 100)
    log.close()
    _write_rows(run / "events.proc1.jsonl", [
        _row("span_begin", "worker/load", 1000.0, 5.0, run_id="w"),
        _row("span_end", "worker/load", 1001.0, 6.0, run_id="w",
             duration_s=1.0)])
    _write_rows(run / "events.supervisor.jsonl", [
        _row("counter", "supervise/restart", 1000.5, 0.5, run_id="s",
             section="phase1", value=1)])
    _write_rows(run / "replica0" / "events.jsonl", [
        _row("span_end", "serve/request", 1002.0, 9.0, run_id="q",
             duration_s=0.25, endpoint="/v1/weights")])


def _clock_alignment(run):
    _write_rows(run / "events.jsonl", [
        _row("span_end", "a/first", ts=100.0, mono=5000.0, duration_s=1.0)])
    _write_rows(run / "events.proc1.jsonl", [
        _row("span_end", "b/second", ts=103.0, mono=7.0, run_id="p1",
             duration_s=1.0)])


def _dangling_span(run):
    _write_rows(run / "events.jsonl", [
        _row("span_begin", "phase/killed", 10.0, 1.0),
        _row("counter", "epochs_dispatched", 12.0, 3.0, value=2),
        _row("span_begin", "phase/ok", 10.0, 1.0),
        _row("span_end", "phase/ok", 11.0, 2.0, duration_s=1.0)])


def _thread_lanes(run):
    _write_rows(run / "events.jsonl", [
        _row("span_end", "compile/a", 10.0, 1.0, tid=1, duration_s=0.5),
        _row("span_end", "compile/b", 10.1, 1.1, tid=2, duration_s=0.5)])


def _fault_rows_without_mono(run):
    _write_rows(run / "events.jsonl", [
        _row("span_end", "phase/x", 100.0, 50.0, duration_s=1.0)])
    (run / "events.faults.jsonl").write_text(json.dumps(
        {"kind": "counter", "name": "fault/injected", "value": 1,
         "site": "trainer/epoch_loop", "action": "kill",
         "ts": 100.5}) + "\n")


def _startup(run):
    ev = EventLog(run)
    for split in ("train", "valid", "test"):
        with ev.span(f"startup/load/{split}"):
            time.sleep(0.002)
        ev.counter("panel_cache", value=1, split=split,
                   hit=split != "test", chunked=True)
        ev.counter("startup/shard_owned", value=2, split=split)
        ev.counter("startup/shard_loaded", value=1, split=split)
    ev.counter("startup/shard_redecode", value=1, split="test")
    for _ in range(3):
        with ev.span("startup/shard_transfer"):
            time.sleep(0.001)
    with ev.span("startup/compile"):
        time.sleep(0.002)
    ev.gauge("startup/peak_rss", 3 << 30)
    ev.gauge("startup/peak_rss", 2 << 30)
    ev.close()


def _serving(run):
    rows, t = [], 1000.0
    for i in range(12):
        t += 0.1
        pri = "interactive" if i % 3 else "bulk"
        rows.append(_row("span_end", "serve/request", t, t - 900,
                         duration_s=0.001 * (i + 1), priority=pri))
        rows.append(_row("request", "serve/request", t, t - 900,
                         duration_s=0.002 * (i + 1), trace_id=f"{i:032x}",
                         endpoint="/v1/weights", status=200, flush=i // 4,
                         occupancy=4, replica=i % 2, wire="b64",
                         parse_s=0.0001 * i, queue_s=0.0002, batch_s=0.0003,
                         dispatch_share_s=0.0004, serialize_s=0.0001,
                         write_s=0.00005, priority=pri))
        rows.append(_row("counter", "serve/requests", t, t - 900, value=1,
                         endpoint="/v1/weights",
                         status=503 if i == 5 else 200, replica=i % 2))
        rows.append(_row("counter", "serve/cache", t, t - 900, value=1,
                         hit=i % 4 == 0))
    for f in range(3):
        rows.append(_row("span_end", "serve/flush_dispatch", t, t - 900,
                         duration_s=0.0005, flush=f))
        rows.append(_row("counter", "serve/flush", t, t - 900, value=1,
                         occupancy=4 if f else 1, queue_depth=f + 2))
        rows.append(_row("span_end", "serve/dispatch", t, t - 900,
                         duration_s=0.0004))
    rows += [
        _row("counter", "serve/shed", t, t - 900, value=2, reason="bulk_shed",
             priority="bulk"),
        _row("counter", "serve/shed", t, t - 900, value=1,
             reason="deadline_expired", priority="interactive"),
        _row("counter", "serve/coalesce", t, t - 900, value=3, hit=True),
        _row("counter", "serve/coalesce", t, t - 900, value=1, hit=False),
        _row("counter", "fleet/scale", t, t - 900, value=1, action="up",
             replica=1, replicas=2, reason="shed_rate", queue_depth=9,
             shed_rate=0.2),
        _row("counter", "fleet/scale", t, t - 900, value=1, action="down",
             replica=1, replicas=1, reason="idle"),
        _row("counter", "fleet/scale", t, t - 900, value=1,
             action="up_failed", replica=2, replicas=1),
        _row("gauge", "fleet/replicas", t, t - 900, value=1),
        _row("counter", "serve/drain", t, t - 900, value=1),
        _row("counter", "serve/flightrecorder", t, t - 900, value=1,
             reason="slow"),
        _row("counter", "serve/recompile", t, t - 900, value=0),
        _row("counter", "serve/macro_append", t, t - 900, value=2),
        _row("counter", "serve/reload", t, t - 900, value=1, swapped=True),
    ]
    _write_rows(run / "events.jsonl", rows)
    (run / "metrics.prom").write_text(
        "# TYPE dlap_serve_requests_total counter\n"
        'dlap_serve_requests_total{endpoint="/v1/weights",status="200"} 11\n'
        'dlap_serve_requests_total{endpoint="/v1/weights",status="503"} 1\n'
        "# TYPE dlap_serve_recompile_total counter\n"
        "dlap_serve_recompile_total 0\n"
        "# TYPE dlap_serve_steady_state_recompiles gauge\n"
        "dlap_serve_steady_state_recompiles 0\n")


def _reliability(run):
    t = 500.0
    _write_rows(run / "events.supervisor.jsonl", [
        _row("counter", "supervise/death", t, 1.0, value=1,
             section="phase1_unconditional", hang=True, rc=-9),
        _row("counter", "supervise/restart", t + 1, 2.0, value=1),
        _row("counter", "supervise/death", t + 2, 3.0, value=1,
             section="phase2_moment", rc=-9),
        _row("counter", "supervise/restart", t + 3, 4.0, value=1),
        _row("counter", "supervise/outcome", t + 9, 10.0, outcome="success",
             restarts=2, returncode=0)])
    _write_rows(run / "events.jsonl", [
        _row("counter", "guard/trip", t + 4, 1.0, value=1, phase=1),
        _row("counter", "checkpoint/fallback", t + 5, 2.0, value=1),
        _row("counter", "checkpoint/unusable", t + 6, 3.0, value=1)])
    (run / "events.faults.jsonl").write_text("".join(
        json.dumps({"kind": "counter", "name": "fault/injected", "value": 1,
                    "site": site, "action": "kill", "ts": t + i}) + "\n"
        for i, site in enumerate(("trainer/epoch_loop",
                                  "trainer/phase_boundary"))))


def _elastic(run):
    ev = EventLog(run)
    for w, n in (("w0", 3), ("w1", 2)):
        for i in range(n):
            ev.counter("sweep/claim", worker=w, bucket=i + 1)
    ev.counter("sweep/ledger_write", worker="w0", bucket=1)
    ev.counter("sweep/ledger_write", worker="w1", bucket=2)
    ev.counter("sweep/ledger_write", bucket=3)
    ev.counter("sweep/ledger_hit", value=2)
    ev.counter("sweep/retry", bucket=2, attempt=2)
    ev.counter("sweep/lease_takeover", bucket=2, from_worker="w1",
               worker="w0")
    ev.counter("sweep/quarantine", bucket=4, attempts=3)
    ev.counter("sweep/quorum_drop", rank=0, seed=123)
    ev.close()
    ledger = SweepLedger(run / "sweep_ledger")
    queue = WorkQueue(run / "sweep_ledger", ledger=ledger)
    items = [{"key": f"k{i}", "index": i} for i in range(4)]
    queue.write_manifest(items, {"kind": "sweep_queue"})
    for i in range(2):
        ledger.write(f"k{i}", {"key": f"k{i}", "index": i})
    ledger.quarantine("k3", {"index": 3, "attempts": 3, "history": []})


def _promotion(run):
    ev = EventLog(run)
    ev.counter("promote/advance", generation=1, source="month0024")
    ev.counter("promote/advance", generation=2, source="month0036")
    ev.counter("promote/reject", reason="sharpe_regression",
               source="month0048")
    ev.counter("promote/reject", reason="digest_mismatch", source="bad")
    ev.counter("promote/rollback", generation=3)
    ev.counter("promote/fleet_rollback")
    ev.counter("promote/fleet_converged")
    ev.counter("serve/reload", swapped=False)
    for replica, rows in (("replica0", [(1, "aa" * 8, True), (2, "bb" * 8,
                                                              False)]),
                          ("replica1", [(2, "bb" * 8, False)])):
        for gen, fp, boot in rows:
            ev.counter("serve/generation", replica=replica, generation=gen,
                       fingerprint=fp, pointer_generation=gen, boot=boot)
    ev.close()
    write_pointer(run, {"checkpoint_dirs": ["a"], "source": "month0024",
                        "params_fingerprint": "aa" * 32,
                        "valid_sharpe": 0.25})
    write_pointer(run, {"checkpoint_dirs": ["b"], "source": "month0036",
                        "params_fingerprint": "bb" * 32,
                        "valid_sharpe": 0.31})


def _model_health(run):
    ev = EventLog(run)
    ev.gauge("model/drift_psi", 0.12)
    ev.gauge("model/drift_psi", 0.31)
    ev.counter("model/drift_alert")
    ev.counter("serve/canary", max_weight_delta=1.5e-7, replayed=4)
    ev.counter("serve/canary", max_weight_delta=3.0e-7, replayed=4)
    ev.close()
    write_health(run, {
        "finite": True, "split": "valid", "guard_trips": 1,
        "diagnostics": {
            "moment_violation_max": 0.0123,
            "moment_violations": [0.01, 0.0123, None],
            "unc_violation": 0.004, "adv_gap": 1.5e-3,
            "sdf_mean": 0.99, "sdf_vol": 0.1, "sdf_min": 0.5,
            "sdf_finite_frac": 1.0, "weight_hhi": 0.02,
            "weight_max_abs": 0.1, "short_fraction": 0.45,
            "turnover": 0.3}})
    write_profile(run, {"kind": "reference_profile", "schema": 1,
                        "source": "x", "individual": [], "macro": []})


Plan = namedtuple("Plan", "route tile threads smem_bytes blocks_per_sm")


def _kernel_programs(run):
    """Kernel plans in the manifest and as ``program`` rows (the JAX
    report files the rows under ``xla_programs``)."""
    ev = EventLog(run)
    plans = {}
    for name, T in (("sdf_ffn_fwd/train", 48), ("cond_em_fwd/valid", 12)):
        programs.record_program(
            ev, name, Plan(1, 128, 256, 16384, 3),
            {"blocks_per_sm": 3, "registers": 96, "local_bytes": 0}, plans,
            S=1, T=T, N=10000, compute_dtype="float32")
    write_manifest(run, "train", events=ev)
    update_manifest(run, kernel_programs=plans)
    ev.close()


def _train_cli(run):
    """A port train-CLI run dir (the CPU, f32)."""
    data = run.parent / "data"
    _synthetic_data(data)
    train.main(["--data_dir", str(data), "--save_dir", str(run),
                "--epochs_unc", "2", "--epochs_moment", "1", "--epochs",
                "3", "--ignore_epoch", "0", "--hidden_dim", "8",
                "--num_moments", "4", "--device", "cpu", "--compute_dtype",
                "float32", "--print_freq", "100"])


def _refit_run(run):
    """A port refit dir: two months, one seed, through the gate."""
    data = run.parent / "data"
    _synthetic_data(data)
    refit.main(["--data_dir", str(data), "--run_dir", str(run),
                "--months", "3", "4", "--seeds", "1", "--epochs_unc", "2",
                "--epochs_moment", "1", "--epochs", "3", "--ignore_epoch",
                "0", "--hidden_dim", "8", "--rnn_dim", "4", "--num_moments",
                "4", "--dropout", "0.0", "--device", "cpu",
                "--compute_dtype", "float32"])


def _synthetic_data(out):
    from deeplearninginassetpricing_paperreplication_torch.data.synthetic import (
        generate_all_splits,
    )

    generate_all_splits(out, n_periods_train=12, n_periods_valid=4,
                        n_periods_test=6, n_stocks=32, n_features=6,
                        n_macro=4, seed=3, verbose=False)


SCENARIOS = {
    "synthetic_train": _synthetic_train,
    "resumed_phase": _resumed_phase,
    "compile_window": _compile_window,
    "null_sharpe": _null_sharpe,
    "dispatch_counters": _dispatch_counters,
    "latest_run_scoping": _latest_run_scoping,
    "empty": _empty,
    "trace_family": _trace_family,
    "clock_alignment": _clock_alignment,
    "dangling_span": _dangling_span,
    "thread_lanes": _thread_lanes,
    "fault_rows_without_mono": _fault_rows_without_mono,
    "startup": _startup,
    "serving": _serving,
    "reliability": _reliability,
    "elastic": _elastic,
    "promotion": _promotion,
    "model_health": _model_health,
    "kernel_programs": _kernel_programs,
    "train_cli": _train_cli,
    "refit_run": _refit_run,
}


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("report_runs")
    out = {}
    for name, build in SCENARIOS.items():
        run = root / name / "run"
        build(run)
        out[name] = run
    return out


def _summaries(run):
    ours = report.summarize_run(report.load_run(run))
    theirs = jreport.summarize_run(jreport.load_run(run))
    return ours, theirs


def _without_block(text, header):
    """`text` without the section starting at the line `header` begins
    (up to the next line at its indent)."""
    out, skipping = [], False
    for line in text.splitlines():
        if line.startswith(header):
            skipping = True
            continue
        if skipping and line.startswith("    "):
            continue
        skipping = False
        out.append(line)
    return "\n".join(out)


# -- the comparisons -----------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_summary_equals_the_jax_package(run_dirs, name):
    ours, theirs = _summaries(run_dirs[name])
    ours.pop(PLANS_KEYS[0], None)
    theirs.pop(PLANS_KEYS[1], None)
    assert ours == theirs


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_text_report_equals_the_jax_package(run_dirs, name):
    ours, theirs = _summaries(run_dirs[name])
    a = _without_block(report.format_summary(ours), PLANS_HEADERS[0])
    b = _without_block(jreport.format_summary(theirs), PLANS_HEADERS[1])
    assert a == b


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trace_equals_the_jax_package(run_dirs, name):
    run = run_dirs[name]
    try:
        theirs = jtrace.assemble_trace(run)
    except FileNotFoundError as e:
        with pytest.raises(FileNotFoundError) as ours:
            trace.assemble_trace(run)
        assert str(ours.value) == str(e)
        return
    assert trace.assemble_trace(run) == theirs


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_budgets_equal_the_jax_package(run_dirs, name, tmp_path):
    (tmp_path / "BENCH_X.json").write_text(json.dumps(
        {"rps": 120.0, "trials": [{"p99_ms": 8.5}]}))
    spec = tmp_path / "budgets.json"
    spec.write_text(json.dumps({"schema": 1, "budgets": [
        {"name": "rps", "file": "BENCH_X.json", "metric": "rps",
         "min": 100, "tolerance": 0.1},
        {"name": "p99", "file": "BENCH_X.json", "metric": "trials.0.p99_ms",
         "max": 8.0, "tolerance": 0.05},
        {"name": "events", "metric": "n_events", "min": 1},
        {"name": "p1_epochs", "metric": "phases.phase1_unconditional.epochs",
         "min": 2},
        {"name": "buckets", "metric": "elastic.buckets_completed",
         "equals": 3},
        {"name": "restarts", "metric": "reliability.restarts", "max": 1},
        {"name": "promotions", "metric": "promotion.promotions", "min": 1},
    ]}))
    ours, theirs = _summaries(run_dirs[name])
    ours.pop(PLANS_KEYS[0], None)
    theirs.pop(PLANS_KEYS[1], None)
    key = str(run_dirs[name])
    got = budgets.check_budgets(spec, {key: ours})
    assert got == jbudgets.check_budgets(spec, {key: theirs})
    assert budgets.format_budget_report(got) == \
        jbudgets.format_budget_report(got)


def test_kernel_plans_section(run_dirs):
    """The port's stated difference: the kernel plans of the manifest,
    and, without them, of the ``program`` rows."""
    run = run_dirs["kernel_programs"]
    ours, theirs = _summaries(run)
    manifest = json.loads((run / "manifest.json").read_text())
    assert ours["kernel_programs"] == manifest["kernel_programs"]
    assert set(theirs["xla_programs"]) == set(ours["kernel_programs"])
    text = report.format_summary(ours)
    assert "kernel launch plans (as the card holds them):" in text
    assert "AOT programs" not in text
    line = next(x for x in text.splitlines() if "sdf_ffn_fwd/train" in x)
    assert line.split()[1:] == ["1", "48", "10000", "float32", "3", "96",
                                "0"]
    rows = report.load_run(run)["events_all"]
    assert report.programs_from_events(rows) == manifest["kernel_programs"]
    for name in ("train_cli", "refit_run", "synthetic_train"):
        assert "kernel_programs" not in _summaries(run_dirs[name])[0]


def test_slo_rows_give_no_section_yet(tmp_path):
    """A run dir with alert and probe rows summarizes as the JAX
    package's, the ``slo`` section included (both read the rows through
    their status board's ``scan_slo_rows``)."""
    run = tmp_path / "run"
    _write_rows(run / "events.jsonl", [
        _row("alert", "alert/firing", 100.0, 1.0, objective="availability",
             window="5m", severity="page", burn_long=20.0, burn_short=30.0),
        _row("probe", "probe/failure", 101.0, 2.0, target="t0",
             error="timeout"),
        _row("span_end", "phase/x", 102.0, 3.0, duration_s=1.0)])
    ours, theirs = _summaries(run)
    assert ours["slo"]["alerts"]["firing_now"] == ["availability [5m]"]
    assert ours["slo"]["probe"]["failures"] == 1
    assert ours == theirs


@pytest.mark.parametrize("name", ["refit_run", "train_cli", "elastic"])
def test_report_cli_json_equals_the_jax_package(run_dirs, name, capsys):
    run = str(run_dirs[name])
    assert report.main([run, "--json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jreport.main([run, "--json"]) == 0
    theirs = json.loads(capsys.readouterr().out)
    ours.pop(PLANS_KEYS[0], None)
    theirs.pop(PLANS_KEYS[1], None)
    assert ours == theirs


def test_refit_run_dir_reads_through_the_report(run_dirs):
    summary = report.summarize_run(report.load_run(run_dirs["refit_run"]))
    assert summary["kind"] == "refit"
    assert summary["elastic"]["buckets_completed"] == 2
    assert summary["elastic"]["ledger"] == {
        "total_buckets": 2, "records": 2, "quarantined": 0}
    pm = summary["promotion"]
    assert pm["promotions"] + sum(pm["rejections_by_reason"].values()) == 2
    assert pm["pointer"]["source"] in ("month0003", "month0004")


def _budget_file(tmp_path, name, entries):
    path = tmp_path / name
    path.write_text(json.dumps({"schema": 1, "budgets": entries}))
    return str(path)


@pytest.mark.parametrize("case,want", [
    ("plain", 0),
    ("missing_parity", 1),
    ("run_budget_pass", 0),
    ("run_budget_regression", 1),
    ("file_budget_regression", 1),
    ("malformed_budget", 2),
    ("no_run_dir", 2),
    ("trace_without_run_dir", 2),
    ("trace_of_nothing", 2),
    ("bench_trend", 0),
    ("bench_trend_without_its_tool", 2),
])
def test_report_cli_exit_codes_equal_the_jax_package(run_dirs, tmp_path,
                                                      capsys, case, want):
    refit_dir = str(run_dirs["refit_run"])
    empty = str(run_dirs["empty"])
    (tmp_path / "BENCH_X.json").write_text(json.dumps({"rps": 10.0}))
    argv = {
        "plain": [refit_dir],
        "missing_parity": [refit_dir, "--parity",
                           str(tmp_path / "PARITY_NONE.json")],
        "run_budget_pass": [refit_dir, "--budget", _budget_file(
            tmp_path, "pass.json", [
                {"name": "b", "metric": "elastic.buckets_completed",
                 "equals": 2}])],
        "run_budget_regression": [refit_dir, "--budget", _budget_file(
            tmp_path, "regress.json", [
                {"name": "b", "metric": "elastic.buckets_completed",
                 "equals": 4}])],
        "file_budget_regression": ["--budget", _budget_file(
            tmp_path, "file.json", [
                {"name": "rps", "file": "BENCH_X.json", "metric": "rps",
                 "min": 1e9}])],
        "malformed_budget": ["--budget", _budget_file(
            tmp_path, "bad.json", [{"name": "x", "metric": "m"}])],
        "no_run_dir": [],
        "trace_without_run_dir": ["--budget", _budget_file(
            tmp_path, "pass2.json", [
                {"name": "rps", "file": "BENCH_X.json", "metric": "rps",
                 "min": 1}]), "--trace", str(tmp_path / "t.json")],
        "trace_of_nothing": [empty, "--trace", str(tmp_path / "t.json")],
        "bench_trend": ["--bench-trend", str(REPO / "benches"
                                             / "history.jsonl")],
        "bench_trend_without_its_tool": [
            "--bench-trend", str(tmp_path / "benches" / "history.jsonl")],
    }[case]
    assert report.main(argv) == want
    ours = capsys.readouterr()
    assert jreport.main(argv) == want
    theirs = capsys.readouterr()
    assert ours.out == theirs.out and ours.err == theirs.err
    if case == "run_budget_regression":
        assert "REGRESSION" in ours.out


def test_report_trace_writes_one_lane_per_event_file(run_dirs, tmp_path,
                                                     capsys):
    """``report --trace`` over a fleet-shaped dir: byte-identical across
    two invocations and to the JAX package's, one lane per event file."""
    run = run_dirs["trace_family"]
    outs = []
    for i, fn in enumerate((report.main, report.main, jreport.main)):
        out = tmp_path / f"t{i}.json"
        assert fn([str(run), "--trace", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == outs[2]
    assert "trace written to" in capsys.readouterr().out
    names = {e["args"]["name"] for e in json.loads(outs[0])["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"events.jsonl", "events.proc1.jsonl",
                     "events.supervisor.jsonl", "replica0/events.jsonl"}


def test_report_shim_is_the_observability_cli():
    from deeplearninginassetpricing_paperreplication_torch import (
        report as shim,
    )

    assert shim.main is report.main
    assert shim.build_arg_parser is report.build_arg_parser
    assert Path(report.build_arg_parser().prog).name.endswith(
        "paperreplication_torch.report")
