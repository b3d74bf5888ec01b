"""The port's SLO plane against the JAX package's, on the CPU: the spec
validator names the same field for the same bad documents, both packages
read each other's verified ``slo.json`` (the repo root's included), the
burn-rate engines make the same fire and resolve transitions on the same
scripted series and clock, and the status board, the timeline and the
report's SLO section print the same output on a shared run dir. Then the
port's own ops console: ``python -m ….ops status|timeline``.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from deeplearninginassetpricing_paperreplication_torch.observability import (
    report as p_report,
)
from deeplearninginassetpricing_paperreplication_torch.observability import (
    slo as p_slo,
)
from deeplearninginassetpricing_paperreplication_torch.observability import (
    statusboard as p_board,
)
from deeplearninginassetpricing_paperreplication_torch.observability.events import (  # noqa: E501
    EventLog,
)
from deeplearninginassetpricing_paperreplication_torch.observability.metrics import (  # noqa: E501
    parse_prom_text,
)
from deeplearninginassetpricing_paperreplication_torch.serving.fleet import (
    write_fleet_json,
)
from deeplearninginassetpricing_paperreplication_torch.serving.flight import (
    FlightRecorder,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    report as j_report,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    slo as j_slo,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    statusboard as j_board,
)

REPO = Path(__file__).resolve().parents[1]
PKG = "deeplearninginassetpricing_paperreplication_torch"


def _bad_docs():
    ratio = {"name": "a", "kind": "ratio", "source": "s", "target": 0.9,
             "windows": [{"long_s": 10, "short_s": 1, "burn_rate": 2}]}
    value = {"name": "a", "kind": "value", "source": "s", "max": 1,
             "sustain_s": 5}
    return [
        ("not_a_dict", []),
        ("schema", {"schema": 2, "objectives": []}),
        ("objectives", {"schema": 1, "objectives": []}),
        ("objective_not_dict", {"schema": 1, "objectives": [3]}),
        ("name", {"schema": 1, "objectives": [dict(ratio, name="")]}),
        ("kind", {"schema": 1, "objectives": [dict(ratio, kind="nope")]}),
        ("source", {"schema": 1, "objectives": [dict(ratio, source="")]}),
        ("target", {"schema": 1, "objectives": [dict(ratio, target=1.2)]}),
        ("windows", {"schema": 1, "objectives": [dict(ratio, windows=[])]}),
        ("short_s", {"schema": 1, "objectives": [dict(ratio, windows=[
            {"long_s": 1, "short_s": 10, "burn_rate": 2}])]}),
        ("burn_rate", {"schema": 1, "objectives": [dict(ratio, windows=[
            {"long_s": 10, "short_s": 1, "burn_rate": -1}])]}),
        ("severity", {"schema": 1, "objectives": [dict(ratio, windows=[
            {"long_s": 10, "short_s": 1, "burn_rate": 2,
             "severity": "sms"}])]}),
        ("max", {"schema": 1, "objectives": [dict(value, max=-1)]}),
        ("sustain_s", {"schema": 1, "objectives": [dict(value,
                                                        sustain_s=0)]}),
        ("duplicate", {"schema": 1, "objectives": [value, value]}),
    ]


@pytest.mark.parametrize("doc", [d for _, d in _bad_docs()],
                         ids=[n for n, _ in _bad_docs()])
def test_validate_slo_names_the_same_field(doc):
    """Each bad document fails in both validators with the same message
    (the field it names included)."""
    msgs = []
    for mod in (p_slo, j_slo):
        with pytest.raises(mod.SLOSpecError) as ei:
            mod.validate_slo(json.loads(json.dumps(doc)))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_specs_and_sources_equal_the_jax_package():
    assert p_slo.default_slo() == j_slo.default_slo()
    assert p_slo.drill_spec(5, 1, 3.0) == j_slo.drill_spec(5, 1, 3.0)
    assert p_slo.KNOWN_SOURCES == j_slo.KNOWN_SOURCES
    assert p_slo.SCHEMA_VERSION == j_slo.SCHEMA_VERSION


def test_verified_slo_files_interchange_and_tamper(tmp_path):
    """Each package writes an ``slo.json`` + ``.sha256`` the other loads;
    a tampered byte fails both sidecar checks."""
    for name, writer, reader in (("p", p_slo, j_slo), ("j", j_slo, p_slo)):
        (tmp_path / name).mkdir()
        path = writer.write_slo(tmp_path / name / "slo.json",
                                writer.drill_spec())
        assert reader.load_slo(path) == writer.drill_spec()
        path.write_text(path.read_text() + " ")
        for mod in (p_slo, j_slo):
            with pytest.raises(mod.SLOSpecError, match="sha256"):
                mod.load_slo(path)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 1, "objectives": [{}]}))
    with pytest.raises(p_slo.SLOSpecError):
        p_slo.load_slo(bad)


def test_shipped_slo_json_verifies_under_the_port():
    doc = p_slo.load_slo(REPO / "slo.json")
    assert doc == j_slo.load_slo(REPO / "slo.json")
    for obj in doc["objectives"]:
        assert obj["source"] in p_slo.KNOWN_SOURCES, obj


def _fake_clock():
    now = [0.0]
    return (lambda: now[0]), now


def _script_ratio(mod, tmp_path):
    """Drive one engine through healthy → 50% outage → recovery on a fake
    clock; returns its transitions without wall timestamps, the alert
    file's states and the engine's final state."""
    clock, now = _fake_clock()
    counts = {"bad": 0, "total": 0}
    events = mod_events(mod)(tmp_path, filename="events.slo.jsonl",
                             process_index=0)
    sink = mod.FileAlertSink(tmp_path / "alerts.jsonl")
    eng = mod.SLOEngine(mod.drill_spec(long_s=8, short_s=2, burn_rate=6.0),
                        {"probe": lambda: (counts["bad"], counts["total"])},
                        events=events, sinks=(sink,), clock=clock)
    transitions = []
    for step in range(200):
        now[0] += 0.25
        counts["total"] += 4
        if 40 <= step < 80:
            counts["bad"] += 2
        for t in eng.tick():
            transitions.append((step, {k: v for k, v in t.items()
                                       if k not in ("ts",)}))
    events.close()
    states = [json.loads(x)["state"] for x in
              (tmp_path / "alerts.jsonl").read_text().splitlines()]
    prom = parse_prom_text(events.metrics.render_prom())
    return transitions, states, eng.firing(), prom


def mod_events(mod):
    if mod is p_slo:
        return EventLog
    from deeplearninginassetpricing_paperreplication_tpu.observability.events import (  # noqa: E501
        EventLog as JEventLog,
    )

    return JEventLog


def test_engine_fires_and_resolves_like_the_jax_engine(tmp_path):
    """The same scripted series on the same clock: the same transitions at
    the same ticks (burn rates, budgets, durations), the same sink
    states, and the dlap_alert_* gauges in both metrics twins."""
    ours = _script_ratio(p_slo, tmp_path / "p")
    theirs = _script_ratio(j_slo, tmp_path / "j")
    assert ours[0] == theirs[0]
    assert [t["state"] for _, t in ours[0]] == ["firing", "resolved"]
    assert ours[1] == theirs[1] == ["firing", "resolved"]
    assert ours[2] == theirs[2] == []
    for name in ("dlap_alert_firing", "dlap_alert_burn_rate",
                 "dlap_alert_budget_remaining", "dlap_alert_firing_total"):
        assert name in ours[3] and ours[3][name] == theirs[3][name], name


def test_value_objective_and_no_data_like_the_jax_engine():
    spec = {"schema": 1, "objectives": [
        {"name": "p99", "kind": "value", "source": "latency_p99_ms",
         "max": 100.0, "sustain_s": 2.0, "severity": "ticket"}]}
    runs = []
    for mod in (p_slo, j_slo):
        clock, now = _fake_clock()
        series = ([50.0] * 10 + [250.0] * 20 + [None] * 5 + [40.0] * 20)
        it = iter(series)
        eng = mod.SLOEngine(spec, {"latency_p99_ms": lambda: next(it)},
                            clock=clock)
        out = []
        for step in range(len(series)):
            now[0] += 0.25
            out += [(step, {k: v for k, v in t.items() if k != "ts"})
                    for t in eng.tick()]
        runs.append(out)
        # no data: neither fires nor resolves; a raising source counts
        quiet = mod.SLOEngine(mod.drill_spec(), {"probe": lambda: None},
                              clock=clock)
        assert all(quiet.tick() == [] for _ in range(50))

        def boom():
            raise RuntimeError("scrape died")

        broken = mod.SLOEngine(mod.drill_spec(), {"probe": boom},
                               clock=clock)
        broken.tick()
        assert broken.source_errors >= 1
    assert runs[0] == runs[1]
    assert [t["state"] for _, t in runs[0]] == ["firing", "resolved"]


def test_engine_refuses_unwired_sources_like_the_jax_engine():
    for spec, sources, needle in (
            (p_slo.drill_spec(), {}, "probe"),
            (p_slo.default_slo(), {"probe": lambda: (0, 0)}, "requests")):
        msgs = []
        for mod in (p_slo, j_slo):
            with pytest.raises(mod.SLOSpecError, match=needle) as ei:
                mod.SLOEngine(spec, sources)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_alert_transitions_ride_the_flight_recorder(tmp_path):
    clock, now = _fake_clock()
    counts = {"bad": 0, "total": 0}
    fr = FlightRecorder(run_dir=tmp_path)
    eng = p_slo.SLOEngine(p_slo.drill_spec(long_s=4, short_s=1),
                          {"probe": lambda: (counts["bad"],
                                             counts["total"])},
                          flight=fr, clock=clock)
    for _ in range(40):
        now[0] += 0.25
        counts["total"] += 4
        counts["bad"] += 4
        eng.tick()
    snap = json.loads(fr.dump("admin").read_text())
    assert [a["state"] for a in snap["alerts"]] == ["firing"]
    assert snap["alerts"][0]["objective"] == "availability"


def _canned_ops_dir(root: Path, events_cls, write_layout) -> Path:
    """A fleet run dir with a pointer-free layout, a replica's generation
    row, probe checks and a failure, a firing alert with its gauges, a
    scale event and a canary verdict — written by one package's
    EventLog."""
    run_dir = root / "fleet_run"
    run_dir.mkdir(parents=True)
    write_layout(run_dir, {
        "host": "127.0.0.1", "port": 8787, "replicas": 2,
        "replica_ids": [0, 1], "admin_ports": {"0": 9001, "1": 9002},
        "admin_urls": ["http://127.0.0.1:9001", "http://127.0.0.1:9002"],
        "pointer": None, "total_replicas_ever": 2})
    (run_dir / "replica0").mkdir()
    rev = events_cls(run_dir / "replica0", process_index=0,
                     run_id="replica0-run")
    rev.counter("serve/generation", replica="replica0", generation=2,
                fingerprint="feedbeef" * 2)
    rev.close()
    ev = events_cls(run_dir, filename="events.probe.jsonl",
                    process_index=0, run_id="probe-run")
    ev.counter("probe/check", target="public", outcome="ok")
    ev.counter("probe/check", target="replica0_healthz", outcome="ok")
    ev.emit("probe", "probe/failure", target="replica1_healthz",
            error="URLError", latency_ms=2.0, consecutive=1)
    ev.emit("alert", "alert/firing", objective="availability",
            window="8s/2s", severity="page", burn_long=50.0,
            burn_short=50.0)
    ev.gauge("alert/burn_rate", 50.0, objective="availability",
             window="8s/2s")
    ev.gauge("alert/budget_remaining", 0.0, objective="availability",
             window="8s/2s")
    ev.counter("fleet/scale", direction="up", reason="queue_depth")
    ev.counter("serve/canary", replica="replica0",
               max_weight_delta=0.0, max_sdf_delta=0.0, finite=True)
    ev.close()
    return run_dir


@pytest.fixture(scope="module")
def ops_dir(tmp_path_factory):
    return _canned_ops_dir(tmp_path_factory.mktemp("ops"), EventLog,
                           write_fleet_json)


def test_status_board_equals_the_jax_board(ops_dir, capsys):
    """gather_status, format_status, scan_slo_rows and the timeline give
    the same output in both packages on one run dir, and both CLIs print
    the same bytes for status and timeline, text and --json."""
    from deeplearninginassetpricing_paperreplication_tpu.observability.trace import (  # noqa: E501
        read_jsonl as j_read_jsonl,
    )
    from deeplearninginassetpricing_paperreplication_torch.observability.trace import (  # noqa: E501
        read_jsonl,
    )

    ours = p_board.gather_status(ops_dir)
    assert ours == j_board.gather_status(ops_dir)
    assert ours["slo"]["firing"][0]["objective"] == "availability"
    assert ours["slo"]["probe"] == {"checks": 2, "failures": 1,
                                    **{k: ours["slo"]["probe"][k]
                                       for k in ours["slo"]["probe"]
                                       if k not in ("checks",
                                                    "failures")}}
    assert p_board.format_status(ours) == j_board.format_status(ours)
    assert "ALERT FIRING: availability" in p_board.format_status(ours)
    rows = read_jsonl(ops_dir / "events.probe.jsonl")
    assert rows == j_read_jsonl(ops_dir / "events.probe.jsonl")
    assert p_board.scan_slo_rows(rows) == j_board.scan_slo_rows(rows)
    assert p_board.gather_timeline(ops_dir) == j_board.gather_timeline(
        ops_dir)
    assert p_board.format_timeline(p_board.gather_timeline(ops_dir)) \
        == j_board.format_timeline(j_board.gather_timeline(ops_dir))
    for argv in (["status", str(ops_dir)], ["status", str(ops_dir), "--json"],
                 ["timeline", str(ops_dir)],
                 ["timeline", str(ops_dir), "--json", "--limit", "3"]):
        outs = []
        for board in (p_board, p_board, j_board):
            assert board.main(argv) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] == outs[2], argv


def test_report_slo_section_equals_the_jax_report(ops_dir, tmp_path):
    ours = p_report.summarize_run(p_report.load_run(ops_dir))
    theirs = j_report.summarize_run(j_report.load_run(ops_dir))
    assert ours["slo"] == theirs["slo"]
    assert ours["slo"]["alerts"]["firing_now"] == ["availability [8s/2s]"]
    assert ours["slo"]["probe"]["checks"] == 2
    text = p_report.format_summary(ours)
    assert "ALERT FIRING: availability [8s/2s]" in text
    assert "probes: 2 checks, 1 failures" in text
    # a run dir without the plane keeps the section absent
    old = tmp_path / "old_run"
    old.mkdir()
    ev = EventLog(old, process_index=0)
    ev.counter("epochs_dispatched", value=1, phase="phase1_unconditional")
    ev.close()
    assert "slo" not in p_report.summarize_run(p_report.load_run(old))


def test_ops_console_on_dead_fleet_layouts(tmp_path):
    run_dir = tmp_path / "r"
    run_dir.mkdir()
    text = p_board.format_status(p_board.gather_status(run_dir))
    assert "(no fleet.json)" in text
    assert "(no probe/alert telemetry)" in text
    assert p_board.gather_timeline(run_dir) == []
    (run_dir / "fleet.json").write_text('{"replicas":')
    assert "(no fleet.json)" in p_board.format_status(
        p_board.gather_status(run_dir))
    write_fleet_json(run_dir, {
        "host": "127.0.0.1", "port": 9, "replicas": 1,
        "replica_ids": [0], "admin_ports": {"0": 1},
        "admin_urls": ["http://127.0.0.1:1"], "pointer": None,
        "total_replicas_ever": 3})
    text = p_board.format_status(p_board.gather_status(run_dir))
    assert "1 live" in text and "ever=3" in text
    assert p_board.main(["status", str(tmp_path / "missing")]) == 2


@pytest.mark.parametrize("cmd", ["status", "timeline"])
def test_ops_module_entrypoint(ops_dir, cmd):
    """``python -m …_torch.ops`` reaches the status board; the output is
    the JAX console's byte for byte."""
    r = subprocess.run([sys.executable, "-m", f"{PKG}.ops", cmd,
                        str(ops_dir)], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    board = p_board
    want = (board.format_status(board.gather_status(ops_dir))
            if cmd == "status"
            else board.format_timeline(board.gather_timeline(ops_dir)))
    assert r.stdout == want + "\n"
    if cmd == "status":
        assert "ALERT FIRING: availability" in r.stdout
