"""The port's blackbox prober against the JAX package's, on the CPU: the
same fixture bytes, the same wire constant, the same per-target outcomes
over a torn, missing and dead fleet layout, and a fleet scraper that stays
monotone across dropouts and restarts exactly as the JAX one does. Then
the detection drill on a real CPU fleet: a replica SIGKILLed and, later,
another SIGSTOPped (wedged, still accepting) under the prober and the
burn-rate engine each fire the availability alert, and each alert resolves
after the restart or SIGCONT.
"""

import dataclasses
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from deeplearninginassetpricing_paperreplication_torch.observability import (
    statusboard,
)
from deeplearninginassetpricing_paperreplication_torch.observability.events import (  # noqa: E501
    EventLog,
)
from deeplearninginassetpricing_paperreplication_torch.observability.report import (  # noqa: E501
    load_run,
    summarize_run,
)
from deeplearninginassetpricing_paperreplication_torch.observability.slo import (
    FileAlertSink,
    SLOEngine,
    drill_spec,
)
from deeplearninginassetpricing_paperreplication_torch.serving import (
    probe as p_probe,
)
from deeplearninginassetpricing_paperreplication_torch.serving.fleet import (
    read_fleet_json,
    write_fleet_json,
)
from deeplearninginassetpricing_paperreplication_tpu.observability.events import (  # noqa: E501
    EventLog as JEventLog,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    probe as j_probe,
)


def test_fixture_payload_same_bytes():
    for kw in ({}, {"month": 3}, {"n_stocks": 7, "seed": 5}):
        assert p_probe.fixture_payload(46, **kw) == \
            j_probe.fixture_payload(46, **kw)
    assert p_probe.FIXTURE_STOCKS == j_probe.FIXTURE_STOCKS


def test_probe_wire_constant_matches_the_server():
    """probe.py keeps the raw-f32 content type as a literal so the probe
    CLI never imports the engine; it must equal the server's."""
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        server,
    )

    assert p_probe.BINARY_CONTENT_TYPE == server.BINARY_CONTENT_TYPE \
        == j_probe.BINARY_CONTENT_TYPE


def _stub_http(body=b"ok", status=200, state=None):
    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            self.rfile.read(n)
            self._answer()

        def do_GET(self):
            self._answer()

        def _answer(self):
            b = json.dumps(state).encode() if state is not None else body
            self.send_response(status)
            self.send_header("Content-Length", str(len(b)))
            self.end_headers()
            self.wfile.write(b)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _layout(port, dead_port=1):
    return {"host": "127.0.0.1", "port": port, "replicas": 2,
            "replica_ids": [0, 1],
            "admin_ports": {"0": port, "1": dead_port},
            "admin_urls": [f"http://127.0.0.1:{port}",
                           f"http://127.0.0.1:{dead_port}"],
            "pointer": None, "total_replicas_ever": 2}


def _probe_story(mod, events_cls, run_dir, port):
    """One prober through a live layout, a torn one and a deleted one;
    returns its per-target outcomes, counts and stats."""
    write_fleet_json(run_dir, _layout(port))
    ev = events_cls(run_dir, filename="events.probe.jsonl",
                    process_index=0)
    prober = mod.Prober(ev, fleet_dir=run_dir, timeout_s=0.5)
    story = [[(r["target"], r["ok"]) for r in prober.probe_once()]]
    story.append(prober.counts())
    (run_dir / "fleet.json").write_text('{"replicas": 2, "adm')
    story.append([(r["target"], r["ok"]) for r in prober.probe_once()])
    (run_dir / "fleet.json").unlink()
    story.append([(r["target"], r["ok"]) for r in prober.probe_once()])
    stats = prober.stats()
    story.append({k: stats[k] for k in ("layout_unreadable", "checks",
                                        "failures")})
    ev.close()
    return story


def test_prober_survives_torn_layout_and_dead_fleet(tmp_path):
    """A dead replica is recorded as failures, a torn or deleted layout as
    unreadable while the last-known layout keeps being probed — the same
    outcomes target by target as the JAX prober."""
    srv = _stub_http()
    port = srv.server_address[1]
    try:
        (tmp_path / "p").mkdir()
        (tmp_path / "j").mkdir()
        ours = _probe_story(p_probe, EventLog, tmp_path / "p", port)
        theirs = _probe_story(j_probe, JEventLog, tmp_path / "j", port)
    finally:
        srv.shutdown()
        srv.server_close()
    assert ours == theirs
    by = dict(ours[0])
    assert by["replica0_healthz"] and by["replica0_metrics"]
    assert not by["replica1_healthz"]
    assert ours[1] == (2, 4)
    assert ours[4]["layout_unreadable"] == 2
    rows = [json.loads(x) for x in
            (tmp_path / "p" / "events.probe.jsonl").read_text().splitlines()]
    probe_rows = [r for r in rows if r["kind"] == "probe"]
    assert probe_rows and all(r["name"] == "probe/failure"
                              for r in probe_rows)
    assert any(r.get("consecutive", 0) >= 3 for r in probe_rows)


def test_prober_with_no_layout_at_all(tmp_path):
    ev = EventLog(tmp_path, filename="events.probe.jsonl", process_index=0)
    prober = p_probe.Prober(ev, fleet_dir=tmp_path, timeout_s=0.5)
    assert prober.probe_once() == []
    assert prober.stats()["layout_unreadable"] == 1
    ev.close()
    assert read_fleet_json(tmp_path) is None


def test_fleet_scraper_monotone_like_the_jax_scraper(tmp_path):
    """Dropouts and restarts never dip the summed series: a dead replica
    keeps its last-seen counts, a counter reset folds the previous
    incarnation into a base — sample for sample the JAX scraper's."""
    state = {"requests": {"POST /v1/weights 200": 90,
                          "POST /v1/weights 500": 10}}
    srv = _stub_http(state=state)
    port = srv.server_address[1]
    samples = {"p": [], "j": []}
    try:
        write_fleet_json(tmp_path, _layout(port))
        scrapers = {"p": p_probe.FleetScraper(tmp_path, timeout_s=0.5),
                    "j": j_probe.FleetScraper(tmp_path, timeout_s=0.5)}

        def sample():
            for k, s in scrapers.items():
                samples[k].append(s.sample()["requests"])

        sample()
        state["requests"]["POST /v1/weights 200"] = 150
        sample()
        state["requests"] = {"POST /v1/weights 200": 5}
        sample()
        (tmp_path / "fleet.json").unlink()
        sample()
    finally:
        srv.shutdown()
        srv.server_close()
    assert samples["p"] == samples["j"]
    assert samples["p"] == [(10, 100), (10, 160), (10, 165), (10, 165)]


def test_build_sources_names_like_the_jax_package(tmp_path):
    ev = EventLog(tmp_path, filename="events.probe.jsonl", process_index=0)
    jev = JEventLog(tmp_path / "j", filename="events.probe.jsonl",
                    process_index=0)
    ours = p_probe.build_sources(
        prober=p_probe.Prober(ev, fleet_dir=tmp_path),
        scraper=p_probe.FleetScraper(tmp_path), pointer_root=tmp_path)
    theirs = j_probe.build_sources(
        prober=j_probe.Prober(jev, fleet_dir=tmp_path),
        scraper=j_probe.FleetScraper(tmp_path), pointer_root=tmp_path)
    assert sorted(ours) == sorted(theirs)
    ev.close()
    jev.close()


# -- the detection drill on a CPU fleet ---------------------------------------


def _members(root, seeds=(1,)):
    from deeplearninginassetpricing_paperreplication_torch.serving.loadgen import (  # noqa: E501
        _make_member_dirs,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config import (  # noqa: E501
        GANConfig,
    )

    cfg = GANConfig(macro_feature_dim=6, individual_feature_dim=10,
                    hidden_dim=(8, 8), num_units_rnn=(4,))
    return _make_member_dirs(root, cfg, seeds)


def test_detection_drill_kill_then_wedge(tmp_path):
    """A supervised 2-replica CPU fleet under the live prober and the
    burn-rate engine (the drill spec): replica0 SIGKILLed fires the
    availability alert, and the supervisor's restart resolves it;
    replica1 SIGSTOPped (its socket still accepts, nothing answers) fires
    it again, and SIGCONT resolves it. The ops console and the report
    then tell the story."""
    from deeplearninginassetpricing_paperreplication_torch.serving.aserver import (  # noqa: E501
        pick_free_port,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.autoscale import (  # noqa: E501
        FleetController,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.fleet import (  # noqa: E501
        REPLICA_POLICY,
        ReplicaFleet,
        server_child_argv,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.flight import (  # noqa: E501
        FlightRecorder,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.server import (  # noqa: E501
        build_arg_parser,
    )

    dirs = _members(tmp_path / "m")
    np.save(tmp_path / "macro.npy", np.random.default_rng(11)
            .standard_normal((12, 6)).astype(np.float32))
    run_dir = tmp_path / "fleet_run"
    args = build_arg_parser().parse_args([
        "--checkpoint_dirs", *dirs, "--macro_npy",
        str(tmp_path / "macro.npy"), "--stock_buckets", "64",
        "--batch_buckets", "1,4", "--max_queue", "32", "--cache_size", "0",
        "--run_dir", str(run_dir), "--device", "cpu",
        "--compute_dtype", "float32"])
    port = pick_free_port()
    admin_ports = {}
    for i in range(2):
        p = pick_free_port()
        while p == port or p in admin_ports.values():
            p = pick_free_port()
        admin_ports[i] = p
    policy = dataclasses.replace(
        REPLICA_POLICY, backoff_base_s=1.0, backoff_max_s=1.0,
        jitter_frac=0.0, min_uptime_s=0.5, poll_s=0.2)

    def make_argv(rid, admin_port):
        return server_child_argv(args, rid, run_dir / f"replica{rid}",
                                 port, admin_port=admin_port)

    fleet = ReplicaFleet([make_argv(i, admin_ports[i]) for i in range(2)],
                         run_dir, policy=policy)
    controller = FleetController(fleet, make_argv, "127.0.0.1", port,
                                 admin_ports=dict(admin_ports))
    events = EventLog(run_dir, filename="events.probe.jsonl",
                      process_index=0)
    flight = FlightRecorder(run_dir=run_dir, events=events)
    prober = p_probe.Prober(events, public_url=f"http://127.0.0.1:{port}",
                            fixture=p_probe.fixture_payload(10, month=0),
                            fleet_dir=run_dir, interval_s=0.25,
                            timeout_s=1.0)
    engine = SLOEngine(drill_spec(long_s=6, short_s=1.5),
                       p_probe.build_sources(prober=prober),
                       events=events, flight=flight,
                       sinks=(FileAlertSink(run_dir / "alerts.jsonl"),),
                       poll_s=0.1)

    def wait_for(predicate, timeout_s, what):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if predicate():
                return
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}: "
                             f"{engine.state()} / {prober.stats()}")

    try:
        fleet.start()
        fleet.wait_ready(timeout=240)
        controller.publish_layout()
        prober.start()
        engine.start()
        wait_for(lambda: prober.counts()[1] >= 10, 60, "probes flowing")
        wait_for(lambda: engine.firing() == [], 60, "a clean baseline")
        failures_before, _ = prober.counts()
        os.kill(fleet.replica_pid(0), signal.SIGKILL)
        wait_for(lambda: engine.firing(), 60, "the kill drill's alert")
        assert engine.firing()[0]["objective"] == "availability"
        assert prober.counts()[0] > failures_before
        wait_for(lambda: not engine.firing(), 120, "the kill's resolve")
        pid1 = fleet.replica_pid(1)
        os.kill(pid1, signal.SIGSTOP)
        try:
            wait_for(lambda: engine.firing(), 60, "the wedge's alert")
        finally:
            os.kill(pid1, signal.SIGCONT)
        wait_for(lambda: not engine.firing(), 120, "the wedge's resolve")
    finally:
        engine.stop()
        prober.stop()
        summaries = fleet.stop()
        events.close()
    assert sum((s or {}).get("restarts", 0) for s in summaries) == 1
    rows = [json.loads(x) for x in
            (run_dir / "events.probe.jsonl").read_text().splitlines()]
    names = [r["name"] for r in rows if r["kind"] == "alert"]
    assert len(names) >= 4 and names[-4:] == [
        "alert/firing", "alert/resolved", "alert/firing", "alert/resolved"]
    sink = [json.loads(x)["state"] for x in
            (run_dir / "alerts.jsonl").read_text().splitlines()]
    assert sink == [n.split("/")[1] for n in names]
    s = statusboard.gather_status(run_dir)
    assert s["slo"]["firing"] == [] and s["slo"]["probe"]["failures"] >= 2
    tl = [r["name"] for r in statusboard.gather_timeline(run_dir)]
    assert "supervise/death" in tl and "supervise/restart" in tl
    summary = summarize_run(load_run(run_dir))
    assert summary["slo"]["alerts"]["firings"] >= 2
    assert summary["slo"]["alerts"]["firing_now"] == []


@pytest.mark.parametrize("argv", [["--interval", "0.2", "--timeout", "0.5"]])
def test_probe_cli_runs_and_stops_on_sigterm(tmp_path, argv):
    """``python -m …serving.probe`` against a stub fleet: it probes, writes
    its events, and a SIGTERM ends it cleanly (rc 0)."""
    import subprocess
    import sys

    srv = _stub_http()
    port = srv.server_address[1]
    write_fleet_json(tmp_path, _layout(port))
    run = tmp_path / "probe_run"
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "deeplearninginassetpricing_paperreplication_torch.serving.probe",
         "--url", f"http://127.0.0.1:{port}", "--fleet_dir", str(tmp_path),
         "--run_dir", str(run), "--n_features", "10", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 60
        path = run / "events.probe.jsonl"
        while time.monotonic() < deadline and not (
                path.exists() and "probe/check" in path.read_text()):
            assert proc.poll() is None, proc.stdout.read()
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        srv.shutdown()
        srv.server_close()
    assert proc.returncode == 0, out
    assert "probe/check" in (run / "events.probe.jsonl").read_text()
