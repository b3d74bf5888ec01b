"""The port's observability and fault-injection copies against the JAX
package's: the same event feed gives byte-identical Prometheus text from
both ``MetricsRegistry`` copies (times pinned), both ``tracecontext``
copies parse, format and sample identically, and the heartbeat, latency
percentiles, flight recorder and event log agree; plus what the port
changed: the rank without JAX, the torch manifest, the serving fault sites
and the pre-death hooks."""

import json

import pytest

from deeplearninginassetpricing_paperreplication_torch.observability import (
    events as p_events,
)
from deeplearninginassetpricing_paperreplication_torch.observability import (
    heartbeat as p_heartbeat,
)
from deeplearninginassetpricing_paperreplication_torch.observability import (
    manifest as p_manifest,
)
from deeplearninginassetpricing_paperreplication_torch.observability import (
    metrics as p_metrics,
)
from deeplearninginassetpricing_paperreplication_torch.observability import (
    report as p_report,
)
from deeplearninginassetpricing_paperreplication_torch.observability import (
    tracecontext as p_tc,
)
from deeplearninginassetpricing_paperreplication_torch.reliability import (
    faults as p_faults,
)
from deeplearninginassetpricing_paperreplication_torch.serving import (
    flight as p_flight,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    heartbeat as j_heartbeat,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    metrics as j_metrics,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    report as j_report,
)
from deeplearninginassetpricing_paperreplication_tpu.observability import (
    tracecontext as j_tc,
)
from deeplearninginassetpricing_paperreplication_tpu.reliability import (
    faults as j_faults,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    flight as j_flight,
)

# one feed of event rows as an EventLog would emit them (times pinned): a
# counter per label set, gauges, span_end durations across the buckets and
# request rows carrying trace-id exemplars
FEED = [
    ("counter", "serve/requests", {"endpoint": "/v1/weights",
                                   "status": 200}),
    ("counter", "serve/requests", {"endpoint": "/v1/weights",
                                   "status": 200}),
    ("counter", "serve/requests", {"endpoint": "/v1/sdf", "status": 400}),
    ("counter", "serve/flush", {"value": 3, "priority": "interactive",
                                "bucket": "16384"}),
    ("counter", "serve/cache", {"hit": True, "endpoint": "/v1/sdf"}),
    ("gauge", "model/drift_psi", {"value": 0.125, "endpoint": "/v1/sdf"}),
    ("gauge", "serve/steady_state_captures", {"value": 0}),
    ("span_end", "serve/dispatch", {"duration_s": 0.0004}),
    ("span_end", "serve/dispatch", {"duration_s": 0.0031}),
    ("span_end", "serve/dispatch", {"duration_s": 0.2}),
    ("span_end", "serve/macro_scan", {"duration_s": 12.5}),
    ("request", "serve/request", {"duration_s": 0.004,
                                  "endpoint": "/v1/weights", "status": 200,
                                  "trace_id": "a" * 32}),
    ("request", "serve/request", {"duration_s": 0.09,
                                  "endpoint": "/v1/weights", "status": 200,
                                  "trace_id": "b" * 32}),
    ("span_end", "serve/request", {"duration_s": 0.011,
                                   "endpoint": "/v1/weights",
                                   "status": 200}),
    ("counter", "fault/injected", {"site": "serve/flush",
                                   "action": "raise"}),
]


def _render(metrics_mod, exemplars):
    reg = metrics_mod.MetricsRegistry()
    for kind, name, row in FEED:
        metrics_mod.feed_event(reg, kind, name, dict(row))
    return reg.render_prom(exemplars=exemplars)


@pytest.mark.parametrize("exemplars", [True, False])
def test_prometheus_text_byte_identical(exemplars):
    ours = _render(p_metrics, exemplars)
    assert ours == _render(j_metrics, exemplars)
    series = p_metrics.parse_prom_text(ours)
    assert series == j_metrics.parse_prom_text(ours)
    assert series["dlap_serve_requests_total"][
        (("endpoint", "/v1/weights"), ("status", "200"))] == 2
    assert p_metrics.parse_prom_exemplars(ours) \
        == j_metrics.parse_prom_exemplars(ours)


@pytest.mark.parametrize("name,kind", [
    ("serve/requests", "counter"), ("model/drift_psi", "gauge"),
    ("serve/dispatch", "span"), ("a-b.c/d e", "counter")])
def test_prom_names_agree(name, kind):
    assert p_metrics.prom_name(name, kind) == j_metrics.prom_name(name, kind)


def test_process_gauges_share_their_names():
    assert sorted(p_metrics.process_stats()) \
        == sorted(j_metrics.process_stats())
    names = set(p_metrics.parse_prom_text(p_metrics.render_process_prom()))
    assert names == set(j_metrics.parse_prom_text(
        j_metrics.render_process_prom()))
    assert p_metrics.PROM_CONTENT_TYPE == j_metrics.PROM_CONTENT_TYPE


HEADERS = [
    "00-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-00f067aa0ba902b7-01",
    "00-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-00f067aa0ba902b7-00",
    "00-" + "0" * 32 + "-00f067aa0ba902b7-01",  # all-zero trace id
    "00-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-" + "0" * 16 + "-01",
    "ff-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    "garbage", "", None, "00-abc-def-01",
    " 00-" + "4bf92f3577b34da6a3ce929d0e0e4736" + "-00f067aa0ba902b7-01 ",
]


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_identical(header):
    assert p_tc.parse_traceparent(header) == j_tc.parse_traceparent(header)
    ours = p_tc.TraceContext.from_header(header)
    theirs = j_tc.TraceContext.from_header(header)
    if p_tc.parse_traceparent(header) is not None:
        assert (ours.trace_id, ours.parent_id, ours.sampled) \
            == (theirs.trace_id, theirs.parent_id, theirs.sampled)
        assert len(ours.span_id) == len(theirs.span_id) == 16


@pytest.mark.parametrize("rate", ["0", "0.25", "0.5", "1", "bogus"])
def test_trace_sampling_identical(monkeypatch, rate):
    monkeypatch.setenv("DLAP_TRACE_SAMPLE", rate)
    assert p_tc.sample_rate() == j_tc.sample_rate()
    ids = [f"{i:08x}" + "0" * 24 for i in range(0, 2**32, 2**27)]
    assert [p_tc.trace_sampled(t) for t in ids] \
        == [j_tc.trace_sampled(t) for t in ids]
    assert p_tc.format_traceparent("a" * 32, "b" * 16, True) \
        == j_tc.format_traceparent("a" * 32, "b" * 16, True)


def test_heartbeat_state_files_interchange(tmp_path):
    p_heartbeat.Heartbeat(tmp_path / "hb.json").beat("serve/ready", gen=2)
    state = j_heartbeat.read_state(tmp_path / "hb.json")
    assert state["heartbeat"]["section"] == "serve/ready"
    assert state["gen"] == 2
    assert j_heartbeat.last_beat(state) == p_heartbeat.last_beat(state)
    assert p_heartbeat.is_stale(state, 3600) is False


@pytest.mark.parametrize("n", [0, 1, 7, 100])
def test_latency_percentiles_identical(n):
    lat = [((i * 7919) % 113) / 1e3 for i in range(n)]
    assert p_report.latency_percentiles_ms(lat) \
        == j_report.latency_percentiles_ms(lat)


def test_flight_recorder_dumps_interchange(tmp_path):
    recs = {}
    for name, mod in (("torch", p_flight), ("jax", j_flight)):
        (tmp_path / name).mkdir()
        fr = mod.FlightRecorder(run_dir=tmp_path / name, burst_threshold=2,
                                cooldown_s=0.0)
        for i, (status, dur) in enumerate([(200, 0.01), (500, 0.3),
                                           (503, 0.2), (200, 0.05)]):
            tok = fr.begin_request(f"{i:032x}", "/v1/weights")
            fr.end_request(tok, {"trace_id": f"{i:032x}", "status": status,
                                 "duration_s": dur, "ts": float(i)})
        fr.begin_request("f" * 32, "/v1/sdf")  # still in flight
        fr.record_flush({"flush": 0, "occupancy": 4})
        assert fr.error_burst() is True
        fr.dump("admin")
        snap = mod.load_flightrecorder(tmp_path / name)
        recs[name] = snap
    for key in ("reason", "n_requests", "n_flushes", "requests", "flushes",
                "in_flight_trace_ids"):
        assert recs["torch"][key] == recs["jax"][key], key
    assert p_flight.slowest_requests(recs["torch"]["requests"], 2) \
        == j_flight.slowest_requests(recs["jax"]["requests"], 2)


def test_event_log_rows_and_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "3")
    log = p_events.EventLog(tmp_path)
    assert log.process_index == 3
    assert log.path.name == "events.proc3.jsonl"
    with log.span("serve/dispatch", bucket=64) as sp:
        pass
    log.counter("serve/requests", endpoint="/v1/sdf", status=200)
    log.close()
    rows = [json.loads(x) for x in log.path.read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["span_begin", "span_end", "counter"]
    assert rows[1]["duration_s"] == pytest.approx(sp.seconds, abs=1e-5)
    assert all(r["process_index"] == 3 for r in rows)
    monkeypatch.delenv("RANK")
    assert p_events.EventLog().process_index == 0


def test_manifest_reads_torch_not_jax(tmp_path):
    from deeplearninginassetpricing_paperreplication_torch.utils.config import (
        GANConfig,
    )

    cfg = GANConfig(macro_feature_dim=6, individual_feature_dim=10)
    m = p_manifest.write_manifest(tmp_path, "serve", config=cfg)
    assert set(m["versions"]) == {"python", "numpy", "torch", "cuda"}
    assert m["devices"]["backend"] in ("cpu", "cuda")
    assert m["config_hash"] == p_manifest.config_hash(cfg)
    p_manifest.update_manifest(tmp_path, extra_key=1)
    assert p_manifest.load_manifest(tmp_path)["extra_key"] == 1


def test_serving_fault_sites_and_pre_death_hooks(monkeypatch):
    for site in ("serving/infer", "serve/accept", "serve/admit",
                 "serve/flush", "serve/coalesce", "serve/reload"):
        assert site in p_faults.SITES and site in j_faults.SITES
    seen = []

    def hook(site, action):
        seen.append((site, action))

    p_faults.add_pre_death_hook(hook)
    p_faults.add_pre_death_hook(hook)  # idempotent
    assert p_faults._pre_death_hooks.count(hook) == 1
    monkeypatch.setattr(p_faults.os, "kill", lambda pid, sig: seen.append(
        ("killed", sig)) or (_ for _ in ()).throw(SystemExit(9)))
    inj = p_faults.FaultInjector({"site": "serve/flush", "action": "kill"})
    with pytest.raises(SystemExit):
        inj.fire("serve/flush", occupancy=4)
    assert seen[0] == ("serve/flush", "kill") and seen[1][0] == "killed"
    p_faults.remove_pre_death_hook(hook)
    p_faults.remove_pre_death_hook(hook)  # absent: no error
    assert hook not in p_faults._pre_death_hooks


def test_injected_flush_raise_fails_only_that_flush(monkeypatch):
    """A plan's `raise` at serve/flush lands on that flush's requests; the
    dispatcher survives and serves the next one."""
    import asyncio

    from deeplearninginassetpricing_paperreplication_torch.serving.batcher import (
        ContinuousBatcher,
    )

    monkeypatch.setenv(p_faults.ENV_PLAN, json.dumps(
        {"site": "serve/flush", "action": "raise", "trigger_count": 1}))
    p_faults.reset_injector()

    async def body():
        cb = ContinuousBatcher(lambda b, items: list(items))
        with pytest.raises(p_faults.FaultInjected):
            await cb.submit("b", 1)
        ok = await cb.submit("b", 2)
        await cb.aclose()
        return ok

    try:
        assert asyncio.run(body()) == 2
    finally:
        monkeypatch.delenv(p_faults.ENV_PLAN)
        p_faults.reset_injector()


# -- the train CLI's telemetry: the run logger, memory, the sidecar, plans ----

_IDENTITY = {"run_id", "process_index", "tid", "seq", "ts", "mono"}


def _rows(path):
    return [{k: v for k, v in json.loads(x).items() if k not in _IDENTITY}
            for x in path.read_text().splitlines()]


@pytest.mark.parametrize("rank", ["0", "1"])
def test_run_logger_agrees_with_jax(tmp_path, capsys, monkeypatch, rank):
    """The same calls print the same lines (process 0 only) and mirror the
    same log rows into every process's events file."""
    from deeplearninginassetpricing_paperreplication_torch.observability import (
        logging as p_logging,
    )
    from deeplearninginassetpricing_paperreplication_tpu.observability import (
        events as j_events,
    )
    from deeplearninginassetpricing_paperreplication_tpu.observability import (
        logging as j_logging,
    )

    monkeypatch.setenv("RANK", rank)
    out = {}
    for name, ev_mod, log_mod in (("torch", p_events, p_logging),
                                  ("jax", j_events, j_logging)):
        events = ev_mod.EventLog(tmp_path / name, process_index=int(rank))
        logger = log_mod.RunLogger(events=events, verbose=True)
        logger.info("phase 1 done", step=3)
        logger.info("quiet", verbose=False)
        logger.warning("guard trip", phase="phase1_unconditional")
        quiet = log_mod.RunLogger(events=events, verbose=False)
        quiet.info("not printed")
        events.close()
        cap = capsys.readouterr()
        out[name] = (cap.out, cap.err, _rows(events.path))
    assert out["torch"] == out["jax"]
    printed = out["torch"][0].splitlines()
    assert printed == (["phase 1 done"] if rank == "0" else [])
    assert [r["message"] for r in out["torch"][2]] == [
        "phase 1 done", "quiet", "guard trip", "not printed"]


def test_active_run_logger_is_set_once():
    from deeplearninginassetpricing_paperreplication_torch.observability import (
        logging as p_logging,
    )

    before = p_logging.get_run_logger()
    try:
        mine = p_logging.RunLogger()
        assert p_logging.set_run_logger(mine) is mine
        assert p_logging.get_run_logger() is mine
    finally:
        p_logging.set_run_logger(before)


def test_memory_snapshot_has_the_jax_shape_on_the_cpu(tmp_path):
    """No CUDA context in this process: no devices, the JAX keys; a beat
    with memory=True adds the state's device_memory and a memory event, as
    the JAX heartbeat does."""
    from deeplearninginassetpricing_paperreplication_torch.observability import (
        memory as p_memory,
    )
    from deeplearninginassetpricing_paperreplication_tpu.observability import (
        events as j_events,
    )
    from deeplearninginassetpricing_paperreplication_tpu.observability import (
        memory as j_memory,
    )

    snap = p_memory.device_memory_snapshot()
    assert snap == {"n_devices": 0, "totals": {}, "per_device": []}
    assert set(snap) == set(j_memory.device_memory_snapshot())
    states = {}
    for name, ev_mod, hb_mod in (("torch", p_events, p_heartbeat),
                                 ("jax", j_events, j_heartbeat)):
        events = ev_mod.EventLog(tmp_path / name)
        hb_mod.Heartbeat(tmp_path / name / "hb.json", events=events).beat(
            "phase1_unconditional", memory=True)
        events.close()
        states[name] = json.loads((tmp_path / name / "hb.json").read_text())
        kinds = [r["kind"] for r in _rows(events.path)]
        assert kinds == ["memory", "heartbeat"], name
    assert set(states["torch"]) == set(states["jax"]) == {
        "heartbeat", "device_memory"}
    assert set(states["torch"]["device_memory"]) == set(
        states["jax"]["device_memory"]) == {"n_devices", "totals"}


def test_memory_aggregation_rule():
    """Counts sum over devices; peak, largest and limit take the max."""
    from deeplearninginassetpricing_paperreplication_torch.observability import (
        memory as p_memory,
    )

    class Cuda:
        def is_initialized(self):
            return True

        def device_count(self):
            return 2

        def memory_stats(self, d):
            return {"allocated_bytes.all.current": 10 * (d + 1),
                    "allocated_bytes.all.peak": 100 * (d + 1),
                    "allocated_bytes.small_pool.current": 5,
                    "num_alloc_retries": d,
                    "reserved_bytes.all.peak": 50 - d}

        def get_device_properties(self, d):
            return type("P", (), {"total_memory": 1000})()

    fake = type("Torch", (), {"cuda": Cuda()})()
    import sys

    real = sys.modules["torch"]
    sys.modules["torch"] = fake
    try:
        snap = p_memory.device_memory_snapshot()
    finally:
        sys.modules["torch"] = real
    assert snap["n_devices"] == 2 and len(snap["per_device"]) == 2
    t = snap["totals"]
    assert t["allocated_bytes.all.current"] == 30 == t["bytes_in_use"]
    assert t["allocated_bytes.all.peak"] == 200 == t["peak_bytes_in_use"]
    assert t["num_alloc_retries"] == 1 and t["reserved_bytes.all.peak"] == 50
    assert t["bytes_limit"] == 1000
    assert "allocated_bytes.small_pool.current" not in t


def test_metrics_sidecar_scrapes(tmp_path):
    import urllib.error
    import urllib.request

    events = p_events.EventLog(tmp_path)
    events.counter("epochs_dispatched", value=4, phase="phase1_unconditional")
    events.counter("guard/trip", phase="phase1_unconditional")
    sidecar = p_metrics.MetricsSidecar([events.metrics], port=0)
    port = sidecar.start()
    try:
        assert port > 0
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"] == p_metrics.PROM_CONTENT_TYPE
            prom = p_metrics.parse_prom_text(r.read().decode())
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/v1/reload", timeout=10)
        assert e.value.code == 404
    finally:
        sidecar.stop()
        events.close()
    key = (("phase", "phase1_unconditional"),)
    assert prom["dlap_epochs_dispatched_total"][key] == 4
    assert prom["dlap_guard_trip_total"][key] == 1
    assert "dlap_process_uptime_seconds" in prom or any(
        k.startswith("dlap_process") for k in prom)


@pytest.mark.parametrize("exemplars", [True, False])
def test_parse_prom_text_round_trips(exemplars):
    """The registry's text parses back to its values, in both packages."""
    reg = p_metrics.MetricsRegistry()
    jreg = j_metrics.MetricsRegistry()
    for kind, name, row in FEED:
        p_metrics.feed_event(reg, kind, name, dict(row))
        j_metrics.feed_event(jreg, kind, name, dict(row))
    text = reg.render_prom(exemplars=exemplars)
    parsed = p_metrics.parse_prom_text(text)
    assert parsed == j_metrics.parse_prom_text(text)
    again = "".join(
        f"{n}{{{','.join(f'{k}={chr(34)}{v}{chr(34)}' for k, v in lab)}}} "
        f"{val!r}\n" if lab else f"{n} {val!r}\n"
        for n, series in parsed.items() for lab, val in series.items())
    assert p_metrics.parse_prom_text(again) == parsed
    assert sum(parsed["dlap_serve_requests_total"].values()) == 3


def test_program_records_fold_into_the_manifest(tmp_path):
    """record_program emits a program row carrying the record it collects;
    a plan dataclass becomes plain JSON."""
    from deeplearninginassetpricing_paperreplication_torch.observability import (
        programs,
    )
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        cond_em,
        sdf_ffn,
    )

    lay = sdf_ffn.ffn_layout(46, (64, 64))
    fwd = sdf_ffn.fwd_plan(lay, 132, 1, 48, 10000, "bfloat16")
    cem = cond_em.cem_plan(1, 48, 10000, 46, 8, 132, "bfloat16").fwd
    events = p_events.EventLog(tmp_path)
    collected = {}
    held = {"blocks_per_sm": 2, "registers": 96, "local_bytes": 0}
    programs.record_program(events, "sdf_ffn_fwd/train", fwd, held,
                            collected, S=1, T=48, N=10000)
    programs.record_program(events, "cond_em_fwd/train", cem, held,
                            collected, S=1, T=48, N=10000)
    events.close()
    rows = [json.loads(x) for x in events.path.read_text().splitlines()]
    assert {r["name"]: r["analysis"] for r in rows
            if r["kind"] == "program"} == collected
    rec = json.loads(json.dumps(collected))["cond_em_fwd/train"]
    assert rec["plan"]["grid"] == list(cem.grid)
    assert rec["held"] == held and rec["T"] == 48
    assert collected["sdf_ffn_fwd/train"]["plan"]["tile"] == fwd.tile
