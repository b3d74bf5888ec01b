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
