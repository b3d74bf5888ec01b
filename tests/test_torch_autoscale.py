"""The port's autoscaler against the JAX package's, on the CPU: the same
scripted ``/metrics`` sequence through both control loops gives the same
decisions tick for tick (hysteresis, floors, cooldown, the shed-rate
trigger, a fault at ``fleet/scale``), the decisions ride the flight
recorder's dump, and ``fleet.json`` written by either package's
``FleetController`` is the other's byte for byte. Then a live CPU fleet
through the port's ``FleetController``: scale-up, and a graceful
``/v1/drain`` scale-down the supervisor records as a clean exit.
"""

import json
import urllib.request

import numpy as np
import pytest

from deeplearninginassetpricing_paperreplication_torch.reliability import (
    faults as p_faults,
)
from deeplearninginassetpricing_paperreplication_torch.serving import (
    autoscale as p_auto,
)
from deeplearninginassetpricing_paperreplication_torch.serving.fleet import (
    read_fleet_json,
)
from deeplearninginassetpricing_paperreplication_torch.serving.flight import (
    FlightRecorder,
)
from deeplearninginassetpricing_paperreplication_tpu.reliability import (
    faults as j_faults,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    autoscale as j_auto,
)


class FakeController:
    """The Autoscaler's levers without processes: a replica count and a
    scripted /metrics answer shared by every replica."""

    def __init__(self, n=1):
        self.n = n
        self.depth = 0.0
        self.requests = {}
        self.p99 = 5.0
        self.downed = []

    def replica_ids(self):
        return list(range(self.n))

    def metrics(self, rid):
        return {"batcher": {"pending": self.depth},
                "latency": {"p99_ms": self.p99},
                "requests": dict(self.requests)}

    def scale_up(self, ready_timeout_s=0.0):
        self.n += 1
        return self.n - 1

    def scale_down(self, rid, drain_timeout_s=0.0):
        self.n -= 1
        self.downed.append(rid)
        return "drained"


def _policy(mod, **kw):
    base = dict(min_replicas=1, max_replicas=3, up_queue_depth=8.0,
                up_shed_rate=0.02, down_queue_depth=1.0, up_hysteresis=2,
                down_hysteresis=3, cooldown_s=0.0)
    base.update(kw)
    return mod.AutoscalePolicy(**base)


def _script(mod, script, policy_kw=None, flight=None):
    """Run one scripted sequence of (depth, requests, p99) ticks through
    a package's Autoscaler; returns its decisions without wall times."""
    f = FakeController()
    a = mod.Autoscaler(f, _policy(mod, **(policy_kw or {})), flight=flight)
    out = []
    for depth, requests, p99 in script:
        f.depth = depth
        if requests is not None:
            f.requests = requests
        f.p99 = p99
        out.append({k: v for k, v in a.tick().items() if k != "ts"})
    return out, (a.scale_ups, a.scale_downs, f.downed)


SCRIPTS = {
    "hysteresis_and_floors": (
        [(0.0, None, 5.0)] * 6 + [(20.0, None, 5.0)] * 8
        + [(0.0, None, 5.0)] * 8, {}),
    "shed_rate_and_counter_resets": (
        [(0.0, {"/v1/weights 200": 100}, 5.0),
         (0.0, {"/v1/weights 200": 150, "/v1/weights 429": 10}, 5.0),
         (0.0, {"/v1/weights 200": 160, "/v1/weights 429": 30}, 5.0),
         (0.0, {"/v1/weights 200": 5}, 5.0),
         (0.0, {"/v1/weights 200": 9, "/v1/weights 503": 1}, 5.0)], {}),
    "cooldown_blocks_flapping": (
        [(50.0, None, 5.0)] * 6, {"cooldown_s": 60.0, "up_hysteresis": 1}),
    "p99_trigger_holds_a_stale_window": (
        [(0.0, None, 500.0)] * 5 + [(0.0, None, 5.0)] * 5,
        {"up_p99_ms": 100.0, "up_hysteresis": 2}),
    "max_floor": (
        [(30.0, None, 5.0)] * 10, {"max_replicas": 2, "up_hysteresis": 1}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_autoscaler_decisions_equal_the_jax_autoscaler(name):
    script, kw = SCRIPTS[name]
    ours = _script(p_auto, script, kw)
    theirs = _script(j_auto, script, kw)
    assert ours == theirs
    actions = [d["action"] for d in ours[0]]
    if name == "hysteresis_and_floors":
        assert actions.count("up") == 2 and actions.count("down") == 2
        assert ours[1] == (2, 2, [2, 1])  # the highest live id goes first
    if name == "shed_rate_and_counter_resets":
        assert ours[0][2]["action"] == "up"
        assert ours[0][2]["reason"].startswith("shed_rate")
        assert ours[0][3]["shed_delta"] == 0  # a reset reads as no load
    if name == "cooldown_blocks_flapping":
        assert actions == ["up"] + ["hold"] * 5
        assert all(d.get("cooldown") for d in ours[0][1:])


def test_fault_at_fleet_scale_fails_one_event_like_the_jax_loop(monkeypatch):
    """A ``raise`` planned at ``fleet/scale`` fails exactly one scale event
    (recorded as ``up_failed``, the fleet untouched) and the loop retries
    on the next tick — in both packages, on the same plan."""
    monkeypatch.setenv("DLAP_FAULT_PLAN", json.dumps([
        {"site": "fleet/scale", "action": "raise", "trigger_count": 1}]))
    runs = []
    for mod, faults in ((p_auto, p_faults), (j_auto, j_faults)):
        faults.reset_injector()
        try:
            runs.append(_script(mod, [(50.0, None, 5.0)] * 3,
                                {"up_hysteresis": 1}))
        finally:
            faults.reset_injector()
    ours, theirs = runs
    for d in ours[0] + theirs[0]:
        d.pop("error", None)
    assert ours == theirs
    assert [d["action"] for d in ours[0]] == ["up_failed", "up", "up"]
    assert ours[1][0] == 2


def test_decisions_ride_the_flight_recorder_dump(tmp_path):
    fr = FlightRecorder(run_dir=tmp_path)
    _script(p_auto, [(50.0, None, 5.0), (0.0, None, 5.0)],
            {"up_hysteresis": 1}, flight=fr)
    for _ in range(8):  # shed 429s arm the burst trigger
        tok = fr.begin_request("t" * 32, "/v1/weights")
        fr.end_request(tok, {"status": 429})
    assert fr.error_burst()
    snap = json.loads(fr.dump("error_burst").read_text())
    decisions = snap["autoscaler_decisions"]
    assert [d["action"] for d in decisions] == ["up", "hold"]
    assert decisions[0]["mean_queue_depth"] == 50.0


class _FakeFleet:
    def __init__(self, run_dir, live):
        self.run_dir = run_dir
        self.live = live
        self.replicas = max(live) + 1

    def live_ids(self):
        return list(self.live)


@pytest.mark.parametrize("pointer", [None, "/ctl"])
def test_fleet_json_interchanges_with_the_jax_package(tmp_path, pointer):
    """The same live layout published by either package's controller is
    the same bytes, and each package's reader reads the other's file."""
    from deeplearninginassetpricing_paperreplication_tpu.serving.fleet import (  # noqa: E501
        read_fleet_json as j_read,
    )

    texts = []
    for name, mod in (("p", p_auto), ("j", j_auto)):
        d = tmp_path / name
        d.mkdir()
        ctl = mod.FleetController(_FakeFleet(d, [0, 2]), None, "127.0.0.1",
                                  8787, admin_ports={0: 9001, 1: 9002,
                                                     2: 9003},
                                  pointer=pointer)
        ctl.publish_layout()
        texts.append((d / "fleet.json").read_bytes())
        ctl.publish_layout(replica_ids=range(3))  # the boot publish
        texts.append((d / "fleet.json").read_bytes())
    assert texts[0] == texts[2] and texts[1] == texts[3]
    assert read_fleet_json(tmp_path / "j") == j_read(tmp_path / "p")
    layout = read_fleet_json(tmp_path / "j")
    assert layout["replica_ids"] == [0, 1, 2]
    assert layout["admin_urls"][1] == "http://127.0.0.1:9002"
    assert layout["mesh"] is None and layout["total_replicas_ever"] == 3


def test_scale_up_then_graceful_drain_down(tmp_path):
    """A live 1-replica CPU fleet grows to 2 through the port's
    ``FleetController.scale_up`` and shrinks back through ``/v1/drain``:
    the victim exits rc 0 (supervisor outcome ``success``, no restart),
    and ``fleet.json`` tracks the live layout at every step."""
    from deeplearninginassetpricing_paperreplication_torch.serving.aserver import (  # noqa: E501
        pick_free_port,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.fleet import (  # noqa: E501
        ReplicaFleet,
        server_child_argv,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.loadgen import (  # noqa: E501
        _make_member_dirs,
        binary_payload_bytes,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.server import (  # noqa: E501
        BINARY_CONTENT_TYPE,
        build_arg_parser,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config import (  # noqa: E501
        GANConfig,
    )

    cfg = GANConfig(macro_feature_dim=6, individual_feature_dim=10,
                    hidden_dim=(8, 8), num_units_rnn=(4,))
    dirs = _make_member_dirs(tmp_path / "m", cfg, (1,))
    rng = np.random.default_rng(3)
    np.save(tmp_path / "macro.npy",
            rng.standard_normal((12, 6)).astype(np.float32))
    run_dir = tmp_path / "fleet_run"
    args = build_arg_parser().parse_args([
        "--checkpoint_dirs", *dirs, "--macro_npy",
        str(tmp_path / "macro.npy"), "--stock_buckets", "64",
        "--batch_buckets", "1,4", "--max_queue", "32", "--cache_size", "0",
        "--run_dir", str(run_dir), "--device", "cpu",
        "--compute_dtype", "float32"])
    port = pick_free_port()
    admin0 = pick_free_port()

    def make_argv(rid, admin_port):
        return server_child_argv(args, rid, run_dir / f"replica{rid}",
                                 port, admin_port=admin_port)

    fleet = ReplicaFleet([make_argv(0, admin0)], run_dir)
    ctl = p_auto.FleetController(fleet, make_argv, "127.0.0.1", port,
                                 admin_ports={0: admin0})
    try:
        fleet.start()
        fleet.wait_ready(timeout=240)
        ctl.publish_layout()
        assert read_fleet_json(run_dir)["replicas"] == 1
        rid = ctl.scale_up(ready_timeout_s=240)
        assert rid == 1 and fleet.live_ids() == [0, 1]
        layout = read_fleet_json(run_dir)
        assert layout["replica_ids"] == [0, 1]
        assert str(rid) in layout["admin_ports"]
        # the new replica serves on the shared port and its admin port
        body = binary_payload_bytes(
            rng.standard_normal((40, 10)).astype(np.float32), 0)
        for url in (f"http://127.0.0.1:{port}", ctl.admin_url(rid)):
            req = urllib.request.Request(
                url + "/v1/weights", data=body, method="POST",
                headers={"Content-Type": BINARY_CONTENT_TYPE})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200 and len(r.read()) == 40 * 4
        assert ctl.metrics(rid)["replica"] == "replica1"
        assert ctl.scale_down(rid, drain_timeout_s=10) == "drained"
        assert fleet.live_ids() == [0]
        assert read_fleet_json(run_dir)["replicas"] == 1
        assert (fleet.summaries[rid] or {}).get("outcome") == "success"
        assert (fleet.summaries[rid] or {}).get("restarts") == 0
        rows = [json.loads(line) for line in
                (run_dir / f"replica{rid}" / "events.jsonl"
                 ).read_text().splitlines()]
        assert any(r.get("name") == "serve/drain" for r in rows)
    finally:
        fleet.stop()
