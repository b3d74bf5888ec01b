"""The port's replica fleet on the CPU: the serving CLI with ``--replicas
2`` boots two supervised replicas on one ``SO_REUSEPORT`` port from a
promotion pointer, and they answer bit for bit what the single-process
service answers; ``/v1/debug/profile`` (``torch.profiler``) works on a
replica's admin port and nowhere else; a ``RollingUpdater`` rolls both
replicas onto a newly promoted pointer under open-loop load with nothing
dropped; a replica SIGKILLed under load loses no request and is restarted
once. Also: the children inherit the parent's execution flags, the
server CLI carries the JAX package's fleet flags with its defaults, and a
plan at ``serve/replica_kill`` hits the one replica its label matches.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from deeplearninginassetpricing_paperreplication_torch.observability.heartbeat import (  # noqa: E501
    read_state,
)
from deeplearninginassetpricing_paperreplication_torch.serving.fleet import (
    RollingUpdater,
    read_fleet_json,
    server_child_argv,
)
from deeplearninginassetpricing_paperreplication_torch.serving.loadgen import (
    _make_member_dirs,
    binary_payload_bytes,
    run_loadgen,
)
from deeplearninginassetpricing_paperreplication_torch.serving.server import (
    BINARY_CONTENT_TYPE,
    build_arg_parser,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
)

REPO = Path(__file__).resolve().parents[1]
PKG = "deeplearninginassetpricing_paperreplication_torch"
N, F, M, T = 40, 10, 6, 12
CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")


def test_children_inherit_the_execution_flags(tmp_path):
    args = build_arg_parser().parse_args([
        "--checkpoint_dirs", "a", "b", "--macro_npy", "m.npy",
        "--device", "cpu", "--kernel", "off", "--compute_dtype", "float32",
        "--replicas", "3", "--run_dir", str(tmp_path), "--cache_size", "0",
        "--stock_buckets", "64", "--no_coalesce"])
    argv = server_child_argv(args, 1, tmp_path / "replica1", 8787,
                             admin_port=9001)
    flags = dict(zip(argv, argv[1:]))
    assert argv[:3] == [sys.executable, "-m", f"{PKG}.serving.server"]
    assert (flags["--device"], flags["--kernel"],
            flags["--compute_dtype"]) == ("cpu", "off", "float32")
    assert (flags["--replica_id"], flags["--admin_port"],
            flags["--port"]) == ("1", "9001", "8787")
    assert "--reuse_port" in argv and "--no_coalesce" in argv
    assert "--replicas" not in argv
    assert flags["--run_dir"] == str(tmp_path / "replica1")
    # the children are rebuilt by the same parser
    child = build_arg_parser().parse_args(argv[3:])
    assert child.replica_id == 1 and child.reuse_port
    assert child.checkpoint_dirs == ["a", "b"] and child.device == "cpu"


def test_server_cli_has_the_jax_fleet_flags():
    """Every serving flag of the JAX CLI, the mesh's three included, with
    the same defaults for the fleet, autoscaler and mesh flags."""
    from deeplearninginassetpricing_paperreplication_tpu.serving.server import (  # noqa: E501
        build_arg_parser as j_parser,
    )

    ours = {a.dest: a.default for a in build_arg_parser()._actions}
    theirs = {a.dest: a.default for a in j_parser()._actions}
    assert set(theirs) - set(ours) == set()
    for dest in ("mesh", "mesh_slices", "mesh_slice",
                 "replicas", "replica_id", "autoscale", "min_replicas",
                 "max_replicas", "autoscale_up_depth",
                 "autoscale_down_depth", "autoscale_up_hysteresis",
                 "autoscale_down_hysteresis", "autoscale_poll_s",
                 "autoscale_cooldown_s", "reuse_port"):
        assert ours[dest] == theirs[dest], dest


def _replica_pid(run_dir: Path, i: int):
    """The live pid of a CLI fleet's replica ``i`` (its command line names
    its run dir), or None."""
    want = str(run_dir / f"replica{i}").encode()
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if b"--replica_id" in cmd and want in cmd:
            return int(d.name)
    return None


def _ready(run_dir: Path, n: int) -> bool:
    for i in range(n):
        hb = read_state(run_dir / f"replica{i}" / "heartbeat.json")
        if (hb.get("heartbeat") or {}).get("section") != "serve/accepting":
            return False
    layout = read_fleet_json(run_dir)
    return bool(layout and len(layout.get("admin_urls") or []) == n)


def _post_raw(url, body, timeout=60):
    req = urllib.request.Request(url + "/v1/weights", data=body,
                                 method="POST", headers={
                                     "Content-Type": BINARY_CONTENT_TYPE})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _post_json(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST", headers={
                                     "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A 2-replica CPU fleet through the serving CLI, booted from a
    promotion pointer over members v1; v2 is a second generation of the
    same architecture for the rolling update."""
    from deeplearninginassetpricing_paperreplication_torch.reliability.promotion import (  # noqa: E501
        promote,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving.aserver import (  # noqa: E501
        pick_free_port,
    )

    root = tmp_path_factory.mktemp("fleet")
    cfg = GANConfig(macro_feature_dim=M, individual_feature_dim=F,
                    hidden_dim=(8, 8), num_units_rnn=(4,))
    v1 = _make_member_dirs(root / "v1", cfg, (1, 2))
    v2 = _make_member_dirs(root / "v2", cfg, (101, 102))
    rng = np.random.default_rng(5)
    macro = rng.standard_normal((T, M)).astype(np.float32)
    np.save(root / "macro.npy", macro)
    ctl = root / "ctl"
    promote(ctl, v1, source="v1", exec_cfg=CPU_F32)
    run_dir = root / "fleet_run"
    port = pick_free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.serving.server", "--replicas", "2",
         "--pointer", str(ctl), "--macro_npy", str(root / "macro.npy"),
         "--stock_buckets", "64", "--batch_buckets", "1,4",
         "--cache_size", "0", "--max_queue", "64", "--run_dir",
         str(run_dir), "--port", str(port), "--device", "cpu",
         "--compute_dtype", "float32"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 240
        while not _ready(run_dir, 2):
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "the fleet did not boot"
            time.sleep(0.2)
        bodies = [binary_payload_bytes(
            rng.standard_normal((N, F)).astype(np.float32), t)
            for t in range(T)]
        yield dict(proc=proc, run_dir=run_dir, url=f"http://127.0.0.1:{port}",
                   admin=read_fleet_json(run_dir)["admin_urls"], ctl=ctl,
                   v1=v1, v2=v2, macro=macro, bodies=bodies)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()


def test_fleet_answers_what_the_single_process_service_answers(fleet):
    """Every month through the shared port equals, bit for bit, the
    single-process service on the same members; both replicas answer
    (each on its admin port too), and the layout names the pointer."""
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        InferenceEngine,
        ServingService,
    )

    eng = InferenceEngine(fleet["v1"], macro_history=fleet["macro"],
                          stock_buckets=(64,), batch_buckets=(1, 4),
                          exec_cfg=CPU_F32)
    service = ServingService(eng, mode="async", cache_size=0)
    try:
        for t, body in enumerate(fleet["bodies"]):
            month, n = np.frombuffer(body[:8], np.int32)[0], N
            ref = eng.infer_one(_req(body, month)).weights
            assert _post_raw(fleet["url"], body) == ref.tobytes(), t
            for admin in fleet["admin"]:
                assert _post_raw(admin, body) == ref.tobytes(), (t, admin)
            assert n == ref.shape[0]
    finally:
        service.close()
    seen = {_get(a + "/metrics")["replica"] for a in fleet["admin"]}
    assert seen == {"replica0", "replica1"}
    layout = read_fleet_json(fleet["run_dir"])
    assert layout["pointer"] == str(fleet["ctl"])
    assert layout["replica_ids"] == [0, 1] and layout["mesh"] is None
    for a in fleet["admin"]:
        m = _get(a + "/metrics")
        assert m["engine"]["steady_state_captures"] == 0
        assert m["engine"]["device"] == "cpu"


def _req(body, month):
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        InferenceRequest,
    )

    ind = np.frombuffer(body, np.float32, offset=8).reshape(N, F)
    return InferenceRequest(individual=ind, month=int(month))


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_debug_profile_on_the_admin_port_only(fleet):
    """start/stop through one replica's admin port writes a Chrome trace
    into its run dir; the shared port answers 404; a second start while
    one runs is 409, a stop with none running 400."""
    admin = fleet["admin"][0]
    s, body = _post_json(fleet["url"] + "/v1/debug/profile",
                         {"action": "start"})
    assert s == 404
    s, body = _post_json(admin + "/v1/debug/profile", {"action": "start"})
    assert s == 200 and body["profiling"] is True
    assert _post_json(admin + "/v1/debug/profile",
                      {"action": "start"})[0] == 409
    for body_ in fleet["bodies"][:4]:
        _post_raw(admin, body_)
    s, body = _post_json(admin + "/v1/debug/profile", {"action": "stop"})
    assert s == 200 and body["profiling"] is False and body["non_empty"]
    trace = json.loads(Path(body["trace"]).read_text())
    assert Path(body["trace"]).parent.parent == \
        fleet["run_dir"] / "replica0" / "profile"
    assert trace["traceEvents"]
    assert _post_json(admin + "/v1/debug/profile",
                      {"action": "stop"})[0] == 400
    assert _post_json(admin + "/v1/debug/profile",
                      {"action": "nope"})[0] == 400


def test_rolling_update_onto_a_promoted_pointer_drops_nothing(fleet):
    """Promote v2 while an open-loop load runs, roll it across the fleet
    one replica at a time through the admin ports: nothing dropped, both
    replicas converge on the pointer's fingerprint, no capture."""
    from deeplearninginassetpricing_paperreplication_torch.reliability.promotion import (  # noqa: E501
        promote,
    )

    bodies = fleet["bodies"]
    load = {}

    def drive():
        load.update(run_loadgen(
            fleet["url"] + "/v1/weights", lambda i: bodies[i % len(bodies)],
            mode="open", rate_rps=40.0, n_requests=160, warmup_requests=0,
            retries=3, open_workers=8, content_type=BINARY_CONTENT_TYPE))

    t = threading.Thread(target=drive)
    t.start()
    time.sleep(1.0)
    pointer = promote(fleet["ctl"], fleet["v2"], source="v2",
                      exec_cfg=CPU_F32)
    roll = RollingUpdater(fleet["admin"], fleet["ctl"],
                          health_interval_s=0.1).roll()
    t.join()
    assert roll["status"] == "promoted", roll
    assert all(r["ok"] for r in roll["replicas"])
    assert load["n_ok"] == load["n_requests"] and load["errors"] == {}
    fp = str(pointer["params_fingerprint"])[:16]
    for a in fleet["admin"]:
        eng = _get(a + "/metrics")["engine"]
        assert eng["params_fingerprint"] == fp
        assert eng["steady_state_captures"] == 0
    # the answers are now v2's
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        InferenceEngine,
    )

    eng = InferenceEngine(fleet["v2"], macro_history=fleet["macro"],
                          stock_buckets=(64,), exec_cfg=CPU_F32)
    ref = eng.infer_one(_req(bodies[2], 2)).weights
    assert _post_raw(fleet["url"], bodies[2]) == ref.tobytes()


def test_replica_killed_under_load_loses_no_request(fleet):
    """SIGKILL replica0 in the middle of an open-loop load with retries:
    every request is answered (the survivor takes the retries), the
    supervisor restarts the replica once, and the new incarnation serves
    on the shared port with no capture after its warmup."""
    run_dir = fleet["run_dir"]
    pid0 = _replica_pid(run_dir, 0)
    assert pid0 is not None
    bodies = fleet["bodies"]
    load = {}

    def drive():
        load.update(run_loadgen(
            fleet["url"] + "/v1/weights", lambda i: bodies[i % len(bodies)],
            mode="open", rate_rps=60.0, n_requests=240, warmup_requests=0,
            retries=4, open_workers=16, content_type=BINARY_CONTENT_TYPE))

    t = threading.Thread(target=drive)
    t.start()
    time.sleep(1.0)
    os.kill(pid0, signal.SIGKILL)
    t.join()
    assert load["n_ok"] == load["n_requests"], load["errors"]
    deadline = time.monotonic() + 240
    while True:
        pid = _replica_pid(run_dir, 0)
        if pid not in (None, pid0) and _ready(run_dir, 2):
            break
        assert time.monotonic() < deadline, "replica0 was not restarted"
        time.sleep(0.2)
    rows = [json.loads(x) for x in (run_dir / "events.supervisor.replica0"
                                    ".jsonl").read_text().splitlines()]
    assert sum(r.get("name") == "supervise/restart" for r in rows) == 1
    admin0 = fleet["admin"][0]
    for body in bodies[:4]:
        _post_raw(admin0, body)
    m = _get(admin0 + "/metrics")
    assert m["replica"] == "replica0"
    assert m["engine"]["steady_state_captures"] == 0
    assert _get(admin0 + "/healthz")["ok"] is True


@pytest.mark.parametrize("replica_id,dies", [(0, True), (1, False)])
def test_replica_kill_site_targets_one_replica(tmp_path, monkeypatch,
                                               replica_id, dies):
    """A plan at ``serve/replica_kill`` matched on ``replica0`` fires on the
    first request of that replica only (a ``raise`` here: the connection
    dies unanswered, the next request is served), never on replica1."""
    from deeplearninginassetpricing_paperreplication_torch.reliability import (
        faults,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        AsyncServerThread,
        InferenceEngine,
        ServingService,
    )

    cfg = GANConfig(macro_feature_dim=M, individual_feature_dim=F,
                    hidden_dim=(8, 8), num_units_rnn=(4,))
    dirs = _make_member_dirs(tmp_path / "m", cfg, (1,))
    macro = np.random.default_rng(2).standard_normal((T, M))
    monkeypatch.setenv("DLAP_FAULT_PLAN", json.dumps([{
        "site": "serve/replica_kill", "action": "raise",
        "match": "replica0", "trigger_count": 1}]))
    faults.reset_injector()
    service = ServingService(
        InferenceEngine(dirs, macro_history=macro.astype(np.float32),
                        stock_buckets=(64,), exec_cfg=CPU_F32),
        mode="async", cache_size=0, replica_id=replica_id)
    server = AsyncServerThread(service)
    url = f"http://127.0.0.1:{server.start()}"
    body = binary_payload_bytes(np.ones((N, F), np.float32), 1)
    try:
        if dies:
            with pytest.raises((urllib.error.URLError, ConnectionError)):
                _post_raw(url, body)
        assert len(_post_raw(url, body)) == N * 4
        assert service.metrics()["replica"] == f"replica{replica_id}"
    finally:
        server.stop()
        service.close()
        faults.reset_injector()
