"""The port's supervisor (``reliability/supervisor.py``) on the CPU.

The supervisor cases of ``tests/test_reliability.py`` against the port's
copy, with stdlib stub children (``python -S``: no site packages, so
neither torch nor JAX can load in them):

  * the restart backoff equals the JAX ``RestartPolicy``'s for the same
    ``rng``;
  * resume detection on the port's trainer files (``resume_state.pt``,
    ``resume_meta.json`` and their ``.g1`` generations) → ``--resume``,
    and on a sweep ledger (``sweep_ledger/queue.json``) →
    ``--resume-from-ledger``;
  * a restart appends ``--resume`` and attributes the death to the last
    heartbeat section; no flag is appended without a state, nor with
    ``--no_auto_resume``;
  * a child whose heartbeat goes stale is SIGKILLed (its process group);
  * crash-loop detection;
  * the supervisor runs as a thin script, without torch.

Heartbeat timeouts are a few seconds; backoffs tens of milliseconds.
"""

import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from deeplearninginassetpricing_paperreplication_torch.observability.events \
    import EventLog
from deeplearninginassetpricing_paperreplication_torch.reliability.supervisor \
    import RestartPolicy, Supervisor, build_arg_parser
from deeplearninginassetpricing_paperreplication_tpu.reliability import (
    supervisor as jsupervisor,
)

REPO = Path(__file__).resolve().parents[1]
PKG = "deeplearninginassetpricing_paperreplication_torch"

STUB_PRELUDE = """
import json, os, sys, time
run_dir = sys.argv[1]
def beat(section):
    path = os.path.join(run_dir, "heartbeat.json")
    tmp = path + ".tmp"
    try:
        with open(path) as f:
            state = json.load(f)
    except Exception:
        state = {}
    state["heartbeat"] = {"section": section, "ts": time.time()}
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)
def bump(name):
    path = os.path.join(run_dir, name)
    n = int(open(path).read()) if os.path.exists(path) else 0
    with open(path, "w") as f:
        f.write(str(n + 1))
    return n + 1
def argv_log(spawn):
    with open(os.path.join(run_dir, f"argv.{spawn}"), "w") as f:
        json.dump(sys.argv[2:], f)
"""


def _stub(tmp_path, body, name="child.py"):
    script = tmp_path / name
    script.write_text(STUB_PRELUDE + textwrap.dedent(body))
    return [sys.executable, "-S", str(script), str(tmp_path)]


def _policy(**kw):
    kw.setdefault("heartbeat_timeout_s", 2.0)
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("max_restarts", 3)
    kw.setdefault("min_uptime_s", 30.0)  # stub deaths are always "fast"
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("backoff_max_s", 0.1)
    kw.setdefault("jitter_frac", 0.0)
    return RestartPolicy(**kw)


def _argv(tmp_path, spawn):
    return json.loads((tmp_path / f"argv.{spawn}").read_text())


@pytest.mark.parametrize("failures", [0, 1, 2, 3, 7, 12])
@pytest.mark.parametrize("u", [0.0, 0.37, 0.999])
def test_backoff_equals_the_jax_policy(failures, u):
    kw = dict(backoff_base_s=1.5, backoff_max_s=40.0, jitter_frac=0.3)
    ours = RestartPolicy(**kw).backoff_s(failures, rng=lambda: u)
    theirs = jsupervisor.RestartPolicy(**kw).backoff_s(failures,
                                                       rng=lambda: u)
    assert ours == theirs
    assert RestartPolicy().backoff_s(failures, rng=lambda: u) == \
        jsupervisor.RestartPolicy().backoff_s(failures, rng=lambda: u)


def test_policy_defaults_are_the_jax_policys():
    import dataclasses

    assert (dataclasses.asdict(RestartPolicy())
            == dataclasses.asdict(jsupervisor.RestartPolicy()))


@pytest.mark.parametrize("files,flag", [
    ((), None),
    (("resume_state.pt",), "--resume"),
    (("resume_meta.json",), "--resume"),
    (("resume_state.pt.g1",), "--resume"),
    (("resume_meta.json.g1", "resume_state.pt.g1"), "--resume"),
    (("resume_state.msgpack",), "--resume"),
    (("sweep_ledger/queue.json",), "--resume-from-ledger"),
    # a trainer state wins over a ledger
    (("sweep_ledger/queue.json", "resume_state.pt"), "--resume"),
    # neighbours that are no resume state
    (("resume_state.pt.sha256", "final_model.pt", "sweep_ledger/x.json"),
     None),
])
def test_resume_detection_on_the_port_files(tmp_path, files, flag):
    for name in files:
        p = tmp_path / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    sup = Supervisor(["true"], tmp_path / "heartbeat.json",
                     policy=_policy())
    assert sup._detect_resume_flag() == flag


def _events_rows(tmp_path):
    p = tmp_path / "events.supervisor.jsonl"
    return [json.loads(x) for x in p.read_text().splitlines()]


def test_restart_appends_resume_and_attributes_death(tmp_path):
    """Crash once in a named phase after writing the port's resume state:
    the respawn carries --resume, the death is attributed to the last
    heartbeat's section, and telemetry records it."""
    cmd = _stub(tmp_path, """
    spawn = bump("spawns")
    argv_log(spawn)
    if spawn == 1:
        beat("phase3_conditional")
        # what the port's train CLI leaves mid-run: the state's newest
        # generation rotated to .g1 beside the current pair
        open(os.path.join(run_dir, "resume_state.pt.g1"), "w").write("x")
        sys.exit(3)
    beat("finalize")
    sys.exit(0)
    """)
    events = EventLog(tmp_path, process_index=0,
                      filename="events.supervisor.jsonl")
    summary = Supervisor(cmd, tmp_path / "heartbeat.json", policy=_policy(),
                         events=events).run()
    events.close()
    assert summary["outcome"] == "success" and summary["restarts"] == 1
    assert summary["deaths"] == [{
        "section": "phase3_conditional", "rc": 3, "hang": False,
        "uptime_s": summary["deaths"][0]["uptime_s"], "attempt": 1,
    }]
    assert _argv(tmp_path, 1) == [] and _argv(tmp_path, 2) == ["--resume"]
    rows = _events_rows(tmp_path)
    death = [r for r in rows if r.get("name") == "supervise/death"]
    assert len(death) == 1 and death[0]["section"] == "phase3_conditional"
    restart = [r for r in rows if r.get("name") == "supervise/restart"]
    assert len(restart) == 1 and restart[0]["rc"] == 3
    outcome = [r for r in rows if r.get("name") == "supervise/outcome"]
    assert outcome[-1]["outcome"] == "success"
    # the dead child's heartbeat is dropped before the respawn
    assert json.loads((tmp_path / "heartbeat.json").read_text())[
        "heartbeat"]["section"] == "finalize"


def test_never_appends_resume_without_a_state(tmp_path):
    """A child that writes no resume state (the serving server) restarts
    with its ORIGINAL argv."""
    cmd = _stub(tmp_path, """
    spawn = bump("spawns")
    argv_log(spawn)
    beat("serve")
    sys.exit(0 if spawn > 1 else 3)
    """)
    sup = Supervisor(cmd, tmp_path / "heartbeat.json", policy=_policy())
    assert sup.run()["outcome"] == "success"
    assert _argv(tmp_path, 2) == []


def test_no_auto_resume_wins_over_a_state(tmp_path):
    cmd = _stub(tmp_path, """
    spawn = bump("spawns")
    argv_log(spawn)
    open(os.path.join(run_dir, "resume_meta.json"), "w").write("{}")
    beat("setup")
    sys.exit(0 if spawn > 1 else 3)
    """)
    sup = Supervisor(cmd, tmp_path / "heartbeat.json",
                     policy=_policy(auto_resume=False))
    assert sup.run()["outcome"] == "success"
    assert _argv(tmp_path, 2) == []


def test_sigkills_a_hang_on_a_stale_heartbeat(tmp_path):
    """A child that stops beating (a hung call) is SIGKILLed with its
    process group — a grandchild too — and the hang is attributed to the
    last section."""
    cmd = _stub(tmp_path, """
    spawn = bump("spawns")
    if spawn == 1:
        import subprocess
        beat("sweep_bucket")
        g = subprocess.Popen([sys.executable, "-S", "-c",
                              "import time; time.sleep(600)"])
        open(os.path.join(run_dir, "grandchild"), "w").write(str(g.pid))
        time.sleep(600)
    beat("finalize")
    sys.exit(0)
    """)
    t0 = time.time()
    summary = Supervisor(cmd, tmp_path / "heartbeat.json",
                         policy=_policy(heartbeat_timeout_s=4.0)).run()
    assert time.time() - t0 < 40, "a hang must be killed, not waited out"
    assert summary["outcome"] == "success" and summary["hang_kills"] == 1
    assert summary["deaths"][0]["section"] == "sweep_bucket"
    assert summary["deaths"][0]["hang"] is True
    assert summary["deaths"][0]["rc"] == -9
    pid = int((tmp_path / "grandchild").read_text())
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
        except OSError:
            break  # reaped: gone
        if stat.split(")")[-1].split()[0] == "Z":
            break  # killed, awaiting its reaper
        time.sleep(0.05)
    else:
        pytest.fail("the hung child's process group survived")


def test_declares_a_crash_loop(tmp_path):
    cmd = _stub(tmp_path, """
    bump("spawns")
    beat("setup")
    sys.exit(3)
    """)
    summary = Supervisor(cmd, tmp_path / "heartbeat.json",
                         policy=_policy(max_restarts=3)).run()
    assert summary["outcome"] == "crash-loop" and summary["returncode"] == 3
    # 3 consecutive fast deaths → exactly 3 spawns, 2 restarts
    assert int((tmp_path / "spawns").read_text()) == 3
    assert summary["restarts"] == 2


def test_runs_as_a_thin_script_without_torch(tmp_path):
    """Executing reliability/supervisor.py directly (no package import,
    ``python -S``: no site packages, so torch cannot even load) supervises
    a child end to end and defaults the fault state and events files into
    the run dir when a plan is set."""
    child = _stub(tmp_path, """
    import os
    assert os.environ["DLAP_FAULT_STATE"].endswith("fault_state.json")
    beat("finalize")
    sys.exit(0)
    """)
    env = {"DLAP_FAULT_PLAN": json.dumps(
        [{"site": "sweep/bucket", "action": "raise"}]), "PATH": "/usr/bin"}
    out = subprocess.run(
        [sys.executable, "-S",
         str(REPO / PKG / "reliability" / "supervisor.py"),
         "--run_dir", str(tmp_path), "--poll", "0.05", "--"] + child,
        capture_output=True, text=True, timeout=60, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["outcome"] == "success"
    rows = _events_rows(tmp_path)
    assert [r["outcome"] for r in rows
            if r.get("name") == "supervise/outcome"] == ["success"]


def test_cli_takes_the_jax_supervise_flags():
    def flags(parser):
        return {a.dest for a in parser._actions} - {"help"}

    assert flags(build_arg_parser()) == flags(jsupervisor.build_arg_parser())


def test_cli_refuses_an_empty_command(tmp_path, capsys):
    from deeplearninginassetpricing_paperreplication_torch.reliability \
        .supervisor import main

    assert main(["--run_dir", str(tmp_path), "--"]) == 2
    assert "no child command" in capsys.readouterr().err
