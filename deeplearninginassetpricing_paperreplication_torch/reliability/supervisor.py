"""Supervised execution: spawn an entrypoint, watch its heartbeat, restart it.

The port's copy of the JAX package's ``reliability/supervisor.py``. It
supervises ANY entrypoint that writes the heartbeat file
(``observability/heartbeat.py``: the train CLI, the sweep CLI and each of
its elastic workers, the serving server):

  * **hang detection** — the child's heartbeat file goes stale past
    ``heartbeat_timeout_s`` → SIGKILL the child's whole process group, and
    attribute the hang to the section the last beat named;
  * **death attribution** — any death mode (raise, OOM-kill, hang) is
    attributed to the last heartbeat section, logged as a
    ``supervise/restart`` counter in ``events.supervisor.jsonl``;
  * **restart policy** — exponential backoff with jitter; a restart appends
    the resume flag matching the state the run dir holds: ``--resume``
    for a trainer resume state (the port's ``resume_state.pt`` /
    ``resume_meta.json`` and their ``.g1`` generations; the JAX
    package's ``resume_state.msgpack`` too), ``--resume-from-ledger`` for
    a sweep bucket ledger (``sweep_ledger/queue.json``), so the child
    continues from its last verified checkpoint — or last completed
    bucket — instead of from scratch (children that write neither, e.g.
    the serving server, restart with their original argv);
  * **crash-loop detection** — a child that dies within ``min_uptime_s`` of
    spawn counts as a fast death; ``max_restarts`` CONSECUTIVE fast deaths
    end the run with outcome ``crash-loop`` (a child that survives past
    ``min_uptime_s`` resets the counter — it made progress).

CLI: ``python -m deeplearninginassetpricing_paperreplication_torch.supervise
--run_dir DIR -- python -m ...train --data_dir ... --save_dir DIR``.

Module level stays stdlib-only, and the supervisor never imports torch:
run as ``python .../reliability/supervisor.py`` it loads its
dependencies by path, so it stays up when the child's stack is wedged.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

try:
    from ..observability.events import EventLog
    from ..observability.heartbeat import read_state, staleness_s, write_state
    from ..observability.metrics import MetricsSidecar
    from .faults import ENV_EVENTS, ENV_PLAN, ENV_STATE
except ImportError:
    # Loaded OUTSIDE the package — by path, or executed directly as
    # `python .../reliability/supervisor.py` (the thin, cannot-hang entry
    # for when the child's stack itself is wedged). The four dependencies
    # are stdlib-only at module level by contract, so they path-load.
    import importlib.util as _ilu
    from pathlib import Path as _P

    def _load_by_path(name, path):
        spec = _ilu.spec_from_file_location(name, path)
        mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _here = _P(__file__).resolve().parent
    _hb = _load_by_path("_dlap_heartbeat", _here.parent / "observability" / "heartbeat.py")
    _ev = _load_by_path("_dlap_events", _here.parent / "observability" / "events.py")
    _mx = _load_by_path("_dlap_metrics_sidecar",
                        _here.parent / "observability" / "metrics.py")
    _fa = _load_by_path("_dlap_faults", _here / "faults.py")
    EventLog = _ev.EventLog
    MetricsSidecar = _mx.MetricsSidecar
    read_state, staleness_s, write_state = (
        _hb.read_state, _hb.staleness_s, _hb.write_state)
    ENV_EVENTS, ENV_PLAN, ENV_STATE = _fa.ENV_EVENTS, _fa.ENV_PLAN, _fa.ENV_STATE

SUPERVISOR_EVENTS_FILENAME = "events.supervisor.jsonl"
# a trainer resume state in a run dir, any generation: the port's pair and
# the JAX package's state file
RESUME_STATE_FILES = ("resume_meta.json", "resume_state.pt",
                      "resume_state.msgpack")


@dataclasses.dataclass
class RestartPolicy:
    """Everything the supervise loop decides from."""

    heartbeat_timeout_s: float = 300.0
    poll_s: float = 2.0
    max_restarts: int = 5          # consecutive fast deaths → crash-loop
    min_uptime_s: float = 60.0     # uptime that counts as progress
    max_total_restarts: int = 50   # absolute cap (slow-death loops)
    backoff_base_s: float = 5.0
    backoff_max_s: float = 300.0
    jitter_frac: float = 0.2
    auto_resume: bool = True
    resume_flag: str = "--resume"
    # sweep semantics: a restarted sweep child resumes from its bucket
    # LEDGER (reliability/ledger.py), not a trainer checkpoint — detected
    # by the run dir holding sweep_ledger/queue.json
    ledger_resume_flag: str = "--resume-from-ledger"
    # pre-kill flare: send this signal (e.g. SIGUSR1) to the child's
    # process group and wait prekill_grace_s BEFORE the SIGKILL on a stale
    # heartbeat — a handler in the child can write its last words in the
    # grace window. None (the default) keeps the
    # immediate-SIGKILL behavior for children that install no handler
    # (SIGUSR1's default disposition would just kill them earlier).
    prekill_signal: Optional[int] = None
    prekill_grace_s: float = 0.75

    def backoff_s(self, consecutive_failures: int, rng=random.random) -> float:
        base = min(
            self.backoff_max_s,
            self.backoff_base_s * (2 ** max(0, consecutive_failures - 1)),
        )
        return base * (1.0 + self.jitter_frac * rng())


def kill_process_group(proc: subprocess.Popen, wait_s: float = 30.0) -> None:
    """SIGKILL the child's whole process group (a process wedged in a
    device call may never act on SIGTERM)."""
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        proc.wait(timeout=wait_s)
    except subprocess.TimeoutExpired:
        pass


class Supervisor:
    """One supervised child command + its restart loop."""

    def __init__(
        self,
        cmd: Sequence[str],
        heartbeat_path: Path,
        policy: Optional[RestartPolicy] = None,
        events: Optional[EventLog] = None,
        log_path: Optional[Path] = None,
        env: Optional[Dict[str, str]] = None,
    ):
        self.cmd = list(cmd)
        self.heartbeat_path = Path(heartbeat_path)
        self.policy = policy if policy is not None else RestartPolicy()
        # process_index pinned to 0: the supervisor is no rank of the
        # child's process group, whatever RANK its environment holds
        self.events = events if events is not None else EventLog(
            process_index=0)
        self.log_path = Path(log_path) if log_path else None
        self.env = env
        self._proc: Optional[subprocess.Popen] = None
        self._stop_requested = False

    # -- public ---------------------------------------------------------------

    def request_stop(self) -> None:
        """Signal-handler hook: kill the child and end the loop."""
        self._stop_requested = True
        if self._proc is not None and self._proc.poll() is None:
            kill_process_group(self._proc)

    @property
    def child_pid(self) -> Optional[int]:
        """The LIVE child's pid (None between incarnations or after
        exit) — detection drills signal the child directly (SIGKILL /
        SIGSTOP) without going through the restart loop."""
        proc = self._proc
        if proc is not None and proc.poll() is None:
            return proc.pid
        return None

    def run(self) -> Dict[str, Any]:
        """Supervise until success, crash-loop, restart exhaustion, or an
        external stop. Returns the summary dict (also logged as the
        ``supervise/outcome`` counter)."""
        pol = self.policy
        summary: Dict[str, Any] = {
            "outcome": None, "returncode": None,
            "restarts": 0, "hang_kills": 0, "deaths": [],
        }
        fast_deaths = 0
        attempt = 0
        log_f = open(self.log_path, "ab") if self.log_path else subprocess.DEVNULL
        try:
            while not self._stop_requested:
                attempt += 1
                child_cmd = list(self.cmd)
                resumed = False
                if attempt > 1 and pol.auto_resume:
                    # continue from the last verified state, not scratch —
                    # ONLY when the run dir actually holds one, and with
                    # the flag that matches its KIND: a trainer resume
                    # state gets --resume, a sweep bucket ledger gets
                    # --resume-from-ledger. Blindly appending a flag would
                    # crash-loop children that don't take it (the serving
                    # server restarts with its original argv).
                    flag = self._detect_resume_flag()
                    if flag and flag not in child_cmd:
                        child_cmd.append(flag)
                        resumed = True
                with self.events.span("supervise/child", attempt=attempt,
                                      resumed=resumed):
                    rc, died_in, hang, uptime = self._run_child(
                        child_cmd, log_f)
                summary["returncode"] = rc
                if self._stop_requested:
                    summary["outcome"] = "stopped"
                    break
                if rc == 0:
                    summary["outcome"] = "success"
                    break
                death = {"section": died_in, "rc": rc, "hang": hang,
                         "uptime_s": round(uptime, 3), "attempt": attempt}
                summary["deaths"].append(death)
                summary["hang_kills"] += int(hang)
                # every death gets a counter (section attribution); the
                # restart counter fires only when a restart actually follows,
                # so the report's restart total matches summary["restarts"]
                self.events.counter("supervise/death", section=died_in,
                                    rc=rc, hang=hang, attempt=attempt,
                                    uptime_s=round(uptime, 3))
                fast_deaths = (fast_deaths + 1
                               if uptime < pol.min_uptime_s else 0)
                if fast_deaths >= pol.max_restarts:
                    summary["outcome"] = "crash-loop"
                    break
                if summary["restarts"] >= pol.max_total_restarts:
                    summary["outcome"] = "restarts-exhausted"
                    break
                summary["restarts"] += 1
                self.events.counter("supervise/restart", section=died_in,
                                    rc=rc, hang=hang, attempt=attempt)
                delay = pol.backoff_s(max(fast_deaths, 1))
                self.events.log(
                    f"child died in {died_in} (rc={rc}, hang={hang}); "
                    f"restart {summary['restarts']} in {delay:.1f}s",
                    level="warning",
                )
                print(f"[supervise] child died in {died_in} (rc={rc}, "
                      f"hang={hang}); restart {summary['restarts']} in "
                      f"{delay:.1f}s", file=sys.stderr, flush=True)
                self._interruptible_sleep(delay)
            if summary["outcome"] is None:
                summary["outcome"] = "stopped"
        finally:
            if log_f is not subprocess.DEVNULL:
                log_f.close()
        self.events.counter(
            "supervise/outcome", outcome=summary["outcome"],
            restarts=summary["restarts"], hang_kills=summary["hang_kills"],
            returncode=summary["returncode"],
        )
        return summary

    def _resumable_state_exists(self) -> bool:
        """Does the run dir hold a trainer resume state (any generation)?
        The port's trainer writes ``resume_state.pt`` + ``resume_meta.json``
        (``training/trainer.py``, ``.g1`` kept on rewrite); the JAX
        package's writes ``resume_state.msgpack``. Name literals, checked
        without importing the checkpoint layer: the supervisor stays thin."""
        run_dir = self.heartbeat_path.parent
        for name in RESUME_STATE_FILES:
            base = run_dir / name
            if base.exists() or any(
                    run_dir.glob(name + ".g[0-9]")):
                return True
        return False

    def _sweep_ledger_exists(self) -> bool:
        """Does the run dir hold a sweep bucket ledger (reliability/
        ledger.py)? Its queue manifest is the marker — a restarted sweep
        child can then reconstruct all completed work from records. Name
        literals, not ledger imports: the supervisor stays path-loadable."""
        return (self.heartbeat_path.parent / "sweep_ledger"
                / "queue.json").exists()

    def _detect_resume_flag(self) -> Optional[str]:
        """The resume flag matching the KIND of state the run dir holds
        (trainer checkpoint wins — a sweep run dir never holds one at its
        root), or None when the child must restart from scratch."""
        if self._resumable_state_exists():
            return self.policy.resume_flag
        if self._sweep_ledger_exists():
            return self.policy.ledger_resume_flag
        return None

    def _interruptible_sleep(self, delay: float) -> None:
        """Backoff sleep that a stop request (SIGTERM/SIGINT handler) cuts
        short — a plain time.sleep resumes after the handler returns (PEP
        475) and would stall shutdown for up to backoff_max_s."""
        deadline = time.time() + delay
        while not self._stop_requested:
            remaining = deadline - time.time()
            if remaining <= 0:
                return
            time.sleep(min(0.2, remaining))

    # -- one child lifetime ---------------------------------------------------

    def _run_child(self, child_cmd: List[str], log_f):
        """Spawn, watch the heartbeat, kill on staleness. Returns
        (rc, died_in_section, hang_killed, uptime_s)."""
        pol = self.policy
        self._proc = proc = subprocess.Popen(
            child_cmd,
            stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True,  # own pgid → killpg reaches threads
            env=self.env,
        )
        spawn_ts = time.time()
        hang_killed = False
        while proc.poll() is None:
            if self._stop_requested:
                kill_process_group(proc)
                break
            state = read_state(self.heartbeat_path)
            if staleness_s(state, floor_ts=spawn_ts) > pol.heartbeat_timeout_s:
                hang_killed = True
                if pol.prekill_signal is not None:
                    # the flare: one grace window for last words (flight-
                    # recorder dump) before the SIGKILL that cannot be
                    # caught; a child that is too wedged to handle it
                    # just dies prekill_grace_s later than before
                    try:
                        os.killpg(os.getpgid(proc.pid), pol.prekill_signal)
                    except (ProcessLookupError, PermissionError):
                        pass
                    else:
                        time.sleep(pol.prekill_grace_s)
                kill_process_group(proc)
                break
            time.sleep(pol.poll_s)
        uptime = time.time() - spawn_ts
        state = read_state(self.heartbeat_path)
        died_in = (state.get("heartbeat") or {}).get("section", "setup")
        if proc.returncode != 0:
            # drop the dead child's heartbeat: the respawn needs its startup
            # window before it can write one, and a stale section would
            # corrupt both the hang timer and the next death's attribution
            state.pop("heartbeat", None)
            try:
                write_state(self.heartbeat_path, state)
            except OSError:
                pass
        self._proc = None
        return proc.returncode, died_in, hang_killed, uptime


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=("python -m deeplearninginassetpricing_paperreplication_torch"
              ".supervise"),
        description="Run any heartbeat-writing entrypoint under supervision: "
                    "hang detection (SIGKILL on stale heartbeat), restart "
                    "with backoff + automatic --resume, crash-loop policy, "
                    "supervise/* telemetry into events.supervisor.jsonl",
    )
    p.add_argument("--run_dir", required=True,
                   help="The child's run directory: heartbeat.json is "
                        "watched here, events.supervisor.jsonl and the child "
                        "log are written here (point the child's --save_dir "
                        "at the same directory)")
    p.add_argument("--timeout", type=float, default=300.0, metavar="S",
                   help="Heartbeat staleness that counts as a hang")
    p.add_argument("--poll", type=float, default=2.0, metavar="S")
    p.add_argument("--max_restarts", type=int, default=5,
                   help="Consecutive fast deaths before declaring a "
                        "crash-loop")
    p.add_argument("--min_uptime", type=float, default=60.0, metavar="S",
                   help="Uptime under which a death counts toward the "
                        "crash-loop counter")
    p.add_argument("--max_total_restarts", type=int, default=50)
    p.add_argument("--backoff", type=float, default=5.0, metavar="S")
    p.add_argument("--backoff_max", type=float, default=300.0, metavar="S")
    p.add_argument("--jitter", type=float, default=0.2)
    p.add_argument("--no_auto_resume", action="store_false",
                   dest="auto_resume",
                   help="Do not append --resume to restarted children")
    p.add_argument("--log", type=str, default=None,
                   help="Child stdout/stderr log (default: "
                        "RUN_DIR/supervised.log)")
    p.add_argument("--metrics_port", type=int, default=None, metavar="PORT",
                   help="Serve the supervisor's live restart/death/hang "
                        "counters as Prometheus text on "
                        "http://127.0.0.1:PORT/metrics (read-only stdlib "
                        "sidecar; port 0 picks a free one)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="The child command, after a literal '--'")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    cmd = list(args.command)
    if cmd[:1] == ["--"]:
        cmd = cmd[1:]
    if not cmd:
        print("supervise: no child command given (append it after '--')",
              file=sys.stderr)
        return 2
    run_dir = Path(args.run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)

    # fault-plan plumbing: when a plan is set but no state/event files are,
    # default them into the run dir — WITHOUT persistent counter state a
    # `kill` fault would re-fire on every restart and the supervised run
    # could never complete
    env = dict(os.environ)
    if env.get(ENV_PLAN):
        env.setdefault(ENV_STATE, str(run_dir / "fault_state.json"))
        env.setdefault(ENV_EVENTS, str(run_dir / "events.faults.jsonl"))

    events = EventLog(run_dir, process_index=0,
                      filename=SUPERVISOR_EVENTS_FILENAME)
    sidecar = None
    if args.metrics_port is not None:
        sidecar = MetricsSidecar([events.metrics], port=args.metrics_port)
        port = sidecar.start()
        print(f"[supervise] metrics sidecar: "
              f"http://127.0.0.1:{port}/metrics", file=sys.stderr,
              flush=True)
    policy = RestartPolicy(
        heartbeat_timeout_s=args.timeout,
        poll_s=args.poll,
        max_restarts=args.max_restarts,
        min_uptime_s=args.min_uptime,
        max_total_restarts=args.max_total_restarts,
        backoff_base_s=args.backoff,
        backoff_max_s=args.backoff_max,
        jitter_frac=args.jitter,
        auto_resume=args.auto_resume,
    )
    sup = Supervisor(
        cmd,
        heartbeat_path=run_dir / "heartbeat.json",
        policy=policy,
        events=events,
        log_path=Path(args.log) if args.log else run_dir / "supervised.log",
        env=env,
    )

    def _on_signal(signum, frame):  # noqa: ARG001 — signal-handler shape
        sup.request_stop()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    summary = sup.run()
    if sidecar is not None:
        sidecar.stop()
    events.close()
    print(json.dumps(summary))
    if summary["outcome"] == "success":
        return 0
    rc = summary.get("returncode")
    return rc if isinstance(rc, int) and rc > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
