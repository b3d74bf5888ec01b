"""The port's three CLIs share one set of execution flags.

``train``, ``evaluate_ensemble``, ``sweep`` and ``serving.server`` each take
``--device``, ``--compute_dtype`` and ``--kernel auto|on|off`` through
``evaluate_ensemble.add_execution_args``, and ``execution_config`` turns
them into the ``ExecutionConfig`` the run uses: ``--kernel off`` is how a
user asks for the plain PyTorch route on a card.
"""

import pytest

from deeplearninginassetpricing_paperreplication_torch import (
    evaluate_ensemble,
    sweep,
    train,
)
from deeplearninginassetpricing_paperreplication_torch.serving import server
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
)

REQUIRED = {
    "train": (train.build_arg_parser, ["--data_dir", "d"]),
    "evaluate_ensemble": (evaluate_ensemble.build_arg_parser,
                          ["--data_dir", "d", "--checkpoint_dirs", "r"]),
    "server": (server.build_arg_parser, ["--checkpoint_dirs", "r"]),
    "sweep": (sweep.build_arg_parser, ["--data_dir", "d"]),
}


@pytest.mark.parametrize("cli", sorted(REQUIRED))
def test_kernel_flag_reaches_the_execution_config(cli):
    parser, required = REQUIRED[cli]
    args = parser().parse_args(required + ["--device", "cpu", "--kernel",
                                           "off"])
    assert evaluate_ensemble.execution_config(args) == ExecutionConfig(
        kernel="off", compute_dtype="bfloat16", device="cpu")
    args = parser().parse_args(required + ["--device", "cpu"])
    assert evaluate_ensemble.execution_config(args).kernel == "auto"


@pytest.mark.parametrize("cli", sorted(REQUIRED))
def test_kernel_flag_rejects_other_values(cli, capsys):
    parser, required = REQUIRED[cli]
    with pytest.raises(SystemExit) as e:
        parser().parse_args(required + ["--kernel", "fast"])
    assert e.value.code == 2
    assert "--kernel" in capsys.readouterr().err


# -- the train CLI's operational plane ----------------------------------------

TRAIN_ARGS = ["--epochs_unc", "4", "--epochs_moment", "2", "--epochs", "6",
              "--ignore_epoch", "1", "--hidden_dim", "8", "--rnn_dim", "4",
              "--num_moments", "4", "--print_freq", "100", "--device", "cpu",
              "--checkpoint_every", "2"]


def _run_dir(save):
    """(history arrays, final_model.pt bytes) of a finished run dir."""
    import numpy as np

    with np.load(save / "history.npz") as h:
        hist = {k: h[k] for k in h.files}
    return hist, (save / "final_model.pt").read_bytes()


def _assert_same_run(a, b):
    import numpy as np

    (ha, fa), (hb, fb) = a, b
    assert ha.keys() == hb.keys()
    for k in ha:
        np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    assert fa == fb


def test_train_cli_accepts_every_jax_train_flag():
    """Every flag of the JAX train CLI but --share_sdf_program (no XLA
    program bodies to share) and --pallas (the port's --kernel)."""
    from deeplearninginassetpricing_paperreplication_tpu import train as jtrain

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    missing = flags(jtrain.build_arg_parser()) - flags(
        train.build_arg_parser())
    assert missing == {"--share_sdf_program", "--pallas"}
    args = train.build_arg_parser().parse_args(["--data_dir", "d"])
    assert (args.use_lstm, args.rnn_dim_moment, args.save_best_freq,
            args.divergence_guard, args.guard_max_trips) == (
        True, [32], 128, True, 3)
    args = train.build_arg_parser().parse_args(
        ["--data_dir", "d", "--no_lstm", "--no_divergence_guard"])
    assert not args.use_lstm and not args.divergence_guard


def test_train_cli_stop_then_resume_gives_the_uninterrupted_bytes(
        synthetic_dir, tmp_path):
    """--stop_after_epochs leaves a resumable state and no
    final_metrics.json; --resume finishes with the uninterrupted run's
    history.npz and final_model.pt. The uninterrupted run also carries the
    telemetry: metrics.jsonl, heartbeat.json with device_memory,
    manifest.json with kernel_programs, events.jsonl with
    epochs_dispatched, and a --profile trace."""
    import json

    full, run, prof = tmp_path / "full", tmp_path / "run", tmp_path / "prof"
    base = ["--data_dir", str(synthetic_dir)] + TRAIN_ARGS
    train.main(base + ["--save_dir", str(full), "--profile", str(prof)])
    train.main(base + ["--save_dir", str(run), "--stop_after_epochs", "5"])
    assert not (run / "final_metrics.json").exists()
    assert (run / "resume_state.pt").exists()
    hb = json.loads((run / "heartbeat.json").read_text())
    assert hb["heartbeat"]["section"] == "stopped"
    train.main(base + ["--save_dir", str(run), "--resume"])
    _assert_same_run(_run_dir(full), _run_dir(run))
    assert not list(run.glob("resume_*"))
    for save in (full, run):
        assert len((save / "metrics.jsonl").read_text().splitlines()) == 12
    hb = json.loads((full / "heartbeat.json").read_text())
    assert hb["heartbeat"]["section"] == "finalize"
    assert hb["device_memory"] == {"n_devices": 0, "totals": {}}
    manifest = json.loads((full / "manifest.json").read_text())
    assert manifest["kernel_programs"] == {}  # the CPU plans no kernel
    assert manifest["reference_profile"] == "reference_profile.json"
    rows = [json.loads(x) for x in
            (full / "events.jsonl").read_text().splitlines()]
    assert sum(r["value"] for r in rows
               if r["name"] == "epochs_dispatched") == 12
    assert any(r["kind"] == "memory" for r in rows)
    assert train.profile_trace_nonempty(prof)
    metrics = json.loads((full / "final_metrics.json").read_text())
    assert {"epoch_ms", "phase_execute_seconds", "device_memory",
            "startup"} <= set(metrics)


def test_train_cli_no_lstm(synthetic_dir, tmp_path):
    import json

    save = tmp_path / "run"
    train.main(["--data_dir", str(synthetic_dir), "--save_dir", str(save),
                "--no_lstm", "--rnn_dim_moment", "16"] + TRAIN_ARGS)
    cfg = json.loads((save / "config.json").read_text())
    assert cfg["use_rnn"] is False and cfg["num_units_rnn_moment"] == [16]
    assert (save / "final_model.pt").exists()


def test_train_cli_guard_trip_lands_in_the_run_dir(synthetic_dir, tmp_path,
                                                   monkeypatch):
    import json

    import numpy as np

    from deeplearninginassetpricing_paperreplication_torch.reliability import (
        faults,
    )

    monkeypatch.setenv(faults.ENV_PLAN, json.dumps(
        [{"site": "trainer/epoch_loop", "action": "nan_loss",
          "trigger_count": 2}]))
    faults.reset_injector()
    save = tmp_path / "run"
    try:
        train.main(["--data_dir", str(synthetic_dir), "--save_dir",
                    str(save)] + TRAIN_ARGS)
    finally:
        monkeypatch.delenv(faults.ENV_PLAN)
        faults.reset_injector()
    rows = [json.loads(x) for x in
            (save / "events.jsonl").read_text().splitlines()]
    assert [(r["phase"], r["start_epoch"], r["end_epoch"]) for r in rows
            if r["name"] == "guard/trip"] == [("phase1_unconditional", 2, 4)]
    with np.load(save / "history.npz") as h:
        assert h["divergence_trips"].tolist() == [[1.0, 2.0, 4.0]]
    assert json.loads((save / "health.json").read_text())["guard_trips"] == 1


def test_train_cli_killed_then_resumed_in_subprocesses(synthetic_dir,
                                                       tmp_path):
    """A kill plan at the third segment (inside phase 2) SIGKILLs the
    child (-9); a second child with --resume leaves the bytes of an
    uninterrupted child."""
    import json
    import os
    import subprocess
    import sys

    base = [sys.executable, "-m",
            "deeplearninginassetpricing_paperreplication_torch.train",
            "--data_dir", str(synthetic_dir)] + TRAIN_ARGS
    env = {k: v for k, v in os.environ.items() if k != "DLAP_FAULT_PLAN"}
    full, run = tmp_path / "full", tmp_path / "run"

    def child(save, *extra, plan=None):
        e = dict(env, DLAP_FAULT_PLAN=json.dumps(plan)) if plan else env
        return subprocess.run(base + ["--save_dir", str(save), *extra],
                              env=e, capture_output=True, text=True,
                              timeout=300)

    assert child(full).returncode == 0
    killed = child(run, plan=[{"site": "trainer/epoch_loop",
                               "trigger_count": 3, "action": "kill"}])
    assert killed.returncode == -9, killed.stderr
    meta = json.loads((run / "resume_meta.json").read_text())
    assert (meta["completed_phase"], meta["in_phase"]) == (1, 0)
    resumed = child(run, "--resume")
    assert resumed.returncode == 0, resumed.stderr
    _assert_same_run(_run_dir(full), _run_dir(run))
    assert len((run / "metrics.jsonl").read_text().splitlines()) == 12
