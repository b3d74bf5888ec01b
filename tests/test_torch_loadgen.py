"""The port's load generator against the JAX package's, on the CPU: the
payload encoders give the same bytes, ``_percentiles`` the same values,
and on the same stub server both generators account a mid-run rate swing
of mixed-priority traffic the same way (steps, per-class drops and sheds,
errors); retries reuse one trace id on a fresh connection. Then the port's
own bench pieces: the seeded member dirs (verified, served by the engine),
``bench_serving``, ``bench_tracing_overhead`` and the CLI.
"""

import json
import socket
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from deeplearninginassetpricing_paperreplication_torch.serving import (
    loadgen as p_lg,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    loadgen as j_lg,
)

REPO = Path(__file__).resolve().parents[1]
PKG = "deeplearninginassetpricing_paperreplication_torch"


@pytest.mark.parametrize("shape,month", [((64, 10), 0), ((500, 46), 7),
                                         ((1, 3), -1)])
def test_payload_encoders_same_bytes(shape, month):
    a = np.random.default_rng(sum(shape)).standard_normal(shape)
    assert p_lg.binary_payload_bytes(a, month) == \
        j_lg.binary_payload_bytes(a, month)
    for b64 in (True, False):
        assert p_lg.compact_payload_bytes(a, month, b64) == \
            j_lg.compact_payload_bytes(a, month, b64)


@pytest.mark.parametrize("n", [0, 1, 7, 100, 4096])
def test_percentiles_equal_the_jax_loadgen(n):
    lat = list(np.random.default_rng(n).exponential(0.01, n))
    assert p_lg._percentiles(lat) == j_lg._percentiles(lat)


def _stub(shed_bulk=True, drop_first=0):
    """A keep-alive HTTP/1.1 stub: 429 for every bulk request, 200 for the
    rest; the first ``drop_first`` requests have their connection closed
    unanswered (a replica dying mid-request)."""
    seen = {"bulk": 0, "interactive": 0, "traces": [], "dropped": 0}
    lock = threading.Lock()

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            self.rfile.read(n)
            pr = self.headers.get("x-dlap-priority") or "interactive"
            with lock:
                seen[pr] += 1
                seen["traces"].append(self.headers.get("traceparent"))
                drop = seen["dropped"] < drop_first
                seen["dropped"] += drop
            if drop:
                self.close_connection = True
                self.connection.shutdown(socket.SHUT_RDWR)
                return
            if pr == "bulk" and shed_bulk:
                body = b'{"error": "shed", "reason": "bulk_shed"}'
                self.send_response(429)
                self.send_header("Retry-After", "1")
            else:
                body = b'{"ok": true}'
                self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, seen, \
        f"http://127.0.0.1:{httpd.server_address[1]}/v1/weights"


def _swing_accounting(mod):
    httpd, seen, url = _stub()
    try:
        out = mod.run_ladder(
            url, {"x": 1}, rates=[20.0, 200.0, 20.0],
            durations=[0.5, 0.5, 0.5],
            class_of=lambda i: "bulk" if i % 5 == 0 else "interactive")
    finally:
        httpd.shutdown()
        httpd.server_close()
    run = out["run"]
    classes = {c: {k: v for k, v in acc.items() if k != "latency"}
               for c, acc in run["by_class"].items()}
    steps = [{k: s[k] for k in ("offered_rate_rps", "duration_s",
                                "n_requests", "n_ok", "errors")}
             for s in out["steps"]]
    return (out["swing"], out["max_clean_rate_rps"], steps, classes,
            run["n_requests"], run["n_ok"], run["errors"],
            sorted(k for k in run if k not in ("latency",))), seen


def test_swing_accounting_equals_the_jax_loadgen():
    """The same 10× swing of mixed-priority traffic against the same stub:
    the same steps, per-class sheds and drops, and error accounting."""
    ours, seen = _swing_accounting(p_lg)
    theirs, _ = _swing_accounting(j_lg)
    assert ours == theirs
    swing, max_clean, steps, classes = ours[:4]
    assert swing is True and max_clean is None
    assert [s["offered_rate_rps"] for s in steps] == [20.0, 200.0, 20.0]
    assert steps[1]["n_requests"] == 10 * steps[0]["n_requests"]
    assert classes["interactive"]["dropped"] == 0
    assert classes["bulk"]["n_shed_429"] == classes["bulk"]["n_requests"] \
        == seen["bulk"] > 0


def test_swing_rejects_mismatched_durations():
    for mod in (p_lg, j_lg):
        with pytest.raises(ValueError, match="durations"):
            mod.run_ladder("http://127.0.0.1:1/x", {}, rates=[1.0, 2.0],
                           durations=[1.0])


def test_retries_reuse_one_trace_id_on_a_fresh_connection():
    """A request whose connection dies is retried on a new connection
    under the same trace id (fresh span id); the error accounting stays
    present and empty."""
    httpd, seen, url = _stub(drop_first=2)
    try:
        out = p_lg.run_loadgen(url, b"{}", mode="closed", concurrency=1,
                               n_requests=3, warmup_requests=0, retries=3,
                               retry_backoff_s=0.0)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert out["n_ok"] == 3 and out["errors"] == {}
    assert out["n_retried"] == 2
    first = [t.split("-")[1] for t in seen["traces"][:3]]
    assert len(set(first)) == 1  # three attempts, one trace id
    assert len({t.split("-")[2] for t in seen["traces"][:3]}) == 3
    assert out["retried_trace_ids"] == [first[0]] * 2


def test_open_loop_and_ladder_report_the_jax_keys():
    httpd, _, url = _stub(shed_bulk=False)
    try:
        runs = [mod.run_loadgen(url, b"{}", mode="open", rate_rps=200.0,
                                n_requests=40, warmup_requests=2)
                for mod in (p_lg, j_lg)]
        ladders = [mod.run_ladder(url, b"{}", rates=[50.0, 100.0],
                                  warmup_s=0.1, measure_s=0.3)
                   for mod in (p_lg, j_lg)]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert sorted(runs[0]) == sorted(runs[1])
    assert runs[0]["n_ok"] == 40 and runs[0]["errors"] == {}
    assert sorted(ladders[0]) == sorted(ladders[1])
    assert ladders[0]["max_clean_rate_rps"] == 100.0


def _tiny_cfg():
    from deeplearninginassetpricing_paperreplication_torch.utils.config import (  # noqa: E501
        GANConfig,
    )

    return GANConfig(macro_feature_dim=6, individual_feature_dim=10,
                     hidden_dim=(8, 8), num_units_rnn=(4,))


def test_member_dirs_are_seeded_verified_and_served(tmp_path):
    """``_make_member_dirs``: the port's GAN parameters from a seeded
    ``torch.Generator``, written through the verified IO; the same seeds
    give the same bytes, and the engine serves them."""
    from deeplearninginassetpricing_paperreplication_torch.reliability.promotion import (  # noqa: E501
        verify_member_dirs,
    )
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        InferenceEngine,
        InferenceRequest,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config import (  # noqa: E501
        ExecutionConfig,
    )

    a = p_lg._make_member_dirs(tmp_path / "a", _tiny_cfg(), (1, 2))
    b = p_lg._make_member_dirs(tmp_path / "b", _tiny_cfg(), (1, 2))
    members, rejection = verify_member_dirs(a)
    assert rejection is None and len(members) == 2
    for x, y in zip(a, b):
        assert (Path(x) / "best_model_sharpe.pt").read_bytes() == \
            (Path(y) / "best_model_sharpe.pt").read_bytes()
    assert (Path(a[0]) / "best_model_sharpe.pt").read_bytes() != \
        (Path(a[1]) / "best_model_sharpe.pt").read_bytes()
    macro = np.random.default_rng(0).standard_normal((12, 6))
    eng = InferenceEngine(a, macro_history=macro.astype(np.float32),
                          stock_buckets=(64,),
                          exec_cfg=ExecutionConfig(device="cpu"))
    res = eng.infer_one(InferenceRequest(
        individual=np.ones((40, 10), np.float32), month=3))
    assert res.weights.shape == (40,) and np.isfinite(res.weights).all()


def test_bench_serving_on_the_cpu():
    out = p_lg.bench_serving(n_stocks=64, n_features=10, n_macro=6,
                             n_members=2, months=12, n_requests=16,
                             device="cpu")
    for key in ("closed_loop_c1", "closed_loop_c4", "open_loop_0.8cap"):
        assert out[key]["n_ok"] == out[key]["n_requests"], key
        assert out[key]["errors"] == {}
    assert out["captures"] == 0 and out["steady_state_captures"] == 0
    assert out["dispatches"] > 0 and out["batcher_flushes"] > 0


def test_bench_tracing_overhead_on_the_cpu():
    out = p_lg.bench_tracing_overhead(
        n_stocks=64, n_features=10, n_macro=6, n_members=2, months=12,
        n_requests=24, concurrency=4, trials=1, device="cpu")
    assert out["rps_tracing_on"] > 0 and out["rps_tracing_off"] > 0
    assert out["rps_ratio_on_off"] is not None
    assert set(out["all_trials"]) == {"off", "on"}


def test_loadgen_cli_drive_and_device_check(tmp_path):
    """``python -m …serving.loadgen drive`` against a stub prints the run's
    JSON; a bench subcommand on a host without CUDA exits 2 naming it."""
    httpd, _, url = _stub(shed_bulk=False)
    payload = tmp_path / "p.json"
    payload.write_text(json.dumps({"x": 1}))
    try:
        r = subprocess.run(
            [sys.executable, "-m", f"{PKG}.serving.loadgen", "drive",
             "--url", url, "--payload_json", str(payload),
             "--n_requests", "8", "--concurrency", "2"],
            capture_output=True, text=True, cwd=REPO, timeout=300)
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["n_ok"] == 8
    r = subprocess.run([sys.executable, "-m", f"{PKG}.serving.loadgen",
                        "bench_async"], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 2 and "CUDA" in r.stderr
