#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py             # the check (one card)
    python3 chip_smoke.py --profile   # also: torch.profiler over the engine

Phases, each printing its results; any failure exits non-zero:

1. Card: ``nvidia-smi`` name and power limit.
2. Build: every kernel of the port from this checkout's sources (``nvcc``,
   sm_90a, one process per library, all started together).
3. Kernels against their plain PyTorch versions on the card, at the serving
   path's shapes, with CUDA-event timings.
4. Main path at the paper's full width: a synthetic panel (F = 46,
   M = 178, N = 10,000 stocks, 48/12/24 months, seed 42) and the three
   paper-width reference checkpoints (``ref_runs/{w500,mid2000,w4000}``)
   served over HTTP by the port's ``serving.server``, in f32 and then in
   bf16. Every test month is served singly and in groups of 4 and held
   against the port's offline ``ensemble_metrics`` (plain route, same card).
   The kernel's launch counter is reset just before each drive and must
   rise during it.
5. Offline ensemble: the port's ``evaluate_ensemble`` on the same panel.

Then one ``kernels`` JSON line, the card line again, and the result line
``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG = "deeplearninginassetpricing_paperreplication_torch"
REF_RUNS = ["ref_runs/w500", "ref_runs/mid2000", "ref_runs/w4000"]
DATA_DIR = ROOT / "_smoke_data"
DEVICE = "cuda"
PANEL = dict(n_periods_train=48, n_periods_valid=12, n_periods_test=24,
             n_stocks=10_000, n_features=46, n_macro=178, seed=42)

# the card's published peaks (H100 SXM data sheet, dense): the bound of a
# kernel is the larger of bytes / memory rate and operations / peak rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = dict(rtol=1e-4, atol=1e-5)  # kernel vs plain, f32 (sum order)
SERVE_F32_TOL = dict(rtol=1e-4, atol=1e-6)  # served vs offline, f32
BF16_REL = 2e-2  # bf16: atol = 2e-2 · max|reference|


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def within(diff: np.ndarray, ref: np.ndarray, dtype: str, rtol: float,
           atol: float) -> bool:
    if dtype == "bfloat16":
        return bool(np.all(diff <= BF16_REL * np.abs(ref).max()))
    return bool(np.all(diff <= atol + rtol * np.abs(ref)))


# -- phase 3 ------------------------------------------------------------------


def kernel_checks(torch, K, card):
    """The fused FFN against its plain version at the listed shapes; returns
    the row of the shape the main path serves most (S=3, T=4, N=16384)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    F, hidden = 46, [64, 64]

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    row = None
    print(f"[kernels] sdf_ffn_fwd vs sdf_ffn_reference, F={F} hidden={hidden}"
          f" ({card})", flush=True)
    for S in (1, 3):
        for T in (1, 4, 24):
            for N in (16384, 10007):
                x = rand(T, F, N)
                zp = rand(S, T, hidden[0], scale=0.3)
                k1T = rand(S, hidden[0], F, scale=F ** -0.5)
                mids = [(rand(S, hidden[1], hidden[0],
                              scale=hidden[0] ** -0.5),
                         rand(S, hidden[1], scale=0.1))]
                kout = rand(S, hidden[1], scale=hidden[1] ** -0.5)
                bout = rand(S, scale=0.1)
                for cd in ("float32", "bfloat16"):
                    packed = K.pack_ffn(k1T, mids, kout, bout, cd)
                    out = K.sdf_ffn_packed(x, zp, packed)
                    torch.cuda.synchronize()
                    ref = K.sdf_ffn_reference(x, zp, k1T, mids, kout, bout,
                                              cd)
                    diff = (out - ref).abs().cpu().numpy()
                    refn = ref.cpu().numpy()
                    err = float(diff.max())
                    check(bool(torch.isfinite(out).all()),
                          f"non-finite kernel output at S={S} T={T} N={N}")
                    check(within(diff, refn, cd, **F32_TOL),
                          f"kernel disagrees with its plain version at S={S}"
                          f" T={T} N={N} {cd}: max|d| {err:.3e}")
                    ms = cuda_ms(torch, lambda: K.sdf_ffn_packed(x, zp,
                                                                 packed))
                    plain_ms = cuda_ms(torch, lambda: K.sdf_ffn_reference(
                        x, zp, k1T, mids, kout, bout, cd))
                    flops = K.flops(S, T, N, F, hidden)
                    nbytes = K.bytes_moved(S, T, N, F, hidden)
                    t_ops = flops / PEAK_FLOPS[cd] * 1e3
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    bound_ms = max(t_ops, t_bytes)
                    print(f"[kernels] S={S} T={T:2d} N={N:5d} {cd:8s} "
                          f"max|d| {err:.3e} max|ref| "
                          f"{float(np.abs(refn).max()):.3f}  kernel "
                          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                          f"{bound_ms:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})"
                          f"  {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
                    if (S, T, N, cd) == (3, 4, 16384, "bfloat16"):
                        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms,
                                   bound_by=("operations" if t_ops >= t_bytes
                                             else "bytes"),
                                   shape=f"S=3 T=4 N=16384 F={F} "
                                         f"hidden={hidden} bfloat16")
    return row


# -- phase 4 ------------------------------------------------------------------


def post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def get(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def serve_and_check(torch, dtype, test, offline, bodies, card, K, server_mod):
    """Serve the three-member ensemble over HTTP at `dtype`, every test month
    singly and in groups of 4, and hold the answers against `offline`."""
    args = server_mod.build_arg_parser().parse_args(
        ["--checkpoint_dirs", *[str(ROOT / d) for d in REF_RUNS],
         "--data_dir", str(DATA_DIR), "--port", "0", "--device", DEVICE,
         "--compute_dtype", dtype])
    service = server_mod.build_service(args)
    httpd = server_mod.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    # the full cross-section lands in the smallest stock bucket holding it
    bucket = min(b for b in service.engine.stock_buckets if b >= test.N)
    avg_ref = offline["avg_weights"]
    port_ref = offline["ensemble_port_returns"]
    latencies, errs_w, errs_sdf = [], [], []

    def check_answer(t, ans_w, ans_s):
        n = test.N
        w = np.asarray(ans_w["weights"])
        check(ans_w["month"] == t and ans_w["n"] == n
              and ans_w["bucket"] == bucket, f"bad answer header {ans_w}")
        check(bool(np.isfinite(w).all()), f"non-finite weights month {t}")
        check(abs(np.abs(w).sum() - 1.0) < 1e-4,
              f"sum|w| = {np.abs(w).sum()} at month {t}")
        check(ans_s["sdf"] is not None and np.isfinite(ans_s["sdf"])
              and np.isfinite(ans_s["member_sdf"]).all(),
              f"non-finite sdf month {t}")
        dw = np.abs(w - avg_ref[t])
        ds = abs(ans_s["sdf"] - port_ref[t])
        errs_w.append(float(dw.max()))
        errs_sdf.append(ds)
        check(within(dw, avg_ref[t], dtype, **SERVE_F32_TOL),
              f"served weights != offline at month {t} ({dtype}): "
              f"max|d| {dw.max():.3e}")
        check(within(np.array([ds]), port_ref, dtype, **SERVE_F32_TOL)
              if dtype == "bfloat16" else
              ds <= SERVE_F32_TOL["atol"]
              + SERVE_F32_TOL["rtol"] * abs(port_ref[t]),
              f"served sdf != offline at month {t} ({dtype}): |d| {ds:.3e}")

    try:
        K.reset_launch_count()
        n_infer = 0
        for t in range(test.T):  # batch bucket 1
            t0 = time.perf_counter()
            sw, ans_w = post(base + "/v1/weights", bodies[t])
            latencies.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ss, ans_s = post(base + "/v1/sdf", bodies[t])
            latencies.append(time.perf_counter() - t0)
            n_infer += 2
            check(sw == 200 and ss == 200, f"HTTP {sw}/{ss} at month {t}")
            check(ans_w["batch_bucket"] == 1, "single query not in bucket 1")
            check_answer(t, ans_w, ans_s)
        for t0_ in range(0, test.T, 4):  # batch bucket 4
            group = b'{"batch": [' + b",".join(bodies[t0_:t0_ + 4]) + b"]}"
            sw, ans_w = post(base + "/v1/weights", group)
            ss, ans_s = post(base + "/v1/sdf", group)
            n_infer += 2
            check(sw == 200 and ss == 200, f"HTTP {sw}/{ss} group {t0_}")
            for i, (aw, as_) in enumerate(zip(ans_w["results"],
                                              ans_s["results"])):
                check(aw["batch_bucket"] == 4, "group not in bucket 4")
                check_answer(t0_ + i, aw, as_)
        launches = K.launches
        check(launches > 0, "the main path launched sdf_ffn_fwd no time")
        check(launches == n_infer,
              f"{launches} kernel launches for {n_infer} served forwards")
        # two new macro months, then the latest month
        for k in range(2):
            s, ans = post(base + "/v1/macro", json.dumps(
                {"macro": test.macro[k].tolist()}).encode())
            check(s == 200 and ans["month"] == test.T + k,
                  f"/v1/macro answered {s} {ans}")
        s, ans = post(base + "/v1/weights", json.dumps(
            {"individual": test.individual[0].tolist(), "month": -1}
        ).encode())
        w = np.asarray(ans.get("weights", [np.nan]))
        check(s == 200 and ans["month"] == test.T + 1
              and np.isfinite(w).all() and abs(np.abs(w).sum() - 1) < 1e-4,
              f"month -1 after two appends answered {s}")
        s, ans = get(base + "/healthz")
        check(s == 200 and ans["ok"] is True, f"/healthz answered {s} {ans}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    med = statistics.median(latencies) * 1e3
    print(f"[serve {dtype}] {len(latencies)} single-month requests + "
          f"{test.T // 4 * 2} groups of 4 served; kernel launches {launches}"
          f"; served vs offline max|d| weights {max(errs_w):.3e} sdf "
          f"{max(errs_sdf):.3e}; per-request latency median {med:.1f} ms "
          f"(HTTP + JSON of 10,000 x 46 floats, {card})", flush=True)
    return service, launches, med


def engine_timing(torch, service, test, card):
    """Time engine.infer alone (no HTTP, no JSON): host clock around a call
    that ends in a device sync, batch buckets 1 and 4."""
    from deeplearninginassetpricing_paperreplication_torch.serving.engine \
        import InferenceRequest

    eng = service.engine
    reqs = [InferenceRequest(individual=test.individual[t],
                             mask=test.mask[t].astype(np.float32),
                             returns=test.returns[t], month=t)
            for t in range(test.T)]
    out = {}
    for b in (1, 4):
        for _ in range(3):
            eng.infer(reqs[:b])
        times = []
        for i in range(0, test.T, b):
            t0 = time.perf_counter()
            eng.infer(reqs[i:i + b])  # returns host arrays: synchronized
            times.append(time.perf_counter() - t0)
        out[b] = statistics.median(times) * 1e3
    print(f"[engine {eng.exec_cfg.compute_dtype}] infer() median "
          f"{out[1]:.2f} ms (batch 1), {out[4]:.2f} ms (batch 4) ({card})",
          flush=True)
    return reqs


def profile_engine(torch, service, reqs, card):
    """torch.profiler over 24 batch-1 engine calls: device time by kernel
    and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    eng = service.engine
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            eng.infer([r])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_time(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    evs = [e for e in prof.key_averages() if dev_time(e) > 0]
    evs.sort(key=dev_time, reverse=True)
    busy = sum(dev_time(e) for e in evs) / 1e6
    print(f"[profile] {len(reqs)} engine calls in {wall * 1e3:.1f} ms wall;"
          f" device busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of "
          f"the window; {card})", flush=True)
    for e in evs[:12]:
        print(f"[profile]   {dev_time(e) / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:90]}", flush=True)


# -- main ----------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the serving engine with "
                         "torch.profiler")
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA "
             "card")
    if not (ROOT / PKG).is_dir() or not (ROOT / "ref_runs").is_dir():
        fail(f"{PKG}/ and ref_runs/ must sit beside this script (run it "
             "from a checkout of the repository)")
    sys.path.insert(0, str(ROOT))
    # the plain references are full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from deeplearninginassetpricing_paperreplication_torch.data.panel import (
        load_splits,
    )
    from deeplearninginassetpricing_paperreplication_torch.data.synthetic \
        import generate_all_splits
    from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble \
        import evaluate_ensemble, stack_checkpoints
    from deeplearninginassetpricing_paperreplication_torch.ops import (
        sdf_ffn as K,
    )
    from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble \
        import ensemble_metrics
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        server as server_mod,
    )
    from deeplearninginassetpricing_paperreplication_torch.utils.config \
        import ExecutionConfig

    t_start = time.perf_counter()
    # 1. card
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s); {kind}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = K.build(verbose=True)
    print(f"[build] sdf_ffn_fwd: {len(logs)} libraries (widths "
          f"{sorted(logs)}) built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for w in sorted(logs):
        for line in logs[w].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   w{w}: {line.strip()}", flush=True)

    # 3. kernel against its plain version
    row = kernel_checks(torch, K, card)

    # 4. main path
    t0 = time.perf_counter()
    if DATA_DIR.exists():
        shutil.rmtree(DATA_DIR)
    generate_all_splits(DATA_DIR, verbose=False, compress=False, **PANEL)
    _, _, test = load_splits(DATA_DIR)
    print(f"[panel] synthetic F={PANEL['n_features']} M={PANEL['n_macro']} "
          f"N={PANEL['n_stocks']} months {PANEL['n_periods_train']}/"
          f"{PANEL['n_periods_valid']}/{PANEL['n_periods_test']} seed "
          f"{PANEL['seed']}: {time.perf_counter() - t0:.1f} s", flush=True)
    mask = test.mask.astype(np.float32)
    bodies = [json.dumps({"individual": test.individual[t].tolist(),
                          "mask": mask[t].tolist(),
                          "returns": test.returns[t].tolist(),
                          "month": t}).encode() for t in range(test.T)]
    cfg, stacked = stack_checkpoints([str(ROOT / d) for d in REF_RUNS],
                                     device=DEVICE)
    batch = test.to_batch(DEVICE)
    total_launches = 0
    for dtype in ("float32", "bfloat16"):
        offline = ensemble_metrics(cfg, stacked, batch, ExecutionConfig(
            kernel="off", compute_dtype=dtype, device=DEVICE))
        service, launches, _ = serve_and_check(
            torch, dtype, test, offline, bodies, card, K, server_mod)
        total_launches += launches
        reqs = engine_timing(torch, service, test, card)
        if opts.profile:
            profile_engine(torch, service, reqs, card)

    # 5. offline ensemble
    res = evaluate_ensemble([str(ROOT / d) for d in REF_RUNS], str(DATA_DIR),
                            exec_cfg=ExecutionConfig(device=DEVICE),
                            verbose=False)
    check(np.isfinite(res["test_sharpe"]), "non-finite ensemble Sharpe")
    print(f"[ensemble] 3-member test Sharpe (negated, ddof 0, bf16 kernel): "
          f"{res['test_sharpe']:.6f}; train {res['train_sharpe']:.6f} valid "
          f"{res['valid_sharpe']:.6f}; members "
          f"{[round(s, 6) for s in res['individual_sharpes']]}", flush=True)
    shutil.rmtree(DATA_DIR, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "sdf_ffn_fwd",
        "route": "cuda",
        "source": f"{PKG}/ops/csrc/sdf_ffn.cu",
        "replaces": "deeplearninginassetpricing_paperreplication_tpu/ops/"
                    "pallas_ffn.py:561",
        "also_replaces": "deeplearninginassetpricing_paperreplication_tpu/"
                         "ops/pallas_ffn.py:188",
        "launches": total_launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "shape": row["shape"],
    }]}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
