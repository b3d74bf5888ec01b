"""The PyTorch port's production serving path on the CPU: the
``ServingService`` over its three wires against the JAX package's
``ServingService`` (f32 bars of PERF.md §2, not bitwise — ROADMAP.md §C1),
the same malformed bodies answered with the same status codes, and the
port's own async front end: every wire, coalesced, cached and batched
answers against its one-at-a-time ``engine.infer``; hot reload, snapshot
and restore, the canary revert, the promotion pointer, drift alerts,
generation quality, ``/metrics`` and ``/v1/drain``.

Members are JAX-initialized params exported as reference ``.pt`` run dirs
(both packages read the same files); the conftest panel is 64 stocks,
hidden (8, 8), LSTM [4].
"""

import asyncio
import base64
import json
import shutil
import struct
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble import (
    stack_checkpoints,
)
from deeplearninginassetpricing_paperreplication_torch.observability.drift import (
    reference_profile,
)
from deeplearninginassetpricing_paperreplication_torch.observability.metrics import (
    parse_prom_text,
)
from deeplearninginassetpricing_paperreplication_torch.reliability.promotion import (
    verify_member_dirs,
    write_pointer,
)
from deeplearninginassetpricing_paperreplication_torch.serving import (
    AsyncServerThread,
    InferenceEngine,
    InferenceRequest,
    ServingService,
    make_server,
)
from deeplearninginassetpricing_paperreplication_torch.serving.server import (
    BINARY_CONTENT_TYPE,
    build_arg_parser,
    build_service,
)
from deeplearninginassetpricing_paperreplication_torch.training.checkpoint import (
    member_state_dicts,
    save_state_dict,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    InferenceEngine as JInferenceEngine,
)
from deeplearninginassetpricing_paperreplication_tpu.serving import (
    ServingService as JServingService,
)
from deeplearninginassetpricing_paperreplication_tpu.training.checkpoint import (
    save_torch_checkpoint,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
# PERF.md §2, f32: served answers against a reference
RTOL, ATOL = 1e-4, 1e-6
MONTHS = (0, 5, 11)


def _write_members(root, train, seeds, hidden=(8, 8)):
    cfg = JGANConfig(macro_feature_dim=train.macro_feature_dim,
                     individual_feature_dim=train.individual_feature_dim,
                     hidden_dim=hidden, num_units_rnn=(4,), dropout=0.0)
    gan = JGAN(cfg)
    dirs = []
    for seed in seeds:
        d = root / f"seed_{seed}"
        save_torch_checkpoint(d / "best_model_sharpe.pt",
                              gan.init(jax.random.key(seed)), cfg)
        dirs.append(str(d))
    return dirs


@pytest.fixture(scope="module")
def members(tmp_path_factory, splits):
    """Three serving members, three others of the same architecture, and
    three of another architecture, as reference .pt run dirs."""
    train = splits[0]
    root = tmp_path_factory.mktemp("async_members")
    return {"a": _write_members(root / "a", train, (0, 1, 2)),
            "b": _write_members(root / "b", train, (3, 4, 5)),
            "wide": _write_members(root / "wide", train, (6, 7, 8),
                                   hidden=(16,))}


def _engine(dirs, splits, **kw):
    train, _, test = splits
    kw.setdefault("stock_buckets", (64, 128))
    return InferenceEngine(dirs, macro_history=test.macro,
                           macro_stats=(train.mean_macro, train.std_macro),
                           exec_cfg=CPU_F32, **kw)


def _jengine(dirs, splits):
    train, _, test = splits
    eng = JInferenceEngine(dirs, macro_history=test.macro,
                           macro_stats=(train.mean_macro, train.std_macro),
                           stock_buckets=(64, 128), batch_buckets=(1, 4))
    return eng


def _request(ds, t, mask=True):
    return InferenceRequest(
        individual=ds.individual[t],
        mask=ds.mask[t].astype(np.float32) if mask else None,
        returns=ds.returns[t], month=t)


def _json_body(ds, t, mask=True):
    body = {"individual": ds.individual[t].tolist(),
            "returns": ds.returns[t].tolist(), "month": t}
    if mask:
        body["mask"] = ds.mask[t].astype(float).tolist()
    return body


def _b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a, np.float32)
                            .tobytes()).decode()


def _b64_body(ds, t, mask=True):
    body = {"individual_b64": _b64(ds.individual[t]),
            "returns_b64": _b64(ds.returns[t]), "month": t,
            "encoding": "b64"}
    if mask:
        body["mask_b64"] = _b64(ds.mask[t].astype(np.float32))
    return body


def _raw_body(ds, t) -> bytes:
    x = np.ascontiguousarray(ds.individual[t], np.float32)
    return struct.pack("<iI", t, x.shape[0]) + x.tobytes()


def _weights(body) -> np.ndarray:
    if isinstance(body, (bytes, bytearray)):
        return np.frombuffer(body, np.float32)
    if "weights_b64" in body:
        return np.frombuffer(base64.b64decode(body["weights_b64"]),
                             np.float32)
    return np.asarray(body["weights"], np.float32)


def _binary(service, body):
    """handle_binary_async on a fresh loop with a fresh batcher."""
    async def run():
        service.start_async()
        try:
            return await service.handle_binary_async(body)
        finally:
            await service.cbatcher.aclose()
            service.cbatcher = None

    return asyncio.run(run())


def _serve(service, wire, ds, t, endpoint="/v1/weights"):
    if wire == "raw":
        return _binary(service, _raw_body(ds, t))
    body = _json_body(ds, t, mask=False) if wire == "json" \
        else _b64_body(ds, t, mask=False)
    return service.handle("POST", endpoint, body)


@pytest.fixture(scope="module")
def both_services(members, splits):
    port = ServingService(_engine(members["a"], splits), mode="async")
    jax_svc = JServingService(_jengine(members["a"], splits), mode="async")
    yield port, jax_svc
    port.close()
    jax_svc.close()


@pytest.mark.parametrize("wire", ["json", "b64", "raw"])
def test_wires_match_the_jax_service(both_services, splits, wire):
    """The same body through both packages' ServingService: the weights
    (and, off the raw wire, the SDF) within the f32 bars."""
    port, jax_svc = both_services
    test = splits[2]
    for t in MONTHS:
        ps, pb = _serve(port, wire, test, t)
        js, jb = _serve(jax_svc, wire, test, t)
        assert ps == js == 200, (pb, jb)
        np.testing.assert_allclose(_weights(pb), _weights(jb), rtol=RTOL,
                                   atol=ATOL)
        if wire != "raw":
            ps, pb = _serve(port, wire, test, t, "/v1/sdf")
            js, jb = _serve(jax_svc, wire, test, t, "/v1/sdf")
            assert ps == js == 200
            np.testing.assert_allclose(pb["sdf"], jb["sdf"], rtol=RTOL,
                                       atol=ATOL)


_F = 10  # the conftest panel's characteristics


def _malformed_cases():
    good = {"individual": [[0.1] * _F] * 3, "month": 1}
    return [
        ("no_individual", "/v1/weights", {"month": 1}, 400),
        ("wrong_width", "/v1/weights", {"individual": [[1.0]]}, 400),
        ("ragged", "/v1/weights", {"individual": [[1.0], [1.0, 2.0]]}, 400),
        ("bad_b64", "/v1/weights", {"individual_b64": "@@@"}, 400),
        ("b64_size", "/v1/weights",
         {"individual_b64": _b64(np.zeros(_F + 1))}, 400),
        ("mask_len", "/v1/weights", dict(good, mask=[1.0]), 400),
        ("sdf_no_returns", "/v1/sdf", good, 400),
        ("returns_len", "/v1/sdf", dict(good, returns=[0.1]), 400),
        ("month_range", "/v1/weights", dict(good, month=10_000), 400),
        ("too_many_stocks", "/v1/weights",
         {"individual": [[0.0] * _F] * 129}, 400),
        ("unknown", "/v1/nope", {}, 404),
        ("get_weights", "/v1/weights", None, 405),
    ]


@pytest.mark.parametrize("name,endpoint,payload,status", _malformed_cases(),
                         ids=[c[0] for c in _malformed_cases()])
def test_malformed_bodies_same_status(both_services, name, endpoint,
                                      payload, status):
    port, jax_svc = both_services
    method = "GET" if payload is None else "POST"
    ps, _ = port.handle(method, endpoint, payload)
    js, _ = jax_svc.handle(method, endpoint, payload)
    assert ps == js == status


@pytest.mark.parametrize("body", [b"\x00" * 4, struct.pack("<iI", 1, 3)
                                  + b"\x00" * 8, struct.pack("<iI", 1, 0),
                                  struct.pack("<iI", 10_000, 1)
                                  + b"\x00" * (4 * _F)],
                         ids=["short", "size", "empty", "month"])
def test_malformed_raw_bodies_same_status(both_services, body):
    port, jax_svc = both_services
    assert _binary(port, body)[0] == _binary(jax_svc, body)[0] == 400


# -- the port's async front end ----------------------------------------------


def _call(url, body=None, raw=None, timeout=60):
    if raw is not None:
        req = urllib.request.Request(
            url, data=raw, method="POST",
            headers={"Content-Type": BINARY_CONTENT_TYPE})
    else:
        req = urllib.request.Request(
            url, method="GET" if body is None else "POST",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            data = r.read()
            ok = r.headers.get("Content-Type") == BINARY_CONTENT_TYPE
            return r.status, data if ok else _decode(data)
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _decode(data: bytes):
    try:
        return json.loads(data)
    except json.JSONDecodeError:
        return data.decode()


def _wait_for(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "condition never held"
        time.sleep(0.005)


def _behind_plug(service, send_plug, sends, wait):
    """Run `sends` while a plug request holds the dispatcher: the engine's
    dispatch lock is held, the plug is taken by the continuous batcher and
    blocks on it, the `sends` queue up (or coalesce) until `wait()` holds,
    then the lock is released."""
    cb = service.cbatcher
    with ThreadPoolExecutor(len(sends) + 1) as pool:
        with service.engine._infer_lock:
            flushes = cb.flushes
            plug = pool.submit(send_plug)
            _wait_for(lambda: cb.flushes > flushes)
            futs = [pool.submit(s) for s in sends]
            _wait_for(wait)
        plug.result(timeout=60)
        return [f.result(timeout=60) for f in futs]


@pytest.fixture()
def async_server(members, splits):
    service = ServingService(_engine(members["a"], splits), mode="async")
    service.warmup()
    server = AsyncServerThread(service, admin_port=0)
    base = f"http://127.0.0.1:{server.start()}"
    yield service, server, base
    server.stop()
    service.close()


def test_async_wires_coalesced_cached_batched_equal_engine(async_server,
                                                           splits):
    service, _, base = async_server
    eng = service.engine
    test = splits[2]
    for t in MONTHS:
        ref = eng.infer_one(_request(test, t, mask=False))
        ref_m = eng.infer_one(_request(test, t))
        s, j = _call(base + "/v1/weights", _json_body(test, t, mask=False))
        s2, b = _call(base + "/v1/weights", _b64_body(test, t, mask=False))
        s3, r = _call(base + "/v1/weights", raw=_raw_body(test, t))
        assert (s, s2, s3) == (200, 200, 200)
        for body in (j, b, r):  # same batch shape: bit for bit
            np.testing.assert_array_equal(_weights(body), ref.weights)
        s, j = _call(base + "/v1/sdf", _json_body(test, t))
        s2, b = _call(base + "/v1/sdf", _b64_body(test, t))
        assert s == s2 == 200 and j["sdf"] == b["sdf"] == ref_m.sdf
        np.testing.assert_array_equal(
            np.frombuffer(base64.b64decode(b["member_sdf_b64"]), np.float32),
            ref_m.member_sdf)
        assert j["batch_bucket"] == 1
    # a repeated request: answered from the cache, the same bits
    s, again = _call(base + "/v1/sdf", _b64_body(test, MONTHS[0]))
    assert s == 200 and again["cached"] is True
    assert again["sdf"] == eng.infer_one(_request(test, MONTHS[0])).sdf
    # four concurrent months folded into one flush (batch bucket 4): bit
    # for bit the engine's own batch of the same four
    group = (1, 2, 3, 4)
    folded = _behind_plug(
        service, lambda: _call(base + "/v1/weights", raw=_raw_body(test, 9)),
        [lambda t=t: _call(base + "/v1/sdf", _b64_body(test, t))
         for t in group],
        lambda: service.cbatcher.pending() == len(group))
    batch = eng.infer([_request(test, t) for t in group])
    for (s, body), res in zip(folded, batch):
        assert s == 200 and body["batch_bucket"] == 4
        assert body["sdf"] == res.sdf
    # identical concurrent requests: one dispatch, the waiters coalesced
    hits = service.coalesce_hits
    same = _behind_plug(
        service, lambda: _call(base + "/v1/weights", raw=_raw_body(test, 8)),
        [lambda: _call(base + "/v1/weights", raw=_raw_body(test, 7))] * 3,
        lambda: service.coalesce_hits == hits + 2)
    ref = eng.infer_one(_request(test, 7, mask=False))
    for s, body in same:
        assert s == 200
        np.testing.assert_array_equal(_weights(body), ref.weights)
    s, m = _call(base + "/metrics")
    assert s == 200 and m["coalesce"]["hits"] >= 2
    assert m["batcher"]["occupancy_hist"].get("4") == 1
    assert m["cache"]["hits"] >= 1
    assert m["latency"]["count"] > 0 and m["latency"]["p99_ms"] > 0
    assert m["engine"]["steady_state_captures"] == 0


def test_metrics_prom_carries_the_jax_series(async_server, splits):
    service, _, base = async_server
    test = splits[2]
    assert _call(base + "/v1/weights", _json_body(test, 0))[0] == 200
    s, text = _call(base + "/metrics?format=prom")
    assert s == 200
    series = parse_prom_text(text)
    for name in ("dlap_model_generation", "dlap_model_outputs_total",
                 "dlap_model_finite_fraction", "dlap_model_drift_alerts_total",
                 "dlap_serve_coalesce_hits_total",
                 "dlap_serve_dispatches_total", "dlap_serve_requests_total",
                 "dlap_serve_flush_total", "dlap_process_threads"):
        assert name in series, name


def test_drain_closes_the_listener_and_returns(async_server, splits):
    service, server, base = async_server
    admin = f"http://127.0.0.1:{server.admin_port}"
    assert _call(base + "/v1/drain", {})[0] == 404  # public: no controls
    s, body = _call(admin + "/v1/drain", {"timeout_s": 5})
    assert s == 200 and body["drained"] is True and service.draining
    assert server.returned.wait(10) and server.error is None
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(base + "/healthz", timeout=5)


def test_flightrecorder_dump_on_the_admin_port(members, splits, tmp_path):
    from deeplearninginassetpricing_paperreplication_torch.serving import (
        load_flightrecorder,
    )

    service = ServingService(_engine(members["a"], splits), mode="async",
                             run_dir=str(tmp_path / "run"))
    server = AsyncServerThread(service, admin_port=0)
    base = f"http://127.0.0.1:{server.start()}"
    try:
        assert _call(base + "/v1/weights",
                     _json_body(splits[2], 0))[0] == 200
        s, body = _call(f"http://127.0.0.1:{server.admin_port}"
                        "/v1/debug/flightrecorder", {})
        assert s == 200 and body["dumped"] is True
        dump = load_flightrecorder(tmp_path / "run")
        assert dump["reason"] == "admin" and dump["n_requests"] >= 1
    finally:
        server.stop()
        service.close()
    assert (tmp_path / "run" / "metrics.prom").exists()
    assert (tmp_path / "run" / "manifest.json").exists()


def test_threaded_front_end_still_serves(members, splits):
    import threading

    service = ServingService(_engine(members["a"], splits))
    httpd = make_server(service)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        test = splits[2]
        s, body = _call(base + "/v1/weights", _b64_body(test, 3, mask=False))
        assert s == 200
        np.testing.assert_array_equal(
            _weights(body),
            service.engine.infer_one(_request(test, 3, mask=False)).weights)
        assert _call(base + "/metrics")[1]["batcher"]["mode"] == "threaded"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        service.close()


# -- hot reload ----------------------------------------------------------------


def test_reload_snapshot_restore(members, splits):
    test = splits[2]
    eng = _engine(members["a"], splits)
    reqs = [_request(test, t) for t in MONTHS]
    before = eng.infer(reqs)
    gen, fp = eng.params_generation, eng.params_fingerprint
    snap = eng.snapshot_params()
    out = eng.reload(members["b"])
    assert out["swapped"] and out["params_generation"] == gen + 1
    assert eng.params_fingerprint != fp
    fresh = _engine(members["b"], splits).infer(reqs)
    for a, b in zip(eng.infer(reqs), fresh):  # the new generation
        np.testing.assert_array_equal(a.weights, b.weights)
        assert a.sdf == b.sdf
    assert eng.reload(members["b"])["swapped"] is False  # same bytes
    eng.restore_params(snap)
    assert eng.params_fingerprint == fp
    assert eng.checkpoint_dirs == members["a"]
    for a, b in zip(eng.infer(reqs), before):  # the pre-swap answers
        np.testing.assert_array_equal(a.weights, b.weights)
        assert a.sdf == b.sdf
    for dirs in (members["wide"], members["b"][:2]):
        with pytest.raises(ValueError):
            eng.reload(dirs)
        for a, b in zip(eng.infer(reqs), before):  # still serving
            np.testing.assert_array_equal(a.weights, b.weights)
    stats = eng.stats()
    assert stats["params_generation"] == gen + 2
    assert stats["captures"] == 0 and stats["replays"] == 0  # the CPU


def test_concurrent_dispatch_and_swap_lose_nothing(members, splits):
    """More threads than cores infer while others append a month and swap
    generations, with a tiny switch interval: every answer is one of the
    two generations' bit for bit, and no dispatch or quality count is
    lost."""
    import os
    import sys
    import threading

    test = splits[2]
    eng = _engine(members["a"], splits)
    req = _request(test, 2)
    ref = {eng.params_fingerprint: eng.infer_one(req).weights}
    ref[_engine(members["b"], splits).params_fingerprint] = \
        _engine(members["b"], splits).infer_one(req).weights
    eng.reload(members["b"])
    eng.reload(members["a"])  # generation 2, the same params as 0
    base = eng.stats()["dispatches"]
    n_threads, per = 2 * (os.cpu_count() or 4), 5
    bad, errors = [], []

    def worker():
        try:
            for _ in range(per):
                w = eng.infer_one(req).weights
                if not any(np.array_equal(w, r) for r in ref.values()):
                    bad.append(w)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    def swapper():
        for dirs in (members["b"], members["a"]) * 2:
            eng.reload(dirs)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        threads.append(threading.Thread(target=swapper))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not bad
    assert eng.stats()["dispatches"] - base == n_threads * per
    assert eng.stats()["params_generation"] == 6
    assert eng.params_fingerprint in ref


def _nan_member(src_dir, dst):
    """A copy of one member whose params are NaN, written through the
    verified writer (so its digest verifies)."""
    shutil.copytree(src_dir, dst)
    _, stacked = stack_checkpoints([str(src_dir)], device="cpu")
    sd = member_state_dicts(stacked)[0]
    for p in dst.glob("best_model_sharpe.pt*"):
        p.unlink()
    save_state_dict(dst / "best_model_sharpe.pt",
                    {k: v * float("nan") for k, v in sd.items()})
    return str(dst)


def test_canary_reverts_a_nan_candidate(members, splits, tmp_path):
    test = splits[2]
    service = ServingService(_engine(members["a"], splits), mode="async")
    try:
        answers = [service.handle("POST", "/v1/sdf", _json_body(test, t))[1]
                   for t in MONTHS]
        gen = service.engine.params_generation
        bad = members["b"][:2] + [_nan_member(members["b"][2],
                                              tmp_path / "nan")]
        s, body = service.handle("POST", "/v1/reload",
                                 {"checkpoint_dirs": bad})
        assert s == 500 and "canary" in body["error"]
        assert service.engine.params_generation == gen + 2  # swap + revert
        assert service.engine.checkpoint_dirs == members["a"]
        for t, ans in zip(MONTHS, answers):
            res = service.engine.infer_one(_request(test, t))
            assert res.sdf == ans["sdf"]
        # a good reload: the cached pre-swap answer is served anew
        s, out = service.handle("POST", "/v1/reload",
                                {"checkpoint_dirs": members["b"]})
        assert s == 200 and out["swapped"] and out["canary"]["finite"]
        s, again = service.handle("POST", "/v1/sdf",
                                  _json_body(test, MONTHS[0]))
        assert s == 200 and again["cached"] is False
        assert again["sdf"] != answers[0]["sdf"]
    finally:
        service.close()


def _verified_members(src_dirs, root):
    """Copies of `src_dirs` written through the verified writer (each .pt
    with its .sha256 sidecar), as the trainer writes run dirs."""
    _, stacked = stack_checkpoints(list(src_dirs), device="cpu")
    dirs = []
    for i, (src, sd) in enumerate(zip(src_dirs, member_state_dicts(stacked))):
        d = root / f"m{i}"
        d.mkdir(parents=True)
        shutil.copy(f"{src}/config.json", d / "config.json")
        save_state_dict(d / "best_model_sharpe.pt", sd)
        dirs.append(str(d))
    return dirs


def test_pointer_reload_verifies_every_member(members, splits, tmp_path):
    dirs = _verified_members(members["a"], tmp_path / "members")
    recorded, rejection = verify_member_dirs(dirs)
    assert rejection is None
    eng = _engine(dirs, splits)
    ctl = tmp_path / "ctl"
    write_pointer(ctl, {"checkpoint_dirs": dirs, "members": recorded,
                        "params_fingerprint": eng.params_fingerprint})
    args = build_arg_parser().parse_args(
        ["--pointer", str(ctl), "--macro_npy", str(_macro_npy(tmp_path,
                                                               splits)),
         "--stock_buckets", "64,128", "--device", "cpu",
         "--compute_dtype", "float32", "--no_warmup", "--server", "async"])
    service = build_service(args)
    try:
        assert service.engine.checkpoint_dirs == dirs
        s, out = service.handle("POST", "/v1/reload", None)
        assert s == 200 and out["swapped"] is False and out["converged"]
        gen = service.engine.params_generation
        # a member torn after promotion: the whole reload fails
        torn = tmp_path / "members" / "m1" / "best_model_sharpe.pt"
        torn.write_bytes(torn.read_bytes()[:-8])
        s, body = service.handle("POST", "/v1/reload", None)
        assert s == 500 and "digest mismatch" in body["error"]
        assert service.engine.params_generation == gen
    finally:
        service.close()


def _macro_npy(tmp_path, splits):
    path = tmp_path / "macro.npy"
    np.save(path, splits[2].macro)
    return path


# -- model health ---------------------------------------------------------------


def test_drift_alerts_move_on_a_shifted_panel(members, splits):
    train, _, test = splits
    profile = reference_profile(train.full_batch())
    service = ServingService(_engine(members["a"], splits), mode="async",
                             reference_profile=profile, drift_every=1)
    try:
        assert service.handle("POST", "/v1/weights",
                              _json_body(test, 0))[0] == 200
        calm = service.drift_alerts
        sd = train.individual[train.mask].std(axis=0)
        shifted = dict(_json_body(test, 1),
                       individual=(test.individual[1] + 3 * sd).tolist())
        assert service.handle("POST", "/v1/weights", shifted)[0] == 200
        assert service.drift_alerts == calm + 1
        assert service.drift_scored == 2
        series = parse_prom_text(service.metrics_prom())
        assert series["dlap_model_drift_alerts_total"][()] == calm + 1
    finally:
        service.close()


def test_generation_quality_matches_the_jax_engine(members, splits):
    test = splits[2]
    eng = _engine(members["a"], splits)
    jeng = _jengine(members["a"], splits)
    for t in MONTHS:
        eng.infer([_request(test, t)])
        jeng.infer([_request(test, t)])
    eng.infer([_request(test, 2, mask=False)])
    jeng.infer([_request(test, 2, mask=False)])
    ours, theirs = eng.generation_quality(), jeng.generation_quality()
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert ours["outputs"] == len(MONTHS) + 1


def test_cli_sigusr1_flare_and_sigterm_shutdown(members, splits, tmp_path):
    """The serving CLI on the CPU: SIGUSR1 dumps the flight recorder,
    SIGTERM is a clean shutdown (exit 0, ``metrics.prom`` and the last
    dump written)."""
    import signal
    import subprocess
    import sys

    from deeplearninginassetpricing_paperreplication_torch.serving import (
        load_flightrecorder,
        pick_free_port,
    )

    port = pick_free_port()
    run = tmp_path / "run"
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "deeplearninginassetpricing_paperreplication_torch.serving.server",
         "--checkpoint_dirs", *members["a"], "--macro_npy",
         str(_macro_npy(tmp_path, splits)), "--stock_buckets", "64",
         "--device", "cpu", "--compute_dtype", "float32", "--port",
         str(port), "--run_dir", str(run)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.monotonic()
        while True:
            try:
                if _call(base + "/healthz", timeout=5)[0] == 200:
                    break
            except urllib.error.URLError:
                pass
            assert proc.poll() is None and time.monotonic() - t0 < 120
            time.sleep(0.2)
        s, _ = _call(base + "/v1/weights", _json_body(splits[2], 1))
        assert s == 200
        proc.send_signal(signal.SIGUSR1)
        _wait_for(lambda: (load_flightrecorder(run) or {}).get("reason")
                  == "watchdog")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert (run / "metrics.prom").exists()
    assert load_flightrecorder(run)["reason"] == "sigterm"


def test_cli_defaults_and_flags():
    args = build_arg_parser().parse_args(["--checkpoint_dirs", "d"])
    assert args.server == "async" and args.device == "cuda"
    assert args.pointer is None and args.cache_size == 256
    assert (args.max_queue, args.drift_every) == (256, 64)
    args = build_arg_parser().parse_args(
        ["--pointer", "ctl", "--admin_port", "0", "--stock_buckets",
         "64,128", "--batch_buckets", "1,2,4", "--max_batch", "2",
         "--bulk_threshold", "0.25", "--no_coalesce", "--reference_profile",
         "off", "--drift_psi_threshold", "0.5", "--max_delay_s", "0.01",
         "--no_warmup", "--server", "threaded", "--run_dir", "r",
         "--macro_npy", "m.npy"])
    assert (args.admin_port, args.max_batch, args.no_coalesce) == (0, 2, True)
    with pytest.raises(ValueError, match="checkpoint_dirs or --pointer"):
        build_service(build_arg_parser().parse_args(["--device", "cpu"]))


@pytest.mark.cuda
def test_graph_replay_bit_for_bit_the_eager_route(members, splits):
    """On the card: every warmed bucket's graph replay equals the same
    forward run eagerly, bit for bit, and serving captures nothing after
    warmup (chip_smoke.py phase 4 holds this at paper width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    train, _, test = splits
    eng = InferenceEngine(members["a"], macro_history=test.macro,
                          stock_buckets=(64, 128),
                          exec_cfg=ExecutionConfig(device="cuda"))
    assert eng.warmup() == 4 and eng.stats()["captures"] == 4
    for b in (1, 4):
        reqs = [_request(test, t) for t in range(b)]
        for g, e in zip(eng.infer(reqs), eng.infer(reqs, graphs=False)):
            np.testing.assert_array_equal(g.weights, e.weights)
    assert eng.stats()["steady_state_captures"] == 0
