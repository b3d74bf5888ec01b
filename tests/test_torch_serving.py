"""The PyTorch port's serving slice on the CPU: the engine against the JAX
package's OFFLINE ensemble path (``parallel/ensemble.ensemble_metrics``),
never against the JAX engine (not bitwise on this tree — ROADMAP.md §C),
plus bucket-padding invariance, the incremental macro state, an HTTP round
trip through the async front end (concurrent queries folded by the
continuous batcher), and the CUDA-by-default entry points.

Members are JAX-initialized params exported as reference ``.pt`` run dirs
with the JAX package's own ``save_torch_checkpoint``, so both packages read
the same files. Tolerances: weights atol 2e-5, SDF atol 2e-5, Sharpe rtol
1e-3 (ROADMAP.md), all f32.
"""

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.evaluate_ensemble import (
    evaluate_ensemble,
    stack_checkpoints,
)
from deeplearninginassetpricing_paperreplication_torch.parallel.ensemble import (
    ensemble_metrics,
)
from deeplearninginassetpricing_paperreplication_torch.serving.engine import (
    InferenceEngine,
    InferenceRequest,
)
from deeplearninginassetpricing_paperreplication_torch.serving.aserver import (
    AsyncServerThread,
)
from deeplearninginassetpricing_paperreplication_torch.serving.server import (
    ServingService,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
)
from deeplearninginassetpricing_paperreplication_tpu import (
    evaluate_ensemble as jeval,
)
from deeplearninginassetpricing_paperreplication_tpu.models.gan import (
    GAN as JGAN,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    ensemble as jens,
)
from deeplearninginassetpricing_paperreplication_tpu.training.checkpoint import (
    save_torch_checkpoint,
)
from deeplearninginassetpricing_paperreplication_tpu.utils.config import (
    GANConfig as JGANConfig,
)

CPU_F32 = ExecutionConfig(device="cpu", compute_dtype="float32")
PKG = "deeplearninginassetpricing_paperreplication_torch"


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory, splits):
    """Three members on the conftest panel, as reference .pt run dirs."""
    train, _, _ = splits
    cfg = JGANConfig(macro_feature_dim=train.macro_feature_dim,
                     individual_feature_dim=train.individual_feature_dim,
                     hidden_dim=(8, 8), num_units_rnn=(4,), dropout=0.0)
    gan = JGAN(cfg)
    root = tmp_path_factory.mktemp("members")
    dirs = []
    for seed in (0, 1, 2):
        d = root / f"seed_{seed}"
        save_torch_checkpoint(d / "best_model_sharpe.pt",
                              gan.init(jax.random.key(seed)), cfg)
        dirs.append(str(d))
    return dirs


def _engine(run_dirs, splits, **kw):
    train, _, test = splits
    return InferenceEngine(run_dirs, macro_history=test.macro,
                           macro_stats=(train.mean_macro, train.std_macro),
                           exec_cfg=CPU_F32, **kw)


def _request(ds, t, month=None):
    return InferenceRequest(individual=ds.individual[t],
                            mask=ds.mask[t].astype(np.float32),
                            returns=ds.returns[t],
                            month=t if month is None else month)


def test_engine_matches_jax_offline_ensemble(run_dirs, splits):
    _, _, test = splits
    jgan, jparams = jeval.stack_checkpoints(run_dirs)
    jbatch = {k: jnp.asarray(v) for k, v in test.full_batch().items()}
    ref = jens.ensemble_metrics(jgan, jparams, jbatch)
    eng = _engine(run_dirs, splits, stock_buckets=(64, 128))
    assert eng.warmup() == 4
    singles = [eng.infer_one(_request(test, t)) for t in range(test.T)]
    grouped = [r for t in range(0, test.T, 4)
               for r in eng.infer([_request(test, u)
                                   for u in range(t, min(t + 4, test.T))])]
    for res in (singles, grouped):
        w = np.stack([r.weights for r in res])
        np.testing.assert_allclose(w, ref["avg_weights"], atol=2e-5)
        np.testing.assert_allclose([r.sdf for r in res],
                                   ref["ensemble_port_returns"], atol=2e-5)
        np.testing.assert_allclose(np.abs(w).sum(axis=1), 1.0, rtol=1e-5)
    assert {r.batch_bucket for r in singles} == {1}
    assert {r.batch_bucket for r in grouped} == {4}
    # the port's own offline path is the same function
    cfg, stacked = stack_checkpoints(run_dirs, device="cpu")
    port = ensemble_metrics(cfg, stacked, {
        k: torch.from_numpy(np.asarray(v, np.float32))
        for k, v in test.full_batch().items()}, CPU_F32)
    for k in ("avg_weights", "ensemble_port_returns", "individual_sharpes"):
        np.testing.assert_allclose(port[k], ref[k], atol=2e-5, err_msg=k)
    for k in ("ensemble_sharpe", "explained_variation", "cross_sectional_r2"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-3, err_msg=k)


def test_bucket_padding_invariance(run_dirs, splits):
    """The same query padded into different stock and batch buckets gives
    the same answer: padded stocks carry mask 0."""
    _, _, test = splits
    reqs = [_request(test, t) for t in range(3)]
    a = _engine(run_dirs, splits, stock_buckets=(64,)).infer(reqs)
    b = _engine(run_dirs, splits, stock_buckets=(256,),
                batch_buckets=(8,)).infer(reqs)
    assert (a[0].bucket, a[0].batch_bucket) == (64, 4)
    assert (b[0].bucket, b[0].batch_bucket) == (256, 8)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.weights, y.weights, rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(x.sdf, y.sdf, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(x.member_sdf, y.member_sdf, rtol=1e-6,
                                   atol=1e-9)


def test_append_month_matches_a_rescan(run_dirs, splits):
    train, _, test = splits
    stats = (train.mean_macro, train.std_macro)
    short = InferenceEngine(run_dirs, macro_history=test.macro[:-2],
                            macro_stats=stats, exec_cfg=CPU_F32)
    full = InferenceEngine(run_dirs, macro_history=test.macro,
                           macro_stats=stats, exec_cfg=CPU_F32)
    assert short.append_month(test.macro[-2]) == test.T - 2
    raw_row = test.macro[-1] * stats[1].reshape(-1) + stats[0].reshape(-1)
    assert short.append_month(raw_row, raw=True) == test.T - 1
    assert short.months == full.months == test.T
    np.testing.assert_allclose(short.macro_state_for_month(-1),
                               full.macro_state_for_month(-1), atol=1e-5)
    a = short.infer_one(_request(test, test.T - 1, month=-1))
    b = full.infer_one(_request(test, test.T - 1))
    assert a.month == b.month == test.T - 1
    np.testing.assert_allclose(a.weights, b.weights, atol=2e-5)
    with pytest.raises(ValueError, match="series"):
        short.append_month(np.zeros(3))
    with pytest.raises(ValueError, match="outside"):
        short.infer_one(_request(test, 0, month=test.T))


def _call(base, path, body=None):
    req = urllib.request.Request(
        base + path, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _fold_concurrent(service, base, path, plug_body, bodies):
    """POST `bodies` concurrently so the continuous batcher folds them into
    ONE flush: the engine's dispatch lock is held while a plug request (a
    body unlike the others) occupies the dispatcher, the bodies queue up
    behind it, and the lock is released once all of them are pending."""
    from concurrent.futures import ThreadPoolExecutor

    cb = service.cbatcher
    with ThreadPoolExecutor(len(bodies) + 1) as pool:
        with service.engine._infer_lock:
            flushes = cb.flushes
            plug = pool.submit(_call, base, path, plug_body)
            _wait_for(lambda: cb.flushes > flushes)
            futs = [pool.submit(_call, base, path, b) for b in bodies]
            _wait_for(lambda: cb.pending() == len(bodies))
        plug.result(timeout=60)
        return [f.result(timeout=60) for f in futs]


def _wait_for(cond, timeout=30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "condition never held"
        time.sleep(0.005)


def test_http_round_trip(run_dirs, splits):
    _, _, test = splits
    eng = _engine(run_dirs, splits, stock_buckets=(64, 128))
    service = ServingService(eng, mode="async")
    server = AsyncServerThread(service)
    base = f"http://127.0.0.1:{server.start()}"
    try:
        q = {"individual": test.individual[2].tolist(),
             "mask": test.mask[2].astype(float).tolist(),
             "returns": test.returns[2].tolist(), "month": 2}
        s, w = _call(base, "/v1/weights", q)
        assert s == 200 and w["month"] == 2 and w["n"] == test.N
        direct = eng.infer_one(_request(test, 2))
        np.testing.assert_allclose(w["weights"], direct.weights, atol=1e-7)
        s, f = _call(base, "/v1/sdf", q)
        assert s == 200 and len(f["member_sdf"]) == 3
        np.testing.assert_allclose(f["sdf"], direct.sdf, atol=1e-7)
        # two concurrent queries folded by the continuous batcher into one
        # flush, padded to batch bucket 4
        folded = _fold_concurrent(service, base, "/v1/sdf",
                                  dict(q, month=5),
                                  [dict(q, month=2, mask=None),
                                   dict(q, month=3, mask=None)])
        assert [st for st, _ in folded] == [200, 200] \
            and [r["month"] for _, r in folded] == [2, 3]
        assert {r["batch_bucket"] for _, r in folded} == {4}
        s, m = _call(base, "/v1/macro", {"macro": test.macro[0].tolist()})
        assert s == 200 and m["month"] == test.T
        s, w = _call(base, "/v1/weights", dict(q, month=-1))
        assert s == 200 and w["month"] == test.T
        assert _call(base, "/healthz")[1]["ok"] is True
        s, info = _call(base, "/v1/models")
        assert s == 200 and info["n_members"] == 3
        assert info["engine"]["ffn_route"] == "plain"
        assert _call(base, "/v1/sdf", {"individual": q["individual"]})[0] \
            == 400  # no returns
        assert _call(base, "/v1/weights", {"individual": [[1.0]]})[0] == 400
        assert _call(base, "/v1/weights")[0] == 405
        assert _call(base, "/v1/nope")[0] == 404
    finally:
        server.stop()
        service.close()


@pytest.mark.parametrize("module,args", [
    ("serving.server", ["--checkpoint_dirs", "ref_runs/small120x500"]),
    ("evaluate_ensemble", ["--checkpoint_dirs", "ref_runs/small120x500",
                           "--data_dir", "data/synthetic_demo"]),
    ("train", ["--data_dir", "data/synthetic_demo", "--save_dir",
               "_cli_default_device_run", "--epochs_unc", "1"]),
])
def test_cli_defaults_to_cuda_and_names_it(module, args):
    """Without --device cpu, a host with no CUDA device is an error that
    names CUDA — never a quiet run (or training) on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.{module}", *args],
        capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_evaluate_ensemble_matches_jax(run_dirs, synthetic_dir):
    port = evaluate_ensemble(run_dirs, synthetic_dir, exec_cfg=CPU_F32,
                             verbose=False)
    ref = jeval.evaluate_ensemble(run_dirs, synthetic_dir, verbose=False)
    for k in ("train_sharpe", "valid_sharpe", "test_sharpe"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(port["individual_sharpes"],
                               ref["individual_sharpes"], rtol=1e-3)
    assert port["device"] == "cpu"
