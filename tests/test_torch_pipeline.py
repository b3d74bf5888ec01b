"""The port's overlapped startup pipeline (data/pipeline.py) on the CPU:
the header probe against the JAX package's, StartupPipeline (cache miss,
then hit) bit for bit load_splits + to_batch on every wire, its compile
worker running at t≈0 and re-raising, its span and counter names, the
train CLI with the pipeline against --no_pipeline, --small_sample in the
train and sweep CLIs against the JAX subsample, and the bf16 wire
predicate."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch.data import (
    pipeline as ppipe,
)
from deeplearninginassetpricing_paperreplication_torch.data.panel import (
    load_splits,
)
from deeplearninginassetpricing_paperreplication_torch.observability.events import (
    EventLog,
)
from deeplearninginassetpricing_paperreplication_torch.reliability import (
    faults as pfaults,
)
from deeplearninginassetpricing_paperreplication_torch.utils.config import (
    ExecutionConfig,
    GANConfig,
)
from deeplearninginassetpricing_paperreplication_tpu.data import (
    pipeline as jpipe,
)
from deeplearninginassetpricing_paperreplication_tpu.data.panel import (
    load_splits as jload_splits,
)


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "panel_cache"
    monkeypatch.setenv("DLAP_PANEL_CACHE_DIR", str(d))
    monkeypatch.delenv("DLAP_PANEL_CACHE", raising=False)
    return d


def _rows(path):
    return [json.loads(x) for x in Path(path).read_text().splitlines()]


def _assert_batches_equal(ref, got):
    assert set(ref) == set(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype and ref[k].shape == got[k].shape
        assert torch.equal(ref[k], got[k]), k


def test_probe_split_shapes_equals_jax(synthetic_dir):
    assert ppipe.probe_split_shapes(synthetic_dir) == \
        jpipe.probe_split_shapes(synthetic_dir)
    shapes = ppipe.probe_split_shapes(synthetic_dir)
    for split, ds in zip(ppipe.SPLITS, load_splits(synthetic_dir)):
        assert shapes[split]["individual"] == ds.individual.shape
        assert shapes[split]["macro"] == ds.macro.shape
    (t, n, c), dtype = ppipe.npz_member_shape(
        Path(synthetic_dir) / "char" / "Char_train.npz")
    assert (t, n, c) == (24, 64, 11) and dtype == np.float32


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("chunk_bytes", [ppipe.DEFAULT_CHUNK_BYTES, 512])
def test_pipeline_miss_then_hit_equals_load_splits(synthetic_dir, cache_dir,
                                                   wire, chunk_bytes):
    ref_ds = load_splits(synthetic_dir)
    ref_b = [ds.to_batch("cpu") for ds in ref_ds]
    if wire == "bf16":
        for b in ref_b:
            b["individual"] = b["individual"].to(torch.bfloat16).float()
    for expect_hit in (False, True):
        res = ppipe.StartupPipeline(
            synthetic_dir, device="cpu", bf16_wire=wire == "bf16",
            chunk_bytes=chunk_bytes).start().result()
        assert res.cache_hits == {s: expect_hit for s in ppipe.SPLITS}
        for b_ref, b_got in zip(ref_b, res.batches):
            _assert_batches_equal(b_ref, b_got)
        for ds_ref, ds_got in zip(ref_ds, res.datasets):
            for f in ("returns", "individual", "mask", "macro", "dates",
                      "mean_macro", "std_macro"):
                np.testing.assert_array_equal(getattr(ds_ref, f),
                                              getattr(ds_got, f), err_msg=f)


def test_pipeline_macro_idx_equals_load_splits(synthetic_dir, cache_dir):
    ref = load_splits(synthetic_dir, macro_idx=[1, 2, 5])
    res = ppipe.StartupPipeline(synthetic_dir, device="cpu",
                                macro_idx=[1, 2, 5]).start().result()
    for r, g, b in zip(ref, res.datasets, res.batches):
        np.testing.assert_array_equal(r.macro, g.macro)
        assert torch.equal(b["macro"], r.to_batch("cpu")["macro"])


def test_pipeline_equals_the_jax_pipeline(synthetic_dir, cache_dir):
    """The port's batches hold the JAX pipeline's arrays, bit for bit."""
    import jax

    jres = jpipe.StartupPipeline(synthetic_dir).start().result()
    pres = ppipe.StartupPipeline(synthetic_dir, device="cpu").start().result()
    assert jres.cache_hits == {s: False for s in ppipe.SPLITS}
    assert pres.cache_hits == {s: True for s in ppipe.SPLITS}
    for jb, pb in zip(jres.batches, pres.batches):
        assert set(jb) == set(pb)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jax.device_get(jb[k])),
                                          pb[k].numpy(), err_msg=k)


def test_compile_worker_runs_at_t0_and_returns(synthetic_dir, cache_dir):
    """compile_fn starts before any split is transferred and gets the
    probed shapes; its value comes back as `compiled`."""
    seen = {}
    started = threading.Event()
    release = threading.Event()

    def compile_fn(shapes):
        started.set()
        seen["shapes"] = shapes
        release.wait(10.0)
        return "compiled-sentinel"

    pipe = ppipe.StartupPipeline(synthetic_dir, device="cpu",
                                 compile_fn=compile_fn).start()
    assert started.wait(10.0)
    # the decode and transfer run on while the compile is held
    pipe._transfer_thread.join(30.0)
    assert not pipe._transfer_thread.is_alive()
    assert set(pipe._batches) == set(ppipe.SPLITS)
    release.set()
    res = pipe.result()
    assert res.compiled == "compiled-sentinel"
    assert seen["shapes"]["train"]["individual"] == (24, 64, 10)


def test_compile_error_is_reraised(synthetic_dir, cache_dir):
    def boom(shapes):
        raise RuntimeError("compile exploded")

    with pytest.raises(RuntimeError, match="compile exploded"):
        ppipe.StartupPipeline(synthetic_dir, device="cpu",
                              compile_fn=boom).start().result()


@pytest.mark.parametrize("site", ["pipeline/transfer", "pipeline/decode"])
def test_stage_error_is_reraised(synthetic_dir, cache_dir, monkeypatch, site):
    plan = [{"site": site, "action": "raise", "trigger_count": 2}]
    monkeypatch.setenv("DLAP_FAULT_PLAN", json.dumps(plan))
    pfaults.reset_injector()
    try:
        with pytest.raises(pfaults.FaultInjected, match=site):
            ppipe.StartupPipeline(synthetic_dir, device="cpu").start().result()
    finally:
        monkeypatch.delenv("DLAP_FAULT_PLAN")
        pfaults.reset_injector()


def test_trainer_precompile_fn_on_the_plain_route(synthetic_dir):
    """The plain route (CPU, or kernel off) builds nothing."""
    shapes = ppipe.probe_split_shapes(synthetic_dir)
    cfg = GANConfig(macro_feature_dim=6, individual_feature_dim=10)
    for ec in (ExecutionConfig(device="cpu"),
               ExecutionConfig(device="cpu", kernel="off")):
        out = ppipe.trainer_precompile_fn(cfg, ec)(shapes)
        assert out == {"device": "cpu", "libraries": [], "plans": 0,
                       "programs": {}}


def test_spans_and_counters(synthetic_dir, cache_dir, tmp_path):
    """The JAX names: startup/probe, startup/compile, startup/load/<split>,
    startup/transfer/<split>, panel_cache, the startup/peak_rss gauge."""
    for expect_hit in (False, True):
        run = tmp_path / f"run_{expect_hit}"
        ev = EventLog(run, process_index=0)
        ppipe.StartupPipeline(synthetic_dir, device="cpu", events=ev,
                              compile_fn=lambda s: None).start().result()
        ev.close()
        rows = _rows(run / "events.jsonl")
        ends = {r["name"] for r in rows if r["kind"] == "span_end"}
        assert {"startup/probe", "startup/compile"} <= ends
        for split in ppipe.SPLITS:
            assert f"startup/load/{split}" in ends
            assert f"startup/transfer/{split}" in ends
        hits = [r for r in rows if r["kind"] == "counter"
                and r["name"] == "panel_cache"]
        assert sorted(r["split"] for r in hits) == sorted(ppipe.SPLITS)
        assert all(r["hit"] is expect_hit for r in hits)
        gauges = [r for r in rows if r["kind"] == "gauge"
                  and r["name"] == "startup/peak_rss"]
        assert len(gauges) == 1 and gauges[0]["value"] > 0


def _train(save_dir, data_dir, *extra):
    from deeplearninginassetpricing_paperreplication_torch import train

    train.main(["--data_dir", str(data_dir), "--save_dir", str(save_dir),
                "--epochs_unc", "2", "--epochs_moment", "1", "--epochs", "2",
                "--ignore_epoch", "0", "--print_freq", "1", "--device", "cpu",
                "--hidden_dim", "8", "4", "--num_moments", "3", *extra])
    return np.load(save_dir / "history.npz")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_cli_pipeline_against_no_pipeline(synthetic_dir, cache_dir,
                                                tmp_path, dtype):
    """The default load (the pipeline, cold then warm) trains bit for bit
    what --no_pipeline does: the same history.npz and final_model.pt."""
    runs = {}
    for label, extra in (("seq", ["--no_pipeline"]), ("cold", []),
                         ("warm", [])):
        runs[label] = _train(tmp_path / label, synthetic_dir,
                             "--compute_dtype", dtype, *extra)
    for label in ("cold", "warm"):
        assert set(runs[label].files) == set(runs["seq"].files)
        for k in runs["seq"].files:
            np.testing.assert_array_equal(runs[label][k], runs["seq"][k],
                                          err_msg=f"{label} {k}")
        assert ((tmp_path / label / "final_model.pt").read_bytes()
                == (tmp_path / "seq" / "final_model.pt").read_bytes())
    metrics = json.loads((tmp_path / "warm" / "final_metrics.json")
                         .read_text())
    assert metrics["startup"] == {"pipeline": True, "bf16_wire": False,
                                  "cache_hits": {s: True
                                                 for s in ppipe.SPLITS}}
    rows = _rows(tmp_path / "cold" / "events.jsonl")
    ends = {r["name"] for r in rows if r["kind"] == "span_end"}
    assert {"startup/pipeline", "startup/compile",
            "startup/transfer/train"} <= ends
    rows = _rows(tmp_path / "seq" / "events.jsonl")
    assert {"data/load", "data/transfer"} <= {
        r["name"] for r in rows if r["kind"] == "span_end"}


def test_train_cli_small_sample_equals_jax_subsample(synthetic_dir, cache_dir,
                                                     tmp_path, monkeypatch):
    from deeplearninginassetpricing_paperreplication_torch import train

    seen = {}

    def capture(cfg, tb, vb, testb, **kw):
        seen.update(train=tb, valid=vb, test=testb)
        raise SystemExit(0)

    monkeypatch.setattr(train, "train_3phase", capture)
    with pytest.raises(SystemExit):
        _train(tmp_path / "small", synthetic_dir, "--small_sample",
               "--n_periods", "10", "--n_stocks", "20")
    jtrain, jvalid, jtest = jload_splits(synthetic_dir)
    for name, ds in (("train", jtrain), ("valid", jvalid), ("test", jtest)):
        ref = ds.subsample(min(10, ds.T), 20).full_batch()
        assert set(ref) == set(seen[name])
        for k in ref:
            np.testing.assert_array_equal(seen[name][k].numpy(), ref[k],
                                          err_msg=f"{name} {k}")


def test_sweep_cli_small_sample_equals_jax_subsample(synthetic_dir, cache_dir,
                                                     tmp_path, monkeypatch):
    from deeplearninginassetpricing_paperreplication_torch import sweep

    seen = {}

    def capture(configs, seeds, tb, vb, **kw):
        seen.update(train=tb, valid=vb)
        raise SystemExit(0)

    monkeypatch.setattr(sweep, "run_sweep", capture)
    with pytest.raises(SystemExit):
        sweep.main(["--data_dir", str(synthetic_dir), "--save_dir",
                    str(tmp_path / "sw"), "--quick", "--search_only",
                    "--device", "cpu", "--small_sample", "--n_periods", "12",
                    "--n_stocks", "30"])
    jtrain, jvalid, _ = jload_splits(synthetic_dir)
    for name, ds in (("train", jtrain), ("valid", jvalid)):
        ref = ds.subsample(min(12, ds.T), 30).full_batch()
        for k in ref:
            np.testing.assert_array_equal(seen[name][k].numpy(), ref[k],
                                          err_msg=f"{name} {k}")


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"compute_dtype": "float32"}, False),
    ({"kernel": "off"}, False),
    ({"device": "cpu"}, False),
    ({"kernel": "on"}, True),
])
def test_bf16_wire_predicate_execution(change, ok):
    cfg = GANConfig(macro_feature_dim=178, individual_feature_dim=46)
    assert ExecutionConfig(**change).bf16_wire_ok(cfg) is ok


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"hidden_dim": (128, 128)}, True),
    ({"hidden_dim": (64, 64, 64)}, True),
    ({"hidden_dim": ()}, False),
    # the streamed route and the moment chunks round x as the resident
    # kernels do
    ({"hidden_dim": (256,)}, True),
    ({"hidden_dim": (8,) * 9}, True),
    ({"hidden_dim_moment": (16,)}, False),
    ({"macro_feature_dim": 0}, False),
    ({"num_condition_moment": 17}, True),
    # past the streamed route's width and depth no kernel takes the stack
    ({"hidden_dim": (4096,)}, False),
    ({"hidden_dim": (8,) * 65}, False),
])
def test_bf16_wire_predicate_model(change, ok):
    cfg = GANConfig(**{**dict(macro_feature_dim=178,
                              individual_feature_dim=46), **change})
    assert ExecutionConfig().bf16_wire_ok(cfg) is ok
