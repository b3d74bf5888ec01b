"""The sharded data plane and ``train --shard_stocks`` on CPU ranks, as
``tests/test_dataplane.py`` holds the JAX package's.

* ``stream_batch_sharded`` on each of two gloo ranks is bit for bit
  ``partition.shard_batch``'s slice (the JAX package's ``shard_batch``
  layout), on the f32 and the bf16 wire, with one ``startup/shard_transfer``
  span per shard naming its ``start``/``stop``;
* padded panels carry the true ``n_assets``; an N that does not divide is
  refused; the per-shard spans are JAX's ``devices_indices_map``;
* ``StartupPipeline(mesh=)`` reads only its rank's columns from the chunked
  store (its shards, none re-decoded) and ships them, bit for bit;
* the train CLI with ``--shard_stocks`` launched by
  ``torch.distributed.run`` at world size 2 into ``tmp_path`` (within the
  training bars of the unsharded CLI; only rank 0 writes the run dir; the
  manifest records the mesh; the ranks end bit for bit equal), and without
  a process group bit for bit the CLI without the flag.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearninginassetpricing_paperreplication_torch import train
from deeplearninginassetpricing_paperreplication_torch.data.panel import (
    load_splits,
)
from deeplearninginassetpricing_paperreplication_torch.data.pipeline import (
    load_splits_chunked,
    stream_batch_sharded,
)
from deeplearninginassetpricing_paperreplication_torch.data.synthetic import (
    generate_all_splits,
)
from deeplearninginassetpricing_paperreplication_torch.parallel import (
    partition,
)
from deeplearninginassetpricing_paperreplication_tpu.parallel import (
    partition as jpartition,
)
from test_torch_shard_ranks import data_worker, spawn

ROOT = Path(__file__).resolve().parents[1]
PKG = "deeplearninginassetpricing_paperreplication_torch"
SPLITS = ("train", "valid", "test")
WIDTH = 16  # chunked-store shard width: 4 shards of a 63-stock split


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A ragged panel (63 stocks: padded to 64 at world size 2)."""
    out = tmp_path_factory.mktemp("shard_data")
    generate_all_splits(out, n_periods_train=24, n_periods_valid=8,
                        n_periods_test=12, n_stocks=63, n_features=10,
                        n_macro=6, seed=9, verbose=False)
    return out


@pytest.fixture(scope="module")
def ranks(data_dir, tmp_path_factory):
    """Two ranks' streamed batches and pipeline results, over a chunked
    store warmed by this process (so the ranks read, not decode)."""
    import os

    cache = tmp_path_factory.mktemp("shard_cache")
    old = os.environ.get("DLAP_PANEL_CACHE_DIR")
    os.environ["DLAP_PANEL_CACHE_DIR"] = str(cache)
    try:
        load_splits_chunked(data_dir, shard_width=WIDTH)
        wd = tmp_path_factory.mktemp("shard_data_ranks")
        spawn(data_worker, 2, wd, str(data_dir), WIDTH)
    finally:
        if old is None:
            del os.environ["DLAP_PANEL_CACHE_DIR"]
        else:
            os.environ["DLAP_PANEL_CACHE_DIR"] = old
    outs = [torch.load(wd / f"data{r}.pt", weights_only=False)
            for r in range(2)]
    events = [[json.loads(x) for x in (wd / f"ev{r}" / name).read_text()
               .splitlines()] for r, name in ((0, "events.jsonl"),
                                               (1, "events.proc1.jsonl"))]
    return outs, events


def _host_batches(data_dir, world):
    return [ds.pad_stocks(world).full_batch() for ds in load_splits(data_dir)]


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16).float()


def test_stream_batch_sharded_is_shard_batch_slice(ranks, data_dir):
    """Each rank's streamed split, f32 and bf16 wire, is bit for bit
    shard_batch's slice of the padded host batch (the bf16 wire's panel
    rounded to bf16 first), with n_assets 63."""
    outs, _ = ranks
    mesh = partition.create_mesh(devices=range(2))
    for name, host in zip(SPLITS, _host_batches(data_dir, 2)):
        tb = {k: torch.as_tensor(np.asarray(v, np.float32))
              for k, v in host.items()}
        for r, o in enumerate(outs):
            want = partition.shard_batch(tb, mesh, device=r)
            for wire in (False, True):
                got = o["streamed"][(name, wire)]
                assert set(got) == set(want)
                for k, v in want.items():
                    ref = _bf16(v) if wire and k == "individual" else v
                    assert torch.equal(got[k], ref), (name, r, wire, k)
                assert float(got["n_assets"]) == 63.0


def test_shard_transfer_spans_name_each_shard(ranks):
    """One startup/shard_transfer span per shipped shard, with the rank's
    start/stop: six streamed splits and the pipeline's three."""
    _, events = ranks
    for r, rows in enumerate(events):
        spans = [e for e in rows if e.get("kind") == "span_end"
                 and e.get("name") == "startup/shard_transfer"]
        assert len(spans) == 9
        assert {(e["start"], e["stop"], e["shard"]) for e in spans} == {
            (32 * r, 32 * (r + 1), r)}


def test_startup_pipeline_mesh_reads_only_its_columns(ranks, data_dir):
    """StartupPipeline(mesh=) serves each rank its padded span from the
    chunked store, reading only the shards its columns touch (2 of 4 a
    split), none re-decoded; its batches are shard_batch's slices."""
    outs, events = ranks
    mesh = partition.create_mesh(devices=range(2))
    for r, (o, rows) in enumerate(zip(outs, events)):
        owned = [e for e in rows if e.get("kind") == "counter"
                 and e.get("name") == "startup/shard_owned"]
        loaded = [e for e in rows if e.get("kind") == "counter"
                  and e.get("name") == "startup/shard_loaded"]
        assert sorted(e["value"] for e in owned) == [2, 2, 2]
        assert sorted(e["value"] for e in loaded) == [2, 2, 2]
        assert not [e for e in rows if e.get("name") ==
                    "startup/shard_redecode"]
        assert o["pipeline"]["n"] == [32, 32, 32]
        assert o["pipeline"]["n_assets"] == [63, 63, 63]
        for host, got in zip(_host_batches(data_dir, 2),
                             o["pipeline"]["batches"]):
            tb = {k: torch.as_tensor(np.asarray(v, np.float32))
                  for k, v in host.items()}
            want = partition.shard_batch(tb, mesh, device=r)
            for k, v in want.items():
                assert torch.equal(got[k], v), (r, k)


def test_padded_n_assets_indivisible_n_and_spans(data_dir):
    """The padded panel's shards carry the true count; an unpadded N the
    mesh does not divide is refused by both routes; the spans are JAX's
    NamedSharding's over a 1-D stocks mesh; one shard adds nothing."""
    ds = load_splits(data_dir)[0]
    mesh4 = partition.create_mesh(devices=range(4))
    tb = {k: torch.as_tensor(np.asarray(v, np.float32))
          for k, v in ds.pad_stocks(4).full_batch().items()}
    jmesh = jpartition.create_mesh(4)
    jmap = jpartition.batch_shardings(jmesh)["returns"].devices_indices_map(
        (ds.T, 64))
    jspans = sorted(sl[1].indices(64)[:2] for sl in jmap.values())
    spans = [partition.stock_span(64, mesh4, r) for r in range(4)]
    assert spans == jspans == [(0, 16), (16, 32), (32, 48), (48, 64)]
    for r in range(4):
        local = partition.shard_batch(tb, mesh4, device=r)
        assert local["returns"].shape == (ds.T, 16)
        assert local["individual"].is_contiguous()
        assert float(local["n_assets"]) == 63.0
    with pytest.raises(ValueError, match="not divisible"):
        partition.shard_batch(ds.full_batch(), mesh4)
    with pytest.raises(ValueError, match="not divisible"):
        stream_batch_sharded(ds.full_batch(), mesh4, device="cpu")
    one = partition.shard_batch(ds.full_batch(), partition.create_mesh(
        devices=[0]))
    assert "n_assets" not in one
    # the JAX rule set's layout, key for key
    jsh = jpartition.batch_shardings(jmesh)
    for k, s in partition.batch_shardings(mesh4).items():
        assert tuple(s.spec) == tuple(jsh[k].spec), k


# -- the train CLI -------------------------------------------------------------


def _cli(data_dir, save, *extra):
    return ["--data_dir", str(data_dir), "--save_dir", str(save),
            "--epochs_unc", "4", "--epochs_moment", "2", "--epochs", "6",
            "--ignore_epoch", "1", "--hidden_dim", "8", "8", "--rnn_dim", "4",
            "--num_moments", "4", "--device", "cpu", "--compute_dtype",
            "float32", *extra]


@pytest.fixture(scope="module")
def cli_runs(data_dir, tmp_path_factory):
    """The train CLI's run dirs: without the flag, with --shard_stocks and
    no process group, and under torch.distributed.run at world size 2."""
    out = tmp_path_factory.mktemp("shard_cli")
    plain, flag, world2 = (out / n for n in ("plain", "flag", "w2"))
    train.main(_cli(data_dir, plain))
    train.main(_cli(data_dir, flag, "--shard_stocks"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", f"{PKG}.train",
         *_cli(data_dir, world2, "--shard_stocks")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return plain, flag, world2


def test_train_cli_shard_stocks(cli_runs):
    """--shard_stocks without a process group is bit for bit the CLI
    without it; under torch.distributed.run at world size 2 every epoch is
    within the training bars of the unsharded CLI, the ranks end bit for
    bit equal, rank 0 alone writes the run dir and the manifest records
    the mesh."""
    plain, flag, world2 = cli_runs
    ha, hb = np.load(plain / "history.npz"), np.load(flag / "history.npz")
    assert set(ha.files) == set(hb.files)
    for k in ha.files:
        assert np.array_equal(ha[k], hb[k]), k
    assert ((plain / "final_model.pt").read_bytes()
            == (flag / "final_model.pt").read_bytes())
    assert "world size 1" in (flag / "events.jsonl").read_text()

    h2 = np.load(world2 / "history.npz")
    for k in ("train_loss", "valid_loss", "test_loss"):
        np.testing.assert_allclose(h2[k], ha[k], rtol=1e-3, err_msg=k)
    for k in ("train_sharpe", "valid_sharpe", "test_sharpe"):
        np.testing.assert_allclose(h2[k], ha[k], atol=5e-3, err_msg=k)
    mesh = json.loads((world2 / "manifest.json").read_text())["devices"][
        "mesh"]
    assert mesh["world_size"] == 2 and mesh["backend"] == "gloo"
    assert [(r["start"], r["stop"], r["device"]) for r in mesh["ranks"]] == [
        (0, 32, "cpu"), (32, 64, "cpu")]
    digests = []
    for name in ("events.jsonl", "events.proc1.jsonl"):
        rows = [json.loads(x) for x in (world2 / name).read_text()
                .splitlines()]
        digests += [e["sha256"] for e in rows
                    if e.get("name") == "shard/final_params"]
    assert len(digests) == 2 and digests[0] == digests[1]
    assert not list(world2.glob("heartbeat.proc*"))
    assert (world2 / "final_model.pt").exists()
    assert json.loads((world2 / "final_metrics.json").read_text())[
        "test"]["sharpe"] == pytest.approx(
        json.loads((plain / "final_metrics.json").read_text())["test"][
            "sharpe"], abs=5e-3)


def test_train_cli_shard_stocks_profiles_the_whole_train_panel(cli_runs):
    """The drift profile of the world-size-2 run is the unsharded run's:
    the whole 63-stock train split, not rank 0's span."""
    plain, flag, world2 = cli_runs
    profiles = [json.loads((d / "reference_profile.json").read_text())
                for d in (plain, flag, world2)]
    for p in profiles:
        del p["written_at"]
    assert profiles[0]["n_stocks"] == 63
    assert profiles[2] == profiles[0]
    assert profiles[1] == profiles[0]
