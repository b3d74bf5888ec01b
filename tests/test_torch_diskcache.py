"""The port's decoded-panel disk cache (data/diskcache.py) and its readers
(data/pipeline.load_splits_cached, load_splits_chunked) on the CPU: the
same CACHE_VERSION, keys and on-disk layout as the JAX package's, so an
entry either package writes loads in the other bit for bit (and the two
write byte-identical entries); the miss, hit, content change and
corrupt-entry fallback; the chunked store's shards, with a torn shard
re-decoding alone."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearninginassetpricing_paperreplication_torch.data import (
    diskcache as pcache,
)
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
from deeplearninginassetpricing_paperreplication_tpu.data import (
    diskcache as jcache,
)
from deeplearninginassetpricing_paperreplication_tpu.data import (
    pipeline as jpipe,
)

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("returns", "individual", "mask", "macro", "dates", "mean_macro",
          "std_macro")


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    """Every test gets a private, empty panel cache."""
    d = tmp_path / "panel_cache"
    monkeypatch.setenv("DLAP_PANEL_CACHE_DIR", str(d))
    monkeypatch.delenv("DLAP_PANEL_CACHE", raising=False)
    monkeypatch.delenv("DLAP_PANEL_SHARD_WIDTH", raising=False)
    return d


@pytest.fixture(scope="module")
def ref_splits(synthetic_dir):
    return load_splits(synthetic_dir)


def _assert_splits_equal(ref, got, columns=None):
    for r, g, name in zip(ref, got, ("train", "valid", "test")):
        a, b = columns if columns is not None else (0, r.N)
        for field in FIELDS:
            x, y = getattr(r, field), getattr(g, field)
            if field in ("returns", "mask"):
                x = x[:, a:b]
            elif field == "individual":
                x = x[:, a:b, :]
            assert np.asarray(x).dtype == np.asarray(y).dtype, (name, field)
            np.testing.assert_array_equal(x, y, err_msg=f"{name} {field}")


def _entry_files(d):
    return {p.relative_to(d): p.read_bytes()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def test_constants_and_keys_equal_jax(synthetic_dir, cache_dir):
    assert pcache.CACHE_VERSION == jcache.CACHE_VERSION
    assert pcache.DEFAULT_SHARD_WIDTH == jcache.DEFAULT_SHARD_WIDTH
    assert pcache.SHARD_ARRAYS == jcache.SHARD_ARRAYS
    assert pcache.cache_root() == jcache.cache_root() == cache_dir
    for split in ppipe.SPLITS:
        char, macro = ppipe.split_paths(synthetic_dir, split)
        assert pcache.entry_key(char, macro) == jcache.entry_key(char, macro)
        for w in (None, 16, 40):
            assert (pcache.chunked_entry_key(char, macro, w)
                    == jcache.chunked_entry_key(char, macro, w))
    assert pcache.shard_bounds(64, 24) == jcache.shard_bounds(64, 24)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_monolithic_entries_cross_load(synthetic_dir, ref_splits, tmp_path,
                                       monkeypatch, writer):
    """Each package stores the three splits in its own cache dir; the
    entries are byte-identical, and each package's hit on the other's
    entry is bit for bit load_splits."""
    dirs = {}
    for pkg, pipe in (("port", ppipe), ("jax", jpipe)):
        dirs[pkg] = tmp_path / f"cache_{pkg}"
        monkeypatch.setenv("DLAP_PANEL_CACHE_DIR", str(dirs[pkg]))
        pipe.load_splits_cached(synthetic_dir)
    assert _entry_files(dirs["port"]) == _entry_files(dirs["jax"])
    reader = "jax" if writer == "port" else "port"
    monkeypatch.setenv("DLAP_PANEL_CACHE_DIR", str(dirs[writer]))
    ev = EventLog(tmp_path / "run", process_index=0)
    if reader == "port":
        got = ppipe.load_splits_cached(synthetic_dir, events=ev)
    else:
        got = jpipe.load_splits_cached(synthetic_dir)
    ev.close()
    _assert_splits_equal(ref_splits, got)
    if reader == "port":
        rows = [json.loads(x) for x in
                (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
        hits = [r for r in rows if r["name"] == "panel_cache"]
        assert len(hits) == 3 and all(r["hit"] for r in hits)
    for split in ppipe.SPLITS:
        char, macro = ppipe.split_paths(synthetic_dir, split)
        load = (pcache if reader == "port" else jcache).load
        entry = load(char, macro)
        assert entry is not None and entry.idx is not None
        assert entry.idx.dtype == np.int32


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("width", [16, 24])
def test_chunked_entries_cross_load(synthetic_dir, ref_splits, tmp_path,
                                    monkeypatch, writer, width):
    dirs = {}
    for pkg, pipe in (("port", ppipe), ("jax", jpipe)):
        dirs[pkg] = tmp_path / f"cache_{pkg}"
        monkeypatch.setenv("DLAP_PANEL_CACHE_DIR", str(dirs[pkg]))
        pipe.load_splits_chunked(synthetic_dir, shard_width=width)
    assert _entry_files(dirs["port"]) == _entry_files(dirs["jax"])
    monkeypatch.setenv("DLAP_PANEL_CACHE_DIR", str(dirs[writer]))
    reader = ppipe if writer == "jax" else jpipe
    _assert_splits_equal(ref_splits, reader.load_splits_chunked(
        synthetic_dir, shard_width=width))
    _assert_splits_equal(ref_splits, reader.load_splits_chunked(
        synthetic_dir, shard_width=width, columns=(10, 40)), (10, 40))
    for split in ppipe.SPLITS:
        char, macro = ppipe.split_paths(synthetic_dir, split)
        entry = (pcache if writer == "jax" else jcache).load_chunked(
            char, macro, width)
        assert entry is not None and entry.width == width
        assert all(entry.verify_shard(i)[0] for i in range(entry.n_shards))


def test_cache_miss_then_hit(synthetic_dir, ref_splits, cache_dir):
    a = ppipe.load_splits_cached(synthetic_dir)
    b = ppipe.load_splits_cached(synthetic_dir)
    _assert_splits_equal(ref_splits, a)
    _assert_splits_equal(ref_splits, b)
    assert len([d for d in cache_dir.iterdir() if d.is_dir()]) == 3
    # a hit's big arrays are read-only memmaps
    assert isinstance(b[0].individual, np.memmap)


def test_cache_misses_on_mtime_change_and_evicts(synthetic_dir, tmp_path,
                                                 cache_dir):
    data_dir = tmp_path / "data"
    shutil.copytree(synthetic_dir, data_dir)
    char, macro = ppipe.split_paths(data_dir, "train")
    ppipe._load_split_raw(char, macro)
    assert ppipe._load_split_raw(char, macro).cache_hit
    st = char.stat()
    os.utime(char, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    assert not ppipe._load_split_raw(char, macro).cache_hit
    assert len([d for d in cache_dir.iterdir() if d.is_dir()]) == 1


def test_cache_misses_on_content_change(synthetic_dir, tmp_path, cache_dir):
    data_dir = tmp_path / "data"
    shutil.copytree(synthetic_dir, data_dir)
    char, macro = ppipe.split_paths(data_dir, "train")
    ppipe._load_split_raw(char, macro)
    assert ppipe._load_split_raw(char, macro).cache_hit
    with np.load(char, allow_pickle=True) as z:
        arrs = {k: z[k].copy() for k in z.files}
    arrs["data"] = arrs["data"] + np.float32(1.0)
    np.savez(char, **arrs)
    raw = ppipe._load_split_raw(char, macro)
    assert not raw.cache_hit
    fresh = ppipe._load_split_raw(char, macro)
    assert fresh.cache_hit
    np.testing.assert_array_equal(fresh.ds.returns, raw.ds.returns)


@pytest.mark.parametrize("damage", ["truncate_array", "bad_meta",
                                    "missing_array"])
def test_corrupt_entry_falls_back_to_npz(synthetic_dir, ref_splits,
                                         cache_dir, damage):
    char, macro = ppipe.split_paths(synthetic_dir, "train")
    ppipe._load_split_raw(char, macro)
    entry = [d for d in cache_dir.iterdir() if d.is_dir()][0]
    if damage == "truncate_array":
        p = entry / "individual.npy"
        p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    elif damage == "bad_meta":
        (entry / "meta.json").write_text("{not json")
    else:
        (entry / "rows.npy").unlink()
    raw = ppipe._load_split_raw(char, macro)
    assert not raw.cache_hit
    np.testing.assert_array_equal(raw.ds.individual, ref_splits[0].individual)
    assert ppipe._load_split_raw(char, macro).cache_hit  # re-stored


def test_cache_disabled_by_env(synthetic_dir, cache_dir, monkeypatch):
    monkeypatch.setenv("DLAP_PANEL_CACHE", "0")
    ppipe.load_splits_cached(synthetic_dir)
    ppipe.load_splits_chunked(synthetic_dir)
    assert not cache_dir.exists() or not any(cache_dir.iterdir())


def test_shard_width_env_knob(synthetic_dir, cache_dir, monkeypatch):
    monkeypatch.setenv("DLAP_PANEL_SHARD_WIDTH", "24")
    assert pcache.shard_width() == 24 == jcache.shard_width()
    assert pcache.shard_width(8) == 8
    ppipe.load_splits_chunked(synthetic_dir, shard_width=24)
    char, macro = ppipe.split_paths(synthetic_dir, "train")
    entry = pcache.load_chunked(char, macro)
    assert entry is not None and entry.bounds() == [(0, 24), (24, 48),
                                                    (48, 64)]


def test_full_span_read_stores_both_formats(synthetic_dir, ref_splits,
                                            cache_dir, tmp_path):
    """A width-agnostic full-span read (the sweep, ensemble and serving
    CLIs) stores the chunked and the monolithic entry from one decode, and
    its warm rerun is a monolithic hit."""
    _assert_splits_equal(ref_splits, ppipe.load_splits_chunked(synthetic_dir))
    assert len([d for d in cache_dir.iterdir() if d.is_dir()]) == 6
    ev = EventLog(tmp_path / "run", process_index=0)
    _assert_splits_equal(ref_splits,
                         ppipe.load_splits_chunked(synthetic_dir, events=ev))
    ev.close()
    rows = [json.loads(x) for x in
            (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    hits = [r for r in rows if r["name"] == "panel_cache"]
    assert all(r["hit"] and r["chunked"] is False for r in hits)


def test_columns_span_loads_only_owned_shards(synthetic_dir, ref_splits,
                                              cache_dir, tmp_path):
    ppipe.load_splits_chunked(synthetic_dir, shard_width=16)
    ev = EventLog(tmp_path / "run", process_index=0)
    got = ppipe.load_splits_chunked(synthetic_dir, columns=(16, 48),
                                    shard_width=16, events=ev)
    ev.close()
    _assert_splits_equal(ref_splits, got, (16, 48))
    rows = [json.loads(x) for x in
            (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    owned = [r for r in rows if r["name"] == "startup/shard_owned"]
    loaded = [r for r in rows if r["name"] == "startup/shard_loaded"]
    assert {r["value"] for r in owned} == {2} and len(owned) == 3
    assert {r["value"] for r in loaded} == {2} and len(loaded) == 3


def test_corrupt_manifest_falls_back_to_fresh_store(synthetic_dir, ref_splits,
                                                    cache_dir):
    ppipe.load_splits_chunked(synthetic_dir, shard_width=32)
    char, macro = ppipe.split_paths(synthetic_dir, "train")
    entry = pcache.load_chunked(char, macro, width=32)
    for p in (entry.dir / "meta.json", entry.dir / "meta.json.g1"):
        if p.exists():
            p.write_text("{not json")
    _assert_splits_equal(ref_splits, ppipe.load_splits_chunked(
        synthetic_dir, shard_width=32))
    entry = pcache.load_chunked(char, macro, width=32)
    assert entry is not None
    assert all(entry.verify_shard(i)[0] for i in range(entry.n_shards))


@pytest.mark.parametrize("how", ["fault_plan", "truncated_on_disk"])
def test_torn_shard_redecodes_alone(synthetic_dir, ref_splits, cache_dir,
                                    tmp_path, monkeypatch, how):
    """A torn shard (through the data/shard_read fault site, or truncated
    on disk) fails its digest, re-decodes from the npz and is repaired in
    place; no other shard re-decodes, and the splits stay bit for bit."""
    ppipe.load_splits_chunked(synthetic_dir, shard_width=16)
    if how == "fault_plan":
        plan = [{"site": "data/shard_read", "action": "truncate_file",
                 "match": "s00002", "trigger_count": 1}]
        monkeypatch.setenv("DLAP_FAULT_PLAN", json.dumps(plan))
    else:
        char, macro = ppipe.split_paths(synthetic_dir, "valid")
        p = pcache.load_chunked(char, macro, 16).shard_path(2, "returns")
        p.write_bytes(p.read_bytes()[:40])
    pfaults.reset_injector()
    ev = EventLog(tmp_path / "run", process_index=0)
    try:
        got = ppipe.load_splits_chunked(synthetic_dir, shard_width=16,
                                        events=ev)
    finally:
        monkeypatch.delenv("DLAP_FAULT_PLAN", raising=False)
        pfaults.reset_injector()
    ev.close()
    _assert_splits_equal(ref_splits, got)
    rows = [json.loads(x) for x in
            (tmp_path / "run" / "events.jsonl").read_text().splitlines()]
    redecodes = [r for r in rows if r["name"] == "startup/shard_redecode"]
    assert len(redecodes) == 1 and redecodes[0]["shard"] == 2
    if how == "truncated_on_disk":
        assert redecodes[0]["split"] == "valid"
    loaded = sum(r["value"] for r in rows if r["name"] == "startup/shard_loaded")
    assert loaded == 3 * 4 - 1
    for split in ppipe.SPLITS:
        char, macro = ppipe.split_paths(synthetic_dir, split)
        entry = pcache.load_chunked(char, macro, width=16)
        assert all(entry.verify_shard(i)[0] for i in range(entry.n_shards))


def test_clear_and_cli(synthetic_dir, cache_dir):
    ppipe.load_splits_cached(synthetic_dir)
    env = dict(os.environ, DLAP_PANEL_CACHE_DIR=str(cache_dir))
    mod = "deeplearninginassetpricing_paperreplication_torch.data.diskcache"
    listing = subprocess.run([sys.executable, "-m", mod], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
    assert listing.returncode == 0, listing.stderr
    assert "3 entries" in listing.stdout
    cleared = subprocess.run([sys.executable, "-m", mod, "--clear"], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120)
    assert cleared.returncode == 0, cleared.stderr
    assert "removed 3 entries" in cleared.stdout
    assert pcache.clear() == 0
