"""The PyTorch port imports no JAX: not jax, flax or optax, and nothing of
the JAX package (whose __init__ pulls in jax and flax) — checked at runtime
in a fresh interpreter and statically over every source file of the port
and chip_smoke.py. The port's stdlib copies (observability, the fault
injector, the batchers, the flight recorder, the downloader) also load by
path without torch or numpy, and its numpy-only copies (the panel cache,
the codec loader) without torch."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = "deeplearninginassetpricing_paperreplication_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "deeplearninginassetpricing_paperreplication_tpu")
SOURCES = sorted((ROOT / PKG).rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return [".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "") for p in sorted((ROOT / PKG).rglob("*.py"))]


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n"] >= 40  # the serving and observability modules included
    assert out["bad"] == []


DATA_PLANE = ["data.native", "data.panel", "data.transfer", "data.diskcache",
              "data.pipeline", "data.download"]


def test_the_data_plane_modules_are_imported():
    """The data plane is among the modules the runtime check imports."""
    mods = set(_modules())
    for m in DATA_PLANE:
        assert f"{PKG}.{m}" in mods, m


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}")


# modules whose top level is stdlib only: a thin parent loads them by path
STDLIB_ONLY = [
    "observability/events.py", "observability/metrics.py",
    "observability/tracecontext.py", "observability/heartbeat.py",
    "observability/manifest.py", "observability/report.py",
    "observability/logging.py", "observability/memory.py",
    "observability/programs.py",
    "reliability/faults.py", "reliability/guard.py",
    "reliability/supervisor.py", "reliability/scheduler.py",
    "reliability/ledger.py", "reliability/verified.py", "serving/batcher.py",
    "serving/flight.py", "data/download.py",
]
# modules whose top level is numpy and the stdlib only
NUMPY_ONLY = ["data/diskcache.py", "data/native.py"]


@pytest.mark.parametrize("rel", STDLIB_ONLY + NUMPY_ONLY)
def test_stdlib_only_module_loads_without_torch(rel):
    """Load the module by path as a package member (its relative imports
    resolve against stub parents), then check no torch or JAX got imported
    (nor numpy, for the stdlib-only ones)."""
    code = (
        "import importlib.util, json, sys, types\n"
        f"root = {str(ROOT / PKG)!r}\n"
        f"rel = {rel!r}\n"
        f"pkg = {PKG!r}\n"
        "sub = rel.split('/')[0]\n"
        "for name, path in ((pkg, root), (pkg + '.' + sub, root + '/' + sub)):\n"
        "    m = types.ModuleType(name); m.__path__ = [path]\n"
        "    sys.modules[name] = m\n"
        "name = pkg + '.' + rel[:-3].replace('/', '.')\n"
        "spec = importlib.util.spec_from_file_location(name, root + '/' + rel)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules[name] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN + ('torch',) + (('numpy',) if rel in STDLIB_ONLY else ())!r})\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_package_exports_the_data_plane():
    """The package exports the JAX package's data-plane names (but the
    mesh's stream_batch_sharded), resolved at first use."""
    import importlib

    port = importlib.import_module(PKG)
    data = importlib.import_module(PKG + ".data")
    names = {"PanelDataset", "load_panel", "load_splits", "StartupPipeline",
             "load_splits_cached", "load_splits_chunked", "stream_batch",
             "generate_all_splits", "generate_dataset"}
    assert set(port.__all__) == names == set(data.__all__)
    from deeplearninginassetpricing_paperreplication_torch.data import (
        pipeline,
    )
    assert port.StartupPipeline is data.StartupPipeline is \
        pipeline.StartupPipeline
    with pytest.raises(AttributeError):
        port.stream_batch_sharded
