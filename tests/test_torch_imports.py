"""The PyTorch port imports no JAX: not jax, flax or optax, and nothing of
the JAX package (whose __init__ pulls in jax and flax) — checked at runtime
in a fresh interpreter and statically over every source file of the port
and chip_smoke.py."""

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
    assert out["n"] >= 15
    assert out["bad"] == []


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
