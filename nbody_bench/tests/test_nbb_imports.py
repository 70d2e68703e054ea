"""Nothing the benchmark runs imports JAX or the JAX package: module
names are compared by their top-level name, whole."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from nbody_bench import run

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_forbidden_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            # the root bench.py would import as the module "bench"
            assert n.split(".")[0] not in run.FORBIDDEN + ("bench",), (
                path, n)
    assert "BENCH_r" not in path.read_text()


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_nbody_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_nbody.fake", object())
    assert run.forbidden_modules() == ["tpu_nbody.fake"]


def test_loading_every_module_loads_no_jax():
    code = ("import sys, nbody_bench.run, nbody_bench.control, "
            "nbody_bench.system, nbody_bench.readers;"
            "from nbody_bench.system import Program;"
            "import tpu_nbody_torch.engine, tpu_nbody_torch.ops.render, "
            "tpu_nbody_torch.accuracy;"
            "from nbody_bench import run;"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
