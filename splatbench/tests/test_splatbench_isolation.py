"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the port (a scene kind imports it only inside ``program``, the
program's load)."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from splatbench import run
from splatbench.tests import fixture

REFERENCE_SIDE = ("reference", "check", "roofline", "cameras", "seeds", "trace", "registry",
                  "scenes.cloud", "scenes.c3dgs_npz", "scenes.draw")


def _imports(path, skip=()):
    """The modules ``path`` imports, but inside its top-level functions
    named in ``skip``."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if not (isinstance(n, ast.FunctionDef) and n.name in skip)]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in fixture.DATA.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in run.FORBIDDEN, (path, mod)


def test_reference_side_imports_nothing_of_the_port():
    for name in REFERENCE_SIDE:
        path = fixture.DATA / (name.replace(".", "/") + ".py")
        for mod in _imports(path, skip=("program",) if name.startswith("scenes.") else ()):
            assert mod.split(".")[0] != "websplat_tpu_torch", (path, mod)
    code = ("import sys; import " + ", ".join(f"splatbench.{n}" for n in REFERENCE_SIDE)
            + "; print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'websplat_tpu', 'websplat_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=fixture.REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("websplat_tpu_torch", "websplat_tpu_torch.ops", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    for name in ("websplat_tpu.ops", "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == ["flax", "jaxlib", "websplat_tpu.ops"]


@pytest.mark.parametrize("where", ["checkout", "bench only"])
def test_run_prints_no_result_where_it_cannot_run(tmp_path, where):
    """Here (no card) and in a directory with only BENCHMARK.json and the
    benchmark's files, a run exits non-zero and prints no result."""
    cwd = fixture.REPO
    if where == "bench only":
        shutil.copy(fixture.REPO / "BENCHMARK.json", tmp_path)
        shutil.copytree(fixture.DATA, tmp_path / "splatbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = tmp_path
    spec = json.loads((fixture.REPO / "BENCHMARK.json").read_text())
    out = subprocess.run(spec["command"] + ["--workload", spec["workloads"][0]["name"],
                                            "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, timeout=300)
    if where == "checkout":
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
