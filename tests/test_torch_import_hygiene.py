"""The port stands alone: ``repro_torch`` and the port's examples
(``examples/torch/*.py``) import neither ``jax`` nor any module of the JAX
package ``repro``.

The check runs in a fresh interpreter, because this test process has JAX
loaded already (``conftest.py`` imports the JAX autotuner for every test).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PKG = SRC / "repro_torch"
PY_FILES = sorted(p.relative_to(SRC).as_posix() for p in PKG.rglob("*.py"))
EXAMPLES = sorted(p.name for p in (ROOT / "examples" / "torch").glob("*.py"))


def _module_name(rel: str) -> str:
    mod = rel[:-3].replace("/", ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def test_fresh_import_leaves_jax_and_repro_out():
    modules = [_module_name(p) for p in PY_FILES]
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(tree: ast.AST, rel: str):
    """Absolute module names every import statement in a file names."""
    pkg_parts = rel[:-3].split("/")[:-1]
    if rel.endswith("__init__.py"):
        pkg_parts = rel[:-len("/__init__.py")].split("/")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[:len(pkg_parts) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


@pytest.mark.parametrize("rel", PY_FILES)
def test_no_jax_or_repro_import(rel):
    tree = ast.parse((SRC / rel).read_text(), filename=rel)
    names = list(_imports(tree, rel))
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{rel} imports {bad}"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax_or_repro(name):
    path = ROOT / "examples" / "torch" / name
    names = list(_imports(ast.parse(path.read_text(), filename=name),
                          f"examples/torch/{name}"))
    assert any(n.startswith("repro_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"examples/torch/{name} imports {bad}"


def test_examples_load_without_jax_or_repro():
    """Each example's module body, run in a fresh interpreter (its
    ``main`` is not called), leaves ``jax`` and ``repro`` out."""
    assert len(EXAMPLES) == 7
    paths = [str(ROOT / "examples" / "torch" / n) for n in EXAMPLES]
    code = (
        "import json, runpy, sys\n"
        f"for p in {paths!r}:\n"
        "    runpy.run_path(p)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = list(_imports(tree, "chip_smoke.py"))
    assert [n for n in names
            if n.split(".")[0] in ("jax", "jaxlib", "repro")] == []


def test_chip_smoke_fails_without_a_card():
    """No CUDA device: a non-zero exit and no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok"' not in out.stdout
