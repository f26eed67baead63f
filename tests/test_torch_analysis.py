"""The port's repro-lint (``repro_torch.analysis``,
``repro_torch.launch.analyze``) against the JAX package's
(``repro.analysis``, ``tools/analyze.py``) on the same inputs.

* Every shared fixture pair under ``tests/analysis_fixtures/`` (parsed,
  never imported) gives the same findings in both packages, fingerprint
  for fingerprint and line for line.
* The jit-safety rules find PyTorch's traced scopes: a rewrite of the JAX
  fixtures with the same bodies under ``@torch.compile``, ``@triton.jit``
  and ``torch.jit.script`` gives the reference's codes on the reference's
  lines.  The rewrites are strings written into ``tmp_path``; the files
  are only parsed, so no ``triton`` is needed.
* The reference's suppression, fingerprint and baseline battery runs
  against both engines.
* Both analyzers over ``src/repro_torch`` find nothing new and the same
  things; the port's CLI self-tests, gates, fails on an injected violation
  and reports dead modules by name.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as jan
import repro_torch.analysis as tan
from repro.analysis.deadmods import dead_module_report as jax_dead_report
from repro_torch.analysis.deadmods import dead_module_report

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "analysis_fixtures"
SRC = REPO / "src" / "repro_torch"
PACKAGES = {"jax": jan, "torch": tan}

# fixture -> (checker class name, constructor kwargs), as the reference's
# battery (tests/test_analysis.py) runs them
SHARED = {
    "conc": ("ConcurrencyChecker", {"path_prefixes": ("",)}),
    "exc": ("ExceptionHygieneChecker", {}),
    "met": ("MetricHygieneChecker", {}),
    "tune": ("TunerSeamChecker", {}),
}


def _run(pkg, checker, paths, root):
    findings, n_files = pkg.analyze_paths([str(p) for p in paths], [checker],
                                          root=str(root))
    assert n_files == len(paths)
    return findings


def _key(findings):
    return [(f.fingerprint, f.line, f.code, f.message, f.checker)
            for f in findings]


# -- shared fixture pairs -----------------------------------------------------

@pytest.mark.parametrize("variant", ["bad", "clean"])
@pytest.mark.parametrize("prefix", sorted(SHARED))
def test_fixture_findings_equal_the_reference(prefix, variant):
    cls, kwargs = SHARED[prefix]
    path = FIXTURES / f"{prefix}_{variant}.py"
    want = _run(jan, getattr(jan, cls)(**kwargs), [path], FIXTURES)
    got = _run(tan, getattr(tan, cls)(**kwargs), [path], FIXTURES)
    assert _key(got) == _key(want)
    assert bool(got) == (variant == "bad")


def test_all_shared_fixtures_under_the_default_checkers_equal_the_reference():
    paths = sorted(p for p in FIXTURES.glob("*.py")
                   if not p.name.startswith("jit_"))
    want, n = jan.analyze_paths([str(p) for p in paths],
                                jan.default_checkers(), root=str(FIXTURES))
    got, m = tan.analyze_paths([str(p) for p in paths],
                               tan.default_checkers(), root=str(FIXTURES))
    assert n == m == len(paths)
    assert _key(got) == _key(want) != []


def test_lock_edges_equal_the_reference():
    path = FIXTURES / "conc_bad.py"
    ref = jan.ConcurrencyChecker(path_prefixes=("",))
    port = tan.ConcurrencyChecker(path_prefixes=("",))
    _run(jan, ref, [path], FIXTURES)
    _run(tan, port, [path], FIXTURES)
    assert port.lock_edges == ref.lock_edges != {}


# -- the jit-safety rules on PyTorch's traced scopes -------------------------

# line-for-line rewrites of the JAX fixtures: the same bodies on the same
# lines, under each PyTorch/Triton tracer
_PARTIAL = "@functools.partial(jax.jit, static_argnames=(\"scale\",))"
_REWRITES = {
    "compile": [("import jax.numpy as jnp", "import torch.nn.functional as F"),
                ("import jax", "import torch"),
                (_PARTIAL, "@functools.partial(torch.compile, dynamic=False)"),
                ("@jax.jit", "@torch.compile"),
                ("jnp.where", "torch.where")],
    "compile_call": [("import jax.numpy as jnp", "import torch"),
                     ("import jax", "import torch"),
                     (_PARTIAL, "@torch.compile(mode=\"max-autotune\")"),
                     ("@jax.jit", "@torch.compile(fullgraph=True)"),
                     ("jnp.where", "torch.where")],
    "triton": [("import jax.numpy as jnp", "import triton.language as tl"),
               ("import jax", "import triton"),
               (_PARTIAL, "@triton.jit"),
               ("@jax.jit", "@triton.jit"),
               ("jnp.where", "tl.where")],
    "script": [("import jax.numpy as jnp", "import torch"),
               ("import jax", "import torch"),
               (_PARTIAL, "@torch.jit.script"),
               ("@jax.jit", "@torch.jit.script"),
               ("jnp.where", "torch.where")],
}


def _rewrite(name, how):
    text = (FIXTURES / name).read_text()
    for old, new in _REWRITES[how]:
        text = text.replace(old, new)
    assert "jax" not in text.replace("JAX", "")
    return text


def _lines_codes(findings):
    return sorted((f.line, f.code) for f in findings)


@pytest.mark.parametrize("how", sorted(_REWRITES))
@pytest.mark.parametrize("name", ["jit_bad.py", "jit_clean.py"])
def test_traced_scopes_give_the_reference_codes_on_its_lines(tmp_path, name,
                                                             how):
    want = _run(jan, jan.JitSafetyChecker(hot_prefixes=("",)),
                [FIXTURES / name], FIXTURES)
    (tmp_path / name).write_text(_rewrite(name, how))
    got = _run(tan, tan.JitSafetyChecker(hot_prefixes=("",)),
               [tmp_path / name], tmp_path)
    assert _lines_codes(got) == _lines_codes(want)
    if name == "jit_bad.py":
        assert {"JIT001", "JIT002", "JIT003", "JIT004"} <= \
            {f.code for f in got}
    else:
        assert got == []


def test_jit003_equals_the_reference_on_the_same_file(tmp_path):
    """A bare assert on a hot path, traced scope or not."""
    src = ("import torch\n\n\ndef eager(x):\n    assert x.ndim == 1\n"
           "    return x\n\n\n@torch.compile\ndef traced(x):\n"
           "    assert x.shape[0] > 0\n    return x\n")
    (tmp_path / "mining").mkdir()
    (tmp_path / "mining" / "m.py").write_text(src)
    (tmp_path / "other.py").write_text(src)
    paths = [tmp_path / "mining" / "m.py", tmp_path / "other.py"]
    want = [(f.fingerprint, f.line) for f in _run(
        jan, jan.JitSafetyChecker(), paths, tmp_path) if f.code == "JIT003"]
    got = [(f.fingerprint, f.line) for f in _run(
        tan, tan.JitSafetyChecker(), paths, tmp_path) if f.code == "JIT003"]
    assert got == want == [("mining/m.py::JIT003::assert x.ndim == 1", 5),
                           ("mining/m.py::JIT003::assert x.shape[0] > 0", 11)]


def _jit(tmp_path, src):
    (tmp_path / "snippet.py").write_text(src)
    return [(f.line, f.code) for f in _run(
        tan, tan.JitSafetyChecker(hot_prefixes=()), [tmp_path / "snippet.py"],
        tmp_path)]


@pytest.mark.parametrize("body,want", [
    ("    return x.cpu()\n", [(6, "JIT004")]),
    ("    return x.numpy()\n", [(6, "JIT004")]),
    ("    return x.item()\n", [(6, "JIT001")]),
    ("    return x.tolist()\n", [(6, "JIT001")]),
    ("    torch.cuda.synchronize()\n    return x\n", [(6, "JIT004")]),
    ("    return np.array(x)\n", [(6, "JIT004")]),
    ("    y = x * 2\n    return int(y)\n", [(7, "JIT001")]),
    ("    while x.sum() > 0:\n        x = x - 1\n    return x\n",
     [(6, "JIT002")]),
    ("    n = x.size(0)\n    if n > 4:\n        return x\n    return x * 2\n",
     []),
    ("    d, m = x.dim(), x.numel()\n    if d == 2 and m > 0:\n"
     "        return x\n    return x\n", []),
    ("    return torch.where(x > 0, x, 0)\n", []),
])
def test_torch_compile_body_rules(tmp_path, body, want):
    src = "import numpy as np\nimport torch\n\n@torch.compile\ndef f(x):\n"
    assert _jit(tmp_path, src + body) == want


def test_function_passed_to_torch_compile_is_traced(tmp_path):
    src = ("import torch\n\n\ndef f(x):\n    return float(x)\n\n\n"
           "g = torch.compile(f)\n")
    assert _jit(tmp_path, src) == [(5, "JIT001")]


def test_function_passed_to_torch_jit_script_is_traced(tmp_path):
    src = ("import torch\n\n\ndef f(x):\n    if x > 0:\n        return x\n"
           "    return -x\n\n\ng = torch.jit.script(f)\n")
    assert _jit(tmp_path, src) == [(5, "JIT002")]


def test_triton_constexpr_and_scalar_parameters_are_static(tmp_path):
    src = ("import triton\nimport triton.language as tl\n\n\n@triton.jit\n"
           "def k(x_ptr, n: int, BLOCK: tl.constexpr, other):\n"
           "    if BLOCK > 16:\n        pass\n    if n > 0:\n        pass\n"
           "    if other > 0:\n        pass\n")
    assert _jit(tmp_path, src) == [(11, "JIT002")]


def test_keyword_only_parameters_are_static(tmp_path):
    src = ("import torch\n\n\n@torch.compile\ndef f(x, *, block_k):\n"
           "    if block_k > 8:\n        return x\n    return x.item()\n")
    assert _jit(tmp_path, src) == [(8, "JIT001")]


def test_eager_code_and_jax_scopes_are_not_flagged(tmp_path):
    """Nothing outside a PyTorch/Triton traced scope is flagged (the JAX
    package lints no eager host sync either); ``jax.jit`` is not a scope
    of the port's."""
    src = ("import jax\nimport torch\n\n\ndef eager(x):\n"
           "    torch.cuda.synchronize()\n    return x.cpu().item()\n\n\n"
           "@jax.jit\ndef j(x):\n    return float(x)\n")
    assert _jit(tmp_path, src) == []


# -- suppressions, fingerprints, baselines (the reference's battery) ---------

_SWALLOW = ("def f(fn):\n"
            "    try:\n"
            "        fn()\n"
            "    except Exception:{comment}\n"
            "        pass\n")


def _analyze_snippet(pkg, tmp_path, source):
    p = tmp_path / "snippet.py"
    p.write_text(source)
    findings, _ = pkg.analyze_paths([str(p)],
                                    [pkg.ExceptionHygieneChecker()],
                                    root=str(tmp_path))
    return findings


def _codes(findings):
    return sorted(f.code for f in findings)


both = pytest.mark.parametrize("pkg", sorted(PACKAGES))


@both
def test_same_line_suppression(pkg, tmp_path):
    pkg = PACKAGES[pkg]
    noisy = _analyze_snippet(pkg, tmp_path, _SWALLOW.format(comment=""))
    assert _codes(noisy) == ["EXC001"]
    quiet = _analyze_snippet(
        pkg, tmp_path,
        _SWALLOW.format(comment="  # repro-lint: disable=EXC001 -- test"))
    assert quiet == []


@both
def test_own_line_suppression_applies_to_next_line(pkg, tmp_path):
    src = ("def f(fn):\n"
           "    try:\n"
           "        fn()\n"
           "    # repro-lint: disable=EXC001 -- fixture\n"
           "    except Exception:\n"
           "        pass\n")
    assert _analyze_snippet(PACKAGES[pkg], tmp_path, src) == []


@both
def test_file_level_suppression(pkg, tmp_path):
    pkg = PACKAGES[pkg]
    src = "# repro-lint: disable-file=EXC001\n" + _SWALLOW.format(comment="")
    assert _analyze_snippet(pkg, tmp_path, src) == []
    src_all = "# repro-lint: disable-file=all\n" + _SWALLOW.format(comment="")
    assert _analyze_snippet(pkg, tmp_path, src_all) == []


@both
def test_unrelated_code_suppression_does_not_mask(pkg, tmp_path):
    src = _SWALLOW.format(comment="  # repro-lint: disable=JIT003")
    assert _codes(_analyze_snippet(PACKAGES[pkg], tmp_path, src)) == \
        ["EXC001"]


@both
def test_fingerprint_survives_line_shift(pkg, tmp_path):
    pkg = PACKAGES[pkg]
    before = _analyze_snippet(pkg, tmp_path, _SWALLOW.format(comment=""))
    shifted = _analyze_snippet(
        pkg, tmp_path, "\n\n\n# padding\n\n" + _SWALLOW.format(comment=""))
    assert len(before) == len(shifted) == 1
    assert before[0].line != shifted[0].line
    assert before[0].fingerprint == shifted[0].fingerprint


@both
def test_baseline_roundtrip_and_diff(pkg, tmp_path):
    pkg = PACKAGES[pkg]
    findings = _analyze_snippet(pkg, tmp_path, _SWALLOW.format(comment=""))
    bl = tmp_path / "baseline.json"
    assert pkg.write_baseline(str(bl), findings) == 1
    fps = pkg.load_baseline(str(bl))
    assert pkg.new_findings(findings, fps) == []
    other = pkg.Finding("elsewhere.py", 1, "EXC001", "m", "exception-hygiene",
                        "except Exception:")
    assert pkg.new_findings([other], fps) == [other]


@both
def test_baseline_schema_mismatch_rejected(pkg, tmp_path):
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"schema": 99, "fingerprints": []}))
    with pytest.raises(ValueError, match="schema"):
        PACKAGES[pkg].load_baseline(str(bl))


def test_baselines_written_by_either_package_load_in_the_other(tmp_path):
    findings = _analyze_snippet(tan, tmp_path, _SWALLOW.format(comment=""))
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    tan.write_baseline(str(a), findings)
    jan.write_baseline(str(b), _analyze_snippet(
        jan, tmp_path, _SWALLOW.format(comment="")))
    assert a.read_text() == b.read_text()
    assert jan.load_baseline(str(a)) == tan.load_baseline(str(b)) == \
        {findings[0].fingerprint}


@both
def test_find_cycle(pkg):
    pkg = PACKAGES[pkg]
    assert pkg.find_cycle({"a": {"b"}, "b": {"c"}, "c": {"a"}}) == \
        ["a", "b", "c", "a"]
    assert pkg.find_cycle({"a": {"b"}, "b": {"c"}}) is None


# -- the whole port -----------------------------------------------------------

def test_both_analyzers_find_the_same_nothing_on_the_port():
    got, n = tan.analyze_paths([str(SRC)], tan.default_checkers(),
                               root=str(SRC))
    want, m = jan.analyze_paths([str(SRC)], jan.default_checkers(),
                                root=str(SRC))
    assert n == m > 90
    assert _key(got) == _key(want)
    baseline = tan.load_baseline(str(SRC / "analysis" / "baseline.json"))
    assert baseline == set()
    fresh = tan.new_findings(got, baseline)
    assert fresh == [], "\n".join(f.format() for f in fresh)


def test_the_port_keeps_its_suppressions():
    """``serve/async_loop.py`` carries two CONC002 suppressions (the caller
    holds the server lock); without them the checker would flag both."""
    findings, _ = tan.analyze_paths([str(SRC)], [tan.ConcurrencyChecker()],
                                    root=str(SRC))
    assert findings == []
    mod = tan.Module(str(SRC / "serve" / "async_loop.py"),
                     "serve/async_loop.py",
                     (SRC / "serve" / "async_loop.py").read_text())
    suppressed = [line for line, codes in mod.line_suppressions.items()
                  if "CONC002" in codes]
    assert len(suppressed) >= 2


def test_the_port_checkers_match_the_reference_on_the_jax_package():
    """Beside the port: the copied checkers (all but the jit rules, which
    look for other tracers) give the reference's findings on ``src/repro``
    itself."""
    jax_src = REPO / "src" / "repro"
    for name in ("ConcurrencyChecker", "TunerSeamChecker",
                 "MetricHygieneChecker", "ExceptionHygieneChecker"):
        want, _ = jan.analyze_paths([str(jax_src)], [getattr(jan, name)()],
                                    root=str(jax_src))
        got, _ = tan.analyze_paths([str(jax_src)], [getattr(tan, name)()],
                                   root=str(jax_src))
        assert _key(got) == _key(want), name


# -- the dead-module report ---------------------------------------------------

def _tree(root, files):
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)


def test_dead_module_report_lists_every_unreached_module(tmp_path):
    _tree(tmp_path, {
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/launch/__init__.py": "",
        "src/repro_torch/launch/run.py": "from ..core import used\n",
        "src/repro_torch/core/__init__.py": "",
        "src/repro_torch/core/used.py": "from . import helper\n",
        "src/repro_torch/core/helper.py": "",
        "src/repro_torch/core/orphan.py": "import os\n",
        "src/repro_torch/kernels/__init__.py": "",
        "src/repro_torch/kernels/probe.py": "",
        "src/repro_torch/kernels/tested.py": "",
        "src/repro_torch/old/__init__.py": "",
        "src/repro_torch/old/gone.py": "from ..core import orphan\n",
        "tests/test_x.py": "from repro_torch.kernels import tested\n",
        "examples/torch/demo.py": "import repro_torch.core.helper\n",
        "chip_smoke.py": "def main():\n"
                         "    from repro_torch.kernels import probe\n",
    })
    rep = dead_module_report(str(tmp_path))
    assert rep["dead"] == ["repro_torch.core.orphan", "repro_torch.old",
                           "repro_torch.old.gone"]
    assert rep["dead_paths"] == ["src/repro_torch/core/orphan.py",
                                 "src/repro_torch/old/__init__.py",
                                 "src/repro_torch/old/gone.py"]
    assert "repro_torch.kernels.probe" in rep["reachable"]
    assert "repro_torch.launch.run" in rep["roots"]


def test_dead_module_report_on_the_repo():
    rep = dead_module_report(str(REPO))
    reachable = set(rep["reachable"])
    for mod in ("repro_torch.serve.service", "repro_torch.mining.dense",
                "repro_torch.analysis.engine",
                "repro_torch.kernels.itemset_count.b1_probe"):
        assert mod in reachable
    for mod in rep["dead"]:
        assert not mod.startswith(("repro_torch.serve", "repro_torch.kernels",
                                   "repro_torch.mining", "repro_torch.obs",
                                   "repro_torch.analysis")), rep["dead"]
    # the JAX package's report over its own tree is unchanged by the port
    assert all(m.startswith("repro.") or m == "repro"
               for m in jax_dead_report(str(REPO))["reachable"])


# -- the CLI ------------------------------------------------------------------

def _run_analyze(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.analyze", *args],
        capture_output=True, text=True, cwd=str(REPO),
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)


def test_cli_gate_passes_on_shipped_tree():
    proc = _run_analyze()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro-lint: ok" in proc.stdout
    assert "0 new finding(s), 0 baselined" in proc.stdout


def test_cli_self_test_catches_all_five():
    proc = _run_analyze("--self-test")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for code in ("CONC001", "JIT001", "TUNE001", "MET001", "EXC001"):
        assert f"caught injected {code} [ok]" in proc.stdout
    assert "clean twin unflagged [ok]" in proc.stdout
    assert "repro-lint self-test: ok (5 injected violations)" in proc.stdout


def test_cli_fails_on_injected_violation(tmp_path):
    (tmp_path / "injected.py").write_text(_SWALLOW.format(comment=""))
    proc = _run_analyze("--root", str(tmp_path))
    assert proc.returncode == 1
    assert "EXC001" in proc.stdout and "repro-lint: FAIL" in proc.stdout


def test_cli_update_baseline_then_json(tmp_path):
    (tmp_path / "injected.py").write_text(_SWALLOW.format(comment=""))
    bl = tmp_path / "bl.json"
    proc = _run_analyze("--root", str(tmp_path), "--baseline", str(bl),
                        "--update-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(bl.read_text())["schema"] == 1
    out = tmp_path / "report.json"
    proc = _run_analyze("--root", str(tmp_path), "--baseline", str(bl),
                        "--json", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["baselined"] == 1 and doc["new"] == []


def test_cli_dead_modules_is_advisory():
    proc = _run_analyze("--dead-modules")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = dead_module_report(str(REPO))
    for path in rep["dead_paths"]:
        assert f"  {path}" in proc.stdout
    assert f"{len(rep['dead'])} unreferenced" in proc.stdout
