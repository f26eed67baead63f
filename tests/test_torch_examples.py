"""The port's examples (``examples/torch/*.py``) against the JAX package's
(``examples/*.py``): each runs on the CPU (``--device cpu``) in this
process and prints what the JAX example prints, times, the speedups
computed from them and launch counts masked (``tests/_torch_examples.py``).
``minority_report_census`` runs through its ``run(p_y, rows=...)`` at 2,000
rows, where its default ``min_support`` of 5e-4 is one row and the full
FP-growth baseline enumerates every subset (1.7 million rules at
``p_y=0.25``): 0.002 keeps four rows, as the default does at 8,000.
``corpus_pattern_mining`` and ``streaming_bigdata`` are in
``test_torch_examples_streaming.py``, so that each file stays well under a
minute on one worker.

Also here: without ``--device`` and without a card every example raises
the no-CUDA error before any work, and ``tools/ci_torch.sh``'s syntax, its
refusal to start without ``DEVICE`` and the modules it runs.
"""
import importlib
import re
import subprocess

import pytest
import torch

from _torch_examples import (NAMES, ROOT, assert_same_output, run_function,
                             run_main)


@pytest.mark.parametrize("name", ["quickstart", "incremental_mining",
                                  "count_server", "rule_server"])
def test_example_prints_what_the_jax_example_prints(name):
    assert_same_output(name, run_main(name, port=False),
                       run_main(name, port=True))


def test_census_run_prints_what_the_jax_run_prints():
    kwargs = dict(rows=2000, min_support=0.002)
    jax_out = run_function("minority_report_census", False, "run", 0.05,
                           **kwargs)
    torch_out = run_function("minority_report_census", True, "run", 0.05,
                             device="cpu", **kwargs)
    assert_same_output("minority_report_census", jax_out, torch_out)
    assert "rules: 78 (identical across engines)" in torch_out


def test_count_server_takes_its_positional_rows():
    out = run_main("count_server", port=True, args=("3000", "500"))
    assert "of 3000, 32 items, version 0" in out.splitlines()[0]
    assert "(+500 rows)" in out


@pytest.mark.parametrize("name", NAMES)
def test_example_without_device_raises_where_no_card_exists(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import runpy
    import sys

    from _torch_examples import path

    saved = sys.argv
    sys.argv = [str(path(name, True))]
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runpy.run_path(str(path(name, True)), run_name="__main__")
    finally:
        sys.argv = saved


# -- tools/ci_torch.sh ------------------------------------------------------

CI = ROOT / "tools" / "ci_torch.sh"


def test_ci_script_parses():
    out = subprocess.run(["bash", "-n", str(CI)], capture_output=True,
                         text=True, timeout=30)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("device", [None, "", "tpu", "CPU"])
def test_ci_script_refuses_to_start_without_a_device(device):
    env = {"PATH": "/usr/bin:/bin"}
    if device is not None:
        env["DEVICE"] = device
    out = subprocess.run(["bash", str(CI)], capture_output=True, text=True,
                         env=env, timeout=30)
    assert out.returncode == 2
    assert "set DEVICE=cpu or DEVICE=cuda" in out.stderr
    assert "===" not in out.stdout


def _ci_lines():
    return [ln.split("#", 1)[0] for ln in CI.read_text().splitlines()]


def test_ci_script_modules_import():
    text = "\n".join(_ci_lines())
    modules = sorted(set(re.findall(r"python3? -m ([\w.]+)", text)))
    assert modules == ["pytest", "repro_torch.launch.analyze",
                       "repro_torch.launch.serve_counts"]
    for mod in modules:
        importlib.import_module(mod)


def test_ci_script_runs_every_example_and_no_perfgate():
    text = "\n".join(_ci_lines())
    loop = re.search(r"for example in (.*?); do", text, re.S).group(1)
    assert sorted(loop.replace("\\", " ").split()) == sorted(NAMES)
    for name in NAMES:
        assert (ROOT / "examples" / "torch" / f"{name}.py").is_file()
    assert "perfgate" not in text
    # every device-bound step takes the one DEVICE, never a fixed cpu
    assert text.count('--device "$DEVICE"') == 5
    assert "--device cpu" not in text
    assert "set -euo pipefail" in text
    assert 'if [ "$DEVICE" = cuda ]; then' in text and \
        "python3 chip_smoke.py" in text
