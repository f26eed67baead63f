"""Runs an example of either package in this process and masks what a run
cannot repeat: wall times (numbers followed by ``s``, ``ms`` or ``us``,
with the spaces that pad them),
the speedups computed from them (``(3.2x)``) and launch counts.  The one
line each package names its own kernel in is mapped to the port's, and the
chooser's measured density, which the port samples from other rows, is
masked on the ``traits:`` line."""
import contextlib
import io
import re
import runpy
import sys
from pathlib import Path

import repro.obs
import repro_torch.obs

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "incremental_mining", "corpus_pattern_mining",
         "minority_report_census", "count_server", "rule_server",
         "streaming_bigdata")

# a time with its field's padding: a one-digit and a two-digit time in one
# fixed-width field differ in their leading spaces
_TIME = re.compile(r" *\d+(?:\.\d+)?\s*(?:s|ms|us)\b")
_RATIO = re.compile(r"\(\s*\d+(?:\.\d+)?x")
_LAUNCHES = re.compile(r"\d+ (kernel )?launches")
_TELEMETRY_LAUNCHES = re.compile(r"\d+ kernel launches(, )?")
_DENSITY = re.compile(r"density \d+\.\d+")
_RENAMED = {
    "=== TPU-native dense engine (bitmaps + Pallas kernel) ===":
    "=== Hopper dense engine (bitmaps + itemset-count CUDA kernel) ===",
}


def path(name, port):
    return ROOT / "examples" / ("torch" if port else "") / f"{name}.py"


def mask(text):
    out = []
    for line in text.splitlines():
        line = _RENAMED.get(line, line)
        line = _TIME.sub("<t>", line)
        line = _RATIO.sub("(<x>", line)
        if line.startswith("telemetry: "):
            # the JAX package counts its interpret-mode launches here; the
            # port's plain version on the CPU launches nothing
            line = _TELEMETRY_LAUNCHES.sub("", line)
            line = "telemetry: " + (line[len("telemetry: "):]
                                    or "no activity")
        if line.startswith("traits: "):
            # the port's chooser samples the rows evenly, the JAX package's
            # a sorted head (a reference fault repaired in the port)
            line = _DENSITY.sub("density <d>", line)
        out.append(_LAUNCHES.sub("<n> launches", line))
    return out


def _fresh_telemetry():
    repro.obs.reset()
    repro_torch.obs.reset()


def run_main(name, port, args=()):
    """Run one example as ``__main__`` with ``args`` (the port's with
    ``--device cpu``); returns what it printed."""
    p = path(name, port)
    argv = [str(p), *args] + (["--device", "cpu"] if port else [])
    return _run(lambda: runpy.run_path(str(p), run_name="__main__"), argv)


def run_function(name, port, fn, *args, **kwargs):
    """Call a module-level function of one example; returns its output."""
    g = runpy.run_path(str(path(name, port)))
    return _run(lambda: g[fn](*args, **kwargs), [str(path(name, port))])


def _run(call, argv):
    _fresh_telemetry()
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = argv
    try:
        with contextlib.redirect_stdout(buf):
            call()
    finally:
        sys.argv = saved
    return buf.getvalue()


def assert_same_output(name, jax_out, torch_out):
    want, got = mask(jax_out), mask(torch_out)
    assert got == want, (name, [(a, b) for a, b in zip(want, got) if a != b]
                         or (len(want), len(got)))
    assert len(got) >= 3
