"""The benchmark harness: one run of one cell, driven by ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  Everything that belongs to
one of them is a file found by its name:

  * ``bench/configs/<config>.json``: the deployment (its generator and sizes);
  * ``bench/traffic/<mix>.json``: the mix's parameters; its ``kind`` names
    the driver ``bench/drivers/<kind>.py`` that runs it;
  * ``bench/generators/<generator>.py``: the data the configuration names;
  * ``bench/metrics/<metric>.py``: the reader of one metric, which takes its
    number from the run's record (``Record``) or returns None.

A run sets up, measures for ``--seconds``, checks the outputs against the
plain reference (``bench/reference/``), and prints one JSON line.  With
``--trace 1`` it reports the cell's per-layer metrics instead of its
end-to-end ones, from spans, counters and a ``torch.profiler`` timeline.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def _process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return now
    return now - max(0.0, age)


PROCESS_START = _process_start()


class HarnessError(RuntimeError):
    """A run that cannot give a result (no chip, a bad name, JAX loaded)."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.partition(".")[0] in FORBIDDEN)


def load_file(path: Path, name: str):
    """Import one file of the benchmark by its path."""
    if not path.is_file():
        raise HarnessError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the spec ----------------------------------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _covers(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def resolve(root: Path, workload: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise HarnessError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _covers(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _covers(m, workload, names)]
    return Cell(workload, w["chips"], cfg, mix, e2e, layer)


# -- what a run records -------------------------------------------------------

@dataclass
class Record:
    """Everything the metric readers read.  Times are on
    ``time.perf_counter``'s clock."""
    setup_s: float = 0.0
    window_t0: float = 0.0
    window_t1: float = 0.0
    trace: bool = False
    jobs: List[Dict[str, Any]] = field(default_factory=list)
    latencies_ms: List[float] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    timeline: Any = None          # devtrace.DeviceTimeline when traced
    attempted: int = 0
    failed: int = 0
    # (name, value, limit) of each number compared with the reference
    checks: List[Tuple[str, float, float]] = field(default_factory=list)


class SpanDrain:
    """Moves the program's finished spans out of its ring buffer as the run
    goes, so that a long window cannot overflow it."""

    def __init__(self, tracer, period_s: float = 0.1):
        self._ring = tracer._ring
        self._period = period_s
        self.spans: List[Tuple[str, float, float]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bench-span-drain")

    def _take(self) -> None:
        while True:
            try:
                s = self._ring.popleft()
            except IndexError:
                return
            self.spans.append((s.name, s.t0, s.t1))

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            self._take()

    def __enter__(self) -> "SpanDrain":
        self._ring.clear()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self._take()


@dataclass
class RunContext:
    """What a driver gets: the cell, the run's arguments, and the calls that
    mark the window."""
    root: Path
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    control: bool
    record: Record = field(default_factory=Record)
    memory_peak_bytes: int = 0

    def generate(self, stream: int):
        """The configuration's data for one stream of the seed."""
        name = self.cell.cfg["generator"]
        gen = load_file(self.root / "bench" / "generators" / f"{name}.py",
                        f"bench_generator_{name}")
        return gen.generate(self.cell.cfg, [int(self.seed) % (1 << 64),
                                            stream])

    def setup_done(self) -> None:
        """Marks the end of set-up."""
        self.record.setup_s = time.perf_counter() - PROCESS_START

    def window_opens(self) -> float:
        """The window's start: after set-up, and after the traced run's
        profiler has started."""
        self.record.window_t0 = time.perf_counter()
        return self.record.window_t0

    def window_closed(self) -> None:
        """Called once the timed work is over and answered: reads the
        memory peak before any reference work."""
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()
            self.memory_peak_bytes = max(
                torch.cuda.max_memory_allocated(i)
                for i in range(self.cell.chips))


# -- one run -----------------------------------------------------------------

def _metric_value(root: Path, metric: dict, rec: Record) -> Optional[float]:
    reader = load_file(root / "bench" / "metrics" / f"{metric['name']}.py",
                       "bench_metric_" + metric["name"].replace(".", "_"))
    return reader.read(rec)


def _breakdown(rec: Record) -> Optional[dict]:
    tl = rec.timeline
    if tl is None:
        return None
    from .devtrace import idle_gaps

    def doing(a: float, b: float) -> str:
        mid = (a + b) / 2
        inner = [s for s in rec.spans if s[1] <= mid <= s[2]]
        if inner:
            return min(inner, key=lambda s: s[2] - s[1])[0]
        return "outside every span"

    gaps = sorted(idle_gaps(tl.ops, tl.t0, tl.t1), key=lambda g: g[0] - g[1])
    return {"device_ops": tl.top_ops(10),
            "idle_gaps": [[doing(a, b), b - a] for a, b in gaps[:10]]}


def card_description(chips: int) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return " | ".join(out.splitlines()[:chips])


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", control: bool = False,
             check_chip: bool = True) -> dict:
    """One run; returns the result line's object."""
    cell = resolve(root, workload)
    import torch

    if check_chip and not (torch.cuda.is_available()
                           and torch.cuda.device_count() >= cell.chips):
        raise HarnessError(f"{workload} needs {cell.chips} CUDA device(s); "
                           f"found {torch.cuda.device_count()}")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / sub)
    from repro_torch.roofline import autotune

    print(f"bench: {workload} seed {seed} seconds {seconds} trace "
          f"{int(trace)} device {device}; launch configs: "
          f"{autotune.describe_active()}", file=sys.stderr)
    ctx = RunContext(root, cell, seed, seconds, trace, device, control)
    kind = cell.mix["kind"]
    driver = load_file(root / "bench" / "drivers" / f"{kind}.py",
                       f"bench_driver_{kind}")
    driver.run(ctx)
    rec = ctx.record
    rec.trace = trace

    from repro_torch import obs
    from repro_torch.kernels import _build

    snap = obs.snapshot()
    print(f"bench: cross-check, the wrapper's kernel_measured_s_total "
          f"{obs.counter_total(snap, 'kernel_measured_s_total')!r} over "
          f"{obs.counter_total(snap, 'kernel_launches_total')!r} launches; "
          f"nvcc builds this run {dict(_build.BUILD_SECONDS)}",
          file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = _metric_value(root, m, rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else device,
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": ctx.memory_peak_bytes}
    out = {"correct": (rec.failed == 0
                       and all(v <= lim for _, v, lim in rec.checks)
                       and bool(rec.checks)),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": dev}
    if trace and rec.timeline is not None:
        dev["busy_s"] = rec.timeline.busy_s()
        dev["window_s"] = rec.timeline.window_s
        out["breakdown"] = _breakdown(rec)
    if device.startswith("cuda"):
        print(f"bench: card {card_description(cell.chips)}", file=sys.stderr)
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, v, lim in rec.checks}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="compare the control (the reference with a broken "
                         "guarantee) in the program's place; not a "
                         "benchmark run")
    a = ap.parse_args(argv)
    try:
        out = run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                       control=bool(a.control))
        # the window has closed: this process, which prints the result,
        # must not hold JAX
        found = forbidden_modules()
        if found:
            raise HarnessError("JAX or the JAX package was loaded: "
                               + ", ".join(found))
    except HarnessError as e:
        print(f"bench: no result: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
