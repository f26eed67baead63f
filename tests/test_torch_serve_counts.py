"""The port's count-serving launcher (``repro_torch.launch.serve_counts``)
as a subprocess on the CPU (``--device cpu``), every run with ``--verify``:
the serve, shard-serve, rule-serve and spill + background-compaction smoke
arguments of ``tools/ci.sh`` (the spill run twice into one directory, so
the second run re-spills over the first run's store), the reference's
rules-mode launcher test, ``--mesh-data 1`` on a one-rank gloo group made
by the launcher, ``--mesh-data 2`` on two ranks described in the
environment as ``torchrun`` describes them, and the refusals: no card
behind the default device, ``--mesh-data 2`` without a group, and
``--async-flush`` over two ranks.  The rule-serve smoke's output is held
against the JAX package's launcher on the same arguments."""
import os
import re
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--rows", "2000", "--items", "24", "--rounds", "4", "--batch", "16",
         "--pool", "64"]
TIMEOUT_S = 240


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        env.pop(key, None)
    env.update(extra)
    return env


def _launch(args, module="repro_torch.launch.serve_counts", env=None):
    return subprocess.run(
        [sys.executable, "-m", module] + list(args),
        env=env or _env(), capture_output=True, text=True,
        timeout=TIMEOUT_S, cwd=ROOT)


def _ok(proc):
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert re.search(r"verified \d+ keys bit-identical to a fresh dense "
                     r"encode at v\d+", out), out
    assert "kernel launches by route: 0 " in out   # the plain version
    return out


def test_serve_smoke():
    out = _ok(_launch(SMOKE + ["--appends", "1", "--append-rows", "300",
                               "--theta", "0.08", "--verify",
                               "--device", "cpu"]))
    assert "resident: dense DB" in out and "device cpu" in out
    assert "append #1: +300 rows" in out and "frequent set ->" in out


def test_shard_serve_smoke_async():
    out = _ok(_launch(SMOKE + ["--appends", "1", "--append-rows", "300",
                               "--shards", "2", "--async-flush",
                               "--max-delay-ms", "25", "--theta", "0.08",
                               "--verify", "--device", "cpu"]))
    assert "resident: sharded[" in out
    assert re.search(r"async: \d+ flushes", out)


def test_rule_serve_smoke_matches_jax_launcher():
    args = SMOKE + ["--appends", "2", "--append-rows", "300", "--p-y", "0.2",
                    "--theta", "0.02", "--rules", "--min-conf", "0.1",
                    "--verify"]
    out = _ok(_launch(args + ["--device", "cpu"]))
    assert "rules:" in out and "== host minority_report oracle" in out
    ref = _launch(args, module="repro.launch.serve_counts",
                  env=_env(JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr[-3000:]

    def facts(text):
        keep = ("mined ", "append #", "top_rules(", "verified ", "  {")
        return [re.sub(r" \([0-9.]+s\)", "", line)
                for line in text.splitlines() if line.startswith(keep)]

    assert facts(out) == facts(ref.stdout)
    assert any("optimal rules" in line for line in facts(out))


def test_spill_bg_compact_smoke_twice_into_one_directory(tmp_path):
    spill = str(tmp_path / "spill")
    args = SMOKE + ["--appends", "2", "--append-rows", "300",
                    "--spill-dir", spill, "--spill-threshold-bytes", "4096",
                    "--bg-compact", "--min-compact-rows", "64",
                    "--theta", "0.08", "--verify", "--device", "cpu"]
    first = _ok(_launch(args))
    assert "resident: spilled DB" in first
    gens = sorted(os.listdir(spill))
    assert gens                      # the first run's store is left behind

    def files(names):
        return {os.path.join(g, f): open(os.path.join(spill, g, f),
                                         "rb").read()
                for g in names for f in os.listdir(os.path.join(spill, g))}

    kept = files(gens)
    second = _ok(_launch(args))
    assert "resident: spilled DB" in second
    # the second run's store spills into generations of its own (the JAX
    # package's re-spills into the first run's): the first run's store is
    # untouched, file for file
    after = sorted(os.listdir(spill))
    assert set(gens) < set(after)
    assert files(gens) == kept


def test_rules_mode_reference_arguments():
    """The reference's launcher test (``tests/test_rule_serving.py``),
    against the port's launcher."""
    out = _ok(_launch(
        ["--rows", "600", "--items", "16", "--rounds", "3", "--batch", "8",
         "--appends", "2", "--append-rows", "100", "--pool", "32",
         "--p-y", "0.35", "--theta", "0.03", "--rules", "--min-conf", "0.3",
         "--verify", "--device", "cpu"]))
    assert "rules:" in out
    assert "== host minority_report" in out


def test_mesh_data_one_on_a_gloo_group_of_its_own(tmp_path):
    dump = tmp_path / "metrics.json"
    trace = tmp_path / "trace.json"
    out = _ok(_launch(SMOKE + ["--appends", "1", "--append-rows", "300",
                               "--shards", "2", "--mesh-data", "1",
                               "--theta", "0.08", "--rules", "--p-y", "0.2",
                               "--min-conf", "0.1", "--metrics-dump",
                               str(dump), "--trace", str(trace),
                               "--verify", "--device", "cpu"]))
    assert "== host minority_report oracle" in out
    assert dump.exists() and trace.exists()
    assert "chrome trace (" in out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(args):
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_counts"] + args,
        env=_env(RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="localhost",
                 MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for r in range(2)]
    outs = []
    try:
        for q in procs:
            outs.append(q.communicate(timeout=TIMEOUT_S))
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.communicate()
    return [(q.returncode,) + o for q, o in zip(procs, outs)]


def test_mesh_data_two_on_ranks_from_the_environment():
    """Two ranks as ``torchrun`` starts them: the same seeded traffic on
    both (SPMD), each verifying its own results; rank 0 prints."""
    runs = _two_ranks(SMOKE + ["--appends", "1", "--append-rows", "300",
                               "--shards", "2", "--mesh-data", "2",
                               "--theta", "0.08", "--rules", "--p-y", "0.2",
                               "--min-conf", "0.1", "--verify",
                               "--device", "cpu"])
    (rc0, out0, err0), (rc1, out1, err1) = runs
    assert rc0 == 0 and rc1 == 0, err0[-2000:] + err1[-2000:]
    assert "== host minority_report oracle" in out0
    assert out1 == ""


def test_async_flush_refused_over_two_ranks():
    runs = _two_ranks(["--rows", "200", "--shards", "2", "--mesh-data", "2",
                       "--async-flush", "--device", "cpu"])
    for rc, out, err in runs:
        assert rc != 0 and "--async-flush over more than one rank" in err


def test_mesh_data_two_without_a_group_names_torchrun():
    proc = _launch(["--rows", "200", "--shards", "2", "--mesh-data", "2",
                    "--device", "cpu"])
    assert proc.returncode != 0 and "torchrun" in proc.stderr


def test_mesh_data_requires_shards():
    proc = _launch(["--rows", "200", "--mesh-data", "1", "--device", "cpu"])
    assert proc.returncode != 0 and "--mesh-data requires --shards" \
        in proc.stderr


@pytest.mark.skipif(
    __import__("torch").cuda.is_available(),
    reason="asserts the refusal on a host without a card")
def test_default_device_exits_without_a_card():
    proc = _launch(["--rows", "200"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "served" not in proc.stdout
