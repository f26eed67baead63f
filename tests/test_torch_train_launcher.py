"""``python -m repro_torch.launch.train`` as a subprocess on the CPU: a run
that trains, logs and checkpoints; the JAX package's preemption-and-resume
test (``tests/test_system.py:112-147``) on the port; a resume on another
``--data-mesh`` (two gloo ranks through ``torchrun``'s environment on a
free localhost port), whose first resumed step logs the loss that an
uninterrupted one-rank run logs at that step (rtol 2e-5, the microbatch
test's loss tolerance: the same mean in another summation order);
``--model-mesh 2`` on two gloo ranks against one rank (the same losses,
rtol 2e-5, for the same reason); and the refusals (no card without
``--device``, a mesh above 1 x 1 in one process).
"""
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "qwen3-8b", "--reduced", "--batch", "4", "--seq", "16"]


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **extra)


def _cmd(*args):
    return [sys.executable, "-m", "repro_torch.launch.train"] + list(args)


def _run(*args, timeout=240, **env):
    return subprocess.run(_cmd(*args), env=_env(**env), capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT)


def _losses(out):
    return {int(s): float(v) for s, v in
            re.findall(r"step +(\d+) loss (\S+)", out)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launcher_trains_logs_and_checkpoints(tmp_path):
    ck = str(tmp_path / "run")
    proc = _run("--device", "cpu", *BASE, "--steps", "12", "--ckpt-dir", ck,
                "--ckpt-every", "5", "--log-every", "4", "--compression",
                "int8", "--microbatches", "2")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "done"
    logged = [ln for ln in lines if ln.startswith("step")]
    assert [int(ln.split()[1]) for ln in logged] == [0, 4, 8, 11]
    assert re.fullmatch(r"step +\d+ loss \d+\.\d{4} gnorm \d+\.\d{3} lr "
                        r"\S+e-0\d [\d,]+ tok/s( +\[straggler\])?", logged[0])
    losses = _losses(proc.stdout)
    assert all(np.isfinite(v) for v in losses.values())
    assert CheckpointManager(ck).all_steps() == [5, 10, 12]


def test_launcher_preemption_and_resume(tmp_path):
    """SIGTERM mid-run checkpoints; --resume continues to completion."""
    ck = str(tmp_path / "run")
    cmd = _cmd("--device", "cpu", *BASE, "--steps", "5000", "--ckpt-dir", ck,
               "--ckpt-every", "5", "--log-every", "50")
    proc = subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    deadline = time.time() + 200
    while time.time() < deadline:
        if os.path.isdir(ck) and any(
                n.startswith("step_") and ".tmp" not in n
                and os.path.exists(os.path.join(ck, n, "MANIFEST.json"))
                for n in os.listdir(ck)):
            break  # a COMPLETE checkpoint exists; safe to preempt
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=200)
    assert proc.returncode == 0, out[-2000:]
    assert "SIGTERM received: checkpointing and exiting" in out, out[-2000:]
    assert "done" not in out

    mgr = CheckpointManager(ck)
    resumed_from = mgr.latest_step()
    assert resumed_from and resumed_from > 0

    cmd2 = list(cmd)
    cmd2[cmd2.index("--steps") + 1] = str(resumed_from + 4)
    cmd2.append("--resume")
    proc2 = subprocess.run(cmd2, env=_env(), capture_output=True, text=True,
                           timeout=200, cwd=ROOT)
    assert proc2.returncode == 0, proc2.stdout[-2000:] + proc2.stderr[-2000:]
    assert f"resumed from step {resumed_from}" in proc2.stdout
    assert proc2.stdout.splitlines()[-1] == "done"
    assert mgr.latest_step() == resumed_from + 4


def test_resume_on_another_data_mesh(tmp_path):
    """Steps 0-2 on one rank, steps 3-5 resumed on two gloo ranks, against
    steps 0-5 on one rank: the resumed steps log the same losses."""
    ck = str(tmp_path / "run")
    common = ["--device", "cpu", *BASE, "--steps", "6", "--log-every", "1",
              "--ckpt-every", "3", "--lr", "1e-3", "--ckpt-dir", ck]
    whole = _run(*common)
    assert whole.returncode == 0, whole.stderr[-2000:]
    # keep step 3 only: resume from there
    shutil.rmtree(os.path.join(ck, "step_00000006"))
    port = str(_free_port())
    ranks = [subprocess.Popen(
        _cmd(*common, "--resume", "--data-mesh", "2"),
        env=_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for r in range(2)]
    outs = [p.communicate(timeout=200)[0] for p in ranks]
    assert [p.returncode for p in ranks] == [0, 0], outs
    assert "resumed from step 3" in outs[0]
    want, got = _losses(whole.stdout), _losses(outs[0])
    assert sorted(got) == [3, 4, 5]
    np.testing.assert_allclose([got[s] for s in (3, 4, 5)],
                               [want[s] for s in (3, 4, 5)], rtol=2e-5)


def test_launcher_refusals(monkeypatch):
    """Each refusal comes before any group or model is made, so it is
    checked in this process."""
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main([*BASE, "--steps", "1"])
    with pytest.raises(SystemExit, match="--model-mesh 2 needs 2 ranks"):
        train.main(["--device", "cpu", *BASE, "--model-mesh", "2"])
    with pytest.raises(SystemExit, match="--data-mesh 2 needs 2 ranks"):
        train.main(["--device", "cpu", *BASE, "--data-mesh", "2"])


def test_model_mesh_two_trains_as_one_rank(tmp_path):
    """Four steps on one rank and on a 1 x 2 mesh of two gloo ranks
    (tensor parallelism): every logged loss agrees, and the checkpoint the
    two ranks write holds the full arrays, equal in shape to one rank's."""
    common = ["--device", "cpu", *BASE, "--steps", "4", "--log-every", "1",
              "--lr", "1e-3"]
    one = _run(*common, "--ckpt-dir", str(tmp_path / "one"))
    assert one.returncode == 0, one.stderr[-2000:]
    port = str(_free_port())
    ranks = [subprocess.Popen(
        _cmd(*common, "--model-mesh", "2", "--ckpt-dir",
             str(tmp_path / "two")),
        env=_env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for r in range(2)]
    outs = [p.communicate(timeout=200)[0] for p in ranks]
    assert [p.returncode for p in ranks] == [0, 0], outs
    want, got = _losses(one.stdout), _losses(outs[0])
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    np.testing.assert_allclose([got[s] for s in range(4)],
                               [want[s] for s in range(4)], rtol=2e-5)
    a = np.load(tmp_path / "one" / "step_00000004" / "arrays_p0.npz")
    b = np.load(tmp_path / "two" / "step_00000004" / "arrays_p0.npz")
    assert sorted(a) == sorted(b)
    assert all(a[k].shape == b[k].shape for k in a)
