"""The port's serving launcher, ``python -m repro_torch.launch.serve``, on
the CPU: the JAX launcher's flags and three output lines; greedy tokens
equal to the JAX package's ``prefill`` / ``decode_step`` on its own
weights (its launcher, ``repro.launch.serve``, does not run under this
JAX); no card without one; and a mesh of two gloo ranks (``--model-mesh
2``, tensor and expert parallelism; ``--data-mesh 2``, a row each) on a
free localhost port, whose greedy tokens equal the 1 x 1 run's."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.convert import model_from_reference
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]


def test_launcher_runs_on_the_host():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-8b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "8", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-1500:] + proc.stderr[-1500:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill: 2x8 in ")
    assert lines[1].startswith("decoded 3 steps in ")
    assert lines[2].startswith("sample: [")
    assert len(eval(lines[2][len("sample: "):])) == 4


def _jax_greedy(arch, prompts, frames, gen):
    jm = jax_get_model(arch, reduced=True)
    params = jm.init(jax.random.key(0))
    vocab = jm.cfg.vocab_size
    s = prompts.shape[1]
    logits, cache = jax.jit(
        lambda p, t, f: jm.prefill(p, t, s + gen, frames=f))(
        params, jnp.asarray(prompts, jnp.int32),
        None if frames is None else jnp.asarray(frames))
    steps = [np.asarray(logits[:, -1, :vocab])]
    decode = jax.jit(jm.decode_step)
    for i in range(gen - 1):
        tok = jnp.asarray(steps[-1].argmax(-1)[:, None], jnp.int32)
        logits, cache = decode(params, cache, tok,
                               jnp.asarray(s + i, jnp.int32))
        steps.append(np.asarray(logits[:, -1, :vocab]))
    return params, np.stack(steps, axis=1)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_greedy_tokens_equal_reference(arch):
    """Prompts (and frames) as the launcher draws them; the JAX weights
    carried across; every step's argmax equal.  A top-2 gap above the
    logits' 1e-4 tolerance at every step keeps argmax well defined."""
    cfg = get_config(arch).reduced()
    b, s, gen = 2, 8, 6
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (b, s))
    frames = (rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)
              if cfg.encdec else None)
    params, want = _jax_greedy(arch, prompts, frames, gen)
    top2 = np.sort(want, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4

    model = model_from_reference(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    out = serve.generate(model, torch.as_tensor(prompts), gen,
                         frames=None if frames is None
                         else torch.as_tensor(frames))
    np.testing.assert_array_equal(out.tokens.numpy(), want.argmax(-1))
    np.testing.assert_allclose(out.logits[..., :cfg.vocab_size].numpy(), want,
                               rtol=1e-4, atol=1e-4)


def test_same_seed_same_tokens(capsys):
    argv = ["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "5", "--seed", "3"]
    a, b = serve.main(argv), serve.main(argv)
    assert torch.equal(a.out.tokens, b.out.tokens)
    assert a.out.tokens.shape == (2, 5)
    assert a.model.dtype == torch.float32
    c = serve.main(argv + ["--dtype", "bfloat16"])
    assert c.model.dtype == c.out.logits.dtype == torch.bfloat16
    assert "decoded 4 steps" in capsys.readouterr().out


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-8b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cuda"])


@pytest.mark.parametrize("flag", ["--model-mesh", "--data-mesh"])
def test_mesh_above_one_waits_for_parallel(flag):
    """Two gloo ranks in torchrun's environment: rank 0 prints the first
    row's greedy tokens, equal to the 1 x 1 run's (arctic-480b: experts,
    heads and the dense residual split over 'model')."""
    argv = ["--arch", "arctic-480b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "6"]
    want = serve.main(argv).out.tokens[0].tolist()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    ranks = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv, flag, "2"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK=str(r),
                 WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(2)]
    outs = [p.communicate(timeout=200)[0] for p in ranks]
    assert [p.returncode for p in ranks] == [0, 0], outs
    sample = [ln for ln in outs[0].splitlines() if ln.startswith("sample: ")]
    assert eval(sample[0][len("sample: "):]) == want
    assert "sample:" not in outs[1]
