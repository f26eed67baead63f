"""The port's checkpointing (``repro_torch.checkpoint``) on the CPU: the JAX
package's battery (``tests/test_system.py:72-110``) on the port, the
layout and manifest the JAX package writes, the bf16 round trip bit for
bit, and a checkpoint that the JAX package's ``CheckpointManager`` wrote,
read into the port by ``convert.checkpoint_from_reference``: the port's
next step then has the JAX run's next loss (rtol 1e-5: the same float32
step, other matmul order) and its parameters and moments start equal.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.models import get_model as jax_get_model
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (CheckpointManager, PreemptionGuard,
                                    StragglerMonitor)
from repro_torch.convert import checkpoint_from_reference, reference_state
from repro_torch.data import TokenPipeline
from repro_torch.models import get_model
from repro_torch.train import AdamWConfig, init_state, make_train_step


def _setup(dtype=None, state_dtype="float32"):
    model = get_model("qwen3-8b", reduced=True, device="cpu", dtype=dtype)
    model.init(torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=40, warmup_steps=2,
                          state_dtype=state_dtype)
    pipe = TokenPipeline(vocab_size=model.cfg.vocab_size, seq_len=32,
                         global_batch=4, seed=0)
    return model, opt_cfg, pipe, init_state(model, opt_cfg)


def _snapshot(model, state):
    return ({k: p.detach().clone() for k, p in model.named_parameters()},
            {k: t.clone() for k, t in state.m.items()},
            {k: t.clone() for k, t in state.v.items()}, state.step.clone())


# ---------------------------------------------------------------- battery
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_restart_bitexact(tmp_path, dtype):
    """Save at step 3, restore into a fresh model and state, run steps 3-5:
    bit for bit the parameters and moments of the uninterrupted run (bf16:
    parameters and moments in bf16, stored as raw bits)."""
    model, opt_cfg, pipe, opt_state = _setup(dtype, dtype)
    step_fn = make_train_step(model, opt_cfg)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    for step in range(6):
        model, opt_state, _ = step_fn(model, opt_state, pipe.host_slice(step))
        if step == 2:
            mgr.save(3, (model, opt_state))
    fresh, _, _, fresh_state = _setup(dtype, dtype)
    (m2, o2), manifest = mgr.restore((fresh, fresh_state))
    assert manifest["step"] == 3 and m2 is fresh
    assert int(o2.step) == 3
    step2 = make_train_step(m2, opt_cfg)
    for step in range(3, 6):
        m2, o2, _ = step2(m2, o2, pipe.host_slice(step))
    for (k, a), (_, b) in zip(model.named_parameters(), m2.named_parameters()):
        assert a.dtype == b.dtype == getattr(torch, dtype)
        assert torch.equal(a, b), k
    for k in opt_state.m:
        assert torch.equal(opt_state.m[k], o2.m[k])
        assert torch.equal(opt_state.v[k], o2.v[k])
    assert int(opt_state.step) == int(o2.step) == 6


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep_last=2,
                            async_save=False)
    tree = {"w": torch.arange(4.0)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(threshold=2.0)
    for _ in range(10):
        mon.record(0.1)
    assert mon.record(0.5) is True
    assert mon.record(0.11) is False
    assert mon.flagged == 1


def test_preemption_guard_turns_sigterm_into_a_request():
    import signal
    guard = PreemptionGuard().install()
    try:
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    finally:
        guard.uninstall()


# ---------------------------------------------------------------- layout
def test_layout_and_manifest(tmp_path):
    model, opt_cfg, _, opt_state = _setup("bfloat16", "float32")
    mgr = CheckpointManager(str(tmp_path / "ck"))          # async
    mgr.save(7, (model, opt_state), extra={"note": "x"})
    mgr.wait()
    d = tmp_path / "ck" / "step_00000007"
    assert sorted(os.listdir(d)) == ["MANIFEST.json", "arrays_p0.npz"]
    man = json.loads((d / "MANIFEST.json").read_text())
    assert set(man) == {"step", "time", "process_index", "process_count",
                        "keys", "shapes", "dtypes", "extra"}
    assert (man["step"], man["process_index"], man["process_count"],
            man["extra"]) == (7, 0, 1, {"note": "x"})
    names = [k for k, _ in model.named_parameters()]
    assert man["keys"] == (names + ["opt.step"]
                           + [f"opt.m.{k}" for k in names]
                           + [f"opt.v.{k}" for k in names])
    assert man["dtypes"]["lm_head"] == "bfloat16"
    assert man["dtypes"]["opt.m.lm_head"] == "float32"
    assert man["dtypes"]["opt.step"] == "int32"
    arrays = np.load(d / "arrays_p0.npz")
    raw = arrays["lm_head"]
    assert raw.dtype == np.int16
    want = model.lm_head.detach().view(torch.int16).numpy()
    np.testing.assert_array_equal(raw, want)
    assert not [n for n in os.listdir(tmp_path / "ck") if ".tmp" in n]


def test_restore_refuses_a_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.zeros(4)})
    with pytest.raises(KeyError):
        mgr.restore({"u": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})
    with pytest.raises(TypeError, match="names no mesh"):
        mgr.restore({"w": torch.zeros(3)}, shardings={"w": None})
    # shardings re-shard: rank 1 of a (1, 2) mesh keeps the second half of
    # the split dim, and of AdamW's moment of the same parameter
    from torch.distributed.tensor import Replicate, Shard

    from _torch_tp_worker import MeshView
    from repro_torch.parallel.sharding import Shardings
    full = torch.arange(12.0).reshape(3, 4)
    mgr.save(2, {"w": full, "opt.m.w": full * 2, "b": torch.ones(3)})
    mesh = MeshView(1, (1, 2))
    got = {"w": torch.zeros(3, 2), "opt.m.w": torch.zeros(3, 2),
           "b": torch.zeros(3)}
    mgr.restore(got, step=2, shardings=Shardings(
        mesh, {"w": (Replicate(), Shard(1)), "b": (Replicate(),
                                                     Replicate())}))
    assert torch.equal(got["w"], full[:, 2:])
    assert torch.equal(got["opt.m.w"], full[:, 2:] * 2)
    assert torch.equal(got["b"], torch.ones(3))


def test_bf16_round_trip_is_bit_exact(tmp_path):
    rng = np.random.default_rng(0)
    bits = rng.integers(-2**15, 2**15, size=(64, 9)).astype(np.int16)
    # every bit pattern a bf16 may hold, NaN payloads and -0 included
    bits[0, :4] = [0x7FC1, -0x8000, 0x7F80, -0x0080]
    src = torch.from_numpy(bits).view(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, {"t": src})
    dst = {"t": torch.zeros(64, 9, dtype=torch.bfloat16)}
    mgr.restore(dst)
    assert torch.equal(dst["t"].view(torch.int16), src.view(torch.int16))


# ---------------------------------------------------------------- from JAX
def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package trains 3 steps and checkpoints ``(params,
    opt_state)`` as its launcher does; the port reads it and takes step 3:
    the same loss as the JAX run's step 3."""
    jm = jax_get_model("qwen3-8b", reduced=True)
    jcfg = JaxAdamWConfig(lr=1e-3, total_steps=40, warmup_steps=2)
    pipe = JaxTokenPipeline(vocab_size=jm.cfg.vocab_size, seq_len=32,
                            global_batch=4, seed=0)
    params = jm.init(jax.random.key(0))
    opt_state = jax_init_state(params, jcfg)
    step_fn = jax.jit(jax_make_train_step(jm, jcfg))
    losses = []
    for step in range(4):
        if step == 3:
            JaxCheckpointManager(str(tmp_path / "jax"), async_save=False
                                 ).save(3, (params, opt_state))
            saved = jax.tree.map(np.asarray, (params, opt_state))
        batch = {k: jnp.asarray(v) for k, v in pipe.host_slice(step).items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))

    model = get_model("qwen3-8b", reduced=True, device="cpu")
    opt, manifest = checkpoint_from_reference(str(tmp_path / "jax"), model)
    assert manifest["step"] == 3 and int(opt.step) == 3
    want_p = reference_state(model.cfg, saved[0])
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want_p[k]), k
    for k, t in reference_state(model.cfg, saved[1].m).items():
        assert torch.equal(opt.m[k], t), k
    tcfg = AdamWConfig(lr=1e-3, total_steps=40, warmup_steps=2)
    _, _, m = make_train_step(model, tcfg)(
        model, opt, TokenPipeline(vocab_size=model.cfg.vocab_size, seq_len=32,
                                  global_batch=4, seed=0).host_slice(3))
    np.testing.assert_allclose(float(m["loss"]), losses[3], rtol=1e-5)


def test_port_checkpoint_keys_cover_the_model(tmp_path):
    """Restoring into a model of another dtype casts (the JAX package's
    ``astype``); the keys are the state_dict names."""
    model, _, _, state = _setup("float32")
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(2, {"params": model, "note": torch.tensor([1, 2])})
    other = get_model("qwen3-8b", reduced=True, device="cpu",
                      dtype="bfloat16")
    like = {"params": other, "note": torch.zeros(2, dtype=torch.int64)}
    mgr.restore(like)
    for (k, a), (_, b) in zip(model.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a.detach().to(torch.bfloat16), b.detach()), k
    assert like["note"].tolist() == [1, 2]
