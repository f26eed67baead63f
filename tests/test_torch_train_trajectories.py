"""Whole training trajectories: the port's ``make_train_step`` against
``jax.jit(make_train_step(...))`` of the JAX package, 5 steps from the same
weights (``jax.random.key(0)``, carried across by
``convert.model_from_reference``) on the same ``TokenPipeline`` batches, on
the CPU in float32, for qwen3-8b, mamba2-2.7b, jamba and seamless at their
reduced configs, with 1 and 4 microbatches and compression none, bf16 and
int8: every pair for qwen3-8b, mamba2-2.7b and seamless, and for jamba,
whose JAX step takes about 16 s to compile, 1 microbatch uncompressed and
4 microbatches with int8 (the layers it adds, the SSD and MoE ones, are
mamba2's and arctic's, and its gradients are held against ``jax.grad`` in
``test_torch_train.py``).

Tolerance: every step's loss within ``LOSS_ATOL`` (losses near 5.5) and
``grad_norm`` within rtol 1e-3.  The gradients agree to about 1e-6 of
their largest entries (``test_torch_train.py``), but AdamW's first step is
about lr * sign(g), so a gradient element near zero whose sign the two
backends' summation order flips moves by up to 2 lr; the loss, summed
over every parameter, is what such trajectories are compared by:
``LOSS_ATOL`` = 1e-4.  int8 compression adds one more amplifier: a
gradient a last bit away from a rounding midpoint lands on the other
int8 code, 1/127 of its tensor's largest gradient away, so with int8 the
loss is held within 1e-3 (mamba2 drifted 1.4e-4 by step 5; the five
steps lower the loss by about 0.13).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import TokenPipeline as JaxTokenPipeline
from repro.models import get_model as jax_get_model
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.convert import model_from_reference
from repro_torch.data import TokenPipeline
from repro_torch.train import AdamWConfig, init_state, make_train_step

ARCHS = ["qwen3-8b", "mamba2-2.7b", "jamba-1.5-large-398b",
         "seamless-m4t-large-v2"]
STEPS, BATCH, SEQ = 5, 4, 32
LOSS_ATOL = {None: 1e-4, "bf16": 1e-4, "int8": 1e-3}
OPT = dict(lr=1e-3, total_steps=40, warmup_steps=2)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jm = jax_get_model(arch, reduced=True)
    return jm, jm.init(jax.random.key(0))


def _batches(cfg):
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         global_batch=BATCH, seed=0)
    jpipe = JaxTokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                             global_batch=BATCH, seed=0)
    rng = np.random.default_rng(7)
    out = []
    for step in range(STEPS):
        b = pipe.host_slice(step)
        jb = jpipe.host_slice(step)
        assert all(np.array_equal(b[k], jb[k]) for k in b)
        if cfg.encdec:
            b["frames"] = rng.normal(size=(BATCH, SEQ, cfg.frontend_dim)
                                     ).astype(np.float32)
        out.append(b)
    return out


CASES = [(arch, n_micro, compression)
         for arch in ARCHS if arch != "jamba-1.5-large-398b"
         for n_micro in (1, 4) for compression in (None, "bf16", "int8")]
CASES += [("jamba-1.5-large-398b", 1, None), ("jamba-1.5-large-398b", 4,
                                               "int8")]


@pytest.mark.parametrize("arch,n_micro,compression", CASES)
def test_trajectory_matches_reference(arch, n_micro, compression):
    jm, params = _reference(arch)
    cfg = tconfigs.get_config(arch).reduced()
    model = model_from_reference(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    jcfg, tcfg = JaxAdamWConfig(**OPT), AdamWConfig(**OPT)
    jstep = jax.jit(jax_make_train_step(jm, jcfg, n_microbatches=n_micro,
                                        compression=compression))
    tstep = make_train_step(model, tcfg, n_microbatches=n_micro,
                            compression=compression)
    jstate, tstate = jax_init_state(params, jcfg), init_state(model, tcfg)
    for step, batch in enumerate(_batches(cfg)):
        params, jstate, jm_ = jstep(params, jstate,
                                    {k: jnp.asarray(v) for k, v in
                                     batch.items()})
        model, tstate, tm_ = tstep(model, tstate, batch)
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) <= \
            LOSS_ATOL[compression], (
            step, float(tm_["loss"]), float(jm_["loss"]))
        np.testing.assert_allclose(float(tm_["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(tm_["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == STEPS
