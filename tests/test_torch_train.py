"""The port's training path (``Model.loss`` with autograd, remat,
``train_step``) against the JAX package's, on the CPU, at every arch's
reduced config (float32).

The JAX package's parameters (``jax.random.key(0)``) are carried across
with ``repro_torch.convert.model_from_reference``; batches come from a
numpy seed.  Tolerances, stated per check:

- gradients against ``jax.grad(model.loss)``: per parameter, the largest
  difference at most ``GRAD_RTOL`` = 1e-4 of that parameter's largest
  gradient entry (+ 1e-9).  Both sides run float32 with the same
  operations; matmul and reduction order differ, and moved the worst
  parameter by 2.9e-6 of its largest entry (jamba);
- remat on against remat off: bit for bit (the same ops run again on the
  same inputs on the CPU);
- the JAX package's ``test_system.py`` battery keeps its own tolerances.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import attention as jattn
from repro.models import get_model as jax_get_model
from repro.parallel import sharding as jshd
from repro_torch import configs as tconfigs
from repro_torch.convert import model_from_reference, reference_state
from repro_torch.data import TokenPipeline
from repro_torch.models import attention as tattn, get_model
from repro_torch.parallel import sharding as tshd
from repro_torch.train import (AdamWConfig, AdamWState, init_state,
                               make_train_step)
from repro_torch.train.optimizer import abstract_state

ALL_ARCHS = sorted(ARCHS)
GRAD_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _reference(arch):
    jm = jax_get_model(arch, reduced=True)
    return jm, jm.init(jax.random.key(0))


def _port(arch, **overrides):
    jm, params = _reference(arch)
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), **overrides)
    return model_from_reference(cfg, jax.tree.map(np.asarray, params),
                                device="cpu")


def _batch(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec:
        batch["frames"] = rng.normal(size=(b, s, cfg.frontend_dim)).astype(
            np.float32)
    return batch


def _grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss = model.loss(batch)
    loss.backward()
    return loss.detach(), {k: (p.grad if p.grad is not None
                               else torch.zeros_like(p))
                           for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_grads_match_reference(arch):
    jm, params = _reference(arch)
    tm = _port(arch)
    batch = _batch(tm.cfg, 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = reference_state(tm.cfg, jax.tree.map(np.asarray, jgrads))
    loss, got = _grads(tm, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        if w.size == 0:
            continue
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max() + 1e-9, (
            f"{arch} {k}: max |grad - jax.grad| {err:.3e}, largest entry "
            f"{np.abs(w).max():.3e}")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_grads_finite(arch):
    """``test_models_smoke.py::test_grads_finite`` on the port."""
    model = get_model(arch, reduced=True, device="cpu").init(
        torch.Generator().manual_seed(0))
    _, grads = _grads(model, _batch(model.cfg, 2, s=16))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    # something nonzero actually flowed
    assert any(float(g.abs().max()) > 0 for g in grads.values() if g.numel())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_remat_on_equals_remat_off(arch):
    on, off = _port(arch, remat=True), _port(arch, remat=False)
    batch = _batch(on.cfg, 3)
    loss_on, g_on = _grads(on, batch)
    loss_off, g_off = _grads(off, batch)
    assert torch.equal(loss_on, loss_off)
    for k in g_on:
        assert torch.equal(g_on[k], g_off[k]), k


def test_loss_records_a_graph_and_serving_does_not():
    model = _port("qwen3-8b")
    batch = _batch(model.cfg, 4)
    assert model.loss(batch).requires_grad
    assert not model.forward(batch["tokens"]).requires_grad
    assert all(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------------
# the JAX package's test_system.py battery on the port
# ---------------------------------------------------------------------------

def _setup(arch="qwen3-8b", seq=32, batch=4):
    model = get_model(arch, reduced=True, device="cpu").init(
        torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=40, warmup_steps=2)
    pipe = TokenPipeline(vocab_size=model.cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=0)
    return model, opt_cfg, pipe, init_state(model, opt_cfg)


def test_training_reduces_loss():
    model, opt_cfg, pipe, opt_state = _setup()
    step_fn = make_train_step(model, opt_cfg)
    losses = []
    for step in range(15):
        model, opt_state, m = step_fn(model, opt_state, pipe.host_slice(step))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses
    assert np.isfinite(losses).all()


def test_microbatch_accumulation_matches_full_batch():
    m1, opt_cfg, pipe, s1 = _setup(batch=8)
    m4, _, _, s4 = _setup(batch=8)
    batch = pipe.host_slice(0)
    _, _, r1 = make_train_step(m1, opt_cfg, n_microbatches=1)(m1, s1, batch)
    _, _, r4 = make_train_step(m4, opt_cfg, n_microbatches=4)(m4, s4, batch)
    np.testing.assert_allclose(float(r1["loss"]), float(r4["loss"]),
                               rtol=2e-5)
    # parameters close (accumulation is fp32; ordering differences only)
    for (k, a), (_, b) in zip(m1.named_parameters(), m4.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=3e-3, atol=3e-5, err_msg=k)


def test_gradient_compression_modes_run():
    base = None
    for mode in (None, "bf16", "int8"):
        model, opt_cfg, pipe, opt_state = _setup()
        fn = make_train_step(model, opt_cfg, compression=mode)
        _, _, m = fn(model, opt_state, pipe.host_slice(0))
        if base is None:
            base = float(m["loss"])
        assert abs(float(m["loss"]) - base) < 1e-3  # loss is pre-compression


def test_grad_norm_is_the_norm_of_what_the_clip_saw():
    """After a single-microbatch step ``.grad`` holds the gradients the
    clip saw; their norm is the reported ``grad_norm``."""
    model, opt_cfg, pipe, opt_state = _setup()
    fn = make_train_step(model, opt_cfg, compression="int8")
    _, _, m = fn(model, opt_state, pipe.host_slice(0))
    norm = torch.sqrt(sum(torch.sum(p.grad.double() ** 2)
                          for p in model.parameters()))
    np.testing.assert_allclose(float(m["grad_norm"]), float(norm), rtol=1e-5)


def test_train_step_rejects_bad_arguments():
    model, opt_cfg, pipe, opt_state = _setup(batch=6)
    with pytest.raises(ValueError):
        make_train_step(model, opt_cfg, compression="fp4")
    with pytest.raises(ValueError):
        make_train_step(model, opt_cfg, n_microbatches=0)
    fn = make_train_step(model, opt_cfg, n_microbatches=4)
    with pytest.raises(ValueError):
        fn(model, opt_state, pipe.host_slice(0))


# ---------------------------------------------------------------------------
# abstract params and state (test_data_and_specs.py:50-75)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "arctic-480b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2"])
def test_abstract_params_match_real_init(arch):
    model = get_model(arch, reduced=True, device="cpu")
    real = dict(model.init(torch.Generator().manual_seed(0))
                .named_parameters())
    abstract = model.abstract()
    assert list(abstract) == list(real)
    for k, a in abstract.items():
        assert a.device.type == "meta"
        assert a.shape == real[k].shape and a.dtype == real[k].dtype
    # and the JAX package's: the same leaves by the key map
    jm = jax_get_model(arch, reduced=True)
    jabs = reference_state(model.cfg, jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jm.abstract()))
    assert {k: tuple(v.shape) for k, v in jabs.items()} == \
        {k: tuple(v.shape) for k, v in abstract.items()}


def test_abstract_opt_state_matches_real():
    model = get_model("qwen3-8b", reduced=True, device="cpu").init(
        torch.Generator().manual_seed(0))
    cfg = AdamWConfig(state_dtype="float32")
    real = init_state(model, cfg)
    abstract = abstract_state(model.abstract(), cfg)
    assert isinstance(abstract, AdamWState)
    for k in real.m:
        for r, a in ((real.m[k], abstract.m[k]), (real.v[k], abstract.v[k])):
            assert r.shape == a.shape and r.dtype == a.dtype
    assert real.step.shape == abstract.step.shape == ()


# ---------------------------------------------------------------------------
# the 'heads' attention strategy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_heads_strategy_where_the_reference_takes_it(arch):
    """On a 1 x 1 mesh both packages pick the 'heads' strategy for the same
    archs (a model axis dividing n_heads, no force_kv_seq_attn)."""
    cfg = tconfigs.get_config(arch)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    with jshd.sharding_ctx(jmesh):
        want = jattn._heads_shardable(cfg)
    with tshd.sharding_ctx(((1, 1), ("data", "model"))):
        got = tattn._heads_shardable(cfg)
    assert got == want
    assert not tattn._heads_shardable(cfg)          # outside a context
    # mamba2-2.7b qualifies (0 heads divide any axis) but has no attention
    assert got == (arch in ("arctic-480b", "llama4-maverick-400b-a17b",
                            "starcoder2-7b", "mamba2-2.7b"))


@pytest.mark.parametrize("nblk", [1, 4])
def test_repeated_heads_attention_matches_reference(nblk):
    cfg = tconfigs.get_config("starcoder2-7b").reduced()
    rng = np.random.default_rng(5)
    s = cfg.attn_block_q * nblk
    q = rng.normal(size=(2, s, cfg.n_heads, cfg.d_head)).astype(np.float32)
    k = rng.normal(size=(2, s, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    v = rng.normal(size=(2, s, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    pos = np.arange(s)
    want = jattn.repeated_heads_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        causal=True, cfg=cfg)
    got = tattn.repeated_heads_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
        causal=True, cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_training_under_a_trivial_mesh_takes_the_heads_path(monkeypatch):
    """starcoder2 under a 1 x 1 context: the 'heads' strategy computes the
    same loss and gradients as the grouped one (within GRAD_RTOL)."""
    model = _port("starcoder2-7b")
    batch = _batch(model.cfg, 6)
    loss_g, g_g = _grads(model, batch)
    calls = []
    orig = tattn.repeated_heads_attention

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tattn, "repeated_heads_attention", spy)
    with tshd.sharding_ctx(((1, 1), ("data", "model"))):
        loss_h, g_h = _grads(model, batch)
    # each layer once forward and once more in backward (remat)
    assert model.cfg.remat and len(calls) == 2 * model.cfg.n_layers
    np.testing.assert_allclose(float(loss_h), float(loss_g), rtol=1e-6)
    for k in g_g:
        w = g_g[k].numpy()
        assert np.abs(g_h[k].numpy() - w).max() <= \
            GRAD_RTOL * np.abs(w).max() + 1e-9, k


def test_long_ssd_chunks_keep_gradients_finite(monkeypatch):
    """At a chunk of 256 (mamba2-2.7b's) the decay matrix's upper triangle
    overflows before the JAX package masks it: its loss is finite and its
    gradients NaN.  The port masks first: the same loss (rtol 1e-6) and
    finite gradients, equal within GRAD_RTOL to the JAX package's with its
    ``_segsum`` masked first (patched here, in this test only)."""
    from repro.models import ssm as jssm
    from repro.models.registry import Model as JaxModel

    jcfg = dataclasses.replace(jax_get_model("mamba2-2.7b", reduced=True).cfg,
                               ssm_chunk=256)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.key(0))
    cfg = dataclasses.replace(tconfigs.get_config("mamba2-2.7b").reduced(),
                              ssm_chunk=256)
    model = model_from_reference(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    batch = _batch(cfg, 8, s=256)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(jm.loss)(params, jbatch)
    assert any(bool(jnp.isnan(g).any()) for g in jax.tree.leaves(jgrads))
    loss, got = _grads(model, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert all(bool(torch.isfinite(g).all()) for g in got.values())

    def masked_segsum(dA):
        q = dA.shape[-2]
        cs = jnp.cumsum(dA, axis=-2)
        diff = jnp.moveaxis(cs[..., :, None, :] - cs[..., None, :, :], -1, -3)
        return jnp.exp(jnp.where(jnp.tril(jnp.ones((q, q), bool)), diff,
                                 -jnp.inf))

    monkeypatch.setattr(jssm, "_segsum", masked_segsum)
    _, fixed = jax.value_and_grad(jm.loss)(params, jbatch)
    want = reference_state(cfg, jax.tree.map(np.asarray, fixed))
    for k, g in got.items():
        w = want[k].numpy()
        if w.size:
            assert np.abs(g.numpy() - w).max() <= \
                GRAD_RTOL * np.abs(w).max() + 1e-9, k
