"""The port's model zoo (``repro_torch.models``) against the JAX package's,
on the CPU, at every arch's reduced config (float32).

The JAX package's parameters (``get_model(arch, reduced=True).init(
jax.random.key(0))``) are carried across with
``repro_torch.convert.model_from_reference``; tokens and frames come from a
numpy seed.  Compared: forward logits, the loss, prefill's logits and cache
(K/V, SSD and conv state) and 4 decode steps, then module by module (norm,
RoPE, blocked attention, the SSD scan, the causal conv, MoE routing and
dispatch with capacity drops).

Tolerance: atol = rtol = 1e-4 on the logits and caches, for every arch.
Both sides compute in float32 with the same operation order up to the
backends' matmul and reduction order, which moves logits of magnitude
about 1 by about 1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.convert import model_from_reference
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.blocks import unit_layout

ALL_ARCHS = sorted(ARCHS)
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, PROMPT, MAX_LEN, STEPS = 2, 32, 16, 32, 4


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX model, JAX params, the port's model with those weights)."""
    jm = jax_get_model(arch, reduced=True)
    params = jm.init(jax.random.key(0))
    cfg = tconfigs.get_config(arch).reduced()
    tm = model_from_reference(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jm, params, tm


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = None
    if cfg.encdec:
        frames = rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)
    return toks, frames


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _jax_layer_caches(cfg, units):
    """The JAX package's stacked cache units as one dict per layer."""
    n_units, layout = unit_layout(cfg)
    out = []
    for u in range(n_units):
        for i in range(len(layout)):
            tree = units if len(layout) == 1 else units[f"layer{i}"]
            out.append({k: np.asarray(v[u]) for k, v in tree.items()})
    return out


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_copy_equals_reference(arch):
    assert (dataclasses.asdict(tconfigs.get_config(arch))
            == dataclasses.asdict(jax_get_config(arch)))
    assert (dataclasses.asdict(tconfigs.get_config(arch).reduced())
            == dataclasses.asdict(jax_get_config(arch).reduced()))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_and_loss_match_reference(arch):
    jm, params, tm = _pair(arch)
    toks, frames = _inputs(tm.cfg, 1)
    want = jm.forward(params, jnp.asarray(toks),
                      frames=None if frames is None else jnp.asarray(frames))
    got = tm.forward(toks, frames=frames)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if frames is not None:
        batch["frames"] = frames
    # the JAX package's train_loss is softmax_xent over forward's logits
    want_loss = jcommon.softmax_xent(want, jnp.asarray(batch["labels"]),
                                     tm.cfg.vocab_size)
    got_loss = tm.loss(batch)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jm, params, tm = _pair(arch)
    cfg = tm.cfg
    toks, frames = _inputs(cfg, 2)
    jframes = None if frames is None else jnp.asarray(frames[:, :PROMPT])
    tframes = None if frames is None else frames[:, :PROMPT]
    want, jcache = jax.jit(lambda p, t, f: jm.prefill(p, t, MAX_LEN, frames=f))(
        params, jnp.asarray(toks[:, :PROMPT]), jframes)
    got, tcache = tm.prefill(toks[:, :PROMPT], MAX_LEN, frames=tframes)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    want_layers = _jax_layer_caches(cfg, jcache["units"])
    assert len(want_layers) == len(tcache["layers"]) == cfg.n_layers
    for i, (w, g) in enumerate(zip(want_layers, tcache["layers"])):
        assert sorted(w) == sorted(g), i
        for key in w:
            np.testing.assert_allclose(_np(g[key]), w[key], err_msg=f"{i}.{key}",
                                       **TOL)
    if cfg.encdec:
        assert tcache["enc_len"] == int(jcache["enc_len"]) == PROMPT
        for key in ("enc_k", "enc_v"):
            for i in range(cfg.n_layers):
                np.testing.assert_allclose(_np(tcache[key][i]),
                                           np.asarray(jcache[key][i]), **TOL)

    decode = jax.jit(jm.decode_step)
    for step in range(STEPS):
        pos = PROMPT + step
        tok = toks[:, pos:pos + 1]
        want, jcache = decode(params, jcache, jnp.asarray(tok),
                              jnp.asarray(pos, jnp.int32))
        got, tcache = tm.decode_step(tcache, tok, pos)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   err_msg=f"step {step}", **TOL)


def test_reference_params_map_one_to_one():
    """Every JAX leaf lands in one port parameter (jamba: superblocks of 8
    layers, MoE on odd layers; seamless: the encoder stack)."""
    for arch in ("jamba-1.5-large-398b", "seamless-m4t-large-v2"):
        jm, params, tm = _pair(arch)
        n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
        assert n_jax == tm.n_params() == sum(
            p.numel() for p in tm.parameters())
    _, params, tm = _pair("jamba-1.5-large-398b")
    np.testing.assert_array_equal(
        _np(tm.decoder[3].attn.wq), np.asarray(params["decoder"]["layer3"]
                                               ["attn"]["wq"][0]))
    np.testing.assert_array_equal(
        _np(tm.decoder[5].moe.router), np.asarray(params["decoder"]["layer5"]
                                                  ["moe"]["router"][0]))


def test_bf16_reference_params_carried_bit_for_bit():
    """A bf16 JAX tree (numpy leaves of ml_dtypes' bfloat16) becomes a
    bf16 model with the same bits."""
    cfg = dataclasses.replace(tconfigs.get_config("qwen3-8b").reduced(),
                              dtype="bfloat16")
    jm = jax_get_model("qwen3-8b", reduced=True)
    params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                          jm.init(jax.random.key(1)))
    tm = model_from_reference(cfg, params, device="cpu")
    assert tm.lm_head.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tm.decoder[1].attn.wq.view(torch.int16).numpy(),
        params["decoder"]["attn"]["wq"][1].view(np.int16))


# ---------------------------------------------------------------------------
# module by module
# ---------------------------------------------------------------------------

def _cfg(arch):
    return tconfigs.get_config(arch).reduced()


def test_rmsnorm_and_rope_match_reference(rng):
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(5)
    np.testing.assert_allclose(
        _np(tcommon.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))),
        np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        **TOL)
    np.testing.assert_allclose(
        _np(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               1e6)),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        **TOL)
    logits = rng.normal(size=(2, 5, 512)).astype(np.float32)
    labels = rng.integers(0, 300, (2, 5))
    np.testing.assert_allclose(
        float(tcommon.softmax_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 300)),
        float(jcommon.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                   300)), **TOL)


@pytest.mark.parametrize("sq,causal", [(64, True), (48, True), (40, False)])
def test_grouped_attention_matches_reference(rng, sq, causal):
    """attn_block_q 16: 4 blocks at 64, 3 at 48, one (ragged) at 40; KV
    positions of -1 are padding when not causal."""
    cfg = _cfg("qwen3-8b")
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    qpos = np.arange(sq)
    kvpos = np.where(np.arange(64) < 50, np.arange(64), -1)
    kw = dict(causal=causal, cfg=cfg)
    got = tattn.grouped_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(qpos),
        kv_positions=torch.from_numpy(kvpos), **kw)
    want = jattn.grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("length,chunk", [(32, 8), (20, 8), (24, 24)])
def test_ssd_scan_and_conv_match_reference(rng, length, chunk):
    """4 chunks, a ragged length (one chunk), one chunk; then the conv."""
    b, nh, p, n = 2, 4, 8, 16
    x = rng.normal(size=(b, length, nh, p)).astype(np.float32)
    dt = rng.uniform(0.1, 2.0, size=(b, length, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, size=(nh,)).astype(np.float32)
    Bm = rng.normal(size=(b, length, nh, n)).astype(np.float32)
    Cm = rng.normal(size=(b, length, nh, n)).astype(np.float32)
    ty, ts = tssm.ssd_scan(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                           chunk)
    jy, js = jssm.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                           chunk)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)
    w = rng.normal(size=(4, nh, n)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tssm._causal_conv(torch.from_numpy(Bm), torch.from_numpy(w))),
        np.asarray(jssm._causal_conv(jnp.asarray(Bm), jnp.asarray(w))), **TOL)


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_drops_the_reference_tokens(rng, arch, impl):
    """At capacity_factor 0.5 both packages drop tokens at capacity; the
    same ones, by the same routing.  The router logits hold no tie at the
    top-k boundary, where jax.lax.top_k and torch.topk could order experts
    differently."""
    cfg = dataclasses.replace(_cfg(arch), capacity_factor=0.5, moe_impl=impl)
    d, e = cfg.d_model, cfg.n_experts
    params = {
        "router": rng.normal(size=(d, e)).astype(np.float32),
        "w_gate": (rng.normal(size=(e, d, 64)) * 0.1).astype(np.float32),
        "w_up": (rng.normal(size=(e, d, 64)) * 0.1).astype(np.float32),
        "w_down": (rng.normal(size=(e, 64, d)) * 0.1).astype(np.float32),
    }
    x = rng.normal(size=(2, 16, d)).astype(np.float32)
    logits = np.sort(x.reshape(-1, d) @ params["router"], axis=-1)[:, ::-1]
    gaps = logits[:, :cfg.top_k] - logits[:, 1:cfg.top_k + 1]
    assert gaps.min() > 1e-5, "a tie at the top-k boundary"

    tp = tcommon.ParamModule(tmoe.moe_specs(cfg), torch.float32,
                             torch.device("cpu"))
    with torch.no_grad():
        for k, v in params.items():
            getattr(tp, k).copy_(torch.from_numpy(v))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    got = tmoe.moe_forward(tp, torch.from_numpy(x), cfg)
    want = jmoe.moe_forward(jp, jnp.asarray(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    g = tmoe._group_count(32, cfg)
    assert g == jmoe._group_count(32, cfg)
    cap = tmoe._capacity(32 // g, cfg)
    _, ids = tmoe._route(tp, torch.from_numpy(x).reshape(g, 32 // g, d), cfg)
    _, jids = jmoe._route(jp, jnp.asarray(x).reshape(g, 32 // g, d), cfg)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    pos = tmoe._positions_in_expert(ids, e, cfg.top_k)
    np.testing.assert_array_equal(
        _np(pos), np.asarray(jmoe._positions_in_expert(jids, e, cfg.top_k)))
    assert int((pos >= cap).sum()) > 0, "no token dropped: the test is vacuous"
