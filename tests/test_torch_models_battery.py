"""The JAX package's model battery (``tests/test_models_smoke.py``) re-run
against the port on the CPU, at every arch's reduced config: shapes and
finiteness, the loss near log(vocab) at init, prefill + decode equal to
forward, greedy multistep decode, parameter counts, and the two MoE
dispatches.  The port's own weights here (``Model.init`` from a
``torch.Generator``); the same tolerances as the JAX battery."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config
from repro_torch.models import Model, get_model
from repro_torch.models.common import param_count
from repro_torch.models.transformer import model_specs

ALL_ARCHS = sorted(ARCHS)


def _model(arch, seed=0):
    m = get_model(arch, reduced=True, device="cpu")
    return m.init(torch.Generator().manual_seed(seed))


def _batch_for(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    batch = {"tokens": toks, "labels": toks}
    if cfg.encdec:
        batch["frames"] = rng.normal(size=(b, s, cfg.frontend_dim)).astype(
            np.float32)
    return batch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_and_loss(arch):
    model = _model(arch)
    b, s = 2, 32
    batch = _batch_for(model.cfg, b, s, 1)
    logits = model.forward(batch["tokens"], frames=batch.get("frames"))
    vpad = ((model.cfg.vocab_size + 255) // 256) * 256
    assert logits.shape == (b, s, vpad)
    assert bool(torch.isfinite(logits).all())
    loss = model.loss(batch)
    assert bool(torch.isfinite(loss))
    # near-uniform init => loss close to log(vocab)
    assert abs(float(loss) - np.log(model.cfg.vocab_size)) < 1.5


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """logits(decode @ pos s-1 after prefill of s-1) == logits(forward)[:, -1]."""
    model = _model(arch)
    b, s = 2, 17
    batch = _batch_for(model.cfg, b, s, 3)
    toks, frames = batch["tokens"], batch.get("frames")
    full = model.forward(toks, frames=frames)
    last, cache = model.prefill(toks[:, :s - 1], 32, frames=frames)
    torch.testing.assert_close(last[:, 0], full[:, s - 2], rtol=2e-4,
                               atol=2e-4)
    dec, cache = model.decode_step(cache, toks[:, s - 1:s], s - 1)
    torch.testing.assert_close(dec[:, 0], full[:, s - 1], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_multistep_decode(arch):
    """4 decode steps equal the teacher-forced forward, step by step."""
    model = _model(arch)
    b, s, extra = 1, 9, 4
    toks = np.random.default_rng(4).integers(0, model.cfg.vocab_size,
                                             (b, s + extra))
    full = model.forward(toks)
    _, cache = model.prefill(toks[:, :s], 32)
    for i in range(extra):
        pos = s + i
        logits, cache = model.decode_step(cache, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(logits[:, 0], full[:, pos], rtol=3e-4,
                                   atol=3e-4)


def test_param_counts_match_analytic_and_reference():
    """The spec count equals the JAX package's and is within 2 % of the
    analytic count, at full size (specs only: nothing is allocated)."""
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        n = param_count(model_specs(cfg))
        assert n == jax_get_model(arch).n_params(), arch
        assert abs(n - cfg.n_params()) / cfg.n_params() < 0.02, arch


def test_reduced_model_counts_its_parameters():
    for arch in ALL_ARCHS:
        model = get_model(arch, reduced=True, device="cpu")
        assert model.n_params() == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_moe_gather_matches_einsum(arch):
    """The two MoE dispatch implementations agree (same capacity drops)."""
    cfg = get_config(arch).reduced()
    m1 = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    m2 = Model(dataclasses.replace(cfg, moe_impl="gather"), device="cpu")
    m2.load_state_dict(m1.state_dict())
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16))
    torch.testing.assert_close(m1.forward(toks), m2.forward(toks),
                               rtol=1e-4, atol=1e-4)


def test_init_distributions_and_seed():
    """normal(0.02) matrices, ones for norms and D, zeros for dt_bias and
    A_log; one seed gives one set of weights."""
    m = _model("mamba2-2.7b")
    std = float(m.decoder[0].ssm.wx.std())
    assert 0.018 < std < 0.022
    assert bool((m.final_norm == 1).all()) and bool((m.decoder[0].ssm.D == 1).all())
    assert not m.decoder[0].ssm.dt_bias.any()
    assert not m.decoder[0].ssm.A_log.any()
    assert m.decoder[0].mlp.w_gate.shape == (64, 128)
    m2 = _model("mamba2-2.7b")
    for (k, a), (_, b) in zip(m.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), k
    m3 = _model("mamba2-2.7b", seed=1)
    assert not torch.equal(m.lm_head, m3.lm_head)


def test_zero_width_mlp_kept_at_full_size():
    """mamba2-2.7b's d_ff = 0: its layers keep zero-width MLP weights."""
    specs = model_specs(get_config("mamba2-2.7b"))
    assert specs["decoder"][0]["mlp"]["w_gate"].shape == (2560, 0)
    assert len(specs["decoder"]) == 64


def test_device_defaults_to_the_card():
    """device=None means cuda: without a card it raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("qwen3-8b", reduced=True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_card_matches_host(arch):
    """The port on the card against the port on the CPU, float32, weights
    from one generator copied across (PyTorch's default keeps TF32 off
    for float32 matmuls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu = _model(arch)
    gpu = get_model(arch, reduced=True, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = _batch_for(cpu.cfg, 2, 24, 6)
    toks, frames = batch["tokens"], batch.get("frames")
    torch.testing.assert_close(gpu.forward(toks, frames=frames).cpu(),
                               cpu.forward(toks, frames=frames),
                               rtol=1e-4, atol=1e-4)
    lc, cc = cpu.prefill(toks[:, :16], 24, frames=frames)
    lg, cg = gpu.prefill(toks[:, :16], 24, frames=frames)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for step in range(4):
        pos = 16 + step
        lc, cc = cpu.decode_step(cc, toks[:, pos:pos + 1], pos)
        lg, cg = gpu.decode_step(cg, toks[:, pos:pos + 1], pos)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)


def test_bf16_deep_ssm_decode_within_the_card_limit():
    """``chip_smoke.py`` phase 16 holds bf16 prefill + decode against bf16
    ``forward`` at a relative L2 of 2^-6 sqrt(layers) a logits row.  A
    64-layer mamba2 of width 512 on the CPU (about 0.067) sits inside
    mamba2-2.7b's limit of 0.125, where a flat 5e-2 would refuse it."""
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), dtype="bfloat16",
                              vocab_size=4096, n_layers=64, d_model=512,
                              ssm_chunk=32)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s, gen = 2, 64, 9
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s + gen))
    full = m.forward(toks)
    logits, cache = m.prefill(toks[:, :s], s + gen)
    got = [logits[:, -1]]
    for i in range(gen - 1):
        logits, cache = m.decode_step(cache, toks[:, s + i:s + i + 1], s + i)
        got.append(logits[:, -1])
    got = torch.stack(got, 1).float()[..., :cfg.vocab_size]
    want = full[:, s - 1:s + gen - 1].float()[..., :cfg.vocab_size]
    rel = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    assert rel < 2.0 ** -6 * cfg.n_layers ** 0.5
