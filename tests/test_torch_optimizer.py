"""The port's AdamW (``repro_torch.train.optimizer``) against the JAX
package's, on the CPU.

The JAX package's own battery (``tests/test_optimizer_and_parallel.py``)
re-run on the port, then the functions side by side on the same float32
and bf16 leaves from a numpy seed.  Tolerances, stated per check:

- ``schedule`` and the clip's norm: rtol 1e-6 (float32 rounding: XLA's
  ``cos`` and reduction order against PyTorch's);
- ``apply_updates`` from identical gradients: parameters and moments at
  rtol 2e-6, atol 1e-9 (the same float32 ops in the same order; ``pow``
  and the norm's reduction may differ in the last bit).  With bf16
  moments a last-bit difference can carry a moment across a bf16
  rounding boundary: that moment then differs by one bf16 ulp (2^-8
  relative) and its parameter's next update by at most lr * 2^-6.  So
  with bf16 moments at most 2 % of the elements may sit outside the
  float32 tolerance, each within one bf16 ulp (moments) or lr * 2^-6
  (parameters);
- the compression round trips: exact for bf16, and int8 codes exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                         clip_by_global_norm, compress_grads,
                                         compress_int8, decompress_int8,
                                         init_state, schedule)

RTOL, ATOL = 2e-6, 1e-9


def _t(a):
    """numpy (ml_dtypes bf16 too) -> torch."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _f32(a):
    return np.asarray(a).astype(np.float32)


# ---------------------------------------------------------------- battery
def test_adamw_moves_toward_minimum():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=100, min_lr_ratio=1.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_state(params, cfg)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}   # d/dw ||w||^2
        params, state, _ = apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_weight_decay_shrinks_weights():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                      total_steps=10, min_lr_ratio=1.0)
    params = {"w": torch.tensor([10.0])}
    state = init_state(params, cfg)
    params2, _, _ = apply_updates(params, {"w": torch.zeros(1)}, state, cfg)
    assert float(params2["w"][0]) < 10.0


def test_grad_clip_global_norm():
    g = {"a": torch.full((4,), 10.0), "b": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    total = sum(float(torch.sum(torch.square(x))) for x in clipped.values())
    assert abs(total - 1.0) < 1e-3
    assert float(norm) == pytest.approx(np.sqrt(800.0), rel=1e-5)


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(schedule(cfg, torch.tensor(0))) == pytest.approx(0.1)
    assert float(schedule(cfg, torch.tensor(9))) == pytest.approx(1.0)
    assert float(schedule(cfg, torch.tensor(99))) == pytest.approx(0.1,
                                                                   abs=1e-2)


def test_int8_compression_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = compress_int8(g)
    back = decompress_int8(q, s, torch.float32)
    assert float((back - g).abs().max()) <= float(s) * 0.51 + 1e-7


def test_compress_grads_tree_modes():
    g = {"a": torch.ones(8, dtype=torch.float32),
         "b": torch.ones(8, dtype=torch.bfloat16)}
    for mode in (None, "none", "bf16", "int8"):
        out = compress_grads(g, mode)
        assert list(out) == list(g)
        for k in g:
            assert out[k].dtype == g[k].dtype
    with pytest.raises(ValueError):
        compress_grads(g, "fp4")


def test_abstract_state_is_meta():
    cfg = AdamWConfig(state_dtype="bfloat16")
    params = {"w": torch.zeros(3, 5), "b": torch.zeros(5)}
    real = init_state(params, cfg)
    meta = topt.abstract_state({k: v.to("meta") for k, v in params.items()},
                               cfg)
    assert meta.step.device.type == "meta" and meta.step.shape == ()
    for k in params:
        for r, a in ((real.m[k], meta.m[k]), (real.v[k], meta.v[k])):
            assert a.device.type == "meta"
            assert r.shape == a.shape and r.dtype == a.dtype == torch.bfloat16


# ---------------------------------------------------------------- side by side
@pytest.mark.parametrize("step", [0, 3, 9, 10, 57, 99, 150])
def test_schedule_matches_reference(step):
    cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    want = np.float32(jopt.schedule(jcfg, jnp.asarray(step, jnp.int32)))
    got = schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _leaves(rng, dtype):
    shapes = {"w": (17, 33), "b": (33,), "emb": (64, 8), "s": (1,)}
    return {k: (rng.normal(size=s) * 0.3).astype(np.float32).astype(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_matches_reference(dtype, max_norm):
    rng = np.random.default_rng(1)
    g = _leaves(rng, jnp.dtype(dtype))
    want, wnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got, norm = clip_by_global_norm({k: _t(v) for k, v in g.items()},
                                    max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for k in g:
        assert got[k].dtype == _t(g[k]).dtype
        np.testing.assert_allclose(_np(got[k]), _f32(want[k]), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(dtype, state_dtype):
    """Three steps from identical gradients (each step's gradients drawn
    anew), with a clip that bites on the first; weight decay on."""
    rng = np.random.default_rng(2)
    jd = jnp.dtype(dtype)
    p0 = _leaves(rng, jd)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
              weight_decay=0.1, state_dtype=state_dtype)
    jcfg, cfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    js, ts = jopt.init_state(jp, jcfg), init_state(tp, cfg)
    for i in range(3):
        g = {k: (rng.normal(size=v.shape) * (3.0 if i == 0 else 0.05))
             .astype(np.float32).astype(jd) for k, v in p0.items()}
        jp, js, jm = jopt.apply_updates(jp, {k: jnp.asarray(v)
                                             for k, v in g.items()}, js, jcfg)
        tp, ts, tm = apply_updates(tp, {k: _t(v) for k, v in g.items()}, ts,
                                   cfg)
        assert int(ts.step) == int(js.step) == i + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in p0:
            assert tp[k].dtype == _t(p0[k]).dtype
            assert ts.m[k].dtype == getattr(torch, state_dtype)
            _close(_np(tp[k]), _f32(jp[k]), state_dtype,
                   flip=kw["lr"] * 2.0 ** -6, what=f"param {k} step {i}")
            for name, a, b in (("m", ts.m[k], js.m[k]),
                               ("v", ts.v[k], js.v[k])):
                want = _f32(b)
                _close(_np(a), want, state_dtype,
                       flip=np.abs(want) * 2.0 ** -8 + ATOL,
                       what=f"{name} {k} step {i}")


def _close(got, want, state_dtype, flip, what):
    """float32 rounding everywhere, but for bf16 moments' rounding flips
    (see the module docstring)."""
    off = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    if state_dtype == "float32" or not off.any():
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)
        return
    assert off.mean() <= 0.02, (what, int(off.sum()), off.size)
    assert (np.abs(got - want) <= flip).all(), what


def test_apply_updates_in_slices_equals_whole(monkeypatch):
    """The update's slicing (``UPDATE_CHUNK``) changes no number."""
    rng = np.random.default_rng(3)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, state_dtype="bfloat16")
    p0 = {"w": torch.from_numpy(rng.normal(size=(40, 25)).astype(np.float32))
          .to(torch.bfloat16)}
    g = {"w": torch.from_numpy(rng.normal(size=(40, 25)).astype(np.float32))
         .to(torch.bfloat16)}
    whole = {"w": p0["w"].clone()}
    s1 = init_state(whole, cfg)
    apply_updates(whole, g, s1, cfg)
    monkeypatch.setattr(topt, "UPDATE_CHUNK", 7)
    sliced = {"w": p0["w"].clone()}
    s2 = init_state(sliced, cfg)
    apply_updates(sliced, g, s2, cfg)
    assert torch.equal(whole["w"], sliced["w"])
    assert torch.equal(s1.m["w"], s2.m["w"])
    assert torch.equal(s1.v["w"], s2.v["w"])


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_matches_reference(dtype, mode):
    rng = np.random.default_rng(4)
    g = _leaves(rng, jnp.dtype(dtype))
    want = jopt.compress_grads({k: jnp.asarray(v) for k, v in g.items()},
                               mode)
    got = compress_grads({k: _t(v) for k, v in g.items()}, mode)
    for k in g:
        assert got[k].dtype == _t(g[k]).dtype
        np.testing.assert_allclose(_np(got[k]), _f32(want[k]), rtol=RTOL,
                                   atol=ATOL)


def test_int8_codes_round_half_to_even():
    """Values at exact .5 multiples of the scale: ``torch.round`` and
    ``jnp.round`` both round half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2)."""
    base = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 127.0],
                    dtype=np.float32)
    want_q, want_s = jopt.compress_int8(jnp.asarray(base))
    got_q, got_s = compress_int8(torch.from_numpy(base))
    assert float(got_s) == float(want_s) == 1.0
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_q.numpy()[:7], [0, 2, 2, 0, -2, -2, 4])
    rng = np.random.default_rng(5)
    g = rng.normal(size=(4096,)).astype(np.float32)
    want_q, _ = jopt.compress_int8(jnp.asarray(g))
    got_q, _ = compress_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
