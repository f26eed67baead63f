"""The port's itemset-count wrapper against the JAX package's, on the same
numpy inputs, with exact integer equality.

On the CPU the port runs the kernel's plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode, as its own tests do.  The CUDA
kernel itself is compared with the plain version on the card by the
``cuda``-marked test at the end (skipped without a card) and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _testutil import random_problem
from repro.kernels.itemset_count import itemset_counts as jax_counts
from repro.kernels.itemset_count import itemset_counts_into as jax_counts_into
from repro.kernels.itemset_count import itemset_counts_ref as jax_ref
from repro_torch._device import resolve_device
from repro_torch.kernels.itemset_count import (itemset_counts,
                                               itemset_counts_into,
                                               itemset_counts_ref,
                                               itemset_counts_ref_blocked)
from repro_torch.kernels.itemset_count import ops

SHAPES = [
    # (N, K, W, C, block_k, block_n) — the JAX kernel test's shape list
    (1, 1, 1, 1, 8, 128),
    (128, 8, 1, 1, 8, 128),
    (200, 5, 2, 2, 8, 128),
    (1024, 256, 4, 2, 256, 1024),
    (1500, 300, 4, 3, 256, 512),
    (4096, 64, 8, 1, 64, 2048),
    (333, 17, 16, 4, 16, 128),
    (777, 130, 33, 2, 128, 256),
]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax(tx, tgt, wts, **kw):
    return np.asarray(jax_counts(jnp.asarray(tx), jnp.asarray(tgt),
                                 jnp.asarray(wts), **kw))


@pytest.mark.parametrize("n,k,w,c,bk,bn", SHAPES)
def test_counts_match_jax_shapes(n, k, w, c, bk, bn):
    rng = np.random.default_rng(n * 7 + k)
    tx, tgt, wts = random_problem(rng, n, k, w, c)
    want = _jax(tx, tgt, wts, block_k=bk, block_n=bn)
    got = itemset_counts(*_t(tx, tgt, wts))
    assert got.dtype == torch.int32 and tuple(got.shape) == (k, c)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(5))
def test_counts_match_jax_random(seed):
    rng = np.random.default_rng(100 + seed)
    n, k = int(rng.integers(1, 700)), int(rng.integers(1, 90))
    w, c = int(rng.integers(1, 6)), int(rng.integers(1, 4))
    tx, tgt, wts = random_problem(rng, n, k, w, c, density=0.5)
    assert np.array_equal(itemset_counts(*_t(tx, tgt, wts)).numpy(),
                          _jax(tx, tgt, wts))


@pytest.mark.parametrize("w", [65, 70])
def test_wide_words_match_jax_fallback(w):
    """W > 64: the JAX wrapper takes its blocked reference; the port's
    plain version (and on the card, its kernel) takes every W."""
    rng = np.random.default_rng(w)
    tx, tgt, wts = random_problem(rng, 300, 20, w, 2)
    assert np.array_equal(itemset_counts(*_t(tx, tgt, wts)).numpy(),
                          _jax(tx, tgt, wts))


def test_weight_vector_promotion_matches_jax():
    rng = np.random.default_rng(4)
    tx, tgt, _ = random_problem(rng, 64, 4, 2, 1)
    w1 = rng.integers(0, 5, size=64).astype(np.int32)
    got = itemset_counts(*_t(tx, tgt, w1))
    assert tuple(got.shape) == (4, 1)
    assert np.array_equal(got.numpy(), _jax(tx, tgt, w1))


@pytest.mark.parametrize("n,k,c", [(0, 3, 2), (5, 0, 1)])
def test_empty_inputs_match_jax(n, k, c):
    tx = np.zeros((n, 2), np.uint32)
    tgt = np.zeros((k, 2), np.uint32)
    wts = np.ones((n, c), np.int32)
    got = itemset_counts(*_t(tx, tgt, wts))
    want = _jax(tx, tgt, wts)
    assert tuple(got.shape) == want.shape == (k, c)
    assert np.array_equal(got.numpy(), want)


def _bad_inputs():
    ok_tx = np.zeros((4, 2), np.uint32)
    ok_tgt = np.zeros((3, 2), np.uint32)
    ok_w = np.ones((4, 1), np.int32)
    return {
        "tx_dtype": (ok_tx.astype(np.int32), ok_tgt, ok_w, TypeError),
        "tgt_dtype": (ok_tx, ok_tgt.astype(np.int64), ok_w, TypeError),
        "ndim": (ok_tx, ok_tgt, np.ones((4, 1, 1), np.int32), ValueError),
        "word_width": (ok_tx, np.zeros((3, 3), np.uint32), ok_w, ValueError),
        "rows": (ok_tx, ok_tgt, np.ones((5, 1), np.int32), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_typed_errors_match_jax_ref(case):
    tx, tgt, wts, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        jax_ref(jnp.asarray(tx), jnp.asarray(tgt), jnp.asarray(wts))
    with pytest.raises(exc):
        itemset_counts_ref(*_t(tx, tgt, wts))
    with pytest.raises(exc):
        itemset_counts(*_t(tx, tgt, wts))


@pytest.mark.parametrize("n,k,w,c", [(300, 40, 2, 2), (1000, 7, 3, 1),
                                     (129, 65, 5, 3)])
def test_counts_into_matches_jax(n, k, w, c):
    rng = np.random.default_rng(n + k)
    tx, tgt, wts = random_problem(rng, n, k, w, c)
    acc0 = rng.integers(-50, 50, size=(k, c)).astype(np.int32)
    want = np.asarray(jax_counts_into(jnp.asarray(acc0), jnp.asarray(tx),
                                      jnp.asarray(tgt), jnp.asarray(wts)))
    acc = torch.from_numpy(acc0.copy())
    got = itemset_counts_into(acc, *_t(tx, tgt, wts))
    assert got is acc                      # updated in place
    assert np.array_equal(got.numpy(), want)


def test_blocked_ref_matches_single_block():
    rng = np.random.default_rng(0)
    tx, tgt, wts = _t(*random_problem(rng, 1000, 40, 3, 2))
    a = itemset_counts_ref(tx, tgt, wts)
    b = itemset_counts_ref_blocked(tx, tgt, wts, block_n=97, block_k=7)
    assert torch.equal(a, b)


def test_cpu_tensor_runs_plain_version_without_launch():
    rng = np.random.default_rng(1)
    tx, tgt, wts = _t(*random_problem(rng, 100, 10, 2, 2))
    before = ops.KERNEL_LAUNCHES
    itemset_counts(tx, tgt, wts, block_k=64, block_n=256)
    assert ops.KERNEL_LAUNCHES == before


def test_mxu_f32_raises_not_implemented():
    rng = np.random.default_rng(2)
    tx, tgt, wts = _t(*random_problem(rng, 64, 4, 2, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        itemset_counts(tx, tgt, wts, accum="mxu_f32")
    with pytest.raises(ValueError):
        itemset_counts(tx, tgt, wts, accum="bogus")


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from repro_torch.mining import DenseDB
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseDB.encode([[1, 2], [2]])         # entry points default to cuda


@pytest.mark.parametrize("geom", [(969130, 34220, 2, 2), (1, 1, 1, 1),
                                  (5000, 100, 65, 17)])
def test_kernel_model_counts_and_buckets_match_jax(geom):
    from repro.roofline import kernel_model as jkm
    from repro_torch.roofline import kernel_model as km

    n, k, w, c = geom
    assert km.kernel_bytes(*geom) == jkm.kernel_bytes(*geom)
    assert km.geometry_bucket(*geom) == jkm.geometry_bucket(*geom)
    # one LOP3 per word and pair, C adds per contained pair; the JAX model's
    # 2W + C per pair is an upper bound on that even if every pair hits
    assert km.kernel_flops(*geom) == n * k * w
    assert km.kernel_flops(*geom, hits=7) == n * k * w + 7 * c
    assert km.kernel_flops(*geom, hits=n * k) <= jkm.kernel_flops(*geom)
    assert km.predicted_seconds(*geom, hits=3) == max(
        km.kernel_flops(*geom, hits=3) / km.PEAK_INT32_OPS,
        km.kernel_bytes(*geom) / km.HBM_BW)


def test_record_launch_publishes_measured_against_predicted():
    from repro_torch import obs
    from repro_torch.roofline import kernel_model as km

    obs.reset()
    try:
        km.record_launch(1000, 10, 2, 2, 0.5)
        eff = obs.kernel_efficiency()[km.geometry_bucket(1000, 10, 2, 2)]
        assert eff["launches"] == 1 and eff["measured_s"] == 0.5
        assert eff["predicted_s"] == km.predicted_seconds(1000, 10, 2, 2)
    finally:
        obs.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,w,c,bk,bn", SHAPES + [
    (2000, 50, 65, 2, 128, 512), (3000, 40, 3, 17, 128, 512)])
def test_cuda_kernel_matches_plain_version(n, k, w, c, bk, bn):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n * 7 + k)
    tx, tgt, wts = [t.to(dev) for t in _t(*random_problem(rng, n, k, w, c))]
    before = ops.KERNEL_LAUNCHES
    got = itemset_counts(tx, tgt, wts, block_k=bk, block_n=bn)
    assert ops.KERNEL_LAUNCHES == before + 1
    want = itemset_counts(tx, tgt, wts, use_kernel=False)
    assert torch.equal(got, want)
    acc0 = torch.randint(-9, 9, (k, c), dtype=torch.int32, device=dev)
    acc = acc0.clone()
    itemset_counts_into(acc, tx, tgt, wts, block_k=bk, block_n=bn)
    assert torch.equal(acc, acc0 + want)


def test_kernel_timings_are_read_without_waiting_until_snapshot():
    """A timed launch is published once its end event has landed (read
    without waiting) or when the telemetry is read (waiting)."""
    from repro_torch import obs
    from repro_torch.roofline import kernel_model as km

    class _Event:
        def __init__(self, t, done):
            self.t, self.done, self.waited = t, done, False

        def query(self):
            return self.done

        def synchronize(self):
            self.waited = True

        def elapsed_time(self, end):
            return end.t - self.t

    obs.reset()
    try:
        finished, running = _Event(3.0, True), _Event(9.0, False)
        ops._PENDING[:] = [(_Event(1.0, True), finished, 1000, 10, 2, 2),
                           (_Event(5.0, True), running, 1000, 10, 2, 2)]
        ops.flush_timings(wait=False)
        geom = km.geometry_bucket(1000, 10, 2, 2)
        eff = obs.kernel_efficiency(obs.REGISTRY.snapshot())[geom]
        assert eff["launches"] == 1 and eff["measured_s"] == 2.0 / 1e3
        assert len(ops._PENDING) == 1 and not running.waited
        eff = obs.kernel_efficiency()[geom]       # snapshot() flushes
        assert running.waited and not ops._PENDING
        assert eff["launches"] == 2 and eff["measured_s"] == 6.0 / 1e3
    finally:
        ops._PENDING.clear()
        obs.reset()
