"""The port's itemset-count wrapper against the JAX package's, on the same
numpy inputs, with exact integer equality.

On the CPU the port runs the kernels' plain PyTorch versions (K1's for
``accum="vpu_int32"``, K2's float32 product for ``accum="mxu_f32"``); the JAX
side runs its Pallas kernel in interpret mode, as its own tests do.  The CUDA
kernels themselves are compared with their plain versions on the card by the
``cuda``-marked tests (skipped without a card) and by ``chip_smoke.py``.
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
from repro_torch.roofline import autotune


@pytest.fixture(autouse=True)
def _untuned():
    """Pin the port's autotuner to the compiled-in defaults (``conftest.py``
    pins the JAX package's)."""
    autotune.set_active_table(None)
    yield
    autotune.set_active_table(None)


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


def test_bogus_accum_raises_value_error():
    rng = np.random.default_rng(2)
    tx, tgt, wts = _t(*random_problem(rng, 64, 4, 2, 2))
    with pytest.raises(ValueError, match="bogus"):
        itemset_counts(tx, tgt, wts, accum="bogus")
    with pytest.raises(ValueError, match="bogus"):
        itemset_counts_into(torch.zeros((4, 2), dtype=torch.int32), tx, tgt,
                            wts, accum="bogus")


# -- K2: accum="mxu_f32" ------------------------------------------------------

@pytest.mark.parametrize("n,k,w,c,bk,bn", SHAPES)
def test_mxu_counts_match_jax_shapes(n, k, w, c, bk, bn):
    rng = np.random.default_rng(n * 7 + k)
    tx, tgt, wts = random_problem(rng, n, k, w, c)
    want = _jax(tx, tgt, wts, block_k=bk, block_n=bn, accum="mxu_f32")
    got = itemset_counts(*_t(tx, tgt, wts), block_k=bk, block_n=bn,
                         accum="mxu_f32")
    assert got.dtype == torch.int32 and tuple(got.shape) == (k, c)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("accum", ["vpu_int32", "mxu_f32"])
def test_accum_variants_match_jax(accum):
    rng = np.random.default_rng(11)
    tx, tgt, wts = random_problem(rng, 1111, 77, 5, 3)
    want = _jax(tx, tgt, wts, accum=accum, block_k=32, block_n=256)
    got = itemset_counts(*_t(tx, tgt, wts), accum=accum, block_k=32,
                         block_n=256)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jax_ref(
        jnp.asarray(tx), jnp.asarray(tgt), jnp.asarray(wts))))


@pytest.mark.parametrize("n,k,w,c,bk,bn", [
    (64, 8, 2, 2, 8, 128),
    (1111, 77, 5, 3, 32, 256),       # multi-tile + ragged on both axes
    (2048, 256, 4, 1, 256, 1024),    # exact blocks
])
def test_mxu_f32_differential_parity(n, k, w, c, bk, bn):
    """mxu == vpu == the plain versions, in both packages."""
    rng = np.random.default_rng(n + k)
    tx, tgt, wts = random_problem(rng, n, k, w, c)
    args = _t(tx, tgt, wts)
    got_mxu = itemset_counts(*args, accum="mxu_f32", block_k=bk, block_n=bn)
    got_vpu = itemset_counts(*args, accum="vpu_int32", block_k=bk,
                             block_n=bn)
    assert torch.equal(got_mxu, got_vpu)
    assert torch.equal(got_mxu, itemset_counts_ref(*args, accum="mxu_f32"))
    assert np.array_equal(got_mxu.numpy(), _jax(
        tx, tgt, wts, accum="mxu_f32", block_k=bk, block_n=bn))


def _near_2p24():
    n = 8
    tx = np.full((n, 1), 0xFFFFFFFF, np.uint32)      # contain every target
    tgt = np.zeros((3, 1), np.uint32)
    tgt[1, 0] = 1
    tgt[2, 0] = 0b11
    wts = np.full((n, 1), (1 << 21) - 1, np.int32)
    return tx, tgt, wts


def test_mxu_f32_exact_near_2p24_bound():
    """Counts just below the 2^24 f32-exactness bound stay bit-exact; the
    weights 2^21 - 1 have 21 significant bits, which TF32 would round."""
    tx, tgt, wts = _near_2p24()
    got = itemset_counts(*_t(tx, tgt, wts), accum="mxu_f32")
    want = _jax(tx, tgt, wts, accum="mxu_f32")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), itemset_counts(
        *_t(tx, tgt, wts), accum="vpu_int32").numpy())
    assert int(got[0, 0]) == (1 << 24) - 8


def test_mxu_plain_version_turns_tf32_off_and_restores():
    tx, tgt, wts = _t(*_near_2p24())
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        got = itemset_counts_ref(tx, tgt, wts, accum="mxu_f32")
        assert int(got[0, 0]) == (1 << 24) - 8
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def test_mxu_f32_row_bound_raises_value_error(monkeypatch):
    """N >= 2^24 rows per launch is refused with the geometry in the text,
    as the JAX package refuses it, before any counting work starts."""
    n = 1 << 24
    tx = np.zeros((n, 1), np.uint32)
    tgt = np.zeros((1, 1), np.uint32)
    w = np.ones((n, 1), np.int32)
    with pytest.raises(ValueError, match=r"N < 2\^24.*N=16777216"):
        jax_counts(jnp.asarray(tx), jnp.asarray(tgt), jnp.asarray(w),
                   accum="mxu_f32")

    def no_counting(*a, **kw):
        raise AssertionError("counted before the row guard")

    monkeypatch.setattr(ops, "itemset_counts_ref_blocked", no_counting)
    monkeypatch.setattr(ops, "_launch", no_counting)
    args = _t(tx, tgt, w)
    with pytest.raises(ValueError, match=r"N < 2\^24.*N=16777216"):
        itemset_counts(*args, accum="mxu_f32")
    with pytest.raises(ValueError, match=r"N < 2\^24.*N=16777216"):
        itemset_counts_into(torch.zeros((1, 1), dtype=torch.int32), *args,
                            accum="mxu_f32")


@pytest.mark.parametrize("n,k,w,c", [(300, 40, 2, 2), (1000, 7, 3, 1),
                                     (129, 65, 5, 3)])
def test_mxu_counts_into_matches_jax(n, k, w, c):
    rng = np.random.default_rng(n + k + 1)
    tx, tgt, wts = random_problem(rng, n, k, w, c)
    acc0 = rng.integers(-50, 50, size=(k, c)).astype(np.int32)
    want = np.asarray(jax_counts_into(jnp.asarray(acc0), jnp.asarray(tx),
                                      jnp.asarray(tgt), jnp.asarray(wts),
                                      accum="mxu_f32"))
    acc = torch.from_numpy(acc0.copy())
    got = itemset_counts_into(acc, *_t(tx, tgt, wts), accum="mxu_f32")
    assert got is acc
    assert np.array_equal(got.numpy(), want)


def test_cpu_mxu_runs_plain_version_without_launch():
    rng = np.random.default_rng(3)
    tx, tgt, wts = _t(*random_problem(rng, 100, 10, 2, 2))
    before = dict(ops.KERNEL_LAUNCHES_BY_ACCUM), ops.KERNEL_LAUNCHES
    itemset_counts(tx, tgt, wts, accum="mxu_f32")
    assert (dict(ops.KERNEL_LAUNCHES_BY_ACCUM), ops.KERNEL_LAUNCHES) == before


def test_kernel_model_mxu_bound():
    from repro.roofline import kernel_model as jkm
    from repro_torch.roofline import kernel_model as km

    n, k, w, c = 969130, 34220, 2, 2
    words = -(-n // 32)
    ints = words * k / km.PEAK_INT32_OPS     # one AND per target and word
    # the card's b1 rate: 8 bits for every int8 operation of its tensor rate
    assert km.PEAK_B1_TENSOR_OPS == 8 * km.PEAK_INT8_TENSOR_OPS
    # the b1 product: 2 bit operations per row (32 a word), target and live
    # plane word; C planes in every word when the live planes are not known
    assert km.b1_ops(k, c * words) == 2 * 32 * words * k * c
    b1 = km.b1_ops(k, c * words) / km.PEAK_B1_TENSOR_OPS
    assert km.and_ops(n, k) == words * k
    assert km.predicted_seconds(n, k, w, c, accum="mxu_f32") == max(
        ints, b1, km.kernel_bytes(n, k, w, c) / km.HBM_BW) == ints
    # even 11 planes live in every word of the main path's level 3 cost
    # about 0.046 ms of b1 product, below the 0.062 ms of bit-sliced
    # containment: K2's bound there is its ANDs
    p11 = km.b1_ops(k, 11 * words) / km.PEAK_B1_TENSOR_OPS
    assert 0.06e-3 < ints < 0.065e-3 and 0.044e-3 < p11 < 0.048e-3
    assert km.predicted_seconds(n, k, w, c, accum="mxu_f32",
                                plane_words=11 * words) == ints
    assert km.bound_by(n, k, w, c, accum="mxu_f32",
                       plane_words=11 * words) == "operations"
    # three items a target: floor(3/2) = 1 AND per word, the same count
    assert km.predicted_seconds(n, k, w, c, accum="mxu_f32",
                                plane_words=11 * words,
                                target_sizes=[3] * k) == ints
    # the first K2's byte-plane bound stays reachable beside it: 2*N*K*4C
    # int8 operations, about 0.27 ms
    assert km.byte_plane_ops(n, k, c) == 2 * n * k * 4 * c
    tensor = km.byte_plane_ops(n, k, c) / km.PEAK_INT8_TENSOR_OPS
    assert 0.26e-3 < tensor < 0.28e-3
    assert km.byte_plane_seconds(n, k, w, c) == max(
        ints, tensor, km.kernel_bytes(n, k, w, c) / km.HBM_BW) == tensor
    assert km.byte_plane_seconds(n, k, w, c) > km.predicted_seconds(
        n, k, w, c, accum="mxu_f32", plane_words=11 * words)
    # the horizontal count stays reachable, and the JAX model's beside it
    assert km.horizontal_flops(n, k, w, c) == n * k * w
    assert jkm.kernel_flops(n, k, w, c) == n * k * (2 * w + c)
    assert km.and_ops(n, k) < km.horizontal_flops(n, k, w, c) \
        < jkm.kernel_flops(n, k, w, c)
    # hits do not enter K2's bound: its adds run on the tensor cores
    assert km.predicted_seconds(n, k, w, c, hits=n * k, accum="mxu_f32") \
        == km.predicted_seconds(n, k, w, c, accum="mxu_f32")
    # full-range weights keep all 64 planes of 2 classes live in every word:
    # the b1 term is the larger one
    g = (1 << 20, 4096, 2, 2)
    full = 64 * (1 << 15)
    assert km.predicted_seconds(*g, accum="mxu_f32", plane_words=full) == \
        km.b1_ops(4096, full) / km.PEAK_B1_TENSOR_OPS
    assert km.bound_by(*g, accum="mxu_f32", plane_words=full) == "operations"


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
    words = -(-n // 32)
    assert km.kernel_bytes(*geom) == jkm.kernel_bytes(*geom)
    assert km.geometry_bucket(*geom) == jkm.geometry_bucket(*geom)
    # bit-sliced: one AND per target and row-word of 32 rows when the
    # targets' sizes are unknown, C adds per contained pair
    assert km.kernel_flops(*geom) == words * k
    assert km.kernel_flops(*geom, hits=7) == words * k + 7 * c
    # the horizontal count (one LOP3 per word and pair) and the JAX
    # model's N*K*(2W + C) stay pinned beside it, each above the last
    assert km.horizontal_flops(*geom) == n * k * w
    assert km.horizontal_flops(*geom, hits=7) == n * k * w + 7 * c
    assert jkm.kernel_flops(*geom) == n * k * (2 * w + c)
    assert km.kernel_flops(*geom, hits=n * k) \
        <= km.horizontal_flops(*geom, hits=n * k) <= jkm.kernel_flops(*geom)
    assert km.predicted_seconds(*geom, hits=3) == max(
        km.kernel_flops(*geom, hits=3) / km.PEAK_INT32_OPS,
        km.kernel_bytes(*geom) / km.HBM_BW)
    assert km.horizontal_seconds(*geom, hits=3) == max(
        km.horizontal_flops(*geom, hits=3) / km.PEAK_INT32_OPS,
        km.kernel_bytes(*geom) / km.HBM_BW)


@pytest.mark.parametrize("sizes,ands", [
    ([0], 0), ([1], 0), ([2], 1), ([3], 1), ([4], 2), ([5], 2), ([64], 32),
    ([0, 1, 2, 3], 2), ([3] * 7, 7)])
def test_kernel_model_and_count_by_target_size(sizes, ands):
    """ceil((s - 1) / 2) three-input ANDs per target of s items and 32 rows:
    none for the empty itemset (the all-ones column) or a single item."""
    from repro_torch.roofline import kernel_model as km

    n, k = 1000, len(sizes)                     # 32 row-words
    assert km.and_ops(n, k, sizes) == 32 * ands
    assert km.and_ops(n, k, iter(sizes)) == 32 * ands
    assert km.and_ops(n, k) == 32 * k           # sizes unknown
    assert km.kernel_flops(n, k, 2, 3, hits=5, target_sizes=sizes) \
        == 32 * ands + 15
    assert km.predicted_seconds(n, k, 2, 3, hits=5, target_sizes=sizes) == \
        max((32 * ands + 15) / km.PEAK_INT32_OPS,
            km.kernel_bytes(n, k, 2, 3) / km.HBM_BW)
    # a few tiny targets over 1000 rows move more bytes than they compute
    assert km.bound_by(n, k, 2, 3, hits=5, target_sizes=sizes) == "bytes"


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


def test_record_launch_predicts_with_the_launch_route():
    """A K2 launch is held against K2's bound with C live planes in every
    row-word."""
    from repro_torch import obs
    from repro_torch.roofline import kernel_model as km

    geom = (1 << 16, 1 << 16, 2, 16)
    obs.reset()
    try:
        km.record_launch(*geom, 0.5, accum="mxu_f32")
        eff = obs.kernel_efficiency()[km.geometry_bucket(*geom)]
        want = km.predicted_seconds(*geom, accum="mxu_f32",
                                    plane_words=16 * (1 << 11))
        assert eff["predicted_s"] == want
        assert want != km.predicted_seconds(*geom)
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


MXU_CUDA_SHAPES = SHAPES + [
    # ragged K (not a multiple of 16) and N (not a multiple of 32), C = 1-3,
    # W = 1, 2, 5, 65, and a class count past one 16-class launch group
    (33, 17, 1, 1, 16, 128), (1025, 45, 2, 2, 64, 512),
    (999, 130, 2, 3, 128, 512), (4097, 200, 5, 1, 256, 512),
    (777, 50, 65, 2, 32, 512), (3000, 40, 3, 17, 128, 512),
    (70000, 300, 2, 2, 128, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,w,c,bk,bn", MXU_CUDA_SHAPES)
def test_cuda_mxu_kernel_matches_plain_version(n, k, w, c, bk, bn):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n * 7 + k)
    tx, tgt, wts = [t.to(dev) for t in _t(*random_problem(rng, n, k, w, c))]
    before = ops.KERNEL_LAUNCHES_BY_ACCUM["mxu_f32"]
    got = itemset_counts(tx, tgt, wts, block_k=bk, block_n=bn,
                         accum="mxu_f32")
    assert ops.KERNEL_LAUNCHES_BY_ACCUM["mxu_f32"] == before + 1
    want = itemset_counts(tx, tgt, wts, use_kernel=False, accum="mxu_f32")
    assert torch.equal(got, want)
    acc0 = torch.randint(-9, 9, (k, c), dtype=torch.int32, device=dev)
    acc = acc0.clone()
    itemset_counts_into(acc, tx, tgt, wts, block_k=bk, block_n=bn,
                        accum="mxu_f32")
    assert torch.equal(acc, acc0 + want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,w,c", [(5000, 100, 2, 2), (3001, 77, 5, 3),
                                     (2000, 33, 1, 1)])
def test_cuda_mxu_kernel_exact_for_full_range_weights(n, k, w, c):
    """K2 folds the byte planes modulo 2^32, so it equals K1's wrapping
    int32 sum for any int32 weights, negative ones included — every byte of
    every weight reaches the tensor cores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n + c)
    tx, tgt, _ = random_problem(rng, n, k, w, c)
    wts = rng.integers(-(1 << 31), 1 << 31, size=(n, c), dtype=np.int64
                       ).astype(np.int32)
    tx, tgt, wts = [t.to(dev) for t in _t(tx, tgt, wts)]
    got = itemset_counts(tx, tgt, wts, accum="mxu_f32")
    assert torch.equal(got, itemset_counts(tx, tgt, wts, use_kernel=False))
    assert torch.equal(got, itemset_counts(tx, tgt, wts, accum="vpu_int32"))


@pytest.mark.cuda
def test_cuda_mxu_kernel_exact_near_2p24_bound():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dev = torch.device("cuda")
    tx, tgt, wts = [t.to(dev) for t in _t(*_near_2p24())]
    got = itemset_counts(tx, tgt, wts, accum="mxu_f32")
    assert torch.equal(got, itemset_counts(tx, tgt, wts, accum="mxu_f32",
                                           use_kernel=False))
    assert int(got[0, 0]) == (1 << 24) - 8


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
        ops._PENDING[:] = [
            (_Event(1.0, True), finished, 1000, 10, 2, 2, "vpu_int32"),
            (_Event(5.0, True), running, 1000, 10, 2, 2, "vpu_int32")]
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


# -- K1's bit-sliced form: the plain version against the JAX package ---------

from repro_torch.kernels.itemset_count.ref import (heavy_rows,
                                                   itemset_counts_sliced,
                                                   to_item_columns,
                                                   to_weight_planes)


def _sliced_problem(n, k, w, c, weights, seed):
    """A random problem whose first target is the empty itemset and whose
    second is a single item; ``weights`` is "small" (0..6), "negative"
    (-50..50) or "full" (the whole int32 range)."""
    rng = np.random.default_rng(seed)
    tx, tgt, _ = random_problem(rng, n, k, w, c, density=0.5)
    tgt[0] = 0
    if k > 1:
        tgt[1] = 0
        b = int(rng.integers(0, 32 * w))
        tgt[1, b >> 5] = np.uint32(1) << np.uint32(b & 31)
    lo, hi = {"small": (0, 7), "negative": (-50, 51),
              "full": (-(1 << 31), 1 << 31)}[weights]
    wts = rng.integers(lo, hi, size=(n, c), dtype=np.int64).astype(np.int32)
    return tx, tgt, wts, rng


SLICED_CASES = [
    # (N, K, W, C, block_n, weights): ragged N (N % 32 != 0, N < 32),
    # W in {1, 2, 3, 5, 65}, C in {1, 2, 3, 17}; stages of ceil(block_n / 32)
    # row-words
    (1, 3, 1, 1, 512, "small"),
    (31, 9, 2, 2, 512, "negative"),
    (33, 20, 1, 3, 1, "full"),
    (200, 17, 2, 2, 100, "full"),
    (1000, 40, 3, 17, 4096, "negative"),
    (777, 30, 5, 2, 512, "full"),
    (333, 12, 65, 2, 4096, "small"),
    (4099, 25, 2, 1, 256, "full"),
]


@pytest.mark.parametrize("n,k,w,c,bn,weights", SLICED_CASES)
def test_bit_sliced_counts_match_jax(n, k, w, c, bn, weights):
    tx, tgt, wts, _ = _sliced_problem(n, k, w, c, weights, n + k + w)
    sw = -(-bn // 32)
    words = -(-n // 32)
    t_tx, t_tgt, t_w = _t(tx, tgt, wts)
    cols = to_item_columns(t_tx)
    planes, live = to_weight_planes(t_w, sw)
    assert tuple(cols.shape) == (32 * w + 1, words)
    assert tuple(planes.shape) == (c, 32, words)
    assert tuple(live.shape) == (c, -(-words // sw))
    got = itemset_counts_sliced(cols, planes, live, t_tgt, sw, block_k=7)
    want = np.asarray(jax_ref(jnp.asarray(tx), jnp.asarray(tgt),
                              jnp.asarray(wts)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the empty itemset counts every row: the column sums, wrapped
    sums = wts.astype(np.int64).sum(0)
    assert np.array_equal(got[0].numpy(),
                          ((sums + (1 << 31)) % (1 << 32) - (1 << 31)))


@pytest.mark.parametrize("n,k,w,c,bn,weights", SLICED_CASES[::2])
def test_bit_sliced_counts_into_match_jax(n, k, w, c, bn, weights):
    """The accumulate form: acc + counts over the bit-sliced layout equals
    the JAX package's itemset_counts_into, wrapping like it."""
    tx, tgt, wts, rng = _sliced_problem(n, k, w, c, weights, n * 3 + c)
    acc0 = rng.integers(-(1 << 31), 1 << 31, size=(k, c),
                        dtype=np.int64).astype(np.int32)
    want = np.asarray(jax_counts_into(jnp.asarray(acc0), jnp.asarray(tx),
                                      jnp.asarray(tgt), jnp.asarray(wts)))
    sw = -(-bn // 32)
    t_tx, t_tgt, t_w = _t(tx, tgt, wts)
    part = itemset_counts_sliced(to_item_columns(t_tx),
                                 *to_weight_planes(t_w, sw), t_tgt, sw)
    acc = torch.from_numpy(acc0.copy())
    acc += part                                   # int32 adds wrap
    assert np.array_equal(acc.numpy(), want)


def test_bit_sliced_layout_words():
    """Column 32 * j + b holds bit b of word j of 32 rows a word (row
    32 * r + l at bit l), the last column is all ones, planes hold the
    weights' two's-complement bits, rows past N are zero, and a stage's
    live mask is the OR of its weights (the last stage is short)."""
    rng = np.random.default_rng(5)
    n, w, c, sw = 300, 2, 2, 4                     # 10 words, 3 stages
    tx = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    wts = rng.integers(-3, 4, size=(n, c)).astype(np.int32)
    wts[128:256] = np.abs(wts[128:256]) & 1        # stage 1: plane 0 only
    cols = to_item_columns(torch.from_numpy(tx)).view(torch.int32)
    planes, live = to_weight_planes(torch.from_numpy(wts), sw)
    cols = cols.numpy().view(np.uint32)
    planes = planes.view(torch.int32).numpy().view(np.uint32)
    live = live.view(torch.int32).numpy().view(np.uint32)
    assert cols.shape == (65, 10) and planes.shape == (2, 32, 10)
    assert live.shape == (2, 3)
    rows = np.arange(10 * 32)
    for item in (0, 5, 31, 32, 63):
        bits = (cols[item][rows // 32] >> (rows % 32).astype(np.uint32)) & 1
        want = np.zeros(10 * 32, np.uint32)
        want[:n] = (tx[:, item // 32] >> np.uint32(item % 32)) & 1
        assert np.array_equal(bits, want)
    assert (cols[64] == 0xFFFFFFFF).all()
    uw = wts.view(np.uint32)
    for ci in range(c):
        for b in (0, 1, 31):
            bits = (planes[ci, b][rows // 32] >> (rows % 32).astype(
                np.uint32)) & 1
            want = np.zeros(10 * 32, np.uint32)
            want[:n] = (uw[:, ci] >> np.uint32(b)) & 1
            assert np.array_equal(bits, want)
        for st in range(3):
            ors = np.bitwise_or.reduce(uw[st * 128:(st + 1) * 128, ci])
            assert live[ci, st] == ors
    assert (live[:, 1] <= 1).all()


@pytest.mark.parametrize("sw", [1, 2, 3, 4, 7, 16, 64, 1000])
def test_bit_sliced_counts_any_stage(sw):
    """The counts over the bit-sliced form do not depend on the stage the
    live masks are taken over (a short last stage, one stage for all rows,
    stages of one row-word), with heavy and negative weights."""
    tx, tgt, wts, _ = _sliced_problem(1000, 30, 2, 2, "negative", 77)
    wts[:40] = 1
    t_tx, t_tgt, t_w = _t(tx, tgt, wts)
    got = itemset_counts_sliced(to_item_columns(t_tx),
                                *to_weight_planes(t_w, sw), t_tgt, sw)
    want = np.asarray(jax_ref(jnp.asarray(tx), jnp.asarray(tgt),
                              jnp.asarray(wts)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,c,bn,sw", [
    (1, 2, 2, 512, 4),              # at least one 16-byte chunk
    (969130, 2, 2, 512, 16),        # the main path: 512 rows a stage
    (969130, 2, 2, 100, 4),         # 100 rows -> 4 words, 128 rows
    (969130, 2, 2, 4096, 128),
    (200, 2, 2, 4096, 8),           # no more than the rows need
    (5000, 65, 17, 4096, 8),        # cut to fit 227 KB
    (5000, 33, 2, 4096, 16),
    (5000, 300, 2, 512, 4),         # nothing fits: read from device memory
])
def test_bit_sliced_stage_rounding(n, w, c, bn, sw):
    """The kernel library's stage geometry (``ops.sliced_geometry``, owned
    by the kernel source) and the scratch layout it reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    g = ops.sliced_geometry(n, w, c, bn)
    assert g.stage_words == sw and g.stages == -(-(-(-n // 32)) // sw)
    nwp = g.padded_words
    assert nwp == g.stages * sw and nwp * 32 >= n
    assert g.heavy == (32 * w + 1) * nwp and g.odd == g.heavy + nwp
    assert g.live == g.odd + c * nwp and g.words == g.live + c * g.stages


def test_bit_slice_wrapper_on_cpu_is_the_plain_layout():
    rng = np.random.default_rng(8)
    tx, _, wts = random_problem(rng, 100, 1, 3, 2)
    wts[::7, 1] = 5                                # heavy rows
    t_tx, t_w = _t(tx, wts)
    before = ops.KERNEL_LAUNCHES
    cols, odd, heavy, live, sw = ops.bit_slice(t_tx, t_w, block_n=64)
    assert ops.KERNEL_LAUNCHES == before
    assert sw == 2                                 # ceil(64 / 32) row-words
    words = 4                                      # ceil(100 / 32)
    assert torch.equal(cols, to_item_columns(t_tx))
    planes, want_l = to_weight_planes(t_w, sw)
    assert torch.equal(odd, planes[:, 0]) and torch.equal(live, want_l)
    assert torch.equal(heavy, heavy_rows(planes))
    assert tuple(odd.shape) == (2, words) and tuple(heavy.shape) == (words,)
    # the heavy column marks exactly the rows with a weight not in {0, 1}
    rows = np.arange(words * 32)
    bits = (heavy.view(torch.int32).numpy().view(np.uint32)[rows // 32]
            >> (rows % 32).astype(np.uint32)) & 1
    want = np.zeros(words * 32, np.uint32)
    want[:100] = ((wts != 0) & (wts != 1)).any(1)
    assert np.array_equal(bits, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,c,bn", [(1, 1, 1, 512), (1000, 2, 2, 100),
                                      (4099, 5, 3, 4096), (2000, 65, 17, 512),
                                      (300, 300, 2, 512)])
def test_cuda_layout_pass_matches_plain_layout(n, w, c, bn):
    """The kernel's layout pass equals to_item_columns / to_weight_planes
    bit for bit over the rows, and its pad words up to whole stages are
    zero, so a layout fault shows apart from a counting fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n + w)
    tx, _, _ = random_problem(rng, n, 1, w, c)
    wts = rng.integers(-(1 << 31), 1 << 31, size=(n, c),
                       dtype=np.int64).astype(np.int32)
    t_tx, t_w = [t.to(dev) for t in _t(tx, wts)]
    got = ops.bit_slice(t_tx, t_w, block_n=bn)
    planes, live = to_weight_planes(t_w.cpu(), got.stage_words)
    want = (to_item_columns(t_tx.cpu()), planes[:, 0], heavy_rows(planes))
    words = -(-n // 32)
    for i, (g, x) in enumerate(zip(got[:3], want)):
        g = g.view(torch.int32).cpu()
        assert torch.equal(g[..., :words], x.view(torch.int32))
        pad = g[..., words:]
        if i == 0:                          # the all-ones column pads with ones
            assert not pad[:-1].any() and (pad[-1] == -1).all()
        else:
            assert not pad.any()
    assert torch.equal(got.live.view(torch.int32).cpu(),
                       live.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,w,c,big", [(5000, 60, 3, 2, False),
                                         (3001, 50, 2, 5, True),
                                         (999, 40, 300, 2, False)])
def test_cuda_kernel_knobs_and_wide_targets(n, k, w, c, big):
    """Every block_k in [1, 1024] and block_n >= 1 gives the same counts,
    also for targets of more than 8 items (the general loop) and for W too
    wide for a stage in shared memory; weights span the int32 range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dev = torch.device("cuda")
    tx, tgt, wts, rng = _sliced_problem(n, k, w, c, "full", n + k)
    if big:
        tgt[2:] = tx[:k - 2] & rng.integers(0, 2 ** 32, size=(k - 2, w),
                                             dtype=np.uint32)
    args = [t.to(dev) for t in _t(tx, tgt, wts)]
    want = itemset_counts(*args, use_kernel=False)
    for bk in (1, 32, 96, 1024):
        for bn in (1, 100, 4096):
            got = itemset_counts(*args, block_k=bk, block_n=bn)
            assert torch.equal(got, want), (bk, bn)


# -- K2's bit-sliced form: all 32 weight planes, the whole-launch masks -------

from repro_torch.kernels.itemset_count import b1_probe
from repro_torch.kernels.itemset_count.ref import (b1_tile_ref, live_planes,
                                                   live_plane_words,
                                                   whole_masks)

PLANE_CASES = [
    # (N, K, W, C, block_n, weights): ragged N, the empty and single-item
    # targets (``_sliced_problem``), W up to 65, C up to 17; small weights
    # keep every partial sum of the f32 route below 2^24
    (1, 3, 1, 1, 512, "small"),
    (31, 9, 2, 2, 96, "small"),
    (33, 20, 1, 3, 1, "small"),
    (200, 17, 2, 2, 100, "negative"),
    (1000, 40, 3, 17, 4096, "small"),
    (777, 30, 5, 2, 512, "negative"),
    (333, 12, 65, 2, 4096, "small"),
    (4099, 25, 2, 1, 1024, "negative"),
]


@pytest.mark.parametrize("n,k,w,c,bn,weights", PLANE_CASES)
def test_plane_sliced_counts_match_jax_mxu(n, k, w, c, bn, weights):
    """K2's plain version, every live plane of the bit-sliced form (and all
    32 planes at once), equals the JAX package's f32 route in interpret
    mode within its 2^24 contract."""
    tx, tgt, wts, _ = _sliced_problem(n, k, w, c, weights, n * 5 + w + c)
    sw = -(-bn // 32)
    t_tx, t_tgt, t_w = _t(tx, tgt, wts)
    cols = to_item_columns(t_tx)
    planes, live = to_weight_planes(t_w, sw)
    want = _jax(tx, tgt, wts, accum="mxu_f32", block_k=32, block_n=256)
    got = itemset_counts_sliced(cols, planes, live, t_tgt, sw, block_k=9)
    assert np.array_equal(got.numpy(), want)
    every = torch.full_like(live.view(torch.int32), -1).view(torch.uint32)
    got = itemset_counts_sliced(cols, planes, every, t_tgt, sw)
    assert np.array_equal(got.numpy(), want)
    # the wrapper's route on the CPU is the same function
    assert np.array_equal(itemset_counts(
        t_tx, t_tgt, t_w, accum="mxu_f32", block_n=bn).numpy(), want)


@pytest.mark.parametrize("n,k,w,c,weights", [
    (300, 20, 2, 2, "full"), (1000, 30, 3, 3, "full"),
    (777, 15, 65, 2, "negative"), (100, 9, 1, 17, "full")])
def test_plane_sliced_counts_match_jax_vpu_full_range(n, k, w, c, weights):
    """Over all 32 two's-complement planes the plain version is the
    wrapping int32 sum for any weights, where the f32 route would round: it
    equals the JAX package's vpu_int32 route."""
    tx, tgt, wts, _ = _sliced_problem(n, k, w, c, weights, n + k * 3 + c)
    t_tx, t_tgt, t_w = _t(tx, tgt, wts)
    planes, _ = to_weight_planes(t_w, 1)
    every = torch.full((c, 1), -1, dtype=torch.int32).view(torch.uint32)
    got = itemset_counts_sliced(to_item_columns(t_tx), planes, every, t_tgt,
                                -(-n // 32))
    want = _jax(tx, tgt, wts, accum="vpu_int32")
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), np.asarray(jax_ref(
        jnp.asarray(tx), jnp.asarray(tgt), jnp.asarray(wts))))


@pytest.mark.parametrize("weights,c", [("small", 2), ("negative", 3),
                                       ("full", 2), ("small", 17)])
def test_whole_masks_and_live_plane_list_match_the_planes(weights, c):
    """The whole-launch mask of a class is the OR of its weights (bit b set
    iff plane b has a set bit), the packed list holds exactly the nonzero
    planes, bit-major, and counting over the listed planes alone gives the
    counts of all 32."""
    tx, tgt, wts, _ = _sliced_problem(500, 20, 2, c, weights, 31 + c)
    if weights == "small":
        wts[:, 0] = np.where(wts[:, 0] == 5, 300, wts[:, 0])   # planes 2, 3, 5, 8
    t_tx, t_tgt, t_w = _t(tx, tgt, wts)
    planes, live = to_weight_planes(t_w, 4)
    whole = whole_masks(t_w)
    u = wts.view(np.uint32)
    assert np.array_equal(whole.view(torch.int32).numpy().view(np.uint32),
                          np.bitwise_or.reduce(u, axis=0))
    # whole = OR over the stages' live masks
    assert np.array_equal(
        whole.view(torch.int32).numpy().view(np.uint32),
        np.bitwise_or.reduce(live.view(torch.int32).numpy().view(np.uint32),
                             axis=1))
    codes = live_planes(whole).tolist()
    nonzero = (planes.view(torch.int32) != 0).any(-1)        # (C, 32)
    assert sorted(codes) == sorted(32 * ci + b for ci in range(c)
                                   for b in range(32) if nonzero[ci, b])
    assert codes == sorted(codes, key=lambda x: (x % 32, x // 32))
    only = torch.zeros((c, 1), dtype=torch.int64)
    for code in codes:
        only[code // 32, 0] |= 1 << (code % 32)
    only = torch.where(only >= 1 << 31, only - (1 << 32), only).to(
        torch.int32).view(torch.uint32)
    got = itemset_counts_sliced(to_item_columns(t_tx), planes, only, t_tgt,
                                -(-500 // 32))
    assert np.array_equal(got.numpy(), np.asarray(jax_ref(
        jnp.asarray(tx), jnp.asarray(tgt), jnp.asarray(wts))))
    # C = 2 with planes 0-8 and 0-1 live packs into 2 n8 tiles, not 3
    if weights == "small" and c == 2:
        assert len(codes) <= 16


@pytest.mark.parametrize("n,c,seed", [(1, 1, 0), (100, 2, 1), (999, 3, 2),
                                      (4096, 17, 3)])
def test_live_plane_words_count_the_set_bits_per_row_word(n, c, seed):
    """The live plane words are, per 32-row word, the (class, bit) pairs
    with a set bit in some row of the word: never more than the whole-launch
    planes in every word, and 0 for no weights."""
    rng = np.random.default_rng(seed)
    wts = rng.integers(0, 4, size=(n, c), dtype=np.int32)
    wts[rng.random(n) < 0.01, 0] = -5          # the sign plane, now and then
    u = wts.view(np.uint32).astype(np.uint64)
    want = 0
    for j in range(0, n, 32):
        orr = np.bitwise_or.reduce(u[j:j + 32], axis=0)
        want += sum(bin(int(x)).count("1") for x in orr)
    t_w = torch.from_numpy(wts)
    assert live_plane_words(t_w) == want
    assert want <= live_planes(whole_masks(t_w)).numel() * -(-n // 32)
    assert live_plane_words(torch.zeros((n, c), dtype=torch.int32)) == 0


def test_live_plane_list_of_no_weights_is_empty():
    assert live_planes(whole_masks(torch.zeros((5, 3), dtype=torch.int32))
                       ).numel() == 0
    assert live_planes(whole_masks(torch.zeros((0, 2), dtype=torch.int32))
                       ).numel() == 0


def test_b1_tile_plain_version_and_cpu_wrapper():
    """The plain b1 product: d[r, n] = sum_j popc(a[r, j] & b[n, j]); the
    wrapper runs it for CPU tensors without a launch."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 2 ** 32, size=(16, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(8, 8), dtype=np.uint32)
    a[3] = 0xFFFFFFFF
    want = np.array([[sum(bin(int(a[r, j]) & int(b[n, j])).count("1")
                          for j in range(8)) for n in range(8)]
                     for r in range(16)])
    ta, tb = (torch.from_numpy(x.view(np.int32)).view(torch.uint32)
              for x in (a, b))
    assert np.array_equal(b1_tile_ref(ta, tb).numpy(), want)
    before = ops.KERNEL_LAUNCHES
    assert np.array_equal(b1_probe.b1_tile(ta, tb).numpy(), want)
    assert ops.KERNEL_LAUNCHES == before


def test_bit_slice_wrapper_on_cpu_is_k2s_plain_layout():
    rng = np.random.default_rng(18)
    tx, _, wts = random_problem(rng, 100, 1, 3, 2)
    wts[::5, 1] = -7
    t_tx, t_w = _t(tx, wts)
    cols, planes, live, whole, sw = ops.bit_slice(t_tx, t_w, block_n=96,
                                                  accum="mxu_f32")
    assert sw == 3
    want_p, want_l = to_weight_planes(t_w, sw)
    assert torch.equal(cols, to_item_columns(t_tx))
    assert torch.equal(planes, want_p) and torch.equal(live, want_l)
    assert torch.equal(whole, whole_masks(t_w))
    assert tuple(planes.shape) == (2, 32, 4)


@pytest.mark.cuda
def test_cuda_b1_tile_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    rng = np.random.default_rng(10)
    for _ in range(4):
        a, b = (torch.from_numpy(rng.integers(0, 2 ** 32, size=s,
                                              dtype=np.uint32).view(np.int32))
                .view(torch.uint32) for s in ((16, 8), (8, 8)))
        got = b1_probe.b1_tile(a.cuda(), b.cuda()).cpu()
        assert torch.equal(got, b1_tile_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,c,bn,sw", [
    (1, 2, 2, 512, 32),             # at least one 32-row-word stage
    (969130, 2, 2, 512, 32),        # the main path: 1024 rows a stage
    (969130, 2, 2, 1, 32),
    (969130, 2, 2, 1025, 64),       # 1025 rows -> 33 words -> 64
    (969130, 2, 2, 4096, 128),
    (200, 2, 2, 4096, 32),          # no more than the rows need
    (5000, 8, 2, 4096, 64),         # cut to fit 227 KB: 128 -> 64
    (5000, 65, 17, 512, 32),        # nothing fits: read from device memory
])
def test_k2_stage_rounding(n, w, c, bn, sw):
    """K2's stage geometry (``sliced_geometry(..., "mxu_f32")``, owned by
    ``csrc/bitslice.cuh``) and the scratch layout it reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    g = ops.sliced_geometry(n, w, c, bn, "mxu_f32")
    assert g.stage_words == sw and g.stages == -(-(-(-n // 32)) // sw)
    nwp = g.padded_words
    assert nwp == g.stages * sw and nwp * 32 >= n
    assert g.heavy == g.odd == -1
    assert g.planes == (32 * w + 1) * nwp
    assert g.live == g.planes + 32 * c * nwp
    assert g.whole == g.live + c * g.stages and g.words == g.whole + c


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,c,bn", [(1, 1, 1, 512), (1000, 2, 2, 100),
                                      (4099, 5, 3, 4096), (2000, 65, 17, 512),
                                      (300, 300, 2, 512)])
def test_cuda_k2_layout_pass_matches_plain_layout(n, w, c, bn):
    """K2's layout pass equals to_item_columns / to_weight_planes /
    whole_masks bit for bit over the rows, and its pad words up to whole
    stages are zero (ones in the all-ones column)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(n + w + 1)
    tx, _, _ = random_problem(rng, n, 1, w, c)
    wts = rng.integers(-(1 << 31), 1 << 31, size=(n, c),
                       dtype=np.int64).astype(np.int32)
    t_tx, t_w = [t.to(dev) for t in _t(tx, wts)]
    got = ops.bit_slice(t_tx, t_w, block_n=bn, accum="mxu_f32")
    planes, live = to_weight_planes(t_w.cpu(), got.stage_words)
    words = -(-n // 32)
    cols = got.columns.view(torch.int32).cpu()
    assert torch.equal(cols[:, :words],
                       to_item_columns(t_tx.cpu()).view(torch.int32))
    assert not cols[:-1, words:].any() and (cols[-1, words:] == -1).all()
    pl = got.planes.view(torch.int32).cpu()
    assert torch.equal(pl[..., :words], planes.view(torch.int32))
    assert not pl[..., words:].any()
    assert torch.equal(got.live.view(torch.int32).cpu(), live.view(torch.int32))
    assert torch.equal(got.whole.view(torch.int32).cpu(),
                       whole_masks(t_w.cpu()).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,w,c,big", [(5000, 60, 3, 2, False),
                                         (3001, 50, 2, 5, True),
                                         (2000, 50, 65, 2, False)])
def test_cuda_k2_knobs_and_wide_targets(n, k, w, c, big):
    """K2 honours block_n: every block_k and block_n (1, 96, 4096 and the
    stage-rounding edges) gives the plain version's counts, also for targets
    of more than 3 items and full-range weights (all 64 planes live)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dev = torch.device("cuda")
    tx, tgt, wts, rng = _sliced_problem(n, k, w, c, "full", n + k + 1)
    if big:
        tgt[2:] = tx[:k - 2] & rng.integers(0, 2 ** 32, size=(k - 2, w),
                                             dtype=np.uint32)
    args = [t.to(dev) for t in _t(tx, tgt, wts)]
    want = itemset_counts(*args, use_kernel=False)
    for bk in (1, 32, 96, 1024):
        for bn in (1, 96, 1024, 1025, 4096):
            got = itemset_counts(*args, block_k=bk, block_n=bn,
                                 accum="mxu_f32")
            assert torch.equal(got, want), (bk, bn)
