"""The port's data pipelines (``repro_torch.data.pipeline``) against the
JAX package's: ``TokenPipeline`` batches and host slices, and
``TransactionPipeline`` blocks, byte for byte (``np.array_equal`` with
equal dtypes) for the same seeds and steps; then the JAX package's own
battery (``tests/test_data_and_specs.py:13-38``) on the port.  That a
group's rank and world size pick the slice is checked on four gloo ranks
in ``tests/test_torch_parallel.py``.
"""
import numpy as np
import pytest

from repro.data import TokenPipeline as JaxTokenPipeline
from repro.data import TransactionPipeline as JaxTransactionPipeline
from repro.data import token_stream as jax_token_stream
from repro_torch.data import (TokenPipeline, TransactionPipeline,
                              census_like_db, token_stream)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 256, 32, 4), (3, 100, 8, 8), (7, 151936, 64, 2), (11, 50280, 17, 6)])
def test_token_batches_byte_equal_to_reference(seed, vocab, seq, batch):
    got = TokenPipeline(vocab_size=vocab, seq_len=seq, global_batch=batch,
                        seed=seed)
    want = JaxTokenPipeline(vocab_size=vocab, seq_len=seq,
                            global_batch=batch, seed=seed)
    for step in (0, 1, 5, 123):
        a, b = got.batch_at(step), want.batch_at(step)
        assert list(a) == list(b) == ["tokens", "labels"]
        for k in a:
            _same(a[k], b[k])
        for pc in (1, 2):
            if batch % pc:
                continue
            for pi in range(pc):
                a = got.host_slice(step, process_index=pi, process_count=pc)
                b = want.host_slice(step, process_index=pi, process_count=pc)
                for k in a:
                    _same(a[k], b[k])


def test_iteration_and_default_slice_equal_reference():
    """Without a process group the slice is the whole batch (rank 0 of 1),
    as the JAX package's on one process."""
    got = iter(TokenPipeline(vocab_size=64, seq_len=8, global_batch=4))
    want = iter(JaxTokenPipeline(vocab_size=64, seq_len=8, global_batch=4))
    for _ in range(3):
        a, b = next(got), next(want)
        for k in a:
            _same(a[k], b[k])


def test_token_stream_equal_reference():
    _same(token_stream(1000, 300, seed=4), jax_token_stream(1000, 300, seed=4))


@pytest.mark.parametrize("index", [0, 3, 4])
def test_transaction_blocks_byte_equal_to_reference(index):
    kw = dict(n_items=40, p_x=0.2, p_y=0.1, block_rows=64, seed=1)
    b1, w1 = TransactionPipeline(**kw).block(index)
    b2, w2 = JaxTransactionPipeline(**kw).block(index)
    _same(b1, np.asarray(b2))
    _same(w1, np.asarray(w2))


# ---------------------------------------------------------------- battery
def test_token_pipeline_deterministic_and_elastic():
    pipe = TokenPipeline(vocab_size=100, seq_len=8, global_batch=8, seed=3)
    a = pipe.batch_at(5)
    b = pipe.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # host slices partition the SAME logical batch regardless of topology
    full = pipe.batch_at(7)["tokens"]
    parts = [pipe.host_slice(7, process_index=i, process_count=4)["tokens"]
             for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    # labels are next-token shifted
    raw = pipe.batch_at(0)
    assert raw["tokens"].shape == raw["labels"].shape
    np.testing.assert_array_equal(raw["tokens"][:, 1:], raw["labels"][:, :-1])
    with pytest.raises(ValueError):
        pipe.host_slice(0, process_index=0, process_count=3)


def test_transaction_pipeline_blocks_deterministic():
    pipe = TransactionPipeline(n_items=16, p_x=0.2, p_y=0.1, block_rows=64,
                               seed=1)
    b1, w1 = pipe.block(3)
    b2, w2 = pipe.block(3)
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(w1, w2)
    assert b1.shape == (64, 1) and w1.shape == (64, 2)
    b3, _ = pipe.block(4)
    assert not np.array_equal(b1, b3)


def test_census_like_schema():
    tx, y = census_like_db(200, 0.2, seed=0)
    assert len(tx) == 200 and len(set(len(t) for t in tx)) == 1
    items = {a for t in tx for a in t}
    assert len(items) <= 115
    assert 0 < y.sum() < 200
