"""The port's count server (``repro_torch.serve``) against the JAX package's
(``repro.serve``), on the same numpy-seeded inputs, with exact equality.

Three parts:

  * the JAX package's own serving battery re-run against the port
    (``tests/test_serving.py`` but its launcher test, the serving half of
    ``tests/test_spill.py``, and the count server's chooser tests of
    ``tests/test_chooser.py``), with every oracle computed by the JAX
    package: a fresh dense encode of the whole history counted by its plain
    reference;
  * side-by-side parity: the same store, server, mine and append sequence in
    both packages, counts, frequent sets, launch counters and ``stats()``
    fields equal where they mean the same thing; a store spilled by one
    package opened by the other's ``SpilledDB``; ``resolve_serve_block_k``
    on the same table;
  * the port's own contracts: the card by default, ``"cpu"`` on request, no
    fallback; ``$REPRO_TORCH_SPILL_DIR``; the refusal of ``async_flush``
    over a mesh of more than one rank.

On the CPU every count runs the plain PyTorch version; the ``cuda``-marked
tests at the end run the kernels on the card and skip here.  The mesh cases
run as gloo processes in ``tests/test_torch_serving_mesh.py``."""
import functools
import json
import os
import threading

import numpy as np
import pytest
import torch

import repro.mining as jm
import repro.serve as js
from repro.kernels.itemset_count import itemset_counts_ref as jax_counts_ref
from repro.roofline import autotune as jat
from repro_torch.core import (ItemOrder, TISTree, brute_force_counts,
                              mine_frequent)
from repro_torch.core.incremental import (IncrementalMiner, ceil_count,
                                          incremental_candidates)
from repro_torch.mining import (ItemVocab, MiningCheckpoint, SpilledDB,
                                encode_targets, extend_vocab, pad_words)
from repro_torch.mining.spill import MANIFEST_NAME
from repro_torch.roofline import autotune as at
from repro_torch.roofline import kernel_model as km
from repro_torch.serve import (CountCache, CountServer, MicroBatcher,
                               ShardedCountBackend, ShardedDB,
                               VersionedCountBackend, VersionedDB,
                               build_masks, canonical_itemset,
                               versioned_mine_frequent)
from repro_torch.serve.cache import check_cache_ledger

CPU = torch.device("cpu")
# the port's entry points default to the card; these tests ask for the host
_store = functools.partial(VersionedDB, device="cpu")
_sharded = functools.partial(ShardedDB, device="cpu")
_server = functools.partial(CountServer, device="cpu")


@pytest.fixture(autouse=True)
def _untuned():
    """Pin the port's autotuner to the compiled-in defaults (``conftest.py``
    pins the JAX package's)."""
    at.set_active_table(None)
    yield
    at.set_active_table(None)


class _Preempted(Exception):
    pass


def _db(rng, rows, items, p=0.3):
    return [[int(a) for a in range(items) if rng.random() < p]
            for _ in range(rows)]


def _fresh_counts(history, classes, n_classes, keys):
    """Oracle, by the JAX package: a fresh dense encode of the full history
    counted by its plain reference; never-seen items count 0."""
    ddb = jm.DenseDB.encode(history, classes=classes, n_classes=n_classes)
    out = np.zeros((len(keys), n_classes), np.int32)
    known = [i for i, k in enumerate(keys)
             if all(a in ddb.vocab for a in k)]
    if known:
        masks = jm.encode_targets([keys[i] for i in known], ddb.vocab)
        out[np.array(known)] = np.asarray(
            jax_counts_ref(ddb.bits, masks, ddb.weights))
    return out


def _jax_mine(tx, min_count):
    from repro.core import mine_frequent as jax_mine_frequent
    return jax_mine_frequent(tx, min_count)


# =================================================== the reference's battery
# ------------------------------------------------------------ encode helpers
def test_pad_words_and_extend_vocab():
    bits = np.array([[1, 2], [3, 4]], np.uint32)
    np.testing.assert_array_equal(pad_words(bits, 2), bits)
    wide = pad_words(bits, 4)
    assert wide.shape == (2, 4) and (wide[:, 2:] == 0).all()
    np.testing.assert_array_equal(wide[:, :2], bits)
    with pytest.raises(ValueError):
        pad_words(bits, 1)

    vocab = ItemVocab((5, 3, 1))
    same = extend_vocab([[5], [3, 1]], vocab)
    assert same is vocab                      # nothing new: same object
    ext = extend_vocab([[5, 9], [9, 7], [9]], vocab)
    assert ext.items[:3] == (5, 3, 1)         # existing columns keep positions
    assert ext.items[3:] == (9, 7)            # new items batch-frequency desc


# ------------------------------------------------------------- VersionedDB
@pytest.mark.parametrize("merge_ratio", [0.25, 1e9])
def test_versioned_db_append_exact_across_batches(merge_ratio):
    """≥2 appends (incl. unseen items), delta-kept and compacted policies:
    served counts stay bit-identical to a fresh encode of the history."""
    rng = np.random.default_rng(0)
    tx = _db(rng, 200, 10)
    y = [int(rng.random() < 0.3) for _ in tx]
    db = _store(tx, classes=y, n_classes=2, merge_ratio=merge_ratio,
                min_compact_rows=0)
    assert db.version == 0 and db.n_rows == 200
    history, classes = list(tx), list(y)
    probes = [(0, 1), (2,), (3, 7, 9), (11,), (4, 12)]  # 11, 12 unseen so far
    for step in range(1, 4):
        batch = _db(rng, 60, 10 + step)       # widens the item universe
        yb = [int(rng.random() < 0.3) for _ in batch]
        assert db.append(batch, classes=yb) == step
        history += batch
        classes += yb
        np.testing.assert_array_equal(
            db.counts(probes), _fresh_counts(history, classes, 2, probes))
    assert db.version == 3 and db.n_rows == len(history)
    if merge_ratio > 1:
        assert db.delta_rows > 0              # delta actually exercised
    else:
        assert db.n_compactions > 0
    db.compact()                              # explicit fold: counts unchanged
    assert db.delta_rows == 0 and db.version == 3
    np.testing.assert_array_equal(
        db.counts(probes), _fresh_counts(history, classes, 2, probes))


@pytest.mark.parametrize("streaming", [False, True])
def test_versioned_db_append_across_word_boundary(streaming):
    """An uncompacted append that widens the bitmap past a 32-item word
    boundary: masks are wider than the resident base, so the out-of-width
    zeroing path runs on the copied-back result."""
    rng = np.random.default_rng(9)
    tx = _db(rng, 80, 40)                     # 40 items -> W=2 words
    db = _store(tx, streaming=streaming, chunk_rows=16, merge_ratio=1e9)
    batch = [[int(a) for a in range(100, 125)] for _ in range(5)]  # W -> 3
    db.append(batch)
    assert db.vocab.n_words == 3
    assert int(db.base.bits.shape[1]) == 2    # base left narrow
    probes = [(0, 1), (104,), (0, 104), (39,)]
    np.testing.assert_array_equal(
        db.counts(probes), _fresh_counts(tx + batch, None, 1, probes))


def test_versioned_db_empty_append_and_unknown_targets():
    rng = np.random.default_rng(1)
    tx = _db(rng, 50, 6)
    db = _store(tx)
    assert db.append([]) == 0                 # no-op: no count can change
    got = db.counts([("never-seen",), (0, "never-seen")])
    np.testing.assert_array_equal(got, np.zeros((2, 1), np.int32))


def test_versioned_db_failed_compaction_preserves_delta(monkeypatch):
    """compact() must not drop the delta when building the new base fails:
    composed counts stay exact after the failure."""
    rng = np.random.default_rng(14)
    tx = _db(rng, 100, 8)
    db = _store(tx, merge_ratio=1e9)
    db.append(_db(rng, 30, 8))
    assert db.delta_rows > 0
    probes = [(0,), (1, 2)]
    want = db.counts(probes)
    monkeypatch.setattr(db, "_make_base",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device OOM")))
    with pytest.raises(RuntimeError, match="OOM"):
        db.compact()
    monkeypatch.undo()
    assert db.delta_rows > 0                  # delta NOT lost
    np.testing.assert_array_equal(db.counts(probes), want)
    db.compact()                              # and a healthy retry works
    assert db.delta_rows == 0
    np.testing.assert_array_equal(db.counts(probes), want)


def test_versioned_db_streaming_resident():
    rng = np.random.default_rng(2)
    tx = _db(rng, 150, 8)
    dense = _store(tx)
    stream = _store(tx, streaming=True, chunk_rows=16)
    # explicit chunk_rows opts into streaming, like the mining stack
    assert _store(tx, chunk_rows=16).resident == "streaming"
    assert _store(tx, streaming=False, chunk_rows=16).resident == "dense"
    assert dense.resident == "dense" and stream.resident == "streaming"
    probes = [(0,), (1, 2), (3, 4, 5)]
    np.testing.assert_array_equal(dense.counts(probes), stream.counts(probes))
    # appends keep the streaming base exact too
    batch = _db(rng, 40, 8)
    dense.append(batch)
    stream.append(batch)
    np.testing.assert_array_equal(dense.counts(probes), stream.counts(probes))
    assert stream.resident == "streaming"


def test_versioned_db_multiclass_requires_classes():
    """Classless rows on a multi-class store would count once PER class
    column — must be rejected, mirroring DenseDB.encode's classes=None ⇒ C=1."""
    rng = np.random.default_rng(10)
    tx = _db(rng, 30, 6)
    y = [int(rng.random() < 0.5) for _ in tx]
    db = _store(tx, classes=y, n_classes=2)
    vocab_before = db.vocab
    with pytest.raises(ValueError, match="classes"):
        db.append([[0, 1, "new-item"]])
    with pytest.raises(ValueError, match="classes"):
        _store(tx, n_classes=2)
    # rejected append leaves NO trace: no version bump, no vocab tail
    assert db.version == 0
    assert db.vocab is vocab_before and "new-item" not in db.vocab
    # single-class stores still take classless appends
    db1 = _store(tx)
    db1.append([[0, 1]])
    assert int(db1.counts([(0, 1)])[0].sum()) == \
        sum(1 for t in tx + [[0, 1]] if {0, 1} <= set(t))


def test_versioned_db_append_overflow_guard():
    db = _store([[0]], vocab=ItemVocab((0,)))
    db._class_totals[:] = np.iinfo(np.int32).max - 1
    with pytest.raises(OverflowError):
        db.append([[0], [0]])
    # same guard at construction (counts would wrap on the dense path)
    with pytest.raises(OverflowError):
        VersionedDB._guard_totals(np.array([1 << 31], np.int64))


# ------------------------------------------------------------------ batcher
def test_canonical_itemset():
    assert canonical_itemset((3, 1, 3, 2)) == (1, 2, 3)
    assert canonical_itemset((1, 2)) == canonical_itemset([2, 1])


def test_batcher_cross_client_dedup_and_scatter():
    b = MicroBatcher(block_k=8)
    t1 = b.submit("a", [(2, 1), (5,), (1, 2)])  # (1,2) twice within request
    t2 = b.submit("b", [(1, 2), (7,)])          # and again across clients
    assert b.pending == 2
    plan = b.take()
    assert b.pending == 0
    assert plan.unique_keys == [(1, 2), (5,), (7,)]
    assert plan.n_queries == 5
    assert b.n_deduped == 2
    assert [r.request_id for r in plan.requests] == [t1, t2]
    assert plan.requests[0].keys == [(1, 2), (5,), (1, 2)]
    assert plan.rows[(1, 2)] == 0 and plan.rows[(7,)] == 2


def test_build_masks_padding_and_unknown():
    vocab = ItemVocab(tuple(range(40)))       # W = 2 words
    keys = [(0, 39), (3,), ("nope",)]
    masks, known = build_masks(keys, vocab, block_k=8)
    assert masks.shape == (8, 2)              # padded to the block_k multiple
    assert known.tolist() == [True, True, False]
    np.testing.assert_array_equal(masks[2], 0)    # unknown -> zero mask
    np.testing.assert_array_equal(masks[3:], 0)   # padding rows
    want = encode_targets([(0, 39), (3,)], vocab)
    np.testing.assert_array_equal(masks[:2], want)
    # and the JAX package's planner builds the same block
    jmasks, jknown = js.build_masks(keys, jm.ItemVocab(tuple(range(40))),
                                    block_k=8)
    np.testing.assert_array_equal(masks, jmasks)
    np.testing.assert_array_equal(known, jknown)
    big, known = build_masks([(i,) for i in range(9)], vocab, block_k=8)
    assert big.shape == (16, 2) and known.all()


# -------------------------------------------------------------------- cache
def test_cache_hit_miss_lru_and_purge():
    c = CountCache(capacity=2)
    assert c.get((1,), 0) is None and c.misses == 1
    c.put((1,), 0, np.array([3, 4]))
    hit = c.get((1,), 0)
    np.testing.assert_array_equal(hit, [3, 4])
    assert c.hits == 1
    hit[0] = 99                               # defensive copy: cache unharmed
    np.testing.assert_array_equal(c.get((1,), 0), [3, 4])
    assert c.get((1,), 1) is None             # other version: miss
    c.put((2,), 0, np.array([1, 1]))
    c.get((1,), 0)                            # (1,) now most-recent
    c.put((3,), 1, np.array([2, 2]))          # evicts LRU (2,)
    assert c.evictions == 1
    assert c.get((2,), 0) is None
    assert c.get((1,), 0) is not None
    assert c.purge_stale(current_version=1) == 1   # drops ((1,), 0)
    assert len(c) == 1 and c.get((3,), 1) is not None


def test_append_survives_compaction_failure():
    """Compaction is an optimization: if it dies, the append stays committed
    and the store keeps serving exact composed base+delta counts (an escaping
    error would look like a rejected batch and invite a double-count retry)."""
    rng = np.random.default_rng(55)
    tx = _db(rng, 80, 8)
    store = _store(tx, merge_ratio=0.01,      # any append triggers compact
                   min_compact_rows=0)

    def boom():
        raise MemoryError("simulated compactor OOM")

    store.compact = boom
    extra = _db(rng, 40, 8)
    v = store.append(extra)                     # must NOT raise
    assert v == 1 and store.delta_rows > 0
    assert store.stats()["failed_compactions"] == 1
    probes = [(0,), (1, 2)]
    np.testing.assert_array_equal(
        store.counts(probes), _fresh_counts(tx + extra, None, 1, probes))


def test_cache_byte_budget_eviction_and_stats():
    row = np.arange(4, dtype=np.int32)        # 16 bytes per entry
    c = CountCache(capacity=1000, max_bytes=3 * row.nbytes)
    for i in range(3):
        c.put((i,), 0, row)
    assert len(c) == 3 and c.nbytes == 3 * row.nbytes
    assert c.stats()["bytes"] == 3 * row.nbytes
    assert c.stats()["max_bytes"] == 3 * row.nbytes
    c.get((0,), 0)                            # (0,) now most-recent
    c.put((3,), 0, row)                       # over budget: evicts LRU (1,)
    assert len(c) == 3 and c.evictions == 1
    assert c.get((1,), 0) is None and c.get((0,), 0) is not None
    # replacing an entry re-accounts its bytes instead of double-counting
    c.put((0,), 0, row)
    assert c.nbytes == 3 * row.nbytes
    # purge updates the byte ledger too
    c.put((9,), 1, row)
    c.purge_stale(current_version=1)
    assert len(c) == 1 and c.nbytes == row.nbytes
    # the full shared invariants (byte recount, inserts-evictions-purged ==
    # size, budgets) — populated out-of-band, so not miss_driven
    check_cache_ledger(c)
    # an entry bigger than the whole budget cannot be admitted
    tight = CountCache(capacity=10, max_bytes=8)
    tight.put((1,), 0, row)
    assert len(tight) == 0 and tight.nbytes == 0
    assert check_cache_ledger(tight)["oversized_rejects"] == 1
    with pytest.raises(ValueError):
        CountCache(capacity=10, max_bytes=0)


def test_server_cache_bytes_budget():
    rng = np.random.default_rng(33)
    tx = _db(rng, 100, 10)
    srv = _server(tx, cache_bytes=4 * 4)      # room for four 1-class rows
    srv.query([(i,) for i in range(8)])
    assert len(srv.cache) == 4                # LRU kept only the budget
    assert srv.cache.nbytes <= 16
    assert srv.stats()["cache"]["bytes"] <= 16
    # serving follows get-miss-compute-put, so the full miss-driven ledger
    # identities hold on top of the budget checks
    assert check_cache_ledger(srv.cache, miss_driven=True)["evictions"] == 4
    # still exact: evicted probes recount on the engine
    np.testing.assert_array_equal(
        srv.query([(0,)]), _fresh_counts(tx, None, 1, [(0,)]))


def test_cache_invalidation_after_append_serves_fresh_counts():
    rng = np.random.default_rng(3)
    tx = _db(rng, 120, 8)
    srv = _server(tx)
    probes = [(0,), (1, 2)]
    before = srv.query(probes)
    launches = srv.store.kernel_launches
    again = srv.query(probes)                 # pure cache: no device work
    np.testing.assert_array_equal(again, before)
    assert srv.store.kernel_launches == launches
    assert srv.cache.hits == len(probes)

    batch = [[0, 1, 2]] * 10                  # changes every probe's count
    srv.append(batch)
    assert len(srv.cache) == 0                # stale entries purged eagerly
    after = srv.query(probes)                 # version bump: cache missed
    assert srv.store.kernel_launches > launches
    np.testing.assert_array_equal(
        after, _fresh_counts(tx + batch, None, 1, probes))
    assert (after != before).any()


# -------------------------------------------------------------- CountServer
def test_server_cross_client_dedup_bit_identical():
    """Acceptance: deduped cross-client answers == a direct count."""
    rng = np.random.default_rng(4)
    tx = _db(rng, 180, 12)
    y = [int(rng.random() < 0.4) for _ in tx]
    srv = _server(tx, classes=y, cache=False, block_k=8)
    t1 = srv.submit("a", [(0, 1), (2,), (1, 0)])
    t2 = srv.submit("b", [(0, 1), (5, 6, 7)])
    launches0 = srv.store.kernel_launches
    res = srv.flush()
    assert srv.store.kernel_launches == launches0 + 1   # ONE composed pass
    want = _fresh_counts(tx, y, 2, [(0, 1), (2,), (5, 6, 7)])
    np.testing.assert_array_equal(res[t1], want[[0, 1, 0]])
    np.testing.assert_array_equal(res[t2], want[[0, 2]])
    assert res[t1].dtype == np.int32


@pytest.mark.parametrize("streaming", [False, True])
def test_server_exact_vs_dense_gfp_counts_after_appends(streaming):
    """Acceptance: served counts == dense_gfp_counts at the same version,
    after ≥2 append batches, with the cache enabled."""
    from repro_torch.mining import DenseDB, dense_gfp_counts

    rng = np.random.default_rng(5)
    tx = _db(rng, 150, 10)
    y = [int(rng.random() < 0.3) for _ in tx]
    srv = _server(tx, classes=y, streaming=streaming, chunk_rows=32,
                  merge_ratio=1e9)            # keep the delta segment live
    history, classes = list(tx), list(y)
    queries = [(0, 1), (2,), (4, 5, 6), (9,), (3, 8)]
    for step in range(2):
        batch = _db(rng, 50, 10)
        yb = [int(rng.random() < 0.3) for _ in batch]
        srv.append(batch, classes=yb)
        history += batch
        classes += yb
        srv.query(queries)                    # populate the cache mid-history
    assert srv.store.version == 2 and srv.store.delta_rows > 0
    got = srv.query(queries)                  # served (partly) from cache

    counts = {a: sum(1 for t in history if a in t) for a in range(10)}
    tis = TISTree(ItemOrder.from_counts(counts))
    for q in queries:
        tis.insert(list(q), target=True)
    want = dense_gfp_counts(tis, DenseDB.encode(history, classes=classes,
                                                n_classes=2, device=CPU))
    for i, q in enumerate(queries):
        np.testing.assert_array_equal(got[i], want[canonical_itemset(q)])
    oracle = brute_force_counts(history, queries)
    assert all(int(got[i].sum()) == oracle[canonical_itemset(q)]
               for i, q in enumerate(queries))
    np.testing.assert_array_equal(
        got, _fresh_counts(history, classes, 2, queries))


def test_server_interleaved_query_leaves_pending_requests_queued():
    """A query() between another client's submit() and flush() must neither
    orphan that client's ticket nor freeze its counts at an older version:
    the pending request stays queued and is answered at flush-time state."""
    rng = np.random.default_rng(11)
    tx = _db(rng, 90, 8)
    srv = _server(tx)
    ticket = srv.submit("a", [(0, 1), (2,)])
    got_q = srv.query([(3,)])                 # must NOT drain the batcher
    np.testing.assert_array_equal(got_q, _fresh_counts(tx, None, 1, [(3,)]))
    assert srv.batcher.pending == 1
    batch = [[0, 1, 2]] * 5
    srv.append(batch)                         # version bump BEFORE a's flush
    res = srv.flush()                         # a gets flush-time (v1) counts
    np.testing.assert_array_equal(
        res[ticket], _fresh_counts(tx + batch, None, 1, [(0, 1), (2,)]))
    assert srv.flush() == {}                  # delivered exactly once


def test_server_failed_flush_is_retryable(monkeypatch):
    """A counting-pass failure must not orphan drained tickets: the plan is
    restored to the batcher and a retried flush answers them."""
    rng = np.random.default_rng(12)
    tx = _db(rng, 60, 6)
    srv = _server(tx, cache=False)
    ticket = srv.submit("a", [(0, 1)])
    monkeypatch.setattr(srv.store, "counts_masks",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device lost")))
    with pytest.raises(RuntimeError, match="device lost"):
        srv.flush()
    assert srv.batcher.pending == 1           # request re-queued
    monkeypatch.undo()
    res = srv.flush()
    np.testing.assert_array_equal(
        res[ticket], _fresh_counts(tx, None, 1, [(0, 1)]))


def test_server_no_cache_and_empty_flush():
    rng = np.random.default_rng(6)
    srv = _server(_db(rng, 40, 6), cache=False)
    assert srv.cache is None
    assert srv.flush() == {}
    t = srv.submit("a", [])
    assert srv.flush()[t].shape == (0, 1)


# ---------------------------------------------- incremental mining satellite
def test_incremental_candidates_partition_and_completeness():
    prev = [(1,), (2,), (1, 2)]
    inc = [(2,), (3,), (2, 3)]
    previously, newly = incremental_candidates(prev, inc)
    assert previously == sorted(prev, key=repr)
    assert newly == [(2, 3), (3,)]            # repr-sorted, prev excluded
    assert not (set(previously) & set(newly))
    assert set(previously) | set(newly) == set(prev) | set(inc)
    assert incremental_candidates([], []) == ([], [])


def test_incremental_miner_state_lifecycle():
    m = IncrementalMiner(0.1)
    assert m.state is None
    with pytest.raises(RuntimeError, match="fit"):
        m.update([[1, 2]])
    with pytest.raises(RuntimeError, match="fit"):
        m.frequent
    with pytest.raises(RuntimeError, match="fit"):
        m.n_seen
    m.fit([[1, 2], [1], [2]])
    assert m.n_seen == 3
    assert m.frequent == m.state.frequent
    with pytest.raises(ValueError):
        IncrementalMiner(0.0)


def test_incremental_parity_host_vs_engine_recount():
    """Host IncrementalMiner (guided FP-tree recounts) == the port's
    CountServer engine-backed recount, across several append batches."""
    rng = np.random.default_rng(7)
    theta = 0.08
    tx = _db(rng, 250, 12, p=0.25)
    miner = IncrementalMiner(theta)
    srv = _server(tx, merge_ratio=1e9)        # delta path must stay exact too
    assert miner.fit(tx) == srv.mine(theta)
    for step in range(3):
        batch = _db(rng, 80, 12 + 2 * step, p=0.25)  # new items mid-stream
        want = miner.update(batch)
        srv.append(batch)
        assert srv.frequent == want, step
    history = miner._require_state()          # sanity: state present
    assert history.n == srv.store.n_rows


def test_versioned_mine_frequent_matches_engines():
    from repro_torch.mining import DenseDB, dense_mine_frequent

    rng = np.random.default_rng(8)
    tx = _db(rng, 200, 9, p=0.35)
    want = mine_frequent(tx, 40)
    assert want == _jax_mine(tx, 40)
    store = _store(tx)
    assert versioned_mine_frequent(store, 40) == want
    assert dense_mine_frequent(DenseDB.encode(tx, device=CPU), 40) == want
    # still exact with an uncompacted delta in play
    store2 = _store(tx[:150], merge_ratio=1e9)
    store2.append(tx[150:])
    assert store2.delta_rows > 0
    assert versioned_mine_frequent(store2, 40) == want


def test_server_frequent_requires_mine():
    srv = _server([[1, 2]])
    with pytest.raises(RuntimeError, match="mine"):
        srv.frequent
    with pytest.raises(ValueError):
        srv.mine(0.0)


def test_server_mining_failures_disarm_incremental_maintenance(monkeypatch):
    """A failed mine() must not arm incremental maintenance, and a failed
    refresh during append() must disarm it: §5.2 completeness requires the
    previous EXACT frequent set, so stale baselines raise instead of serve."""
    import repro_torch.serve.service as service_mod
    from repro_torch.serve import MiningRefreshError

    rng = np.random.default_rng(13)
    tx = _db(rng, 80, 6)
    srv = _server(tx)
    monkeypatch.setattr(service_mod, "versioned_mine_frequent",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device lost")))
    with pytest.raises(RuntimeError, match="device lost"):
        srv.mine(0.1)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="mine"):
        srv.frequent                          # mine never succeeded
    srv.append([[0, 1]])                      # and appends don't refresh

    want = srv.mine(0.1)
    assert srv.frequent == want
    monkeypatch.setattr(srv.store, "counts",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device lost")))
    with pytest.raises(MiningRefreshError, match="do not retry") as ei:
        srv.append([[0, 1, 2]] * 5)
    monkeypatch.undo()
    assert ei.value.version == srv.store.version  # batch WAS committed
    with pytest.raises(RuntimeError, match="mine"):
        srv.frequent                          # stale baseline disarmed


# ------------------------------------------------- serving-path bug sweep
def test_cache_oversized_put_rejected_without_eviction():
    """A put larger than max_bytes is rejected up front, counted separately,
    and evicts nothing."""
    row = np.arange(4, dtype=np.int32)            # 16 bytes
    c = CountCache(capacity=10, max_bytes=4 * row.nbytes)
    for i in range(4):
        c.put((i,), 0, row)
    big = np.arange(64, dtype=np.int32)           # 256 bytes > budget
    c.put((99,), 0, big)
    assert len(c) == 4 and c.nbytes == 4 * row.nbytes   # warm set intact
    assert c.evictions == 0
    assert c.oversized_rejects == 1
    assert c.stats()["oversized_rejects"] == 1
    assert c.get((99,), 0) is None                # never admitted
    for i in range(4):                            # every resident row hits
        assert c.get((i,), 0) is not None
    # replacing a resident key with an oversized value keeps the (still
    # correct: same key+version = same counts) resident entry
    c.put((0,), 0, big)
    assert c.get((0,), 0) is not None and c.oversized_rejects == 2


def test_batcher_restore_rolls_back_dedup_stats():
    """A failed flush's restore() rolls back take()'s n_deduped increments,
    so the re-take counts every dedup once."""
    b = MicroBatcher(block_k=8)
    b.submit("a", [(1, 2), (2, 1), (3,)])         # (2,1) dedups onto (1,2)
    b.submit("b", [(1, 2)])                       # cross-client dedup
    plan = b.take()
    assert b.n_deduped == 2
    b.restore(plan.requests)
    assert b.n_deduped == 0                       # rolled back exactly
    b.take()
    assert b.n_deduped == 2                       # retry counts once, not 4
    assert b.stats()["requests"] == 2 and b.stats()["queries"] == 4


def test_server_retried_flush_reports_exact_dedup_stats(monkeypatch):
    rng = np.random.default_rng(20)
    srv = _server(_db(rng, 60, 6), cache=False)
    srv.submit("a", [(0, 1), (1, 0)])             # one in-request dedup
    srv.submit("b", [(0, 1)])                     # one cross-client dedup
    monkeypatch.setattr(srv.store, "counts_masks",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device lost")))
    with pytest.raises(RuntimeError, match="device lost"):
        srv.flush()
    assert srv.batcher.stats()["deduped"] == 0    # failed take rolled back
    monkeypatch.undo()
    srv.flush()
    assert srv.batcher.stats()["deduped"] == 2    # exact after the retry


def test_store_class_label_validation_no_trace():
    """Out-of-range labels raise the documented no-trace ValueError at the
    store boundary, for construction AND append."""
    rng = np.random.default_rng(21)
    tx = _db(rng, 40, 6)
    with pytest.raises(ValueError, match="negative"):
        _store(tx, classes=[-1] * len(tx))
    with pytest.raises(ValueError, match="out of range"):
        _store(tx, classes=[3] * len(tx), n_classes=2)
    with pytest.raises(ValueError, match="n_classes"):
        _store(tx, classes=[0] * len(tx), n_classes=-2)
    with pytest.raises(ValueError, match="integer"):
        _store(tx, classes=[0.5] * len(tx), n_classes=2)

    y = [int(rng.random() < 0.5) for _ in tx]
    db = _store(tx, classes=y, n_classes=2)
    vocab_before, totals_before = db.vocab, db._class_totals.copy()
    for bad in ([-1], [2], [0.5]):
        with pytest.raises(ValueError):
            db.append([[0, "new-item"]], classes=bad)
    assert db.version == 0 and db.n_rows == len(tx)
    assert db.vocab is vocab_before and "new-item" not in db.vocab
    np.testing.assert_array_equal(db._class_totals, totals_before)
    assert db.delta_rows == 0                     # no delta segment appeared

    # the sharded store rejects with no trace on ANY shard either
    sh = _sharded(tx, classes=y, n_classes=2, n_shards=2)
    with pytest.raises(ValueError):
        sh.append([[0, "new-item"]], classes=[5])
    assert sh.version == 0 and "new-item" not in sh.vocab
    assert all(s.version == 0 for s in sh.shards)
    with pytest.raises(ValueError, match="length"):
        _sharded(tx, classes=y + [3], n_shards=2)
    with pytest.raises(ValueError, match="length"):
        _sharded(tx, classes=y[:-1], n_shards=2)
    with pytest.raises(ValueError, match="length"):
        sh.append([[0], [1]], classes=[0])


def test_empty_store_chunk_accounting_and_kill_resume(tmp_path):
    """An empty store claims a 1-chunk grid and its (trivially exact) sweep
    completes that chunk, so a checkpointed mine records its progress."""
    store = _store(vocab=ItemVocab((0, 1, 2)))
    backend = VersionedCountBackend(store)
    assert backend.n_count_chunks == 1
    fired = []
    got = backend.counts(np.zeros((2, 1), np.uint32),
                         on_chunk=lambda i, acc: fired.append(i))
    assert fired == [0]                           # grid and progress agree
    np.testing.assert_array_equal(got, 0)

    ckpt = MiningCheckpoint(str(tmp_path / "empty.json"))

    def die(level, chunk):
        raise _Preempted()

    with pytest.raises(_Preempted):
        versioned_mine_frequent(store, 1, checkpoint=ckpt, on_chunk=die)
    state = json.load(open(str(tmp_path / "empty.json")))
    assert state["partial"]["next_chunk"] == 1    # == n_count_chunks
    resumed = []
    got = versioned_mine_frequent(store, 1, checkpoint=ckpt,
                                  on_chunk=lambda l, c: resumed.append((l, c)))
    assert got == {} and resumed == []            # level 1 resumed, no recount


# ------------------------------------------------------------ sharded store
def test_sharded_vs_single_device_parity_interleaved():
    """Sharded counts bit-identical to the single-device VersionedDB at
    EVERY version across ≥3 interleaved append/flush rounds (vocab-widening
    batches, live deltas, unknown-item probes)."""
    rng = np.random.default_rng(30)
    tx = _db(rng, 180, 10)
    y = [int(rng.random() < 0.4) for _ in tx]
    single = _store(tx, classes=y, n_classes=2, merge_ratio=1e9)
    sharded = _sharded(tx, classes=y, n_classes=2, n_shards=3,
                       merge_ratio=1e9)
    assert sharded.n_rows == single.n_rows == len(tx)
    probes = [(0, 1), (2,), (3, 7, 9), (11,), ("nope",), (0, 12)]
    np.testing.assert_array_equal(single.counts(probes),
                                  sharded.counts(probes))
    history, classes = list(tx), list(y)
    for step in range(1, 4):
        batch = _db(rng, 50, 10 + step)           # widens the item universe
        yb = [int(rng.random() < 0.4) for _ in batch]
        assert single.append(batch, classes=yb) == step
        assert sharded.append(batch, classes=yb) == step
        history += batch
        classes += yb
        got = sharded.counts(probes)
        np.testing.assert_array_equal(got, single.counts(probes))
        np.testing.assert_array_equal(
            got, _fresh_counts(history, classes, 2, probes))
    assert sharded.delta_rows > 0                 # deltas genuinely in play
    assert max(s.n_rows for s in sharded.shards) \
        - min(s.n_rows for s in sharded.shards) <= len(batch)
    sharded.compact()                             # counts unchanged
    assert sharded.delta_rows == 0 and sharded.version == 3
    np.testing.assert_array_equal(sharded.counts(probes),
                                  single.counts(probes))
    with pytest.raises(ValueError):
        _sharded(tx, n_shards=0)


def test_sharded_append_routes_to_least_loaded_shard():
    rng = np.random.default_rng(31)
    sh = _sharded(_db(rng, 90, 8), n_shards=3)
    rows_before = [s.n_rows for s in sh.shards]
    target = min(range(3), key=lambda i: rows_before[i])
    sh.append(_db(rng, 10, 8))
    rows_after = [s.n_rows for s in sh.shards]
    assert rows_after[target] == rows_before[target] + 10
    assert sum(rows_after) == sum(rows_before) + 10


def test_sharded_mine_parity_kill_resume_and_stale_version(tmp_path):
    rng = np.random.default_rng(32)
    tx = _db(rng, 240, 10, p=0.4)
    store = _sharded(tx, n_shards=3)
    backend = ShardedCountBackend(store)
    assert backend.n_count_chunks == 3            # one chunk per shard
    want = mine_frequent(tx, 40)
    assert versioned_mine_frequent(store, 40) == want

    ckpt = MiningCheckpoint(str(tmp_path / "sharded.json"))

    def die_mid_level_2(level, chunk):
        if level == 2 and chunk == 1:
            raise _Preempted()                    # mid shard sweep

    with pytest.raises(_Preempted):
        versioned_mine_frequent(store, 40, checkpoint=ckpt,
                                on_chunk=die_mid_level_2)
    state = json.load(open(str(tmp_path / "sharded.json")))
    assert state["partial"]["level"] == 2
    assert state["partial"]["next_chunk"] == 2
    assert state["partial"]["n_shards"] == 3      # shard grid in signature
    assert state["meta"] == {"version": 0, "n_shards": 3,
                             "min_count": 40.0, "class_column": None,
                             "max_len": 0}

    resumed = []
    got = versioned_mine_frequent(
        store, 40, checkpoint=ckpt,
        on_chunk=lambda l, c: resumed.append((l, c)))
    assert got == want
    assert resumed[0] == (2, 2)                   # resumed at shard chunk 2

    extra = _db(rng, 100, 10, p=0.6)              # denser: counts shift
    store.append(extra)
    got = versioned_mine_frequent(store, 40, checkpoint=ckpt)
    assert got == mine_frequent(tx + extra, 40)   # stale checkpoint discarded


def test_sharded_server_end_to_end():
    """CountServer(shards=): submit/flush/query/append/mine/frequent all run
    unchanged over the sharded store, exactly."""
    rng = np.random.default_rng(33)
    tx = _db(rng, 200, 10, p=0.3)
    y = [int(rng.random() < 0.4) for _ in tx]
    srv = _server(tx, classes=y, shards=2, block_k=8)
    plain = _server(tx, classes=y, block_k=8)
    t1 = srv.submit("a", [(0, 1), (2,), (1, 0)])
    res = srv.flush()
    want = plain.query([(0, 1), (2,), (1, 0)])
    np.testing.assert_array_equal(res[t1], want)

    theta = 0.12
    assert srv.mine(theta) == plain.mine(theta)
    batch = _db(rng, 60, 12, p=0.3)
    yb = [int(rng.random() < 0.4) for _ in batch]
    srv.append(batch, classes=yb)
    plain.append(batch, classes=yb)
    assert srv.frequent == plain.frequent         # §5.2 maintenance parity
    np.testing.assert_array_equal(srv.query([(0, 1), (11,)]),
                                  plain.query([(0, 1), (11,)]))
    with pytest.raises(ValueError, match="shards"):
        _server(tx, mesh=object())


# ------------------------------------------------------------- async flush
def test_async_occupancy_and_deadline_triggers():
    rng = np.random.default_rng(40)
    tx = _db(rng, 80, 8)
    srv = _server(tx, async_flush=True, max_delay_ms=40, min_batch=4)
    try:
        futs = [srv.submit_async(f"c{i}", [(0, 1), (2,)]) for i in range(4)]
        results = [f.result(timeout=15) for f in futs]   # occupancy fires
        want = _fresh_counts(tx, None, 1, [(0, 1), (2,)])
        for got in results:
            np.testing.assert_array_equal(got, want)
        lone = srv.submit_async("lone", [(3,)])          # below min_batch
        np.testing.assert_array_equal(lone.result(timeout=15),
                                      _fresh_counts(tx, None, 1, [(3,)]))
        st = srv.stats()["async"]
        assert st["flushes"] >= 2 and st["pending_tickets"] == 0
        assert st["by_trigger"]["deadline"] >= 1         # the lone ticket
    finally:
        srv.close()
    assert srv.stats()["async"]["closed"]
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit_async("late", [(0,)])
    # the server stays usable synchronously after close
    np.testing.assert_array_equal(srv.query([(3,)]),
                                  _fresh_counts(tx, None, 1, [(3,)]))


def test_async_close_drains_pending_tickets():
    """close() never orphans a submitted ticket — triggers that would never
    fire (huge min_batch, long deadline) still get answered by the drain."""
    rng = np.random.default_rng(41)
    tx = _db(rng, 60, 6)
    srv = _server(tx, async_flush=True, max_delay_ms=60_000,
                  min_batch=10_000)
    futs = [srv.submit_async(f"c{i}", [(0,), (1, 2)]) for i in range(3)]
    assert not any(f.done() for f in futs)
    srv.close()
    want = _fresh_counts(tx, None, 1, [(0,), (1, 2)])
    for f in futs:
        assert f.done()
        np.testing.assert_array_equal(f.result(timeout=1), want)
    assert srv.stats()["async"]["by_trigger"]["drain"] == 1


def test_async_failed_flush_retries_then_answers():
    rng = np.random.default_rng(42)
    tx = _db(rng, 60, 6)
    srv = _server(tx, cache=False, async_flush=True, max_delay_ms=30,
                  min_batch=1)
    calls = {"n": 0}
    orig = srv.store.counts_masks

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device loss")
        return orig(*a, **k)

    srv.store.counts_masks = flaky
    try:
        fut = srv.submit_async("a", [(0, 1)])
        np.testing.assert_array_equal(fut.result(timeout=15),
                                      _fresh_counts(tx, None, 1, [(0, 1)]))
        assert srv.stats()["async"]["flush_errors"] >= 1
    finally:
        srv.close()


def test_async_close_with_failing_store_raises_on_futures():
    rng = np.random.default_rng(43)
    tx = _db(rng, 40, 6)
    srv = _server(tx, cache=False, async_flush=True, max_delay_ms=60_000,
                  min_batch=10_000)
    srv.store.counts_masks = \
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("dead device"))
    fut = srv.submit_async("a", [(0,)])
    with pytest.raises(RuntimeError, match="dead device"):
        srv.close()
    assert fut.done()
    with pytest.raises(RuntimeError, match="dead device"):
        fut.result(timeout=1)


def test_async_background_flush_preserves_sync_tickets():
    """A synchronously submitted ticket drained by a BACKGROUND flush does
    not vanish — the next explicit flush() hands it back."""
    rng = np.random.default_rng(44)
    tx = _db(rng, 60, 6)
    srv = _server(tx, async_flush=True, max_delay_ms=20, min_batch=2)
    try:
        t = srv.submit("sync", [(0, 1)])          # plain sync ticket
        fut = srv.submit_async("async", [(2,)])   # fills min_batch: bg flush
        fut.result(timeout=15)                    # ... drained BOTH tickets
        assert srv.stats()["async"]["unclaimed_sync_tickets"] == 1
        out = srv.flush()                         # sync ticket handed back
        np.testing.assert_array_equal(
            out[t], _fresh_counts(tx, None, 1, [(0, 1)]))
        assert srv.stats()["async"]["unclaimed_sync_tickets"] == 0
    finally:
        srv.close()


def test_async_future_result_is_a_private_copy():
    """A manual flush() answering an async ticket returns the block to its
    own caller too — the future must hold an independent copy."""
    rng = np.random.default_rng(45)
    tx = _db(rng, 50, 6)
    srv = _server(tx, async_flush=True, max_delay_ms=60_000,
                  min_batch=10_000)
    try:
        fut = srv.submit_async("a", [(0, 1)])
        out = srv.flush()                     # manual flush answers it
        out[fut.ticket][:] = -7               # flush caller mutates its rows
        np.testing.assert_array_equal(fut.result(timeout=1),
                                      _fresh_counts(tx, None, 1, [(0, 1)]))
    finally:
        srv.close()


def test_submit_async_requires_async_flush():
    srv = _server([[1, 2]])
    with pytest.raises(RuntimeError, match="async_flush"):
        srv.submit_async("a", [(1,)])


# ---------------------------------- the serving half of tests/test_spill.py
def test_versioned_db_spilled_residency_and_gen_cleanup(tmp_path):
    rng = np.random.default_rng(12)
    tx = _db(rng, 200, 10)
    y = [int(rng.random() < 0.3) for _ in tx]
    db = _store(tx, classes=y, n_classes=2, spill=True,
                spill_dir=str(tmp_path), chunk_rows=32,
                merge_ratio=1e9)     # keep the delta resident
    assert db.resident == "spilled"
    st_ = db.stats()
    assert st_["resident"] == "spilled"
    assert st_["spill"]["segments"] == db.base.n_chunks >= 2
    assert st_["spill"]["chunk_rows"] == 32
    assert db.base.device == CPU
    history, classes = list(tx), list(y)
    probes = [(0, 1), (2,), (3, 7, 9), (11,)]
    np.testing.assert_array_equal(db.counts(probes),
                                  _fresh_counts(history, classes, 2, probes))

    batch = _db(rng, 40, 12)
    yb = [int(rng.random() < 0.3) for _ in batch]
    db.append(batch, classes=yb)
    history += batch
    classes += yb
    assert db.delta_rows > 0                 # composed base+delta sweep
    np.testing.assert_array_equal(db.counts(probes),
                                  _fresh_counts(history, classes, 2, probes))

    old_dir = db.base.directory
    db.compact()                             # fold: new gen dir, old deleted
    assert db.resident == "spilled" and db.delta_rows == 0
    assert db.base.directory != old_dir
    assert not os.path.exists(old_dir)       # replaced gen cleaned up
    assert os.path.exists(os.path.join(db.base.directory, MANIFEST_NAME))
    np.testing.assert_array_equal(db.counts(probes),
                                  _fresh_counts(history, classes, 2, probes))


def test_versioned_db_auto_spill_threshold(tmp_path):
    rng = np.random.default_rng(13)
    tx = _db(rng, 150, 10)
    db = _store(tx, spill_dir=str(tmp_path), spill_threshold_bytes=64,
                chunk_rows=32)
    assert db.resident == "spilled"          # footprint > 64-byte budget
    probes = [(0,), (1, 2), (4, 5, 6)]
    np.testing.assert_array_equal(
        db.counts(probes), _fresh_counts(tx, None, 1, probes))
    # under-budget store stays in host RAM
    small = _store(tx[:5], spill_dir=str(tmp_path / "small"),
                   spill_threshold_bytes=1 << 30)
    assert small.resident != "spilled"


def test_versioned_mine_over_spilled_base(tmp_path):
    rng = np.random.default_rng(14)
    tx = _db(rng, 200, 10, p=0.4)
    db = _store(tx, spill=True, spill_dir=str(tmp_path), chunk_rows=32)
    assert db.resident == "spilled"
    assert versioned_mine_frequent(db, 40) == mine_frequent(tx, 40)


def test_min_compact_rows_floor_stops_bootstrap_thrash():
    """A cold-start append loop does not compact on every tiny batch: the
    row floor keeps compaction off until the delta is worth folding."""
    rng = np.random.default_rng(15)

    def run(min_compact_rows):
        db = _store(n_classes=1, min_compact_rows=min_compact_rows)
        history = []
        for _ in range(20):
            batch = _db(rng, 8, 8)
            db.append(batch)
            history += batch
        probes = [(0,), (1, 2), (3,)]
        np.testing.assert_array_equal(
            db.counts(probes), _fresh_counts(history, None, 1, probes))
        return db

    floored = run(min_compact_rows=None)     # default floor
    assert floored.n_compactions == 0        # no thrash on cold start
    assert floored.stats()["min_compact_rows"] > 0
    thrash = run(min_compact_rows=0)         # floor off: the old behavior
    assert thrash.n_compactions >= 10        # compacted on most tiny appends
    floored.compact()
    assert floored.delta_rows == 0 and floored.n_compactions == 1


def test_background_compactor_exact_under_racing_appends():
    rng = np.random.default_rng(16)
    tx = _db(rng, 120, 10)
    db = _store(tx, n_classes=1, merge_ratio=0.05, min_compact_rows=0,
                background_compaction=True)
    history = list(tx)
    probes = [(0, 1), (2,), (3, 7)]
    try:
        for _ in range(6):
            batch = _db(rng, 40, 10)
            db.append(batch)
            history += batch
        db._compactor.drain()
        np.testing.assert_array_equal(
            db.counts(probes), _fresh_counts(history, None, 1, probes))
        st_ = db.stats()
        assert st_["compactor"] is not None
        assert st_["compactor"]["runs"] >= 1
        assert db.n_compactions >= 1
        assert db.last_compaction_error is None
    finally:
        db.close()
    assert db.stats()["compactor"] is None   # close() reverts to inline


def test_background_compactor_build_failure_absorbed(monkeypatch):
    """A failing off-lock base build leaves base+delta serving exactly,
    surfaces the error in stats(), and a later compact succeeds once the
    fault clears."""
    rng = np.random.default_rng(17)
    tx = _db(rng, 120, 10)
    db = _store(tx, n_classes=1, merge_ratio=0.05, min_compact_rows=0,
                background_compaction=True)
    history = list(tx)
    probes = [(0, 1), (2,), (3, 7)]
    real_make_base = db._make_base
    try:
        def boom(bits, weights, vocab=None):
            raise RuntimeError("disk full")

        monkeypatch.setattr(db, "_make_base", boom)
        batch = _db(rng, 60, 10)
        db.append(batch)                      # trigger: queues a bg compact
        history += batch
        db._compactor.drain()
        st_ = db.stats()
        assert st_["failed_compactions"] >= 1
        assert "disk full" in st_["last_compaction_error"]
        assert db.delta_rows > 0              # delta NOT dropped
        np.testing.assert_array_equal(        # base+delta still exact
            db.counts(probes), _fresh_counts(history, None, 1, probes))

        monkeypatch.setattr(db, "_make_base", real_make_base)
        db.compact()                          # fault cleared: fold succeeds
        assert db.delta_rows == 0
        np.testing.assert_array_equal(
            db.counts(probes), _fresh_counts(history, None, 1, probes))
    finally:
        db.close()


def test_inline_compaction_failure_metrics(monkeypatch):
    """An append-triggered compaction failure is absorbed (the append
    committed), surfaced through stats(), and leaves the base+delta
    composition exact; an EXPLICIT compact() re-raises."""
    rng = np.random.default_rng(18)
    tx = _db(rng, 100, 8)
    db = _store(tx, n_classes=1, merge_ratio=0.05, min_compact_rows=0)
    history = list(tx)
    monkeypatch.setattr(db, "_make_base",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("torn write")))
    batch = _db(rng, 30, 8)
    assert db.append(batch) == 1              # append commits despite the fail
    history += batch
    st_ = db.stats()
    assert st_["failed_compactions"] == 1
    assert "torn write" in st_["last_compaction_error"]
    assert db.delta_rows > 0                  # build-before-drop held
    probes = [(0,), (1, 2), (3, 4)]
    np.testing.assert_array_equal(
        db.counts(probes), _fresh_counts(history, None, 1, probes))
    with pytest.raises(RuntimeError):
        db.compact()                          # explicit compact re-raises
    assert db.delta_rows > 0                  # delta still not dropped
    np.testing.assert_array_equal(
        db.counts(probes), _fresh_counts(history, None, 1, probes))


# --------------------------- the count server's tests of tests/test_chooser
def _tx(seed, rows, items, p):
    rng = np.random.default_rng(seed)
    return [list(np.flatnonzero(rng.random(items) < p)) for _ in range(rows)]


def test_count_server_mine_backend_invariant():
    tx = _tx(2, 3000, 10, 0.5)
    theta = 0.2
    want = mine_frequent(tx, ceil_count(theta * len(tx)))

    srv = _server(tx)
    auto = srv.mine(theta)
    assert srv.last_backend_choice.name == "gfp"   # dense + compressible
    assert auto == want

    # identical results whichever backend mines the store
    assert srv.mine(theta, backend="store") == want
    assert srv.last_backend_choice.name == "store"
    assert srv.mine(theta, backend="gfp") == want
    assert srv.last_backend_choice.name == "gfp"
    assert srv.mine(theta, backend="dense") == want

    with pytest.raises(ValueError):
        srv.mine(theta, backend="bogus")

    # a sharded store always mines through its own all-reduced sweep
    sharded = _server(tx, shards=2)
    assert sharded.mine(theta) == want
    assert sharded.last_backend_choice.name == "store"


def test_store_records_adaptive_residency_choice():
    tx = _tx(3, 2500, 10, 0.5)
    store = _store(tx)
    assert store.backend_choice is not None
    assert store.backend_choice.name != "streaming"   # small footprint
    assert store.resident == "dense"
    assert store.stats()["backend_choice"] == store.backend_choice.name
    # explicit residency bypasses the chooser entirely
    forced = _store(tx, streaming=True)
    assert forced.backend_choice is None
    assert forced.resident == "streaming"
    assert forced.stats()["backend_choice"] is None
    # the composed backend exposes measured traits for CountServer.mine
    t = VersionedCountBackend(store).traits()
    assert t.n_rows == len(tx) and t.density > 0.3


# ================================================ side by side with the JAX
# package: the same inputs, the same calls, equal results and counters
STORE_FIELDS = ("version", "n_rows", "n_classes", "vocab_size", "resident",
                "base_rows", "delta_rows", "nbytes", "kernel_launches",
                "appends", "compactions", "failed_compactions",
                "last_compaction_error", "min_compact_rows",
                "backend_choice")


def _same_store_stats(a: dict, b: dict):
    for key in STORE_FIELDS:
        assert a[key] == b[key], key
    for key in ("segments", "chunk_rows", "disk_bytes"):
        assert (a["spill"] is None) == (b["spill"] is None)
        if a["spill"] is not None:
            assert a["spill"][key] == b["spill"][key], key


@pytest.mark.parametrize("residency", ["dense", "streaming", "spilled"])
def test_versioned_db_matches_jax_across_appends(tmp_path, residency):
    """VersionedDB on each base: counts, launch counters and stats() equal
    the JAX package's after appends that widen W, a compaction and a mine."""
    rng = np.random.default_rng(60)
    tx = _db(rng, 240, 30)
    y = [int(rng.random() < 0.3) for _ in tx]
    kw = dict(classes=y, n_classes=2, merge_ratio=1e9)
    if residency == "streaming":
        kw.update(streaming=True, chunk_rows=48)
    elif residency == "spilled":
        kw.update(spill=True, chunk_rows=48)
    port = _store(tx, spill_dir=str(tmp_path / "port"), **kw)
    ref = js.VersionedDB(tx, spill_dir=str(tmp_path / "jax"), **kw)
    assert port.resident == ref.resident == residency
    probes = [(0, 1), (2,), (3, 7, 9), (29,), (31,), (0, 40), ("nope",)]
    history, classes = list(tx), list(y)
    for step in range(1, 4):
        batch = _db(rng, 40, 30 + 6 * step)       # W 1 -> 2 words
        yb = [int(rng.random() < 0.3) for _ in batch]
        assert port.append(batch, classes=yb) == \
            ref.append(batch, classes=yb) == step
        history += batch
        classes += yb
        got = port.counts(probes)
        np.testing.assert_array_equal(got, ref.counts(probes))
        np.testing.assert_array_equal(
            got, _fresh_counts(history, classes, 2, probes))
        assert port.kernel_launches == ref.kernel_launches
    assert port.vocab.items == ref.vocab.items
    _same_store_stats(port.stats(), ref.stats())
    assert versioned_mine_frequent(port, 20) == \
        js.versioned_mine_frequent(ref, 20)
    assert port.kernel_launches == ref.kernel_launches
    port.compact()
    ref.compact()
    np.testing.assert_array_equal(port.counts(probes), ref.counts(probes))
    _same_store_stats(port.stats(), ref.stats())
    np.testing.assert_array_equal(np.asarray(port.base.bits),
                                  np.asarray(ref.base.bits))
    np.testing.assert_array_equal(np.asarray(port.base.weights),
                                  np.asarray(ref.base.weights))


@pytest.mark.parametrize("delta", ["empty", "rows", "wider"])
@pytest.mark.parametrize("residency", ["dense", "streaming", "spilled"])
def test_one_sweep_serves_and_mines(tmp_path, residency, delta):
    """``counts_masks`` and ``VersionedCountBackend.counts`` are one sweep:
    the same answer, resumable from every chunk boundary on the sweep's own
    accumulators, equal to the JAX store's with the same launches, on each
    base, with no delta, a delta, and a delta one vocabulary word wider."""
    rng = np.random.default_rng(62)
    tx = _db(rng, 120, 20)
    y = [int(rng.random() < 0.3) for _ in tx]
    kw = dict(classes=y, n_classes=2, merge_ratio=1e9)
    if residency == "streaming":
        kw.update(streaming=True, chunk_rows=32)
    elif residency == "spilled":
        kw.update(spill=True, chunk_rows=32)
    port = _store(tx, spill_dir=str(tmp_path / "port"), **kw)
    ref = js.VersionedDB(tx, spill_dir=str(tmp_path / "jax"), **kw)
    assert port.resident == ref.resident == residency
    if delta != "empty":
        batch = _db(rng, 30, 45 if delta == "wider" else 20)
        yb = [int(rng.random() < 0.3) for _ in batch]
        port.append(batch, classes=yb)
        ref.append(batch, classes=yb)
    assert port.vocab.items == ref.vocab.items
    assert port.vocab.n_words == (2 if delta == "wider" else 1)
    probes = [(0, 1), (2,), (3, 7, 9), (19,), (0, 40), (33,), ("nope",)]
    masks, _ = build_masks(probes, port.vocab, block_k=1)

    before, jbefore = port.kernel_launches, ref.kernel_launches
    got = port.counts_masks(masks)
    np.testing.assert_array_equal(got, np.asarray(ref.counts_masks(masks)))
    assert port.kernel_launches - before == ref.kernel_launches - jbefore

    backend = VersionedCountBackend(port)
    seen = {}
    full = backend.counts(
        masks, on_chunk=lambda j, acc: seen.__setitem__(j, np.array(acc)))
    np.testing.assert_array_equal(full, got)
    n = backend.n_count_chunks
    assert sorted(seen) == list(range(n))
    for start in range(n + 1):
        init = None if start == 0 else seen[start - 1]
        np.testing.assert_array_equal(
            backend.counts(masks, start_chunk=start, init=init), got)


def test_sharded_db_matches_jax_without_mesh():
    rng = np.random.default_rng(61)
    tx = _db(rng, 210, 12)
    y = [int(rng.random() < 0.4) for _ in tx]
    port = _sharded(tx, classes=y, n_classes=2, n_shards=3, merge_ratio=1e9)
    ref = js.ShardedDB(tx, classes=y, n_classes=2, n_shards=3,
                       merge_ratio=1e9)
    probes = [(0, 1), (2,), (3, 7, 9), (13,), (0, 14)]
    np.testing.assert_array_equal(port.counts(probes), ref.counts(probes))
    for step in range(2):
        batch = _db(rng, 50, 12 + 2 * step)
        yb = [int(rng.random() < 0.4) for _ in batch]
        port.append(batch, classes=yb)
        ref.append(batch, classes=yb)
        np.testing.assert_array_equal(port.counts(probes),
                                      ref.counts(probes))
    a, b = port.stats(), ref.stats()
    for key in ("version", "n_rows", "n_classes", "vocab_size", "resident",
                "n_shards", "shard_rows", "base_rows", "delta_rows",
                "nbytes", "kernel_launches", "appends", "compactions",
                "failed_compactions", "mesh"):
        assert a[key] == b[key], key
    assert versioned_mine_frequent(port, 30) == \
        js.versioned_mine_frequent(ref, 30)
    assert port.kernel_launches == ref.kernel_launches


def _server_fields(srv):
    st = srv.stats()
    return dict(batcher={k: v for k, v in st["batcher"].items()
                         if k != "block_k"},
                cache=st["cache"], flushes=st["flushes"],
                queries_served=st["queries_served"],
                mining_theta=st["mining_theta"],
                frequent_itemsets=st["frequent_itemsets"],
                launches=st["store"]["kernel_launches"])


def test_count_server_sync_matches_jax():
    """The same submit / flush / query / append / mine sequence on both
    servers: every answered block, the frequent sets and the stats()
    counters that mean the same thing are equal."""
    rng = np.random.default_rng(62)
    tx = _db(rng, 260, 12, p=0.3)
    y = [int(rng.random() < 0.3) for _ in tx]
    port = _server(tx, classes=y, block_k=16, merge_ratio=1e9)
    ref = js.CountServer(tx, classes=y, block_k=16, merge_ratio=1e9)
    pool = [(a,) for a in range(14)] + [(a, b) for a in range(6)
                                        for b in range(a + 1, 8)]
    for rnd in range(4):
        reqs = [[pool[int(i)] for i in rng.integers(0, len(pool), 5)]
                for _ in range(3)]
        tp = [port.submit(f"c{i}", r) for i, r in enumerate(reqs)]
        tj = [ref.submit(f"c{i}", r) for i, r in enumerate(reqs)]
        assert tp == tj
        op, oj = port.flush(), ref.flush()
        assert sorted(op) == sorted(oj)
        for t in op:
            np.testing.assert_array_equal(op[t], oj[t])
            assert op[t].dtype == np.int32
        if rnd == 1:
            assert port.mine(0.1) == ref.mine(0.1)
        if rnd >= 1:
            batch = _db(rng, 40, 14, p=0.3)
            yb = [int(rng.random() < 0.3) for _ in batch]
            assert port.append(batch, classes=yb) == \
                ref.append(batch, classes=yb)
            assert port.frequent == ref.frequent
    np.testing.assert_array_equal(port.query(pool), ref.query(pool))
    assert _server_fields(port) == _server_fields(ref)


def test_count_server_async_matches_jax():
    """Async flush: every future's counts equal the JAX package's server
    answering the same requests (the flush times differ, the counts at one
    version cannot), and the close() drain answers every ticket."""
    rng = np.random.default_rng(63)
    tx = _db(rng, 200, 10)
    pool = [(a,) for a in range(10)] + [(a, a + 1) for a in range(9)]
    port = _server(tx, async_flush=True, max_delay_ms=10, min_batch=4)
    ref = js.CountServer(tx)
    futs = []
    lock = threading.Lock()

    def client(c):
        for i in range(12):
            req = [pool[(c * 7 + i * 3 + j) % len(pool)] for j in range(3)]
            f = port.submit_async(f"c{c}", req)
            with lock:
                futs.append((req, f))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        port.close()
    assert len(futs) == 48
    for req, f in futs:
        assert f.done()
        np.testing.assert_array_equal(f.result(timeout=1), ref.query(req))
    st = port.stats()
    assert st["async"]["pending_tickets"] == 0
    assert st["batcher"]["requests"] == 48 and st["batcher"]["queries"] == 144
    assert st["queries_served"] == 144


@pytest.mark.parametrize("backend", ["auto", "store", "gfp"])
def test_count_server_mine_matches_jax(backend):
    """mine(backend=...) and its incremental maintenance over appends: the
    same frequent sets, the same chooser verdict, as the JAX package."""
    tx = _tx(4, 1500, 10, 0.45)
    port = _server(tx, merge_ratio=1e9)
    ref = js.CountServer(tx, merge_ratio=1e9)
    theta = 0.2
    got = port.mine(theta, backend=backend)
    assert got == ref.mine(theta, backend=backend)
    assert port.last_backend_choice.name == ref.last_backend_choice.name
    assert got == _jax_mine(tx, ceil_count(theta * len(tx)))
    history = list(tx)
    for seed in (5, 6):
        batch = _tx(seed, 300, 12, 0.5)
        port.append(batch)
        ref.append(batch)
        history += batch
        assert port.frequent == ref.frequent
    assert port.frequent == _jax_mine(history,
                                      ceil_count(theta * len(history)))
    # a class-guided mine is a query and leaves the baseline armed
    y = [int(i % 3 == 0) for i in range(len(tx))]
    cp = _server(tx, classes=y, n_classes=2)
    cj = js.CountServer(tx, classes=y, n_classes=2)
    assert cp.mine(0.05, class_column=1, backend=backend) == \
        cj.mine(0.05, class_column=1, backend=backend)


def test_gfp_backend_from_store_matches_jax():
    """GFPBackend.from_store over a store with a live delta: the composed
    rows, the signature pinned to the version, and its counts."""
    from repro.mining.gfp_backend import GFPBackend as JaxGFP
    from repro_torch.mining import GFPBackend

    rng = np.random.default_rng(64)
    tx = _db(rng, 300, 10, p=0.4)
    port = _store(tx, merge_ratio=1e9)
    ref = js.VersionedDB(tx, merge_ratio=1e9)
    batch = _db(rng, 60, 12, p=0.4)
    port.append(batch)
    ref.append(batch)
    gp, gj = GFPBackend.from_store(port), JaxGFP.from_store(ref)
    np.testing.assert_array_equal(gp.bits, gj.bits)
    np.testing.assert_array_equal(gp.weights, gj.weights)
    assert gp.mine_signature() == gj.mine_signature() == \
        {"engine": "gfp", "version": 1}
    assert gp.device == CPU
    masks = encode_targets([(0, 1), (2,), (3, 11), (4, 5, 6)], port.vocab)
    np.testing.assert_array_equal(gp.counts(masks),
                                  np.asarray(gj.counts(masks)))
    np.testing.assert_array_equal(gp.counts(masks),
                                  port.counts_masks(masks))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spilled_store_opens_in_the_other_package(tmp_path, writer):
    """A VersionedDB's spilled base, written by one package, opens with the
    other's SpilledDB and counts the same."""
    rng = np.random.default_rng(65)
    tx = _db(rng, 200, 12)
    y = [int(rng.random() < 0.3) for _ in tx]
    kw = dict(classes=y, n_classes=2, spill=True, spill_dir=str(tmp_path),
              chunk_rows=40)
    store = (js.VersionedDB(tx, **kw) if writer == "jax"
             else _store(tx, **kw))
    directory = store.base.directory
    other = (SpilledDB.open(directory, device=CPU) if writer == "jax"
             else jm.SpilledDB.open(directory))
    assert other.seg_rows == store.base.seg_rows
    assert tuple(other.vocab.items) == tuple(store.vocab.items)
    masks = encode_targets([(0, 1), (2,), (3, 7, 9)],
                           ItemVocab(tuple(store.vocab.items)))
    got = np.asarray(other.counts(masks))
    np.testing.assert_array_equal(got, np.asarray(store.base.counts(masks)))
    np.testing.assert_array_equal(
        got, _fresh_counts(tx, y, 2, [(0, 1), (2,), (3, 7, 9)]))


def test_resolve_serve_block_k_on_a_store_matches_jax():
    """The serve pad size of a port store equals the JAX package's on the
    same table and data, and the server pads with it."""
    rng = np.random.default_rng(66)
    tx = _db(rng, 500, 40)
    y = [int(rng.random() < 0.3) for _ in tx]
    port = _store(tx, classes=y, n_classes=2)
    ref = js.VersionedDB(tx, classes=y, n_classes=2)
    bucket = km.geometry_bucket(port.base_rows, at.TABLE_LOOKUP_BLOCK_K,
                                port.vocab.n_words, 2)
    doc = {"schema": 1, "device_kind": "cpu", "created": "", "entries": {
        bucket: {"block_k": 512, "block_n": 1024, "accum": "vpu_int32",
                 "chunk_rows": 0, "us": 100.0, "efficiency": 0.5,
                 "serve_block_k": 64}}}
    at.set_active_table(at.table_from_dict(json.loads(json.dumps(doc))))
    jat.set_active_table(jat.table_from_dict(json.loads(json.dumps(doc))))
    assert at.resolve_serve_block_k(port) == \
        jat.resolve_serve_block_k(ref) == 64
    srv = _server(tx, classes=y, n_classes=2)
    assert srv.batcher.block_k == 64
    at.set_active_table(None)
    jat.set_active_table(None)
    assert at.resolve_serve_block_k(port) == at.DEFAULT_BLOCK_K
    assert jat.resolve_serve_block_k(ref) == jat.DEFAULT_BLOCK_K


# ============================================================ port contracts
@pytest.mark.parametrize("make", [
    lambda tx: VersionedDB(tx),
    lambda tx: ShardedDB(tx, n_shards=2),
    lambda tx: CountServer(tx),
])
def test_entry_points_default_to_the_card(make):
    """No device means the card: without one they raise, never fall back
    to the host."""
    tx = [[0, 1], [1, 2], [0]]
    if torch.cuda.is_available():
        built = make(tx)
        store = getattr(built, "store", built)
        assert store.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(tx)


def test_store_device_reaches_every_segment(tmp_path):
    tx = [[0, 1], [1, 2], [0], [2, 3]] * 10
    for kw in ({}, dict(streaming=True, chunk_rows=8),
               dict(spill=True, spill_dir=str(tmp_path), chunk_rows=8)):
        db = _store(tx, merge_ratio=1e9, **kw)
        db.append([[0, 9]])
        db.counts([(0,)])
        assert db.device == CPU and db.stats()["device"] == "cpu"
        assert getattr(db.base, "device", None) in (None, CPU)
        if isinstance(db.base.bits, torch.Tensor):
            assert db.base.bits.device == CPU
        assert all(t.device == CPU for t in db._delta.on_device())
    sh = _sharded(tx, n_shards=2)
    assert all(s.device == CPU for s in sh.shards)


def test_spill_dir_from_the_port_environment(tmp_path, monkeypatch):
    """The store's default spill root is $REPRO_TORCH_SPILL_DIR (the JAX
    package reads $REPRO_SPILL_DIR)."""
    monkeypatch.delenv("REPRO_SPILL_DIR", raising=False)
    monkeypatch.delenv("REPRO_TORCH_SPILL_DIR", raising=False)
    tx = [[0, 1], [1, 2], [0]] * 20
    with pytest.raises(ValueError, match="REPRO_TORCH_SPILL_DIR"):
        _store(tx, spill=True)
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="spill_dir"):
        _store(tx, spill=True)
    monkeypatch.setenv("REPRO_TORCH_SPILL_DIR", str(tmp_path / "port"))
    db = _store(tx, spill=True)
    assert db.resident == "spilled"
    assert db.base.directory.startswith(str(tmp_path / "port"))


class _TwoRankMesh:
    """Stands in for a DeviceMesh of two ranks: ``size()`` is a method."""

    def size(self):
        return 2


def test_async_flush_refused_over_a_multi_rank_mesh():
    """Each rank's flusher would pick its own flush times, so the ranks'
    all-reduces would pair different batches: CountServer refuses
    async_flush over a mesh of more than one rank (the JAX package, one
    process, has no such limit).  The gloo run pins it on a real mesh."""
    tx = [[0, 1], [1, 2], [0]] * 10
    with pytest.raises(ValueError, match="async_flush over a mesh"):
        _server(tx, shards=2, mesh=_TwoRankMesh(), async_flush=True)
    # a server without a mesh, or over one rank, keeps async flush
    srv = _server(tx, shards=2, async_flush=True)
    assert srv.stats()["async"] is not None
    srv.close()


# ==================================================================== card
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("residency", ["dense", "streaming"])
def test_cuda_served_counts_run_the_kernel(residency):
    """On the card every flush launches K1 (or K3 for a streamed base) and
    the counts equal the plain version on the same resident tensors."""
    _cuda_or_skip()
    from repro_torch.kernels.itemset_count import ops

    rng = np.random.default_rng(70)
    tx = _db(rng, 3000, 40)
    y = [int(rng.random() < 0.2) for _ in tx]
    kw = dict(streaming=True, chunk_rows=512) if residency == "streaming" \
        else {}
    srv = CountServer(tx, classes=y, n_classes=2, merge_ratio=1e9, **kw)
    plain = CountServer(tx, classes=y, n_classes=2, merge_ratio=1e9,
                        use_kernel=False, **kw)
    assert srv.store.device.type == "cuda"
    pool = [(a, b) for a in range(10) for b in range(a + 1, 12)]
    before = ops.KERNEL_LAUNCHES
    got = srv.query(pool)
    assert ops.KERNEL_LAUNCHES - before == srv.store.kernel_launches > 0
    np.testing.assert_array_equal(got, plain.query(pool))
    batch = _db(rng, 200, 45)
    yb = [int(rng.random() < 0.2) for _ in batch]
    srv.append(batch, classes=yb)
    plain.append(batch, classes=yb)
    before = ops.KERNEL_LAUNCHES
    got = srv.query(pool + [(41,), (0, 42)])
    assert ops.KERNEL_LAUNCHES > before
    np.testing.assert_array_equal(got, plain.query(pool + [(41,), (0, 42)]))
    np.testing.assert_array_equal(
        got, _fresh_counts(tx + batch, y + yb, 2, pool + [(41,), (0, 42)]))


@pytest.mark.cuda
def test_cuda_async_flush_and_background_compaction():
    """The flusher and compactor threads count on the store's card."""
    _cuda_or_skip()
    from repro_torch.kernels.itemset_count import ops

    rng = np.random.default_rng(71)
    tx = _db(rng, 4000, 20)
    srv = CountServer(tx, async_flush=True, max_delay_ms=5, min_batch=4,
                      background_compaction=True, merge_ratio=0.01,
                      min_compact_rows=0)
    history = list(tx)
    before = ops.KERNEL_LAUNCHES
    try:
        futs = []
        for i in range(4):
            futs.append(srv.submit_async("c", [(i,), (i, i + 1)]))
            batch = _db(rng, 100, 20)
            srv.append(batch)
            history += batch
        results = [f.result(timeout=60) for f in futs]
        srv.store._compactor.drain()
    finally:
        srv.close()
    assert ops.KERNEL_LAUNCHES > before
    assert srv.store.n_compactions >= 1
    assert all(r.shape == (2, 1) for r in results)
    probes = [(0,), (1, 2), (3, 7)]
    np.testing.assert_array_equal(srv.query(probes),
                                  _fresh_counts(history, None, 1, probes))
