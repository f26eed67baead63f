"""The port's mining path (encode, dense and streaming engines, driver,
checkpoint, Minority-Report, launcher) against the JAX package and the host
oracles, on the same inputs, with exact equality.  Runs on the CPU, where
the port counts through the kernel's plain PyTorch version."""
import json
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mining as jm
from _testutil import random_problem
from repro.core import ItemOrder as JaxItemOrder
from repro.core import TISTree as JaxTISTree
from repro.core import mine_frequent as jax_host_mine
from repro.data import bernoulli_db as jax_bernoulli_db
from repro.data import census_like_db as jax_census_like_db
from repro.mining.distributed import MiningCheckpoint as JaxCheckpoint
from repro_torch import mining as tm
from repro_torch import obs
from repro_torch.convert import dense_db_from_reference
from repro_torch.core import ItemOrder, TISTree, mine_frequent
from repro_torch.data import bernoulli_db, census_like_db
from repro_torch.launch import mine as launch_mine
from repro_torch.mining import MiningCheckpoint
from repro_torch.mining import dense as tdense
from repro_torch.mining.encode import walk_rows
from repro_torch.obs import TRACER

CPU = torch.device("cpu")


def _bern(n=1500, items=24, p_x=0.2, p_y=0.1, seed=3):
    tx, y = bernoulli_db(n, items, p_x, p_y, seed)
    jtx, jy = jax_bernoulli_db(n, items, p_x, p_y, seed)
    assert tx == jtx and np.array_equal(y, jy)
    return tx, y


def _census(n=800, p_y=0.15, seed=5):
    rows, y = census_like_db(n, p_y, seed)
    jrows, jy = jax_census_like_db(n, p_y, seed)
    assert rows == jrows and np.array_equal(y, jy)
    return rows, y


DATASETS = {"bernoulli": _bern, "census": _census}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_encode_dedup_bytes_equal(name):
    tx, y = DATASETS[name]()
    vocab = tm.ItemVocab.from_transactions(tx)
    jvocab = jm.ItemVocab.from_transactions(tx)
    assert vocab.items == jvocab.items
    bits = tm.encode_bitmap(tx, vocab)
    jbits = jm.encode_bitmap(tx, jvocab)
    assert bits.tobytes() == jbits.tobytes()
    ub, uw = tm.dedup_rows(bits, tm.class_weights(y, 2))
    jub, juw = jm.dedup_rows(jbits, jm.class_weights(y, 2))
    assert ub.dtype == jub.dtype and uw.dtype == juw.dtype
    assert ub.tobytes() == jub.tobytes() and uw.tobytes() == juw.tobytes()
    db = tm.DenseDB.encode(tx, y, device=CPU)
    jdb = jm.DenseDB.encode(tx, y)
    assert db.bits.numpy().tobytes() == np.asarray(jdb.bits).tobytes()
    assert db.weights.numpy().tobytes() == np.asarray(jdb.weights).tobytes()


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("streaming", [None, True])
def test_dense_db_from_reference_gives_equal_gfp_counts(streaming, project):
    """On the dense engine and, asked to stream, through the streaming
    backend over a host view of the same DenseDB, projected or not."""
    tx, y = _bern(seed=11)
    jdb = jm.DenseDB.encode(tx, y)
    db = dense_db_from_reference(jdb.vocab.items, np.asarray(jdb.bits),
                                 np.asarray(jdb.weights), jdb.n_rows,
                                 jdb.n_classes, device=CPU)
    counts = {}
    for t in tx:
        for a in set(t):
            counts[a] = counts.get(a, 0) + 1
    rng = np.random.default_rng(0)
    items = sorted(counts)
    tis = TISTree(ItemOrder.from_counts(counts))
    jtis = JaxTISTree(JaxItemOrder.from_counts(counts))
    for _ in range(40):
        t = [int(a) for a in rng.choice(items, size=int(rng.integers(1, 4)),
                                        replace=False)]
        tis.insert(t, target=True)
        jtis.insert(t, target=True)
    kw = dict(streaming=streaming, project=project,
              chunk_rows=256 if streaming else None)
    got = tm.dense_gfp_counts(tis, db, **kw)
    want = jm.dense_gfp_counts(jtis, jdb, **kw)
    assert got.keys() == want.keys() and len(want) > 0
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key]))


@pytest.mark.parametrize("class_column", [None, 1])
def test_dense_mine_frequent_matches_jax_and_host(class_column):
    tx, y = _bern(n=1200, items=16, p_x=0.3, seed=7)
    min_count = 30 if class_column is None else 8
    got = tm.dense_mine_frequent(tm.DenseDB.encode(tx, y, device=CPU),
                                 min_count, class_column=class_column)
    want = jm.dense_mine_frequent(jm.DenseDB.encode(tx, y), min_count,
                                  class_column=class_column)
    assert got == want
    if class_column is None:
        assert got == mine_frequent(tx, min_count) == jax_host_mine(tx,
                                                                    min_count)


def _level1_table(v, seed):
    """Rows over exactly ``v`` items (each appears), a third of them
    repeated so that deduped weights exceed 1."""
    rng = np.random.default_rng(seed)
    tx = [sorted(int(a) for a in np.flatnonzero(rng.random(v) < 0.3))
          for _ in range(90)]
    tx += [[a] for a in range(v)]
    return tx + tx[::3]


def _item_counts_case(v, classes, device, use_kernel):
    """The port's and the JAX package's ``item_counts`` on one table;
    returns the count kernel's launches during the port's call."""
    from repro_torch.kernels.itemset_count import ops
    tx = _level1_table(v, seed=v)
    y = {"one": None, "two": [int(i % 4 == 0) for i in range(len(tx))],
         "two_one_empty": [0] * len(tx)}[classes]
    n_classes = None if y is None else 2
    db = tm.DenseDB.encode(tx, y, n_classes, device=device)
    jdb = jm.DenseDB.encode(tx, y, n_classes)
    assert db.vocab.size == v and int(db.weights.max()) > 1
    backend = tm.DenseBackend(db, use_kernel=use_kernel)
    before = ops.KERNEL_LAUNCHES
    got = backend.item_counts()
    launches = ops.KERNEL_LAUNCHES - before
    want = jm.DenseBackend(jdb).item_counts()
    assert got.dtype == np.int64 and got.shape == (v, db.n_classes)
    assert np.array_equal(got, want)
    if classes == "two_one_empty":
        assert not got[:, 1].any()
    return launches


_ITEM_COUNTS_CASES = pytest.mark.parametrize(
    "v,classes", [(v, c) for v in (1, 31, 32, 33, 64, 65, 115)
                  for c in ("one", "two", "two_one_empty")])


@_ITEM_COUNTS_CASES
def test_dense_item_counts_match_jax(v, classes):
    assert _item_counts_case(v, classes, CPU, use_kernel=False) == 0


@pytest.mark.cuda
@_ITEM_COUNTS_CASES
def test_cuda_dense_item_counts_match_jax(v, classes):
    """Level 1 through the count kernel: one launch, the JAX integers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    assert _item_counts_case(v, classes, torch.device("cuda"),
                             use_kernel=True) == 1


@pytest.mark.parametrize("class_column", [None, 1])
def test_level1_shortcut_identical_and_guarded(class_column, monkeypatch):
    """The port's twin of the JAX package's level-1 guard: the dense
    engine's shortcut gives the same mine as counting level 1 like any
    level, and equals the JAX mine; ``item_counts`` is one ``counts``
    call; a backend without the shortcut refuses a forced request."""
    tx, y = _bern(n=600, items=14, p_x=0.35, p_y=0.3, seed=2)
    min_count = 40 if class_column is None else 12
    db = tm.DenseDB.encode(tx, y, device=CPU)
    want = jm.mine_frequent_backend(jm.DenseBackend(jm.DenseDB.encode(tx, y)),
                                    min_count, class_column=class_column)
    assert len(want) > len([k for k in want if len(k) == 1])
    for shortcut in (None, True, False):
        got = tm.mine_frequent_backend(tm.DenseBackend(db), min_count,
                                       class_column=class_column,
                                       level1_shortcut=shortcut)
        assert got == want, shortcut

    calls = []
    counts = tm.DenseBackend.counts

    def spy(self, masks, **kw):
        calls.append(masks.shape)
        return counts(self, masks, **kw)

    monkeypatch.setattr(tm.DenseBackend, "counts", spy)
    tm.DenseBackend(db).item_counts()
    assert calls == [(db.vocab.size, db.vocab.n_words)]

    sdb = tm.StreamingDB.encode(tx, y, chunk_rows=64, device=CPU)
    with pytest.raises(ValueError):
        tm.mine_frequent_backend(tm.StreamingBackend(sdb), min_count,
                                 level1_shortcut=True)


@pytest.mark.parametrize("chunk_rows", [1, 7, 128, None])
def test_streaming_counts_bit_identical_with_resume(chunk_rows):
    rng = np.random.default_rng(chunk_rows or 0)
    n, k, w, c = 300, 25, 2, 2
    tx, tgt, wts = random_problem(rng, n, k, w, c)
    rows = n if chunk_rows is None else chunk_rows
    want = np.asarray(jm.streaming_counts(tx, jnp.asarray(tgt), wts,
                                          chunk_rows=rows))
    seen = []
    got = tm.streaming_counts(tx, tgt, wts, chunk_rows=rows, device=CPU,
                              on_chunk=lambda j, acc: seen.append((j, acc)))
    assert np.array_equal(got.numpy(), want)
    n_chunks = -(-n // rows)
    assert [j for j, _ in seen] == list(range(n_chunks))
    assert all(isinstance(a, np.ndarray) for _, a in seen)
    mid = n_chunks // 2 - 1 if n_chunks > 1 else 0
    resumed = tm.streaming_counts(tx, tgt, wts, chunk_rows=rows, device=CPU,
                                  init=seen[mid][1], start_chunk=mid + 1)
    jax_resumed = np.asarray(jm.streaming_counts(
        tx, jnp.asarray(tgt), wts, chunk_rows=rows, init=seen[mid][1],
        start_chunk=mid + 1))
    assert np.array_equal(resumed.numpy(), want)
    assert np.array_equal(jax_resumed, want)


class _Preempted(Exception):
    pass


def _kill_mid_level_2(mine, sdb, ckpt):
    calls = []

    def die(level, chunk):
        calls.append((level, chunk))
        if len(calls) == sdb.n_chunks + 3:   # 3 chunks into level 2
            raise _Preempted()

    with pytest.raises(_Preempted):
        mine(sdb, 40, checkpoint=ckpt, on_chunk=die)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    rng = np.random.default_rng(10)
    db = [[i for i in range(10) if rng.random() < 0.4] for _ in range(200)]
    want = mine_frequent(db, 40)
    path = str(tmp_path / "mine.json")
    jsdb = jm.StreamingDB.encode(db, chunk_rows=16)
    tsdb = tm.StreamingDB.encode(db, chunk_rows=16, device=CPU)
    assert tsdb.n_chunks == jsdb.n_chunks >= 4
    if writer == "jax":
        _kill_mid_level_2(jm.streaming_mine_frequent, jsdb,
                          JaxCheckpoint(path))
        resume, sdb, ckpt = tm.streaming_mine_frequent, tsdb, \
            MiningCheckpoint(path)
    else:
        _kill_mid_level_2(tm.streaming_mine_frequent, tsdb,
                          MiningCheckpoint(path))
        resume, sdb, ckpt = jm.streaming_mine_frequent, jsdb, \
            JaxCheckpoint(path)
    state = json.load(open(path))
    assert state["level"] == 1
    assert state["partial"]["level"] == 2
    assert state["partial"]["next_chunk"] == 3
    resumed = []
    got = resume(sdb, 40, checkpoint=ckpt,
                 on_chunk=lambda l, c: resumed.append((l, c)))
    assert got == want
    assert resumed[0] == (2, 3)              # resumed mid-level, chunk 3


def test_checkpoint_requires_streaming_engine(tmp_path):
    tx, y = _bern(n=200)
    ck = MiningCheckpoint(str(tmp_path / "c.json"))
    with pytest.raises(ValueError, match="streaming"):
        tm.minority_report_dense(tx, y, min_support=0.01, min_confidence=0.1,
                                 streaming=False, checkpoint=ck, device=CPU)
    with pytest.raises(ValueError, match="streaming"):
        tm.dense_mine_frequent(tm.DenseDB.encode(tx, device=CPU), 10,
                               streaming=False, checkpoint=ck)


@pytest.mark.parametrize("name,streaming", [
    ("bernoulli", False), ("bernoulli", True),
    ("census", False), ("census", True)])
def test_minority_report_dense_matches_jax(name, streaming):
    tx, y = DATASETS[name]()
    kw = dict(min_support=0.01, min_confidence=0.05, streaming=streaming)
    if streaming:
        kw["chunk_rows"] = 256
    got = tm.minority_report_dense(tx, y, device=CPU, **kw)
    want = jm.minority_report_dense(tx, y, **kw)
    # the Rule classes are each package's own: compare their fields
    assert [astuple(r) for r in got.rules] == \
        [astuple(r) for r in want.rules]
    assert len(got.rules) > 0
    assert got.items_kept == want.items_kept
    assert (got.n_db, got.n_rare) == (want.n_db, want.n_rare)
    assert got.engine == want.engine
    assert got.kernel_launches == want.kernel_launches


@pytest.mark.parametrize("extra", [[], ["--streaming", "--chunk-rows", "300"],
                                   ["--backend", "dense"],
                                   ["--backend", "streaming"]])
def test_launcher_verifies_on_cpu(capsys, extra):
    launch_mine.main(["--rows", "2000", "--items", "30", "--p-x", "0.15",
                      "--p-y", "0.05", "--min-support", "0.004",
                      "--min-conf", "0.02", "--device", "cpu", "--verify",
                      *extra])
    out = capsys.readouterr().out
    assert "identical" in out
    assert "verified against paper-faithful engine" in out


@pytest.mark.parametrize("backend,p_x,expect", [
    ("auto", 0.05, "backend: dense ("), ("auto", 0.15, "backend: gfp ("),
    ("gfp", 0.15, "backend: gfp (explicitly requested)")])
def test_launcher_backend_auto_gfp_verifies_on_cpu(capsys, backend, p_x,
                                                   expect):
    """``--backend auto`` prints the chooser's verdict with its traits (at
    p_x = 0.05 the mine stays shallow and dense; at 0.15 the rows are dense
    and compressible and go to the GFP hybrid); ``--backend gfp`` forces the
    hybrid; each matches the host oracle."""
    launch_mine.main(["--rows", "3000", "--items", "12", "--p-x", str(p_x),
                      "--min-support", "0.02", "--device", "cpu", "--verify",
                      "--backend", backend])
    out = capsys.readouterr().out
    assert "autotune: default launch configs (no tuning table)" in out
    assert expect in out
    assert ("traits: 3000 rows" in out) == (backend == "auto")
    assert "itemsets identical" in out


def test_reference_kernel_launches_misses_last_counted_level():
    """A fault of the reference, kept in the port for parity: the dense
    engine's ``kernel_launches`` counts max frequent length - 1 levels, but
    the mine also counts the next level, whose candidates all fail.  Here
    no pair is frequent in the rare class, so level 2 is counted (one
    launch) and the fused pass is another: 2 launches, reported as 1."""
    import repro.obs as jobs

    tx, y = _bern()
    kw = dict(min_support=0.01, min_confidence=0.05, streaming=False)
    before = jobs.counter_total(jobs.snapshot(), "kernel_launches_total")
    want = jm.minority_report_dense(tx, y, **kw)
    launched = jobs.counter_total(jobs.snapshot(),
                                  "kernel_launches_total") - before
    assert max(len(r.antecedent) for r in want.rules) == 1
    assert want.kernel_launches == 1
    assert launched == 2
    got = tm.minority_report_dense(tx, y, device=CPU, **kw)
    assert got.kernel_launches == want.kernel_launches


@pytest.mark.parametrize("chunk_rows", [64, 500])
def test_progress_hook_without_checkpoint_matches_jax(chunk_rows):
    """Without a checkpoint the progress hook sees the same (level, chunk)
    sequence as the JAX package's, but the sweep is not handed a per-chunk
    accumulator (its host copy would wait on every chunk's launch)."""
    tx, y = _bern()
    jdb = jm.DenseDB.encode(tx, classes=y, n_classes=2)
    sdb = tm.StreamingDB.from_arrays(
        tm.ItemVocab(tuple(jdb.vocab.items)), np.asarray(jdb.bits),
        np.asarray(jdb.weights), jdb.n_rows, 2, chunk_rows, device=CPU)
    jsdb = jm.StreamingDB.from_dense(jdb, chunk_rows)
    seen, jseen, hooks = [], [], []
    real = tm.stream.streaming_counts

    def spy(*a, **kw):
        hooks.append(kw.get("on_chunk"))
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tm.stream, "streaming_counts", spy)
    mp.setattr(tm.backend, "streaming_counts", spy)
    try:
        got = tm.streaming_mine_frequent(
            sdb, 8, class_column=1, on_chunk=lambda l, j: seen.append((l, j)))
    finally:
        mp.undo()
    want = jm.streaming_mine_frequent(
        jsdb, 8, class_column=1, on_chunk=lambda l, j: jseen.append((l, j)))
    assert got == want and len(got) > 0
    assert seen == jseen and len(seen) > sdb.n_chunks
    assert hooks and all(h is None for h in hooks)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_mra_encode_matches_jax_encoding(name):
    """The MRA's own encoding (rare-class vocabulary, two weight columns)
    equals the JAX package's DenseDB built on the vocabulary its
    minority_report_dense keeps, byte for byte."""
    tx, y = DATASETS[name]()
    db, items_kept, n_rare = tm.mra_encode(tx, y, min_support=0.01,
                                           streaming=False, device=CPU)
    want = jm.minority_report_dense(tx, y, min_support=0.01,
                                    min_confidence=0.05)
    assert items_kept == want.items_kept and n_rare == want.n_rare
    y01 = [int(v == 1) for v in y]
    jdb = jm.DenseDB.encode(tx, classes=y01, n_classes=2,
                            vocab=jm.ItemVocab(tuple(items_kept)))
    assert db.bits.numpy().tobytes() == np.asarray(jdb.bits).tobytes()
    assert db.weights.numpy().tobytes() == np.asarray(jdb.weights).tobytes()
    sdb, _, _ = tm.mra_encode(tx, y, min_support=0.01, chunk_rows=128,
                              device=CPU)
    assert isinstance(sdb, tm.StreamingDB) and sdb.chunk_rows == 128
    assert sdb.bits.tobytes() == np.asarray(jdb.bits).tobytes()


def _edge_table(case):
    """-> (make_rows, y, n_kept): ``make_rows()`` gives a fresh copy of the
    table as the case gives it (generators are read once); ``n_kept`` is the
    size of the kept vocabulary where the case fixes it.  Row ``i`` is rare
    where ``i % 6 == 5``; every kept item is in some rare row, and the five
    items past ``k`` only in the other rows, outside the kept vocabulary."""
    n, k = 240, 40
    if case.startswith("vocab_"):
        k = int(case.split("_")[1])
    rng = np.random.default_rng(k)
    y = np.array([int(i % 6 == 5) for i in range(n)])
    base = []
    for i in range(n):
        if y[i]:
            r = i // 6
            row = [j for j in range(k) if j % 40 == r or rng.random() < 0.1]
        else:
            row = [j for j in range(k + 5) if rng.random() < 0.1]
        base.append([int(j) for j in rng.permutation(row)])
    obj = {"strings": lambda j: f"s{j}", "tuples": lambda j: ("t", j % 3, j)}
    if case in obj:
        base = [[obj[case](j) for j in t] for t in base]
    elif case == "repeats":
        base = [t + t[:1] + t[-1:] if i % 3 else t + t
                for i, t in enumerate(base)]
    elif case == "empty_rows":
        base = [[] if i % 4 == 0 else t for i, t in enumerate(base)]
    elif case == "outside_vocab":
        base = [t if y[i] or i % 3 else [k + j for j in range(i % 5 + 1)]
                for i, t in enumerate(base)]
    elif case == "equal_hashables":
        # 1 and 0 in several types, the first row not rare: the kept object
        # is the one first seen in a rare-class row
        ones, zeros = [1, 1.0, True, np.int64(1)], [0, 0.0, False]
        base = [[ones[int(rng.integers(4))] if a == 1 else
                 zeros[int(rng.integers(3))] if a == 0 else a for a in t]
                for t in base]
        base[0] = [True, 0.0] + base[0]
        base[5] = [np.int64(1), 1.0, False] + base[5]
    if case == "generator_rows":
        return (lambda: [(a for a in t) for t in base]), y, k
    if case == "generator_table":
        return (lambda: (list(t) for t in base)), y, k
    if case == "array_rows":
        return (lambda: [np.array(t, dtype=np.int64) for t in base]), y, k
    return (lambda: [list(t) for t in base]), y, k


_EDGE_CASES = ["repeats", "empty_rows", "outside_vocab", "vocab_31",
               "vocab_32", "vocab_33", "vocab_64", "vocab_65", "ints",
               "strings", "tuples", "equal_hashables", "generator_rows",
               "generator_table", "array_rows"]


def _typed(items):
    return [(type(a), repr(a)) for a in items]


@pytest.mark.parametrize("engine", ["dense", "streaming"])
@pytest.mark.parametrize("case", _EDGE_CASES)
def test_flat_encode_matches_jax_on_edge_inputs(case, engine, monkeypatch):
    """The one walk over the rows (``flatten_rows``) feeding both MRA passes
    gives the JAX package's kept items (order and objects), rare count,
    bits and weights, and ``encode_bitmap`` its bytes, on repeats within a
    row, empty rows, rows of out-of-vocabulary items, word edges of the
    vocabulary, item types, equal hashables of several types, and rows as
    generators and numpy arrays."""
    make_rows, y, k = _edge_table(case)
    min_support = 0.5 / len(y)
    # the JAX package's passes 1 and 2 alone: no antecedent mine
    monkeypatch.setattr("repro.mining.dense.dense_mine_frequent",
                        lambda *a, **kw: {})
    want = jm.minority_report_dense(make_rows(), y, min_support=min_support,
                                    min_confidence=0.5, streaming=False)
    opts = ({"streaming": False} if engine == "dense"
            else {"chunk_rows": 128})
    db, items_kept, n_rare = tm.mra_encode(make_rows(), y,
                                           min_support=min_support,
                                           device=CPU, **opts)
    assert _typed(items_kept) == _typed(want.items_kept)
    assert n_rare == want.n_rare == int(y.sum())
    if case.startswith("vocab_"):
        assert len(items_kept) == k
    vocab = jm.ItemVocab(tuple(want.items_kept))
    jdb = jm.DenseDB.encode(list(make_rows()), classes=y, n_classes=2,
                            vocab=vocab)
    if engine == "dense":
        assert isinstance(db, tm.DenseDB)
        bits, weights = db.bits.numpy(), db.weights.numpy()
    else:
        assert isinstance(db, tm.StreamingDB) and db.chunk_rows == 128
        bits, weights = db.bits, db.weights
    assert bits.tobytes() == np.asarray(jdb.bits).tobytes()
    assert weights.tobytes() == np.asarray(jdb.weights).tobytes()
    assert db.n_rows == len(y)
    got = tm.encode_bitmap(make_rows(), tm.ItemVocab(tuple(items_kept)))
    jbits = jm.encode_bitmap(list(make_rows()), vocab)
    assert got.dtype == jbits.dtype and got.tobytes() == jbits.tobytes()


def _route_case(case):
    """-> (rows, classes, min_support) for the routes of the MRA's encode."""
    if case in ("bernoulli", "no_rare", "nothing_kept"):
        tx, y = _bern()
        if case == "no_rare":
            y = np.zeros_like(y)
        return tx, y, 2.0 if case == "nothing_kept" else 0.01
    if case == "census":
        rows, y = _census()
        return rows, y, 0.002
    if case == "wide_vocab":
        # 70 walked items a kept one: most items are in one row each
        tx, y = _bern(n=600)
        return [t + [f"u{i}.{j}" for j in range(3)] for i, t in
                enumerate(tx)], y, 0.01
    make_rows, y, _ = _edge_table(case)
    return make_rows(), y, 0.5 / len(y)


_ROUTE_CASES = ["bernoulli", "repeats", "empty_rows", "no_rare",
                "nothing_kept", "equal_hashables", "vocab_65", "strings",
                "census", "wide_vocab"]


def _traced(fn):
    """-> (fn(), the spans it filed)."""
    obs.configure(tracing=True)
    try:
        TRACER.reset()
        out = fn()
        return out, [s for s in TRACER.spans() if s.name != "py.gc"]
    finally:
        obs.configure(tracing=False)


def _attrs(spans, name):
    (span,) = [s for s in spans if s.name == name]
    return span.attrs


def _jax_encoding(rows, y, min_support, monkeypatch):
    """-> (the JAX package's kept items, its DenseDB over them): its passes
    1 and 2 alone, no antecedent mine."""
    monkeypatch.setattr("repro.mining.dense.dense_mine_frequent",
                        lambda *a, **kw: {})
    want = jm.minority_report_dense(rows, y, min_support=min_support,
                                    min_confidence=0.5, streaming=False)
    y01 = [int(v == 1) for v in y]
    return want.items_kept, jm.DenseDB.encode(
        rows, classes=y01, n_classes=2,
        vocab=jm.ItemVocab(tuple(want.items_kept)))


def _check_device_route(case, dev, monkeypatch):
    """The MRA's encode after the walk on ``dev`` (``_scan_on_device`` then
    ``_dense_on_device``) gives the JAX package's DB and the numpy route's
    byte for byte, rows in the same order, the same kept items (down to the
    objects: the numpy route's), the numpy route's distinct pairs for a
    streaming pass 2 and its ``mra.scan`` and ``encode.dedup`` attributes;
    its spans come in the order upload, scan, bitmap, dedup."""
    rows, y, min_support = _route_case(case)
    (db, kept, n_rare), host = _traced(lambda: tm.mra_encode(
        rows, y, min_support=min_support, streaming=False, device=CPU))
    assert _attrs(host, "mra.encode")["route"] == "host"
    rare = np.asarray(y) == 1

    def on_device():
        scan = tdense._scan_on_device(rows, rare, min_support, dev)
        vocab = tm.ItemVocab(tuple(scan.items_kept))
        return scan, tdense._dense_on_device(scan, vocab, dev)

    (scan, got), dev_spans = _traced(on_device)
    assert isinstance(db, tm.DenseDB) and isinstance(got, tm.DenseDB)
    assert got.bits.device.type == got.weights.device.type == dev.type
    bits, weights = got.bits.cpu(), got.weights.cpu()
    assert bits.dtype == db.bits.dtype == torch.uint32
    assert weights.dtype == db.weights.dtype == torch.int32
    assert bits.shape == db.bits.shape
    assert bits.numpy().tobytes() == db.bits.numpy().tobytes()
    assert weights.numpy().tobytes() == db.weights.numpy().tobytes()
    jkept, jdb = _jax_encoding(rows, y, min_support, monkeypatch)
    assert bits.numpy().tobytes() == np.asarray(jdb.bits).tobytes()
    assert weights.numpy().tobytes() == np.asarray(jdb.weights).tobytes()
    assert _typed(scan.items_kept) == _typed(jkept)
    assert (got.n_rows, got.n_classes) == (db.n_rows, db.n_classes)
    assert got.vocab == db.vocab
    assert len(scan.items_kept) == len(kept)
    assert all(a is b for a, b in zip(scan.items_kept, kept))
    assert n_rare == int(rare.sum())
    assert bool(kept) == (case not in ("no_rare", "nothing_kept"))
    want = tdense._scan_on_host(rows, rare, min_support).flat()
    pairs = scan.flat()
    assert np.array_equal(pairs.ids, want.ids)
    assert np.array_equal(pairs.rows, want.rows)
    assert pairs.n_rows == want.n_rows and pairs.items == want.items
    for name in ("mra.scan", "encode.dedup"):
        assert _attrs(dev_spans, name) == _attrs(host, name)
    assert [s.name for s in dev_spans] == ["encode.upload", "mra.scan",
                                           "encode.bitmap", "encode.dedup"]


@pytest.mark.parametrize("case", _ROUTE_CASES)
def test_mra_encode_device_route_equals_host_route(case, monkeypatch):
    """The device route's plain PyTorch version (``kernels/mra_encode/
    ref.py``, the route a CUDA device takes, run here on the CPU)."""
    _check_device_route(case, CPU, monkeypatch)


@pytest.mark.parametrize("bad", ["ids_dtype", "offsets_dtype", "rare_dtype",
                                 "cols_dtype", "perm_length"])
def test_mra_encode_kernels_refuse_bad_buffers(bad):
    """The encode kernels read raw pointers: their wrappers refuse a tensor
    of another type or length before any launch."""
    from repro_torch.kernels import mra_encode as kernels
    ids = torch.tensor([1, 0, 1], dtype=torch.int32)
    offsets = torch.tensor([0, 3], dtype=torch.int64)
    rare = torch.ones(1, dtype=torch.uint8)
    counts = kernels.count_rows(ids, offsets, rare, 2)
    assert counts.tolist() == [[1, 1], [1, 1], [1, 1]]
    assert ids.tolist() == [0, 1, 1]
    cols = torch.tensor([1, -1], dtype=torch.int32)
    words, wkeys = kernels.pack_rows(ids, offsets, cols, 1)
    assert words.tolist() == [[2]]
    perm = torch.zeros(1, dtype=torch.int64)
    calls = {
        "ids_dtype": lambda: kernels.count_rows(ids.long(), offsets, rare, 2),
        "offsets_dtype": lambda: kernels.pack_rows(ids, offsets.int(), cols,
                                                   1),
        "rare_dtype": lambda: kernels.count_rows(ids, offsets, rare.bool(), 2),
        "cols_dtype": lambda: kernels.pack_rows(ids, offsets, cols.long(), 1),
        "perm_length": lambda: kernels.row_heads(words, perm[:0]),
    }
    with pytest.raises(ValueError):
        calls[bad]()


@pytest.mark.cuda
@pytest.mark.parametrize("case", _ROUTE_CASES)
def test_cuda_mra_encode_device_route_equals_host_route(case, monkeypatch):
    """The device route's kernels (``kernels/mra_encode``) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    _check_device_route(case, torch.device("cuda"), monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bernoulli", "repeats", "empty_rows",
                                  "vocab_65", "census", "wide_vocab"])
def test_cuda_mra_encode_kernels_match_plain_version(case):
    """Each encode kernel on the card gives its plain PyTorch version's
    output (``ref.py``) on the same card tensors, word for word."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.kernels.mra_encode import ops, ref
    rows, y, min_support = _route_case(case)
    dev = torch.device("cuda")
    walk = walk_rows(rows)
    offsets = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(walk.lengths)]).astype(np.int64)).to(dev)
    ids = torch.from_numpy(walk.ids).to(dev)
    rare = torch.from_numpy((np.asarray(y) == 1).view(np.uint8)).to(dev)
    want_ids = ids.clone()
    want = ref.count_rows_ref(want_ids, offsets, rare, len(walk.items))
    assert torch.equal(ops.count_rows(ids, offsets, rare, len(walk.items)),
                       want)
    assert torch.equal(ids, want_ids)
    # every third walked id a column, in reverse walk order, over 3 words
    n_ids = len(walk.items)
    cols = torch.full((n_ids,), -1, dtype=torch.int32)
    chosen = torch.arange(n_ids - 1, -1, -3)[:96]
    cols[chosen] = torch.arange(chosen.numel(), dtype=torch.int32)
    cols = cols.to(dev)
    words, wkeys = ops.pack_rows(ids, offsets, cols, 3)
    rwords, rkeys = ref.pack_rows_ref(ids, offsets, cols, 3)
    assert torch.equal(words, rwords) and torch.equal(wkeys, rkeys)
    perm = torch.argsort(wkeys[1], stable=True)
    perm = perm[torch.argsort(wkeys[0][perm], stable=True)]
    head = ops.row_heads(words, perm)
    assert torch.equal(head, ref.row_heads_ref(words, perm))
    run = head.cumsum(0, dtype=torch.int32)
    runs = int(run[-1])
    got = ops.gather_rows(words, perm, run, head, rare, runs)
    want = ref.gather_rows_ref(words, perm, run, head, rare, runs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_mra_encode_memory_follows_occurrences():
    """Pass 1 on the card holds the occurrences, not a bit per walked item
    and row: 200,000 rows over 400,000 walked items (a bit each would be
    10 GB) encode within 256 MiB, to the numpy route's DB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    tx, y = bernoulli_db(200_000, 12, 0.3, 0.05, 7)
    rows = [t + [2 * i + 100, 2 * i + 101] for i, t in enumerate(tx)]
    dev = torch.device("cuda")
    want, kept, _ = tm.mra_encode(rows, y, min_support=0.001,
                                  streaming=False, device=CPU)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    got, got_kept, _ = tm.mra_encode(rows, y, min_support=0.001,
                                     streaming=False, device=dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert peak < 256 * 2 ** 20, peak
    assert got_kept == kept and len(kept) == 12
    assert got.bits.cpu().numpy().tobytes() == want.bits.numpy().tobytes()
    assert got.weights.cpu().numpy().tobytes() == \
        want.weights.numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bernoulli", "census", "vocab_65"])
def test_cuda_minority_report_takes_the_device_route(name):
    """On the card a job's encode takes the device route, once a job, with
    its spans in the order upload, scan, bitmap, dedup, and the job gives
    the rule list and kept items of the JAX package's job and of the same
    job on the CPU; with ``use_kernel=False`` it takes the host route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    rows, y, _ = _route_case(name)
    params = dict(min_support={"bernoulli": 0.002, "census": 0.005,
                               "vocab_65": 0.01}[name], min_confidence=0.05)
    want = tm.minority_report_dense(rows, y, device=CPU, **params)
    jwant = jm.minority_report_dense(rows, y, **params)
    obs.reset()

    def routes():
        snap = obs.snapshot()
        return [obs.counter_value(snap, "mra_encode_route_total", route=r)
                for r in ("device", "host")]

    before = routes()
    got, spans = _traced(lambda: tm.minority_report_dense(
        rows, y, device="cuda", **params))
    assert routes() == [before[0] + 1, before[1]]
    assert got.rules and [astuple(r) for r in got.rules] == [
        astuple(r) for r in want.rules] == [astuple(r) for r in jwant.rules]
    assert _typed(got.items_kept) == _typed(jwant.items_kept)
    assert all(a is b for a, b in zip(got.items_kept, want.items_kept))
    assert len(got.items_kept) == len(want.items_kept)
    (enc,) = [s for s in spans if s.name == "mra.encode"]
    assert enc.attrs["route"] == "device"
    assert [s.name for s in spans if s.parent_id == enc.span_id] == [
        "encode.upload", "mra.scan", "encode.bitmap", "encode.dedup"]
    plain = tm.minority_report_dense(rows, y, device="cuda", use_kernel=False,
                                     **params)
    assert routes() == [before[0] + 1, before[1] + 1]
    assert [astuple(r) for r in plain.rules] == [astuple(r) for r in
                                                 want.rules]


_GEN_ITEMS = {"ints": list(range(14)),
              "strings": [f"i{j}" for j in range(14)],
              "mixed": [1, "1", 2, "b", 3.5, 10, "10", (1, 2), "a", 0]}


@pytest.mark.parametrize("items", sorted(_GEN_ITEMS))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_apriori_gen_prefix_join_matches_jax(items, k):
    """The port's candidate generator joins k-sets within prefix groups
    (the JAX package's joins every pair): the same candidates, in the same
    order, on random frequent families of every density."""
    import itertools

    from repro.core.apriori import apriori_gen as jax_apriori_gen
    from repro_torch.core.apriori import apriori_gen

    rng = np.random.default_rng(k)
    pool = list(itertools.combinations(_GEN_ITEMS[items], k))
    for size in (0, 1, 5, 30, len(pool) // 2, len(pool)):
        pick = rng.permutation(len(pool))[:size]
        fam = {frozenset(pool[i]) for i in pick}
        got = apriori_gen(fam, k)
        assert got == jax_apriori_gen(fam, k), (size, k)
        if size == len(pool):
            assert len(got) == len(list(itertools.combinations(
                _GEN_ITEMS[items], k + 1)))
