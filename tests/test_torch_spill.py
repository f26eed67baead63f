"""The port's disk tier (``repro_torch.mining.spill``) against the JAX
package's, on the same inputs, with exact equality: the spilled sweep
bit-identical to the streamed sweep, one dense pass and the JAX package's
sweep (prefetch on AND off), segment-grid resume parity, prefetch-hit
telemetry, manifest/open validation, the chooser's verdict, checkpoint and
hard-kill resume — and the on-disk format shared by both packages: each
opens the other's store, both write the same files, and a mid-level
checkpoint of one package's spilled mine resumes in the other's.  On the
CPU the port counts through the plain version."""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch
from _pbt import given, settings, strategies as st  # hypothesis or offline shim
from _testutil import random_problem as _random_problem

import repro.mining as jm
from repro.core import mine_frequent
from repro.kernels.itemset_count import itemset_counts_ref as jax_counts_ref
from repro.mining.distributed import MiningCheckpoint as JaxCheckpoint
from repro_torch import mining as tm
from repro_torch.mining import MiningCheckpoint, mine_frequent_backend
from repro_torch.mining.chooser import (TRAIT_SAMPLE_ROWS, DatasetTraits,
                                        backend_for_db, choose_backend)
from repro_torch.mining.spill import (MANIFEST_NAME, SpilledBackend,
                                      SpilledDB, spilled_counts)
from repro_torch.obs import REGISTRY, counter_total
from repro_torch.roofline import autotune as at

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


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


def _ref(tx, tgt, wts) -> np.ndarray:
    """One dense pass, by the JAX package's plain reference."""
    return np.asarray(jax_counts_ref(tx, tgt, wts))


def _spill_problem(tmp, rng_seed=0, n=300, k=17, w=3, c=2, chunk=64):
    """Random counting problem spilled to disk alongside its host arrays."""
    rng = np.random.default_rng(rng_seed)
    tx, tgt, wts = _random_problem(rng, n, k, w, c)
    vocab = tm.ItemVocab(tuple(range(32 * w)))
    db = SpilledDB.spill(vocab, tx, wts, n, c, str(tmp), chunk_rows=chunk,
                         device=CPU)
    return db, tx, tgt, wts


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------- roundtrip + facts
def test_spill_roundtrip_and_manifest_facts(tmp_path):
    db, tx, tgt, wts = _spill_problem(tmp_path, n=300, chunk=64)
    assert os.path.exists(os.path.join(str(tmp_path), MANIFEST_NAME))
    assert db.n_chunks == len(db.seg_rows) == -(-300 // 64)
    assert db.seg_rows == (64, 64, 64, 64, 44)
    assert db.n_unique == 300 and db.n_words == 3
    assert db.nbytes == 4 * (3 + 2) * 300
    assert db.device == CPU
    # materialization reproduces the host arrays
    np.testing.assert_array_equal(db.bits, tx)
    np.testing.assert_array_equal(db.weights, wts)
    # the trait-sampling hook: rows spread over every segment
    hb, hw = db.rows_at(np.arange(0, 300, 30))
    np.testing.assert_array_equal(hb, tx[::30])
    np.testing.assert_array_equal(hw, wts[::30])
    np.testing.assert_array_equal(db.rows_at(np.arange(300))[0], tx)

    # reopen from the manifest: same grid, same counts
    re = SpilledDB.open(str(tmp_path), device=CPU)
    assert re.seg_rows == db.seg_rows and re.chunk_rows == db.chunk_rows
    assert re.vocab.items == db.vocab.items
    np.testing.assert_array_equal(_np(re.counts(tgt)), _np(db.counts(tgt)))
    np.testing.assert_array_equal(_np(db.counts(tgt)), _ref(tx, tgt, wts))


def test_spill_from_streaming_keeps_grid(tmp_path):
    rng = np.random.default_rng(1)
    tx = _db(rng, 150, 12)
    sdb = tm.StreamingDB.encode(tx, chunk_rows=32, device=CPU)
    spl = SpilledDB.from_streaming(sdb, str(tmp_path))
    assert spl.chunk_rows == 32 and spl.n_chunks == sdb.n_chunks
    assert spl.device == CPU
    np.testing.assert_array_equal(spl.bits, sdb.bits)
    masks = tm.encode_targets([(a,) for a in sdb.vocab.items[:6]], sdb.vocab)
    np.testing.assert_array_equal(_np(spl.counts(masks)),
                                  _np(sdb.counts(masks)))


def test_spill_empty_and_single_segment(tmp_path):
    vocab = tm.ItemVocab((0, 1))
    empty = SpilledDB.spill(vocab, np.zeros((0, 1), np.uint32),
                            np.zeros((0, 1), np.int32), 0, 1,
                            str(tmp_path / "empty"), device=CPU)
    assert empty.n_chunks == 0 and empty.bits.shape == (0, 1)
    tgt = np.zeros((3, 1), np.uint32)
    assert tuple(empty.counts(tgt).shape) == (3, 1)
    assert (_np(empty.counts(tgt)) == 0).all()

    rng = np.random.default_rng(2)
    tx, tgt, wts = _random_problem(rng, 40, 5, 1, 1)
    one = SpilledDB.spill(tm.ItemVocab(tuple(range(32))), tx, wts, 40, 1,
                          str(tmp_path / "one"), chunk_rows=4096, device=CPU)
    assert one.n_chunks == 1   # single segment: no prefetch thread
    np.testing.assert_array_equal(_np(one.counts(tgt)), _ref(tx, tgt, wts))


def test_spill_validation_errors(tmp_path):
    vocab = tm.ItemVocab((("a", 1), ("b", 2)))  # tuples don't JSON-round-trip
    with pytest.raises(TypeError):
        SpilledDB.spill(vocab, np.zeros((2, 1), np.uint32),
                        np.ones((2, 1), np.int32), 2, 1, str(tmp_path / "t"),
                        device=CPU)

    # int32 overflow guard (same contract as the streaming sweep)
    with pytest.raises(OverflowError):
        SpilledDB.spill(tm.ItemVocab((0,)), np.zeros((2, 1), np.uint32),
                        np.full((2, 1), 1 << 30, np.int32), 2, 1,
                        str(tmp_path / "o"), device=CPU)

    db, _, tgt, _ = _spill_problem(tmp_path / "g", chunk=64)
    with pytest.raises(ValueError):      # immutable on-disk grid
        spilled_counts(db, tgt, chunk_rows=32)

    # torn store: manifest lists a segment that is gone
    os.remove(os.path.join(db.directory, "seg00002.bits.npy"))
    with pytest.raises(FileNotFoundError):
        SpilledDB.open(db.directory, device=CPU)

    # unknown format fails loudly
    bad = tmp_path / "bad"
    os.makedirs(str(bad))
    with open(os.path.join(str(bad), MANIFEST_NAME), "w") as f:
        json.dump({"format": "not-a-spill"}, f)
    with pytest.raises(ValueError):
        SpilledDB.open(str(bad), device=CPU)

    # a truncated segment: the manifest's row count disagrees
    db2, _, _, _ = _spill_problem(tmp_path / "trunc", chunk=64)
    bp = os.path.join(db2.directory, "seg00001.bits.npy")
    np.save(bp, np.load(bp)[:10])
    with pytest.raises(ValueError, match="manifest says 64 rows"):
        SpilledDB.open(db2.directory, device=CPU)


# ------------------------------------------------- bit-identical counting
@pytest.mark.parametrize("chunk,prefetch", [(7, True), (64, True), (64, False),
                                            (300, True), (10_000, False)])
def test_spilled_counts_bit_identical(tmp_path, chunk, prefetch):
    db, tx, tgt, wts = _spill_problem(tmp_path, rng_seed=chunk, chunk=chunk)
    got = _np(spilled_counts(db, tgt, prefetch=prefetch))
    stream = _np(tm.streaming_counts(tx, tgt, wts, chunk_rows=chunk,
                                     device=CPU))
    jdb = jm.SpilledDB.open(str(tmp_path))
    jgot = np.asarray(jm.spilled_counts(jdb, tgt, prefetch=prefetch))
    np.testing.assert_array_equal(got, stream)
    np.testing.assert_array_equal(got, _ref(tx, tgt, wts))
    np.testing.assert_array_equal(got, jgot)


@settings(max_examples=10, deadline=None)
@given(
    st.integers(min_value=1, max_value=150),    # n
    st.integers(min_value=1, max_value=12),     # k
    st.integers(min_value=1, max_value=3),      # w
    st.integers(min_value=1, max_value=3),      # c
    st.integers(min_value=1, max_value=200),    # chunk_rows
    st.sampled_from([True, False]),             # prefetch
    st.integers(min_value=0, max_value=2 ** 31 - 1),
)
def test_spilled_property_random(n, k, w, c, chunk, prefetch, seed):
    rng = np.random.default_rng(seed)
    tx, tgt, wts = _random_problem(rng, n, k, w, c)
    d = tempfile.mkdtemp(prefix="repro-spill-test-")
    try:
        db = SpilledDB.spill(tm.ItemVocab(tuple(range(32 * w))), tx, wts,
                             n, c, d, chunk_rows=chunk, device=CPU)
        got = _np(spilled_counts(db, tgt, prefetch=prefetch))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    np.testing.assert_array_equal(got, _ref(tx, tgt, wts))


def test_spilled_counts_resume_parity(tmp_path):
    """init/start_chunk/on_chunk resume == one sweep (the checkpoint seam),
    and the hook's accumulators equal the JAX package's chunk by chunk."""
    db, tx, tgt, wts = _spill_problem(tmp_path, rng_seed=5, chunk=48)
    full = _np(spilled_counts(db, tgt))
    seen, jseen = {}, {}
    spilled_counts(db, tgt, on_chunk=lambda j, acc: seen.update({j: acc}))
    jm.spilled_counts(jm.SpilledDB.open(str(tmp_path)), tgt,
                      on_chunk=lambda j, acc: jseen.update(
                          {j: np.asarray(acc)}))
    assert sorted(seen) == sorted(jseen) == list(range(db.n_chunks))
    for j in seen:
        assert isinstance(seen[j], np.ndarray)
        np.testing.assert_array_equal(seen[j], jseen[j])
    resumed = _np(spilled_counts(db, tgt, start_chunk=2, init=seen[1]))
    np.testing.assert_array_equal(resumed, full)
    # start past the last segment: the init accumulator comes back untouched
    done = _np(spilled_counts(db, tgt, start_chunk=db.n_chunks, init=full))
    np.testing.assert_array_equal(done, full)


# ------------------------------------------------------ prefetch telemetry
def test_prefetch_hit_accounting(tmp_path):
    db, _, tgt, _ = _spill_problem(tmp_path, rng_seed=6, n=400, chunk=32)
    assert db.n_chunks >= 8
    before = REGISTRY.snapshot()

    spilled_counts(db, tgt, prefetch=True)
    after = REGISTRY.snapshot()
    handoffs = ((counter_total(after, "spill_prefetch_hits_total")
                 + counter_total(after, "spill_prefetch_misses_total"))
                - (counter_total(before, "spill_prefetch_hits_total")
                   + counter_total(before, "spill_prefetch_misses_total")))
    assert handoffs == db.n_chunks          # one handoff per segment
    assert "spill_prefetch_hit_ratio" in after.get("gauges", {})
    read = (counter_total(after, "spill_bytes_read_total")
            - counter_total(before, "spill_bytes_read_total"))
    assert read == db.nbytes                # every segment read once

    # synchronous ablation performs no prefetcher handoffs at all
    base = REGISTRY.snapshot()
    spilled_counts(db, tgt, prefetch=False)
    sync = REGISTRY.snapshot()
    for name in ("spill_prefetch_hits_total", "spill_prefetch_misses_total"):
        assert counter_total(sync, name) == counter_total(base, name)


def test_prefetch_error_surfaces_on_consumer(tmp_path):
    db, _, tgt, _ = _spill_problem(tmp_path, rng_seed=7, n=300, chunk=32)
    os.remove(os.path.join(db.directory, "seg00003.bits.npy"))
    before = counter_total(REGISTRY.snapshot(), "spill_prefetch_errors_total")
    with pytest.raises(FileNotFoundError):
        spilled_counts(db, tgt, prefetch=True)
    assert counter_total(REGISTRY.snapshot(),
                         "spill_prefetch_errors_total") == before + 1
    # the synchronous path raises the same error on the consumer directly
    with pytest.raises(FileNotFoundError):
        spilled_counts(db, tgt, prefetch=False)


# ----------------------------------------------------- backend + chooser
def test_spilled_backend_mine_matches_host(tmp_path):
    rng = np.random.default_rng(8)
    tx = _db(rng, 200, 10, p=0.4)
    want = mine_frequent(tx, 40)
    sdb = tm.StreamingDB.encode(tx, chunk_rows=16, device=CPU)
    spl = SpilledDB.from_streaming(sdb, str(tmp_path))
    backend = SpilledBackend(spl)
    assert backend.n_count_chunks == spl.n_chunks
    jbackend = jm.SpilledBackend(jm.SpilledDB.open(str(tmp_path)))
    assert backend.chunk_signature() == jbackend.chunk_signature()
    assert backend.chunk_signature()["backend"] == "spilled"
    got = mine_frequent_backend(backend, 40)
    assert got == want == jm.mine_frequent_backend(jbackend, 40)
    # traits report the TRUE on-disk footprint, not the sample's
    t = backend.traits()
    assert t.nbytes == spl.nbytes and t.n_unique == spl.n_unique
    # a deliberate difference: the port samples rows over every segment
    # (all 200 here, so its traits are the whole DB's); the JAX package
    # measures the head segment's 16 rows only
    assert t == DatasetTraits.of_db(sdb)
    jt = jbackend.traits()
    seg0 = DatasetTraits.measure(*spl.segment(0), spl.vocab, spl.n_rows)
    assert (jt.density, jt.skew) == (seg0.density, seg0.skew) \
        != (t.density, t.skew)


def test_chooser_spill_verdict_and_backend_for_db(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    tx = _db(rng, 120, 10, p=0.4)
    ddb = tm.DenseDB.encode(tx, device=CPU)
    traits = DatasetTraits.of_db(ddb)
    jtraits = jm.DatasetTraits.of_db(jm.DenseDB.encode(tx))
    # over-budget: disk tier wins (opt-in: threshold must be passed)
    c = choose_backend(traits, spill_threshold_bytes=64)
    jc = jm.choose_backend(jtraits, spill_threshold_bytes=64)
    assert c.name == "spilled" and "spill budget" in c.reason
    assert (c.name, c.reason) == (jc.name, jc.reason)
    assert choose_backend(traits).name != "spilled"   # no budget, no spill

    monkeypatch.setenv("REPRO_TORCH_SPILL_DIR", str(tmp_path / "auto"))
    backend, choice = backend_for_db(ddb, spill_threshold_bytes=64)
    assert choice.name == "spilled" and isinstance(backend, SpilledBackend)
    assert backend.db.directory == str(tmp_path / "auto")
    assert os.path.exists(str(tmp_path / "auto" / MANIFEST_NAME))
    assert backend.db.device == CPU           # counts on the DB's device
    want = mine_frequent(tx, 30)
    assert mine_frequent_backend(backend, 30) == want
    # a SpilledDB is not spilled again
    again, choice2 = backend_for_db(backend.db, name="spilled")
    assert again.db is backend.db and choice2.name == "spilled"


def test_spilled_backend_checkpoint_kill_resume(tmp_path):
    """In-process preemption mid-level; the resume reopens the store FROM
    DISK (SpilledDB.open) — segment files + checkpoint are the durable
    state, exactly the kill/resume contract of the streaming engine."""
    rng = np.random.default_rng(10)
    tx = _db(rng, 200, 10, p=0.4)
    want = mine_frequent(tx, 40)
    sdb = tm.StreamingDB.encode(tx, chunk_rows=16, device=CPU)
    spl = SpilledDB.from_streaming(sdb, str(tmp_path / "seg"))
    assert spl.n_chunks >= 4
    ckpt = MiningCheckpoint(str(tmp_path / "mine.json"))
    calls = []

    def die_mid_level_2(level, chunk):
        calls.append((level, chunk))
        if len(calls) == spl.n_chunks + 3:
            raise _Preempted()

    with pytest.raises(_Preempted):
        mine_frequent_backend(SpilledBackend(spl), 40, checkpoint=ckpt,
                              on_chunk=die_mid_level_2)

    state = json.load(open(str(tmp_path / "mine.json")))
    assert state["partial"]["next_chunk"] == 3

    reopened = SpilledDB.open(str(tmp_path / "seg"), device=CPU)
    resumed = []
    got = mine_frequent_backend(SpilledBackend(reopened), 40, checkpoint=ckpt,
                                on_chunk=lambda l, c: resumed.append((l, c)))
    assert got == want
    assert resumed[0][1] == 3                # resumed mid-level at chunk 3
    assert len(resumed) < len(calls) + spl.n_chunks


_KILL_SCRIPT = textwrap.dedent("""
    import os, sys
    from repro_torch.mining import (MiningCheckpoint, SpilledBackend,
                                    SpilledDB, mine_frequent_backend)

    seg_dir, ckpt_path, min_count = sys.argv[1], sys.argv[2], int(sys.argv[3])
    db = SpilledDB.open(seg_dir, device="cpu")
    calls = []

    def hard_kill(level, chunk):
        calls.append((level, chunk))
        if len(calls) == db.n_chunks + 3:
            os._exit(17)       # SIGKILL-equivalent: no finally, no flush

    mine_frequent_backend(SpilledBackend(db), min_count,
                          checkpoint=MiningCheckpoint(ckpt_path),
                          on_chunk=hard_kill)
    os._exit(0)                # must not be reached
""")


def test_spilled_hard_kill_process_resume(tmp_path):
    """Process death mid-level (os._exit: no cleanup handlers run): the
    parent reopens the SAME on-disk segments + checkpoint and finishes the
    mine bit-identically to the never-killed run."""
    rng = np.random.default_rng(11)
    tx = _db(rng, 200, 10, p=0.4)
    want = mine_frequent(tx, 40)
    sdb = tm.StreamingDB.encode(tx, chunk_rows=16, device=CPU)
    spl = SpilledDB.from_streaming(sdb, str(tmp_path / "seg"))
    assert spl.n_chunks >= 4
    ckpt_path = str(tmp_path / "mine.json")

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT, str(tmp_path / "seg"),
         ckpt_path, "40"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 17, proc.stderr   # it died where we told it to

    state = json.load(open(ckpt_path))
    assert state["partial"] is not None         # durable mid-level partial

    reopened = SpilledDB.open(str(tmp_path / "seg"), device=CPU)
    got = mine_frequent_backend(SpilledBackend(reopened), 40,
                                checkpoint=MiningCheckpoint(ckpt_path))
    assert got == want


# ------------------------------------------- one on-disk format, two packages
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_opens_the_others_store(tmp_path, writer):
    """One store, written by either package: both open it, and their
    spilled sweeps (prefetch on and off) are integer for integer equal."""
    rng = np.random.default_rng(12)
    tx, tgt, wts = _random_problem(rng, 500, 23, 2, 3)
    items = tuple(range(64))
    d = str(tmp_path / "store")
    if writer == "jax":
        jm.SpilledDB.spill(jm.ItemVocab(items), tx, wts, 500, 3, d,
                           chunk_rows=96)
    else:
        SpilledDB.spill(tm.ItemVocab(items), tx, wts, 500, 3, d,
                        chunk_rows=96, device=CPU)
    tdb = SpilledDB.open(d, device=CPU)
    jdb = jm.SpilledDB.open(d)
    assert (tdb.seg_rows, tdb.chunk_rows, tdb.n_words, tdb.vocab.items) == \
        (jdb.seg_rows, jdb.chunk_rows, jdb.n_words, jdb.vocab.items)
    np.testing.assert_array_equal(tdb.bits, jdb.bits)
    np.testing.assert_array_equal(tdb.weights, jdb.weights)
    want = _ref(tx, tgt, wts)
    for prefetch in (True, False):
        got = _np(spilled_counts(tdb, tgt, prefetch=prefetch))
        jgot = np.asarray(jm.spilled_counts(jdb, tgt, prefetch=prefetch))
        np.testing.assert_array_equal(got, jgot)
        np.testing.assert_array_equal(got, want)


def test_both_packages_write_the_same_store(tmp_path):
    """The same arrays spilled by each package give byte-identical segment
    files and the same manifest (``repro-spill-v1``, the same keys)."""
    rng = np.random.default_rng(13)
    tx, _, wts = _random_problem(rng, 333, 4, 2, 2)
    items = tuple(f"i{a}" for a in range(64))
    SpilledDB.spill(tm.ItemVocab(items), tx, wts, 400, 2,
                    str(tmp_path / "t"), chunk_rows=100, device=CPU)
    jm.SpilledDB.spill(jm.ItemVocab(items), tx, wts, 400, 2,
                       str(tmp_path / "j"), chunk_rows=100)
    names = sorted(os.listdir(str(tmp_path / "t")))
    assert names == sorted(os.listdir(str(tmp_path / "j")))
    assert names == [MANIFEST_NAME] + [f"seg{j:05d}.{kind}.npy"
                                       for j in range(4)
                                       for kind in ("bits", "w")]
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    m = json.loads((tmp_path / "t" / MANIFEST_NAME).read_text())
    assert list(m) == ["format", "n_rows", "n_classes", "chunk_rows",
                       "n_words", "seg_rows", "items", "class_totals"]
    assert m["format"] == "repro-spill-v1" and m["seg_rows"] == [100] * 3 + [33]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_spilled_checkpoint_resumes_across_packages(tmp_path, writer):
    """A spilled mine killed mid-level by one package resumes in the other
    from the same segment files and checkpoint, at the next segment."""
    rng = np.random.default_rng(14)
    tx = _db(rng, 240, 10, p=0.4)
    want = mine_frequent(tx, 40)
    sdb = tm.StreamingDB.encode(tx, chunk_rows=16, device=CPU)
    seg = str(tmp_path / "seg")
    SpilledDB.from_streaming(sdb, seg)
    path = str(tmp_path / "mine.json")
    calls = []

    def die(level, chunk):
        calls.append((level, chunk))
        if level == 2 and chunk == 4:
            raise _Preempted()

    if writer == "jax":
        killed = jm.SpilledBackend(jm.SpilledDB.open(seg))
        run, ck = jm.mine_frequent_backend, JaxCheckpoint(path)
        resume = SpilledBackend(SpilledDB.open(seg, device=CPU))
        rerun, rck = mine_frequent_backend, MiningCheckpoint(path)
    else:
        killed = SpilledBackend(SpilledDB.open(seg, device=CPU))
        run, ck = mine_frequent_backend, MiningCheckpoint(path)
        resume = jm.SpilledBackend(jm.SpilledDB.open(seg))
        rerun, rck = jm.mine_frequent_backend, JaxCheckpoint(path)
    with pytest.raises(_Preempted):
        run(killed, 40, checkpoint=ck, on_chunk=die)
    state = json.load(open(path))
    assert state["partial"]["level"] == 2
    assert state["partial"]["next_chunk"] == 5
    assert state["partial"]["backend"] == "spilled"
    resumed = []
    got = rerun(resume, 40, checkpoint=rck,
                on_chunk=lambda l, c: resumed.append((l, c)))
    assert got == want
    assert tuple(resumed[0]) == (2, 5)       # the next segment, not chunk 0


# --------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_cuda_spilled_sweep_matches_plain_version(tmp_path, prefetch):
    """The staging ring on the card (pinned buffers, copy stream, events):
    more segments than slots, a ragged last one, resumed mid-sweep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from repro_torch.kernels.itemset_count import ops

    rng = np.random.default_rng(15)
    tx, tgt, wts = _random_problem(rng, 5000, 40, 2, 2)
    db = SpilledDB.spill(tm.ItemVocab(tuple(range(64))), tx, wts, 5000, 2,
                         str(tmp_path), chunk_rows=384, device="cuda")
    assert db.n_chunks > 8 and db.seg_rows[-1] != 384
    before = ops.KERNEL_LAUNCHES_INTO
    seen = {}
    got = spilled_counts(db, tgt, prefetch=prefetch,
                         on_chunk=lambda j, acc: seen.update({j: acc}))
    assert ops.KERNEL_LAUNCHES_INTO == before + db.n_chunks
    want = _ref(tx, tgt, wts)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    resumed = spilled_counts(db, tgt, prefetch=prefetch, start_chunk=5,
                             init=seen[4])
    np.testing.assert_array_equal(resumed.cpu().numpy(), want)


# ----------------------------------- the interrupted re-spill (ROADMAP §3.4)
class _Killed(Exception):
    pass


def _kill_after(monkeypatch, module, saves):
    """Make ``module``'s segment writer die after ``saves`` files: a spill
    killed part way through its segments."""
    real = module._atomic_save
    done = [0]

    def save(path, arr):
        if done[0] == saves:
            raise _Killed(path)
        real(path, arr)
        done[0] += 1

    monkeypatch.setattr(module, "_atomic_save", save)


def test_interrupted_respill_is_refused_by_open(tmp_path, monkeypatch):
    """Spill A (4,096 rows in four 1,024-row segments), then spill B of the
    same shape into the same directory and kill it after B's first
    segment.  The JAX package still opens the directory and counts a mix
    of B's segment 0 and A's segments 1-3; the port removed A's manifest
    before writing, so its ``open`` refuses the directory (a deliberate
    difference), and a finished re-spill opens as B."""
    import repro.mining.spill as jspill
    import repro_torch.mining.spill as tspill

    rng = np.random.default_rng(21)
    a_tx, tgt, a_w = _random_problem(rng, 4096, 9, 2, 2)
    b_tx, _, b_w = _random_problem(rng, 4096, 9, 2, 2)
    vocab, jvocab = tm.ItemVocab(tuple(range(64))), jm.ItemVocab(
        tuple(range(64)))
    want_a, want_b = _ref(a_tx, tgt, a_w), _ref(b_tx, tgt, b_w)
    mixed = _ref(np.concatenate([b_tx[:1024], a_tx[1024:]]), tgt,
                 np.concatenate([b_w[:1024], a_w[1024:]]))
    assert not np.array_equal(mixed, want_a)
    assert not np.array_equal(mixed, want_b)

    # the JAX package: the torn store opens and miscounts
    jdir = str(tmp_path / "jax")
    jm.SpilledDB.spill(jvocab, a_tx, a_w, 4096, 2, jdir, chunk_rows=1024)
    with monkeypatch.context() as m:
        _kill_after(m, jspill, 2)
        with pytest.raises(_Killed):
            jm.SpilledDB.spill(jvocab, b_tx, b_w, 4096, 2, jdir,
                               chunk_rows=1024)
    torn = jm.SpilledDB.open(jdir)
    np.testing.assert_array_equal(np.asarray(jm.spilled_counts(torn, tgt)),
                                  mixed)

    # the port: no manifest survives the interrupted re-spill
    tdir = str(tmp_path / "torch")
    SpilledDB.spill(vocab, a_tx, a_w, 4096, 2, tdir, chunk_rows=1024,
                    device=CPU)
    with monkeypatch.context() as m:
        _kill_after(m, tspill, 2)
        with pytest.raises(_Killed):
            SpilledDB.spill(vocab, b_tx, b_w, 4096, 2, tdir,
                            chunk_rows=1024, device=CPU)
    assert not os.path.exists(os.path.join(tdir, MANIFEST_NAME))
    with pytest.raises(FileNotFoundError):
        SpilledDB.open(tdir, device=CPU)
    # a re-spill that finishes is B, byte for byte the JAX package's B
    SpilledDB.spill(vocab, b_tx, b_w, 4096, 2, tdir, chunk_rows=1024,
                    device=CPU)
    re = SpilledDB.open(tdir, device=CPU)
    np.testing.assert_array_equal(_np(re.counts(tgt)), want_b)
    jm.SpilledDB.spill(jvocab, b_tx, b_w, 4096, 2, jdir, chunk_rows=1024)
    for name in sorted(os.listdir(tdir)):
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_open_checks_the_weights_files_rows(tmp_path):
    """A weights file whose row count disagrees with the manifest: the
    port's ``open`` refuses it; the JAX package's checks the bits files
    only and opens it (a deliberate difference)."""
    db, _, _, _ = _spill_problem(tmp_path / "s", chunk=64)
    wp = os.path.join(db.directory, "seg00001.w.npy")
    np.save(wp, np.load(wp)[:10])
    with pytest.raises(ValueError, match="seg00001.w.npy: manifest says 64"):
        SpilledDB.open(db.directory, device=CPU)
    assert jm.SpilledDB.open(db.directory).seg_rows == db.seg_rows


def test_spilled_store_traits_sample_every_segment(tmp_path):
    """A spilled ``VersionedDB`` base of 6,000 unique rows in 1,000-row
    segments plus a delta: the traits the count server's chooser reads are
    measured on rows spread over every segment and the delta — the same
    traits as the same rows in a dense store — where the JAX package's
    sample the head segment."""
    import repro.serve as js
    from repro_torch.serve import VersionedCountBackend, VersionedDB

    rng = np.random.default_rng(17)
    tx = _db(rng, 6000, 40, p=0.3)
    extra = _db(rng, 300, 44, p=0.3)
    kw = dict(classes=[int(rng.random() < 0.2) for _ in tx], n_classes=2,
              merge_ratio=1e9, device="cpu")
    spilled = VersionedDB(tx, chunk_rows=1000, spill_dir=str(tmp_path),
                          spill_threshold_bytes=0, **kw)
    dense = VersionedDB(tx, **kw)
    assert spilled.resident == "spilled" and spilled.base.n_chunks == 6
    assert spilled.base_rows > TRAIT_SAMPLE_ROWS
    for store in (spilled, dense):
        store.append(extra, classes=[0] * len(extra))
    got = VersionedCountBackend(spilled).traits()
    assert got == VersionedCountBackend(dense).traits()
    jstore = js.VersionedDB(tx, chunk_rows=1000,
                            spill_dir=str(tmp_path / "j"),
                            spill_threshold_bytes=0, classes=kw["classes"],
                            n_classes=2, merge_ratio=1e9)
    jstore.append(extra, classes=[0] * len(extra))
    jt = js.VersionedCountBackend(jstore).traits()
    assert (jt.n_unique, jt.nbytes) == (got.n_unique, got.nbytes)
    assert jt.density != got.density


# ---------------------------------------------------------------------------
# the spill root: generations no other store holds, temporary stores deleted
# (deliberate differences from the JAX package, ROADMAP §3)
# ---------------------------------------------------------------------------

SPILL_PROBES = [(0,), (1, 2), (3, 4, 5), (9,), (2, 7)]


def test_two_stores_over_one_spill_root_keep_their_generations(
        tmp_path, monkeypatch):
    """Two ``VersionedDB``s over one ``$REPRO_TORCH_SPILL_DIR`` spill into
    generations of their own and each reads back its own rows, through a
    compaction too; the JAX package's second store spills into the first
    one's ``gen00000`` and the first one no longer counts its rows."""
    import repro.serve as js
    from repro_torch.serve import VersionedDB

    root = tmp_path / "spill"
    monkeypatch.setenv("REPRO_TORCH_SPILL_DIR", str(root))
    rng = np.random.default_rng(21)
    tx_a, tx_b = _db(rng, 90, 10, p=0.4), _db(rng, 70, 10, p=0.6)
    want_a = VersionedDB(tx_a, device="cpu").counts(SPILL_PROBES)
    want_b = VersionedDB(tx_b, device="cpu").counts(SPILL_PROBES)
    a = VersionedDB(tx_a, spill=True, chunk_rows=16, device="cpu")
    b = VersionedDB(tx_b, spill=True, chunk_rows=16, device="cpu")
    assert a.resident == b.resident == "spilled"
    assert sorted(os.listdir(root)) == ["gen00000", "gen00001"]
    assert {a.base.directory, b.base.directory} == {
        str(root / "gen00000"), str(root / "gen00001")}
    np.testing.assert_array_equal(a.counts(SPILL_PROBES), want_a)
    np.testing.assert_array_equal(b.counts(SPILL_PROBES), want_b)
    # A compacts into a generation of its own and drops its old one
    extra = _db(rng, 30, 10, p=0.4)
    a.append(extra)
    a.compact()
    assert a.base.directory == str(root / "gen00002")
    assert sorted(os.listdir(root)) == ["gen00001", "gen00002"]
    np.testing.assert_array_equal(
        a.counts(SPILL_PROBES),
        VersionedDB(tx_a + extra, device="cpu").counts(SPILL_PROBES))
    np.testing.assert_array_equal(b.counts(SPILL_PROBES), want_b)
    a.close()
    b.close()

    # the reference: both stores in gen00000, the second over the first
    jroot = str(tmp_path / "jax")
    ja = js.VersionedDB(tx_a, spill=True, spill_dir=jroot, chunk_rows=16)
    jb = js.VersionedDB(tx_b, spill=True, spill_dir=jroot, chunk_rows=16)
    assert ja.base.directory == jb.base.directory == \
        os.path.join(jroot, "gen00000")
    np.testing.assert_array_equal(jb.counts(SPILL_PROBES), want_b)
    try:
        got = ja.counts(SPILL_PROBES)
    except Exception:       # its segments are another store's now
        got = None
    assert got is None or not np.array_equal(got, want_a)


def test_a_store_skips_generations_another_process_made(tmp_path):
    """A generation directory that exists already (another process's
    store, or a crashed one's) is never spilled into."""
    from repro_torch.serve import VersionedDB

    root = tmp_path / "spill"
    (root / "gen00000").mkdir(parents=True)
    (root / "gen00000" / "theirs").write_text("kept")
    rng = np.random.default_rng(22)
    tx = _db(rng, 60, 8, p=0.5)
    db = VersionedDB(tx, spill=True, spill_dir=str(root), chunk_rows=16,
                     device="cpu")
    assert db.base.directory == str(root / "gen00001")
    assert (root / "gen00000" / "theirs").read_text() == "kept"
    np.testing.assert_array_equal(
        db.counts(SPILL_PROBES),
        VersionedDB(tx, device="cpu").counts(SPILL_PROBES))
    db.close()


def test_backend_for_db_deletes_the_spill_directory_it_made(
        tmp_path, monkeypatch):
    """Without ``$REPRO_TORCH_SPILL_DIR``, ``backend_for_db(...,
    name="spilled")`` spills into a temporary directory that goes with the
    store: on ``close()`` or once the backend is garbage-collected.  A
    directory the caller names stays.  The JAX package's temporary
    directory stays behind."""
    import gc

    monkeypatch.delenv("REPRO_TORCH_SPILL_DIR", raising=False)
    monkeypatch.delenv("REPRO_SPILL_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def made():
        return sorted(p.name for p in tmp_path.glob("repro-spill-*"))

    rng = np.random.default_rng(23)
    tx = _db(rng, 120, 10, p=0.4)
    ddb = tm.DenseDB.encode(tx, device=CPU)
    backend, choice = tm.backend_for_db(ddb, name="spilled")
    assert choice.name == "spilled"
    assert made() == [os.path.basename(backend.db.directory)]
    assert mine_frequent_backend(backend, 30) == mine_frequent(tx, 30)
    del backend
    gc.collect()
    assert made() == []

    backend, _ = tm.backend_for_db(ddb, name="spilled")
    assert len(made()) == 1
    backend.close()
    assert made() == []

    monkeypatch.setenv("REPRO_TORCH_SPILL_DIR", str(tmp_path / "mine"))
    backend, _ = tm.backend_for_db(ddb, name="spilled")
    backend.close()
    del backend
    gc.collect()
    assert (tmp_path / "mine" / MANIFEST_NAME).exists()
    assert made() == []

    jb, _ = jm.backend_for_db(jm.DenseDB.encode(tx), name="spilled")
    del jb
    gc.collect()
    assert len(made()) == 1
