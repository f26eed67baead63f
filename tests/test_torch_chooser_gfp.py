"""The port's adaptive chooser and GFP device hybrid against the JAX
package's and the paper-faithful host GFP-growth, on the same inputs, with
exact equality: measured traits, verdicts and their reasons (with and
without a tuning table), GFP counts and flush counters, mines, kill/resume
across the two packages, and the reference's differential battery.  On the
CPU the port's kernel-sized blocks count through the plain version."""
import json
import types

import numpy as np
import pytest
import torch

import repro.mining as jm
from repro.core import TISTree as JaxTISTree
from repro.core.fptree import ItemOrder as JaxItemOrder
from repro.mining.distributed import MiningCheckpoint as JaxCheckpoint
from repro.roofline import autotune as jat
from repro_torch import mining as tm
from repro_torch.core import mine_frequent
from repro_torch.core.fptree import FPTree, ItemOrder
from repro_torch.core.gfp import gfp_growth
from repro_torch.core.incremental import ceil_count
from repro_torch.core.tis import TISTree
from repro_torch.mining import MiningCheckpoint
from repro_torch.roofline import autotune as at

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


def _random_tx(rng, n, m, p):
    return [[i for i in range(m) if rng.random() < p] for _ in range(n)]


def _random_multitude(rng, m, n_targets, max_len):
    """Targets over items 0..m+1; items m and m+1 occur in no transaction
    (the unknown-item contract)."""
    out = []
    for _ in range(n_targets):
        size = int(rng.integers(1, max_len + 1))
        out.append(sorted(rng.choice(m + 2, size=min(size, m + 2),
                                     replace=False).tolist()))
    return out


def _dbs(tx, classes=None, n_classes=None):
    """The same transactions encoded by both packages."""
    db = tm.DenseDB.encode(tx, classes=classes, n_classes=n_classes,
                           device=CPU)
    jdb = jm.DenseDB.encode(tx, classes=classes, n_classes=n_classes)
    assert db.vocab.items == jdb.vocab.items
    return db, jdb


def _tis(targets, vocab, tis_cls=TISTree, order_cls=ItemOrder):
    unknown = sorted({a for t in targets for a in t if a not in vocab},
                     key=repr)
    tis = tis_cls(order_cls(list(vocab.items) + unknown))
    for t in targets:
        tis.insert(t)
    tis.finalize()
    return tis


def _host_gfp(tx, classes, n_classes, vocab, targets):
    """The paper-faithful oracle: per class, a real FP-tree under the
    bitmap's arrangement order and a guided walk."""
    known = list(vocab.items)
    unknown = sorted({a for t in targets for a in t if a not in vocab},
                     key=repr)
    order = ItemOrder(known + unknown)
    out = {}
    for c in range(n_classes):
        fp = FPTree.build([t for t, y in zip(tx, classes) if y == c], order)
        tis = TISTree(order)
        for t in targets:
            tis.insert(t)
        tis.finalize()
        gfp_growth(tis, fp)
        for key, g in tis.as_dict("g_count").items():
            out.setdefault(key, np.zeros(n_classes, np.int32))[c] = g
    return out


def _traits(mod, **kw):
    base = dict(n_rows=10_000, n_unique=9_000, vocab_size=24, n_classes=1,
                nbytes=1 << 20, density=0.05, skew=1.5, dedup_ratio=0.9)
    base.update(kw)
    return mod.DatasetTraits(**base)


def _throughput_table(mod, overhead_us):
    entries = {}
    for n in (1024, 4096, 16384, 65536):
        us = overhead_us + 0.05 * n
        entries[f"n{n}_k256_w2_c2"] = {
            "block_k": 128, "block_n": 1024, "accum": "vpu_int32",
            "chunk_rows": 0, "us": us, "efficiency": 0.5,
            "chunk_candidates": {"0": us, "4096": us / 0.5}}
    return mod.table_from_dict({"schema": 1, "device_kind": "cpu",
                                "created": "", "entries": entries})


# -- the chooser -----------------------------------------------------------------

TRAIT_GRID = [
    {}, {"density": 0.5, "dedup_ratio": 0.3}, {"skew": 10.0},
    {"nbytes": 600 << 20, "density": 0.5, "dedup_ratio": 0.3, "skew": 10.0},
    {"n_rows": 500, "density": 0.5, "dedup_ratio": 0.3},
    {"n_rows": 5000}, {"n_rows": 9000, "skew": 4.0},
    {"density": 0.25, "dedup_ratio": 0.6}, {"density": 0.24,
                                            "dedup_ratio": 0.3},
    {"nbytes": 300 << 20}, {"skew": float("inf")},
]
CHOICE_KW = [{}, {"max_len": 2}, {"max_len": 4}, {"max_len": 3},
             {"mesh": types.SimpleNamespace(size=8)},
             {"mesh": types.SimpleNamespace(size=1)},
             {"spill_threshold_bytes": 1 << 20},
             {"tiny_rows": 20_000, "min_depth": 2}]


@pytest.mark.parametrize("tuned", [None, 400.0, 25.0])
def test_choose_backend_matches_jax(tuned):
    """Same verdict and the same reason on a grid of traits and options,
    with no table and under tables that move the derived thresholds."""
    if tuned is not None:
        at.set_active_table(_throughput_table(at, tuned))
        jat.set_active_table(_throughput_table(jat, tuned))
    names = set()
    for tkw in TRAIT_GRID:
        for ckw in CHOICE_KW:
            got = tm.choose_backend(_traits(tm, **tkw), **ckw)
            want = jm.choose_backend(_traits(jm, **tkw), **ckw)
            assert (got.name, got.reason) == (want.name, want.reason), \
                (tkw, ckw)
            names.add(got.name)
    assert names == {"dense", "gfp", "streaming", "distributed", "spilled"}


def test_decision_table_pins():
    def pick(**kw):
        mesh = kw.pop("mesh", None)
        max_len = kw.pop("max_len", 0)
        return tm.choose_backend(_traits(tm, **kw), mesh=mesh,
                                 max_len=max_len).name

    assert pick(density=0.5, dedup_ratio=0.3) == "gfp"
    assert pick(skew=10.0) == "gfp"
    assert pick() == "dense"
    assert pick(nbytes=600 << 20, density=0.5, dedup_ratio=0.3,
                skew=10.0) == "streaming"
    assert pick(n_rows=500, density=0.5, dedup_ratio=0.3) == "dense"
    assert pick(mesh=types.SimpleNamespace(size=8)) == "distributed"
    assert pick(density=0.5, dedup_ratio=0.3,
                mesh=types.SimpleNamespace(size=1)) == "gfp"
    assert pick(density=0.5, dedup_ratio=0.3, max_len=2) == "dense"
    assert pick(density=0.5, dedup_ratio=0.3, max_len=4) == "gfp"


@pytest.mark.parametrize("seed,n,m,p,classes", [
    (0, 4000, 12, 0.5, 1), (1, 700, 40, 0.1, 2), (2, 3000, 70, 0.3, 3),
    (3, 50, 5, 0.9, 2)])
def test_measured_traits_match_jax(seed, n, m, p, classes):
    rng = np.random.default_rng(seed)
    tx = _random_tx(rng, n, m, p)
    y = [int(rng.integers(0, classes)) for _ in tx]
    db, jdb = _dbs(tx, y, classes)
    got = tm.DatasetTraits.of_db(db)
    want = jm.DatasetTraits.of_db(jdb)
    assert tuple(vars(got).values()) == tuple(vars(want).values())
    # host arrays, device tensors and the backends' hooks measure the same
    assert tm.DatasetTraits.measure(db.bits.numpy(), db.weights.numpy(),
                                    db.vocab, n) == got
    assert tm.DenseBackend(db).traits() == got
    assert tm.StreamingBackend(tm.StreamingDB.from_dense(db)).traits() == got
    assert tm.GFPBackend(db).traits() == got


def test_measured_traits_sane():
    rng = np.random.default_rng(0)
    tx = _random_tx(rng, 4000, 12, 0.5)
    db = tm.DenseDB.encode(tx, device=CPU)
    t = tm.DatasetTraits.of_db(db)
    assert t.n_rows == 4000 and 0 < t.n_unique <= 4000
    assert t.vocab_size == 12 and 0.3 < t.density < 0.7
    assert t.skew >= 1.0 and t.dedup_ratio == t.n_unique / t.n_rows
    empty = tm.DatasetTraits.measure(np.zeros((0, 1), np.uint32),
                                     np.zeros((0, 1), np.int32), db.vocab, 0)
    assert (empty.density, empty.skew, empty.dedup_ratio) == (0.0, 1.0, 1.0)


def test_backend_for_db_constructs_choice_and_results_agree():
    rng = np.random.default_rng(1)
    tx = _random_tx(rng, 5000, 10, 0.5)
    db, jdb = _dbs(tx)
    want = mine_frequent(tx, 800)

    be, choice = tm.backend_for_db(db)
    jbe, jchoice = jm.backend_for_db(jdb)
    assert (choice.name, choice.reason) == (jchoice.name, jchoice.reason)
    assert choice.name == "gfp" and isinstance(be, tm.GFPBackend)
    assert be.device == CPU                   # counts on the DB's device
    forced_dense, cd = tm.backend_for_db(db, name="dense")
    forced_stream, cs = tm.backend_for_db(db, name="streaming")
    assert isinstance(forced_dense, tm.DenseBackend)
    assert isinstance(forced_stream, tm.StreamingBackend)
    assert forced_stream.db.device == CPU
    assert cd.name == "dense" and cs.name == "streaming" and cd.traits is None
    assert tm.mine_frequent_backend(be, 800) \
        == tm.mine_frequent_backend(forced_dense, 800) \
        == tm.mine_frequent_backend(forced_stream, 800) \
        == jm.mine_frequent_backend(jbe, 800) == want
    with pytest.raises(ValueError):
        tm.backend_for_db(db, name="bogus")


@pytest.mark.parametrize("name", ["distributed", "spilled"])
def test_backend_for_db_refuses_unported_engines(name, tmp_path, monkeypatch):
    """No engine is refused any more: the mesh runtime (on a one-rank gloo
    mesh) and the disk tier are built by name and mine what the dense
    backend mines, as the JAX package's do."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    rng = np.random.default_rng(4)
    tx = _random_tx(rng, 300, 9, 0.4)
    db, jdb = _dbs(tx)
    want = tm.mine_frequent_backend(tm.DenseBackend(db), 40)
    assert want == mine_frequent(tx, 40)
    monkeypatch.setenv("REPRO_TORCH_SPILL_DIR", str(tmp_path / "spill"))
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path / "jax"))
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        mesh = make_host_mesh(1, 1, device_type="cpu")
        be, choice = tm.backend_for_db(db, name=name, mesh=mesh)
        assert choice.name == name
        assert type(be).__name__ == {"distributed": "DistributedBackend",
                                     "spilled": "SpilledBackend"}[name]
        assert be.chunk_signature()["backend"] == name
        assert tm.mine_frequent_backend(be, 40) == want
    finally:
        dist.destroy_process_group()
    if name == "spilled":
        assert be.db.directory == str(tmp_path / "spill")
        jbe, _ = jm.backend_for_db(jdb, name=name)
        assert jbe.chunk_signature() == be.chunk_signature()


def test_auto_never_reaches_unported_engines_on_one_card():
    """Without a mesh and without a spill budget the verdict is one of the
    three engines the port builds."""
    for tkw in TRAIT_GRID:
        assert tm.choose_backend(_traits(tm, **tkw)).name in (
            "dense", "streaming", "gfp")


# -- the GFP hybrid ----------------------------------------------------------------

def _gfp_case(seed, n=350, m=11, p=0.45, classes=2, n_targets=60):
    rng = np.random.default_rng(seed)
    tx = _random_tx(rng, n, m, p)
    y = [int(rng.integers(0, classes)) for _ in tx]
    db, jdb = _dbs(tx, y, classes)
    targets = _random_multitude(rng, m, n_targets, max_len=5)
    known = [t for t in targets if all(a in db.vocab for a in t)]
    return tx, y, db, jdb, targets, tm.encode_targets(known, db.vocab)


@pytest.mark.parametrize("host_rows", [0, None, 64, 1 << 20])
@pytest.mark.parametrize("guide", [True, False])
def test_gfp_counts_and_flush_counters_match_jax(host_rows, guide):
    _, _, db, jdb, _, masks = _gfp_case(42, n=2500, m=12, p=0.5)
    b = tm.GFPBackend(db, host_rows=host_rows, guide=guide)
    jb = jm.GFPBackend(jdb, host_rows=host_rows, guide=guide)
    got, want = b.counts(masks), jb.counts(masks)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, tm.DenseBackend(db).counts(masks))
    assert (b.host_rows, b.host_blocks, b.kernel_launches,
            b.blocks_counted) == (jb.host_rows, jb.host_blocks,
                                  jb.kernel_launches, jb.blocks_counted)
    if host_rows == 0:
        assert b.kernel_launches > 0 and b.host_blocks == 0
    if host_rows is None:
        assert b.host_rows == 4096 and b.kernel_launches == 0


def test_gfp_host_rows_derive_from_the_table():
    at.set_active_table(_throughput_table(at, 1000.0))
    jat.set_active_table(_throughput_table(jat, 1000.0))
    _, _, db, jdb, _, _ = _gfp_case(3)
    b, jb = tm.GFPBackend(db), jm.GFPBackend(jdb)
    assert b.host_rows == jb.host_rows == at.derived_chooser_thresholds()[
        "gfp_host_rows"] > 4096


def test_gfp_kernel_blocks_count_on_the_backends_device(monkeypatch):
    """A kernel-sized block is copied to the backend's device and counted
    through the port's counting seam, whose accum resolves by the table."""
    import repro_torch.mining.gfp_backend as gb

    _, _, db, _, _, masks = _gfp_case(5)
    seen = []
    real = gb.itemset_counts

    def spy(tx, tgt, w, **kw):
        seen.append((tx.device, tgt.device, w.device, kw))
        return real(tx, tgt, w, **kw)

    monkeypatch.setattr(gb, "itemset_counts", spy)
    b = tm.GFPBackend(db, host_rows=0)
    b.counts(masks)
    assert len(seen) == b.kernel_launches > 0
    for tx_dev, tgt_dev, w_dev, kw in seen:
        assert (tx_dev, tgt_dev, w_dev) == (CPU, CPU, CPU)
        assert "accum" not in kw and "block_k" not in kw


def test_gfp_from_arrays_defaults_to_the_card():
    db = tm.DenseDB.encode([[1, 2], [2]], device=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.GFPBackend.from_arrays(db.vocab, db.bits.numpy(),
                                  db.weights.numpy(), 2, 1)
    b = tm.GFPBackend.from_arrays(db.vocab, db.bits.numpy(),
                                  db.weights.numpy(), 2, 1, device="cpu")
    assert b.device == CPU


@pytest.mark.parametrize("seed", range(8))
def test_gfp_differential_battery(seed):
    """Host GFP-growth oracle == dense == hybrid (default, kernel-only,
    unguided) in the port == the JAX package's hybrid, per class."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 120))
    m = int(rng.integers(2, 13))
    p = float(rng.uniform(0.1, 0.7))
    n_classes = int(rng.integers(1, 4))
    tx = _random_tx(rng, n, m, p)
    classes = [int(rng.integers(0, n_classes)) for _ in tx]
    targets = _random_multitude(rng, m, int(rng.integers(1, 25)), 4)
    db, jdb = _dbs(tx, classes, n_classes)
    tis = _tis(targets, db.vocab)
    oracle = _host_gfp(tx, classes, n_classes, db.vocab, targets)
    runs = [tm.dense_gfp_counts(tis, db),
            tm.gfp_multitude_counts(tis, db),
            tm.gfp_multitude_counts(tis, db, host_rows=0),
            tm.gfp_multitude_counts(tis, db, guide=False),
            jm.gfp_multitude_counts(_tis(targets, jdb.vocab, JaxTISTree,
                                         JaxItemOrder), jdb)]
    for run in runs:
        assert set(run) == set(oracle)
        for key in oracle:
            assert np.array_equal(np.asarray(run[key]), oracle[key]), key


def test_gfp_empty_multitude_and_empty_db():
    rng = np.random.default_rng(3)
    tx = _random_tx(rng, 60, 8, 0.4)
    db, _ = _dbs(tx)
    empty = TISTree(ItemOrder(list(db.vocab.items)))
    empty.insert([0, 1], target=False)
    empty.finalize()
    assert tm.gfp_multitude_counts(empty, db) == {}
    edb = tm.DenseDB.encode([], vocab=db.vocab, device=CPU)
    got = tm.gfp_multitude_counts(_tis([[0]], db.vocab), edb)
    assert all(np.array_equal(v, np.zeros(1, np.int32)) for v in got.values())
    assert tm.gfp_mine_frequent(edb, 1) == {}
    out = tm.GFPBackend(db).counts(np.zeros((0, db.vocab.n_words), np.uint32))
    assert out.shape == (0, 1)


def test_gfp_unknown_item_targets_count_zero():
    rng = np.random.default_rng(4)
    tx = _random_tx(rng, 80, 6, 0.5)
    db, _ = _dbs(tx)
    tis = _tis([[0, 99], [99], [1, 2]], db.vocab)
    got = tm.gfp_multitude_counts(tis, db)
    assert np.array_equal(got[(0, 99)], np.zeros(1, np.int32))
    assert np.array_equal(got[(99,)], np.zeros(1, np.int32))
    want = tm.dense_gfp_counts(tis, db)
    for k in got:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", range(5))
def test_gfp_mine_matches_jax_and_host(seed):
    rng = np.random.default_rng(seed)
    tx = _random_tx(rng, int(rng.integers(40, 200)), int(rng.integers(4, 10)),
                    float(rng.uniform(0.25, 0.6)))
    db, jdb = _dbs(tx)
    counts = sorted(mine_frequent(tx, 1).values())
    mc = counts[len(counts) // 2]              # an exactly-achieved count
    want = mine_frequent(tx, mc)
    assert ceil_count((mc / len(tx)) * len(tx)) == mc
    assert tm.gfp_mine_frequent(db, mc) == want == jm.gfp_mine_frequent(
        jdb, mc)
    assert tm.gfp_mine_frequent(db, mc, host_rows=0) == want


def test_gfp_class_column_parity():
    rng = np.random.default_rng(5)
    tx = _random_tx(rng, 260, 10, 0.4)
    y = [int(rng.random() < 0.3) for _ in tx]
    want = mine_frequent([t for t, c in zip(tx, y) if c == 1], 12)
    db, jdb = _dbs(tx, y, 2)
    assert tm.gfp_mine_frequent(db, 12, class_column=1) == want
    assert jm.gfp_mine_frequent(jdb, 12, class_column=1) == want


def test_gfp_multitude_counts_match_jax():
    tx, y, db, jdb, targets, _ = _gfp_case(9, n=600, m=9, p=0.5, classes=3)
    got = tm.gfp_multitude_counts(_tis(targets, db.vocab), db, host_rows=0)
    want = jm.gfp_multitude_counts(
        _tis(targets, jdb.vocab, JaxTISTree, JaxItemOrder), jdb, host_rows=0)
    assert got.keys() == want.keys() and len(got) > 10
    for key in want:
        assert np.array_equal(got[key], np.asarray(want[key])), key


def test_gfp_mid_flush_kill_resume(tmp_path):
    tx = _random_tx(np.random.default_rng(6), 400, 9, 0.5)
    want = mine_frequent(tx, 60)
    db, _ = _dbs(tx)
    fresh = tm.GFPBackend(db)
    assert tm.mine_frequent_backend(fresh, 60) == want
    assert fresh.kernel_launches == 0 and fresh.blocks_counted > 2

    ckpt = MiningCheckpoint(str(tmp_path / "gfp.json"))
    killed = tm.GFPBackend(db)

    def die(level, chunk):
        if level == 2 and chunk == 1:
            raise _Preempted()

    with pytest.raises(_Preempted):
        tm.mine_frequent_backend(killed, 60, checkpoint=ckpt, on_chunk=die)
    assert killed.blocks_counted == 2
    resumed = []
    b2 = tm.GFPBackend(db)
    got = tm.mine_frequent_backend(b2, 60, checkpoint=ckpt,
                                   on_chunk=lambda l, c: resumed.append((l, c)))
    assert got == want and resumed[0] == (2, 2)
    assert b2.blocks_counted == fresh.blocks_counted - killed.blocks_counted


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_gfp_checkpoint_resumes_mid_flush_across_packages(tmp_path, writer):
    tx = _random_tx(np.random.default_rng(6), 400, 9, 0.5)
    want = mine_frequent(tx, 60)
    db, jdb = _dbs(tx)
    path = str(tmp_path / "gfp.json")

    def die(level, chunk):
        if level == 2 and chunk == 1:
            raise _Preempted()

    if writer == "jax":
        with pytest.raises(_Preempted):
            jm.mine_frequent_backend(jm.GFPBackend(jdb), 60,
                                     checkpoint=JaxCheckpoint(path),
                                     on_chunk=die)
        resume = lambda **kw: tm.mine_frequent_backend(  # noqa: E731
            tm.GFPBackend(db), 60, checkpoint=MiningCheckpoint(path), **kw)
    else:
        with pytest.raises(_Preempted):
            tm.mine_frequent_backend(tm.GFPBackend(db), 60,
                                     checkpoint=MiningCheckpoint(path),
                                     on_chunk=die)
        resume = lambda **kw: jm.mine_frequent_backend(  # noqa: E731
            jm.GFPBackend(jdb), 60, checkpoint=JaxCheckpoint(path), **kw)
    state = json.load(open(path))
    assert state["partial"]["level"] == 2
    assert state["partial"]["next_chunk"] == 2
    assert state["partial"]["backend"] == "gfp"
    resumed = []
    assert resume(on_chunk=lambda l, c: resumed.append((l, c))) == want
    assert resumed[0] == (2, 2)
