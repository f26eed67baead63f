"""Live ingest on the port's serving store (``repro_torch.serve.store``):
a background fold that commits while appends keep landing, appends that
cost their batch and not the delta, a device mirror that grows with the
delta, answers that name their version, and counts equal to the JAX
package's ``VersionedDB`` on the same batches.  CPU only: every count runs
the plain PyTorch version."""
import functools
import threading

import numpy as np
import pytest

import repro.serve as js
from repro_torch import obs
from repro_torch.mining import class_weights, dedup_rows, encode_bitmap
from repro_torch.mining.encode import pad_words
from repro_torch.roofline import autotune as at
from repro_torch.serve import CountServer, VersionedDB
from repro_torch.serve import store as store_mod

_store = functools.partial(VersionedDB, device="cpu")
_server = functools.partial(CountServer, device="cpu")

PROBES = [(0,), (1, 2), (3, 7), (0, 4, 5), (11,), (2, 9), (40,), (33, 40),
          ("never",)]


@pytest.fixture(autouse=True)
def _untuned():
    at.set_active_table(None)
    yield
    at.set_active_table(None)


def _db(rng, rows, items, p=0.3):
    return [[int(a) for a in range(items) if rng.random() < p]
            for _ in range(rows)]


def _plain(history, classes, probes, n_classes=2):
    """Per-class counts by walking every row."""
    out = np.zeros((len(probes), n_classes), np.int64)
    for t, c in zip(history, classes):
        t = set(t)
        for i, p in enumerate(probes):
            if set(p) <= t:
                out[i, c] += 1
    return out


def _discarded() -> float:
    return obs.counter_total(obs.snapshot(),
                             "store_discarded_compactions_total")


class _SlowBuild:
    """Holds the background fold inside its base build until the test has
    landed its appends."""

    def __init__(self, db):
        self.started = threading.Event()
        self.release = threading.Event()
        self._real = db._make_base

    def __call__(self, bits, weights, vocab=None):
        if not self.started.is_set():
            self.started.set()
            assert self.release.wait(60)
        return self._real(bits, weights, vocab=vocab)


def _residency(kind, tmp_path):
    if kind == "streaming":
        return dict(streaming=True, chunk_rows=64)
    if kind == "spilled":
        return dict(spill=True, spill_dir=str(tmp_path), chunk_rows=64)
    return {}


@pytest.mark.parametrize("residency", ["dense", "streaming", "spilled"])
def test_background_fold_commits_under_appends(tmp_path, monkeypatch,
                                               residency):
    """Appends that land during the fold's build neither void it nor get
    lost: the fold commits once, no build is discarded, the delta after it
    is exactly the rows appended after the snapshot, and every version's
    counts equal a plain count of its history."""
    rng = np.random.default_rng(3)
    tx = _db(rng, 300, 12)
    y = [int(rng.random() < 0.3) for _ in tx]
    db = _store(tx, classes=y, n_classes=2, merge_ratio=0.2,
                min_compact_rows=0, background_compaction=True,
                **_residency(residency, tmp_path))
    slow = _SlowBuild(db)
    monkeypatch.setattr(db, "_make_base", slow)
    history, classes = list(tx), list(y)
    discarded = _discarded()
    try:
        batch = _db(rng, 80, 12)
        yb = [int(rng.random() < 0.3) for _ in batch]
        assert db.append(batch, classes=yb) == 1     # past the threshold
        history += batch
        classes += yb
        assert slow.started.wait(60)
        after = []
        for v in range(2, 6):                        # land during the build
            batch = _db(rng, 10, 12 + 10 * (v == 4))
            yb = [int(rng.random() < 0.3) for _ in batch]
            assert db.append(batch, classes=yb) == v
            history += batch
            classes += yb
            after.append((batch, yb))
            np.testing.assert_array_equal(db.counts(PROBES),
                                          _plain(history, classes, PROBES))
        assert db.n_compactions == 0
        slow.release.set()
        db._compactor.drain()
        assert db.n_compactions == 1
        assert _discarded() == discarded
        assert db.stats()["compactor"]["retries"] == 0
        assert db.last_compaction_error is None
        w = db.vocab.n_words
        want_bits, want_w = [], []
        for batch, yb in after:
            ub, uw = dedup_rows(encode_bitmap(batch, db.vocab),
                                class_weights(yb, 2))
            want_bits.append(pad_words(ub, w))
            want_w.append(uw)
        np.testing.assert_array_equal(db._delta.bits,
                                      np.concatenate(want_bits))
        np.testing.assert_array_equal(db._delta.weights,
                                      np.concatenate(want_w))
        assert db.version == 5 and db.n_rows == len(history)
        np.testing.assert_array_equal(db.counts(PROBES),
                                      _plain(history, classes, PROBES))
    finally:
        slow.release.set()
        db.close()


def test_a_fold_committed_meanwhile_voids_the_build(monkeypatch):
    """An explicit compact() that commits while the background build runs:
    the background build is discarded and counted, and counts stay exact."""
    rng = np.random.default_rng(4)
    tx = _db(rng, 200, 10)
    y = [int(rng.random() < 0.3) for _ in tx]
    db = _store(tx, classes=y, n_classes=2, merge_ratio=0.2,
                min_compact_rows=0, background_compaction=True)
    slow = _SlowBuild(db)
    monkeypatch.setattr(db, "_make_base", slow)
    discarded = _discarded()
    history, classes = list(tx), list(y)
    try:
        batch = _db(rng, 60, 10)
        yb = [int(rng.random() < 0.3) for _ in batch]
        db.append(batch, classes=yb)
        history += batch
        classes += yb
        assert slow.started.wait(60)
        db.compact()                     # its build passes the hook
        assert db.n_compactions == 1 and db.delta_rows == 0
        slow.release.set()
        db._compactor.drain()
        assert _discarded() == discarded + 1
        assert db.n_compactions == 1
        np.testing.assert_array_equal(db.counts(PROBES),
                                      _plain(history, classes, PROBES))
    finally:
        slow.release.set()
        db.close()


@pytest.mark.parametrize("batch_rows", [1, 25, 200])
def test_an_append_sorts_only_its_batch(monkeypatch, batch_rows):
    rng = np.random.default_rng(5)
    db = _store(_db(rng, 400, 12), merge_ratio=1e9)
    sorted_rows = []
    real = store_mod.dedup_rows

    def spy(bits, weights=None):
        sorted_rows.append(int(bits.shape[0]))
        return real(bits, weights)

    monkeypatch.setattr(store_mod, "dedup_rows", spy)
    for _ in range(6):
        db.append(_db(rng, batch_rows, 12))
    assert len(sorted_rows) == 6
    assert max(sorted_rows) <= batch_rows < db.delta_rows


@pytest.mark.parametrize("widen", [False, True])
def test_the_device_mirror_follows_the_host_delta(widen):
    """Through appends, counts and folds, the delta's mirror on the store's
    device holds exactly the host delta, and a count takes to the device
    only the rows appended since the last one (a vocabulary past a word
    boundary lays it anew)."""
    rng = np.random.default_rng(6)
    tx = _db(rng, 200, 12)
    db = _store(tx, merge_ratio=0.3, min_compact_rows=0)   # inline folds
    history = list(tx)
    for step in range(12):
        wider = widen and step == 5
        batch = _db(rng, 15, 12 + (40 if wider else 0))
        history += batch
        db.append(batch)
        waiting = db.delta_rows - db._delta._mirrored
        assert waiting == db.delta_rows if wider else waiting <= len(batch)
        got = db.counts(PROBES)
        np.testing.assert_array_equal(
            got, _plain(history, [0] * len(history), PROBES, 1))
        assert db._delta._mirrored == db.delta_rows
        if db.delta_rows:
            bits, weights = db._delta.on_device()
            assert bits.device == db.device
            np.testing.assert_array_equal(bits.numpy(), db._delta.bits)
            np.testing.assert_array_equal(weights.numpy(), db._delta.weights)
    assert db.n_compactions >= 2


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_answers_name_a_version_no_older_than_the_acknowledged_append(mode):
    rng = np.random.default_rng(7)
    tx = _db(rng, 300, 12)
    y = [int(rng.random() < 0.3) for _ in tx]
    srv = _server(tx, classes=y, n_classes=2, merge_ratio=0.2,
                  min_compact_rows=0, background_compaction=True,
                  async_flush=(mode == "async"), max_delay_ms=2, min_batch=2)
    history, classes = list(tx), list(y)
    lengths = {0: len(tx)}
    try:
        for _ in range(8):
            batch = _db(rng, 30, 12)
            yb = [int(rng.random() < 0.3) for _ in batch]
            acked = srv.append(batch, classes=yb)
            history += batch
            classes += yb
            lengths[acked] = len(history)
            if mode == "async":
                fut = srv.submit_async("c", PROBES)
                block = fut.result(timeout=60)
                version = fut.version
            else:
                ticket = srv.submit("c", PROBES)
                out = srv.flush()
                block, version = out[ticket], out.versions[ticket]
            assert version >= acked
            n = lengths[version]
            np.testing.assert_array_equal(
                block, _plain(history[:n], classes[:n], PROBES))
    finally:
        srv.close()


@pytest.mark.parametrize("background", [False, True])
def test_counts_at_every_version_equal_the_jax_store(background):
    """The same batches into both packages' stores, folds included: equal
    counts at every version."""
    rng = np.random.default_rng(8)
    tx = _db(rng, 250, 14)
    y = [int(rng.random() < 0.3) for _ in tx]
    kw = dict(classes=y, n_classes=2, merge_ratio=0.2, min_compact_rows=0)
    port = _store(tx, background_compaction=background, **kw)
    ref = js.VersionedDB(tx, **kw)
    try:
        for step in range(10):
            batch = _db(rng, 25, 14 + 3 * step)
            yb = [int(rng.random() < 0.3) for _ in batch]
            assert port.append(batch, classes=yb) == \
                ref.append(batch, classes=yb)
            np.testing.assert_array_equal(port.counts(PROBES),
                                          ref.counts(PROBES))
        if background:
            port._compactor.drain()
        assert port.n_compactions >= 1 and ref.n_compactions >= 1
        np.testing.assert_array_equal(port.counts(PROBES), ref.counts(PROBES))
    finally:
        port.close()


def test_ingest_spans_nest_where_they_are_read():
    """``store.append`` holds ``store.encode_batch`` and ``store.delta_add``;
    a count of a live delta records ``store.count_delta``; a background
    fold's ``store.bg_compact`` holds its four phases."""
    rng = np.random.default_rng(9)
    db = _store(_db(rng, 200, 10), merge_ratio=0.2, min_compact_rows=0,
                background_compaction=True)
    obs.TRACER.reset()
    obs.configure(tracing=True)
    try:
        db.append(_db(rng, 60, 10))
        db._compactor.drain()
        db.append(_db(rng, 5, 10))
        db.counts(PROBES)
    finally:
        obs.configure(tracing=False)
        db.close()
    spans = obs.TRACER.spans()
    by_id = {s.span_id: s for s in spans}

    def parent(name):
        return {by_id[s.parent_id].name if s.parent_id in by_id else None
                for s in spans if s.name == name}

    assert parent("store.encode_batch") == {"store.append"}
    assert parent("store.delta_add") == {"store.append"}
    for phase in ("compact.fetch", "compact.dedup", "compact.build",
                  "compact.commit"):
        assert parent(phase) == {"store.bg_compact"}, phase
    fold = [s for s in spans if s.name == "store.bg_compact"]
    assert len(fold) == 1
    assert fold[0].attrs["kept_rows"] == 0 and fold[0].attrs["folded_rows"] > 0
    append = [s for s in spans if s.name == "store.append"][-1]
    assert append.attrs["rows"] == 5 and append.attrs["version"] == 2
    assert append.attrs["delta_rows"] == db.delta_rows
    count = [s for s in spans if s.name == "store.count_delta"]
    assert count and count[-1].attrs["delta_rows"] == db.delta_rows


@pytest.mark.parametrize("n,w,c", [(0, 2, 2), (1, 1, 1), (50, 0, 2),
                                   (400, 1, 1), (400, 2, 2), (300, 3, 2)])
def test_dedup_rows_equals_the_jax_package(n, w, c):
    """The fold's and the encoder's row dedup (a lexsort that lets go of the
    interpreter lock) gives the JAX package's ``np.unique(axis=0)`` rows, in
    its order, with the same summed weights."""
    from repro.mining.encode import dedup_rows as jax_dedup_rows

    rng = np.random.default_rng(n + 10 * w + c)
    scale = np.uint32(rng.choice([1, 2**30, 2**31 + 5]))
    bits = rng.integers(0, 4, size=(n, w)).astype(np.uint32) * scale
    weights = rng.integers(0, 3, size=(n, c)).astype(np.int32)
    for args in ((bits, weights), (bits,)):
        got, want = dedup_rows(*args), jax_dedup_rows(*args)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and g.shape == x.shape
            np.testing.assert_array_equal(g, x)
