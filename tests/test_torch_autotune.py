"""The port's autotuner against the JAX package's: one tuning-table format,
the same resolutions, chunk sizes and derived chooser thresholds on the same
table, and counts that no lattice config changes (exact equality
throughout).  Also the port's own battery: schema rejection, discovery,
staleness, telemetry, the sweep and its launcher on the CPU."""
import json
import os
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mining as jm
from repro.roofline import autotune as jat
from repro_torch import mining as tm
from repro_torch import obs
from repro_torch.roofline import autotune as at
from repro_torch.roofline import kernel_model as km

CPU = torch.device("cpu")
LATTICE = [(bk, acc) for bk in at.BLOCK_K_LATTICE for acc in at.ACCUM_LATTICE]


@pytest.fixture(autouse=True)
def _untuned():
    """Pin the port's autotuner to the compiled-in defaults (``conftest.py``
    pins the JAX package's)."""
    at.set_active_table(None)
    yield
    at.set_active_table(None)


def _entry(block_k=128, accum="vpu_int32", chunk_rows=0, us=100.0,
           block_n=1024, **extra):
    e = {"block_k": block_k, "block_n": block_n, "accum": accum,
         "chunk_rows": chunk_rows, "us": us, "efficiency": 0.5}
    e.update(extra)
    return e


def _doc(entries, kind="cpu"):
    return {"schema": 1, "device_kind": kind, "created": "",
            "entries": entries}


def _tables(entries, source="<test>"):
    """The same table document loaded by the port and by the JAX package."""
    doc = _doc(entries)
    return (at.table_from_dict(json.loads(json.dumps(doc)), source),
            jat.table_from_dict(json.loads(json.dumps(doc)), source))


def _pin(entries):
    t, jt = _tables(entries)
    at.set_active_table(t)
    jat.set_active_table(jt)


def _small_db(seed=0, rows=300, items=10):
    rng = np.random.default_rng(seed)
    tx = [list(np.flatnonzero(rng.random(items) < 0.4)) for _ in range(rows)]
    y = (rng.random(rows) < 0.3).astype(int)
    return tx, y


# -- geometry buckets ----------------------------------------------------------

@pytest.mark.parametrize("geom", [(1000, 100, 2, 3), (1, 1, 1, 1),
                                  (1 << 30, 1 << 22, 100, 50),
                                  (2048, 256, 4, 2), (969130, 34220, 2, 2)])
def test_buckets_match_jax(geom):
    from repro.roofline import kernel_model as jkm
    b = km.geometry_bucket(*geom)
    assert b == jkm.geometry_bucket(*geom)
    assert km.bucket_shape(b) == jkm.bucket_shape(b)


def test_bucket_shape_rejects_non_buckets():
    with pytest.raises(ValueError):
        km.bucket_shape(km.GEOMETRY_OVERFLOW)
    with pytest.raises(ValueError):
        km.bucket_shape("n12_k8")


def test_record_launch_uses_buckets_and_overflow_cap():
    saved = set(km._SEEN_BUCKETS)
    obs.reset()
    km._reset_geometry_buckets()
    try:
        km.record_launch(1000, 100, 2, 3, 1e-3)
        km.record_launch(1001, 101, 2, 3, 1e-3)   # same bucket
        launches = obs.snapshot()["counters"]["kernel_launches_total"]
        assert launches == {"geometry=n1024_k128_w2_c4": 2.0}
        for i in range(km.MAX_GEOMETRY_BUCKETS - 1):
            km._SEEN_BUCKETS.add(f"synthetic{i}")
        km.record_launch(1 << 20, 8, 1, 1, 1e-3)
        assert km.GEOMETRY_OVERFLOW in obs.kernel_efficiency()
    finally:
        km._reset_geometry_buckets()
        km._SEEN_BUCKETS.update(saved)
        obs.reset()


# -- one table format ----------------------------------------------------------

def test_jax_saved_table_loads_in_port_and_back(tmp_path):
    entries = {
        "n1024_k256_w2_c2": _entry(
            block_k=512, chunk_rows=4096, us=42.0, serve_block_k=64,
            candidates={"bk512/vpu_int32": 42.0, "bk256/mxu_f32": 50.0},
            chunk_candidates={"0": 60.0, "4096": 42.0},
            serve_candidates={"64": 10.0, "256": 30.0}),
        "n4096_k256_w1_c1": _entry(block_k=64, accum="mxu_f32", us=13.0),
    }
    jpath = str(tmp_path / "jax.json")
    jat.save_table(jat.table_from_dict(_doc(entries)), jpath)
    t = at.load_table(jpath)
    assert t.source == jpath and t.device_kind == "cpu"
    assert at.table_to_dict(t) == jat.table_to_dict(jat.load_table(jpath))
    e = t.entries["n1024_k256_w2_c2"]
    assert e.config == at.LaunchConfig(512, 1024, "vpu_int32", 4096, "table")
    assert e.serve_block_k == 64 and e.candidates["bk256/mxu_f32"] == 50.0
    tpath = str(tmp_path / "port.json")
    at.save_table(t, tpath)
    assert open(tpath).read() == open(jpath).read()     # byte for byte
    assert jat.table_to_dict(jat.load_table(tpath)) == at.table_to_dict(t)


MUTATIONS = {
    "schema": lambda d: d.update(schema=99),
    "kind": lambda d: d.update(device_kind=""),
    "entries": lambda d: d.update(entries="nope"),
    "bucket": lambda d: d["entries"].update(
        {"not_a_bucket": d["entries"].pop("n1024_k256_w2_c2")}),
    "block_k": lambda d: d["entries"]["n1024_k256_w2_c2"].update(block_k=100),
    "accum": lambda d: d["entries"]["n1024_k256_w2_c2"].update(accum="int8"),
    "chunk_rows": lambda d: d["entries"]["n1024_k256_w2_c2"].update(
        chunk_rows=-1),
    "us": lambda d: d["entries"]["n1024_k256_w2_c2"].update(us=0),
    "serve_block_k": lambda d: d["entries"]["n1024_k256_w2_c2"].update(
        serve_block_k=100),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_table_schema_rejection_matches_jax(case):
    doc = _doc({"n1024_k256_w2_c2": _entry()})
    MUTATIONS[case](doc)
    with pytest.raises(at.TableError):
        at.table_from_dict(json.loads(json.dumps(doc)))
    with pytest.raises(jat.TableError):
        jat.table_from_dict(json.loads(json.dumps(doc)))


def test_load_table_rejects_bad_json(tmp_path):
    p = tmp_path / "cpu.json"
    p.write_text("{not json")
    with pytest.raises(at.TableError):
        at.load_table(str(p))


# -- discovery -----------------------------------------------------------------

def test_discovery_env_override_and_disable(tmp_path, monkeypatch):
    path = str(tmp_path / "mine.json")
    at.save_table(at.table_from_dict(_doc(
        {"n1024_k256_w2_c2": _entry(block_k=64)}, kind="whatever")), path)
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", path)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    at.clear_active_table()
    t = at.active_table()
    assert t is not None and t.source == path
    assert at.resolve_launch_config(1000, 200, 2, 2).block_k == 64
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "0")     # wins over all
    at.clear_active_table()
    assert at.active_table() is None
    assert at.resolve_launch_config(1000, 200, 2, 2).source == "default"


def test_discovery_reads_user_cache(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_TABLE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    path = at.cache_table_path()
    assert path == os.path.join(str(tmp_path), "repro_torch", "autotune",
                                f"{at.device_kind()}.json")
    at.save_table(at.table_from_dict(_doc(
        {"n1024_k256_w2_c2": _entry(block_k=512)})), path)
    at.clear_active_table()
    assert at.active_table().source == path
    assert "1 entries" in at.describe_active()


def test_discovery_skips_corrupt_table(tmp_path, monkeypatch):
    path = tmp_path / "broken.json"
    path.write_text("{definitely not json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", str(path))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE", raising=False)
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "empty"))
    at.clear_active_table()
    before = obs.counter_total(obs.snapshot(), "autotune_table_errors_total")
    t = at.active_table()
    after = obs.counter_total(obs.snapshot(), "autotune_table_errors_total")
    assert after == before + 1
    assert t is None or t.source != str(path)


def test_no_table_is_committed_with_the_port():
    assert not os.path.isdir(os.path.dirname(at.repo_table_path("cpu")))


def test_device_kind_names_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert at.device_kind() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert at.device_kind() == "nvidia_h100_80gb_hbm3"


# -- the resolution seam -------------------------------------------------------

def test_untuned_launches_keep_the_kernel_defaults():
    cfg = at.resolve_launch_config(5000, 100, 2, 1)
    assert (cfg.block_k, cfg.block_n, cfg.accum, cfg.chunk_rows,
            cfg.source) == (128, 512, "vpu_int32", None, "default")
    from repro_torch.kernels.itemset_count import ops
    assert (ops.DEFAULT_BLOCK_K, ops.DEFAULT_BLOCK_N, ops.DEFAULT_ACCUM) == \
        (128, 512, "vpu_int32")


RESOLVE_GRID = [(n, k, w, c) for n in (200, 1000, 5000, 100000, 1 << 24,
                                        (1 << 25) + 3)
                for k in (8, 100, 256, 2000) for w in (1, 2) for c in (1, 2)]


def _resolve_table():
    """Entries on a subset of the grid's buckets, both accums, tuned chunk
    sizes, and an mxu_f32 entry in the 2^26-clamped bucket that N >= 2^24
    launches hit."""
    entries = {}
    for i, (n, k, w, c) in enumerate(RESOLVE_GRID):
        if i % 3:
            continue
        entries[km.geometry_bucket(n, k, w, c)] = _entry(
            block_k=at.BLOCK_K_LATTICE[i % 4],
            accum=at.ACCUM_LATTICE[(i // 3) % 2],
            chunk_rows=(0, 4096, 5000, 16384)[i % 4])
    entries[km.geometry_bucket(1 << 25, 8, 1, 1)] = _entry(
        block_k=64, accum="mxu_f32")
    return entries


def test_resolution_matches_jax_on_a_grid():
    entries = _resolve_table()
    _pin(entries)
    hits = mxu_fallbacks = 0
    for geom in RESOLVE_GRID + [((1 << 25) + 3, 8, 1, 1)]:
        cfg, jcfg = at.resolve_launch_config(*geom), \
            jat.resolve_launch_config(*geom)
        assert cfg.source == jcfg.source, geom
        if jcfg.source == "table":
            hits += 1
            assert (cfg.block_k, cfg.block_n, cfg.accum, cfg.chunk_rows) == \
                (jcfg.block_k, jcfg.block_n, jcfg.accum, jcfg.chunk_rows)
            tuned = entries[km.geometry_bucket(*geom)]["accum"]
            mxu_fallbacks += tuned != cfg.accum
        else:
            # a miss takes each package's own kernel default
            assert cfg == at.DEFAULT_CONFIG
    assert hits > 10 and mxu_fallbacks >= 1


def test_resolve_mxu_guard_falls_back_to_vpu():
    n_big = 1 << 25
    _pin({km.geometry_bucket(n, 8, 1, 1): _entry(accum="mxu_f32", block_k=64)
          for n in (n_big, 1 << 24)})
    before = obs.counter_total(obs.snapshot(),
                               "autotune_mxu_row_fallbacks_total")
    cfg = at.resolve_launch_config(n_big, 8, 1, 1)
    assert cfg.accum == "vpu_int32" and cfg.block_k == 64
    assert jat.resolve_launch_config(n_big, 8, 1, 1).accum == "vpu_int32"
    assert obs.counter_total(obs.snapshot(),
                             "autotune_mxu_row_fallbacks_total") == before + 1
    # the bucket (2^23, 2^24] holds both sides of the bound
    assert at.resolve_launch_config((1 << 24) - 1, 8, 1, 1).accum == "mxu_f32"
    assert at.resolve_launch_config(1 << 24, 8, 1, 1).accum == "vpu_int32"


def test_resolve_serve_block_k_uses_store_geometry():
    class Store:
        base_rows = 5000
        n_classes = 1

        class vocab:
            n_words = 2

    bucket = km.geometry_bucket(5000, at.TABLE_LOOKUP_BLOCK_K, 2, 1)
    _pin({bucket: _entry(block_k=512, serve_block_k=64)})
    assert at.resolve_serve_block_k(Store()) == 64
    _pin({bucket: _entry(block_k=512)})
    assert at.resolve_serve_block_k(Store()) == at.DEFAULT_BLOCK_K
    at.set_active_table(None)
    assert at.resolve_serve_block_k(Store()) == at.DEFAULT_BLOCK_K
    assert at.resolve_serve_block_k(object()) == at.DEFAULT_BLOCK_K


# -- the chunk planner ---------------------------------------------------------

CHUNK_GRID = [(w, c, n) for w in (1, 2, 4) for c in (1, 2)
              for n in (None, 1, 300, 2000, 100000, 969130, 3_000_000)]


@pytest.mark.parametrize("tuned", [False, True])
def test_choose_chunk_rows_matches_jax(tuned):
    """Equal with and without a table.  The table keys its chunk sizes at
    K = 256 (the JAX package's default block_k); a lookup under the port's
    kernel default of 128 would miss every one of these entries."""
    from repro.mining.plan import choose_chunk_rows as jax_ccr

    if tuned:
        entries = {km.geometry_bucket(n, 256, w, c): _entry(
            chunk_rows=(5000, 16384, 4096)[i % 3])
            for i, (w, c, n) in enumerate(CHUNK_GRID) if n}
        assert not any(km.bucket_shape(b)[1] == 128 for b in entries)
        _pin(entries)
    for w, c, n in CHUNK_GRID:
        assert tm.choose_chunk_rows(w, c, n_rows=n) == \
            jax_ccr(w, c, n_rows=n), (w, c, n)
    heur = {(w, c, n): tm.choose_chunk_rows(w, c, n_rows=n)
            for w, c, n in CHUNK_GRID}
    at.set_active_table(None)
    changed = sum(heur[g] != tm.choose_chunk_rows(g[0], g[1], n_rows=g[2])
                  for g in heur)
    assert (changed > 0) == tuned


def test_choose_chunk_rows_clamped_to_db_rows():
    _pin({km.geometry_bucket(2000, 256, 2, 2): _entry(chunk_rows=16384)})
    assert tm.choose_chunk_rows(2, 2, n_rows=2000) == 2048
    at.set_active_table(None)
    assert tm.choose_chunk_rows(2, 2, n_rows=2000) == 2048
    assert tm.choose_chunk_rows(4, 2, budget_bytes=1 << 30, align=128,
                                n_rows=300) == 384
    assert tm.choose_chunk_rows(2, 2, n_rows=1) == 1024


def test_oversized_tuned_chunk_never_launches_past_padded_rows(monkeypatch):
    import repro_torch.mining.stream as stream_mod
    from repro_torch.kernels.itemset_count import itemset_counts

    tx, y = _small_db(3)
    db = tm.DenseDB.encode(tx, classes=y, n_classes=2, device=CPU)
    bits, wts = db.bits.numpy(), db.weights.numpy()
    masks = bits[:8].copy()
    want = itemset_counts(db.bits, torch.from_numpy(masks), db.weights)
    launched = []
    real = stream_mod.itemset_counts_into

    def spy(acc, cur_tx, tgt, w, **kw):
        launched.append(int(cur_tx.shape[0]))
        return real(acc, cur_tx, tgt, w, **kw)

    monkeypatch.setattr(stream_mod, "itemset_counts_into", spy)
    _pin({km.geometry_bucket(bits.shape[0], 256, bits.shape[1], 2):
          _entry(chunk_rows=16384)})
    sdb = tm.StreamingDB.from_arrays(db.vocab, bits, wts, db.n_rows, 2,
                                     device=CPU)
    got = sdb.counts(masks)
    assert launched and max(launched) <= -(-bits.shape[0] // 1024) * 1024
    assert torch.equal(got, want)


# -- config invariance: the whole lattice counts the same ----------------------

@pytest.mark.parametrize("cfg", LATTICE)
def test_lattice_config_invariance_all_paths(cfg):
    """Every (block_k, accum) of the lattice gives the same counts as the
    JAX package's default on the dense, streamed and GFP paths, the GFP one
    under a table pinned to the config (host_rows=0: every block through
    the counting seam)."""
    from repro.kernels.itemset_count import itemset_counts as jax_counts
    from repro_torch.kernels.itemset_count import itemset_counts

    block_k, accum = cfg
    tx, y = _small_db(block_k + len(accum))
    db = tm.DenseDB.encode(tx, classes=y, n_classes=2, device=CPU)
    bits, wts = db.bits.numpy(), db.weights.numpy()
    masks = bits[:12].copy()
    want = np.asarray(jax_counts(jnp.asarray(bits), jnp.asarray(masks),
                                 jnp.asarray(wts)))
    got = itemset_counts(db.bits, torch.from_numpy(masks), db.weights,
                         block_k=block_k, accum=accum)
    assert np.array_equal(got.numpy(), want)
    got = tm.streaming_counts(bits, masks, wts, chunk_rows=64,
                              block_k=block_k, accum=accum, device=CPU)
    assert np.array_equal(got.numpy(), want)
    _pin({km.geometry_bucket(n, k, bits.shape[1], 2): _entry(
        block_k=block_k, accum=accum)
        for n in (128, 256, 512, 1024) for k in (8, 16, 32, 64, 128, 256)})
    be = tm.GFPBackend(db, host_rows=0)
    assert np.array_equal(be.counts(masks), want)
    assert be.kernel_launches > 0


def test_tuned_table_mine_identical_to_default():
    tx, y = _small_db(7, rows=400, items=12)
    db = tm.DenseDB.encode(tx, classes=y, n_classes=2, device=CPU)
    want = tm.dense_mine_frequent(db, 40)
    _pin({km.geometry_bucket(n, k, 1, 2): _entry(
        block_k=64, accum="mxu_f32", chunk_rows=1024)
        for n in (128, 256, 512, 1024)
        for k in (8, 16, 32, 64, 128, 256, 512, 1024)})
    assert tm.dense_mine_frequent(db, 40) == want
    assert jm.dense_mine_frequent(
        jm.DenseDB.encode(tx, classes=y, n_classes=2), 40) == want


@pytest.mark.parametrize("streaming", [False, True])
def test_minority_report_under_mxu_table_matches_jax(streaming, monkeypatch):
    """The slice as a whole: under a table pinned to mxu_f32 at every bucket
    the mine can touch, the port's rules equal the JAX package's under the
    same table, and every count went through the mxu_f32 route."""
    from repro.data import bernoulli_db
    from repro_torch.kernels.itemset_count import ops

    tx, y = bernoulli_db(1500, 16, 0.25, 0.1, 3)
    _pin({km.geometry_bucket(n, k, w, c): _entry(
        block_k=64, accum="mxu_f32", chunk_rows=512)
        for n in (128, 256, 512, 1024, 2048) for w in (1, 2) for c in (1, 2)
        for k in (8, 16, 32, 64, 128, 256, 512, 1024)})
    accums = []
    real = ops.itemset_counts_ref_blocked

    def spy(*a, **kw):
        accums.append(kw["accum"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "itemset_counts_ref_blocked", spy)
    kw = dict(min_support=0.01, min_confidence=0.05, streaming=streaming)
    got = tm.minority_report_dense(tx, y, device=CPU, **kw)
    want = jm.minority_report_dense(tx, y, **kw)
    assert [astuple(r) for r in got.rules] == \
        [astuple(r) for r in want.rules] and got.rules
    assert accums and set(accums) == {"mxu_f32"}


# -- derived chooser thresholds ------------------------------------------------

def _throughput_entries(overhead_us=100.0, per_row_us=0.05, rho=1.0):
    entries = {}
    for n in (1024, 4096, 16384, 65536):
        us = overhead_us + per_row_us * n
        entries[km.geometry_bucket(n, 256, 2, 2)] = _entry(
            us=us, chunk_candidates={"0": us, "4096": us / rho})
    return entries


@pytest.mark.parametrize("kw", [{}, {"overhead_us": 400.0},
                                {"overhead_us": 25.0}, {"rho": 0.25},
                                {"rho": 2.0}, {"per_row_us": 1e-9}])
def test_derived_thresholds_match_jax(kw):
    t, jt = _tables(_throughput_entries(**kw))
    assert at.derived_chooser_thresholds(t) == \
        jat.derived_chooser_thresholds(jt)


def test_derived_thresholds_scale_with_measured_overhead():
    from repro_torch.mining.stream import DEFAULT_STREAM_THRESHOLD_BYTES

    base = at.derived_chooser_thresholds(_tables(_throughput_entries())[0])
    assert base == {"tiny_rows": 2000, "gfp_host_rows": 4096, "min_depth": 4,
                    "stream_threshold_bytes":
                    DEFAULT_STREAM_THRESHOLD_BYTES // 2}
    pricey = at.derived_chooser_thresholds(
        _tables(_throughput_entries(overhead_us=400.0))[0])
    assert pricey["tiny_rows"] == 8000 and pricey["min_depth"] == 2
    assert at.derived_chooser_thresholds(_tables({})[0]) == {}
    assert at.derived_chooser_thresholds() == {}


def test_chooser_consumes_derived_thresholds():
    traits = tm.DatasetTraits(n_rows=5000, n_unique=5000, vocab_size=20,
                              n_classes=1, nbytes=10 ** 6, density=0.05,
                              skew=1.0, dedup_ratio=1.0)
    assert tm.choose_backend(traits).name == "dense"
    _pin(_throughput_entries(overhead_us=400.0))
    choice = tm.choose_backend(traits)
    assert choice.name == "dense" and "tiny DB" in choice.reason


# -- the sweep -----------------------------------------------------------------

def test_sweep_smoke_produces_valid_winning_table(tmp_path):
    t = at.sweep([(256, 16, 1, 1)], repeats=1, block_ks=(128, 256),
                 chunk_grid=(0,), kind="testkind", device=CPU)
    e = t.entries[km.geometry_bucket(256, 16, 1, 1)]
    assert e.config.block_k in (128, 256) and e.us > 0 and e.efficiency > 0
    assert set(e.candidates) == {f"bk{bk}/{acc}" for bk in (128, 256)
                                 for acc in at.ACCUM_LATTICE}
    assert e.serve_block_k is None and e.serve_candidates == {}
    path = at.save_table(t, str(tmp_path / "testkind.json"))
    assert at.load_table(path).entries.keys() == t.entries.keys()
    # the JAX package reads what the port's sweep wrote
    assert jat.load_table(path).entries.keys() == t.entries.keys()


def test_sweep_guards_mxu_candidates_by_rows():
    assert ("64", "mxu_f32") not in at.candidate_configs(1 << 24)
    assert len(at.candidate_configs(1 << 24)) == 4
    assert at.candidate_configs(1000) == jat.candidate_configs(1000)
    assert at.candidate_configs(1 << 24) == jat.candidate_configs(1 << 24)


def test_sweep_serve_view_prefers_less_padding(monkeypatch):
    """The serve view times each candidate at its own padded geometry
    (k = block_k) times the flushes a 64-query batch needs.  A clock that
    charges 1 us per target makes the comparison exact: the 64-target
    launch must win against the 256-target one."""
    import repro_torch.kernels.itemset_count as kic

    ks = []
    real = kic.itemset_counts

    def spy(tx, tgt, w, **kw):
        ks.append(int(tgt.shape[0]))
        return real(tx, tgt, w, **kw)

    def clock(fn, repeats, device):
        fn()
        return float(ks[-1])

    monkeypatch.setattr(kic, "itemset_counts", spy)
    monkeypatch.setattr(at, "_time_best_of", clock)
    t = at.sweep([(16384, 256, 2, 2)], repeats=2, block_ks=(64, 256),
                 accums=("vpu_int32",), chunk_grid=(0,), kind="testkind",
                 device=CPU)
    e = t.entries[km.geometry_bucket(16384, 256, 2, 2)]
    assert e.serve_candidates == {"64": 64.0, "256": 256.0}
    assert e.serve_block_k == 64


def test_sweep_leaves_telemetry_clean():
    obs.reset()
    at.sweep([(256, 16, 1, 1)], repeats=1, block_ks=(256,),
             accums=("vpu_int32",), chunk_grid=(0,), device=CPU)
    assert obs.counter_total(obs.snapshot(), "kernel_launches_total") == 0
    assert obs.KERNEL_TIMING
    obs.reset()


def test_sweep_times_the_card_with_cuda_events(monkeypatch):
    """On the card a launch returns before its kernel ends: each candidate
    is bracketed by CUDA events and the host waits for the end event."""
    log = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t = None

        def record(self, stream=None):
            self.t = len(log)
            log.append("record")

        def synchronize(self):
            log.append("sync")

        def elapsed_time(self, end):
            return 2.5          # ms

    monkeypatch.setattr(torch.cuda, "Event", Event)
    us = at._time_best_of(lambda: log.append("call"), 3,
                          torch.device("cuda"))
    assert us == 2500.0
    assert log == ["call"] + ["record", "call", "record", "sync"] * 3


def test_autotune_launcher_smoke_and_preset(tmp_path, capsys):
    from repro_torch.launch import autotune as launch_autotune

    out = str(tmp_path / "smoke.json")
    assert launch_autotune.main(["--smoke", "--device", "cpu",
                                 "--out", out]) == 0
    assert "autotune smoke OK" in capsys.readouterr().out
    assert at.load_table(out).device_kind == "cpu"
    out = str(tmp_path / "g.json")
    assert launch_autotune.main(["-g", "3000,40,2,2", "--repeats", "1",
                                 "--device", "cpu", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "tuning table [cpu] 1 buckets" in text
    t = at.load_table(out)
    assert set(t.entries) == {km.geometry_bucket(3000, 40, 2, 2)}
    assert launch_autotune.PRESETS["main"] == [
        (969130, 1770, 2, 2), (969130, 34220, 2, 2), (969130, 1830, 2, 2)]


# -- staleness, telemetry, banner ----------------------------------------------

def test_staleness_flags_drifted_entry():
    bucket = km.geometry_bucket(4096, 256, 2, 2)
    t = _tables({bucket: _entry(
        block_k=512, us=100.0, candidates={"bk512/vpu_int32": 100.0,
                                           "bk256/mxu_f32": 120.0})})[0]
    obs.reset()
    try:
        for predicted, stale in ((0.2, True), (0.5, False)):
            obs.reset()
            obs.REGISTRY.counter("kernel_launches_total",
                                 geometry=bucket).inc(10)
            obs.REGISTRY.counter("kernel_measured_s_total",
                                 geometry=bucket).inc(1.0)
            obs.REGISTRY.counter("kernel_predicted_s_total",
                                 geometry=bucket).inc(predicted)
            rep = at.staleness_report(t)
            assert rep[bucket]["stale"] is stale
            assert rep[bucket]["alternative"] == "bk256/mxu_f32"
        obs.reset()
        rep = at.staleness_report(t)
        assert rep[bucket]["stale"] is False and "reason" in rep[bucket]
    finally:
        obs.reset()


def test_telemetry_section_exposes_autotune():
    bucket = km.geometry_bucket(5000, 256, 1, 2)
    at.set_active_table(_tables({bucket: _entry(block_k=512)},
                                source="<pinned>")[0])
    sec = obs.telemetry_section()["autotune"]
    assert sec["active"] is True and sec["source"] == "<pinned>"
    assert sec["entries"][bucket]["block_k"] == 512
    assert bucket in sec["stale"]
    at.set_active_table(None)
    assert obs.telemetry_section()["autotune"] == {
        "active": False, "source": "default", "entries": {}, "stale": {},
        "fallbacks": dict(at.LAST_FALLBACKS)}


def test_describe_active_banner():
    assert "default launch configs" in at.describe_active()
    at.set_active_table(_tables({"n128_k8_w1_c1": _entry()},
                                source="x.json")[0])
    msg = at.describe_active()
    assert "cpu" in msg and "1 entries" in msg and "x.json" in msg
