"""The port's mesh runtime (``repro_torch.mining.distributed``) in several
processes: gloo groups on the CPU, on a 2x2 and a 4x1 ``DeviceMesh``, each
rank running ``tests/_torch_dist_worker.py``.  Every count and mine equals
the JAX package's ``distributed_counts`` / ``DistributedMiner`` on an
in-process (1, 1) mesh, integer for integer, on every rank.

Every spawn rendezvous through a ``FileStore`` under the test's temporary
directory (never a fixed TCP port: the suite runs in parallel workers),
gives ``init_process_group`` a timeout, and is joined with a deadline after
which its processes are killed.
"""
import json
import os
import pickle
import shutil
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import _torch_dist_worker as worker
import repro.mining as jm
from repro.core import ItemOrder as JaxItemOrder
from repro.core import TISTree as JaxTISTree
from repro.core import mine_frequent
from repro.mining.distributed import DistributedMiner as JaxMiner
from repro.mining.distributed import MiningCheckpoint as JaxCheckpoint
from repro.mining.distributed import distributed_counts as jax_counts
from repro_torch import mining as tm
from repro_torch.mining.distributed import _reduce_device
from repro_torch.roofline import autotune as at

JOIN_S = 120
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
CHUNK = 150
KILL = (2, 1)


@pytest.fixture(autouse=True)
def _untuned():
    at.set_active_table(None)
    yield
    at.set_active_table(None)


def _spawn(d, world, shape, scenario, payload):
    """Run ``scenario`` on ``world`` gloo ranks; per-rank results."""
    os.makedirs(d)
    pay = os.path.join(d, "payload.pkl")
    with open(pay, "wb") as f:
        pickle.dump(payload, f)
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, os.path.join(d, "store"), shape,
                               scenario, pay, d), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errs = {r: open(os.path.join(d, f"rank{r}.err")).read()
            for r in range(world)
            if os.path.exists(os.path.join(d, f"rank{r}.err"))}
    assert not hung, f"ranks still running after {JOIN_S} s: {errs}"
    assert [p.exitcode for p in procs] == [0] * world, errs
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _problem():
    rng = np.random.default_rng(13)
    m, n = 14, 600
    tx = [[i for i in range(m) if rng.random() < 0.5] for _ in range(n)]
    y = rng.integers(0, 2, n)
    vocab = tm.ItemVocab.from_transactions(tx)
    bits = tm.encode_bitmap(tx, vocab)
    w = tm.class_weights(y, 2)
    items = list(vocab.items)
    blocks = [[[items[0], items[1]], [items[2]], [items[3], items[4]],
               [items[5]], [items[1], items[6], items[7]]],     # K = 5
              [[a] for a in items] + [[a, b] for a in items[:4]
                                      for b in items[4:9]],      # K = 34
              [[items[3]]]]                                      # K = 1
    # item 99 occurs in no transaction: its targets count zero
    tis_targets = [[0, 1], [2], [3, 4, 5], [1, 7], [9], [2, 11, 13], [99],
                   [1, 99]]
    return dict(tx=tx, y=y, bits=bits, w=w, items=tuple(items),
                tis_order=items + [99],
                masks=[tm.encode_targets(b, vocab) for b in blocks],
                tis_targets=tis_targets, chunk_rows=CHUNK, min_count=60,
                min_count_class=40)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The battery on 2x2 (ending in a mine killed mid-level), then on 4x1
    (ending in the elastic resume of that mine); the kill's checkpoint is
    copied before the resume for the JAX package's own resume."""
    base = tmp_path_factory.mktemp("mesh")
    p = _problem()
    p["shared_ckpt"] = str(base / "shared.json")
    killed = _spawn(str(base / "2x2"), 4, MESHES["2x2"], "battery",
                    dict(p, kill=KILL))
    shutil.copy(p["shared_ckpt"], str(base / "killed.json"))
    resumed = _spawn(str(base / "4x1"), 4, MESHES["4x1"], "battery",
                     dict(p, resume=True))
    return dict(p=p, base=base, out={"2x2": killed, "4x1": resumed})


def _jax_mesh():
    import jax

    return jax.make_mesh((1, 1), ("data", "model"))


def _same_on_every_rank(out, key):
    for r in out[1:]:
        a, b = out[0][key], r[key]
        if isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a == b, key


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_mesh_layout(runs, shape):
    out = runs["out"][shape]
    data, model = MESHES[shape]
    assert {tuple(o["coord"]) for o in out} == {
        (d, m) for d in range(data) for m in range(model)}
    assert all(o["size"] == 4 and o["names"] == ("data", "model")
               for o in out)


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_distributed_counts_match_jax(runs, shape):
    """Single pass and chunked sweep, on every rank, == the JAX package's
    (1, 1) mesh == one dense pass; K not a multiple of the model axis."""
    p, out = runs["p"], runs["out"][shape]
    mesh = _jax_mesh()
    for key in ("single", "chunked"):
        _same_on_every_rank(out, key)
    for i, masks in enumerate(p["masks"]):
        want = np.asarray(jax_counts(p["bits"], masks, p["w"], mesh))
        chunked = np.asarray(jax_counts(p["bits"], masks, p["w"], mesh,
                                        chunk_rows=CHUNK))
        np.testing.assert_array_equal(want, chunked)
        for o in out:
            assert o["single"][i].dtype == np.int32
            np.testing.assert_array_equal(o["single"][i], want)
            np.testing.assert_array_equal(o["chunked"][i], want)


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_one_all_reduce_per_launch(runs, shape):
    """One all-reduce of the (K_pad, C) int32 block per single pass, one
    per chunk of a chunked sweep."""
    p, out = runs["p"], runs["out"][shape]
    model = MESHES[shape][1]
    n_chunks = -(-len(p["tx"]) // CHUNK)
    for i, masks in enumerate(p["masks"]):
        k_pad = -(-masks.shape[0] // model) * model
        for o in out:
            single, chunked = o["reduces"][i]
            assert single == [k_pad * 2 * 4]
            assert chunked == [k_pad * 2 * 4] * n_chunks


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_resume_contract_matches_jax(runs, shape):
    p, out = runs["p"], runs["out"][shape]
    masks = p["masks"][0]
    jseen = {}
    jax_counts(p["bits"], masks, p["w"], _jax_mesh(), chunk_rows=CHUNK,
               on_chunk=lambda j, acc: jseen.update({j: np.asarray(acc)}))
    full = out[0]["chunked"][0]
    for o in out:
        assert sorted(o["hook"]) == sorted(jseen) == [0, 1, 2, 3]
        for j in jseen:
            np.testing.assert_array_equal(o["hook"][j], jseen[j])
        np.testing.assert_array_equal(o["resumed"], full)
        # single-chunk discipline: start_chunk >= 1 returns init untouched
        np.testing.assert_array_equal(o["single_resume"], o["hook"][1])


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_miner_mine_and_gfp_counts_match_jax(runs, shape):
    p, out = runs["p"], runs["out"][shape]
    mesh = _jax_mesh()
    vocab = jm.ItemVocab(p["items"])
    want = JaxMiner(mesh).mine_frequent(p["bits"], p["w"], vocab,
                                        p["min_count"])
    assert want == mine_frequent(p["tx"], p["min_count"])
    want_class = JaxMiner(mesh, chunk_rows=CHUNK).mine_frequent(
        p["bits"], p["w"], vocab, p["min_count_class"], class_column=1)
    tis = JaxTISTree(JaxItemOrder(p["tis_order"]))
    for t in p["tis_targets"]:
        tis.insert(t)
    tis.finalize()
    want_gfp = JaxMiner(mesh).gfp_counts(tis, p["bits"], p["w"], vocab)
    for o in out:
        assert o["mine"] == want
        assert o["mine_class"] == want_class and want_class
        assert sorted(o["gfp"]) == sorted(want_gfp)
        for key, row in want_gfp.items():
            np.testing.assert_array_equal(o["gfp"][key], np.asarray(row))


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_place_rows_and_resident_counts(runs, shape):
    """Each rank holds only its row shard (padded to the data-axis
    multiple); resident counts, with and without the model axis, == the
    single pass."""
    p, out = runs["p"], runs["out"][shape]
    data = MESHES[shape][0]
    n = len(p["tx"])
    nb = -(-n // data)
    for o in out:
        d = o["coord"][0]
        tx, w = o["shard"]
        assert tx.shape == (nb, p["bits"].shape[1]) and w.shape == (nb, 2)
        rows = slice(d * nb, min((d + 1) * nb, n))
        real = rows.stop - rows.start
        np.testing.assert_array_equal(tx[:real], p["bits"][rows])
        np.testing.assert_array_equal(w[:real], p["w"][rows])
        assert not tx[real:].any() and not w[real:].any()
        for i, (plain, by_model) in enumerate(o["resident"]):
            np.testing.assert_array_equal(plain, out[0]["single"][i])
            np.testing.assert_array_equal(by_model, out[0]["single"][i])


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_overflow_raised_before_any_collective(runs, shape):
    for o in runs["out"][shape]:
        assert o["overflow"] is not None and "int32" in o["overflow"]
        assert o["overflow_reduces"] == 0


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_only_rank_zero_writes_the_checkpoint(runs, shape):
    d = runs["base"] / shape
    out = runs["out"][shape]
    assert os.path.exists(str(d / "ckpt0.json"))
    for r in range(1, 4):
        assert not os.path.exists(str(d / f"ckpt{r}.json"))
        assert not os.path.exists(str(d / f"ckpt{r}.json.tmp"))
    state = JaxCheckpoint(str(d / "ckpt0.json")).load_state()
    assert state["frequent"] == out[0]["ckpt_mine"] == out[0]["mine"]
    assert state["partial"] is None


def test_chunked_mine_killed_on_2x2_resumes_on_4x1_and_in_jax(runs,
                                                              tmp_path):
    """Elastic restart: the kill's mid-level partial (mesh-independent
    signature) resumes on another mesh shape, and in the JAX package."""
    p = runs["p"]
    assert all(o["killed"] for o in runs["out"]["2x2"])
    state = json.load(open(str(runs["base"] / "killed.json")))
    partial = state["partial"]
    assert (partial["level"], partial["next_chunk"]) == (2, 2)
    assert partial["backend"] == "distributed"
    assert partial["chunk_rows"] == CHUNK and partial["n_rows"] == 600
    want = mine_frequent(p["tx"], p["min_count"])
    assert max(len(k) for k in want) >= 3       # levels after the kill
    for o in runs["out"]["4x1"]:
        assert o["resume_mine"] == want
        assert tuple(o["resume_chunks"][0]) == (2, 2)
    path = str(tmp_path / "jax.json")
    shutil.copy(str(runs["base"] / "killed.json"), path)
    resumed = []
    got = JaxMiner(_jax_mesh(), checkpoint=JaxCheckpoint(path),
                   chunk_rows=CHUNK).mine_frequent(
        p["bits"], p["w"], jm.ItemVocab(p["items"]), p["min_count"],
        on_chunk=lambda level, j: resumed.append((level, j)))
    assert got == want
    assert tuple(resumed[0]) == (2, 2)


def test_chooser_picks_distributed_for_a_two_rank_mesh(tmp_path):
    """A real two-rank ``DeviceMesh`` (``size()`` is a method) goes through
    ``choose_backend`` with the verdict and reason of the JAX package's
    chooser on a mesh of two devices; ``spilled`` past the budget; and
    ``backend_for_db`` builds the distributed backend, whose mine is the
    host's."""
    rng = np.random.default_rng(3)
    tx = [[i for i in range(12) if rng.random() < 0.35] for _ in range(200)]
    traits = tm.DatasetTraits.of_db(tm.DenseDB.encode(tx, device="cpu"))
    jtraits = jm.DatasetTraits.of_db(jm.DenseDB.encode(tx))
    out = _spawn(str(tmp_path / "run"), 2, (2, 1), "chooser",
                 dict(tx=tx, traits=traits, min_count=30))
    jpick = jm.choose_backend(jtraits, mesh=types.SimpleNamespace(size=2))
    jspill = jm.choose_backend(jtraits, spill_threshold_bytes=64)
    assert jpick.reason == "multi-device mesh (2 devices): shard the sweep"
    for o in out:
        assert o["pick"] == (jpick.name, jpick.reason) == (
            "distributed", jpick.reason)
        assert o["spill"] == (jspill.name, jspill.reason)
        assert o["spill"][0] == "spilled"
        assert o["built"] == ("DistributedBackend", "distributed")
        assert o["mine"] == mine_frequent(tx, 30)


def test_reduce_device_follows_the_group_backend(monkeypatch):
    """NCCL reduces on the card, gloo a host copy (also of a count made on
    the card), chosen up front; NCCL with host counting is refused."""
    import torch.distributed as dist

    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "nccl")
    assert _reduce_device(cuda) == cuda
    with pytest.raises(ValueError, match="NCCL"):
        _reduce_device(torch.device("cpu"))
    monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "gloo")
    assert _reduce_device(cuda) == torch.device("cpu")
    assert _reduce_device(torch.device("cpu")) == torch.device("cpu")


def test_make_host_mesh_needs_a_process_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    if dist.is_initialized():
        pytest.skip("a process group is initialised in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(1, 1, device_type="cpu")
