"""One rank of a multi-process gloo run of the port's mesh runtime, for
``tests/test_torch_distributed.py``.

The test spawns ``world`` processes on ``run``; each joins a gloo group
through a ``FileStore`` (never a fixed TCP port), builds the mesh, runs the
scenario on the same inputs as every other rank, and pickles what it saw to
``out_dir/rank<r>.pkl`` (a traceback to ``rank<r>.err`` on failure, then a
non-zero exit).  Imports the port only, so a rank starts without JAX.
"""
import datetime
import os
import pickle
import traceback

import numpy as np

TIMEOUT_S = 60


class Preempted(Exception):
    pass


def run(rank: int, world: int, store: str, shape, scenario: str,
        payload_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            with open(payload_path, "rb") as f:
                payload = pickle.load(f)
            from repro_torch.launch.mesh import make_host_mesh

            mesh = make_host_mesh(*shape, device_type="cpu")
            out = SCENARIOS[scenario](mesh, payload, rank, out_dir)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


class _CountingAllReduce:
    """Counts the all-reduces a call makes, and their bytes."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.inner = dist.all_reduce
        self.calls = []

    def __enter__(self):
        def counted(tensor, *args, **kwargs):
            self.calls.append(tensor.numel() * tensor.element_size())
            return self.inner(tensor, *args, **kwargs)

        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.inner


def _miner(mesh, **kw):
    from repro_torch.mining.distributed import DistributedMiner

    return DistributedMiner(mesh, device="cpu", **kw)


def battery(mesh, p, rank, out_dir):
    """Every multi-rank contract on one mesh."""
    from repro_torch.core import ItemOrder, TISTree
    from repro_torch.mining import ItemVocab, MiningCheckpoint
    from repro_torch.mining.distributed import (distributed_counts,
                                                place_rows,
                                                resident_distributed_counts)

    bits, w, chunk = p["bits"], p["w"], p["chunk_rows"]
    vocab = ItemVocab(p["items"])
    out = {"coord": mesh.get_coordinate(), "size": mesh.size(),
           "names": tuple(mesh.mesh_dim_names)}

    # counts: single pass (one all-reduce of K_pad x C int32) and chunked
    # (one per chunk), each masks block of the payload
    out["single"], out["chunked"], out["reduces"] = [], [], []
    for masks in p["masks"]:
        with _CountingAllReduce() as ar:
            out["single"].append(distributed_counts(bits, masks, w, mesh,
                                                    device="cpu"))
        with _CountingAllReduce() as arc:
            out["chunked"].append(distributed_counts(
                bits, masks, w, mesh, chunk_rows=chunk, device="cpu"))
        out["reduces"].append((ar.calls, arc.calls))

    # the resume contract of the chunked sweep and of the single pass
    masks = p["masks"][0]
    seen = {}
    distributed_counts(bits, masks, w, mesh, chunk_rows=chunk, device="cpu",
                       on_chunk=lambda j, acc: seen.update({j: acc}))
    out["hook"] = seen
    out["resumed"] = distributed_counts(bits, masks, w, mesh,
                                        chunk_rows=chunk, start_chunk=2,
                                        init=seen[1], device="cpu")
    out["single_resume"] = distributed_counts(
        bits, masks, w, mesh, start_chunk=1, init=seen[1], device="cpu")

    # mines and the GFP contract
    out["mine"] = _miner(mesh).mine_frequent(bits, w, vocab, p["min_count"])
    out["mine_class"] = _miner(mesh, chunk_rows=chunk).mine_frequent(
        bits, w, vocab, p["min_count_class"], class_column=1)
    tis = TISTree(ItemOrder(p["tis_order"]))
    for t in p["tis_targets"]:
        tis.insert(t)
    tis.finalize()
    out["gfp"] = _miner(mesh).gfp_counts(tis, bits, w, vocab)

    # resident placement: this rank's shard only, counted in place
    tx_dev, w_dev = place_rows(bits, w, mesh, device="cpu")
    out["shard"] = (tx_dev.numpy().copy(), w_dev.numpy().copy())
    out["resident"] = [
        (resident_distributed_counts(tx_dev, m, w_dev, mesh),
         resident_distributed_counts(tx_dev, m, w_dev, mesh,
                                     model_axis="model"))
        for m in p["masks"]]

    # the overflow guard fires before any collective (and any device work)
    big = np.full_like(w, 1 << 29)
    with _CountingAllReduce() as ar:
        try:
            distributed_counts(bits, masks, big, mesh, device="cpu")
            out["overflow"] = None
        except OverflowError as e:
            out["overflow"] = str(e)
        out["overflow_reduces"] = len(ar.calls)

    # only rank 0 writes a checkpoint (each rank is handed its own path)
    own = os.path.join(out_dir, f"ckpt{rank}.json")
    out["ckpt_mine"] = _miner(
        mesh, chunk_rows=chunk, checkpoint=MiningCheckpoint(own)
    ).mine_frequent(bits, w, vocab, p["min_count"])

    if p.get("kill"):
        # a chunked mine killed mid-level 2: every rank stops at the same
        # chunk, after its all-reduce and rank 0's save
        def die(level, j):
            if (level, j) == tuple(p["kill"]):
                raise Preempted()

        try:
            _miner(mesh, chunk_rows=chunk,
                   checkpoint=MiningCheckpoint(p["shared_ckpt"])
                   ).mine_frequent(bits, w, vocab, p["min_count"],
                                   on_chunk=die)
            out["killed"] = False
        except Preempted:
            out["killed"] = True
    if p.get("resume"):
        resumed = []
        out["resume_mine"] = _miner(
            mesh, chunk_rows=chunk,
            checkpoint=MiningCheckpoint(p["shared_ckpt"])).mine_frequent(
                bits, w, vocab, p["min_count"],
                on_chunk=lambda level, j: resumed.append((level, j)))
        out["resume_chunks"] = resumed
    return out


def chooser(mesh, p, rank, out_dir):
    """The chooser's verdict on a real mesh, and the backend it builds."""
    from repro_torch.mining import (DenseDB, choose_backend, backend_for_db,
                                    mine_frequent_backend)

    db = DenseDB.encode(p["tx"], device="cpu")
    traits = p["traits"]
    pick = choose_backend(traits, mesh=mesh)
    spill = choose_backend(traits, spill_threshold_bytes=64)
    backend, choice = backend_for_db(db, mesh=mesh)
    return {"pick": (pick.name, pick.reason),
            "spill": (spill.name, spill.reason),
            "built": (type(backend).__name__, choice.name),
            "mine": mine_frequent_backend(backend, p["min_count"])}


SCENARIOS = {"battery": battery, "chooser": chooser}
