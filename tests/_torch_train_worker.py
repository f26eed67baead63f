"""One rank of a multi-process gloo run of the port's training-side mesh
helpers, for ``tests/test_torch_parallel.py``.

The test spawns ``world`` processes on ``run``; each joins a gloo group
through a ``FileStore`` (never a fixed TCP port), runs the GPipe schedule
(``repro_torch.parallel.pipeline.pipeline_forward``) over the payload's
stage weights, takes its ``TokenPipeline.host_slice``, and pickles both to
``out_dir/rank<r>.pkl`` (a traceback to ``rank<r>.err`` on failure, then a
non-zero exit).  Imports the port only, so a rank starts without JAX.
"""
import datetime
import os
import pickle
import traceback

TIMEOUT_S = 60


def _layer(w, b, h):
    import torch
    return torch.tanh(h @ w + b)


def _stage_body(params, h):
    sw, sb = params
    for i in range(sw.shape[0]):
        h = _layer(sw[i], sb[i], h)
    return h


def run(rank: int, world: int, store: str, payload_path: str,
        out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            from repro_torch.data import TokenPipeline
            from repro_torch.parallel.pipeline import (pipeline_forward,
                                                       split_stages)

            with open(payload_path, "rb") as f:
                p = pickle.load(f)
            w, b, x = (torch.from_numpy(p[k]) for k in ("w", "b", "x"))
            stages = split_stages((w, b), world)
            out = pipeline_forward(stages, x, _stage_body)
            pipe = TokenPipeline(vocab_size=100, seq_len=8, global_batch=8,
                                 seed=3)
            result = {"rank": rank, "out": out.numpy(),
                      "slice": pipe.host_slice(5)["tokens"]}
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
