"""Serving launcher: batched prefill + greedy decode loop for one
architecture of the model zoo.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Random weights from ``torch.Generator(device).manual_seed(--seed)``;
prompts (and the encoder-decoder's frames) from
``np.random.default_rng(--seed)``, as the JAX launcher draws them.
``--device`` defaults to the card and raises without one; ``--dtype``
overrides the config's.  Prints the JAX launcher's three lines: the
prefill time, the decode steps with tokens/s, and the first row's tokens.

``--data-mesh D --model-mesh M`` serves on a (D, M) mesh over a
``torch.distributed`` group of D * M ranks, the one ``torchrun`` describes
in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``): each model group holds the model split over its M ranks
(``Model(mesh=)``) and each data rank serves its own rows of the batch.
The backend is NCCL where each of this host's ranks has a card of its
own, else gloo (on ``cpu``, or where ranks share a card, which NCCL
refuses).  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch


@dataclass
class Generation:
    tokens: torch.Tensor      # (B, gen): greedy tokens, the first from prefill
    logits: torch.Tensor      # (B, gen, Vpad): the logits each token came from
    prefill_s: float
    decode_s: float           # the gen - 1 decode steps


@dataclass
class ServeRun:
    model: Any                # repro_torch.models.Model
    prompts: torch.Tensor     # (B, prompt_len)
    frames: Optional[torch.Tensor]
    out: Generation


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompts: torch.Tensor, gen: int,
             frames: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``prompts`` into a cache of ``prompt_len + gen`` positions
    and decode ``gen - 1`` greedy steps; argmax reads only the real
    vocabulary, never the padded tail.  Times are host clocks around work
    that ends in a device synchronise."""
    cfg, dev = model.cfg, model.device
    s = prompts.shape[1]
    max_len = s + gen
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, max_len, frames=frames)
    steps = [logits[:, -1]]
    out = [steps[-1][:, :cfg.vocab_size].argmax(-1)[:, None]]
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(cache, out[-1], s + i)
        steps.append(logits[:, -1])
        out.append(steps[-1][:, :cfg.vocab_size].argmax(-1)[:, None])
    _sync(dev)
    return Generation(torch.cat(out, dim=1), torch.stack(steps, dim=1),
                      prefill_s, time.perf_counter() - t0)


def main(argv: Optional[Sequence[str]] = None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu for the host)")
    ap.add_argument("--dtype", default=None,
                    choices=("bfloat16", "float16", "float32"),
                    help="parameter and activation dtype (default: the "
                         "config's)")
    args = ap.parse_args(argv)

    from .._device import resolve_device
    dev = resolve_device(args.device)
    n = args.data_mesh * args.model_mesh
    if n == 1:
        return _serve(args, dev, None)

    import torch.distributed as dist

    from .mesh import join_group, make_host_mesh
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    backend = ("nccl" if dev.type == "cuda"
               and ranks_here <= torch.cuda.device_count() else "gloo")
    if args.batch % args.data_mesh:
        raise SystemExit(f"--batch {args.batch} does not split over "
                         f"--data-mesh {args.data_mesh}")
    if dev.type == "cuda" and dev.index is None:
        rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    made = join_group(args.data_mesh, args.model_mesh, backend, "serve")
    try:
        mesh = make_host_mesh(args.data_mesh, args.model_mesh,
                              device_type="cpu" if backend == "gloo"
                              else dev.type)
        return _serve(args, dev, mesh)
    finally:
        if made:
            dist.destroy_process_group()


def _serve(args, dev: torch.device, mesh) -> ServeRun:
    from ..models import get_model

    model = get_model(args.arch, reduced=args.reduced, device=dev,
                      dtype=args.dtype, mesh=mesh)
    cfg = model.cfg
    model.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.long, device=dev)
    frames = None
    if cfg.encdec:
        frames = torch.as_tensor(
            rng.normal(size=(args.batch, args.prompt_len, cfg.frontend_dim)),
            dtype=model.dtype, device=dev)
    rank = 0
    if mesh is not None:            # this data rank's rows
        import torch.distributed as dist
        rank = dist.get_rank()
        n = args.batch // args.data_mesh
        row = mesh.get_local_rank("data") * n
        prompts = prompts[row:row + n]
        frames = None if frames is None else frames[row:row + n]

    out = generate(model, prompts, args.gen, frames=frames)
    if rank == 0:
        b = prompts.shape[0]
        print(f"prefill: {b}x{args.prompt_len} in {out.prefill_s:.2f}s")
        steps = args.gen - 1
        print(f"decoded {steps} steps in {out.decode_s:.2f}s "
              f"({b * steps / max(out.decode_s, 1e-9):,.1f} tok/s)")
        print("sample:", out.tokens[0, :16].tolist())
    return ServeRun(model, prompts, frames, out)


if __name__ == "__main__":
    main()
