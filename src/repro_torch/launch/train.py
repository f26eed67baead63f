"""Training launcher: config-driven, fault-tolerant, restartable (the JAX
package's ``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
      [--resume] --device cpu

What it does, end to end:
  * deterministic data as a function of step (``TokenPipeline``), each rank
    taking its ``host_slice`` of the global batch;
  * periodic async checkpoints (atomic publish), rank 0 writing;
  * SIGTERM -> checkpoint-and-exit (``PreemptionGuard``), agreed by every
    rank before anyone stops;
  * resume from the latest checkpoint, on any ``--data-mesh``;
  * straggler detection hooks and gradient compression (which, as in the
    JAX package, models the numerics and does not narrow the wire).

Log lines (rank 0): ``step N loss L gnorm G lr R T tok/s`` every
``--log-every`` steps and at the last, with `` [straggler]`` on a slow
step; ``resumed from step N``; ``SIGTERM received: checkpointing and
exiting``; ``done``.  ``loss`` is the global batch's mean (the ranks'
means averaged in the gradient all-reduce), ``gnorm`` the gradients'
global norm before the clip, ``lr`` the schedule's rate for the step,
``tok/s`` the global batch's tokens over the step's host wall time.

``--device`` defaults to the card and raises without one.  ``--data-mesh
D --model-mesh M`` runs on a (D, M) mesh over a ``torch.distributed``
group of D * M ranks: the one ``torchrun`` describes in the environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or, for a
1 x 1 mesh and no such environment, a one-rank group made here.  Each
model group holds one copy of the model split over its M ranks (tensor
and expert parallelism, ``Model(mesh=)``) and takes one data slice;
gradients are averaged over the D data ranks.  The backend is gloo on
``cpu`` and NCCL on ``cuda`` (``--dist-backend gloo`` lets ranks share one
card).  Checkpoints hold the full arrays whatever the mesh, so a run
resumes on any other.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..checkpoint import CheckpointManager, PreemptionGuard, StragglerMonitor
from ..data import TokenPipeline
from ..models import get_model
from ..parallel import sharding as shd
from ..train import AdamWConfig, init_state, make_train_step
from .mesh import join_group, make_host_mesh


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default=None,
                    choices=[None, "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu for the host)")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend (default: gloo on cpu, "
                         "nccl on cuda)")
    return ap.parse_args(argv)


def _agree(flag: bool, group, device: torch.device) -> bool:
    """True on every rank when any rank's ``flag`` is set."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = _parse(argv)
    dev = resolve_device(args.device)
    backend = args.dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda" and dev.index is None:
        rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    made = join_group(args.data_mesh, args.model_mesh, backend, "train")
    try:
        # gloo ranks sharing a card mesh on the host
        mesh = make_host_mesh(args.data_mesh, args.model_mesh,
                              device_type="cpu" if backend == "gloo"
                              else dev.type)
        _train(args, dev, mesh, mesh["data"].get_group())
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, dev, mesh, group) -> None:
    rank = dist.get_rank()
    model = get_model(args.arch, reduced=args.reduced, device=dev,
                      mesh=mesh)
    cfg = model.cfg
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20),
                          state_dtype=cfg.opt_state_dtype)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    guard = PreemptionGuard().install()
    straggler = StragglerMonitor()

    with shd.sharding_ctx(mesh):
        model.init(torch.Generator(device=dev).manual_seed(args.seed))
        opt_state = init_state(model, opt_cfg)
        start_step = 0
        if args.resume and mgr and mgr.latest_step() is not None:
            (model, opt_state), manifest = mgr.restore((model, opt_state))
            start_step = manifest["step"]
            if rank == 0:
                print(f"resumed from step {start_step}", flush=True)

        step_fn = make_train_step(model, opt_cfg,
                                  n_microbatches=args.microbatches,
                                  compression=args.compression, group=group)
        n_tok = args.batch * args.seq
        for step in range(start_step, args.steps):
            t0 = time.time()
            batch = pipe.host_slice(step, mesh.get_local_rank("data"),
                                    args.data_mesh)
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            slow = straggler.record(dt)
            if rank == 0 and (step % args.log_every == 0
                              or step == args.steps - 1):
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"{n_tok/dt:,.0f} tok/s"
                      f"{'  [straggler]' if slow else ''}", flush=True)
            should_ckpt = mgr and (step + 1) % args.ckpt_every == 0
            if _agree(guard.requested, dist.group.WORLD, dev):
                if rank == 0:
                    print("SIGTERM received: checkpointing and exiting",
                          flush=True)
                if mgr:
                    mgr.save(step + 1, (model, opt_state), blocking=True)
                guard.uninstall()
                return
            if should_ckpt:
                mgr.save(step + 1, (model, opt_state))
        if mgr:
            mgr.save(args.steps, (model, opt_state), blocking=True)
        guard.uninstall()
        if rank == 0:
            print("done", flush=True)


if __name__ == "__main__":
    main()
