"""Dry run: count one rank's step of every (arch x shape x mesh) cell on
the production mesh, with nothing allocated and no card (the JAX
package's ``launch/dryrun.py``), for §Dry-run and §Roofline.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch arctic-480b --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results.jsonl

Where the JAX package compiles for 256 (512) placeholder devices and reads
XLA's analyses, the port runs the eager step of ONE rank, rank 0, on fake
tensors (``FakeTensorMode``: shapes, dtypes and a fake ``cuda`` device, no
storage), over a fake process group of 256 (512) ranks
(``torch.testing``'s ``FakeStore`` and the ``fake`` backend, whose
collectives move nothing), so that ``make_production_mesh`` sees its world
and the model splits over 'model' as it would.  ``--device cpu`` puts the
stand-ins on a fake host instead: the same ops, so the same counts.  Fake
``cuda`` tensors need a PyTorch built with CUDA (its bindings and autograd
take a CUDA device guard; no card is touched), so a build without CUDA
refuses the default and counts with ``--device cpu``.  Importing this
module sets nothing and initialises no group; ``main`` makes the fake group
and destroys it.

Per cell and rank it counts (``roofline/count.py``): FLOPs
(``FlopCounterMode``: matmul-class ops only), bytes accessed (inputs plus
outputs of every dispatched op: the unfused eager traffic), the arguments'
bytes exactly (weights, AdamW state, cache, batch), the peak and temporary
bytes of the live storages during the step, and every collective at the
dispatcher with its kind, group size, bytes and ring-model wire bytes.
``roofline/analysis.py`` turns them into the three-term roofline on H100
data-sheet constants.  Eager counts every layer, so the JAX package's
scan-body correction has nothing to correct: ``--no-correct`` is accepted
and changes nothing.  ``lower_s`` is the seconds to build the stand-ins
and ``compile_s`` those of the counted step (the keys ``report.py``
renders).  A record's ``fits`` says whether the predicted peak
(``memory.peak_hbm_est``) fits the card's 80 GB (``CARD_BYTES``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
from typing import Optional

from ..configs import ARCHS, get_config
from ..models.config import ALL_SHAPES, shape_by_name
from ..roofline.analysis import CARD_BYTES, analyze, model_flops
from .mesh import make_production_mesh
from .specs import input_specs, local_batch, step_fn


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.has_subquadratic_decode():
        return "SKIP(full-attn): 524k decode requires sub-quadratic mixer"
    return None


def _depth_variant(cfg, n_units: int):
    """``cfg`` cut to ``n_units`` scan units (a superblock, or a dense and
    a MoE layer, is one unit) and as many encoder layers at most.  The
    JAX package's variant also makes each q-block and SSD chunk one (its
    while loops count a body once); eager counts every block, so only the
    depth changes."""
    unit = cfg.superblock or (cfg.moe_every if cfg.is_moe and cfg.moe_every > 1
                              else 1)
    return dataclasses.replace(
        cfg, n_layers=unit * n_units,
        n_enc_layers=min(cfg.n_enc_layers, n_units) if cfg.encdec else 0)


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` with this process as rank 0,
    destroyed on exit; refuses to replace a group that exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group: "
                           "a group is initialised already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(data: int, model: int):
    """A (data, model) mesh over the fake group of ``data * model`` ranks
    that ``fake_world`` made; None for one rank (no group needed)."""
    if data * model == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (data, model),
                            mesh_dim_names=("data", "model"))


def _device(device: str) -> str:
    return "cuda:0" if device == "cuda" else device


def count_cell(arch: str, shape, mesh, *, device: str = "cuda",
               cfg_override=None, max_len: Optional[int] = None):
    """One rank's counted step of ``arch`` at ``shape`` (a ``ShapeSpec`` or
    its name) over ``mesh`` (None for one rank) -> ``(kind, count, info,
    build seconds)``; ``count`` is a ``roofline.count.StepCount``."""
    from ..roofline.count import count_step

    dev = _device(device)
    t0 = time.perf_counter()
    kind, args, info = input_specs(arch, shape, mesh,
                                   cfg_override=cfg_override, device=dev,
                                   max_len=max_len)
    build_s = time.perf_counter() - t0
    fn = step_fn(kind, info)
    with info["mode"]:
        _, count = count_step(fn, args)
    return kind, count, info, build_s


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             quiet: bool = False, correct_scan: bool = True,
             device: str = "cuda") -> dict:
    """The JAX package's record of one cell (``correct_scan`` has nothing
    to correct here; see the module docstring).  Counts over the fake
    group that ``main`` made, or one of its own."""
    import torch.distributed as dist

    reason = skip_reason(arch, shape_name)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if reason:
        rec["status"] = "skip"
        rec["reason"] = reason
        return rec
    if not dist.is_initialized():
        with fake_world(512 if multi_pod else 256):
            return run_cell(arch, shape_name, multi_pod, quiet, correct_scan,
                            device)

    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_devices = mesh.mesh.numel()
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    kind, count, info, build_s = count_cell(arch, shape, mesh, device=device)
    roof = analyze(count, model_flops(cfg, shape), n_devices)
    mem = count.memory()
    rec.update({
        "status": "ok",
        "kind": kind,
        "n_devices": n_devices,
        "device": device,
        "per_rank_batch": local_batch(shape.global_batch, mesh),
        "lower_s": round(build_s, 2),
        "compile_s": round(count.seconds, 2),
        "n_ops": count.n_ops,
        "memory": mem,
        "fits": mem["peak_hbm_est"] <= CARD_BYTES,
        "roofline": roof.as_dict(),
    })
    if not quiet:
        print(f"[{arch} × {shape_name} × {rec['mesh']}] kind={kind}")
        print(f"  memory: args={mem['argument_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_bytes']/2**30:.2f}GiB "
              f"out={mem['output_bytes']/2**30:.2f}GiB  (per rank; "
              f"{'fits' if rec['fits'] else 'does NOT fit'} 80 GB)")
        print(f"  count: flops/rank={roof.flops:.3e} "
              f"bytes/rank={roof.bytes_accessed:.3e} "
              f"wire/rank={roof.wire_bytes:.3e} ({count.n_ops} ops, "
              f"{count.seconds:.1f}s)")
        print(f"  roofline: compute={roof.t_compute*1e3:.2f}ms "
              f"memory={roof.t_memory*1e3:.2f}ms "
              f"collective={roof.t_collective*1e3:.2f}ms "
              f"-> bottleneck={roof.bottleneck} "
              f"useful={roof.useful_ratio:.2f} frac={roof.roofline_fraction:.3f}",
              flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES], default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch, shape) for the chosen mesh")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--no-correct", action="store_true",
                    help="accepted for the JAX package's command line; eager "
                         "counts every layer, so there is no scan-body "
                         "correction to skip")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the fake device of the stand-ins (default: the "
                         "card the dry run models)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in sorted(ARCHS):
            for s in ALL_SHAPES:
                cells.append((arch, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    failures = 0
    with fake_world(512 if args.multi_pod else 256):
        for arch, shape_name in cells:
            try:
                rec = run_cell(arch, shape_name, args.multi_pod,
                               correct_scan=not args.no_correct,
                               device=args.device)
            except Exception as e:  # a failure here is a bug in the system
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": "2x16x16" if args.multi_pod else "16x16",
                       "status": "fail", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                failures += 1
                print(f"[{arch} × {shape_name}] FAILED: {rec['error']}",
                      file=sys.stderr)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
