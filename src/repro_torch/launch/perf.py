"""§Perf hillclimb: count a cell under a named config variant and
report the roofline delta against the baseline config (the JAX package's
``launch/perf.py``, over the port's dry run, ``launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.perf --arch arctic-480b \\
      --shape train_4k --variant moe_gather

Variants are explicit, named hypotheses (see VARIANTS below); each run prints
baseline and variant three-term rooflines on H100 data-sheet constants.
These are counts, not times on a card.  ``attn_kv_seq`` is refused: the
port attends by heads in train and prefill for every arch (ROADMAP §3),
so ``force_kv_seq_attn`` changes nothing it runs, and a null delta
would read as a measured one.
"""
import argparse
import dataclasses

from ..configs import ARCHS, get_config
from ..models.config import ALL_SHAPES, shape_by_name
from ..roofline.analysis import analyze, model_flops
from .dryrun import count_cell, fake_world
from .mesh import make_production_mesh


def v_moe_gather(cfg):
    """MoE dispatch via sort/gather buffers instead of one-hot einsums —
    hypothesis: removes the 2·T·(E·C)·D dispatch/combine FLOPs (~30-70% of
    MoE-layer HLO flops) and the (T,E,C) transient."""
    return dataclasses.replace(cfg, moe_impl="gather")


def v_no_remat(cfg):
    """Disable activation rematerialization — hypothesis: removes the
    recomputed forward (~25% of train FLOPs) and its re-gathers, paying
    activation HBM instead.  Only sane where memory headroom exists."""
    return dataclasses.replace(cfg, remat=False)


def v_attn_kv_seq(cfg):
    """Force the kv_seq (split-KV) attention sharding even when heads divide
    the mesh — hypothesis: k/v stay seq-sharded (no repeat-to-heads gather);
    scores psum over 'model' instead.  Wins when Skv is large vs H."""
    return dataclasses.replace(cfg, force_kv_seq_attn=True)


def v_cap_075(cfg):
    """Capacity factor 1.0 -> 0.75 — hypothesis: linear cut of expert-FFN and
    dispatch FLOPs/bytes at the cost of more dropped tokens (quality trade
    recorded, not evaluated here)."""
    return dataclasses.replace(cfg, capacity_factor=0.75)


def v_groups_x2(cfg):
    """Double dispatch groups — hypothesis: halves the (T_g,E,C) dispatch
    transient and its HBM traffic at equal FLOPs."""
    return dataclasses.replace(cfg, moe_groups_per_dp=cfg.moe_groups_per_dp * 2)


def v_chunk_512(cfg):
    """SSD chunk 128/256 -> 512 — hypothesis: fewer inter-chunk scan steps
    (less state HBM traffic) at quadratically larger intra-chunk matmuls;
    helps while compute term has headroom."""
    return dataclasses.replace(cfg, ssm_chunk=512)


def v_qblock_2048(cfg):
    """Attention q-block 512 -> 2048 — hypothesis: 4x fewer scan steps and
    score-tile launches; raises transient memory by 4x."""
    return dataclasses.replace(cfg, attn_block_q=2048)


def v_mb4(cfg):
    """4 gradient-accumulation microbatches — hypothesis: activation
    transients (the (B,S,D)-sized live set dominating MoE train temp) shrink
    ~4x; FSDP weight re-gathers go up ~4x (wire trade)."""
    return dataclasses.replace(cfg, train_microbatches=4)


def v_mb8(cfg):
    return dataclasses.replace(cfg, train_microbatches=8)


VARIANTS = {
    "mb4": v_mb4,
    "mb8": v_mb8,
    "moe_gather": v_moe_gather,
    "no_remat": v_no_remat,
    "attn_kv_seq": v_attn_kv_seq,
    "cap_0.75": v_cap_075,
    "groups_x2": v_groups_x2,
    "ssd_chunk_512": v_chunk_512,
    "qblock_2048": v_qblock_2048,
}

# variants the port refuses, and why
REFUSED = {
    "attn_kv_seq": "the port attends by heads in train and prefill for every "
                   "arch (ROADMAP §3): force_kv_seq_attn changes "
                   "nothing it runs, so the variant is refused rather than "
                   "reported as a null delta",
}


def measure(arch, shape_name, mesh, cfg, n_devices, device="cuda"):
    """The counted roofline and memory of ``cfg`` at ``shape_name`` over
    ``mesh`` (every layer counted; no depth extrapolation)."""
    if cfg.force_kv_seq_attn != get_config(arch).force_kv_seq_attn:
        raise ValueError(f"attn_kv_seq: {REFUSED['attn_kv_seq']}")
    shape = shape_by_name(shape_name)
    _, count, _, _ = count_cell(arch, shape, mesh, device=device,
                                cfg_override=cfg)
    roof = analyze(count, model_flops(get_config(arch), shape), n_devices)
    return roof, count.memory()


def fmt(roof, mem) -> str:
    return (f"compute={roof.t_compute*1e3:9.1f}ms memory={roof.t_memory*1e3:9.1f}ms "
            f"collective={roof.t_collective*1e3:9.1f}ms bottleneck={roof.bottleneck:10s} "
            f"useful={roof.useful_ratio:5.2f} frac={roof.roofline_fraction:6.3f} "
            f"temp={mem['temp_bytes']/2**30:6.2f}GiB args={mem['argument_bytes']/2**30:6.2f}GiB")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--shape", choices=[s.name for s in ALL_SHAPES], required=True)
    ap.add_argument("--variant", choices=sorted(VARIANTS), required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the fake device of the dry run's stand-ins")
    args = ap.parse_args(argv)
    if args.variant in REFUSED:
        ap.error(f"--variant {args.variant}: {REFUSED[args.variant]}")

    with fake_world(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type="cpu")
        n = mesh.mesh.numel()
        base_cfg = get_config(args.arch)
        if not args.skip_baseline:
            roof, mem = measure(args.arch, args.shape, mesh, base_cfg, n,
                                args.device)
            print(f"BASELINE {args.arch}×{args.shape}: {fmt(roof, mem)}")
        vcfg = VARIANTS[args.variant](base_cfg)
        roof, mem = measure(args.arch, args.shape, mesh, vcfg, n, args.device)
        print(f"VARIANT[{args.variant}] {args.arch}×{args.shape}: "
              f"{fmt(roof, mem)}")


if __name__ == "__main__":
    main()
