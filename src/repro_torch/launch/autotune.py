"""Offline autotune sweep: time the launch-config lattice of the counting
kernels and save the per-(device kind, geometry bucket) winners as a JSON
tuning table (``roofline/autotune.py`` is the library; this is the entry
point, the twin of the JAX package's ``tools/autotune.py``).

  PYTHONPATH=src python -m repro_torch.launch.autotune --preset main
  PYTHONPATH=src python -m repro_torch.launch.autotune -g 969130,34220,2,2
  PYTHONPATH=src python -m repro_torch.launch.autotune --smoke --device cpu

The table is written to ``--out``, or else to the user cache
(``~/.cache/repro_torch/autotune/<device-kind>.json``), where the resolution
seam finds it; ``$REPRO_TORCH_TUNE_TABLE`` points the seam at any other
file.  Every run round-trips the saved file through the schema-checked
loader and proves that it resolves before reporting success.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

# Geometry presets: (N, K, W, C) per launch.  "main" is the Minority-Report
# main path on the paper's 1,000,000-row simulation (U = 969,130 unique rows):
# level 2, level 3 and the fused two-class pass.  "ci" keeps the JAX
# package's preset (>= 2 row buckets, so the derived chooser thresholds
# have a slope to fit).
PRESETS = {
    "main": [(969130, 1770, 2, 2), (969130, 34220, 2, 2),
             (969130, 1830, 2, 2)],
    "ci": [(16384, 256, 2, 2), (4096, 256, 2, 2), (1024, 256, 2, 2)],
}


def _parse_geometry(text: str):
    parts = [int(p) for p in text.replace("x", ",").split(",") if p]
    if len(parts) != 4 or any(p <= 0 for p in parts):
        raise argparse.ArgumentTypeError(
            f"geometry must be 4 positive ints N,K,W,C — got {text!r}")
    return tuple(parts)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-g", "--geometry", action="append", default=[],
                    type=_parse_geometry, metavar="N,K,W,C",
                    help="launch geometry to tune (repeatable)")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="main",
                    help="geometry preset when no -g given (default: main)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="best-of-N timing per candidate (default: 5)")
    ap.add_argument("--out", default=None,
                    help="output path (default: the user cache for this "
                         "device kind)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweep; assert the table saves, loads and "
                         "resolves")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: time the CUDA kernels) or cpu (the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..roofline import autotune

    device = resolve_device(args.device)
    kind = autotune.device_kind() if device.type == "cuda" else "cpu"
    created = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    out = args.out or autotune.cache_table_path(kind)

    if args.smoke:
        geometries = [(256, 16, 1, 1), (1024, 16, 1, 1)]
        table = autotune.sweep(geometries, repeats=2, block_ks=(128, 256),
                               kind=kind, created=created, log=print,
                               device=device)
        autotune.save_table(table, out)
        loaded = autotune.load_table(out)
        if not loaded.entries or loaded.device_kind != kind:
            raise SystemExit(f"smoke sweep table at {out} is empty or of "
                             f"another device kind")
        autotune.set_active_table(loaded)
        try:
            cfg = autotune.resolve_launch_config(256, 16, 1, 1)
        finally:
            autotune.set_active_table(None)
        if cfg.source != "table":
            raise SystemExit(f"smoke table does not resolve: {cfg}")
        print(f"autotune smoke OK ({len(loaded.entries)} entries, "
              f"saved+loaded+resolved via {out})")
        return 0

    geometries = args.geometry or PRESETS[args.preset]
    t0 = time.perf_counter()
    table = autotune.sweep(geometries, repeats=args.repeats, kind=kind,
                           created=created, log=print, device=device)
    dt = time.perf_counter() - t0
    autotune.save_table(table, out)
    loaded = autotune.load_table(out)     # prove the round trip
    if autotune.table_to_dict(loaded) != autotune.table_to_dict(table):
        raise SystemExit(f"tuning table at {out} did not round-trip")

    print(f"\ntuning table [{kind}] {len(table.entries)} buckets "
          f"in {dt:.1f}s -> {out}")
    for bucket, e in sorted(table.entries.items()):
        print(f"  {bucket}: bk{e.config.block_k}/{e.config.accum}"
              f" chunk_rows={e.config.chunk_rows or 'auto'}"
              f" serve_block_k={e.serve_block_k or 'default'}"
              f" ({e.us:.0f}us, eff={e.efficiency:.3g})")
    derived = autotune.derived_chooser_thresholds(loaded)
    if derived:
        print(f"derived chooser thresholds: {derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
