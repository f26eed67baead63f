"""End-to-end driver: minority-class rule mining on census-like data —
the paper's Fig-6 experiment shape (imbalanced 'salary' target, 115 items,
p_Y-resampled), comparing:

  1. full FP-growth over the whole DB (the "well-known solution" baseline),
  2. the Minority-Report Algorithm (paper-faithful GFP-growth),
  3. the Hopper dense engine (bitmap + the itemset-count CUDA kernel),
  4. the streaming out-of-core engine (same kernel, N swept in host chunks,
     each chunk added into the running counts).

All four must produce identical rule sets; times illustrate the paper's
speedup claim (GFP focuses work on the rare class) and the streaming
engine's overhead for unbounded-N operation.

  PYTHONPATH=src python examples/torch/minority_report_census.py \
      [p_y ...] [--device cuda|cpu]
"""
import argparse
import time

from repro_torch._device import resolve_device
from repro_torch.core import full_fpgrowth_rules, minority_report
from repro_torch.data import census_like_db
from repro_torch.mining import minority_report_dense


def run(p_y: float, rows: int = 8000, min_support: float = 5e-4,
        min_conf: float = 0.3, *, device=None) -> None:
    device = resolve_device(device)
    tx, y = census_like_db(rows, p_y, seed=42)
    print(f"\n--- p_y={p_y} rows={rows} rare={int(y.sum())} "
          f"min_sup={min_support} ---")

    t0 = time.time()
    base = full_fpgrowth_rules(tx, y, min_support=min_support,
                               min_confidence=min_conf)
    t_full = time.time() - t0

    t0 = time.time()
    mra = minority_report(tx, y, min_support=min_support,
                          min_confidence=min_conf)
    t_mra = time.time() - t0

    t0 = time.time()
    dense = minority_report_dense(tx, y, min_support=min_support,
                                  min_confidence=min_conf, device=device)
    t_dense = time.time() - t0

    t0 = time.time()
    stream = minority_report_dense(tx, y, min_support=min_support,
                                   min_confidence=min_conf,
                                   streaming=True, chunk_rows=1024,
                                   device=device)
    t_stream = time.time() - t0

    a = {r.antecedent: (r.count, r.g_count) for r in base}
    b = {r.antecedent: (r.count, r.g_count) for r in mra.rules}
    c = {r.antecedent: (r.count, r.g_count) for r in dense.rules}
    d = {r.antecedent: (r.count, r.g_count) for r in stream.rules}
    assert a == b == c == d, (len(a), len(b), len(c), len(d))

    print(f"rules: {len(b)} (identical across engines)")
    print(f"full FP-growth: {t_full:8.2f}s   (baseline)")
    print(f"MRA/GFP-growth: {t_mra:8.2f}s   ({t_full / max(t_mra, 1e-9):5.1f}x)")
    print(f"dense (kernel): {t_dense:8.2f}s   ({t_full / max(t_dense, 1e-9):5.1f}x)")
    print(f"streaming     : {t_stream:8.2f}s   ({t_full / max(t_stream, 1e-9):5.1f}x, "
          f"out-of-core chunks of 1024 rows)")
    for r in mra.rules[:5]:
        print("   ", r)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("p_y", nargs="*", type=float,
                    help="rare-class rates to run (default 0.01 0.05 0.25)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernel) or cpu (the plain "
                         "PyTorch version)")
    args = ap.parse_args()
    device = resolve_device(args.device)
    for p_y in args.p_y or [0.01, 0.05, 0.25]:
        run(p_y, device=device)


if __name__ == "__main__":
    main()
