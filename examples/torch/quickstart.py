"""Quickstart: the paper's §4.2 worked example, end to end.

Runs the Minority-Report Algorithm (GFP-growth inside) on the 8-transaction
database of Table 1 and prints every intermediate the paper prints —
item selection, TIS-tree counts, g-counts, and the five rules — then runs the
same mine on the Hopper dense engine and shows they agree.

  PYTHONPATH=src python examples/torch/quickstart.py [--device cuda|cpu]
"""
import argparse

from repro_torch._device import resolve_device
from repro_torch.core import minority_report
from repro_torch.mining import minority_report_dense

DB = [
    (list("facdgimp"), 0),   # TID 100
    (list("abcflmo"), 0),    # TID 200
    (list("bfhjo"), 0),      # TID 300
    (list("bcksp"), 0),      # TID 400
    (list("afcelpmn"), 0),   # TID 500
    (list("fm"), 1),         # TID 600
    (list("c"), 1),          # TID 700
    (list("b"), 1),          # TID 800
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernel) or cpu (the plain "
                         "PyTorch version)")
    device = resolve_device(ap.parse_args().device)
    tx = [t for t, _ in DB]
    y = [c for _, c in DB]

    print("=== paper-faithful engine (FP-trees + GFP-growth) ===")
    res = minority_report(tx, y, min_support=0.125, min_confidence=0.2)
    print(f"I' (items frequent in rare class): {sorted(res.items_kept)}")
    print(f"TIS-tree: {res.tis.n_targets} target itemsets")
    for key, c1 in sorted(res.tis.as_dict('count').items()):
        g = res.tis.as_dict('g_count')[key]
        print(f"  {{{','.join(map(str, key))}}}: count(C1)={c1} g-count(C0)={g}")
    print("rules:")
    for r in res.rules:
        print("  ", r)
    print(f"GFP stats: {res.stats}")

    print("\n=== Hopper dense engine (bitmaps + itemset-count CUDA kernel) ===")
    dres = minority_report_dense(tx, y, min_support=0.125, min_confidence=0.2,
                                 device=device)
    for r in dres.rules:
        print("  ", r)
    a = {r.antecedent: (r.count, r.g_count) for r in res.rules}
    b = {r.antecedent: (r.count, r.g_count) for r in dres.rules}
    assert a == b
    print(f"\nengines agree on all {len(a)} rules "
          f"({dres.kernel_launches} kernel launches)")


if __name__ == "__main__":
    main()
