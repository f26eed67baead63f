"""Render §Dry-run and §Roofline markdown tables from sweep JSONL records
(a copy of the JAX package's ``roofline/report.py``: the port's dry-run
records have the JAX package's keys, so one renderer serves both), and the
port's ``rank_table``: a rank's memory, work and fit against 80 GB.

  PYTHONPATH=src python -m repro_torch.roofline.report results_single_pod.jsonl \
      [results_multi_pod.jsonl]
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional


def load(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def _gib(x: float) -> str:
    return f"{x / 2**30:.2f}"


def dryrun_table(recs: List[dict]) -> str:
    lines = [
        "| arch | shape | mesh | kind | compile | args GiB/dev | temp GiB/dev | "
        "HLO GFLOP/dev | wire GB/dev | collectives (ar/ag/rs/a2a/cp) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skip":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | "
                         f"SKIP | — | — | — | — | {r['reason']} |")
            continue
        if r["status"] == "fail":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | "
                         f"**FAIL** | — | — | — | — | {r['error'][:60]} |")
            continue
        m, roof = r["memory"], r["roofline"]
        c = roof["collectives"]["counts"]
        counts = "/".join(str(c.get(k, 0)) for k in
                          ("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all", "collective-permute"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['kind']} | "
            f"{r['compile_s']}s | {_gib(m['argument_bytes'])} | "
            f"{_gib(m['temp_bytes'])} | {roof['flops_per_device']/1e9:,.0f} | "
            f"{roof['wire_bytes_per_device']/1e9:.1f} | {counts} |")
    return "\n".join(lines)


def roofline_table(recs: List[dict]) -> str:
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck | "
        "MODEL/HLO | roofline frac | what would move the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            continue
        roof = r["roofline"]
        hint = _hint(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {roof['t_compute_s']*1e3:,.1f}ms | "
            f"{roof['t_memory_s']*1e3:,.1f}ms | {roof['t_collective_s']*1e3:,.1f}ms | "
            f"**{roof['bottleneck']}** | {roof['useful_ratio']:.2f} | "
            f"{roof['roofline_fraction']:.3f} | {hint} |")
    return "\n".join(lines)


def _hint(r: dict) -> str:
    roof = r["roofline"]
    b = roof["bottleneck"]
    kind = r["kind"]
    wire = roof["collectives"]["wire_bytes"]
    if b == "collective":
        top = max(wire, key=wire.get) if wire else "?"
        return (f"biggest wire item is {top}: fewer/narrower activation "
                f"reshards (SP gather-once, RS instead of AR, int8 grads)")
    if b == "memory":
        if kind == "decode":
            return "KV/weight reads dominate: quantize KV cache, fuse decode attention"
        return "remat recompute + activation traffic: looser remat policy, fused norms"
    return "MXU-bound: raise arithmetic intensity (larger tiles, bf16 dots)"


def rank_table(recs: List[dict], mrecs: Optional[List[dict]] = None) -> str:
    """The port's addition: one row a counted cell with what a rank holds
    and does (argument, temporary and peak GiB; GFLOP; wire GB; the three
    roofline terms) and whether its peak (``memory.peak_hbm_est``) fits
    the H100's 80 GB; with ``mrecs``, the multi-pod peak and fit beside."""
    from .analysis import CARD_BYTES

    def fit(r):
        peak = r["memory"]["peak_hbm_est"]
        return f"{_gib(peak)} {'yes' if peak <= CARD_BYTES else 'no'}"

    multi = {(r["arch"], r["shape"]): r for r in mrecs or []
             if r["status"] == "ok"}
    lines = [
        "| arch | shape | args / temp GiB | peak GiB, fits 80 GB | GFLOP | "
        "wire GB | compute / memory / collective ms |"
        + (" multi-pod peak, fits |" if mrecs else ""),
        "|---|---|---|---|---|---|---|" + ("---|" if mrecs else ""),
    ]
    for r in recs:
        if r["status"] != "ok":
            continue
        m, roof = r["memory"], r["roofline"]
        row = (f"| {r['arch']} | {r['shape']} | {_gib(m['argument_bytes'])} /"
               f" {_gib(m['temp_bytes'])} | {fit(r)} | "
               f"{roof['flops_per_device']/1e9:,.0f} | "
               f"{roof['wire_bytes_per_device']/1e9:.1f} | "
               f"{roof['t_compute_s']*1e3:,.1f} / "
               f"{roof['t_memory_s']*1e3:,.1f} / "
               f"{roof['t_collective_s']*1e3:,.1f} |")
        if mrecs:
            mr = multi.get((r["arch"], r["shape"]))
            row += f" {fit(mr) if mr else '—'} |"
        lines.append(row)
    return "\n".join(lines)


def main() -> None:
    recs = load(sys.argv[1])
    print("### Dry-run (single pod 16x16)\n")
    print(dryrun_table(recs))
    print("\n### Roofline (single pod 16x16)\n")
    print(roofline_table(recs))
    if len(sys.argv) > 2:
        mrecs = load(sys.argv[2])
        print("\n### Dry-run (multi-pod 2x16x16)\n")
        print(dryrun_table(mrecs))
    else:
        mrecs = None
    print("\n### A rank's memory, work and fit (single pod; multi-pod "
          "beside)\n")
    print(rank_table(recs, mrecs))


if __name__ == "__main__":
    main()
