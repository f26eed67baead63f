"""Roofline analysis of one rank's step, from the dry run's count (the JAX
package's ``roofline/analysis.py``).

Three terms per (arch x shape x mesh) cell, each in seconds a step on the
TARGET, one NVIDIA H100 SXM card a rank (data-sheet constants: nothing here
was measured, and no multi-card host has measured either link rate):

  compute    = FLOPs a rank                      / PEAK_FLOPS
  memory     = bytes accessed a rank             / HBM_BW
  collective = sum over collectives of wire bytes / the link rate of its group

The count comes from ``launch/dryrun.py``: one rank's eager step run on fake
tensors (``roofline/count.py``).  XLA's post-partitioning HLO, which the
JAX package parses for its collectives, has no torch counterpart; the dry
run sees each collective at the dispatcher instead, with its true dtype
(so no bf16-upcast adjustment is needed) and its group's size.

Link rates.  Within an HGX node of ``NODE_SIZE`` = 8 cards, NVLink 4 at
``NVLINK_BW`` = 450 GB/s a direction (900 GB/s both ways); across nodes,
``NODE_LINK_BW`` = 50 GB/s a card (one NDR 400 Gb/s InfiniBand port).  A
collective whose group spans more than 8 ranks crosses nodes, and its ring
is held to the slower rate: the whole of its wire is charged at
``NODE_LINK_BW``.  Both axes of the production mesh (16 x 16, and the
pod axis of 2 x 16 x 16) span more than 8 ranks, so every collective of a
production cell is charged at 50 GB/s; only small meshes (at most 8 ranks
a group) see NVLink's rate.

The ring model (``ring_wire_bytes``) is the JAX package's, per op kind:
all-reduce ``2 b (n - 1) / n``, all-gather ``b (n - 1) / n`` of the gathered
result, reduce-scatter ``b (n - 1)`` of the scattered shard, all-to-all
``b (n - 1) / n``, collective-permute ``b``; plus broadcast ``b`` (the
pipeline's output broadcast: every rank but the root receives the buffer
once), which the JAX package's HLO never holds.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

# --- target hardware constants (NVIDIA H100 SXM data sheet, per card) -------
PEAK_FLOPS = 989e12      # bf16 FLOP/s, dense
HBM_BW = 3.35e12         # bytes/s, HBM3
CARD_BYTES = 80 * 10**9  # HBM3 a card, 80 GB
NVLINK_BW = 450e9        # bytes/s a direction, NVLink 4, within a node
NODE_LINK_BW = 50e9      # bytes/s a card across nodes (NDR 400 Gb/s)
NODE_SIZE = 8            # cards an HGX node joins by NVLink
LINK_BW = NODE_LINK_BW   # the rate of a group that spans nodes

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")


def ring_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes a rank puts on the wire for one collective of ``kind`` over
    ``n`` ranks whose result is ``result_bytes`` a rank (the ring model)."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective kind {kind!r}")
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac
    if kind == "all-gather":
        return result_bytes * frac        # result is the gathered (big) shape
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)     # result is the scattered shard
    if kind == "all-to-all":
        return result_bytes * frac
    return float(result_bytes)            # collective-permute, broadcast


def link_bw(n: int) -> float:
    """The link rate a collective over ``n`` ranks is charged at."""
    return NVLINK_BW if n <= NODE_SIZE else NODE_LINK_BW


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    result_bytes: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    wire_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # seconds of each kind on its group's link (``link_bw``): the port's
    # addition, since its two link rates make the wire alone not a time
    link_seconds: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_link_seconds(self) -> float:
        return sum(self.link_seconds.values())

    def add(self, kind: str, result_bytes: int, n: int) -> None:
        """One collective of ``kind`` over ``n`` ranks (none where n = 1)."""
        if n <= 1:
            return
        wire = ring_wire_bytes(kind, result_bytes, n)
        self.counts[kind] += 1
        self.result_bytes[kind] += result_bytes
        self.wire_bytes[kind] += wire
        self.link_seconds[kind] += wire / link_bw(n)

    def as_dict(self) -> dict:
        return {"counts": dict(self.counts),
                "result_bytes": dict(self.result_bytes),
                "wire_bytes": {k: float(v) for k, v in self.wire_bytes.items()},
                "total_wire_bytes": float(self.total_wire_bytes),
                "link_seconds": {k: float(v)
                                 for k, v in self.link_seconds.items()}}


@dataclass
class Roofline:
    flops: float                 # per device
    bytes_accessed: float        # per device
    wire_bytes: float            # per device
    collectives: CollectiveStats
    model_flops: float = 0.0     # analytic useful FLOPs per device
    n_devices: int = 1

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        """Each collective's wire at its group's rate (``link_bw``)."""
        if self.collectives.link_seconds:
            return self.collectives.total_link_seconds
        return self.wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs.  The port counts matmul-class ops
        only (``FlopCounterMode``), where XLA's ``cost_analysis`` also
        counts elementwise work: so this is the share of the matmul work
        that is useful (remat's recompute, MoE dispatch einsums, padded
        vocab and capacity slots are not), and it may exceed 1 where
        ``model_flops`` charges work the port does not run as a matmul."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful FLOPs / (step_time * peak) — the MFU-at-roofline score."""
        t = self.step_time
        return self.model_flops / (t * PEAK_FLOPS) if t else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "wire_bytes_per_device": self.wire_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_device": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives.as_dict(),
        }


def analyze(count, model_flops_total: float, n_devices: int) -> Roofline:
    """The roofline of one rank's counted step (``count.StepCount``: its
    FLOPs, bytes accessed and collectives), with ``model_flops_total``
    shared over ``n_devices``."""
    stats = count.collectives
    return Roofline(
        flops=float(count.flops),
        bytes_accessed=float(count.bytes_accessed),
        wire_bytes=stats.total_wire_bytes,
        collectives=stats,
        model_flops=model_flops_total / n_devices,
        n_devices=n_devices,
    )


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step: 6·N_active·D for training,
    2·N_active·D for prefill, 2·N_active·B per decoded token (+attention reads
    are bytes, not FLOPs — attention matmul FLOPs added explicitly)."""
    n_active = cfg.n_active_params()
    tokens = shape.seq_len * shape.global_batch
    # attention score+value matmul FLOPs (causal => /2)
    attn = 0.0
    n_attn_layers = sum(1 for i in range(cfg.n_layers)
                        if cfg.layer_kind(i) == "attn")
    if cfg.n_heads:
        h, dh = cfg.n_heads, cfg.d_head
        if shape.kind in ("train", "prefill"):
            attn = (2.0 * tokens * shape.seq_len * h * dh * 2 / 2) * n_attn_layers
        else:  # decode: 1 new token vs seq_len cache
            attn = (2.0 * shape.global_batch * shape.seq_len * h * dh * 2) * n_attn_layers
    if shape.kind == "train":
        return 6.0 * n_active * tokens + 3.0 * attn
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens + attn
    return 2.0 * n_active * shape.global_batch + attn
