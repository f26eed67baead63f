"""The port's roofline (``repro_torch/roofline/analysis.py`` and
``report.py``) against the JAX package's (``repro/roofline/``, which
imports no JAX): ``model_flops`` equal for every arch x shape, the ring
model equal to ``collective_bytes`` on HLO lines of every kind, the same
tables rendered from the same records by both packages, the reference's
own sanity tests re-run on the port, and the H100 constants and link
rates."""
import math

import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models.config import ALL_SHAPES as JAX_SHAPES
from repro.roofline import analysis as jan
from repro.roofline import report as jreport
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.config import ALL_SHAPES, DECODE_32K, TRAIN_4K
from repro_torch.roofline import analysis as an
from repro_torch.roofline import report

CELLS = [(a, s.name) for a in sorted(ARCHS) for s in ALL_SHAPES]


def test_same_archs_and_shapes_as_the_reference():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    assert [s.name for s in ALL_SHAPES] == [s.name for s in JAX_SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equals_the_reference(arch, shape):
    port_shape = {s.name: s for s in ALL_SHAPES}[shape]
    jax_shape = {s.name: s for s in JAX_SHAPES}[shape]
    assert an.model_flops(get_config(arch), port_shape) == \
        jan.model_flops(jax_config(arch), jax_shape)


def test_model_flops_sane():
    """The reference's ``test_model_flops_sane``, on the port."""
    cfg = get_config("qwen3-8b")
    f_train = an.model_flops(cfg, TRAIN_4K)
    # 6*N*D within 2x of parameter-only estimate (attention adds more)
    n, d = cfg.n_params(), TRAIN_4K.seq_len * TRAIN_4K.global_batch
    assert 6 * n * d <= f_train <= 2 * 6 * n * d
    f_dec = an.model_flops(cfg, DECODE_32K)
    assert f_dec < f_train / 100


def test_moe_active_params():
    """The reference's ``test_moe_active_params``, on the port."""
    cfg = get_config("arctic-480b")
    assert cfg.n_params() > 400e9
    assert cfg.n_active_params() < 0.1 * cfg.n_params()


# HLO lines as XLA writes them (the reference's HLO_SAMPLE, widened): the
# result type, the op and an iota replica group of size n
def _hlo(kind, dtype, dims, n):
    shape = f"{dtype}[{','.join(map(str, dims))}]{{1,0}}"
    if kind == "collective-permute":
        return (f"  %x = {shape} collective-permute(%y), channel_id=1, "
                "source_target_pairs={{0,1}}")
    return (f"  %x = {shape} {kind}(%y), channel_id=1, "
            f"replica_groups=[{64 // n},{n}]<=[64], to_apply=%add")


WIDTH = {"f32": 4, "bf16": 2, "s32": 4, "u8": 1}


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("n", [2, 4, 16, 32])
def test_ring_model_equals_the_reference_parser(kind, n):
    for dtype, dims in (("f32", (64, 128)), ("bf16", (256, 64)),
                        ("s32", (3,)), ("u8", (7, 5, 2))):
        stats = jan.collective_bytes(_hlo(kind, dtype, dims, n),
                                     adjust_bf16_upcast=False)
        assert stats.counts == {kind: 1}
        b = math.prod(dims) * WIDTH[dtype]
        assert stats.result_bytes[kind] == b
        group = 2 if kind == "collective-permute" else n
        assert an.ring_wire_bytes(kind, b, group) == \
            pytest.approx(stats.wire_bytes[kind], rel=0, abs=0)
        port = an.CollectiveStats()
        port.add(kind, b, group)
        got = port.as_dict()
        want = stats.as_dict()
        for key in ("counts", "result_bytes", "wire_bytes",
                    "total_wire_bytes"):
            assert got[key] == want[key]


def test_ring_model_edges():
    assert an.ring_wire_bytes("all-reduce", 1000, 1) == 0.0
    assert an.ring_wire_bytes("broadcast", 1000, 16) == 1000.0
    with pytest.raises(ValueError, match="unknown collective"):
        an.ring_wire_bytes("gossip", 1, 2)
    stats = an.CollectiveStats()
    stats.add("all-reduce", 1 << 20, 1)        # one rank: nothing moves
    assert stats.as_dict()["counts"] == {}


def test_h100_constants_and_link_rates():
    """Data-sheet constants of the H100 SXM; a group of more than 8 ranks
    crosses nodes and is charged at the slower rate."""
    assert (an.PEAK_FLOPS, an.HBM_BW) == (989e12, 3.35e12)
    assert (an.NVLINK_BW, an.NODE_LINK_BW, an.NODE_SIZE) == (450e9, 50e9, 8)
    assert an.link_bw(2) == an.link_bw(8) == 450e9
    assert an.link_bw(9) == an.link_bw(16) == an.link_bw(256) == 50e9
    stats = an.CollectiveStats()
    stats.add("all-reduce", 8e9, 16)           # 15 GB on the wire at 50 GB/s
    stats.add("all-gather", 9e9, 2)            # 4.5 GB at 450 GB/s
    roof = an.Roofline(flops=989e12, bytes_accessed=3.35e12 / 2,
                       wire_bytes=stats.total_wire_bytes, collectives=stats,
                       model_flops=989e12 / 4, n_devices=16)
    assert roof.t_compute == pytest.approx(1.0)
    assert roof.t_memory == pytest.approx(0.5)
    assert roof.t_collective == pytest.approx(15e9 / 50e9 + 4.5e9 / 450e9)
    assert roof.bottleneck == "compute" and roof.step_time == roof.t_compute
    assert roof.useful_ratio == pytest.approx(0.25)
    assert roof.roofline_fraction == pytest.approx(0.25)
    keys = set(jan.Roofline(1.0, 1.0, 1.0, jan.CollectiveStats()).as_dict())
    assert set(roof.as_dict()) == keys


@pytest.fixture(scope="module")
def records():
    """One record the port's dry run counted (a fake 16 x 16 group), a
    skipped cell and a failed one."""
    from repro_torch.launch import dryrun

    ok = dryrun.run_cell("mamba2-2.7b", "decode_32k", False, quiet=True,
                         device="cpu")
    skip = dryrun.run_cell("qwen3-8b", "long_500k", False, quiet=True)
    fail = {"arch": "qwen3-8b", "shape": "train_4k", "mesh": "16x16",
            "status": "fail", "error": "RuntimeError: " + "x" * 80}
    return [ok, skip, fail]


def test_tables_are_byte_equal_across_the_packages(records):
    ok, skip, _ = records
    assert ok["status"] == "ok" and skip["status"] == "skip"
    assert skip["reason"].startswith("SKIP(full-attn)")
    assert report.dryrun_table(records) == jreport.dryrun_table(records)
    assert report.roofline_table(records) == jreport.roofline_table(records)
    assert ok["arch"] in report.roofline_table(records)


def test_report_main_renders_both_meshes(records, tmp_path, capsys,
                                         monkeypatch):
    import json

    path = tmp_path / "single.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    monkeypatch.setattr("sys.argv", ["report", str(path), str(path)])
    report.main()
    port = capsys.readouterr().out
    jreport.main()
    jax_out = capsys.readouterr().out
    assert "### Dry-run (multi-pod 2x16x16)" in port
    # the JAX package's tables, then the port's rank table: the counted
    # cell alone, its peak and fit on both meshes
    assert port.startswith(jax_out)
    rank = port[len(jax_out):].strip().splitlines()
    assert "fits 80 GB" in rank[2] and len(rank) == 5
    ok = records[0]
    peak = f"{ok['memory']['peak_hbm_est'] / 2**30:.2f} yes"
    assert rank[4].startswith(f"| {ok['arch']} | {ok['shape']} | ")
    assert rank[4].count(peak) == 2
