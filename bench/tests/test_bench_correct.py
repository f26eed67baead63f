"""``correct`` comes out true for the program, and false for the control
and for each fault a cell can have, when a whole run of the harness (its
look for a chip skipped) drives the port on the CPU at a tiny size.

The faults are planted under the timed path, in the kernel wrapper's
count (the plain version the CPU runs): an answer altered where it is
produced, and half of the rows left out with the count taken as twice the
rest.  The cells train nothing and use one chip, so a state left unchanged
and a missing exchange between chips are not faults they can have.
"""
from __future__ import annotations

import pytest

from bench import harness
from bench.tests.tiny import tiny_checkout

CELLS = ["sim-1m.mine", "census-adult.mine", "sim-1m.count-cold",
         "sim-1m.count-hot"]
SEED = 2**31 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


def _run(root, cell, **kw):
    return harness.run_cell(root, cell, SEED, 1.0, False, device="cpu",
                            check_chip=False, **kw)


def _altered(inner):
    def counts(tx_bits, tgt_bits, weights, **kw):
        out = inner(tx_bits, tgt_bits, weights, **kw).clone()
        out[0, 0] += 1
        return out
    return counts


def _half(inner):
    def counts(tx_bits, tgt_bits, weights, **kw):
        n = tx_bits.shape[0] // 2
        return 2 * inner(tx_bits[:n], tgt_bits, weights[:n], **kw)
    return counts


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    out = _run(root, cell, control=True)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("fault", [_altered, _half])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    from repro_torch.kernels.itemset_count import ops

    monkeypatch.setattr(ops, "itemset_counts_ref_blocked",
                        fault(ops.itemset_counts_ref_blocked))
    out = _run(root, cell)
    assert not out["correct"], out["checks"]


def test_work_is_the_same_for_every_kernel_route(root, monkeypatch):
    """The roofline's work comes from the reference, never from the shapes
    or the route the port launched."""
    from repro_torch.roofline import autotune

    passes = {}
    for accum in ("vpu_int32", "mxu_f32"):
        monkeypatch.setattr(autotune, "resolve_launch_config",
                            lambda *a, accum=accum: autotune.LaunchConfig(
                                accum=accum))
        cell = harness.resolve(root, "census-adult.mine")
        ctx = harness.RunContext(root, cell, SEED, 0.3, False, "cpu", False)
        harness.load_file(root / "bench" / "drivers" / "mine_jobs.py",
                          "bench_driver_mine_jobs").run(ctx)
        assert all(v == 0 for _, v, _ in ctx.record.checks)
        passes[accum] = ctx.record.jobs[0]["passes"]
    assert passes["vpu_int32"] == passes["mxu_f32"]
