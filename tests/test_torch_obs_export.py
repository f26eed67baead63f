"""The port's telemetry export (``repro_torch.obs.export``) against the JAX
package's (``repro.obs.export``): ``prometheus_text`` byte for byte on the
same snapshots, the reference's format test, the HTTP round trip over the
port's ``REGISTRY`` and ``dump_json``."""
import json
import urllib.request

import numpy as np
import pytest

import repro.obs as jobs
from repro.obs.export import dump_json as jax_dump_json
from repro.obs.export import prometheus_text as jax_prometheus_text
from repro_torch import obs
from repro_torch.obs import REGISTRY, MetricsRegistry
from repro_torch.obs.export import (dump_json, prometheus_text,
                                    start_metrics_server)


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    obs.reset()
    yield
    obs.reset()


def _traffic(reg, rng):
    """The same seeded counter / gauge / histogram traffic into a
    registry of either package."""
    reg.counter("t_exp_total", path="host").inc(3)
    reg.counter("t_exp_total", path="device").inc(int(rng.integers(1, 99)))
    reg.counter("serve_flushes_total", trigger="sync").inc(5)
    reg.counter("t_float_total").inc(0.25)
    reg.counter("t_float_total").inc(1.75)        # integral float: "2"
    reg.set_gauge("t_exp_gauge", 2.5)
    reg.set_gauge("chooser_last_decision", 1, exclusive=True,
                  backend="gfp")
    reg.set_gauge("chooser_last_decision", 1, exclusive=True,
                  backend="dense")
    reg.histogram("t_exp_ms", buckets=(1.0, 10.0)).observe_many(
        [0.5, 5.0, 50.0])
    reg.histogram("serve_flush_ms").observe_many(
        rng.gamma(2.0, 3.0, size=40).tolist())
    reg.histogram("t_lab_ms", buckets=(0.1, 0.2), geometry="a,b").observe(
        0.15)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_byte_equal_across_packages(seed):
    """The same traffic gives the same snapshot in both packages, and each
    package's renderer gives the same bytes for either snapshot."""
    mine = MetricsRegistry(enabled=True)
    theirs = jobs.MetricsRegistry(enabled=True)
    _traffic(mine, np.random.default_rng(seed))
    _traffic(theirs, np.random.default_rng(seed))
    snap, jsnap = mine.snapshot(), theirs.snapshot()
    assert snap == jsnap
    text = prometheus_text(snap)
    assert text.encode() == jax_prometheus_text(snap).encode()
    assert text.encode() == jax_prometheus_text(jsnap).encode()
    assert prometheus_text({}) == jax_prometheus_text({}) == "\n"


def test_prometheus_text_format():
    REGISTRY.counter("t_exp_total", path="host").inc(3)
    REGISTRY.set_gauge("t_exp_gauge", 2.5)
    h = REGISTRY.histogram("t_exp_ms", buckets=(1.0, 10.0))
    h.observe_many([0.5, 5.0, 50.0])
    text = prometheus_text(REGISTRY.snapshot())
    assert '# TYPE t_exp_total counter' in text
    assert 't_exp_total{path="host"} 3' in text
    assert 't_exp_gauge 2.5' in text
    assert 't_exp_ms_bucket{le="1"} 1' in text
    assert 't_exp_ms_bucket{le="10"} 2' in text
    assert 't_exp_ms_bucket{le="+Inf"} 3' in text
    assert 't_exp_ms_count 3' in text


def test_metrics_http_server_roundtrip():
    """``start_metrics_server`` defaults to the port's ``REGISTRY``."""
    REGISTRY.counter("t_http_total").inc(7)
    REGISTRY.histogram("serve_flush_ms").observe_many([0.2, 3.0])
    srv = start_metrics_server(0)
    try:
        port = srv.server_address[1]
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "t_http_total 7" in text
        assert "serve_flush_ms_count 2" in text
        snap = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json", timeout=10).read())
        assert snap["counters"]["t_http_total"][""] == 7
        assert snap["histograms"]["serve_flush_ms"][""]["count"] == 2
        assert text == prometheus_text(snap)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=10)
        assert e.value.code == 404
    finally:
        srv.shutdown()


def test_metrics_http_server_over_another_registry():
    reg = MetricsRegistry(enabled=True)
    reg.counter("t_other_total").inc(2)
    REGISTRY.counter("t_global_total").inc(1)
    srv = start_metrics_server(0, registry=reg)
    try:
        port = srv.server_address[1]
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10).read().decode()
    finally:
        srv.shutdown()
    assert text == prometheus_text(reg.snapshot())
    assert "t_global_total" not in text


def test_dump_json_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    reg = MetricsRegistry(enabled=True)
    _traffic(reg, rng)
    snap = reg.snapshot()
    extra = {"kernel_efficiency": obs.kernel_efficiency(snap)}
    dump_json(str(tmp_path / "t.json"), snap, extra=extra)
    jax_dump_json(str(tmp_path / "j.json"), snap, extra=extra)
    got = (tmp_path / "t.json").read_bytes()
    assert got == (tmp_path / "j.json").read_bytes()
    doc = json.loads(got)
    assert doc["counters"] == json.loads(json.dumps(snap["counters"]))
    assert "kernel_efficiency" in doc and got.endswith(b"\n")
    dump_json(str(tmp_path / "plain.json"), snap)
    assert json.loads((tmp_path / "plain.json").read_text()) \
        == json.loads(json.dumps(snap))
