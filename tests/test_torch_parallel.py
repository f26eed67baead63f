"""The port's mesh helpers for training on the CPU: ``parallel.sharding``
against the JAX package's (``pspec`` on the same mesh shapes, entry for
entry; ``Model.shardings`` against ``param_shardings``), ``constrain``,
``launch.mesh``'s ``dp_size`` and ``make_production_mesh``, the GPipe
schedule on four gloo ranks against the sequential stack (the shapes of
``tests/test_pipeline.py``; max |err| below 1e-5, as there), and the
launcher's replicated data parallelism, ``--data-mesh 2`` on two gloo
processes against one process on the whole batch: the same losses (rtol
2e-5) and parameters within the microbatch test's tolerance (rtol 3e-3,
atol 3e-5), since both average the same per-example gradients in another
order.

Spawned ranks rendezvous through a ``FileStore`` under the test's tmp dir;
the launcher's two ranks, which take ``torchrun``'s environment, through a
free localhost port.
"""
import os
import pickle
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import _torch_train_worker as worker
from _torch_tp_worker import MeshView
from repro.compat import abstract_mesh
from repro.configs import ARCHS
from repro.models import get_model as jax_get_model
from repro.parallel import sharding as jshd
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import dp_size, make_production_mesh
from repro_torch.models import common as tcommon
from repro_torch.models import get_model, transformer as ttransformer
from repro_torch.parallel import sharding as tshd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((8,), ("data",))]
ACTIVATIONS = [
    (("act_batch", "act_seq", "act_embed"), (256, 4096, 5120)),
    (("act_batch", None, "act_vocab"), (256, 4096, 151936)),
    (("act_batch", None, "act_heads", None), (256, 4096, 56, 128)),
    (("act_batch", "act_kv_seq_long", None, None), (1, 524288, 8, 128)),
    (("act_groups", None, "act_experts"), (32, 512, 128)),
    (("act_batch", None, None, None, "act_kv_seq"), (256, 8, 4, 512, 4096)),
    (("embed", "embed"), (16, 16)), (("vocab_out",), (7,)),
]


def _spec_leaves(specs):
    if isinstance(specs, tcommon.ParamSpec):
        yield specs
    elif isinstance(specs, dict):
        for v in specs.values():
            yield from _spec_leaves(v)
    else:
        for v in specs:
            yield from _spec_leaves(v)


def _cases():
    """Every (logical axes, shape) of every arch's full-size parameters,
    and a set of activation constraints."""
    seen = set(ACTIVATIONS)
    for arch in sorted(ARCHS):
        for s in _spec_leaves(ttransformer.model_specs(
                tconfigs.get_config(arch))):
            seen.add((s.logical, s.shape))
    return sorted(seen, key=repr)


@pytest.mark.parametrize("sizes,names", MESHES)
def test_pspec_matches_reference(sizes, names):
    jmesh = abstract_mesh(sizes, names)
    for logical, shape in _cases():
        want = jshd.pspec(logical, shape=shape, mesh=jmesh)
        got = tshd.pspec(logical, shape=shape, mesh=(sizes, names))
        assert got == tuple(want), (logical, shape, got, want)
        # without a shape: no divisibility drop
        assert tshd.pspec(logical, mesh=dict(zip(names, sizes))) == \
            tuple(jshd.pspec(logical, mesh=jmesh))


@pytest.mark.parametrize("arch", ["qwen3-8b", "arctic-480b", "mamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_model_shardings_match_reference(arch):
    """``Model.shardings`` on the reduced model: each parameter's
    placements are those of the JAX ``param_shardings`` spec, by the key
    map (stacked JAX leaves drop their leading 'layers' axis, which no
    rule shards)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes, names = (4, 2), ("data", "model")
    model = get_model(arch, reduced=True, device="cpu")
    got = model.shardings((sizes, names))
    jm = jax_get_model(arch, reduced=True)
    jspecs = jax.tree.map(
        lambda s: jshd.pspec(s.logical, shape=s.shape,
                             mesh=abstract_mesh(sizes, names)),
        jm.specs, is_leaf=lambda x: hasattr(x, "logical"))
    want = {}
    for key, spec in _flat_specs(model.cfg, jspecs):
        spec = tuple(spec)
        if key.startswith(("decoder.", "encoder.")):
            assert not spec or spec[0] is None, (key, spec)   # 'layers'
            spec = spec[1:]
        want[key] = tshd.placements(spec, (sizes, names))
    assert set(got) == set(want)
    for k, pl in got.items():
        assert pl == want[k], (k, pl, want[k])
        assert all(isinstance(p, (Shard, Replicate)) for p in pl)
    assert any(isinstance(p, Shard) for pl in got.values() for p in pl)


def _flat_specs(cfg, tree):
    """(port key, JAX spec) by the key map, one entry per layer."""
    from repro_torch.models.blocks import unit_layout
    from repro_torch.models.transformer import _enc_cfg

    stacks = {"decoder": unit_layout(cfg), "encoder": None}
    if cfg.encdec:
        stacks["encoder"] = unit_layout(_enc_cfg(cfg))

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v

    for path, spec in walk(tree, ()):
        if path[0] not in stacks:
            yield ".".join(path), spec
            continue
        n_units, layout = stacks[path[0]]
        rest, first = path[1:], 0
        if len(layout) > 1:
            first, rest = int(rest[0][len("layer"):]), rest[1:]
        for u in range(n_units):
            yield ".".join((path[0], str(u * len(layout) + first)) + rest), \
                spec


def test_constrain_outside_a_context_is_the_identity():
    x = torch.ones(4, 4)
    assert tshd.constrain(x, "act_batch", None) is x


def test_constrain_inside_a_context():
    x = torch.ones(8, 16, 32)
    axes = ("act_batch", "act_seq", "act_embed")
    with tshd.sharding_ctx(((1, 1), ("data", "model"))):
        assert tshd.active()
        assert tshd.constrain(x, *axes) is x
        with pytest.raises(ValueError):
            tshd.constrain(x, "act_batch", None)
    # replicated data parallelism: each rank holds its batch slice already
    with tshd.sharding_ctx(((2, 1), ("data", "model"))):
        assert tshd.constrain(x, *axes) is x
    # over a model axis of 2 a replicated tensor becomes this rank's slice
    # of the dim the JAX spec splits (the port keeps act_seq replicated)
    x = torch.arange(8 * 16 * 32, dtype=torch.float32).reshape(8, 16, 32)
    jmesh = abstract_mesh((1, 2), ("data", "model"))
    for rank in (0, 1):
        with tshd.sharding_ctx(MeshView(rank, (1, 2))):
            for logical in [("act_batch", None, "act_ffn"),
                            ("act_batch", "act_heads", None),
                            ("act_batch", "act_kv_seq", None),
                            ("act_experts", None, None)]:
                spec = tuple(jshd.pspec(logical, shape=x.shape, mesh=jmesh))
                dim = spec.index("model")
                want = x.narrow(dim, rank * x.shape[dim] // 2,
                                x.shape[dim] // 2)
                assert torch.equal(tshd.constrain(x, *logical), want)
                # already this rank's shard: stays as it is
                assert tshd.constrain(want, *logical, shard=dim) is want
            assert tshd.constrain(x, *axes) is x
            # a dim that does not divide the model axis stays unsharded
            y = torch.ones(8, 15)
            assert tshd.constrain(y, "act_batch", "act_ffn") is y
    assert not tshd.active()


def test_duplicate_axis_not_reused_and_missing_axis_filtered():
    with tshd.sharding_ctx(((1, 1), ("data", "model"))):
        assert tshd.pspec(("embed", "embed"), shape=(16, 16)) == ("data",)
    with tshd.sharding_ctx(((1,), ("data",))):
        assert tshd.pspec(("act_batch", "act_seq", None),
                          shape=(8, 8, 8)) == ("data",)


def test_named_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = ((2, 16, 16), ("pod", "data", "model"))
    assert tshd.named_sharding(("embed", "ffn"), shape=(64, 128),
                               mesh=mesh) == (Replicate(), Shard(0), Shard(1))
    assert tshd.named_sharding(("act_batch", None), shape=(64, 3),
                               mesh=mesh) == (Shard(0), Shard(0), Replicate())


def test_mesh_helpers():
    assert dp_size(((2, 16, 16), ("pod", "data", "model"))) == 32
    assert dp_size(((4, 2), ("data", "model"))) == 4
    assert dp_size({"model": 8}) == 1
    for multi in (False, True):
        with pytest.raises(RuntimeError, match=r"need (256|512) ranks"):
            make_production_mesh(multi_pod=multi, device_type="cpu")


# ---------------------------------------------------------------- pipeline
def _spawn(d, world, payload):
    os.makedirs(d)
    pay = os.path.join(d, "payload.pkl")
    with open(pay, "wb") as f:
        pickle.dump(payload, f)
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, world,
                                                  os.path.join(d, "store"),
                                                  pay, d), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errs = {r: open(os.path.join(d, f"rank{r}.err")).read()
            for r in range(world)
            if os.path.exists(os.path.join(d, f"rank{r}.err"))}
    assert not hung, f"ranks still running after {JOIN_S} s: {errs}"
    assert [p.exitcode for p in procs] == [0] * world, errs
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def test_pipeline_forward_on_four_gloo_ranks(tmp_path):
    """S = 4 stages of an 8-layer tanh stack, M = 6 microbatches of 4 x
    16: every rank returns the sequential stack's output; each rank's
    ``host_slice`` is its quarter of the global batch."""
    import jax.numpy as jnp

    from repro_torch.data import TokenPipeline

    S, L, M, MB, D = 4, 8, 6, 4, 16
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    w = np.asarray(jax.random.normal(k1, (L, D, D)) * 0.3, np.float32)
    b = np.asarray(jax.random.normal(k2, (L, D)) * 0.1, np.float32)
    x = np.asarray(jax.random.normal(k3, (M, MB, D)), np.float32)
    ref = jnp.asarray(x)
    for i in range(L):
        ref = jnp.tanh(ref @ w[i] + b[i])
    outs = _spawn(str(tmp_path / "pp"), S, {"w": w, "b": b, "x": x})
    full = TokenPipeline(vocab_size=100, seq_len=8, global_batch=8,
                         seed=3).batch_at(5)["tokens"]
    for r, o in enumerate(outs):
        assert o["out"].shape == (M, MB, D)
        assert np.abs(o["out"] - np.asarray(ref)).max() < 1e-5
        np.testing.assert_array_equal(o["slice"], full[2 * r:2 * r + 2])


def test_split_stages():
    from repro_torch.parallel.pipeline import split_stages

    t = {"w": torch.arange(24.0).reshape(8, 3), "b": [torch.zeros(8)]}
    out = split_stages(t, 4)
    assert out["w"].shape == (4, 2, 3) and out["b"][0].shape == (4, 2)
    with pytest.raises(ValueError):
        split_stages(t, 3)


# ---------------------------------------------------------------- data mesh
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(args, env_extra, ckpt):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env_extra)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "qwen3-8b", "--reduced", "--steps", "3",
           "--batch", "4", "--seq", "16", "--log-every", "1", "--lr", "1e-3",
           "--ckpt-dir", ckpt] + args
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT)


def _losses(out):
    return [float(m) for m in re.findall(r"step +\d+ loss (\S+)", out)]


def test_data_mesh_two_gloo_ranks_equal_one(tmp_path):
    one = _launch([], {}, str(tmp_path / "d1"))
    port = str(_free_port())
    two = [_launch(["--data-mesh", "2"],
                   {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
                    "MASTER_ADDR": "localhost", "MASTER_PORT": port},
                   str(tmp_path / "d2")) for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in [one] + two]
    assert [p.returncode for p in [one] + two] == [0, 0, 0], outs
    l1, l2 = _losses(outs[0]), _losses(outs[1])
    assert len(l1) == len(l2) == 3 and _losses(outs[2]) == []  # rank 0 logs
    np.testing.assert_allclose(l2, l1, rtol=2e-5)
    # rank 0 alone wrote the replicated arrays
    assert sorted(os.listdir(tmp_path / "d2" / "step_00000003")) == [
        "MANIFEST.json", "arrays_p0.npz"]
    models = []
    for d in ("d1", "d2"):
        m = get_model("qwen3-8b", reduced=True, device="cpu")
        _, man = CheckpointManager(str(tmp_path / d)).restore(m)
        models.append(m)
    assert man["process_count"] == 2
    for (k, a), (_, b) in zip(models[0].named_parameters(),
                              models[1].named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=3e-3, atol=3e-5, err_msg=k)
