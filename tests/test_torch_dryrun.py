"""The port's dry run (``repro_torch/launch/specs.py``, ``dryrun.py``,
``perf.py`` and ``roofline/count.py``) on the CPU: fake process groups of
256, 4 and 2 ranks (``dryrun.fake_world``), stand-ins on a fake host
(``device="cpu"``; fake ``cuda`` tensors need a CUDA build).

* ``input_specs`` against the JAX package's on
  ``repro.compat.abstract_mesh((16, 16), ("data", "model"))`` for every
  arch x shape: every leaf's global shape and dtype equal, and this rank's
  bytes equal to JAX's ``shard_shape`` except where a deliberate
  difference of the port (ROADMAP §3) accounts for the gap, each gap
  pinned by name and size;
* the fake count against a real CPU run of the same step, for a dense, a
  MoE and an SSM arch at reduced size: FLOPs, argument bytes, bytes
  accessed and the peak of live storages equal;
* the dispatcher's collectives against ``collectives.STATS``: equal for an
  inference cell on a fake (1, 2) group, and over a data axis of 2 more by
  exactly the gradient and clip all-reduces;
* ``perf.py`` refuses ``attn_kv_seq``; ``no_remat`` lowers a train cell's
  FLOPs; ``dryrun.main``'s records carry the JAX package's keys.
"""
import contextlib
import json
import math
from collections import defaultdict

import jax
import pytest
import torch

import repro.compat as compat
from repro.launch import specs as jspecs
from repro.models.blocks import unit_layout as jax_unit_layout
from repro.models.transformer import _enc_cfg as jax_enc_cfg
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, perf, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import ALL_SHAPES, ShapeSpec
from repro_torch.parallel import collectives as coll
from repro_torch.roofline.count import count_step

CELLS = [(a, s.name) for a in sorted(ARCHS) for s in ALL_SHAPES]
MESH = {"data": 16, "model": 16}
LOCAL_AXES = ("data", "pod")
# the port's deliberate differences from the JAX layout (ROADMAP §3) that
# leave this rank more bytes
FSDP = "no FSDP over 'data'"
ONE_SEQ = "'data' shards no activation (one sequence)"
CROSS = "cross-attention cache replicated"


# ---------------------------------------------------------------------------
# the leaves of both packages' stand-ins, keyed alike
# ---------------------------------------------------------------------------

def _stack_keys(cfg, path, n):
    """The port's per-layer keys of a JAX leaf stacked over ``n`` units
    (``convert.model_from_reference``'s key map)."""
    root, rest = path[0], path[1:]
    unit = len(jax_unit_layout(cfg if root != "encoder"
                               else jax_enc_cfg(cfg))[1])
    first = 0
    if unit > 1:
        first, rest = int(rest[0][len("layer"):]), rest[1:]
    return [".".join((root, str(u * unit + first)) + tuple(rest))
            for u in range(n)]


def _jax_leaves(cfg, kind, jargs):
    """name -> (one layer's global shape, dtype, shard shape) of every JAX
    leaf, stacked leaves split into the port's layers; plus the scalars
    the port keeps as Python ints."""
    out, ints = {}, []

    def put(name, leaf):
        sh = getattr(leaf, "sharding", None)
        out[name] = (tuple(leaf.shape), str(leaf.dtype),
                     tuple(sh.shard_shape(leaf.shape)) if sh else leaf.shape,
                     tuple(sh.spec) if sh else ())

    def tree(prefix, t):
        for p, leaf in jax.tree_util.tree_leaves_with_path(t):
            path = tuple(k.key for k in p)
            if path[0] not in ("decoder", "encoder"):
                put(prefix + ".".join(path), leaf)
                continue
            shard = tuple(leaf.sharding.shard_shape(leaf.shape))[1:]
            spec = tuple(leaf.sharding.spec)[1:]
            for key in _stack_keys(cfg, path, leaf.shape[0]):
                out[prefix + key] = (tuple(leaf.shape[1:]), str(leaf.dtype),
                                     shard, spec)

    def cache(c):
        for p, leaf in jax.tree_util.tree_leaves_with_path(c):
            path = tuple(k.key for k in p)
            if path == ("enc_len",):
                ints.append("enc_len")
                continue
            shard = tuple(leaf.sharding.shard_shape(leaf.shape))[1:]
            spec = tuple(leaf.sharding.spec)[1:]
            if path[0] in ("enc_k", "enc_v"):
                names = [f"cache.{path[0]}.{i}" for i in range(leaf.shape[0])]
            else:
                names = [f"cache.layers.{k.split('.', 1)[1]}" for k in
                         _stack_keys(cfg, ("decoder",) + path[1:],
                                     leaf.shape[0])]
            for name in names:
                out[name] = (tuple(leaf.shape[1:]), str(leaf.dtype), shard,
                             spec)

    if kind == "train":
        params, opt, batch = jargs
        tree("param.", params)
        tree("m.", opt.m)
        tree("v.", opt.v)
        put("step", opt.step)
        for k, leaf in batch.items():
            put(f"batch.{k}", leaf)
    elif kind == "prefill":
        tree("param.", jargs[0])
        put("batch.tokens", jargs[1])
        if len(jargs) > 2:
            put("batch.frames", jargs[2])
    else:
        params, c, token, pos = jargs
        tree("param.", params)
        cache(c)
        put("token", token)
        ints.append("pos")
    return out, ints


def _port_leaves(kind, args):
    """name -> (global shape, dtype, this rank's shape) of every stand-in."""
    out = {}

    def put(name, t):
        out[name] = (t.global_shape, str(t.dtype).replace("torch.", ""),
                     tuple(t.shape))

    if kind == "train":
        params, opt, batch = args
        for k in params:
            put(f"param.{k}", params[k])
            put(f"m.{k}", opt.m[k])
            put(f"v.{k}", opt.v[k])
        put("step", opt.step)
        for k, t in batch.items():
            put(f"batch.{k}", t)
    elif kind == "prefill":
        for k, t in args[0].items():
            put(f"param.{k}", t)
        put("batch.tokens", args[1])
        if len(args) > 2:
            put("batch.frames", args[2])
    else:
        params, cache, token, pos = args
        for k, t in params.items():
            put(f"param.{k}", t)
        for i, lc in enumerate(cache["layers"]):
            for k, t in lc.items():
                put(f"cache.layers.{i}.{k}", t)
        for key in ("enc_k", "enc_v"):
            for i, t in enumerate(cache.get(key, [])):
                put(f"cache.{key}.{i}", t)
        put("token", token)
        assert isinstance(pos, int)
        if "enc_len" in cache:
            assert isinstance(cache["enc_len"], int)
    return out


def _axes(entry):
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _expected_local(name, jax_shard, spec):
    """This rank's shape of a leaf under the port's deliberate layout
    (ROADMAP §3), from the JAX package's shard shape and spec, and the
    name of the difference that makes it differ (None where equal)."""
    shape, why = list(jax_shard), set()
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            param = name.split(".")[0] in ("param", "m", "v")
            if param and a in LOCAL_AXES:
                shape[d] *= MESH[a]
                why.add(FSDP)
            elif name.startswith("cache.enc_") and a == "model":
                shape[d] *= MESH[a]
                why.add(CROSS)
            elif name.startswith("cache.layers.") and a in LOCAL_AXES \
                    and d == 1:         # a KV cache's sequence
                shape[d] *= MESH[a]
                why.add(ONE_SEQ)
    return tuple(shape), (sorted(why)[0] if why else None)


@pytest.fixture(scope="module")
def spec_cells():
    """Every arch x shape through both packages' ``input_specs``: the
    leaves, and this rank's bytes of each package with the gaps by name."""
    jmesh = compat.abstract_mesh((16, 16), ("data", "model"))
    out = {}
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        for arch, shape in CELLS:
            kind, args, info = specs.input_specs(arch, shape, mesh,
                                                 device="cpu")
            jkind, jargs, _ = jspecs.input_specs(arch, shape, jmesh)
            jl, ints = _jax_leaves(get_config(arch), jkind, jargs)
            abstract = {k: tuple(t.shape)
                        for k, t in info["model"].abstract().items()}
            out[arch, shape] = dict(kind=(kind, jkind), port=_port_leaves(
                kind, args), jax=jl, ints=ints, abstract=abstract)
            del args, info
    return out


def _bytes(shape, dtype):
    return math.prod(shape) * {"bfloat16": 2, "float32": 4, "int32": 4}[dtype]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_leaves_equal_the_reference(spec_cells, arch, shape):
    """Every JAX leaf has a port stand-in of its global shape and dtype (a
    stacked leaf one per layer); the JAX package's ``pos`` (and the
    encoder-decoder's ``enc_len``) are Python ints in the port."""
    c = spec_cells[arch, shape]
    assert c["kind"][0] == c["kind"][1]
    port, jl = c["port"], c["jax"]
    assert sorted(port) == sorted(jl)
    for name, (gshape, dtype, _, _) in jl.items():
        assert port[name][:2] == (gshape, dtype), name
    # the parameters have this rank's shapes of Model.abstract() (meta)
    assert c["abstract"] == {k[len("param."):]: v[2] for k, v in port.items()
                             if k.startswith("param.")}
    want_ints = ["pos"] + (["enc_len"] if get_config(arch).encdec else [])
    assert sorted(c["ints"]) == (sorted(want_ints)
                                 if c["kind"][0] == "decode" else [])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_rank_bytes_equal_the_reference_but_named_gaps(
        spec_cells, arch, shape):
    """This rank's shape of every stand-in equals JAX's ``shard_shape``, or
    what a deliberate difference of the port makes of it."""
    c = spec_cells[arch, shape]
    gaps = defaultdict(int)
    for name, (_, dtype, shard, spec) in c["jax"].items():
        local = c["port"][name][2]
        want, why = _expected_local(name, shard, spec)
        assert local == want, (name, local, shard, spec)
        if why:
            gaps[why] += _bytes(local, dtype) - _bytes(shard, dtype)
        else:
            assert local == tuple(shard), name
    total_port = sum(_bytes(p[2], p[1]) for p in c["port"].values())
    total_jax = sum(_bytes(j[2], j[1]) for j in c["jax"].values())
    assert total_port - total_jax == sum(gaps.values())
    if c["kind"][0] == "train":
        assert gaps[FSDP] > 0


# pinned: this rank's bytes (port, JAX) and the gaps by name, in bytes
PINNED = {
    ("qwen3-8b", "decode_32k"): (4006701088, 2588911648, {FSDP: 1417789440}),
    ("arctic-480b", "train_4k"): (202123974660, 12716742660,
                                  {FSDP: 189407232000}),
    ("jamba-1.5-large-398b", "long_500k"): (
        51474531796, 3300779476, {FSDP: 47041290240, ONE_SEQ: 1132462080}),
    ("seamless-m4t-large-v2", "decode_32k"): (
        27920224288, 3285948448, {FSDP: 475084800, CROSS: 24159191040}),
}


def test_pinned_rank_bytes(spec_cells):
    """This rank's bytes in each package and the named gaps of four cells:
    qwen3-8b's decode (JAX 2.59 GB a rank), arctic-480b's training,
    jamba's 524k-token decode (its one sequence on every data rank) and
    seamless's decode (its cross-attention cache whole on every rank)."""
    got = {}
    for key in (("qwen3-8b", "decode_32k"), ("arctic-480b", "train_4k"),
                ("jamba-1.5-large-398b", "long_500k"),
                ("seamless-m4t-large-v2", "decode_32k")):
        c = spec_cells[key]
        gaps = defaultdict(int)
        for name, (_, dtype, shard, spec) in c["jax"].items():
            local = c["port"][name][2]
            why = _expected_local(name, shard, spec)[1]
            if why:
                gaps[why] += _bytes(local, dtype) - _bytes(shard, dtype)
        got[key] = (sum(_bytes(p[2], p[1]) for p in c["port"].values()),
                    sum(_bytes(j[2], j[1]) for j in c["jax"].values()),
                    dict(gaps))
    assert got == PINNED


# ---------------------------------------------------------------------------
# the fake count against a real CPU run; collectives; perf; main
# ---------------------------------------------------------------------------

SMALL = {"train": ShapeSpec("train_small", 32, 4, "train"),
         "prefill": ShapeSpec("prefill_small", 32, 2, "prefill"),
         "decode": ShapeSpec("decode_small", 48, 2, "decode")}


def _real_count(arch, shape, cfg, mesh=None):
    """The same step on real CPU tensors (weights from a seed): its count
    and the bytes of its argument tensors."""
    kind, args, info = specs.input_specs(arch, shape, mesh, cfg_override=cfg,
                                         device="cpu",
                                         mode=contextlib.nullcontext())
    info["model"].init(torch.Generator().manual_seed(0))
    seen, nbytes = set(), 0
    from repro_torch.roofline.count import _tensors
    for t in _tensors(args):
        if t.untyped_storage()._cdata not in seen:
            seen.add(t.untyped_storage()._cdata)
            nbytes += t.numel() * t.element_size()
    _, count = count_step(specs.step_fn(kind, info), args)
    return count, nbytes


@pytest.mark.parametrize("arch", ["qwen3-8b", "arctic-480b", "mamba2-2.7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_count_equals_a_real_cpu_run(arch, kind):
    """A dense, a MoE and an SSM arch, reduced: the fake step's FLOPs,
    argument bytes, bytes accessed, peak of live storages and new against
    written-in-place results equal a real run's (the SSM decode replaces
    its state: a dropped argument's storage is no argument again)."""
    cfg = get_config(arch).reduced()
    got_kind, fake, _, _ = dryrun.count_cell(arch, SMALL[kind], None,
                                             device="cpu", cfg_override=cfg)
    real, arg_bytes = _real_count(arch, SMALL[kind], cfg)
    assert got_kind == kind
    assert fake.flops == real.flops > 0
    assert fake.argument_bytes == real.argument_bytes == arg_bytes
    assert fake.bytes_accessed == real.bytes_accessed > 0
    assert fake.peak_bytes == real.peak_bytes > fake.argument_bytes
    assert fake.output_bytes == real.output_bytes
    assert fake.alias_bytes == real.alias_bytes


def _with_stats(fn):
    coll.STATS.reset()
    coll.STATS.enabled = True
    try:
        return fn()
    finally:
        coll.STATS.enabled = False


@pytest.mark.parametrize("arch", ["qwen3-8b", "arctic-480b"])
def test_inference_collectives_equal_stats_on_a_fake_1x2_group(arch):
    """Every collective of a prefill and a decode step goes through
    ``parallel/collectives.py``: the dispatcher sees what ``STATS``
    counts, the all-reduces' bytes too (bf16 would be float32 on both)."""
    cfg = get_config(arch).reduced()
    with dryrun.fake_world(2):
        mesh = dryrun.fake_mesh(1, 2)
        for kind in ("prefill", "decode"):
            _, count, _, _ = _with_stats(lambda: dryrun.count_cell(
                arch, SMALL[kind], mesh, device="cpu", cfg_override=cfg))
            log = count.collective_log
            assert len(log) == coll.STATS.calls > 0
            assert {n for _, n, _ in log} == {2}
            ar = [b for k, _, b in log if k == "all-reduce"]
            ag = [b for k, _, b in log if k == "all-gather"]
            assert len(ar) + len(ag) == len(log)
            # STATS counts an all-gather's input, the ring model its result
            assert sum(ar) + sum(ag) // 2 == coll.STATS.bytes


def test_train_collectives_exceed_stats_by_the_gradient_and_clip_reduces():
    """On a fake (2, 2) group a train step also all-reduces the gradients
    over 'data' (one float32 bucket here, ``train_step.py``) and the clip's
    squared norm over 'model' (``optimizer.py``), beside ``collectives``."""
    arch = "qwen3-8b"
    cfg = get_config(arch).reduced()
    with dryrun.fake_world(4):
        mesh = dryrun.fake_mesh(2, 2)
        _, count, info, _ = _with_stats(lambda: dryrun.count_cell(
            arch, SMALL["train"], mesh, device="cpu", cfg_override=cfg))
        extra = count.collective_log[-2:]
        n_params = sum(p.numel() for p in info["model"].parameters())
    assert len(count.collective_log) == coll.STATS.calls + 2
    grads, clip = (extra[0], extra[1]) if extra[0][2] > 4 else extra[::-1]
    assert grads == ("all-reduce", 2, 4 * (n_params + 1))     # + the loss
    assert clip == ("all-reduce", 2, 4)


def test_perf_refuses_attn_kv_seq(capsys):
    with pytest.raises(SystemExit):
        perf.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--variant",
                   "attn_kv_seq"])
    assert "attends by heads" in capsys.readouterr().err
    with pytest.raises(ValueError, match="attn_kv_seq"):
        perf.measure("arctic-480b", "train_4k", None,
                     perf.v_attn_kv_seq(get_config("arctic-480b")), 1,
                     device="cpu")


def test_no_remat_lowers_train_flops():
    cfg = get_config("qwen3-8b").reduced()
    base = dryrun.count_cell("qwen3-8b", SMALL["train"], None, device="cpu",
                             cfg_override=cfg)[1]
    flat = dryrun.count_cell("qwen3-8b", SMALL["train"], None, device="cpu",
                             cfg_override=perf.VARIANTS["no_remat"](cfg))[1]
    assert flat.flops < base.flops
    assert flat.peak_bytes > base.peak_bytes     # activations kept instead


def test_depth_variant_counts_whole_units():
    cfg = get_config("jamba-1.5-large-398b")
    assert dryrun._depth_variant(cfg, 2).n_layers == 16
    assert dryrun._depth_variant(get_config("arctic-480b"), 3).n_layers == 3
    enc = dryrun._depth_variant(get_config("seamless-m4t-large-v2"), 1)
    assert (enc.n_layers, enc.n_enc_layers) == (1, 1)


def test_main_writes_the_reference_record(tmp_path):
    """``--device cpu`` on the 16 x 16 fake group: the JAX package's
    record keys, and the arguments' bytes of ``input_specs`` exactly."""
    out = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                        "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    for key in ("arch", "shape", "mesh", "status", "kind", "n_devices",
                "lower_s", "compile_s", "memory", "roofline"):
        assert key in rec
    assert (rec["status"], rec["kind"], rec["n_devices"]) == ("ok", "decode",
                                                              256)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_hbm_est"}
    assert rec["memory"]["argument_bytes"] == \
        PINNED["qwen3-8b", "decode_32k"][0]
    assert rec["fits"] is True
    assert rec["roofline"]["collectives"]["counts"]["all-reduce"] > 0


def test_fake_cuda_is_refused_without_a_cuda_build(capsys):
    if torch.cuda._is_compiled():
        pytest.skip("a PyTorch built with CUDA runs fake cuda tensors")
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k"]) == 1
    assert "built with CUDA" in capsys.readouterr().err
