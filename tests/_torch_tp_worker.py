"""Tensor and expert parallelism of the port's model zoo against the JAX
package sharded on the same mesh shape, for
``tests/test_torch_tensor_parallel*.py`` (one file per mesh shape, so that
the suite's workers share them out).

Two kinds of process, started at once by a module fixture:

* the reference (``python tests/_torch_tp_worker.py D M OUT ARCHS``, two
  processes sharing the archs, JAX on D * M host devices): for every arch
  at ``reduced()`` it writes the JAX
  package's parameters (``jax.random.key(0)``) to ``params_<arch>.pkl``,
  then, under ``sharding_ctx`` on an Auto-axes ``jax.sharding.Mesh`` (not
  ``make_host_mesh``, whose Explicit axes JAX 0.9 refuses), the forward
  logits, the loss and its gradients, prefill's logits and cache, 4 decode
  steps and one AdamW update (clip active) to ``ref_<arch>.pkl``;
* D * M gloo ranks of the port (``run``, rendezvous through a
  ``FileStore``), each carrying the same parameters across with
  ``convert.model_from_reference(..., mesh=)``: its data rank's rows of the
  forward, prefill, cache (gathered whole) and decode, then one
  ``make_train_step`` (loss and the data-averaged gradients, gathered
  whole), then AdamW from the reference's own gradients (so the update is
  held at float32 rounding), and on a 1 x 2 mesh a checkpoint of the
  converted parameters and AdamW state.

Every rank pickles ``rank<r>.pkl``; a traceback goes to ``rank<r>.err``.
The tests (the ``check_*`` functions below, imported by each file) read
both: model rank 0 of each data rank against the reference, and every
other model rank's loss, clip norm, gradients and update against model
rank 0's, bit for bit.  Tolerances: 1e-4 (rtol and atol) on logits and
caches, as in ``tests/test_torch_models.py``; gradients within 1e-4 of each
parameter's largest entry, as in ``tests/test_torch_train.py``; the update
at rtol 2e-6 / atol 1e-9 and its norm at rtol 1e-6, as in
``tests/test_torch_optimizer.py``.
"""
import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np

# a rank's view of a mesh without a process group, which the tests import
# from here
from repro_torch.parallel.sharding import MeshView  # noqa: F401

ARCHS = ["arctic-480b", "chameleon-34b", "jamba-1.5-large-398b",
         "llama4-maverick-400b-a17b", "mamba2-2.7b", "mistral-nemo-12b",
         "qwen3-32b", "qwen3-8b", "seamless-m4t-large-v2", "starcoder2-7b"]
B, S, PROMPT, MAX_LEN, STEPS = 2, 32, 16, 32, 4
OPT = dict(lr=1e-3, grad_clip=1e-3, warmup_steps=1, total_steps=10)
CKPT_ARCH = "jamba-1.5-large-398b"
# the reference's two processes, about equal in compile time (jamba's
# superblock is about 40 % of it)
REFERENCE_SPLIT = (("jamba-1.5-large-398b", "mistral-nemo-12b", "qwen3-32b"),
                   ("arctic-480b", "chameleon-34b",
                    "llama4-maverick-400b-a17b", "mamba2-2.7b", "qwen3-8b",
                    "seamless-m4t-large-v2", "starcoder2-7b"))
TIMEOUT_S = 240
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = 1e-4


def inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    frames = None
    if cfg.encdec:
        frames = rng.normal(size=(B, S, cfg.frontend_dim)).astype(np.float32)
    return toks, frames


def _dump(path, obj):
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


def _wait_load(path, deadline):
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# the JAX reference
# ---------------------------------------------------------------------------

def reference(d: int, m: int, out: str, archs) -> None:
    import jax
    import jax.numpy as jnp

    from repro.models import common as jcommon
    from repro.models import get_model
    from repro.parallel import sharding as jshd
    from repro.train import optimizer as jopt

    models = {a: get_model(a, reduced=True) for a in archs}
    params = {a: models[a].init(jax.random.key(0)) for a in archs}
    for a in archs:
        _dump(os.path.join(out, f"params_{a}.pkl"),
              jax.tree.map(np.asarray, params[a]))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                             ("data", "model"))
    ocfg = jopt.AdamWConfig(**OPT)
    for a in archs:
        jm, cfg = models[a], models[a].cfg
        toks, frames = inputs(cfg)
        batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
        if frames is not None:
            batch["frames"] = frames

        def loss_fn(p, b):
            lg = jm.forward(p, b["tokens"], frames=b.get("frames"))
            return jcommon.softmax_xent(lg, b["labels"], cfg.vocab_size), lg

        with jshd.sharding_ctx(mesh):
            p = jax.device_put(params[a], jm.shardings(mesh))
            (loss, logits), grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(p, batch)
            fp = None if frames is None else frames[:, :PROMPT]
            lg, cache = jax.jit(lambda p, t, f: jm.prefill(
                p, t, MAX_LEN, frames=f, dp_size=d))(p, toks[:, :PROMPT], fp)
            pre, jcache = np.asarray(lg), jax.tree.map(np.asarray, cache)
            dec, decode = [], jax.jit(jm.decode_step)
            for i in range(STEPS):
                pos = PROMPT + i
                lg, cache = decode(p, cache, jnp.asarray(toks[:, pos:pos + 1]),
                                   jnp.int32(pos))
                dec.append(np.asarray(lg))
            st = jopt.init_state(p, ocfg)
            newp, newst, met = jax.jit(
                lambda p, g, s: jopt.apply_updates(p, g, s, ocfg))(p, grads,
                                                                  st)
        tree = lambda t: jax.tree.map(np.asarray, t)
        _dump(os.path.join(out, f"ref_{a}.pkl"), {
            "forward": np.asarray(logits), "loss": float(loss),
            "grads": tree(grads), "prefill": pre, "cache": jcache,
            "decode": np.stack(dec, axis=1), "new_params": tree(newp),
            "m": tree(newst.m), "v": tree(newst.v),
            "gnorm": float(met["grad_norm"])})


def start_reference(d: int, m: int, out: str, archs,
                    log: str) -> subprocess.Popen:
    """The reference for ``archs`` in a subprocess of its own (JAX pins
    its device count at start-up).  Compiled at XLA's lowest optimisation
    level: the compile dominates at these sizes, and the tolerances above
    cover the difference."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    # one compute thread: the suite's other workers share the cores
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=4 "
        "--xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true "
        "--xla_cpu_multi_thread_eigen=false"), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(d), str(m), out,
         ",".join(archs)],
        env=env, stdout=open(os.path.join(out, log), "w"),
        stderr=subprocess.STDOUT)


# ---------------------------------------------------------------------------
# one rank of the port
# ---------------------------------------------------------------------------

def _full(t, dim, mesh):
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as shd

    with shd.sharding_ctx(mesh):
        return coll.all_gather(t.detach().contiguous(), dim)


def _params_full(model, tensors, mesh):
    from repro_torch.models.common import named_slices

    return {k: (tensors[k] if sl is None else _full(tensors[k], sl[0], mesh)
                ).detach().cpu().numpy() for k, sl in named_slices(model)}


def _cache_full(cfg, cache, mesh):
    layers = []
    full = {"k": (1, MAX_LEN), "v": (1, MAX_LEN), "ssd": (1, cfg.ssm_heads),
            "conv_x": (2, cfg.d_inner)}
    for lc in cache["layers"]:
        out = {}
        for key, t in lc.items():
            dim, n = full.get(key, (None, None))
            out[key] = (_full(t, dim, mesh) if dim is not None
                        and t.shape[dim] != n else t).cpu().numpy()
        layers.append(out)
    res = {"layers": layers}
    for key in ("enc_k", "enc_v"):
        if key in cache:
            res[key] = [t.cpu().numpy() for t in cache[key]]
    return res


def _port_arch(arch, params, mesh, dev, d, dr, out, deadline, save_ckpt):
    import torch

    from repro_torch import configs
    from repro_torch.convert import (model_from_reference,
                                     opt_state_from_reference,
                                     reference_state)
    from repro_torch.models.common import named_slices
    from repro_torch.parallel.sharding import local_shard
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.optimizer import apply_updates

    cfg = configs.get_config(arch).reduced()
    model = model_from_reference(cfg, params, device=dev, mesh=mesh)
    toks, frames = inputs(cfg)
    n = B // d
    rows = slice(dr * n, (dr + 1) * n)
    f = None if frames is None else frames[rows]
    res = {"device": str(model.lm_head.device)}
    res["forward"] = model.forward(toks[rows, :S], frames=f).cpu().numpy()
    lg, cache = model.prefill(toks[rows, :PROMPT], MAX_LEN,
                              frames=None if f is None else f[:, :PROMPT])
    res["prefill"], res["cache"] = lg.cpu().numpy(), _cache_full(cfg, cache,
                                                                 mesh)
    res["kv_split"] = cache.get("kv_split", False)
    dec = []
    for i in range(STEPS):
        pos = PROMPT + i
        lg, cache = model.decode_step(cache, toks[rows, pos:pos + 1], pos)
        dec.append(lg.cpu().numpy())
    res["decode"] = np.stack(dec, axis=1)

    batch = {"tokens": toks[rows, :S], "labels": toks[rows, 1:]}
    if f is not None:
        batch["frames"] = f
    ocfg = AdamWConfig(**OPT, state_dtype=cfg.opt_state_dtype)
    step = make_train_step(model, ocfg, group=mesh["data"].get_group())
    _, _, met = step(model, init_state(model, ocfg), batch)
    res["loss"] = float(met["loss"])
    res["grads"] = _params_full(
        model, {k: p.grad for k, p in model.named_parameters()}, mesh)

    # AdamW on this rank's shards of the reference's own gradients
    ref = _wait_load(os.path.join(out, f"ref_{arch}.pkl"), deadline)
    model = model_from_reference(cfg, params, device=dev, mesh=mesh)
    pl = model.shardings()
    grads = {k: local_shard(g, pl[k], mesh).to(dev) for k, g in
             reference_state(cfg, ref["grads"]).items()}
    _, st, met = apply_updates(model, grads, init_state(model, ocfg), ocfg)
    res["gnorm"] = float(met["grad_norm"])
    res["new_params"] = _params_full(
        model, dict(model.named_parameters()), mesh)
    res["m"] = _params_full(model, st.m, mesh)
    res["v"] = _params_full(model, st.v, mesh)
    res["slices"] = dict(named_slices(model))

    if save_ckpt and arch == CKPT_ARCH:
        from repro_torch.checkpoint import CheckpointManager

        jst = (np.int32(1), ref["m"], ref["v"])
        ck = model_from_reference(cfg, params, device=dev, mesh=mesh)
        opt = opt_state_from_reference(cfg, jst, ck)
        CheckpointManager(os.path.join(out, "ckpt"), async_save=False).save(
            1, (ck, opt))
    return res


def run(rank: int, world: int, store: str, shape, out: str,
        device: str = "cpu", archs=None) -> None:
    import torch
    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            from repro_torch.launch.mesh import make_host_mesh

            torch.set_num_threads(1)
            d, m = shape
            mesh = make_host_mesh(d, m, device_type="cpu")
            dev = torch.device(device)
            dr = mesh.get_local_rank("data")
            deadline = time.time() + TIMEOUT_S
            result = {}
            for arch in archs or ARCHS:
                params = _wait_load(os.path.join(out, f"params_{arch}.pkl"),
                                    deadline)
                result[arch] = _port_arch(arch, params, mesh, dev, d, dr, out,
                                          deadline, save_ckpt=shape == (1, 2))
            result["data_rank"] = dr
            result["model_rank"] = mesh.get_local_rank("model")
        finally:
            dist.destroy_process_group()
        _dump(os.path.join(out, f"rank{rank}.pkl"), result)
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# the module fixture and the tests each file imports
# ---------------------------------------------------------------------------

def launch(shape, out, device="cpu", archs=None, reference_too=True):
    """Start the reference and the ranks; wait for both; return (the
    ranks' results by data rank, the reference's by arch, ``out``)."""
    import torch.multiprocessing as tmp

    os.makedirs(out, exist_ok=True)
    d, m = shape
    world = d * m
    refs_p = [start_reference(d, m, out, part, f"reference{i}.log")
              for i, part in enumerate(REFERENCE_SPLIT)] \
        if reference_too else []
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world,
                                           os.path.join(out, "store"),
                                           shape, out, device, archs),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.time() + TIMEOUT_S + 60
        while time.time() < deadline and any(p.is_alive() for p in procs):
            if any(r.poll() for r in refs_p):
                break           # the reference failed: its log says why
            time.sleep(0.2)
        for r in refs_p:
            r.wait(max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for r in refs_p:
            if r.poll() is None:
                r.kill()
    errs = {r: open(os.path.join(out, f"rank{r}.err")).read()
            for r in range(world)
            if os.path.exists(os.path.join(out, f"rank{r}.err"))}
    for i, r in enumerate(refs_p):
        with open(os.path.join(out, f"reference{i}.log")) as f:
            assert r.returncode == 0, f.read()[-3000:]
    assert [p.exitcode for p in procs] == [0] * world, errs
    by_rank = {}
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        by_rank[res["data_rank"], res["model_rank"]] = res
    assert sorted(by_rank) == [(dr, mr) for dr in range(d) for mr in range(m)]
    ranks = {dr: by_rank[dr, 0] for dr in range(d)}
    for dr in range(d):
        ranks[dr]["peers"] = [by_rank[dr, mr] for mr in range(1, m)]
    refs = {}
    for a in archs or ARCHS:
        with open(os.path.join(out, f"ref_{a}.pkl"), "rb") as f:
            refs[a] = pickle.load(f)
    return ranks, refs, out


def _rows(ranks, arch, key):
    return np.concatenate([ranks[dr][arch][key] for dr in sorted(ranks)])


def _state(arch, tree):
    from repro_torch import configs
    from repro_torch.convert import reference_state

    cfg = configs.get_config(arch).reduced()
    return {k: v.float().numpy() if v.dtype.is_floating_point else v.numpy()
            for k, v in reference_state(cfg, tree).items()}


def check_forward(ranks, refs, out, arch):
    np.testing.assert_allclose(_rows(ranks, arch, "forward"),
                               refs[arch]["forward"], **TOL)


def check_prefill_and_decode(ranks, refs, out, arch):
    from repro_torch import configs
    from repro_torch.models.blocks import unit_layout

    cfg = configs.get_config(arch).reduced()
    ref = refs[arch]
    np.testing.assert_allclose(_rows(ranks, arch, "prefill"), ref["prefill"],
                               **TOL)
    np.testing.assert_allclose(_rows(ranks, arch, "decode"), ref["decode"],
                               **TOL)
    # the cache: split-KV over 'model' (gathered whole), data ranks' rows
    assert all(ranks[dr][arch]["kv_split"] for dr in ranks)
    n_units, layout = unit_layout(cfg)
    units = ref["cache"]["units"]
    i = 0
    for u in range(n_units):
        for j in range(len(layout)):
            tree = units if len(layout) == 1 else units[f"layer{j}"]
            for key, want in tree.items():
                got = np.concatenate([ranks[dr][arch]["cache"]["layers"][i][key]
                                      for dr in sorted(ranks)])
                np.testing.assert_allclose(got, want[u], err_msg=f"{i}.{key}",
                                           **TOL)
            i += 1
    if cfg.encdec:
        for key in ("enc_k", "enc_v"):
            for layer in range(cfg.n_layers):
                got = np.concatenate([ranks[dr][arch]["cache"][key][layer]
                                      for dr in sorted(ranks)])
                np.testing.assert_allclose(got, ref["cache"][key][layer],
                                           **TOL)


def check_loss_and_gradients(ranks, refs, out, arch):
    got = ranks[0][arch]
    np.testing.assert_allclose(got["loss"], refs[arch]["loss"], **TOL)
    want = _state(arch, refs[arch]["grads"])
    assert sorted(want) == sorted(got["grads"])
    for k, w in want.items():
        err = np.max(np.abs(got["grads"][k] - w)) if w.size else 0.0
        assert err <= GRAD_RTOL * np.max(np.abs(w), initial=0.0) + 1e-9, \
            (k, err, np.max(np.abs(w), initial=0.0))
    # some parameter really is split over the model axis
    assert any(sl is not None for sl in got["slices"].values())
    _check_peers(ranks, arch, "grads")


def _check_peers(ranks, arch, *names):
    """Every model rank of every data rank holds what its model rank 0
    holds, bit for bit: its own copy of each replicated leaf (and the
    gathered split ones), and the loss and clip norm."""
    for dr in sorted(ranks):
        want = ranks[dr][arch]
        for peer in ranks[dr]["peers"]:
            got = peer[arch]
            for key in ("loss", "gnorm"):
                assert got[key] == want[key], (dr, peer["model_rank"], key)
            for name in names:
                assert sorted(got[name]) == sorted(want[name])
                for k, w in want[name].items():
                    np.testing.assert_array_equal(
                        got[name][k], w, err_msg=f"data rank {dr} model rank "
                        f"{peer['model_rank']} {name} {k}")


def check_adamw_update(ranks, refs, out, arch):
    got, ref = ranks[0][arch], refs[arch]
    np.testing.assert_allclose(got["gnorm"], ref["gnorm"], rtol=1e-6)
    for name, tree in (("new_params", ref["new_params"]), ("m", ref["m"]),
                       ("v", ref["v"])):
        want = _state(arch, tree)
        for k, w in want.items():
            np.testing.assert_allclose(got[name][k], w, rtol=2e-6, atol=1e-9,
                                       err_msg=f"{name} {k}")
    _check_peers(ranks, arch, "new_params", "m", "v")


if __name__ == "__main__":
    reference(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
              sys.argv[4].split(","))
