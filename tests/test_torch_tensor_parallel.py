"""Tensor and expert parallelism of the port's model zoo on a 1 x 2 mesh of
gloo ranks, against the JAX package sharded on a 1 x 2 host mesh: every
arch at ``reduced()`` (float32), forward, prefill and its split-KV cache,
4 decode steps, the loss and its gradients through ``make_train_step``,
and one AdamW update (``tests/_torch_tp_worker.py`` has the procedure and
the tolerances).  Also: a checkpoint the two ranks save holds the full
arrays, byte for byte those one rank saves of the same state, and restores
on one rank and on every rank of a 1 x 4 mesh; and one ``cuda``-marked
case per path (the checkpoint's too), which runs the two ranks on the
card.
"""
import os

import numpy as np
import pytest
import torch

import _torch_tp_worker as tp

MESH = (1, 2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tp.launch(MESH, str(tmp_path_factory.mktemp("tp12")))


@pytest.mark.parametrize("arch", tp.ARCHS)
def test_forward_matches_reference(run, arch):
    tp.check_forward(*run, arch)


@pytest.mark.parametrize("arch", tp.ARCHS)
def test_prefill_and_decode_match_reference(run, arch):
    tp.check_prefill_and_decode(*run, arch)


@pytest.mark.parametrize("arch", tp.ARCHS)
def test_loss_and_gradients_match_reference(run, arch):
    tp.check_loss_and_gradients(*run, arch)


@pytest.mark.parametrize("arch", tp.ARCHS)
def test_adamw_update_matches_reference(run, arch):
    tp.check_adamw_update(*run, arch)


def test_checkpoint_saved_on_two_ranks_restores_anywhere(run, tmp_path):
    """The two ranks saved the converted parameters and AdamW state of
    ``tp.CKPT_ARCH``: the same arrays, byte for byte, as one rank saves of
    the same state; restored on one rank, the same tensors; restored on
    each rank of a 1 x 4 mesh, that rank's shard of each."""
    import pickle

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import (model_from_reference,
                                     opt_state_from_reference)
    from repro_torch.models import Model
    from repro_torch.models.common import named_slices
    from repro_torch.train import AdamWConfig, init_state

    _, refs, out = run
    with open(os.path.join(out, f"params_{tp.CKPT_ARCH}.pkl"), "rb") as f:
        params = pickle.load(f)
    ref = refs[tp.CKPT_ARCH]
    cfg = configs.get_config(tp.CKPT_ARCH).reduced()
    model = model_from_reference(cfg, params, device="cpu")
    opt = opt_state_from_reference(cfg, (np.int32(1), ref["m"], ref["v"]),
                                   model)
    CheckpointManager(str(tmp_path), async_save=False).save(1, (model, opt))
    one = np.load(tmp_path / "step_00000001" / "arrays_p0.npz")
    two = np.load(os.path.join(out, "ckpt", "step_00000001",
                               "arrays_p0.npz"))
    assert sorted(one) == sorted(two)
    for k in one:
        assert np.array_equal(one[k], two[k]), k

    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    want = dict(model.named_parameters())
    m1 = Model(cfg, device="cpu")
    o1 = init_state(m1, ocfg)
    mgr.restore((m1, o1))
    for k, p in m1.named_parameters():
        assert torch.equal(p, want[k]) and torch.equal(o1.m[k], opt.m[k]), k
    split = 0
    for r in range(4):
        m4 = Model(cfg, device="cpu", mesh=tp.MeshView(r, (1, 4)))
        o4 = init_state(m4, ocfg)
        mgr.restore((m4, o4))
        got = dict(m4.named_parameters())
        for k, sl in named_slices(m4):
            cut = (lambda t: t) if sl is None else (lambda t: t.narrow(*sl))
            split += sl is not None
            assert torch.equal(got[k], cut(want[k])), (r, k)
            assert torch.equal(o4.v[k], cut(opt.v[k])), (r, k)
    assert split > 0


@pytest.fixture(scope="module")
def card_run(tmp_path_factory, run):
    """The two ranks on the card (gloo, sharing it), arctic-480b and
    jamba-1.5-large-398b, against the same reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import shutil

    _, _, out = run
    card = str(tmp_path_factory.mktemp("tp12cuda"))
    archs = ["arctic-480b", "jamba-1.5-large-398b"]
    for a in archs:
        for kind in ("params", "ref"):
            shutil.copy(os.path.join(out, f"{kind}_{a}.pkl"), card)
    return tp.launch(MESH, card, device="cuda", archs=archs,
                     reference_too=False), archs


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["forward", "prefill_and_decode",
                                  "loss_and_gradients", "adamw_update",
                                  "checkpoint"])
def test_on_the_card(run, card_run, path):
    (ranks, refs, out), archs = card_run
    for arch in archs:
        assert all(ranks[dr][arch]["device"].startswith("cuda")
                   for dr in ranks)
        if path != "checkpoint":
            getattr(tp, f"check_{path}")(ranks, refs, out, arch)
    if path == "checkpoint":    # the card's ranks wrote the host ranks' bytes
        step = os.path.join("ckpt", "step_00000001", "arrays_p0.npz")
        card, host = np.load(os.path.join(out, step)), np.load(
            os.path.join(run[2], step))
        assert sorted(card) == sorted(host)
        assert all(np.array_equal(card[k], host[k]) for k in host)
