"""Tensor and expert parallelism of the port's model zoo on a 1 x 4 mesh
(4 gloo ranks as one model group of four), against the JAX package sharded on a
1 x 4 host mesh: every arch at ``reduced()`` (float32), forward, prefill and
its split-KV cache, 4 decode steps, the loss and its gradients through
``make_train_step``, and one AdamW update (``tests/_torch_tp_worker.py``
has the procedure and the tolerances; ``test_torch_tensor_parallel.py``
the 1 x 2 mesh, the checkpoints and the card); and the refusal of a MoE
whose experts the axis does not divide.
"""
import pytest

import _torch_tp_worker as tp

MESH = (1, 4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tp.launch(MESH, str(tmp_path_factory.mktemp("tp14")))


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


def test_moe_whose_experts_the_axis_does_not_divide():
    """6 experts over a model axis of 4: the JAX spec would split each
    expert's ffn dim instead of whole experts, a layout no config of the
    zoo meets; ``Model`` refuses it before it allocates, on every rank,
    and takes 8 experts on the same axis."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import Model

    base = configs.get_config("arctic-480b").reduced()
    for e, refused in ((6, True), (8, False)):
        cfg = dataclasses.replace(base, n_experts=e)
        for r in range(MESH[1]):
            mesh = tp.MeshView(r, MESH)
            if refused:
                with pytest.raises(ValueError, match="does not divide its 6"):
                    Model(cfg, device="cpu", mesh=mesh)
            else:
                moe = Model(cfg, device="cpu", mesh=mesh).decoder[0].moe
                assert moe.shard_dim("w_gate") == 0
                assert moe.w_gate.shape[0] == e // MESH[1]
