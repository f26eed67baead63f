"""Tensor and expert parallelism of the port's model zoo on a 2 x 2 mesh
(4 gloo ranks as two data ranks of a two-way model group each), against the JAX package sharded on a
2 x 2 host mesh: every arch at ``reduced()`` (float32), forward, prefill and
its split-KV cache, 4 decode steps, the loss and its gradients through
``make_train_step``, and one AdamW update (``tests/_torch_tp_worker.py``
has the procedure and the tolerances; ``test_torch_tensor_parallel.py``
the 1 x 2 mesh, the checkpoints and the card).
"""
import pytest

import _torch_tp_worker as tp

MESH = (2, 2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return tp.launch(MESH, str(tmp_path_factory.mktemp("tp22")))


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
