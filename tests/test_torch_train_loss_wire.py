"""``forward_loss`` and its gradients against JAX for the packed and
sparse wires: HNN ``spike_pack4``, ``sparse_topk`` and
``spike_fused+bwd8`` (int8-coded cotangents at the gathers and
reduce-scatters).  The checks and the tolerance (1e-5) are
``test_torch_train_loss.py``'s; the codecs are split over files because
each JAX model compiles once (``spike``: ``test_torch_train_loss_spike.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_loss import check_forward_loss  # noqa: E402


@pytest.mark.parametrize("codec", ["spike_pack4", "sparse_topk",
                                   "spike_fused+bwd8"])
def test_forward_loss_wire_codecs_match_jax(codec):
    check_forward_loss("hnn", codec)
