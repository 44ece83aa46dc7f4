"""Training reduced ``xlstm-125m``: ``forward_loss`` and every leaf's
gradient against ``jax.value_and_grad`` of the reference's, ANN (codec
``none``) and HNN ``spike_fused`` (``test_torch_train_rnn.py``'s check
and tolerance, 1e-5 per element).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_rnn import check  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("hnn,codec", (("ann", "none"),
                                       ("hnn", "spike_fused")))
def test_forward_loss_and_grads_match_jax(hnn, codec):
    check("xlstm-125m", None, hnn, codec)
