"""Training one unit of reduced ``jamba-1.5-large-398b`` (``n_layers=8``
on both sides: mamba + MLP, mamba + MoE with its capacity and aux loss,
attention): ``forward_loss`` and every leaf's gradient against
``jax.value_and_grad`` of the reference's, ANN (codec ``none``)
(``test_torch_train_rnn.py``'s check and tolerance, 1e-5 per element).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import JAMBA_ONE_UNIT  # noqa: E402
from test_torch_train_rnn import check  # noqa: E402

torch.set_num_threads(1)


def test_forward_loss_and_grads_match_jax():
    check("jamba-1.5-large-398b", JAMBA_ONE_UNIT, "ann", "none")
