"""The MoE family's training forward under ``spike`` (the T-tick IF
encoder at every penalty, ``sp_disp``'s among them): the check of
``test_torch_train_moe.py``, in a file of its own (one JAX model
compiles per codec)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_moe import check_moe_loss  # noqa: E402

torch.set_num_threads(1)


def test_moe_forward_loss_matches_jax_spike():
    _, grads = check_moe_loss("hnn", "spike")
    ls = max(np.abs(v).max() for k, v in grads.items()
             if "sp_disp" in k and "log_scale" in k)
    np.testing.assert_allclose(ls, 0.0249, rtol=2e-2)
