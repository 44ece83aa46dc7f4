"""``forward_loss`` and its gradients against JAX under HNN ``spike``,
the faithful IF encoder, whose penalty's gradient runs the surrogate
through the tick loop.  The checks are ``test_torch_train_loss.py``'s:
values within 1e-5, gradients within the measured float conditioning
of the reference's own (see there).  A file of its own for the 30 s
budget of one file.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_loss import check_forward_loss  # noqa: E402


def test_forward_loss_spike_matches_jax():
    check_forward_loss("hnn", "spike")
