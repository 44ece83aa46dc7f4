"""The train step against JAX's under HNN ``spike_fused`` at two
microbatches (float32 gradient accumulation): the checks of
``test_torch_train_step.py``, in a file of its own for the 30 s budget
of one file.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import check_train_steps  # noqa: E402


def test_train_steps_two_microbatches_match_jax():
    first = check_train_steps("hnn", "spike_fused", 2)
    assert first["penalty"] > 0 and first["grad_norm"] > 0
