"""The train step against JAX's under HNN ``spike`` at two
microbatches (float32 gradient accumulation): the checks of
``test_torch_train_step.py``, in a file of its own for the 30 s budget
of one file.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import check_train_steps  # noqa: E402


def test_train_steps_spike_two_microbatches_match_jax():
    first = check_train_steps("hnn", "spike", 2)
    assert first["penalty"] > 0
