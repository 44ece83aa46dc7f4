"""The train step against JAX's under HNN ``spike``, the faithful IF
encoder (its penalty's gradient runs the surrogate through the ticks):
the checks of ``test_torch_train_step.py`` at one microbatch (two:
``test_torch_train_step_spike_mb2.py``), in a file of its own for the
30 s budget of one file.  Its first step is the reference's own run
on the quickstart batch: NLL 5.5641, grad norm 18.43.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import check_oracle  # noqa: E402
from test_torch_train_step import check_train_steps  # noqa: E402


def test_train_steps_spike_match_jax():
    first = check_train_steps("hnn", "spike", 1)
    check_oracle(first, 18.43, 1e-2)
