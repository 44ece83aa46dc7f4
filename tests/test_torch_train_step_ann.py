"""The train step against JAX's in ANN mode (codec ``none``): the
checks of ``test_torch_train_step.py`` at microbatches 1 and 2, in a
file of its own for the 30 s budget of one file.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_step import check_train_steps  # noqa: E402


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_ann_match_jax(microbatches):
    first = check_train_steps("ann", "none", microbatches)
    assert first["penalty"] == 0.0 and first["occupancy"] == 0.0
