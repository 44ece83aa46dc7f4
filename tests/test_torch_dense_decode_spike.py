"""The port's single-request serve steps against the reference's under
codec ``spike`` (the T-tick IF encoder at every coded boundary): the
checks of ``test_torch_dense_decode.py``, in a file of their own so that
each file's JAX steps compile within its time."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dense_decode import (check_logits_step,  # noqa: E402
                                     check_per_slot_positions,
                                     check_quickstart_sequence)

torch.set_num_threads(1)


def test_quickstart_sequence_matches_reference():
    check_quickstart_sequence("spike")


def test_per_slot_positions_match_reference():
    check_per_slot_positions("spike")


def test_logits_step_matches_reference():
    check_logits_step("spike")
