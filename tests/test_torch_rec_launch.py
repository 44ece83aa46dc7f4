"""The recurrent-state families through the port's ``launch.serve``
steps: the dense per-slot cache carries their state leaves
(``rnn_state`` / ``rwkv_state``, [U, B, ...]), which ``make_prefill_step``
returns and ``make_decode_step`` updates in place, as
``repro.launch.serve``'s steps return and update them.

``test_torch_dense_decode.py``'s checks on a 1x1 mesh: the quickstart's
[2, 32] prefill, then four greedy decode steps (logits within 1e-5 and
every cache leaf within 1e-5, relative and absolute), on reduced
``xlstm-125m`` (ANN, codec ``none``) and ``rwkv-paper`` (HNN
``spike_fused``), and the teacher-forced logits of ``rwkv-paper``.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dense_decode import (check_logits_step,  # noqa: E402
                                     check_quickstart_sequence)

torch.set_num_threads(1)


@pytest.mark.parametrize("codec,arch", (("none", "xlstm-125m"),
                                        ("spike_fused", "rwkv-paper")))
def test_launch_serve_steps_match_reference(codec, arch):
    check_quickstart_sequence(codec, arch)


def test_logits_step_matches_reference():
    check_logits_step("spike_fused", "rwkv-paper")
