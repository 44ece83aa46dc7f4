"""Reduced ``qwen1.5-4b`` (MHA with QKV bias) in the port against the
JAX reference.

The biases and norm scales, zero at the init, are seeded on the JAX
parameters before they are carried across
(``test_torch_model.seed_zero_init_leaves``).  Under ``none``,
``spike_fused`` and ``spike_pack4``, with ``test_torch_model.py``'s
``JaxModel`` and tolerances (logits 1e-5, greedy tokens exact up to
a margin of 1e-4): prefill logits and prompt KV, five teacher-forced
decode steps and three K1 = 4 verify steps over a shared pool through
both walks, and the engine's greedy streams against
``JaxModel.greedy_solo``.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import check_streams_match_jax  # noqa: E402
from test_torch_model import (_Models, check_prefill,  # noqa: E402
                              check_teacher_forced)
from test_torch_verify import check_verify  # noqa: E402

torch.set_num_threads(1)

MODELS = _Models("qwen1.5-4b", seeded=True)
CODECS = ("none", "spike_fused", "spike_pack4")


@pytest.mark.parametrize("codec", CODECS)
def test_prefill_matches_jax(codec):
    check_prefill(MODELS[codec])


@pytest.mark.parametrize("codec", CODECS)
def test_teacher_forced_paged_decode_matches_jax(codec):
    check_teacher_forced(MODELS[codec])


@pytest.mark.parametrize("codec", CODECS)
def test_forward_verify_matches_jax(codec):
    check_verify(MODELS[codec])


@pytest.mark.parametrize("codec", CODECS)
def test_engine_streams_match_jax(codec):
    check_streams_match_jax(MODELS[codec])
