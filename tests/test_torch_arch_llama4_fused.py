"""Reduced ``llama4-maverick-400b-a17b`` under codec ``spike_fused``: the
checks of ``test_torch_arch_llama4.py`` (the engine's streams held to
the JAX replay of its own batches), in a file of their own so that its
JAX models compile within one file's time."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_arch_llama4 import (ARCH, check_streams_replay,  # noqa: E402
                                    check_third_slot_dropped)
from test_torch_model import (_Models, check_prefill,  # noqa: E402
                              check_teacher_forced)
from test_torch_verify import check_verify  # noqa: E402

torch.set_num_threads(1)

MODELS = _Models(ARCH, seeded=True)
CODEC = "spike_fused"


def test_prefill_matches_jax():
    check_prefill(MODELS[CODEC])


def test_teacher_forced_paged_decode_matches_jax():
    check_teacher_forced(MODELS[CODEC])


def test_forward_verify_matches_jax():
    check_verify(MODELS[CODEC])


def test_engine_streams_match_jax_replay():
    check_streams_replay(MODELS[CODEC])


def test_third_slot_routed_output_dropped():
    check_third_slot_dropped(MODELS[CODEC])
