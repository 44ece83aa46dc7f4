"""Reduced ``qwen2-moe-a2.7b`` under codec ``spike_pack4``: the checks of
``test_torch_arch_qwen2moe.py``, in a file of their own so that its
JAX models compile within one file's time."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_arch_qwen2moe import ARCH  # noqa: E402
from test_torch_engine import check_streams_match_jax  # noqa: E402
from test_torch_model import (_Models, check_prefill,  # noqa: E402
                              check_teacher_forced)
from test_torch_verify import check_verify  # noqa: E402

torch.set_num_threads(1)

MODELS = _Models(ARCH, seeded=True)
CODEC = "spike_pack4"


def test_prefill_matches_jax():
    check_prefill(MODELS[CODEC])


def test_teacher_forced_paged_decode_matches_jax():
    check_teacher_forced(MODELS[CODEC])


def test_forward_verify_matches_jax():
    check_verify(MODELS[CODEC])


def test_engine_streams_match_jax():
    check_streams_match_jax(MODELS[CODEC])
