"""Reduced ``xlstm-125m`` in the port against the JAX reference under
HNN ``spike_fused`` and ``spike``: prefill logits and states, and four
teacher-forced decode steps of three slots (``_torch_rec.py``'s checks
and tolerances, 1e-5 of each value's largest entry).  A spike count
whose input lies within float noise of a rounding boundary would part
the two sides; on these seeded inputs none does, so every value is
compared.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import (RecModels, check_prefill,  # noqa: E402
                        check_teacher_forced)

torch.set_num_threads(1)

MODELS = RecModels("xlstm-125m")
KEYS = (("hnn", "spike_fused"), ("hnn", "spike"))


@pytest.mark.parametrize("key", KEYS)
def test_prefill_matches_jax(key):
    check_prefill(MODELS[key], lengths=(16,))


@pytest.mark.parametrize("key", KEYS)
def test_teacher_forced_decode_matches_jax(key):
    check_teacher_forced(MODELS[key], walks=("fused",))
