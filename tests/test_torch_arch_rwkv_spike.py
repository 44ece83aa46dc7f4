"""Reduced ``rwkv-paper`` in the port against the JAX reference under
coded boundaries: HNN ``spike_fused`` (prefill, teacher-forced decode,
the engine's greedy streams) and SNN ``spike_fused``, whose prefill also
roundtrips both block outputs through their codec locally (the
reference's ``_local_roundtrip``s in ``rwkv_fwd``; its decode has none,
and neither has the port's).  HNN ``spike``, the faithful IF encoder,
prefills and decodes too.

Tolerances as in ``test_torch_arch_rwkv.py``.  A spike count whose
input lies within float noise of a rounding boundary would part the two
sides (the port's wkv prefill sums a chunk in another order than the
reference's step); on these seeded inputs none does, so every value is
compared.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import (RecModels, check_prefill,  # noqa: E402
                        check_streams, check_teacher_forced)

torch.set_num_threads(1)

MODELS = RecModels("rwkv-paper")
KEYS = (("hnn", "spike_fused"), ("snn", "spike_fused"), ("hnn", "spike"))


@pytest.mark.parametrize("key", KEYS)
def test_prefill_matches_jax(key):
    check_prefill(MODELS[key])


@pytest.mark.parametrize("key", KEYS)
def test_teacher_forced_decode_matches_jax(key):
    check_teacher_forced(MODELS[key], walks=("fused",))


def test_engine_streams_match_jax():
    check_streams(MODELS["hnn", "spike_fused"], walks=("fused",))
