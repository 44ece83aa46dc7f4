"""Reduced ``jamba-1.5-large-398b`` at one unit (``n_layers=8`` on both
sides) in the port against the JAX reference under HNN ``spike_fused``:
prefill logits, mamba states and KV, and four teacher-forced decode
steps of three slots on the kernel walk (``_torch_rec.py``'s checks and
tolerances, 1e-5 of each value's largest entry).  A spike count whose
input lies within float noise of a rounding boundary would part the two
sides; on these seeded inputs none does, so every value is compared.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import (JAMBA_ONE_UNIT, RecModels,  # noqa: E402
                        check_prefill, check_teacher_forced)

torch.set_num_threads(1)

MODELS = RecModels("jamba-1.5-large-398b", JAMBA_ONE_UNIT)
KEY = ("hnn", "spike_fused")


def test_prefill_matches_jax():
    check_prefill(MODELS[KEY], lengths=(16,))


def test_teacher_forced_decode_matches_jax():
    check_teacher_forced(MODELS[KEY], walks=("fused",))
