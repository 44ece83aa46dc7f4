"""Reduced ``jamba-1.5-large-398b`` at one unit (``n_layers=8`` on both
sides), ANN mode: four teacher-forced decode steps of three slots of
prompt lengths 4, 10 and 16 over one KV pool and slot-major mamba state,
through the kernel walk and the reference walk, against the JAX
reference's model-level steps (``_torch_rec.check_teacher_forced``:
logits every step, then every state leaf and pool page, within 1e-5 of
each value's largest entry).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import (JAMBA_ONE_UNIT, RecModels,  # noqa: E402
                        check_teacher_forced)

torch.set_num_threads(1)

MODELS = RecModels("jamba-1.5-large-398b", JAMBA_ONE_UNIT)


def test_teacher_forced_decode_matches_jax():
    check_teacher_forced(MODELS["ann", "none"])
