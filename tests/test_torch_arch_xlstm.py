"""Reduced ``xlstm-125m`` (arXiv:2405.04517: a unit of three mLSTM
blocks and one sLSTM block, layer norms; reduced to 8 layers of width
64, 4 heads of 16) in the port against the JAX reference, ANN mode
(codec ``none``).

With ``_torch_rec.py``'s ``RecJaxModel`` (exact-length prefill, the
zero-init leaves seeded) and tolerance (1e-5 of each value's largest
entry): prefill logits and states (mLSTM ``C``, ``n``, ``m``; sLSTM
``c``, ``n``, ``h``, ``m``), four teacher-forced decode steps of three
slots, ``forward_logits``, the engine's greedy streams against
``JaxModel.greedy_solo``, and a 100-token prefill — a length the
reference's chunked scans refuse — against the port's own 64-token
prefill and 36 decode steps.  HNN codecs in
``test_torch_arch_xlstm_spike.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import (RecModels, check_logits, check_prefill,  # noqa: E402
                        check_split_prefill, check_streams,
                        check_teacher_forced)

torch.set_num_threads(1)

MODELS = RecModels("xlstm-125m")
KEY = ("ann", "none")


def test_prefill_matches_jax():
    check_prefill(MODELS[KEY])


def test_teacher_forced_decode_matches_jax():
    # no attention: the two walks are one
    check_teacher_forced(MODELS[KEY], walks=("fused",))


def test_forward_logits_match_jax():
    check_logits(MODELS[KEY])


def test_engine_streams_match_jax():
    check_streams(MODELS[KEY], walks=("fused",))


def test_prefill_at_a_length_the_reference_refuses():
    check_split_prefill(MODELS[KEY])
