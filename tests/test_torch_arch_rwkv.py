"""Reduced ``rwkv-paper`` (the paper's own language model, §4.1 Table 4:
RWKV-4 time-mix and channel-mix blocks, layer norms; reduced to 2
layers of width 64) in the port against the JAX reference, ANN mode
(codec ``none``).

With ``_torch_rec.py``'s ``RecJaxModel`` (exact-length prefill, the
zero-init and constant leaves seeded) and tolerance (1e-5 of each
value's largest entry): prefill logits and states, four teacher-forced
decode steps of three slots through both walks, ``forward_logits``,
the engine's greedy streams against ``JaxModel.greedy_solo``, and a
100-token prefill — a length the reference's chunked scan refuses —
against the port's own 64-token prefill and 36 decode steps.  HNN
codecs in ``test_torch_arch_rwkv_spike.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import (RecModels, check_logits, check_prefill,  # noqa: E402
                        check_split_prefill, check_streams,
                        check_teacher_forced)

torch.set_num_threads(1)

MODELS = RecModels("rwkv-paper")
KEY = ("ann", "none")


def test_prefill_matches_jax():
    check_prefill(MODELS[KEY])


def test_teacher_forced_decode_matches_jax():
    check_teacher_forced(MODELS[KEY])


def test_forward_logits_match_jax():
    check_logits(MODELS[KEY])


def test_engine_streams_match_jax():
    check_streams(MODELS[KEY])


def test_prefill_at_a_length_the_reference_refuses():
    check_split_prefill(MODELS[KEY])
