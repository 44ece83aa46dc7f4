"""Reduced ``qwen2-moe-a2.7b`` in the port against the JAX reference:
every block ``attn_moe`` (MHA with QKV biases, then the MoE FFN of 8
experts, top-2, with one shared expert; the reduced config keeps 2
layers).

The biases and norm scales, zero at the init, are seeded on the JAX
parameters before they are carried across
(``test_torch_model.seed_zero_init_leaves``).  With
``test_torch_model.py``'s ``JaxModel`` and tolerances (logits 1e-5,
greedy tokens exact up to a margin of 1e-4): prefill logits and prompt
KV, five teacher-forced decode steps and three K1 = 4 verify steps over
a shared pool through both walks, and the engine's greedy streams
against ``JaxModel.greedy_solo``.  At these widths capacity never
binds in serving (C = T for every prefill, decode and verify step:
k = 2 of 8 experts at cf 4.0), so a batched stream is the solo one.
Codec ``none`` here; ``spike_fused``, ``spike_pack4`` and ``spike`` in
``test_torch_arch_qwen2moe_{fused,pack4,spike}.py`` (each JAX model
compiles once per file).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import check_streams_match_jax  # noqa: E402
from test_torch_model import (_Models, check_prefill,  # noqa: E402
                              check_teacher_forced)
from test_torch_verify import check_verify  # noqa: E402

torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"
MODELS = _Models(ARCH, seeded=True)
CODEC = "none"


def test_prefill_matches_jax():
    check_prefill(MODELS[CODEC])


def test_teacher_forced_paged_decode_matches_jax():
    check_teacher_forced(MODELS[CODEC])


def test_forward_verify_matches_jax():
    check_verify(MODELS[CODEC])


def test_engine_streams_match_jax():
    check_streams_match_jax(MODELS[CODEC])
