"""Reduced ``jamba-1.5-large-398b`` at one unit of its 8-layer pattern
(mamba + dense MLP, mamba + MoE, and one attention layer with no RoPE;
width 64, 8 experts top-2; ``n_layers=8`` on both sides) in the port
against the JAX reference, ANN mode (codec ``none``).

With ``_torch_rec.py``'s ``RecJaxModel`` (exact-length prefill, the
zero-init and constant leaves seeded) and tolerance (1e-5 of each
value's largest entry): prefill logits, mamba states (``conv``,
``ssm``) and attention KV, ``forward_logits``, and the engine's greedy
streams through both walks against ``JaxModel.greedy_solo``.  Four
teacher-forced decode steps in ``test_torch_arch_jamba_decode.py``, HNN
codecs in ``test_torch_arch_jamba_spike.py`` (each JAX model compiles
once per file and prompt length).
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_rec import (JAMBA_ONE_UNIT, RecModels,  # noqa: E402
                        check_logits, check_prefill, check_streams)

torch.set_num_threads(1)

MODELS = RecModels("jamba-1.5-large-398b", JAMBA_ONE_UNIT)
KEY = ("ann", "none")


def test_prefill_matches_jax():
    check_prefill(MODELS[KEY], lengths=(16,))


def test_forward_logits_match_jax():
    check_logits(MODELS[KEY])


def test_engine_streams_match_jax():
    check_streams(MODELS[KEY])
