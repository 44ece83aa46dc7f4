"""Reduced ``gemma2-2b`` in the port against the JAX reference.

The config keeps its local/global pattern (window 16 after the shrink),
both softcaps, the sandwich post-norms, GeGLU and tied embeddings; the
shrink makes it MHA (4 heads on 4), so both sides run it with the same
``cfg.replace(n_heads=8, n_kv_heads=2)`` to keep GQA (8 heads of 16 on
2 KV heads).  The init leaves biases and norm scales at zero, so they
are seeded on the JAX parameters before they are carried across
(``test_torch_model.seed_zero_init_leaves``).  Per codec, with
``test_torch_model.py``'s ``JaxModel`` and tolerances (logits 1e-5,
greedy tokens exact up to a margin of 1e-4):

* prefill logits and the prompt KV of both pattern positions;
* five teacher-forced decode steps of three slots, both walks;
* three ``forward_verify`` steps at K1 = 4 with rollbacks, both walks;
* the engine's greedy streams against ``JaxModel.greedy_solo``.

Codec ``none`` (ANN mode) runs here; ``spike_fused``, ``spike``,
``spike_pack4`` and ``sparse_topk`` each in a file of its own,
``test_torch_arch_gemma2_<codec>.py``: each JAX model compiles once per
file, and a file must run in under 30 s on one worker.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import check_streams_match_jax  # noqa: E402
from test_torch_model import (_Models, check_prefill,  # noqa: E402
                              check_teacher_forced)
from test_torch_verify import check_verify  # noqa: E402

torch.set_num_threads(1)

#: 8 query heads on 2 KV heads, the same on both sides
GQA = dict(n_heads=8, n_kv_heads=2)
MODELS = _Models("gemma2-2b", overrides=GQA, seeded=True)
CODECS = ("none",)


def test_variant_keeps_gemma2():
    cfg = MODELS["none"].tcfg
    assert (cfg.pattern, cfg.window, cfg.n_heads, cfg.n_kv_heads) == (
        ("local", "global"), 16, 8, 2)
    assert cfg.attn_softcap and cfg.final_softcap and cfg.post_norm
    assert cfg.tie_embeddings and cfg.act == "gelu"


@pytest.mark.parametrize("codec", CODECS)
def test_prefill_matches_jax(codec):
    check_prefill(MODELS[codec])


@pytest.mark.parametrize("codec", CODECS)
def test_teacher_forced_paged_decode_matches_jax(codec):
    check_teacher_forced(MODELS[codec])


@pytest.mark.parametrize("codec", CODECS)
def test_forward_verify_matches_jax(codec):
    check_verify(MODELS[codec])


@pytest.mark.parametrize("codec", CODECS)
def test_engine_streams_match_jax(codec):
    check_streams_match_jax(MODELS[codec])
