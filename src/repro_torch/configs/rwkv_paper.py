"""RWKV — the paper's own LM benchmark model (§4.1, Table 4).

"a six-layer, 512-size embedding RWKV model" trained on Enwik8
(char-level).  Used by the accuracy-reproduction examples; not part of
the assigned 10-arch pool.
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv-paper",
        family="rnn",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_head=64,
        d_ff=2048,
        vocab=256,
        pattern=("rwkv",),
        rope_kind="none",
        norm="layernorm",
        subquadratic=True,
    )
