"""gemma2-2b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf].  26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000, window 4096, attn softcap 50, final softcap 30,
sandwich (post) norms, GeGLU.
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=9216,
        vocab=256000,
        pattern=("local", "global"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norm=True,
        act="gelu",
        tie_embeddings=True,
    )
