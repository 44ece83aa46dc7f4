"""granite-20b [dense] — llama-arch, code, MQA kv=1 [arXiv:2405.04324; hf].

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_head=128,
        d_ff=24576,
        vocab=49152,
        pattern=("attn",),
        act="gelu",
    )
