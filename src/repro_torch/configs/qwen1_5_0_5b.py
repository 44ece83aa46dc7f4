"""qwen1.5-0.5b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=2816 vocab=151936.
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_head=64,
        d_ff=2816,
        vocab=151936,
        pattern=("attn",),
        qkv_bias=True,
    )
