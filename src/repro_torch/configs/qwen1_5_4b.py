"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-4B].

40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912 vocab=151936.
20 heads pad to 32 for tp=16 (pad waste noted in EXPERIMENTS.md).
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_head=128,
        d_ff=6912,
        vocab=151936,
        pattern=("attn",),
        qkv_bias=True,
    )
