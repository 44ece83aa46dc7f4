"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1408 (per expert)
vocab=151936.  60 experts pad to 64 for tp=16 (router-masked dummies).
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,
        vocab=151936,
        pattern=("attn_moe",),
        qkv_bias=True,
        n_experts=60,
        top_k=4,
        n_shared_experts=4,
        d_ff_expert=1408,
    )
