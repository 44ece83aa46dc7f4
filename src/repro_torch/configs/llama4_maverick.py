"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.  Llama-4
interleaves dense and MoE layers (every other layer MoE) with one
shared expert; unit = (attn-dense, attn-moe).
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab=202048,
        pattern=("attn", "attn_moe"),
        n_experts=128,
        top_k=1,
        n_shared_experts=1,
        d_ff_expert=8192,
        rope_theta=5e5,
    )
