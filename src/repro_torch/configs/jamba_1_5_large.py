"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887; hf].
Unit of 8 layers: one attention layer per 8 (1:7), MoE every other layer
(Jamba places attention at index 4 of each 8-layer block; MoE on odd
indices).  Sub-quadratic (hybrid) -> runs the long_500k cell.
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=24576,
        vocab=65536,
        pattern=("mamba_mlp", "mamba_moe", "mamba_mlp", "mamba_moe",
                 "attn", "mamba_moe", "mamba_mlp", "mamba_moe"),
        n_experts=16,
        top_k=2,
        d_ff_expert=24576,
        d_state=16,
        d_conv=4,
        expand=2,
        rope_kind="none",          # jamba uses no positional encoding
        subquadratic=True,
    )
