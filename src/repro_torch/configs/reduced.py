"""Reduced (smoke-test) variants: same family/pattern, tiny dims.

The same shrink as ``repro.configs.reduced``, so a reduced config here
and there describe identical parameter shapes: the CPU tests run these
through both packages, and only the GPU smoke run uses full widths.
"""
from __future__ import annotations

from .base import ModelConfig


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink every axis while keeping the architecture family intact."""
    n_units = max(1, min(2, cfg.n_units))
    kw = dict(
        n_layers=n_units * len(cfg.pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        window=16,
    )
    if cfg.n_experts:
        kw.update(n_experts=max(4, min(8, cfg.n_experts)),
                  top_k=min(cfg.top_k, 2),
                  d_ff_expert=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.family in ("hybrid", "ssm"):
        kw.update(d_state=8, d_conv=4, expand=2, dt_rank=8)
    if cfg.is_encdec:
        kw.update(n_enc_layers=2)
    if cfg.name == "xlstm-125m":
        kw.update(d_model=64, n_heads=4, n_kv_heads=4, d_ff=0)
    return cfg.replace(**kw)
