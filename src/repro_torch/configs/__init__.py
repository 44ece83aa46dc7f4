"""Architecture registry: ``get_config(name)``; ``reduced.reduced(cfg)``.

Only the architectures the port can run are registered: the dense
attention family (``qwen1.5-0.5b``, ``qwen1.5-4b``, ``gemma2-2b``,
``granite-20b``), the MoE family (``qwen2-moe-a2.7b``,
``llama4-maverick-400b-a17b``) and the recurrent-state families
(``rwkv-paper``, ``xlstm-125m``, ``jamba-1.5-large-398b``); the others
join with their model families.
"""
from __future__ import annotations

from .base import ModelConfig, ShapeCell  # noqa: F401

_REGISTRY = {}


def register(fn):
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def _load_all():
    from . import (gemma2_2b, granite_20b, jamba_1_5_large,  # noqa: F401
                   llama4_maverick, qwen1_5_0_5b, qwen1_5_4b,
                   qwen2_moe_a2_7b, rwkv_paper, xlstm_125m)


def get_config(name: str, **overrides) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"{name!r} is not ported yet; ported: "
                       f"{sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def list_archs():
    _load_all()
    return sorted(_REGISTRY.keys())
