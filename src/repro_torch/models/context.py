"""Execution context threaded through every block.

The port runs on one device: tp = dp = cp = 1, so of the reference's
fields the context keeps the config, the boundary codec, the mode, the
statistics flag and the encoder flag.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig
from ..core.boundary import BoundaryCodec
from ..core.spike import SpikeConfig


def codec_from_name(name: str, hnn_mode: str) -> BoundaryCodec:
    bwd = "none"
    if name.endswith("+bwd8"):       # int8-compressed backward cotangents
        name = name[:-5]
        bwd = "int8"
    if hnn_mode == "ann" or name == "none":
        return BoundaryCodec(mode="none")
    if name == "int8":
        return BoundaryCodec(mode="int8", bwd_mode=bwd)
    if name == "spike":
        return BoundaryCodec(mode="spike", cfg=SpikeConfig(T=15,
                                                           faithful=True),
                             bwd_mode=bwd)
    if name == "spike_fused":
        return BoundaryCodec(mode="spike_fused", cfg=SpikeConfig(T=15),
                             bwd_mode=bwd)
    if name == "spike_pack4":
        return BoundaryCodec(mode="spike_pack4", cfg=SpikeConfig(T=7),
                             bwd_mode=bwd)
    if name == "sparse_topk":
        return BoundaryCodec(mode="sparse_topk", cfg=SpikeConfig(T=15),
                             capacity=0.125, bwd_mode=bwd)
    raise ValueError(name)


@dataclasses.dataclass(frozen=True)
class Context:
    cfg: ModelConfig
    codec: BoundaryCodec
    mode: str = "train"            # train|prefill|decode
    #: in train mode, compute each gathered boundary's eq-10 penalty and
    #: occupancy (``blocks_attn._stats``)
    collect_stats: bool = True
    is_encoder: bool = False       # non-causal attention
    #: run ``ops.count_matmul`` on the spike counts of every boundary
    #: whose decoded output feeds a projection, once per weight, beside
    #: the served decode-then-matmul (``core.boundary``; a check of the
    #: kernel on live traffic, not a reference feature)
    count_matmul_shadow: bool = False

    def with_(self, **kw):
        return dataclasses.replace(self, **kw)


def make_context(cfg: ModelConfig, mode: str = "train") -> Context:
    return Context(cfg=cfg, codec=codec_from_name(cfg.codec, cfg.hnn_mode),
                   mode=mode)


def pool_local_pages(page_ids, pool_index, pages_local):
    """Map global KV-pool page ids onto this shard's local pool slice.

    Global page p lives on shard ``p // pages_local`` at row
    ``p % pages_local``.  Returns ``(loc, ok)``: where ``ok`` (mapped
    and resident here) ``loc`` is the local row; else ``loc`` is
    ``pages_local`` — one past the end: the KV write's sink row (torch
    has no dropping scatter), which every reader replaces by a fixed row
    under the ``ok`` mask.
    """
    loc = page_ids - pool_index * pages_local
    ok = (page_ids >= 0) & (loc >= 0) & (loc < pages_local)
    return torch.where(ok, loc, torch.full_like(loc, pages_local)), ok
