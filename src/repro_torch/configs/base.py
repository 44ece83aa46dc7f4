"""Model configuration schema shared by every architecture.

The port's copy of ``repro.configs.base``: same fields, defaults and
derived helpers, with ``dtype`` a torch dtype.  A config fully
determines parameter shapes, the layer pattern, and which boundaries
carry the spike codec.  ``pattern`` is the repeating unit of block
kinds; the stack is ``n_layers / len(pattern)`` units whose parameters
are stacked along a leading unit dim, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    pattern: Tuple[str, ...] = ("attn",)

    # attention
    qkv_bias: bool = False
    rope_kind: str = "rope"          # rope|mrope|none
    rope_theta: float = 1e4
    window: int = 4096               # sliding window for 'local' blocks
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    norm: str = "rmsnorm"            # rmsnorm|layernorm
    post_norm: bool = False          # gemma2 sandwich norms
    act: str = "silu"                # silu|gelu

    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25

    # mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model/16)

    # encoder-decoder
    is_encdec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub
    frontend: str = "none"           # none|patches|frames

    # hnn / boundary
    hnn_mode: str = "hnn"            # ann|hnn|snn
    codec: str = "spike_fused"       # none|int8|spike|spike_fused|spike_pack4|sparse_topk

    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    # whether this arch supports 524k decode (sub-quadratic path)
    subquadratic: bool = False

    # ---------------- derived helpers ----------------

    @property
    def n_units(self) -> int:
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} is not a multiple "
                f"of the pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or max(1, math.ceil(self.d_model / 16))

    def padded(self, n: int, mult: int) -> int:
        return ((n + mult - 1) // mult) * mult

    def heads_padded(self, tp: int) -> int:
        return self.padded(self.n_heads, tp)

    def kv_heads_eff(self, tp: int) -> tuple[int, bool]:
        """(#kv heads stored per shard basis, replicated?)."""
        if self.n_kv_heads % tp == 0:
            return self.n_kv_heads, False
        return self.n_kv_heads, True

    def ff_padded(self, tp: int) -> int:
        return self.padded(self.d_ff, tp) if self.d_ff else 0

    def ffe_padded(self, tp: int) -> int:
        return self.padded(self.d_ff_expert, tp) if self.d_ff_expert else 0

    def vocab_padded(self, tp: int) -> int:
        return self.padded(self.vocab, tp)

    def inner_padded(self, tp: int) -> int:
        return self.padded(self.d_inner, tp)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"

