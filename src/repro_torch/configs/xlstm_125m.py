"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 (self-contained blocks) vocab=50304.
xLSTM[7:1]-style: mostly mLSTM with periodic sLSTM; unit of 4 =
(mlstm, mlstm, mlstm, slstm).  Recurrent -> runs the long_500k cell.
"""
from . import register
from .base import ModelConfig


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_head=192,
        d_ff=0,
        vocab=50304,
        pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        rope_kind="none",
        norm="layernorm",
        subquadratic=True,
    )
