"""Public kernel wrappers.

A wrapper given CUDA tensors launches its hand-written kernel (building
it on first use) or raises; given CPU tensors it runs the kernel's plain
PyTorch version — the path the CPU tests take.  There is no fallback
from one to the other.  Each wrapper counts its kernel launches in an
integer attribute (``paged_flash_decode.launches``), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from . import count_matmul as CM
from . import lif_encode as LE
from . import pack4 as PK
from . import paged_decode as PD
from . import roundtrip_bwd as RB


def _on_cuda(name, t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def paged_flash_decode(q, k_pool, v_pool, cl_page, cl_pos, qpos, *,
                       window: int = 0, cap: float = 0.0,
                       encode_wire: bool = False):
    """Fused page-gather -> flash decode -> LSE partial over one pool.

    q [B,K1,Hq,dh] x pool [P_loc,psz,Hkv,dh], walking each slot's
    compacted page list (cl_page local rows / cl_pos absolute start
    positions, [B,ppc], -1 = none).  Returns ``(o, lse)`` or, with
    ``encode_wire``, the epilogue-quantized ``(wire, scale, lse)`` for
    the coded combine.  The CUDA path takes q as f32 (a bf16 q is cast
    here, as the TPU kernel casts it inside).
    """
    args = (q, k_pool, v_pool, cl_page, cl_pos, qpos)
    kw = dict(window=window, cap=cap, encode_wire=encode_wire)
    if not _on_cuda("paged_flash_decode", q):
        return PD.paged_decode_plain(*args, **kw)
    out = PD.paged_decode_cuda(q.float().contiguous(), *args[1:], **kw)
    paged_flash_decode.launches += 1
    return out


def lif_encode(x, theta, scale, *, T: int = 15, math_dtype=torch.float32,
               decode_scale=None):
    """T-tick on/off IF rate encoder: x [M, C] -> int8 counts [M, C],
    gated on ``|x/scale| >= theta/scale``; theta, scale [C], taken as
    float32 (as the TPU kernel casts them).  ``math_dtype`` float32 is
    the TPU kernel's arithmetic; bfloat16 rounds every op to bf16, as the
    JAX codec computes on a bf16 activation.  With ``decode_scale`` [C]
    (the decode's ``exp(log_scale) / T`` in x's dtype), returns
    ``(counts, counts * decode_scale)``, the rate decode in x's dtype
    from the same launch."""
    theta, scale = theta.float(), scale.float()
    if decode_scale is not None:
        decode_scale = decode_scale.float()
    if not _on_cuda("lif_encode", x):
        return LE.lif_encode_plain(x, theta, scale, T=T,
                                   math_dtype=math_dtype,
                                   decode_scale=decode_scale)
    out = LE.lif_encode_cuda(
        x.contiguous(), theta.contiguous(), scale.contiguous(), T=T,
        math_dtype=math_dtype,
        decode_scale=None if decode_scale is None else
        decode_scale.contiguous())
    lif_encode.launches += 1
    return out


def count_matmul(counts, w, scale, *, T: int = 15,
                 out_dtype=torch.bfloat16):
    """int8 spike counts [M, K] x w [K, N] (float32 or bfloat16) with
    the rate decode fused: ``(counts * (scale * f32(1/T))) @ w``, summed
    in float32 and rounded once to ``out_dtype``; scale [K], taken as
    float32."""
    scale = scale.float()
    if not _on_cuda("count_matmul", counts):
        return CM.count_matmul_plain(counts, w, scale, T=T,
                                     out_dtype=out_dtype)
    out = CM.count_matmul_cuda(counts.contiguous(), w.contiguous(),
                               scale.contiguous(), T=T, out_dtype=out_dtype)
    count_matmul.launches += 1
    return out


def pack4(wire):
    """uint8 values < 16, [M, C] with C even -> uint8 [M, C/2]."""
    if not _on_cuda("pack4", wire):
        return PK.pack4_plain(wire)
    out = PK.pack4_cuda(wire.contiguous())
    pack4.launches += 1
    return out


def pack4_counts(counts, T: int):
    """Signed spike counts [M, C] (float32 or bfloat16, C even) -> the
    packed uint8 [M, C/2] of ``(counts + T).to(torch.uint8)``: the bias
    and the pack in one launch, counted as a ``pack4`` launch."""
    if not _on_cuda("pack4_counts", counts):
        return PK.pack4_counts_plain(counts, T)
    out = PK.pack4_counts_cuda(counts.contiguous(), T)
    pack4.launches += 1
    return out


def unpack4(packed):
    """uint8 [M, C2] -> uint8 [M, 2*C2], the inverse of ``pack4``."""
    if not _on_cuda("unpack4", packed):
        return PK.unpack4_plain(packed)
    out = PK.unpack4_cuda(packed.contiguous())
    unpack4.launches += 1
    return out


def unpack4_decode(packed, T: int, decode_scale):
    """uint8 [M, C2] -> ``(unpack4(packed).to(dtype) - T) *
    decode_scale`` [M, 2*C2] in ``decode_scale``'s dtype (float32 or
    bfloat16; [2*C2], the decode's ``exp(log_scale) / T``): the unpack,
    the wire's unbias and the rate decode in one launch, counted as an
    ``unpack4`` launch."""
    if not _on_cuda("unpack4_decode", packed):
        return PK.unpack4_decode_plain(packed, T, decode_scale)
    out = PK.unpack4_decode_cuda(packed.contiguous(), T,
                                 decode_scale.contiguous())
    unpack4.launches += 1
    return out


def roundtrip_bwd(x, g, theta, s, s_over_T, *, T: int):
    """The backward of a spike-coded boundary's roundtrip: x, g [M, C]
    (float32 or bfloat16), theta, s = exp(log_scale) and s / T [C]
    (taken as float32) -> (dx [M, C] in x's dtype, dtheta [C],
    dlog_scale [C], float32)."""
    theta, s, s_over_T = theta.float(), s.float(), s_over_T.float()
    if not _on_cuda("roundtrip_bwd", x):
        return RB.roundtrip_bwd_plain(x, g, theta, s, s_over_T, T=T)
    out = RB.roundtrip_bwd_cuda(x.contiguous(), g.contiguous(),
                                theta.contiguous(), s.contiguous(),
                                s_over_T.contiguous(), T=T)
    roundtrip_bwd.launches += 1
    return out


def lif_encode_bwd(xn, thn, g, *, T: int = 15):
    """The faithful encoder's surrogate gradient: xn = x / scale and the
    cotangent g [M, C], thn = theta / scale [C] -> (dxn, dthn), both
    [M, C] (dthn per element, not summed over rows)."""
    if not _on_cuda("lif_encode_bwd", xn):
        return LE.lif_encode_bwd_plain(xn, thn, g, T=T)
    out = LE.lif_encode_bwd_cuda(xn.contiguous(), thn.contiguous(),
                                 g.contiguous(), T=T)
    lif_encode_bwd.launches += 1
    return out


_WRAPPERS = {"paged_decode": paged_flash_decode, "lif_encode": lif_encode,
             "count_matmul": count_matmul, "pack4": pack4,
             "unpack4": unpack4, "roundtrip_bwd": roundtrip_bwd,
             "lif_encode_bwd": lif_encode_bwd}


def launch_counts() -> dict:
    """Kernel name -> launches counted so far."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts():
    for fn in _WRAPPERS.values():
        fn.launches = 0


reset_launch_counts()
