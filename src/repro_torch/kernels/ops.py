"""Public kernel wrappers.

A wrapper given CUDA tensors launches its hand-written kernel (building
it on first use) or raises; given CPU tensors it runs the kernel's plain
PyTorch version — the path the CPU tests take.  There is no fallback
from one to the other.  Each wrapper counts its kernel launches in an
integer attribute (``paged_flash_decode.launches``), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

from . import paged_decode as PD


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
    if q.device.type == "cpu":
        return PD.paged_decode_plain(*args, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: no kernel for device "
                         f"{q.device}")
    out = PD.paged_decode_cuda(q.float().contiguous(), *args[1:], **kw)
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def launch_counts() -> dict:
    """Kernel name -> launches counted so far."""
    return {"paged_decode": paged_flash_decode.launches}


def reset_launch_counts():
    paged_flash_decode.launches = 0
