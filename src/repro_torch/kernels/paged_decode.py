"""Paged-decode attention: the plain version and the CUDA launch.

Replaces the TPU kernel ``paged_decode_pallas`` (body
``_paged_decode_kernel``) of ``src/repro/kernels/paged_decode.py``; the
plain version is the port of its oracle ``ref.paged_decode_ref`` plus
the epilogue quantize of ``ops.paged_flash_decode``.

Per slot the function walks the slot's compacted per-shard page list
(``cl_page`` local pool rows, ``cl_pos`` absolute start positions, -1 =
no page), scores K1 >= 1 queries against every page with GQA, the
1/sqrt(dh) scale, the optional tanh softcap, the causal and window
masks (sentinel -1e30), and returns the locally normalised partial and
``lse = m + log(max(l, 1e-30))``.  With ``encode_wire`` it returns the
partial quantized to int8 per (token, head): ``s = max(absmax,
1e-6)/127``, ``round(o/s)`` (half to even).

The CUDA kernel (``csrc/paged_decode.cu``) runs one block per (slot,
kv head, row group): a kv head's K1 x Hq/Hkv query rows are split into
groups of at most 8 — fewer while the grid would still fit one block
per SM, or where a group does not fit shared memory — so that a wide
GQA or MQA group (48 heads on one kv head at K1 = 4: 192 rows) neither
overflows a block nor runs on a handful of blocks (``launch_plan``
gives the rows and warps of a block at a shape).  What
bounds it on the card is memory: the K/V bytes of the
live pages, read once, plus q and the outputs, at the card's memory
bandwidth — decode attention does about one operation per byte, and at
the serve shape those bytes take under a microsecond, so the design
cuts the dependent trips to memory.  The block reads the list once,
keeps only the entries that hold a key some query may see (every entry
when some query token sees none, as for an evicted slot, so the
sentinel arithmetic is the oracle's), deals them to its warps, and
each warp streams its pages through a two-stage ``cp.async`` ring with
its own running max, normaliser and accumulator; the warps' partials
are combined in a fixed order.  Each staged page is shared by the GQA
group's query heads and all K1 query tokens, and nothing but the
(optionally int8) partial and lse is written.

``ops.paged_flash_decode`` is the wrapper callers use: CPU tensors take
``paged_decode_plain``, CUDA tensors ``paged_decode_cuda``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

F32 = torch.float32


def _quantize_wire(o):
    s = torch.clamp(torch.amax(torch.abs(o), dim=-1, keepdim=True),
                    min=1e-6) / 127.0
    return torch.round(o / s).to(torch.int8), s


def paged_decode_plain(q, k_pool, v_pool, cl_page, cl_pos, qpos, *,
                       window: int = 0, cap: float = 0.0,
                       encode_wire: bool = False):
    """Dense single-softmax version: gathers every listed page (a -1
    entry gathers page 0, fully masked) and runs the masking/softmax math
    of ``models.common.verify_attention_partial``.

    q [B,K1,Hq,dh]; k_pool/v_pool [P_loc,psz,Hkv,dh]; cl_page/cl_pos
    [B,ppc] int32; qpos [B,K1] int32.  Returns ``(o f32, lse f32)`` or,
    with ``encode_wire``, ``(wire int8, scale f32 [B,K1,Hq,1], lse)``.
    """
    B, K1, Hq, dh = q.shape
    _, psz, Hkv, _ = k_pool.shape
    ppc = cl_page.shape[1]
    valid = cl_page >= 0                                     # [B, ppc]
    safe = torch.where(valid, cl_page, torch.zeros_like(cl_page)).long()
    k_s = k_pool[safe].to(F32).reshape(B, ppc * psz, Hkv, dh)
    v_s = v_pool[safe].to(F32).reshape(B, ppc * psz, Hkv, dh)
    if Hkv != Hq:
        g = Hq // Hkv
        k_s = torch.repeat_interleave(k_s, g, dim=2)
        v_s = torch.repeat_interleave(v_s, g, dim=2)
    k_pos = (cl_pos[:, :, None]
             + torch.arange(psz, device=q.device)).reshape(B, ppc * psz)
    ent_ok = torch.repeat_interleave(valid, psz, dim=1)      # [B, ppc*psz]
    s = torch.einsum("bqhd,bkhd->bqhk", q.to(F32), k_s) / math.sqrt(dh)
    if cap:
        s = cap * torch.tanh(s / cap)
    posb = qpos[:, :, None, None]                            # [B,K1,1,1]
    mask = k_pos[:, None, None, :] <= posb
    if window:
        mask &= (posb - k_pos[:, None, None, :]) < window
    mask &= ent_ok[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bqhk,bkhd->bqhd", p, v_s)
    o = o / torch.clamp(l[..., None], min=1e-30)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    if not encode_wire:
        return o, lse
    wire, scale = _quantize_wire(o)
    return wire, scale, lse


def _library():
    lib = build.load("paged_decode")
    fn = lib.paged_decode_launch
    if fn.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 10 + [I] * 9 + [Fl, Fl, I, I, P]
        fn.restype = ctypes.c_int
        pl = lib.paged_decode_plan
        pl.argtypes = [I] * 8 + [ctypes.POINTER(I)] * 2
        pl.restype = I
    return fn


@functools.lru_cache(maxsize=None)
def launch_plan(B, K1, Hq, Hkv, dh, psz, ppc, pool_dtype=F32):
    """``(rows per block, row groups, warps per block)`` the CUDA kernel
    takes at a shape on the current card (it builds the kernel
    library), or None where even one query row and one warp a block do
    not fit shared memory."""
    _library()
    lib = build.load("paged_decode")
    rpb, nw = ctypes.c_int(0), ctypes.c_int(0)
    ok = lib.paged_decode_plan(B, K1, Hq, Hkv, dh, psz, ppc,
                               int(pool_dtype == torch.bfloat16),
                               ctypes.byref(rpb), ctypes.byref(nw))
    if not ok:
        return None
    nq = K1 * (Hq // Hkv)
    return rpb.value, -(-nq // rpb.value), nw.value


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_decode_cuda: {msg}")


def paged_decode_cuda(q, k_pool, v_pool, cl_page, cl_pos, qpos, *,
                      window: int = 0, cap: float = 0.0,
                      encode_wire: bool = False):
    """Launch the CUDA kernel on the current stream; same contract as
    ``paged_decode_plain``.  ``q`` must be f32; pools f32 or bf16 (both
    the same); lists and qpos int32; every tensor contiguous on one CUDA
    device.  Raises on anything else and when the launch is refused."""
    dev = q.device
    tensors = (q, k_pool, v_pool, cl_page, cl_pos, qpos)
    _require(dev.type == "cuda", f"q lies on {dev}, not a CUDA device")
    _require(all(t.device == dev for t in tensors),
             "tensors lie on different devices")
    _require(all(t.is_contiguous() for t in tensors),
             "every input must be contiguous")
    _require(q.dtype == F32, f"q must be float32, got {q.dtype}")
    _require(k_pool.dtype in (F32, torch.bfloat16)
             and v_pool.dtype == k_pool.dtype,
             f"pools must both be float32 or bfloat16, got "
             f"{k_pool.dtype}/{v_pool.dtype}")
    _require(all(t.dtype == torch.int32 for t in (cl_page, cl_pos, qpos)),
             "cl_page, cl_pos and qpos must be int32")
    _require(q.ndim == 4 and k_pool.ndim == 4
             and k_pool.shape == v_pool.shape, "bad q/pool ranks or shapes")
    B, K1, Hq, dh = q.shape
    P_loc, psz, Hkv, dh_k = k_pool.shape
    _require(dh_k == dh and Hkv > 0 and Hq % Hkv == 0,
             f"q {tuple(q.shape)} does not fit pool {tuple(k_pool.shape)}")
    _require(cl_page.ndim == 2 and cl_page.shape == cl_pos.shape
             and cl_page.shape[0] == B, "cl_page/cl_pos must be [B, ppc]")
    _require(tuple(qpos.shape) == (B, K1), "qpos must be [B, K1]")
    _require(dh % 4 == 0, f"dh={dh} must be a multiple of 4")
    ppc = cl_page.shape[1]
    _require(B == 0 or launch_plan(B, K1, Hq, Hkv, dh, psz, ppc,
                                   k_pool.dtype) is not None,
             f"K1={K1}, {Hq // Hkv} query heads a kv head, dh={dh}, pages "
             f"of {psz} and {ppc} list entries do not fit one block's "
             "shared memory even at one query row and one warp")
    lse = torch.empty((B, K1, Hq), dtype=F32, device=dev)
    if encode_wire:
        o = None
        wire = torch.empty((B, K1, Hq, dh), dtype=torch.int8, device=dev)
        scale = torch.empty((B, K1, Hq, 1), dtype=F32, device=dev)
    else:
        o = torch.empty((B, K1, Hq, dh), dtype=F32, device=dev)
        wire = scale = None
    if B == 0:
        return (wire, scale, lse) if encode_wire else (o, lse)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library()(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(cl_page), ptr(cl_pos),
        ptr(qpos), ptr(o), ptr(wire), ptr(scale), ptr(lse),
        B, K1, Hq, Hkv, dh, P_loc, psz, ppc, int(window), float(cap),
        1.0 / math.sqrt(dh), int(bool(encode_wire)),
        int(k_pool.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA "
                           f"error {err}")
    return (wire, scale, lse) if encode_wire else (o, lse)
