"""4-bit two-per-byte wire packing: the plain versions and the CUDA
launches.

Replace the TPU kernels ``pack4_pallas`` and ``unpack4_pallas`` of
``src/repro/kernels/pack4.py``; the plain versions are the ports of
their oracles ``ref.pack4_ref`` / ``ref.unpack4_ref``.  Pack takes uint8
``[M, C]`` (C even) to ``[M, C/2]`` with ``out[k] = v[2k] | v[2k+1] <<
4``; unpack is its inverse on values below 16.  For a spike count in
{-7..7} biased by T=7 the wire halves again (``spike_pack4``).
``pack4_counts`` is the pack with the wire's bias fused in: signed
counts (float32 or bfloat16) to the packed bytes of
``(counts + T).to(torch.uint8)``, what ``spike_pack4`` sends.
``unpack4_decode`` is the unpack with the wire's unbias and the rate
decode fused in: packed bytes to ``(unpack4(p).to(dtype) - T) *
decode_scale`` in float32 or bfloat16, what ``spike_pack4`` receives.

The CUDA kernels (``csrc/pack4.cu``) walk the flat bytes: a thread of
a pack makes one 16-byte load (16 wire bytes, 4 f32 or 8 bf16 counts)
and writes half as many bytes as values; a thread of an unpack loads
one word of packed bytes (8, or 4 for the decode) and stores the 16
bytes of its nibbles, or their 8 decoded values.  What bounds them on
the card is memory and, at decode rows, the launch: each byte read once
and written once.

``ops.pack4`` / ``ops.pack4_counts`` / ``ops.unpack4`` /
``ops.unpack4_decode`` are the wrappers callers use: CPU tensors take
the plain versions, CUDA tensors the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

U8 = torch.uint8


def pack4_plain(wire):
    """uint8 [M, C] (C even) -> uint8 [M, C/2]."""
    if wire.shape[-1] % 2:
        raise ValueError(f"pack4: last axis {wire.shape[-1]} is odd")
    return wire[..., 0::2] | (wire[..., 1::2] << 4)


def pack4_counts_plain(counts, T: int):
    """Signed counts [M, C] (C even) -> uint8 [M, C/2], the packed bytes
    of ``(counts + T).to(torch.uint8)``."""
    return pack4_plain((counts + T).to(U8))


def unpack4_plain(packed):
    """uint8 [M, C2] -> uint8 [M, 2*C2]."""
    out = torch.stack([packed & 0xF, (packed >> 4) & 0xF], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def unpack4_decode_plain(packed, T: int, decode_scale):
    """uint8 [M, C2] -> [M, 2*C2] in ``decode_scale``'s dtype (float32
    or bfloat16): ``(unpack4(packed).to(dtype) - T) * decode_scale``,
    the codec's ``wire_u8_to_counts`` then ``rate_decode_signed`` with
    ``decode_scale = exp(log_scale).to(dtype) / T`` [2*C2]."""
    return (unpack4_plain(packed).to(decode_scale.dtype) - T) * decode_scale


_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_ARGTYPES = {"pack4_launch": [_P, _P, _L, _P],
             "pack4_counts_launch": [_P, _P, _L, _I, _I, _P],
             "unpack4_launch": [_P, _P, _L, _P],
             "unpack4_decode_launch": [_P, _P, _L, _P, _I, _I, _I, _P]}


def _library(name):
    fn = getattr(build.load("pack4"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _require(fn_name, cond, msg):
    if not cond:
        raise ValueError(f"{fn_name}: {msg}")


def _check_input(fn_name, t, dtypes=(U8,)):
    _require(fn_name, t.device.type == "cuda",
             f"input lies on {t.device}, not a CUDA device")
    _require(fn_name, t.dtype in dtypes,
             f"input must be {' or '.join(map(str, dtypes))}, got "
             f"{t.dtype}")
    _require(fn_name, t.ndim == 2 and t.numel() > 0,
             f"input must be a non-empty [M, C], got {tuple(t.shape)}")
    _require(fn_name, t.is_contiguous(), "input must be contiguous")


def _launch(name, src, out, n, *extra):
    err = _library(name)(src.data_ptr(), out.data_ptr(), n, *extra,
                         torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        kernel = name.replace("_launch", "")
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def pack4_cuda(wire):
    """Launch the pack kernel on the current stream; same contract as
    ``pack4_plain``.  Raises unless ``wire`` is a contiguous non-empty
    uint8 [M, C] with C even on a CUDA device, and when the launch is
    refused."""
    _check_input("pack4_cuda", wire)
    M, C = wire.shape
    _require("pack4_cuda", C % 2 == 0, f"last axis {C} is odd")
    out = torch.empty((M, C // 2), dtype=U8, device=wire.device)
    return _launch("pack4_launch", wire, out, out.numel())


def pack4_counts_cuda(counts, T: int):
    """Launch the fused pack kernel on the current stream; same contract
    as ``pack4_counts_plain``.  Raises unless ``counts`` is a contiguous
    non-empty float32 or bfloat16 [M, C] with C even on a CUDA device,
    and when the launch is refused."""
    _check_input("pack4_counts_cuda", counts, (torch.float32,
                                               torch.bfloat16))
    M, C = counts.shape
    _require("pack4_counts_cuda", C % 2 == 0, f"last axis {C} is odd")
    out = torch.empty((M, C // 2), dtype=U8, device=counts.device)
    return _launch("pack4_counts_launch", counts, out, out.numel(), int(T),
                   int(counts.dtype == torch.bfloat16))


def unpack4_cuda(packed):
    """Launch the unpack kernel on the current stream; same contract as
    ``unpack4_plain``.  Raises unless ``packed`` is a contiguous
    non-empty uint8 [M, C2] on a CUDA device, and when the launch is
    refused."""
    _check_input("unpack4_cuda", packed)
    M, C2 = packed.shape
    out = torch.empty((M, 2 * C2), dtype=U8, device=packed.device)
    return _launch("unpack4_launch", packed, out, packed.numel())


def unpack4_decode_cuda(packed, T: int, decode_scale):
    """Launch the fused unpack-and-decode kernel on the current stream;
    same contract as ``unpack4_decode_plain``.  Raises unless ``packed``
    is a contiguous non-empty uint8 [M, C2] on a CUDA device,
    ``decode_scale`` a contiguous float32 or bfloat16 [2*C2] on the same
    device and 1 <= T <= 127, and when the launch is refused."""
    name = "unpack4_decode_cuda"
    _check_input(name, packed)
    M, C2 = packed.shape
    _require(name, decode_scale.device == packed.device,
             f"decode_scale lies on {decode_scale.device}, not "
             f"{packed.device}")
    _require(name, decode_scale.dtype in (torch.float32, torch.bfloat16),
             f"decode_scale must be float32 or bfloat16, got "
             f"{decode_scale.dtype}")
    _require(name, tuple(decode_scale.shape) == (2 * C2,),
             f"decode_scale must be [{2 * C2}], got "
             f"{tuple(decode_scale.shape)}")
    _require(name, decode_scale.is_contiguous(),
             "decode_scale must be contiguous")
    _require(name, 1 <= T <= 127, f"T={T} must fit the uint8 wire's bias")
    out = torch.empty((M, 2 * C2), dtype=decode_scale.dtype,
                      device=packed.device)
    return _launch("unpack4_decode_launch", packed, out, packed.numel(),
                   decode_scale.data_ptr(), 2 * C2, int(T),
                   int(decode_scale.dtype == torch.bfloat16))
