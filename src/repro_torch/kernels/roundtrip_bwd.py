"""Backward of a spike-coded boundary: the plain version and the CUDA launch.

The VJP of one boundary's encode -> wire -> decode roundtrip for the
signed rate code, ``spike.roundtrip_vjp`` of the reference
(``src/repro/core/spike.py``), which the reference's coded collectives
run in their custom backward (``_roundtrip_bwd``).  It is jnp there, not
a TPU kernel; the port gives it a CUDA kernel of its own
(``csrc/roundtrip_bwd.cu``) because every coded boundary of a training
step runs it.

For ``x``, ``g`` ``[M, C]`` (float32 or bfloat16) and per-channel
``theta``, the scale ``s = exp(log_scale)`` and ``s / T`` (``[C]``
float32, computed by the caller in PyTorch), in float32:

    mag = |x|; sgn = sign(x); in = 1[0 < mag < s]; gate = 1[mag >= theta]
    c = round(clip(mag / s, 0, 1) * T); ymag = c * (s / T)
    surr = 10 * (1 / (1 + 10 * |mag - theta|)^2)
    dx  = g * (gate * in + ymag * surr)                  -> [M, C], x's dtype
    dth = sum over rows of -g * sgn * ymag * surr        -> [C] float32
    dls = sum over rows of g * sgn * gate * (-mag * in + ymag)

The fast-sigmoid surrogate is written as PyTorch's ``10 / t`` computes
it (``Tensor.__rtruediv__``: a reciprocal, then a product), and each
op of the plain version rounds once, so the kernel's ``dx`` is the
plain version's bit for bit.  The two sums are in a fixed order on the
card: per channel, one partial per warp over its rows in order, then
the warps' partials in order; no atomics.

``ops.roundtrip_bwd`` is the wrapper callers use: CPU tensors take
``roundtrip_bwd_plain``, CUDA tensors ``roundtrip_bwd_cuda``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

F32 = torch.float32
BF16 = torch.bfloat16
#: the surrogate's beta (the reference's ``surr_beta``)
BETA = 10.0


def roundtrip_bwd_plain(x, g, theta, s, s_over_T, *, T: int):
    """x, g [M, C]; theta, s, s_over_T [C] float32 -> (dx [M, C] in x's
    dtype, dtheta [C] float32, dlog_scale [C] float32)."""
    dx, dth, dls = roundtrip_bwd_terms(x, g, theta, s, s_over_T, T=T)
    return dx, torch.sum(dth, dim=0), torch.sum(dls, dim=0)


def roundtrip_bwd_terms(x, g, theta, s, s_over_T, *, T: int):
    """``roundtrip_bwd_plain`` before the sums over rows: (dx, and the
    [M, C] float32 terms of dtheta and dlog_scale)."""
    xf = x.to(F32)
    gf = g.to(F32)
    mag = torch.abs(xf)
    sgn = torch.sign(xf)
    in_rng = ((mag > 0) & (mag < s)).to(F32)
    gate = (mag >= theta).to(F32)
    c_mag = torch.round(torch.clamp(mag / s, 0.0, 1.0) * float(T))
    ymag = c_mag * s_over_T
    v = mag - theta
    q = 1.0 + BETA * torch.abs(v)
    surr = torch.reciprocal(q * q) * BETA
    dx = gf * (gate * in_rng + ymag * surr)
    dth = -gf * sgn * ymag * surr
    dls = gf * sgn * gate * (-mag * in_rng + ymag)
    return dx.to(x.dtype), dth, dls


def _library():
    fn = build.load("roundtrip_bwd").roundtrip_bwd_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [P, P, P, P, P, P, P, P, L, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"roundtrip_bwd_cuda: {msg}")


def roundtrip_bwd_cuda(x, g, theta, s, s_over_T, *, T: int):
    """Launch the CUDA kernel on the current stream; same contract as
    ``roundtrip_bwd_plain``.  ``x`` and ``g`` of one dtype (float32 or
    bfloat16), non-empty ``[M, C]``; ``theta``, ``s``, ``s_over_T``
    float32 ``[C]``; all contiguous on one CUDA device.  Raises on
    anything else and when the launch is refused."""
    dev = x.device
    params = [theta, s, s_over_T]
    _require(dev.type == "cuda", f"x lies on {dev}, not a CUDA device")
    _require(all(t.device == dev for t in [g] + params),
             "tensors lie on different devices")
    _require(x.dtype in (F32, BF16) and g.dtype == x.dtype,
             f"x and g must both be float32 or bfloat16, got {x.dtype} "
             f"and {g.dtype}")
    _require(all(t.dtype == F32 for t in params),
             f"theta, s and s_over_T must be float32, got "
             f"{[t.dtype for t in params]}")
    _require(x.ndim == 2 and x.numel() > 0 and g.shape == x.shape,
             f"x and g must be one non-empty [M, C], got "
             f"{tuple(x.shape)} and {tuple(g.shape)}")
    M, C = x.shape
    _require(all(tuple(t.shape) == (C,) for t in params),
             f"theta, s and s_over_T must be [{C}]")
    _require(all(t.is_contiguous() for t in [x, g] + params),
             "every input must be contiguous")
    _require(1 <= T <= 127, f"T={T} must fit the int8 count")
    dx = torch.empty_like(x)
    dth = torch.empty(C, dtype=F32, device=dev)
    dls = torch.empty(C, dtype=F32, device=dev)
    err = _library()(
        x.data_ptr(), g.data_ptr(), theta.data_ptr(), s.data_ptr(),
        s_over_T.data_ptr(), dx.data_ptr(), dth.data_ptr(), dls.data_ptr(),
        M, C, int(T), int(x.dtype == BF16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roundtrip_bwd kernel launch failed: CUDA "
                           f"error {err}")
    return dx, dth, dls
