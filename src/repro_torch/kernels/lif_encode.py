"""T-tick IF spike encoder: the plain version and the CUDA launch.

Replaces the TPU kernel ``lif_encode_pallas`` (body
``_lif_encode_kernel``) of ``src/repro/kernels/lif_encode.py``; the
plain version is the port of its oracle ``ref.lif_encode_ref``, with
one difference taken from the JAX ``spike`` codec that serving runs.

For ``x [M, C]`` and per-channel ``theta``, ``scale [C]``, in float32:
on and off integrate-and-fire populations start their membranes at 0.5
and add ``clip(x/scale, 0, 1)`` and ``clip(-x/scale, 0, 1)`` each of T
ticks, firing at >= 1 with subtract reset; the int8 output is the count
difference in {-T..T}, gated to 0 where ``|x/scale| < theta/scale``.
The oracle gates on raw values (``|x| >= theta``); the JAX faithful
codec (``spike.encode`` with ``SpikeConfig(faithful=True)``) gates on
normalised ones, and the two differ only where ``fl(|x|/s) ==
fl(theta/s)`` while ``|x| < theta``.  The port follows the codec, so
the served counts are the JAX package's bit for bit.

Two compute types.  In float32 (the default) the kernel computes as
the TPU kernel does.  In bfloat16 (``math_dtype=torch.bfloat16``) it
computes as the JAX codec does on a bf16 activation, where every op of
the encoder is rounded to bf16: x, theta and scale are rounded to bf16,
then ``x/s``, ``theta/s``, the gate's ``|x/s| - theta/s``, each tick's
``u + d`` and ``u - 1`` and the reset are each rounded to bf16 — which
is what PyTorch's bf16 ops compute, so the plain version runs the same
code on bf16 tensors.

With ``decode_scale`` [C] — the decode's ``exp(log_scale) / T`` as
``spike.decode`` computes it in x's dtype — each version also returns
``decoded = counts * decode_scale`` in x's dtype: the single multiply
of ``rate_decode_signed``, so a served wire roundtrip runs as one
launch and its decoded values are the codec's bit for bit.

The CUDA kernel (``csrc/lif_encode.cu``) gives each thread two
channels of one row, loads everything before any arithmetic, and keeps
both tick chains in registers (in bf16 as one packed pair).  At most
one population of an element can fire (the other's drive is 0, and a
membrane of 0.5 never reaches 1), so the kernel integrates only
``clip(|x/s|, 0, 1)``, with a drive of 0 where the gate is closed, and
signs the count.  What bounds it on the card is the launch at decode
rows and, at prefill rows, the read of x and the tick arithmetic.

``ops.lif_encode`` is the wrapper callers use: CPU tensors take
``lif_encode_plain``, CUDA tensors ``lif_encode_cuda``.

The backward (training): ``ops.lif_encode_bwd`` gives the surrogate
gradient of the faithful encoder with respect to its pre-normalised
input ``xn = x / scale`` and threshold ``thn = theta / scale``, element
by element — ``lif_encode_bwd_plain``, PyTorch's autograd through the
tick loop ``if_count`` with the fast-sigmoid spike, on CPU tensors, and
``lif_encode_bwd_cuda`` (the second entry of ``csrc/lif_encode.cu``,
float32, T <= 16) on CUDA tensors.  The sum over rows and the division
by the scale stay in PyTorch around it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

F32 = torch.float32
BF16 = torch.bfloat16


def heaviside(v):
    return (v >= 0.0).to(v.dtype)


def if_count(drive, T: int, step=heaviside):
    """One integrate-and-fire population: from a membrane of 0.5, add
    ``drive`` each of T ticks and fire where ``step(u - 1)`` is 1, with
    subtract reset.  Returns the float spike counts in {0..T}.  The
    faithful codec's autograd path passes the surrogate-gradient spike
    as ``step``; the plain version takes the Heaviside."""
    u = torch.full_like(drive, 0.5)
    count = torch.zeros_like(drive)
    for _ in range(T):
        u = u + drive
        s = step(u - 1.0)
        u = u - s
        count = count + s
    return count


def lif_encode_plain(x, theta, scale, *, T: int = 15, math_dtype=F32,
                     decode_scale=None):
    """x [M, C] float -> int8 signed counts [M, C]; theta, scale [C];
    every op computed in ``math_dtype`` (float32 or bfloat16).  With
    ``decode_scale`` [C], returns ``(counts, counts * decode_scale)``,
    the product in x's dtype."""
    if math_dtype not in (F32, BF16):
        raise ValueError(f"lif_encode: math_dtype must be float32 or "
                         f"bfloat16, got {math_dtype}")
    s = scale.to(math_dtype)
    xn = x.to(math_dtype) / s
    gate = (torch.abs(xn) - theta.to(math_dtype) / s) >= 0.0
    c = (if_count(torch.clamp(xn, 0.0, 1.0), T)
         - if_count(torch.clamp(-xn, 0.0, 1.0), T))
    counts = torch.where(gate, c, torch.zeros_like(c)).to(torch.int8)
    if decode_scale is None:
        return counts
    return counts, counts.to(x.dtype) * decode_scale.to(x.dtype)


def _library():
    fn = build.load("lif_encode").lif_encode_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [P, P, P, P, P, P, L, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"lif_encode_cuda: {msg}")


def lif_encode_cuda(x, theta, scale, *, T: int = 15, math_dtype=F32,
                    decode_scale=None):
    """Launch the CUDA kernel on the current stream; same contract as
    ``lif_encode_plain``.  ``x`` f32 or bf16 [M, C] with M*C > 0;
    ``theta``, ``scale`` and ``decode_scale`` (or None) f32 [C]; all
    contiguous on one CUDA device; ``math_dtype`` f32 or bf16.  Raises
    on anything else and when the launch is refused."""
    dev = x.device
    params = [theta, scale] + ([] if decode_scale is None
                               else [decode_scale])
    _require(math_dtype in (F32, BF16), f"math_dtype must be float32 or "
             f"bfloat16, got {math_dtype}")
    _require(dev.type == "cuda", f"x lies on {dev}, not a CUDA device")
    _require(all(t.device == dev for t in params),
             "tensors lie on different devices")
    _require(x.dtype in (F32, BF16),
             f"x must be float32 or bfloat16, got {x.dtype}")
    _require(all(t.dtype == F32 for t in params),
             f"theta, scale and decode_scale must be float32, got "
             f"{[t.dtype for t in params]}")
    _require(x.ndim == 2 and x.numel() > 0, f"x must be a non-empty "
             f"[M, C], got {tuple(x.shape)}")
    M, C = x.shape
    _require(all(tuple(t.shape) == (C,) for t in params),
             f"theta, scale and decode_scale must be [{C}]")
    _require(all(t.is_contiguous() for t in [x] + params),
             "every input must be contiguous")
    _require(1 <= T <= 127, f"T={T} must fit the int8 count")
    out = torch.empty((M, C), dtype=torch.int8, device=dev)
    dec = None if decode_scale is None else torch.empty_like(x)
    err = _library()(
        x.data_ptr(), theta.data_ptr(), scale.data_ptr(),
        None if dec is None else decode_scale.data_ptr(), out.data_ptr(),
        None if dec is None else dec.data_ptr(), M, C, int(T),
        int(x.dtype == BF16), int(math_dtype == BF16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lif_encode kernel launch failed: CUDA error "
                           f"{err}")
    return out if dec is None else (out, dec)


#: the most ticks the backward kernel keeps in registers
BWD_MAX_T = 16


def lif_encode_bwd_plain(xn, thn, g, *, T: int = 15):
    """The VJP of ``spike.lif_rate_encode_signed(xn, thn, T)`` for the
    cotangent ``g``: xn, g [M, C], thn [C] -> (dxn [M, C], dthn [M, C],
    the threshold's gradient per element), by PyTorch's autograd through
    the surrogate-gradient tick loop, in xn's dtype."""
    from ..core import spike          # the surrogate spike lives there
    M, C = xn.shape
    with torch.enable_grad():
        x = xn.detach().requires_grad_()
        th = thn.detach().expand(M, C).clone().requires_grad_()
        out = spike.lif_rate_encode_signed(x, th, T)
        dx, dth = torch.autograd.grad(out, (x, th), g)
    return dx, dth


def _bwd_library():
    fn = build.load("lif_encode").lif_encode_bwd_launch
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [P, P, P, P, P, L, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def lif_encode_bwd_cuda(xn, thn, g, *, T: int = 15):
    """Launch the backward kernel on the current stream; same contract as
    ``lif_encode_bwd_plain``.  ``xn`` and ``g`` float32 non-empty
    [M, C], ``thn`` float32 [C], contiguous on one CUDA device,
    1 <= T <= ``BWD_MAX_T``.  Raises on anything else and when the
    launch is refused."""
    dev = xn.device
    _require(dev.type == "cuda", f"xn lies on {dev}, not a CUDA device")
    _require(thn.device == dev and g.device == dev,
             "tensors lie on different devices")
    _require(all(t.dtype == F32 for t in (xn, thn, g)),
             f"the backward computes in float32, got "
             f"{[t.dtype for t in (xn, thn, g)]}")
    _require(xn.ndim == 2 and xn.numel() > 0 and g.shape == xn.shape,
             f"xn and g must be one non-empty [M, C], got "
             f"{tuple(xn.shape)} and {tuple(g.shape)}")
    M, C = xn.shape
    _require(tuple(thn.shape) == (C,), f"thn must be [{C}]")
    _require(all(t.is_contiguous() for t in (xn, thn, g)),
             "every input must be contiguous")
    _require(1 <= T <= BWD_MAX_T, f"T={T}: the backward keeps at most "
             f"{BWD_MAX_T} ticks")
    dx = torch.empty_like(xn)
    dth = torch.empty_like(xn)
    err = _bwd_library()(xn.data_ptr(), thn.data_ptr(), g.data_ptr(),
                         dx.data_ptr(), dth.data_ptr(), M, C, int(T),
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lif_encode backward launch failed: CUDA "
                           f"error {err}")
    return dx, dth
