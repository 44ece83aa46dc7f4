"""Spike-count matmul with the rate decode fused: the plain version and
the CUDA launch.

Replaces the TPU kernel ``count_matmul_pallas`` (body
``_count_matmul_kernel``) of ``src/repro/kernels/count_matmul.py``, the
receiving die's first matmul with the decode of paper eq 3 folded in:

    y[m, n] = sum_k  c[m, k] * (scale[k] * f32(1/T)) * W[k, n]

for int8 counts ``c [M, K]``, ``W [K, N]`` in float32 or bfloat16 and a
per-channel decode scale ``[K]`` taken as float32; the sum runs in
float32 and is rounded once to ``out_dtype``.  As the TPU kernel, the
decode multiplies by ``f32(1/T)`` rather than dividing by T (the JAX
oracle ``ref.count_matmul_ref`` divides; the two differ in the last
place).

The CUDA kernel (``csrc/count_matmul.cu``) takes one of three designs
by shape.  At a decode batch of up to 16 rows it streams W, bound by
W's bytes: a cluster of blocks splits K, each thread keeps every row's
sums for its columns, and the partials are summed in a fixed order
through the cluster's shared memory.  At more rows with bf16 W it runs
on the tensor cores: the decoded float32 activations split exactly
into three bf16 planes, whose products with bf16 W are exact in
float32.  With float32 W and more rows, float32 FMAs through
shared-memory tiles.  Ragged shapes are bounds-checked inside it, and
no design uses atomics: two launches give the same bits.

``ops.count_matmul`` is the wrapper callers use: CPU tensors take
``count_matmul_plain``, CUDA tensors ``count_matmul_cuda``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

F32 = torch.float32
BF16 = torch.bfloat16


def inv_T(T: int) -> float:
    """``f32(1/T)``, the TPU kernel's decode factor, as a Python float
    (exactly representable in float32, so a float32 op takes it
    unchanged)."""
    return torch.tensor(1.0 / T, dtype=F32).item()


def count_matmul_plain(counts, w, scale, *, T: int = 15, out_dtype=BF16):
    """int8 counts [M, K] x w [K, N] -> [M, N] ``out_dtype``."""
    s = scale.to(F32) * inv_T(T)
    return ((counts.to(F32) * s) @ w.to(F32)).to(out_dtype)


def _library():
    fn = build.load("count_matmul").count_matmul_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"count_matmul_cuda: {msg}")


def count_matmul_cuda(counts, w, scale, *, T: int = 15, out_dtype=BF16):
    """Launch the CUDA kernel on the current stream; same contract as
    ``count_matmul_plain``.  ``counts`` int8 [M, K], ``w`` f32 or bf16
    [K, N], ``scale`` f32 [K], all contiguous on one CUDA device, with
    M, K, N > 0; ``out_dtype`` f32 or bf16.  Raises on anything else and
    when the launch is refused."""
    dev = counts.device
    _require(dev.type == "cuda", f"counts lie on {dev}, not a CUDA device")
    _require(w.device == dev and scale.device == dev,
             "tensors lie on different devices")
    _require(counts.dtype == torch.int8,
             f"counts must be int8, got {counts.dtype}")
    _require(w.dtype in (F32, BF16),
             f"w must be float32 or bfloat16, got {w.dtype}")
    _require(scale.dtype == F32, f"scale must be float32, got {scale.dtype}")
    _require(out_dtype in (F32, BF16),
             f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    _require(counts.ndim == 2 and w.ndim == 2 and counts.numel() > 0
             and w.numel() > 0, f"counts [M, K] and w [K, N] must be "
             f"non-empty, got {tuple(counts.shape)} and {tuple(w.shape)}")
    M, K = counts.shape
    _require(w.shape[0] == K and tuple(scale.shape) == (K,),
             f"w must be [{K}, N] and scale [{K}], got {tuple(w.shape)} "
             f"and {tuple(scale.shape)}")
    N = w.shape[1]
    _require(all(t.is_contiguous() for t in (counts, w, scale)),
             "every input must be contiguous")
    _require(T >= 1, f"T={T} must be positive")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    err = _library()(
        counts.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, inv_T(T), int(w.dtype == BF16),
        int(out_dtype == BF16), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"count_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return out
