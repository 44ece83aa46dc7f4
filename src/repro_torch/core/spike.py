"""Spike-based encoding core (paper §3.5, eqs 1-3, 10) in PyTorch.

The port of ``repro.core.spike`` for the closed-form ("fused") signed
rate code the serving path uses at every coded boundary:

* ``spike_step`` — Heaviside with the fast-sigmoid surrogate gradient,
* ``round_ste`` — round half to even with a straight-through gradient,
* ``rate_encode_signed`` / ``rate_decode_signed`` — activation -> signed
  spike count in {-T..T} and back,
* ``encode`` / ``decode`` over one boundary's learnable params.

Rounding is ``torch.round`` (half to even), exactly as ``jnp.round``,
so the counts on the wire equal the reference's bit for bit.  The
faithful T-tick IF encoder (``SpikeConfig.faithful``) is not ported in
this slice and raises.
"""
from __future__ import annotations

import dataclasses

import torch

# ---------------------------------------------------------------------------
# Surrogate gradients
# ---------------------------------------------------------------------------


class _SpikeStep(torch.autograd.Function):
    """Heaviside H(v) with fast-sigmoid surrogate gradient
    ``beta / (1 + beta*|v|)^2`` (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, v, beta):
        ctx.save_for_backward(v)
        ctx.beta = beta
        return (v >= 0.0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        beta = ctx.beta
        surr = beta / torch.square(1.0 + beta * torch.abs(v))
        return g * surr.to(g.dtype), None


def spike_step(v: torch.Tensor, beta: float = 10.0) -> torch.Tensor:
    return _SpikeStep.apply(v, beta)


class _RoundSTE(torch.autograd.Function):
    """Round half to even with a straight-through gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    return _RoundSTE.apply(x)


# ---------------------------------------------------------------------------
# Signed deterministic rate code (eqs 2, 3)
# ---------------------------------------------------------------------------


def rate_encode_signed(x, scale, theta, T: int):
    """Signed symmetric rate code: counts in {-T..T} (float)."""
    mag = torch.abs(x)
    gate = spike_step(mag - theta, 10.0)
    c = round_ste(torch.clamp(mag / scale, 0.0, 1.0) * T) * gate
    return torch.sign(x) * c


def rate_decode_signed(counts, scale, T: int):
    return counts.to(scale.dtype) * (scale / T)


# ---------------------------------------------------------------------------
# Boundary parameter container + init
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpikeConfig:
    """Static config for one spike boundary."""

    T: int = 15                # ticks; 15 -> signed counts fit 5 bits
    faithful: bool = False     # True: T-tick IF train (not ported yet)


def init_spike_params(dim: int, *, device, dtype=torch.float32) -> dict:
    """Learnable per-channel threshold + scale for one boundary."""
    return {
        "theta": torch.full((dim,), 0.01, dtype=dtype, device=device),
        "log_scale": torch.zeros((dim,), dtype=dtype, device=device),
    }


def encode(x, params: dict, cfg: SpikeConfig):
    """Activation -> signed float counts in {-T..T}. Differentiable."""
    if cfg.faithful:
        raise NotImplementedError(
            "faithful T-tick IF boundary encoder: not ported yet")
    scale = torch.exp(params["log_scale"]).to(x.dtype)
    theta = params["theta"].to(x.dtype)
    return rate_encode_signed(x, scale, theta, cfg.T)


def decode(counts, params: dict, cfg: SpikeConfig, dtype=torch.bfloat16):
    scale = torch.exp(params["log_scale"]).to(dtype)
    return rate_decode_signed(counts, scale, cfg.T).to(dtype)
