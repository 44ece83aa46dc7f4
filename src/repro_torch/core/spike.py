"""Spike-based encoding core (paper §3.5, eqs 1-3, 10) in PyTorch.

The port of ``repro.core.spike`` for the encoders the coded boundaries
run:

* ``spike_step`` — Heaviside with the fast-sigmoid surrogate gradient,
* ``round_ste`` — round half to even with a straight-through gradient,
* ``abs_`` and ``clip01`` — ``|x|`` and ``clip(x, 0, 1)`` with JAX's
  derivatives at their kinks, so the encoders' gradients are the
  reference's,
* ``rate_encode_signed`` / ``rate_decode_signed`` — the closed-form
  ("fused") signed rate code: activation -> spike count in {-T..T} and
  back,
* ``if_rate_encode`` / ``lif_rate_encode_signed`` — the paper-faithful
  T-tick integrate-and-fire encoder (on/off populations), with the
  surrogate gradient inside the tick loop,
* the wire's 4-bit two-per-byte packing: ``pack4_counts`` (the counts
  biased by T and packed, as the reference's
  ``pack4(counts_to_wire_u8(counts, T))``), ``unpack4`` and
  ``wire_u8_to_counts``,
* the eq-10 sparsity penalty ``sparsity_loss`` and the statistics
  ``firing_rate`` and ``occupancy``,
* ``roundtrip_vjp``, the hand-derived backward of a boundary's encode
  -> decode roundtrip that the coded collectives run (the
  ``roundtrip_bwd`` kernel on CUDA tensors),
* ``encode`` / ``decode`` over one boundary's learnable params,
  ``encode_decode``, both in one ``lif_encode`` launch where it can, and
  ``unpack4_decode``, the packed wire's unpack, unbias and decode in one
  ``unpack4`` launch where it can.

Rounding is ``torch.round`` (half to even), exactly as ``jnp.round``,
so the counts on the wire equal the reference's bit for bit.  The IF
encoder is not the closed form: at a drive within rounding of a
half-integer tick count the two can differ by one, and ``encode`` with
``SpikeConfig(faithful=True)`` follows the IF encoder, as the reference
does.  Without gradients (serving) that branch runs the ``lif_encode``
kernel through ``kernels.ops``, ``pack4_counts`` biases and packs the
counts in one launch of the ``pack4`` kernel, and ``unpack4`` runs its
own; on CPU tensors each runs its kernel's plain version.  A served wire
roundtrip (``encode_decode``) takes the decode from the ``lif_encode``
launch's epilogue, and a served packed exchange (``unpack4_decode``)
its unbias and decode from the ``unpack4`` launch.

Training: ``encode`` with the faithful encoder and a gradient wanted
runs PyTorch's autograd through the tick loop on CPU tensors, and on
CUDA tensors (float32) an autograd Function whose forward is the
``lif_encode`` kernel and whose backward is its surrogate-gradient
kernel (``ops.lif_encode_bwd``), on ``x / scale`` and ``theta / scale``
as the reference divides them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops as kops
from ..kernels.lif_encode import if_count

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


class _Abs(torch.autograd.Function):
    """``|x|`` with JAX's derivative: +1 at 0 (``jnp.abs``'s rule), where
    PyTorch's is 0.  The penalty differentiates ``|counts|``, and most
    counts are 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x: torch.Tensor) -> torch.Tensor:
    return _Abs.apply(x) if needs_grad(x) else torch.abs(x)


class _Clip01(torch.autograd.Function):
    """``clip(x, 0, 1)`` with JAX's derivative: 1 inside, 1/2 at either
    end (``jnp.clip``'s max/min ties), 0 outside; PyTorch's clamp passes
    1 at the ends."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = ((x > 0) & (x < 1)).to(g.dtype)
        ends = ((x == 0) | (x == 1)).to(g.dtype)
        return g * (inside + 0.5 * ends)


def clip01(x: torch.Tensor) -> torch.Tensor:
    return _Clip01.apply(x) if needs_grad(x) else torch.clamp(x, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Signed deterministic rate code (eqs 2, 3)
# ---------------------------------------------------------------------------


def rate_encode_signed(x, scale, theta, T: int):
    """Signed symmetric rate code: counts in {-T..T} (float)."""
    mag = abs_(x)
    gate = spike_step(mag - theta, 10.0)
    c = round_ste(clip01(mag / scale) * T) * gate
    return torch.sign(x) * c


def rate_decode_signed(counts, scale, T: int):
    return counts.to(scale.dtype) * (scale / T)


def if_rate_encode(drive, T: int):
    """Paper-faithful CLP rate coder (Fig 4a): an integrate-and-fire
    accumulator from a membrane of 0.5 adds ``drive`` in [0, 1] each of
    T ticks and fires at >= 1 with subtract reset.  Returns float counts
    in {0..T}; the spike is ``spike_step``, so surrogate gradients
    flow.  The tick loop is the ``lif_encode`` kernel's plain one."""
    return if_count(drive, T, step=spike_step)


def lif_rate_encode_signed(x, theta, T: int):
    """Paper-faithful signed encoder: two IF populations (on/off cells)
    fed by the positive and the negative part of the pre-normalised
    drive ``x`` (= activation / scale); the count difference is gated
    to 0 below the learnable threshold ``theta`` (normalised too)."""
    gate = spike_step(abs_(x) - theta, 10.0)
    c_pos = if_rate_encode(clip01(x), T)
    c_neg = if_rate_encode(clip01(-x), T)
    return (c_pos - c_neg) * gate


class _LIFEncode(torch.autograd.Function):
    """``lif_rate_encode_signed(xn, thn, T)`` on the card: the counts of
    the ``lif_encode`` kernel (scale 1: ``xn`` and ``thn`` come
    normalised) and, backward, the surrogate gradient of its
    ``ops.lif_encode_bwd`` kernel; the threshold's per-element gradient
    is summed over the rows here."""

    @staticmethod
    def forward(ctx, xn, thn, T):
        C = xn.shape[-1]
        ones = torch.ones(C, dtype=torch.float32, device=xn.device)
        counts = kops.lif_encode(xn.reshape(-1, C), thn, ones, T=T)
        ctx.save_for_backward(xn, thn)
        ctx.T = T
        return counts.reshape(xn.shape).to(xn.dtype)

    @staticmethod
    def backward(ctx, g):
        xn, thn = ctx.saved_tensors
        C = xn.shape[-1]
        dx, dth = kops.lif_encode_bwd(xn.reshape(-1, C), thn,
                                      g.reshape(-1, C), T=ctx.T)
        return dx.reshape(xn.shape), torch.sum(dth, dim=0), None


# ---------------------------------------------------------------------------
# Sparsity regularizer (eq 10)
# ---------------------------------------------------------------------------


def sparsity_loss(counts, T: int, target_rate: float, lam: float):
    """L_sparse = lam * hinge(mean firing rate - target), the firing rate
    ``mean(|counts|) / T``: the penalty acts only above the target."""
    rate = torch.mean(abs_(counts)) / T
    return lam * torch.clamp(rate - target_rate, min=0.0)


def firing_rate(counts, T: int):
    """Mean firing rate in [0, 1] (fraction of possible spikes emitted)."""
    return torch.mean(abs_(counts)) / T


def occupancy(counts):
    """Fraction of channels that fired at all (1 - sparsity)."""
    return torch.mean((torch.abs(counts) > 0).to(torch.float32))


# ---------------------------------------------------------------------------
# Wire packing: counts {-T..T} -> uint8 (bias T) and 4-bit two-per-byte
# ---------------------------------------------------------------------------


def wire_u8_to_counts(wire, T: int, dtype=torch.float32):
    return wire.to(dtype) - T


def pack4_counts(counts, T: int):
    """Signed counts (float32 or bfloat16) biased to uint8,
    ``(counts + T).to(uint8)`` (needs 2T+1 <= 256), and packed two per
    byte along the last axis (even): ``out[..., k] = v[2k] | v[2k+1] <<
    4``.  One launch of the ``pack4`` kernel on a CUDA tensor."""
    C = counts.shape[-1]
    out = kops.pack4_counts(counts.reshape(-1, C), T)
    return out.reshape(*counts.shape[:-1], C // 2)


def unpack4(packed):
    """Unpack two 4-bit values a byte along the last axis, the inverse
    of the pack in ``pack4_counts`` (giving the biased uint8 wire); runs
    the ``unpack4`` kernel on a CUDA tensor."""
    C2 = packed.shape[-1]
    out = kops.unpack4(packed.reshape(-1, C2))
    return out.reshape(*packed.shape[:-1], 2 * C2)


# ---------------------------------------------------------------------------
# Boundary parameter container + init
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpikeConfig:
    """Static config for one spike boundary."""

    T: int = 15                # ticks; 15 -> signed counts fit 5 bits
    target_rate: float = 0.10  # paper: 90% sparsity
    lam: float = 1e-3          # weight of the eq-10 penalty
    faithful: bool = False     # True: T-tick IF encoder; False: closed form


def init_spike_params(dim: int, *, device, dtype=torch.float32) -> dict:
    """Learnable per-channel threshold + scale for one boundary."""
    return {
        "theta": torch.full((dim,), 0.01, dtype=dtype, device=device),
        "log_scale": torch.zeros((dim,), dtype=dtype, device=device),
    }


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def encode(x, params: dict, cfg: SpikeConfig):
    """Activation -> signed float counts in {-T..T}. Differentiable.

    ``cfg.faithful`` selects the T-tick IF encoder on ``x/scale`` with
    the gate ``theta/scale``.  With a gradient wanted it runs
    ``lif_rate_encode_signed`` under PyTorch's autograd on CPU tensors
    and, on CUDA tensors (float32 only), ``_LIFEncode``: the
    ``lif_encode`` kernel forward and its surrogate-gradient kernel
    backward.  Without, the ``lif_encode`` kernel, whose counts are the
    same.  Like the reference it computes in the activation's dtype,
    float32 or bfloat16: on a bf16 activation every op is rounded to
    bf16 (the kernel's bf16 mode)."""
    scale = torch.exp(params["log_scale"]).to(x.dtype)
    theta = params["theta"].to(x.dtype)
    if not cfg.faithful:
        return rate_encode_signed(x, scale, theta, cfg.T)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"faithful IF encoder on {x.dtype} activations: not ported "
            "(the kernel computes in float32 or bfloat16)")
    if needs_grad(x, params["theta"], params["log_scale"]):
        if x.device.type == "cpu":
            return lif_rate_encode_signed(x / scale, theta / scale, cfg.T)
        if x.dtype != torch.float32:
            raise NotImplementedError(
                f"gradients through the faithful IF encoder on {x.dtype} "
                "activations off the CPU: the backward kernel computes "
                "in float32 only")
        return _LIFEncode.apply(x / scale, theta / scale, cfg.T)
    C = x.shape[-1]
    counts = kops.lif_encode(x.reshape(-1, C), theta, scale, T=cfg.T,
                             math_dtype=x.dtype)
    return counts.reshape(x.shape).to(x.dtype)


def decode(counts, params: dict, cfg: SpikeConfig, dtype=torch.bfloat16):
    scale = torch.exp(params["log_scale"]).to(dtype)
    return rate_decode_signed(counts, scale, cfg.T).to(dtype)


def unpack4_decode(packed, params: dict, cfg: SpikeConfig,
                   dtype=torch.bfloat16):
    """The receiving side of a packed wire: ``decode(wire_u8_to_counts(
    unpack4(packed), cfg.T, dtype), params, cfg, dtype)``, bit for bit,
    packed uint8 [..., C/2] -> [..., C] in ``dtype``.

    On a CUDA tensor with no gradient wanted on ``log_scale`` and a
    float32 or bfloat16 ``dtype``, one ``unpack4`` launch
    (``ops.unpack4_decode``) gives it, with ``scale / T`` computed here
    as ``decode`` computes it; otherwise (CPU tensors, a gradient) it
    runs the unpack, ``wire_u8_to_counts`` and ``decode``."""
    if (dtype in (torch.float32, torch.bfloat16)
            and not needs_grad(params["log_scale"])
            and kops._on_cuda("unpack4_decode", packed)):
        scale = torch.exp(params["log_scale"]).to(dtype)
        C2 = packed.shape[-1]
        out = kops.unpack4_decode(packed.reshape(-1, C2), cfg.T,
                                  scale / cfg.T)
        return out.reshape(*packed.shape[:-1], 2 * C2)
    return decode(wire_u8_to_counts(unpack4(packed), cfg.T, dtype), params,
                  cfg, dtype)


def encode_decode(x, params: dict, cfg: SpikeConfig):
    """``encode`` then ``decode`` in x's dtype: returns ``(counts,
    decoded)``, the decoded value equal to ``decode(encode(x, params,
    cfg), params, cfg, x.dtype)`` bit for bit.

    On a CUDA activation with the faithful encoder and no gradient
    wanted, one ``lif_encode`` launch gives both: int8 counts and, from
    its epilogue, ``counts * (scale / T)`` with ``scale / T`` computed
    here as ``decode`` computes it.  Otherwise (CPU tensors, the closed
    form, a gradient) it runs ``encode`` then ``decode``, and the counts
    are ``encode``'s floats.  Either way ``counts.to(torch.int8)`` is
    the wire."""
    if (cfg.faithful and x.dtype in (torch.float32, torch.bfloat16)
            and not needs_grad(x, params["theta"], params["log_scale"])
            and kops._on_cuda("lif_encode", x)):
        scale = torch.exp(params["log_scale"]).to(x.dtype)
        C = x.shape[-1]
        counts, dec = kops.lif_encode(
            x.reshape(-1, C), params["theta"].to(x.dtype), scale, T=cfg.T,
            math_dtype=x.dtype, decode_scale=scale / cfg.T)
        return counts.reshape(x.shape), dec.reshape(x.shape)
    counts = encode(x, params, cfg)
    return counts, decode(counts, params, cfg, x.dtype)


def roundtrip_vjp(x, theta, log_scale, g, cfg: SpikeConfig):
    """Hand-derived VJP of ``y = decode(encode(x))`` for the signed rate
    code (the reference's ``spike.roundtrip_vjp``): straight-through
    rounding, the fast-sigmoid surrogate through the gate,

      dy/dx  = gate * 1[0<|x|<s]  +  (c_mag*s/T) * surr(|x|-theta)
      dy/dth = -sign(x) * c_mag * (s/T) * surr(|x|-theta)
      dy/dls = sign(x)*gate * ( -|x| * 1[in] + c_mag*s/T )

    with ``s = exp(log_scale)``, computed here in float32, and the
    parameters' gradients summed over the token dims.  One launch of the
    ``roundtrip_bwd`` kernel on CUDA tensors (``ops.roundtrip_bwd``).
    Returns ``(dx in x's dtype, dtheta, dlog_scale)``."""
    s = torch.exp(log_scale.to(torch.float32))
    C = x.shape[-1]
    dx, dth, dls = kops.roundtrip_bwd(
        x.reshape(-1, C), g.to(x.dtype).reshape(-1, C), theta, s,
        s / cfg.T, T=cfg.T)
    return (dx.reshape(x.shape), dth.to(theta.dtype),
            dls.to(log_scale.dtype))
