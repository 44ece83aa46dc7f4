"""Spike-coded boundaries at world size 1.

The port of ``repro.core.boundary`` for one device.  In the reference
every tensor that crosses a chip boundary moves through a collective
whose wire carries spike counts (or int8) instead of floats.  On one
card there is no peer, but the boundary still exists: each collective
here runs its encode -> wire -> decode through a size-1 "gather" (a
leading axis of length 1), so the codec's numerics — and therefore the
served tokens — are the reference's at tp=1.

All six modes are ported: ``none``, ``int8``, ``spike`` (the T-tick
IF encoder, through the ``lif_encode`` kernel when serving; a wire
roundtrip takes its decode from the same launch), ``spike_fused`` (the
closed form), ``spike_pack4`` (closed form at T=7, two counts per byte
through the ``pack4``/``unpack4`` kernels, the bias fused into the
pack, the unbias and the decode into the unpack) and
``sparse_topk`` (the top fraction of counts per token as (index, count)
pairs on the gather; dense counts elsewhere, as in the reference).  A
world size above 1 raises ``NotImplementedError``.

Gradients.  The wire is integer, so autograd cannot see through it:
``coded_all_gather``, ``coded_psum_scatter`` and ``coded_psum`` are
each a ``torch.autograd.Function``, as the reference's are
``jax.custom_vjp``s.  The forward runs the real wire (``_encode_local``
-> ``_decode_local``, the kernels serving runs); the backward is the
reference's ``_roundtrip_bwd`` on the primals: the cotangent straight
through under ``int8`` (the parameters get zeros), and
``spike.roundtrip_vjp`` under the spike codecs — the hand-derived VJP,
not the autograd of the forward (under ``spike`` that would chain the
surrogate through the IF ticks).  With ``bwd_mode="int8"`` the gather
and the reduce-scatter first code the cotangent as the reference's
transpose collective does at one rank: int8 absmax per channel over the
token axes.  The ``sparse_topk`` gather's backward is the VJP of its
local view (``_topk_local``, the mask detached), recomputed from the
primals.  ``wire_roundtrip`` has no custom VJP in the reference either:
it differentiates its local encode/decode.

``wire_roundtrip`` and ``coded_all_gather`` take the weights that
consume their decoded output (``consumers``; empty by default).  Under a
spike-count codec each such weight then also runs ``ops.count_matmul``
on the int8 counts of the wire — the receiving die's first matmul with
the rate decode fused — and drops the result: the served value stays
decode-then-matmul, as in the reference, whose models never call the
count matmul.  It is a shadow that puts the kernel on live traffic.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops as kops
from . import spike
from .spike import SpikeConfig

_MODES = ("none", "int8", "spike", "spike_fused", "spike_pack4",
          "sparse_topk")
#: the modes whose wire carries dense spike counts
COUNT_MODES = ("spike", "spike_fused", "spike_pack4")


@dataclasses.dataclass(frozen=True)
class BoundaryCodec:
    """Static description of one class of boundary."""

    mode: str = "none"
    cfg: SpikeConfig = SpikeConfig()
    capacity: float = 0.125        # sparse_topk capacity fraction
    bwd_mode: str = "none"         # compress backward wire too ("int8"|"none")

    def wire_bits(self) -> float:
        """Bits per boundary element on the wire (for roofline bookkeeping)."""
        if self.mode == "none":
            return 16.0
        if self.mode in ("int8", "spike", "spike_fused"):
            return 8.0
        if self.mode == "spike_pack4":
            return 4.0
        if self.mode == "sparse_topk":
            return self.capacity * (8 + 32)
        raise ValueError(self.mode)


def _check(codec: BoundaryCodec, world_size: int = 1):
    if codec.mode not in _MODES:
        raise ValueError(f"boundary mode {codec.mode!r}: expected one of "
                         f"{', '.join(_MODES)}")
    if world_size != 1:
        raise NotImplementedError(
            f"coded collectives over {world_size} ranks: the port runs "
            "at world size 1 only")


# ---------------------------------------------------------------------------
# local encode/decode to the integer wire format
# ---------------------------------------------------------------------------


def _encode_local(x, params, codec: BoundaryCodec):
    """x float [..., C] -> (wire int tensor, int8 scale or None, counts)."""
    _check(codec)
    if codec.mode == "int8":
        amax = torch.amax(torch.abs(x), dim=tuple(range(x.ndim - 1)),
                          keepdim=True)
        s = torch.clamp(amax, min=1e-6) / 127.0
        wire = torch.round(x / s).to(torch.int8)
        return wire, s, None
    counts = spike.encode(x, params, codec.cfg)      # float in {-T..T}
    if codec.mode == "spike_pack4":
        # {0..14} fits 4 bits: two counts per byte
        return spike.pack4_counts(counts, codec.cfg.T), None, counts
    return counts.to(torch.int8), None, counts


def _decode_local(wire, params, codec: BoundaryCodec, scale_i8, dtype):
    # decode directly in the compute dtype: counts are small integers,
    # exactly representable in bf16
    if codec.mode == "int8":
        return (wire.to(torch.float32) * scale_i8).to(dtype)
    if codec.mode == "spike_pack4":
        return spike.unpack4_decode(wire, params, codec.cfg, dtype)
    return spike.decode(wire.to(dtype), params, codec.cfg, dtype)


def _local_roundtrip(x, params, codec: BoundaryCodec, consumers=()):
    """Differentiable local view of encode -> wire -> decode."""
    if codec.mode == "int8":
        amax = torch.amax(torch.abs(x), dim=tuple(range(x.ndim - 1)),
                          keepdim=True)
        s = torch.clamp(amax, min=1e-6) / 127.0
        return spike.round_ste(x / s) * s
    counts, decoded = spike.encode_decode(x, params, codec.cfg)
    count_matmul_shadow(counts, params, codec, consumers, x.dtype)
    return decoded


def _check_consumers(codec: BoundaryCodec, consumers):
    if consumers and codec.mode not in COUNT_MODES:
        raise ValueError(f"count matmul on a {codec.mode!r} wire: it takes "
                         f"spike counts ({', '.join(COUNT_MODES)})")


def count_matmul_shadow(counts, params, codec: BoundaryCodec, consumers,
                        dtype):
    """For each weight [K, N] in ``consumers``, launch
    ``ops.count_matmul`` on the wire's counts [..., K] (int8, or the
    float counts of ``spike.encode``) as int8 rows, with the decode's
    scale ``exp(log_scale)`` in ``dtype`` and the result in ``dtype``;
    the results are dropped (see the module docstring)."""
    if not consumers:
        return
    K = counts.shape[-1]
    c8 = counts.reshape(-1, K).to(torch.int8)
    scale = torch.exp(params["log_scale"]).to(dtype)
    for w in consumers:
        kops.count_matmul(c8, w, scale, T=codec.cfg.T, out_dtype=dtype)


# ---------------------------------------------------------------------------
# sparse_topk: the top fraction of |count| per token
# ---------------------------------------------------------------------------


def _topk_k(C: int, capacity: float) -> int:
    return min(max(8, int(C * capacity)), C)


def topk_wire(counts, k: int):
    """The (index, count) packets of ``sparse_topk``'s gather: the k
    channels of largest ``|count|`` per token, ``(idx int64 [..., k],
    vals int8 [..., k])``.  Ties at the k-th magnitude are the rule (the
    magnitudes are integers in {0..T}), and ``lax.top_k`` keeps the lower
    index among equals; a stable descending sort does the same, where
    ``torch.topk`` promises no order among ties."""
    idx = torch.sort(torch.abs(counts), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return idx, torch.gather(counts, -1, idx).to(torch.int8)


def _topk_local(x, params, codec: BoundaryCodec):
    """Local view of the top-k wire: every channel whose |count| reaches
    the k-th largest is kept (ties kept, so no tie-breaking)."""
    C = x.shape[-1]
    k = _topk_k(C, codec.capacity)
    c = spike.encode(x, params, codec.cfg)
    mag = torch.abs(c).detach()
    thresh = torch.sort(mag, dim=-1).values[..., C - k:C - k + 1]
    mask = (mag >= thresh).to(c.dtype)
    return spike.decode(c * mask, params, codec.cfg, x.dtype)


class _TopkGather(torch.autograd.Function):
    """Gather over one rank of the top-k (index, count) packets: encode,
    select, scatter the counts back into a dense zero row and decode.
    Backward (the reference's custom VJP): the VJP of ``_topk_local``
    at the primals, its mask detached."""

    @staticmethod
    def forward(ctx, x, theta, log_scale, codec):
        params = {"theta": theta, "log_scale": log_scale}
        counts = spike.encode(x, params, codec.cfg)
        idx, vals = topk_wire(counts, _topk_k(x.shape[-1], codec.capacity))
        dense = torch.zeros(counts.shape, dtype=torch.float32,
                            device=x.device)
        dense.scatter_(-1, idx, vals.to(torch.float32))
        ctx.save_for_backward(x, theta, log_scale)
        ctx.codec = codec
        return spike.decode(dense, params, codec.cfg, x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, theta, log_scale = ctx.saved_tensors
        with torch.enable_grad():
            prim = [t.detach().requires_grad_() for t in (x, theta,
                                                          log_scale)]
            y = _topk_local(prim[0], {"theta": prim[1],
                                      "log_scale": prim[2]}, ctx.codec)
            grads = torch.autograd.grad(y, prim, g, allow_unused=True)
        return tuple(torch.zeros_like(p) if d is None else d
                     for p, d in zip(prim, grads)) + (None,)


def _topk_all_gather(x, params, codec: BoundaryCodec):
    return _TopkGather.apply(x, params["theta"], params["log_scale"], codec)


# ---------------------------------------------------------------------------
# sparsity statistics (feeds the eq-10 regularizer)
# ---------------------------------------------------------------------------


def boundary_penalty(x, params, codec: BoundaryCodec):
    """Differentiable sparsity penalty + occupancy of one boundary's
    counts, in x's dtype; zeros under ``none`` and ``int8``."""
    if codec.mode in ("none", "int8"):
        z = torch.zeros((), dtype=x.dtype, device=x.device)
        return z, z
    counts = spike.encode(x, params, codec.cfg)
    pen = spike.sparsity_loss(counts, codec.cfg.T, codec.cfg.target_rate,
                              codec.cfg.lam)
    occ = spike.occupancy(counts)
    return pen.to(x.dtype), occ.to(x.dtype)


# ---------------------------------------------------------------------------
# the coded collectives' backward
# ---------------------------------------------------------------------------

_INT8 = BoundaryCodec(mode="int8")


def _roundtrip_bwd(x, theta, log_scale, g, codec: BoundaryCodec):
    """Analytic VJP of the local encode -> decode roundtrip (the
    reference's ``_roundtrip_bwd``): straight through under ``int8``,
    with no learnable parameters; ``spike.roundtrip_vjp`` otherwise."""
    if codec.mode == "int8":
        return (g.to(x.dtype), torch.zeros_like(theta),
                torch.zeros_like(log_scale))
    return spike.roundtrip_vjp(x, theta, log_scale, g, codec.cfg)


def _code_cotangent(g, codec: BoundaryCodec):
    """Under ``bwd_mode="int8"``, the cotangent as the transpose
    collective's int8 wire delivers it at one rank: absmax per channel
    over the token axes, rounded, decoded in g's dtype."""
    if codec.bwd_mode != "int8":
        return g
    wire, s8, _ = _encode_local(g, None, _INT8)
    return _decode_local(wire, None, _INT8, s8, g.dtype)


class _CodedCollective(torch.autograd.Function):
    """One coded collective over one rank: ``forward_fn(x, params)`` runs
    the integer wire; backward is ``_roundtrip_bwd`` at the primals, the
    cotangent first coded when ``code_g`` (``bwd_mode``)."""

    @staticmethod
    def forward(ctx, x, theta, log_scale, codec, forward_fn, code_g):
        ctx.save_for_backward(x, theta, log_scale)
        ctx.codec, ctx.code_g = codec, code_g
        return forward_fn(x, {"theta": theta, "log_scale": log_scale})

    @staticmethod
    def backward(ctx, g):
        x, theta, log_scale = ctx.saved_tensors
        if ctx.code_g:
            g = _code_cotangent(g, ctx.codec)
        dx, dth, dls = _roundtrip_bwd(x, theta, log_scale, g, ctx.codec)
        return dx, dth, dls, None, None, None


def _coded(x, params, codec, forward_fn, code_g):
    return _CodedCollective.apply(x, params["theta"], params["log_scale"],
                                  codec, forward_fn, code_g)


# ---------------------------------------------------------------------------
# train/prefill boundaries: gather-in and reduce-scatter-out of a layer
# ---------------------------------------------------------------------------


def coded_all_gather(x, params, codec: BoundaryCodec, axis: int = 0,
                     world_size: int = 1, consumers=()):
    """Token-axis all_gather over one rank: the local encode -> wire ->
    decode of the reference's coded gather (per-channel int8 scales).
    ``consumers``: the weights that take the gathered value, each run
    through the count matmul shadow."""
    _check(codec, world_size)
    _check_consumers(codec, consumers)
    if codec.mode == "none":
        return x
    if codec.mode == "sparse_topk":
        return _topk_all_gather(x, params, codec)

    def wire(x, p):
        w, s8, counts = _encode_local(x, p, codec)
        count_matmul_shadow(counts, p, codec, consumers, x.dtype)
        return _decode_local(w, p, codec, s8, x.dtype)
    return _coded(x, params, codec, wire, code_g=True)


def coded_psum_scatter(x, params, codec: BoundaryCodec, axis: int = 0,
                       world_size: int = 1):
    """Reduce-scatter of partial sums over one rank: encode, exchange
    one chunk with itself, decode and sum — the reference's spike
    accumulation at n=1."""
    _check(codec, world_size)
    if codec.mode == "none":
        return x

    def wire(x, p):
        w, s8, _ = _encode_local(x, p, codec)
        dec = _decode_local(w.unsqueeze(0), p, codec,
                            None if s8 is None else s8.unsqueeze(0),
                            x.dtype)
        return torch.sum(dec, dim=0)
    return _coded(x, params, codec, wire, code_g=True)


# ---------------------------------------------------------------------------
# decode-path boundaries (token-replicated activations)
# ---------------------------------------------------------------------------
#
# Both stay BATCH-INDEPENDENT: no reduction mixes slots, and int8 scales
# are per token, so a slot's greedy stream does not depend on its
# neighbours in the batch.


def wire_roundtrip(x, params, codec: BoundaryCodec, consumers=()):
    """Local encode -> wire -> decode for a replicated decode activation.
    ``consumers``: the weights that take the decoded value, each run
    through the count matmul shadow."""
    _check(codec)
    _check_consumers(codec, consumers)
    if codec.mode == "none":
        return x
    if codec.mode == "int8":
        s = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                        min=1e-6) / 127.0
        return (spike.round_ste(x / s) * s).to(x.dtype)
    if codec.mode == "sparse_topk":
        return _topk_local(x, params, codec)
    return _local_roundtrip(x, params, codec, consumers)


def coded_psum(x, params, codec: BoundaryCodec, world_size: int = 1):
    """All-reduce of partial sums with the coded wire, over one rank.

    Each rank encodes its partial, the wire is gathered (here: a
    leading axis of length 1), and every rank decodes and sums — so at
    tp=1 the codec's rounding still applies, exactly as in the
    reference.  ``sparse_topk`` sends dense counts here (decode tensors
    are [B, 1, D]-tiny), as in the reference."""
    _check(codec, world_size)
    if codec.mode == "none":
        return x

    def wire(x, p):
        if codec.mode == "int8":
            s = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                            min=1e-6) / 127.0
            wire_g = torch.round(x / s).to(torch.int8).unsqueeze(0)
            s_g = s.unsqueeze(0)
            dec = wire_g.to(torch.float32) * s_g.to(torch.float32)
            return torch.sum(dec, dim=0).to(x.dtype)
        w, _, _ = _encode_local(x, p, codec)
        dec = _decode_local(w.unsqueeze(0), p, codec, None, x.dtype)
        return torch.sum(dec, dim=0)
    # the psum's cotangent is already replicated: no coding of it
    return _coded(x, params, codec, wire, code_g=False)


# ---------------------------------------------------------------------------
# decode-step head-space boundary: the attention partial combine
# ---------------------------------------------------------------------------


def quantize_partial(o):
    """Per-token int8 absmax quantization of a locally normalized
    attention partial ``[..., dh]`` -> ``(wire int8, scale f32)``.

    The same contract as the paged-decode kernel's epilogue, so the
    reference walk and the kernel put the same bytes on the wire."""
    o = o.to(torch.float32)
    s = torch.clamp(torch.amax(torch.abs(o), dim=-1, keepdim=True),
                    min=1e-6) / 127.0
    return torch.round(o / s).to(torch.int8), s


def coded_combine_partials(wire, scale, lse, out_dtype, world_size: int = 1):
    """LSE-weighted combine of int8-coded decode partials over one shard
    (the gathers are a leading axis of length 1)."""
    if world_size != 1:
        raise NotImplementedError(
            "coded partial combine over several shards: not ported yet")
    wire_g = wire.unsqueeze(0)
    s_g = scale.unsqueeze(0)
    lse_g = lse.unsqueeze(0)
    m = torch.amax(lse_g, dim=0)
    w = torch.exp(lse_g - m)
    dec = wire_g.to(torch.float32) * s_g.to(torch.float32)
    o_sum = torch.sum(dec * w[..., None], dim=0)
    l_sum = torch.sum(w, dim=0)
    return (o_sum / torch.clamp(l_sum[..., None], min=1e-30)).to(out_dtype)
