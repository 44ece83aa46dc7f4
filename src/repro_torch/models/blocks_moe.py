"""Mixture-of-Experts FFN at tp = 1.

The port of ``repro.models.blocks_moe``.  Tokens are routed (an f32
router, softmax, top-k with the lower expert first on ties, the gates
renormalised), ranked within their expert token-major, and every
assignment at or past the expert's capacity C is dropped.  The kept
ones fill an [E, C, D] dispatch buffer, the experts run as three
batched products, and each token sums its k gated outputs left to
right, in a fixed order (no atomics), then the shared experts.

Capacity depends on the step's token count T, and dead slots' tokens
take part: C = ceil(T * k / E * cf), with cf = ``capacity_factor`` in
train mode (teacher-forced logits included) and 4.0 in prefill and
decode, as in the reference.

The reference codes its expert exchange (``sp_disp`` on the dispatch,
``sp_comb`` on the combine) only across ranks (tp > 1); at world size 1
the block has no coded exchange.  ``sp_disp``'s eq-10 penalty still
counts in training, and ``sp_comb`` is carried unused, as there.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import common
from .blocks_attn import _maybe_snn, _stats
from .context import Context
from .params import pdef, spike_pdefs

F32 = torch.float32


def moe_dims(cfg, tp=1):
    E = cfg.padded(cfg.n_experts, tp)
    return dict(E=E, E_loc=E // tp, Fe=cfg.d_ff_expert,
                n_real=cfg.n_experts,
                Fs=cfg.n_shared_experts * cfg.d_ff_expert)


def moe_defs(cfg, tp=1):
    d = moe_dims(cfg, tp)
    D = cfg.d_model
    defs = {
        "ln2": pdef(D, init="zeros"),
        "wr": pdef(D, d["E"], init="normal", scale=0.02, dtype=F32),
        "we1": pdef(d["E"], D, d["Fe"], tp=0, fsdp=1),
        "we3": pdef(d["E"], D, d["Fe"], tp=0, fsdp=1),
        "we2": pdef(d["E"], d["Fe"], D, tp=0, fsdp=1),
        "sp_disp": spike_pdefs(D),
        "sp_comb": spike_pdefs(D),
    }
    if d["Fs"]:
        defs["ws1"] = pdef(D, d["Fs"], fsdp=0)
        defs["ws3"] = pdef(D, d["Fs"], fsdp=0)
        defs["ws2"] = pdef(d["Fs"], D, fsdp=1)
    if cfg.hnn_mode == "snn":
        defs["sp_snn2"] = spike_pdefs(D)
    return defs


def capacity(cfg, T, mode):
    """Slots per expert for a step of T tokens in ``mode``."""
    cf = cfg.capacity_factor if mode == "train" else 4.0
    return max(1, math.ceil(T * cfg.top_k / moe_dims(cfg)["E"] * cf))


def _route(cfg, d, h, wr):
    """h [B, S, D] -> (gates [T, k] f32, idx [T, k], probs [T, E] f32).

    ``torch.topk`` promises no order among equal values; a stable
    descending sort keeps the lower expert first, as ``lax.top_k``."""
    h2 = h.reshape(-1, h.shape[-1])
    logits = h2.to(F32) @ wr.to(F32)
    emask = torch.arange(d["E"], device=h.device) < d["n_real"]
    logits = torch.where(emask[None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :cfg.top_k], order[:, :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def _aux_loss(d, probs, idx):
    """The Switch load-balance loss of one step's routing."""
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], d["E"]).to(F32).mean(0)
    return d["n_real"] * torch.sum(me * ce)


def _dispatch_slots(idx, E, C):
    """Token-major rank of each of the T * k assignments within its
    expert (the reference's cumsum over the flattened one-hot); those
    ranked at or past C are dropped.  Returns (keep [T*k] bool, the
    flat dispatch row ``e * C + rank`` of each kept assignment, E * C —
    one past the buffer, a sink — of each dropped one)."""
    e_fl = idx.reshape(-1)
    flat = F.one_hot(e_fl, E)
    rank = torch.gather(torch.cumsum(flat, 0) - flat, 1, e_fl[:, None])[:, 0]
    keep = rank < C
    row = torch.where(keep, e_fl * C + rank, torch.full_like(e_fl, E * C))
    return keep, row


def moe_fwd(p, x, ctx: Context):
    """x [B, S, D] -> (x', penalty, occupancy): the penalty of
    ``sp_disp`` plus 0.01 x the aux loss in train mode, ``(None, None)``
    in prefill and decode (their callers drop them)."""
    cfg = ctx.cfg
    d = moe_dims(cfg)
    B, S, D = x.shape
    T, k, E = B * S, cfg.top_k, d["E"]

    h = common.norm(x, p["ln2"], cfg.norm)
    h2 = h.reshape(T, D)
    pen, occ = _stats(h2, p["sp_disp"], ctx)
    gates, idx, probs = _route(cfg, d, h, p["wr"])

    C = capacity(cfg, T, ctx.mode)
    keep, row = _dispatch_slots(idx, E, C)
    # dispatch [E, C, D]: one kept assignment per row, the dropped ones
    # into the sink row past the end
    buf = h2.new_zeros(E * C + 1, D).index_put(
        (row,), h2.repeat_interleave(k, dim=0))
    xb = buf[:E * C].view(E, C, D)

    hh = common.act_fn(torch.bmm(xb, p["we1"]), cfg.act) \
        * torch.bmm(xb, p["we3"])
    yb = torch.bmm(hh, p["we2"])

    # combine: each token's k gated outputs summed left to right
    y_fl = yb.reshape(E * C, D)[torch.clamp(row, max=E * C - 1)]
    w = (gates.reshape(-1, 1) * keep[:, None]).to(y_fl.dtype)
    y_k = (y_fl * w).view(T, k, D)
    y = y_k[:, 0]
    for j in range(1, k):
        y = y + y_k[:, j]

    if d["Fs"]:
        y = y + (common.act_fn(h2 @ p["ws1"], cfg.act)
                 * (h2 @ p["ws3"])) @ p["ws2"]

    y = _maybe_snn(y.reshape(B, S, D), p.get("sp_snn2"), ctx)
    if pen is not None:
        pen = pen + 0.01 * _aux_loss(d, probs, idx)
    return x + y, pen, occ
