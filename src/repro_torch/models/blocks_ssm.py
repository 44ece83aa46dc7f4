"""Mamba (selective SSM) mixer block at tp = 1 — jamba's dominant layer.

The port of ``repro.models.blocks_ssm``.  The reference's selective
scan is jnp (an associative scan inside ``lax.scan`` chunks of 256
tokens, which asserts that the length is one chunk or a multiple of
one), outside any Pallas kernel, so plain torch ops are the port.  Here
each chunk of up to ``chunk`` tokens materialises its decay and drive
``[B, ch, Di, N]`` at once, then steps the recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t`` token by token on a
``[B, Di, N]`` carry: the reference's sums up to float reassociation
(its associative scan multiplies the decays in another order), for any
length.  At jamba's width (Di 16384, N 16) a chunk of 64 tokens holds
64 MB a tensor in float32.

The causal depthwise convolution is written as K shifted products, the
same sum the decode step takes over its window (cuDNN's convolution
would round its float32 inputs to TF32 on the card).  As in the
reference, the prefill state's ``conv`` rows are the last K-1 rows of
the convolution's activated output (the decode step keeps raw inputs
there) in the model dtype, and ``ssm`` the float32 state.
"""
from __future__ import annotations

import torch

from ..core import boundary
from . import common
from .blocks_attn import _stats
from .blocks_rnn import softplus
from .context import Context
from .params import pdef, spike_pdefs

F32 = torch.float32


def ssm_dims(cfg, tp=1):
    Di = cfg.inner_padded(tp)
    return dict(Di=Di, Di_loc=Di // tp, N=cfg.d_state, R=cfg.dt_rank_eff,
                K=cfg.d_conv)


def mamba_defs(cfg, tp=1):
    d = ssm_dims(cfg, tp)
    D = cfg.d_model
    return {
        "ln": pdef(D, init="zeros"),
        "wi": pdef(D, 2 * d["Di"], tp=1, fsdp=0),        # x, z
        "conv_w": pdef(d["Di"], d["K"], tp=0, scale=0.1),
        "wb": pdef(D, d["N"], scale=0.05),               # B projection
        "wc": pdef(D, d["N"], scale=0.05),               # C projection
        "wdt1": pdef(D, d["R"], scale=0.05),
        "wdt2": pdef(d["R"], d["Di"], tp=1, scale=0.1),
        "dt_bias": pdef(d["Di"], tp=0, init="dtbias", dtype=F32),
        "a_log": pdef(d["Di"], d["N"], tp=0, init="alog", dtype=F32),
        "d_skip": pdef(d["Di"], tp=0, init="ones", dtype=F32),
        "wo": pdef(d["Di"], D, tp=0, fsdp=1),
        "sp_in": spike_pdefs(D),
        "sp_out": spike_pdefs(D),
    }


def mamba_state_shapes(cfg):
    """Per-slot state leaves: name -> (shape, dtype)."""
    d = ssm_dims(cfg)
    return {"conv": ((d["K"] - 1, d["Di"]), cfg.dtype),
            "ssm": ((d["Di"], d["N"]), F32)}


def _causal_conv(x, w):
    """x [B, S, Ci]; w [Ci, K]: depthwise causal convolution, left-padded
    by K-1, in float32, back in x's dtype."""
    B, S, Ci = x.shape
    K = w.shape[1]
    xp = torch.cat([torch.zeros((B, K - 1, Ci), dtype=F32, device=x.device),
                    x.to(F32)], dim=1)
    wf = w.to(F32)
    out = xp[:, 0:S] * wf[:, 0]
    for k in range(1, K):
        out = out + xp[:, k:k + S] * wf[:, k]
    return out.to(x.dtype)


def _selective_scan(x_in, dt, Bm, Cm, A, h, chunk=64):
    """x_in, dt [B, S, Di]; Bm, Cm [B, S, N]; A [Di, N]; h [B, Di, N].

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t
    Returns (y [B, S, Di], final h)."""
    ys = []
    for s0 in range(0, x_in.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        dtc = dt[:, sl]
        decay = torch.exp(dtc[..., None] * A)                 # [B,ch,Di,N]
        drive = (dtc * x_in[:, sl])[..., None] * Bm[:, sl, None, :]
        hs = []
        for t in range(decay.shape[1]):
            h = decay[:, t] * h + drive[:, t]
            hs.append(h)
        ys.append(torch.einsum("bcdn,bcn->bcd", torch.stack(hs, dim=1),
                               Cm[:, sl]))
    return torch.cat(ys, dim=1), h


def _dt(p, h):
    """The step sizes of the input h [..., D]: float32 [..., Di]."""
    dtr = h @ p["wdt1"].to(h.dtype)
    return softplus(dtr.to(F32) @ p["wdt2"].to(F32) + p["dt_bias"])


def mamba_fwd(p, x, ctx: Context):
    """Train / prefill.  x [B, S, D] -> (x', state in prefill mode else
    None, penalty, occupancy)."""
    cfg = ctx.cfg
    d = ssm_dims(cfg)
    h = common.norm(x, p["ln"], cfg.norm)
    pen, occ = _stats(h, p["sp_in"], ctx)
    xg = boundary.coded_all_gather(h, p["sp_in"], ctx.codec, axis=1)
    B, S, _ = xg.shape
    x_in, z = torch.chunk(xg @ p["wi"], 2, dim=-1)          # [B, S, Di]
    x_in = common.act_fn(_causal_conv(x_in, p["conv_w"]), "silu")
    Bm = xg.to(F32) @ p["wb"].to(F32)
    Cm = xg.to(F32) @ p["wc"].to(F32)
    dt = _dt(p, xg)
    A = -torch.exp(p["a_log"])
    y, h_fin = _selective_scan(
        x_in.to(F32), dt, Bm, Cm, A,
        torch.zeros((B, d["Di_loc"], d["N"]), dtype=F32, device=x.device))
    y = y + p["d_skip"] * x_in.to(F32)
    y = (y * common.act_fn(z.to(F32), "silu")).to(x.dtype)
    out = boundary.coded_psum_scatter(y @ p["wo"], p["sp_out"], ctx.codec,
                                      axis=1)
    cache = None
    if ctx.mode == "prefill":
        # the reference's slice, which keeps fewer than K-1 rows when
        # S < K-1 (the engine's insert then broadcasts them, as there)
        cache = {"conv": x_in[:, S - (d["K"] - 1):].to(x.dtype),
                 "ssm": h_fin}
    return x + out, cache, pen, occ


def mamba_decode_fwd(p, x, state, ctx: Context):
    """One state update.  x [B, 1, D], state {conv [B, K-1, Di], ssm
    [B, Di, N]} -> (x', new state)."""
    cfg = ctx.cfg
    h = common.norm(x, p["ln"], cfg.norm)[:, 0]              # [B, D]
    h = boundary.wire_roundtrip(h, p["sp_in"], ctx.codec)
    x_in, z = torch.chunk(h @ p["wi"], 2, dim=-1)           # [B, Di]
    conv = state["conv"]
    hist = torch.cat([conv, x_in[:, None, :].to(conv.dtype)], dim=1)
    x_c = torch.einsum("bkc,ck->bc", hist.to(F32), p["conv_w"].to(F32))
    x_c = common.act_fn(x_c, "silu")
    Bm = h.to(F32) @ p["wb"].to(F32)                         # [B, N]
    Cm = h.to(F32) @ p["wc"].to(F32)
    dt = _dt(p, h)
    A = -torch.exp(p["a_log"])
    decay = torch.exp(dt[..., None] * A)                     # [B, Di, N]
    drive = (dt * x_c)[..., None] * Bm[:, None, :]
    h_new = decay * state["ssm"] + drive
    y = torch.einsum("bdn,bn->bd", h_new, Cm)
    y = y + p["d_skip"] * x_c
    y = (y * common.act_fn(z.to(F32), "silu")).to(x.dtype)
    out = boundary.coded_psum(y[:, None, :] @ p["wo"], p["sp_out"],
                              ctx.codec)
    return x + out, {"conv": hist[:, 1:], "ssm": h_new}
