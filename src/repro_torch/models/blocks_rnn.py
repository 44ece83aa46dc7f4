"""Recurrent blocks at tp = 1: xLSTM (mLSTM + sLSTM) and RWKV (the
paper's LM).

The port of ``repro.models.blocks_rnn``.  The reference runs every scan
as jnp (``lax.scan`` over sequence chunks), outside any Pallas kernel,
so plain torch ops are the port.  Its chunked scans take only lengths
of at most one chunk or a multiple of it (a reshape to ``S // 64``
chunks); the port's carry the state across chunks of any length.

* mLSTM and sLSTM step token by token, as the reference's inner scans
  do (the sLSTM recurrence runs through ``h``, so it has no parallel
  form); the carried state leaves are named as the reference's cache
  defs: ``C``, ``n``, ``m`` and ``c``, ``n``, ``h``, ``m``.
* RWKV's wkv recurrence is linear in its state, so a chunk of L tokens
  is computed at once from an [L, L] table of log-weights, stabilised
  by each row's maximum as the reference's step is by ``pp``: the same
  sums up to float reassociation, in a few dozen operations a chunk in
  place of a few dozen a token (the training step runs it on 256
  tokens).  The decode step is the reference's ``_wkv_step``.  The
  state is ``x_tm``, ``x_cm``, ``aa``, ``bb``, ``pp`` (``pp`` starts at
  -1e30).

As in the reference, ``rwkv_fwd`` in SNN mode roundtrips both block
outputs through their codec locally, and ``rwkv_decode_fwd`` does not;
the prefill state holds ``x_tm`` / ``x_cm`` as the gathered normed
input of the last token, the decode state the decode's wire-roundtripped
one.  Decode steps return the new state; the model writes it into the
slot-major state leaves in place.
"""
from __future__ import annotations

import torch

from ..core import boundary
from . import common
from .blocks_attn import _stats
from .context import Context
from .params import pdef, spike_pdefs

F32 = torch.float32


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (torch's
    ``F.softplus`` switches to ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# ===========================================================================
# mLSTM (xLSTM matrix-memory block)
# ===========================================================================


def mlstm_dims(cfg, tp=1):
    H = cfg.padded(cfg.n_heads, tp)
    dh = cfg.d_model // cfg.n_heads
    return dict(H=H, H_loc=H // tp, dh=dh)


def mlstm_defs(cfg, tp=1):
    d = mlstm_dims(cfg, tp)
    D, dh = cfg.d_model, d["dh"]
    return {
        "ln": pdef(D, init="zeros"),
        "wq": pdef(D, d["H"] * dh, tp=1, fsdp=0),
        "wk": pdef(D, d["H"] * dh, tp=1, fsdp=0),
        "wv": pdef(D, d["H"] * dh, tp=1, fsdp=0),
        "wif": pdef(D, 2, d["H"], tp=2, scale=0.05),    # i,f gate logits
        "wg": pdef(D, d["H"] * dh, tp=1, fsdp=0),       # output gate
        "wo": pdef(d["H"] * dh, D, tp=0, fsdp=1),
        "sp_in": spike_pdefs(D),
        "sp_out": spike_pdefs(D),
    }


def mlstm_state_shapes(cfg):
    """Per-slot state leaves: name -> (shape, dtype)."""
    d = mlstm_dims(cfg)
    H, dh = d["H"], d["dh"]
    return {"C": ((H, dh, dh), F32), "n": ((H, dh), F32), "m": ((H,), F32)}


def _mlstm_cell(state, q, k, v, ig, fg):
    """One stabilised mLSTM step (xLSTM paper eqs 19-27)."""
    C, n, m = state
    m_new = torch.maximum(fg + m, ig)
    f_eff = torch.exp(fg + m - m_new)
    i_eff = torch.exp(ig - m_new)
    C_new = (f_eff[..., None, None] * C
             + i_eff[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = f_eff[..., None] * n + i_eff[..., None] * k
    num = torch.einsum("bhij,bhi->bhj", C_new, q)
    den = torch.maximum(torch.abs(torch.einsum("bhi,bhi->bh", n_new, q)),
                        torch.ones((), dtype=F32, device=q.device))
    h = num / den[..., None]
    return (C_new, n_new, m_new), h


def _mlstm_scan(q, k, v, ig, fg, state):
    """q, k, v [B, S, H, dh]; ig, fg [B, S, H] -> (h [B, S, H, dh],
    state)."""
    hs = []
    for t in range(q.shape[1]):
        state, h = _mlstm_cell(state, q[:, t], k[:, t], v[:, t], ig[:, t],
                               fg[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), state


def _mlstm_inputs(p, xg, d):
    """Projections of the gathered input [..., D] -> q, k, v [..., H, dh]
    and the gate logits ig, log-sigmoid fg [..., H], all float32."""
    lead = xg.shape[:-1]
    H, dh = d["H_loc"], d["dh"]
    q = (xg @ p["wq"]).reshape(*lead, H, dh).to(F32)
    k = (xg @ p["wk"]).reshape(*lead, H, dh).to(F32) / (dh ** 0.5)
    v = (xg @ p["wv"]).reshape(*lead, H, dh).to(F32)
    gif = torch.einsum("...d,dgh->...gh", xg.to(F32), p["wif"].to(F32))
    return q, k, v, gif[..., 0, :], log_sigmoid(gif[..., 1, :])


def mlstm_fwd(p, x, ctx: Context):
    """x [B, S, D] -> (x', state in prefill mode else None, penalty,
    occupancy)."""
    cfg = ctx.cfg
    d = mlstm_dims(cfg)
    h_in = common.norm(x, p["ln"], cfg.norm)
    pen, occ = _stats(h_in, p["sp_in"], ctx)
    xg = boundary.coded_all_gather(h_in, p["sp_in"], ctx.codec, axis=1)
    B, S, _ = xg.shape
    H, dh = d["H_loc"], d["dh"]
    q, k, v, ig, fg = _mlstm_inputs(p, xg, d)
    z = dict(dtype=F32, device=x.device)
    state = (torch.zeros((B, H, dh, dh), **z), torch.zeros((B, H, dh), **z),
             torch.zeros((B, H), **z))
    hseq, state = _mlstm_scan(q, k, v, ig, fg, state)
    og = torch.sigmoid((xg @ p["wg"]).to(F32)).reshape(B, S, H, dh)
    y = (hseq * og).reshape(B, S, H * dh).to(x.dtype)
    out = boundary.coded_psum_scatter(y @ p["wo"], p["sp_out"], ctx.codec,
                                      axis=1)
    cache = None
    if ctx.mode == "prefill":
        cache = {"C": state[0], "n": state[1], "m": state[2]}
    return x + out, cache, pen, occ


def mlstm_decode_fwd(p, x, state, ctx: Context):
    """x [B, 1, D], state {C, n, m} of every slot -> (x', new state)."""
    cfg = ctx.cfg
    d = mlstm_dims(cfg)
    B = x.shape[0]
    h_in = common.norm(x, p["ln"], cfg.norm)[:, 0]
    h_in = boundary.wire_roundtrip(h_in, p["sp_in"], ctx.codec)
    q, k, v, ig, fg = _mlstm_inputs(p, h_in, d)
    st, h = _mlstm_cell((state["C"], state["n"], state["m"]), q, k, v, ig,
                        fg)
    og = torch.sigmoid((h_in @ p["wg"]).to(F32)).reshape(B, d["H_loc"],
                                                          d["dh"])
    y = (h * og).reshape(B, 1, d["H_loc"] * d["dh"]).to(x.dtype)
    out = boundary.coded_psum(y @ p["wo"], p["sp_out"], ctx.codec)
    return x + out, {"C": st[0], "n": st[1], "m": st[2]}


# ===========================================================================
# sLSTM (xLSTM scalar-memory block, block-diagonal recurrence)
# ===========================================================================


def slstm_defs(cfg, tp=1):
    d = mlstm_dims(cfg, tp)
    D, dh = cfg.d_model, d["dh"]
    return {
        "ln": pdef(D, init="zeros"),
        "wz": pdef(D, d["H"] * dh, tp=1, fsdp=0),
        "wgates": pdef(D, 3, d["H"] * dh, tp=2, fsdp=0),    # i,f,o
        "r": pdef(d["H"], dh, 4 * dh, tp=0, scale=0.05),    # z,i,f,o
        "wo": pdef(d["H"] * dh, D, tp=0, fsdp=1),
        "sp_in": spike_pdefs(D),
        "sp_out": spike_pdefs(D),
    }


_SLSTM_KEYS = ("c", "n", "h", "m")


def slstm_state_shapes(cfg):
    d = mlstm_dims(cfg)
    return {k: ((d["H"], d["dh"]), F32) for k in _SLSTM_KEYS}


def _slstm_cell(state, z_x, i_x, f_x, o_x, r):
    """Stabilised sLSTM step; r [H, dh, 4dh] block-diagonal recurrence."""
    c, n, h, m = state                              # [B, H, dh]
    rec = torch.einsum("bhi,hij->bhj", h, r)        # [B, H, 4dh]
    z_r, i_r, f_r, o_r = torch.split(rec, c.shape[-1], dim=-1)
    z = torch.tanh(z_x + z_r)
    i_t = i_x + i_r
    f_t = log_sigmoid(f_x + f_r)
    o = torch.sigmoid(o_x + o_r)
    m_new = torch.maximum(f_t + m, i_t)
    i_eff = torch.exp(i_t - m_new)
    f_eff = torch.exp(f_t + m - m_new)
    c_new = f_eff * c + i_eff * z
    n_new = f_eff * n + i_eff
    h_new = o * c_new / torch.maximum(
        n_new, torch.full((), 1e-6, dtype=F32, device=n.device))
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_inputs(p, xg, d):
    """Gathered input [..., D] -> z, i, f, o pre-activations [..., H,
    dh], float32."""
    lead = xg.shape[:-1]
    H, dh = d["H_loc"], d["dh"]
    zx = (xg @ p["wz"]).reshape(*lead, H, dh).to(F32)
    gx = torch.einsum("...d,dgk->...gk", xg.to(F32), p["wgates"].to(F32))
    gx = gx.reshape(*lead, 3, H, dh)
    return zx, gx[..., 0, :, :], gx[..., 1, :, :], gx[..., 2, :, :]


def slstm_fwd(p, x, ctx: Context):
    cfg = ctx.cfg
    d = mlstm_dims(cfg)
    h_in = common.norm(x, p["ln"], cfg.norm)
    pen, occ = _stats(h_in, p["sp_in"], ctx)
    xg = boundary.coded_all_gather(h_in, p["sp_in"], ctx.codec, axis=1)
    B, S, _ = xg.shape
    H, dh = d["H_loc"], d["dh"]
    zx, ix, fx, ox = _slstm_inputs(p, xg, d)
    r = p["r"].to(F32)
    state = tuple(torch.zeros((B, H, dh), dtype=F32, device=x.device)
                  for _ in _SLSTM_KEYS)
    hs = []
    for t in range(S):
        state, h = _slstm_cell(state, zx[:, t], ix[:, t], fx[:, t],
                               ox[:, t], r)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, H * dh).to(x.dtype)
    out = boundary.coded_psum_scatter(y @ p["wo"], p["sp_out"], ctx.codec,
                                      axis=1)
    cache = dict(zip(_SLSTM_KEYS, state)) if ctx.mode == "prefill" else None
    return x + out, cache, pen, occ


def slstm_decode_fwd(p, x, state, ctx: Context):
    cfg = ctx.cfg
    d = mlstm_dims(cfg)
    B = x.shape[0]
    h_in = common.norm(x, p["ln"], cfg.norm)[:, 0]
    h_in = boundary.wire_roundtrip(h_in, p["sp_in"], ctx.codec)
    zx, ix, fx, ox = _slstm_inputs(p, h_in, d)
    st, h = _slstm_cell(tuple(state[k] for k in _SLSTM_KEYS), zx, ix, fx,
                        ox, p["r"].to(F32))
    y = h.reshape(B, 1, d["H_loc"] * d["dh"]).to(x.dtype)
    out = boundary.coded_psum(y @ p["wo"], p["sp_out"], ctx.codec)
    return x + out, dict(zip(_SLSTM_KEYS, st))


# ===========================================================================
# RWKV (the paper's language model; RWKV-4-style)
# ===========================================================================


def rwkv_dims(cfg, tp=1):
    C = cfg.padded(cfg.d_model, tp)
    return dict(C=C, C_loc=C // tp)


def rwkv_defs(cfg, tp=1):
    d = rwkv_dims(cfg, tp)
    D = cfg.d_model
    F = cfg.ff_padded(tp) or 4 * D
    return {
        "ln1": pdef(D, init="zeros"),
        "ln2": pdef(D, init="zeros"),
        "mix_kvr": pdef(3, D, init="half", dtype=F32),
        "mix_cm": pdef(2, D, init="half", dtype=F32),
        "time_decay": pdef(d["C"], tp=0, init="zeros", dtype=F32),
        "time_first": pdef(d["C"], tp=0, init="zeros", dtype=F32),
        "wk_tm": pdef(D, d["C"], tp=1, fsdp=0),
        "wv_tm": pdef(D, d["C"], tp=1, fsdp=0),
        "wr_tm": pdef(D, d["C"], tp=1, fsdp=0),
        "wo_tm": pdef(d["C"], D, tp=0, fsdp=1),
        "wk_cm": pdef(D, F, tp=1, fsdp=0),
        "wr_cm": pdef(D, D, fsdp=0),
        "wv_cm": pdef(F, D, tp=0, fsdp=1),
        "sp_in": spike_pdefs(D),
        "sp_out": spike_pdefs(D),
        "sp_in2": spike_pdefs(D),
        "sp_out2": spike_pdefs(D),
    }


def rwkv_state_shapes(cfg):
    C, D = rwkv_dims(cfg)["C"], cfg.d_model
    return {"x_tm": ((D,), cfg.dtype), "x_cm": ((D,), cfg.dtype),
            "aa": ((C,), F32), "bb": ((C,), F32), "pp": ((C,), F32)}


#: the wkv state's log-space running maximum starts here
PP_INIT = -1e30


def _wkv_step(state, kt, vt, w, u):
    """The reference's numerically stable wkv recurrence, one step."""
    aa, bb, pp = state
    ww = u + kt
    q = torch.maximum(pp, ww)
    e1 = torch.exp(pp - q)
    e2 = torch.exp(ww - q)
    out = (e1 * aa + e2 * vt) / torch.maximum(
        e1 * bb + e2, torch.full((), 1e-30, dtype=F32, device=aa.device))
    ww2 = pp + w
    q2 = torch.maximum(ww2, kt)
    e1b = torch.exp(ww2 - q2)
    e2b = torch.exp(kt - q2)
    return (e1b * aa + e2b * vt, e1b * bb + e2b, q2), out


def _wkv_chunk(k, v, w, u, state):
    """L tokens of the wkv recurrence at once.  k, v [B, L, C]; w, u
    [C]; state (aa, bb, pp) [B, C], the true running sums being
    ``aa * exp(pp)`` and ``bb * exp(pp)``.  Before token t the sums are
    the state's, decayed by ``t * w``, plus token i < t's ``exp(k_i)
    (v_i | 1)`` decayed by ``(t - 1 - i) * w``; the output adds the
    current token at ``u + k_t``.  Each row is stabilised by its largest
    log-weight, the end state by its own (the reference's ``pp``)."""
    aa, bb, pp = state
    L = k.shape[1]
    dev = k.device
    t = torch.arange(L, dtype=F32, device=dev)
    lag = t[:, None] - 1 - t[None, :]                        # [L(t), L(i)]
    past = lag >= 0
    neg = torch.full((), float("-inf"), dtype=F32, device=dev)
    logw = torch.where(past[None, :, :, None],
                       lag[None, :, :, None] * w + k[:, None, :, :], neg)
    a = pp[:, None, :] + t[None, :, None] * w                # [B, L, C]
    cur = u + k
    m = torch.maximum(torch.maximum(a, cur), torch.amax(logw, dim=2))
    ew = torch.exp(logw - m[:, :, None, :])                  # [B, L, L, C]
    ea = torch.exp(a - m)
    ec = torch.exp(cur - m)
    num = aa[:, None] * ea + torch.sum(ew * v[:, None], dim=2) + ec * v
    den = bb[:, None] * ea + torch.sum(ew, dim=2) + ec
    out = num / torch.maximum(den, torch.full((), 1e-30, dtype=F32,
                                              device=dev))
    e_end = k + (L - 1 - t)[None, :, None] * w               # [B, L, C]
    a_end = pp + L * w
    pp_new = torch.maximum(a_end, torch.amax(e_end, dim=1))
    ee = torch.exp(e_end - pp_new[:, None])
    ea_end = torch.exp(a_end - pp_new)
    aa_new = aa * ea_end + torch.sum(ee * v, dim=1)
    bb_new = bb * ea_end + torch.sum(ee, dim=1)
    return out, (aa_new, bb_new, pp_new)


def _wkv_scan(k, v, w, u, state, chunk=64):
    """k, v [B, S, C] of any length S -> (wkv [B, S, C], state)."""
    outs = []
    for s0 in range(0, k.shape[1], chunk):
        out, state = _wkv_chunk(k[:, s0:s0 + chunk], v[:, s0:s0 + chunk],
                                w, u, state)
        outs.append(out)
    return torch.cat(outs, dim=1), state


def _token_shift(xg, x_prev):
    """The x_{t-1} stream: shift right by one, x_prev fills position 0."""
    return torch.cat([x_prev[:, None, :], xg[:, :-1, :]], dim=1)


def _mix(h, prev, m):
    """``h * m + prev * (1 - m)`` in float32, back in h's dtype."""
    return (h.to(F32) * m + prev.to(F32) * (1 - m)).to(h.dtype)


def rwkv_fwd(p, x, ctx: Context):
    """Time-mix, then channel-mix.  x [B, S, D] -> (x', state in prefill
    mode else None, penalty, occupancy)."""
    cfg = ctx.cfg
    d = rwkv_dims(cfg)
    snn = cfg.hnn_mode == "snn" and ctx.codec.mode != "none"

    # ---- time-mix ----
    h = common.norm(x, p["ln1"], cfg.norm)
    pen, occ = _stats(h, p["sp_in"], ctx)
    xg = boundary.coded_all_gather(h, p["sp_in"], ctx.codec, axis=1)
    B, S, D = xg.shape
    xp = _token_shift(xg, torch.zeros((B, D), dtype=xg.dtype,
                                      device=xg.device))
    mk, mv, mr = p["mix_kvr"][0], p["mix_kvr"][1], p["mix_kvr"][2]
    kt = (_mix(xg, xp, mk) @ p["wk_tm"]).to(F32)
    vt = (_mix(xg, xp, mv) @ p["wv_tm"]).to(F32)
    rt = torch.sigmoid((_mix(xg, xp, mr) @ p["wr_tm"]).to(F32))
    w = -torch.exp(p["time_decay"])
    u = p["time_first"]
    z = dict(dtype=F32, device=x.device)
    state = (torch.zeros((B, d["C_loc"]), **z),
             torch.zeros((B, d["C_loc"]), **z),
             torch.full((B, d["C_loc"]), PP_INIT, **z))
    wkv, state = _wkv_scan(kt, vt, w, u, state)
    y = (rt * wkv).to(x.dtype)
    out1 = boundary.coded_psum_scatter(y @ p["wo_tm"], p["sp_out"],
                                       ctx.codec, axis=1)
    if snn:
        out1 = boundary._local_roundtrip(out1, p["sp_out"], ctx.codec)
    x = x + out1

    # ---- channel-mix ----
    h2 = common.norm(x, p["ln2"], cfg.norm)
    pen2, occ2 = _stats(h2, p["sp_in2"], ctx)
    xg2 = boundary.coded_all_gather(h2, p["sp_in2"], ctx.codec, axis=1)
    xp2 = _token_shift(xg2, torch.zeros((B, D), dtype=xg2.dtype,
                                        device=xg2.device))
    mk2, mr2 = p["mix_cm"][0], p["mix_cm"][1]
    kk = torch.square(torch.relu(_mix(xg2, xp2, mk2) @ p["wk_cm"]))
    rr = torch.sigmoid((_mix(xg2, xp2, mr2) @ p["wr_cm"]).to(F32)).to(
        x.dtype)
    out2 = boundary.coded_psum_scatter(kk @ p["wv_cm"], p["sp_out2"],
                                       ctx.codec, axis=1)
    if snn:
        out2 = boundary._local_roundtrip(out2, p["sp_out2"], ctx.codec)
    x = x + rr * out2
    cache = None
    if ctx.mode == "prefill":
        cache = {"x_tm": xg[:, -1].to(x.dtype), "x_cm": xg2[:, -1].to(x.dtype),
                 "aa": state[0], "bb": state[1], "pp": state[2]}
    if pen is not None:          # train mode: both blocks' statistics
        pen, occ = pen + pen2, occ * 0.5 + occ2 * 0.5
    return x, cache, pen, occ


def rwkv_decode_fwd(p, x, state, ctx: Context):
    """x [B, 1, D], state {x_tm, x_cm, aa, bb, pp} -> (x', new state).
    No SNN roundtrips here, as in the reference."""
    cfg = ctx.cfg
    h = common.norm(x, p["ln1"], cfg.norm)[:, 0]
    h = boundary.wire_roundtrip(h, p["sp_in"], ctx.codec)
    xp = state["x_tm"].to(F32)
    mk, mv, mr = p["mix_kvr"][0], p["mix_kvr"][1], p["mix_kvr"][2]
    kt = (_mix(h, xp, mk) @ p["wk_tm"]).to(F32)
    vt = (_mix(h, xp, mv) @ p["wv_tm"]).to(F32)
    rt = torch.sigmoid((_mix(h, xp, mr) @ p["wr_tm"]).to(F32))
    w = -torch.exp(p["time_decay"])
    u = p["time_first"]
    st, wkv = _wkv_step((state["aa"], state["bb"], state["pp"]), kt, vt, w,
                        u)
    y = (rt * wkv)[:, None, :].to(x.dtype)
    x = x + boundary.coded_psum(y @ p["wo_tm"], p["sp_out"], ctx.codec)

    h2 = common.norm(x, p["ln2"], cfg.norm)[:, 0]
    h2 = boundary.wire_roundtrip(h2, p["sp_in2"], ctx.codec)
    xp2 = state["x_cm"].to(F32)
    mk2, mr2 = p["mix_cm"][0], p["mix_cm"][1]
    kk = torch.square(torch.relu(_mix(h2, xp2, mk2) @ p["wk_cm"]))
    rr = torch.sigmoid((_mix(h2, xp2, mr2) @ p["wr_cm"]).to(F32)).to(x.dtype)
    out2 = boundary.coded_psum((kk @ p["wv_cm"])[:, None, :], p["sp_out2"],
                               ctx.codec)
    x = x + rr[:, None, :] * out2
    return x, {"x_tm": h.to(state["x_tm"].dtype),
               "x_cm": h2.to(state["x_cm"].dtype),
               "aa": st[0], "bb": st[1], "pp": st[2]}
