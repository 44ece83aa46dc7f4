"""Per-device model math: norms, rotary embeddings, attention.

The port of ``repro.models.common``.  Prefill attention is plain tensor
code in the reference too (an online-softmax loop over q/kv chunks,
never an S x S matrix per chunk pair beyond the chunk), so plain torch
ops are the port.  SDPA is not used: it has no logit softcap.  The
``-1e30`` masking sentinel and the ``1e-30`` normaliser floors are kept
exactly, because the paged-decode kernel and its oracle agree on them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32

# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    h = x.to(F32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * (1.0 + scale.to(F32))).to(x.dtype)


def layer_norm(x, scale, bias=None, eps=1e-5):
    h = x.to(F32)
    mu = torch.mean(h, dim=-1, keepdim=True)
    # jnp.var is the population variance: no Bessel correction
    var = torch.var(h, dim=-1, keepdim=True, correction=0)
    h = (h - mu) * torch.rsqrt(var + eps)
    h = h * (1.0 + scale.to(F32))
    if bias is not None:
        h = h + bias.to(F32)
    return h.to(x.dtype)


def norm(x, scale, kind="rmsnorm"):
    return rms_norm(x, scale) if kind == "rmsnorm" else layer_norm(x, scale)


def act_fn(x, kind="silu"):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def softcap(x, cap):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=F32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta=1e4):
    """x [B, S, H, dh]; positions [B, S] (int)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                    # [dh/2]
    ang = positions.to(F32)[..., None] * inv                 # [B, S, dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked (flash) attention for prefill — causal/window, GQA, softcap
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                    q_chunk=512, kv_chunk=512, q_offset=0):
    """Online-softmax attention, chunk for chunk as the reference.

    q [B, Sq, Hq, dh]; k, v [B, Skv, Hkv, dh]; Hq % Hkv == 0 (GQA).
    Returns [B, Sq, Hq, dh] in q's dtype.
    """
    B, Sq, Hq, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(dh)
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    if Sq % qc or Skv % kc:
        raise ValueError(f"seq lengths {Sq}/{Skv} not multiples of the "
                         f"chunks {qc}/{kc}")
    nq, nk = Sq // qc, Skv // kc
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * qc:(qi + 1) * qc].to(F32)          # [B,qc,Hq,dh]
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, Hq, qc), -1e30, dtype=F32, device=dev)
        l = torch.zeros((B, Hq, qc), dtype=F32, device=dev)
        o = torch.zeros((B, Hq, qc, dh), dtype=F32, device=dev)
        for kj in range(nk):
            kb = k[:, kj * kc:(kj + 1) * kc].to(F32)
            vb = v[:, kj * kc:(kj + 1) * kc].to(F32)
            k_pos = kj * kc + torch.arange(kc, device=dev)
            if Hkv != Hq:
                kb = torch.repeat_interleave(kb, g, dim=2)
                vb = torch.repeat_interleave(vb, g, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, kb) * scale
            s = softcap(s, cap)
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(mask[None, None], s,
                            torch.full_like(s, -1e30))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
            m = m_new
        out = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 2, 1, 3))                 # [B,qc,Hq,dh]
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention partials (paged reference walk) and their combine
# ---------------------------------------------------------------------------


def decode_attention_partial(q, k_shard, v_shard, *, pos, shard_offset,
                             window=0, cap=0.0, kv_valid=None):
    """One decode step over a shard of the KV cache: the K1 = 1 case of
    ``verify_attention_partial``, as the reference builds it, so a
    decode step and a verify step share one copy of the masking and
    softmax math.

    q [B, Hq, dh]; k_shard/v_shard [B, Ss, Hkv, dh]; pos the current
    absolute position (an int, a 0-d tensor or [B] per-slot positions).
    Returns (out [B, Hq, dh] locally normalised, lse [B, Hq]).
    """
    B = q.shape[0]
    posb = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    o, lse = verify_attention_partial(
        q[:, None], k_shard, v_shard, pos=posb[:, None],
        shard_offset=shard_offset, window=window, cap=cap,
        kv_valid=kv_valid)
    return o[:, 0], lse[:, 0]


def verify_attention_partial(q, k_shard, v_shard, *, pos, shard_offset,
                             window=0, cap=0.0, kv_valid=None):
    """K1-token attention step over a shard of the KV cache.

    q [B, K1, Hq, dh]; k_shard/v_shard [B, Ss, Hkv, dh]; pos [B, K1]
    absolute per-query positions; ``kv_valid`` (optional [B, Ss] bool)
    masks entries that are not this slot's data.  Returns (out [B, K1,
    Hq, dh] locally normalised, lse [B, K1, Hq]).
    """
    B, K1, Hq, dh = q.shape
    _, Ss, Hkv, _ = k_shard.shape
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(dh)
    kb = k_shard.to(F32)
    vb = v_shard.to(F32)
    if Hkv != Hq:
        kb = torch.repeat_interleave(kb, g, dim=2)
        vb = torch.repeat_interleave(vb, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bqhk", q.to(F32), kb) * scale
    s = softcap(s, cap)
    k_pos = shard_offset + torch.arange(Ss, device=q.device)
    posb = pos[:, :, None, None]                              # [B,K1,1,1]
    mask = k_pos[None, None, None, :] <= posb
    if window:
        mask &= (posb - k_pos[None, None, None, :]) < window
    if kv_valid is not None:
        mask &= kv_valid[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bqhk,bkhd->bqhd", p, vb)
    o = o / torch.clamp(l[..., None], min=1e-30)              # locally normalised
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o, lse


def combine_decode_partials(o_norm, lse, world_size: int = 1):
    """LSE-weighted combination of locally normalised decode partials
    (the plain-fp path, codec "none"), over one shard."""
    if world_size != 1:
        raise NotImplementedError(
            "partial combine over several shards: not ported yet")
    m = lse                                          # pmax over one shard
    w = torch.exp(lse - m)
    o_sum = o_norm * w[..., None]
    l_sum = w
    return o_sum / torch.clamp(l_sum[..., None], min=1e-30)
