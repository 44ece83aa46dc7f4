"""Attention + dense-MLP blocks at tp = 1, with the coded boundaries.

The port of ``repro.models.blocks_attn`` for one device.  Every boundary
the reference puts on a collective (the gather into a block, the
reduce-scatter or psum out of it) still runs its codec here through the
world-size-1 collectives of ``core.boundary``, so the activations the
blocks see are the reference's.

Decode (one token per slot) and verify (K1 = spec_k + 1 tokens per
slot) attend over the serving engine's shared KV page pool: new K/V
rows are written through the block table (``_paged_kv_write``) and the
step attends either through the paged-decode kernel over the compacted
page lists (the fused walk) or by gathering the full block table
(``_paged_kv_gather``, the reference walk).  Without a block table a
decode step runs over the dense per-slot cache of the single-request
serve steps (``launch.serve``): ``cache[slot, pos]``, written only where
the position lies inside the cache (``_dense_kv_write``).  Unlike the
reference's functional updates, cache writes happen in place.

In SNN mode (``hnn_mode="snn"``) the block outputs of prefill and of
every MLP are spike-coded too (``_maybe_snn``).  The decode and verify
attention blocks apply no such roundtrip, as in the reference.
"""
from __future__ import annotations

import torch

from ..core import boundary
from ..kernels import ops as kops
from . import common
from .context import Context, pool_local_pages
from .params import pdef, spike_pdefs

F32 = torch.float32


# ---------------------------------------------------------------------------
# dims and parameter defs
# ---------------------------------------------------------------------------


def attn_dims(cfg, tp=1):
    dh = cfg.d_head
    Hkv = cfg.n_kv_heads
    if Hkv == cfg.n_heads:                      # MHA: pad both together
        Hq = cfg.padded(cfg.n_heads, tp)
        Hkv_p = Hq
        kv_rep = False
    else:
        Hq = cfg.padded(cfg.n_heads, tp)
        while Hq % Hkv != 0:
            Hq += tp
        Hkv_p = Hkv
        kv_rep = Hkv % tp != 0
    Hq_loc = Hq // tp
    Hkv_loc = Hkv_p if kv_rep else Hkv_p // tp
    return dict(dh=dh, Hq=Hq, Hq_loc=Hq_loc, Hkv=Hkv_p, Hkv_loc=Hkv_loc,
                kv_rep=kv_rep, group=Hq // Hkv_p)


def attn_defs(cfg, tp=1):
    d = attn_dims(cfg, tp)
    D, dh = cfg.d_model, d["dh"]
    kv_tp = None if d["kv_rep"] else 1
    defs = {
        "ln": pdef(D, init="zeros"),
        "wq": pdef(D, d["Hq"] * dh, tp=1, fsdp=0),
        "wk": pdef(D, d["Hkv"] * dh, tp=kv_tp, fsdp=0),
        "wv": pdef(D, d["Hkv"] * dh, tp=kv_tp, fsdp=0),
        "wo": pdef(d["Hq"] * dh, D, tp=0, fsdp=1),
        "sp_in": spike_pdefs(D),
        "sp_out": spike_pdefs(D),
    }
    if cfg.qkv_bias:
        defs["bq"] = pdef(d["Hq"] * dh, tp=0, init="zeros")
        defs["bk"] = pdef(d["Hkv"] * dh, tp=(None if d["kv_rep"] else 0),
                          init="zeros")
        defs["bv"] = pdef(d["Hkv"] * dh, tp=(None if d["kv_rep"] else 0),
                          init="zeros")
    if cfg.post_norm:
        defs["post_ln"] = pdef(D, init="zeros")
    if cfg.hnn_mode == "snn":
        defs["sp_snn"] = spike_pdefs(D)
    return defs


def mlp_defs(cfg, tp=1):
    D = cfg.d_model
    F = cfg.ff_padded(tp)
    defs = {
        "ln2": pdef(D, init="zeros"),
        "w1": pdef(D, F, tp=1, fsdp=0),
        "w3": pdef(D, F, tp=1, fsdp=0),
        "w2": pdef(F, D, tp=0, fsdp=1),
        "sp_in2": spike_pdefs(D),
        "sp_out2": spike_pdefs(D),
    }
    if cfg.post_norm:
        defs["post_ln2"] = pdef(D, init="zeros")
    if cfg.hnn_mode == "snn":
        defs["sp_snn2"] = spike_pdefs(D)
    return defs


def _rope(cfg, x, positions):
    if cfg.rope_kind == "rope":
        return common.apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope_kind == "none":
        return x
    raise NotImplementedError(f"rope_kind={cfg.rope_kind!r}: not ported")


def _consumers(ctx: Context, p, *names):
    """The weights that consume a boundary's decoded output, for the
    count matmul shadow; none unless ``ctx.count_matmul_shadow``."""
    return tuple(p[n] for n in names) if ctx.count_matmul_shadow else ()


def _maybe_snn(h, p_snn, ctx: Context):
    """SNN mode: intra-chip activations are spike-coded too (a local
    encode -> decode roundtrip); nothing under codec ``none``."""
    if ctx.cfg.hnn_mode != "snn" or ctx.codec.mode == "none":
        return h
    return boundary._local_roundtrip(h, p_snn, ctx.codec)


def _stats(h, p, ctx: Context):
    """The eq-10 penalty and occupancy (float32 scalars) of a block's
    gathered input in train mode (zeros without ``collect_stats``);
    ``(None, None)`` in prefill and decode, whose callers drop them, so
    a served step launches nothing for them."""
    if ctx.mode != "train":
        return None, None
    if ctx.collect_stats:
        pen, occ = boundary.boundary_penalty(h, p, ctx.codec)
        return pen.to(F32), occ.to(F32)
    z = torch.zeros((), dtype=F32, device=h.device)
    return z, z


# ---------------------------------------------------------------------------
# forward: train / prefill
# ---------------------------------------------------------------------------


def attn_fwd(p, x, ctx: Context, aux, kind="attn"):
    """x [B, S, D] -> (x', cache {k, v} [B, S, Hkv, dh] in prefill mode
    else None, penalty, occupancy)."""
    cfg = ctx.cfg
    d = attn_dims(cfg)
    dh = d["dh"]
    h = common.norm(x, p["ln"], cfg.norm)
    pen, occ = _stats(h, p["sp_in"], ctx)
    xg = boundary.coded_all_gather(
        h, p["sp_in"], ctx.codec, axis=1,
        consumers=_consumers(ctx, p, "wq", "wk", "wv"))
    B, S, _ = xg.shape
    q = xg @ p["wq"]
    k = xg @ p["wk"]
    v = xg @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, d["Hq"], dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    q = _rope(cfg, q, aux["positions"])
    k = _rope(cfg, k, aux["positions"])
    window = cfg.window if kind == "local" else 0
    out = common.flash_attention(
        q, k, v, causal=not ctx.is_encoder, window=window,
        cap=cfg.attn_softcap, q_chunk=min(512, S), kv_chunk=min(512, S))
    part = out.reshape(B, S, d["Hq"] * dh) @ p["wo"]
    y = boundary.coded_psum_scatter(part, p["sp_out"], ctx.codec, axis=1)
    y = _maybe_snn(y, p.get("sp_snn"), ctx)
    if cfg.post_norm:
        y = common.norm(y, p["post_ln"], cfg.norm)
    cache = {"k": k, "v": v} if ctx.mode == "prefill" else None
    return x + y, cache, pen, occ


def mlp_fwd(p, x, ctx: Context):
    """x [B, S, D] -> (x', penalty, occupancy)."""
    cfg = ctx.cfg
    h = common.norm(x, p["ln2"], cfg.norm)
    pen, occ = _stats(h, p["sp_in2"], ctx)
    if ctx.mode == "decode":
        # tokens replicated: roundtrip in, spike-accumulated psum out
        h = boundary.wire_roundtrip(h, p["sp_in2"], ctx.codec,
                                    consumers=_consumers(ctx, p, "w1", "w3"))
        hh = common.act_fn(h @ p["w1"], cfg.act) * (h @ p["w3"])
        y = boundary.coded_psum(hh @ p["w2"], p["sp_out2"], ctx.codec)
    else:
        xg = boundary.coded_all_gather(
            h, p["sp_in2"], ctx.codec, axis=1,
            consumers=_consumers(ctx, p, "w1", "w3"))
        hh = common.act_fn(xg @ p["w1"], cfg.act) * (xg @ p["w3"])
        y = boundary.coded_psum_scatter(hh @ p["w2"], p["sp_out2"],
                                        ctx.codec, axis=1)
    y = _maybe_snn(y, p.get("sp_snn2"), ctx)
    if cfg.post_norm:
        y = common.norm(y, p["post_ln2"], cfg.norm)
    return x + y, pen, occ


# ---------------------------------------------------------------------------
# paged KV: block-table indexed writes/gathers on the shared page pool
# ---------------------------------------------------------------------------


def paged_write_targets(bt, qpos, pages_local, page_size):
    """The (pool row, offset) each (slot, query) row writes, with no
    host sync.

    bt [B, PPS] int32 global page ids (-1 unmapped); qpos [B, K1]
    absolute write positions.  A write whose page is unmapped, not
    resident in this pool, or whose position lies past the block table
    is dropped, never clipped into a live page — so an evicted slot (bt
    row all -1) cannot corrupt a recycled page.  Torch has no dropping
    scatter, and selecting the kept rows (``nonzero``) would make the
    host wait for the device, so a dropped row writes into the sink:
    pool row ``pages_local``, one past the mapped pages, which no block
    table maps and no read touches.  The targets are the same for every
    layer of a step, so callers compute them once.  Returns ``(loc,
    off)``, the pool row and offset of each of the B * K1 rows.
    """
    PPS = bt.shape[1]
    pj = torch.div(qpos, page_size, rounding_mode="floor")
    g = torch.gather(bt, 1, pj.clamp(0, PPS - 1).long())
    loc, _ = pool_local_pages(g, 0, pages_local)   # pages_local if not ok
    loc = torch.where(pj < PPS, loc, pages_local)
    return loc.reshape(-1).long(), (qpos - pj * page_size).reshape(-1).long()


def _paged_kv_write(cache, bt, qpos, k_new, v_new, targets=None):
    """Write new KV rows [B, K1, Hkv, dh] through the block table into the
    pool {k, v} [P_loc + 1, psz, Hkv, dh] (the last row the sink), in
    place.  Targets outside the sink are unique (a slot's positions are
    distinct and live slots' pages are disjoint), so the writes need no
    ordering."""
    ck, cv = cache["k"], cache["v"]
    if targets is None:
        targets = paged_write_targets(bt, qpos, ck.shape[0] - 1, ck.shape[1])
    loc, off = targets
    ck[loc, off] = k_new.reshape(-1, *k_new.shape[2:]).to(ck.dtype)
    cv[loc, off] = v_new.reshape(-1, *v_new.shape[2:]).to(cv.dtype)
    return cache


def _dense_kv_write(cache, pos, k_new, v_new):
    """Write one new KV row per slot, [B, Hkv, dh], into the dense
    per-slot cache {k, v} [B, Ss, Hkv, dh] at ``cache[b, pos[b]]``, in
    place.  A position at or past the cache length (or negative) is not
    written: the slot's row at the clipped position is written back with
    its own value, as the reference's ``in_range`` / ``clip`` do, so no
    host sync selects the rows."""
    ck, cv = cache["k"], cache["v"]
    B, Ss = ck.shape[:2]
    bidx = torch.arange(B, device=ck.device)
    loc = pos.clamp(0, Ss - 1).long()
    sel = ((pos >= 0) & (pos < Ss))[:, None, None]
    ck[bidx, loc] = torch.where(sel, k_new.to(ck.dtype), ck[bidx, loc])
    cv[bidx, loc] = torch.where(sel, v_new.to(cv.dtype), cv[bidx, loc])
    return cache


def _paged_kv_gather(cache, bt):
    """Gather every slot's resident pages in position order.

    Returns (k [B, PPS*psz, Hkv, dh], v likewise, valid [B, PPS*psz]):
    entry i of the gathered sequence is absolute position i of the slot.
    Every non-resident entry gathers LOCAL PAGE 0 — one fixed row for all
    dead entries — and is masked by ``valid``.
    """
    ck, cv = cache["k"], cache["v"]
    P_loc, psz, Hkv, dh = ck.shape
    B, PPS = bt.shape
    loc, ok = pool_local_pages(bt, 0, P_loc)
    idx = torch.where(ok, loc, torch.zeros_like(loc)).long()
    kg = ck[idx].reshape(B, PPS * psz, Hkv, dh)
    vg = cv[idx].reshape(B, PPS * psz, Hkv, dh)
    return kg, vg, torch.repeat_interleave(ok, psz, dim=1)


def _combine_partials(o, lse, ctx: Context):
    """Combine of a flash partial; coded wire when the codec is.  Mode
    "none" is the plain fp LSE combine; every coded mode quantizes the
    partial to the per-token int8 wire (the kernel epilogue's contract)
    and combines through ``coded_combine_partials``."""
    if ctx.codec.mode == "none":
        return common.combine_decode_partials(o, lse)
    wire, scale = boundary.quantize_partial(o)
    return boundary.coded_combine_partials(wire, scale, lse, F32)


def _paged_attn_combined(q, cache, bt, page_list, qpos, ctx: Context,
                         window, cap):
    """Paged attention partial + combine, both cache walks.

    q [B, K1, Hq, dh]; qpos [B, K1].  ``page_list`` (the engine's
    compacted per-shard lists ``(clp, clo)``, each [B, 1, ppc]; None on
    the reference walk) selects the paged-decode kernel, with the int8
    wire encode fused into its epilogue under a coded codec.  The
    reference walk gathers the full block table and scores it with
    ``verify_attention_partial``.  Returns [B, K1, Hq, dh] f32.
    """
    coded = ctx.codec.mode != "none"
    if page_list is not None:
        clp, clo = page_list
        clp, clo = clp[:, 0], clo[:, 0]            # [B, ppc]
        if coded:
            wire, scale, lse = kops.paged_flash_decode(
                q, cache["k"], cache["v"], clp, clo, qpos,
                window=window, cap=cap, encode_wire=True)
            return boundary.coded_combine_partials(wire, scale, lse, F32)
        o, lse = kops.paged_flash_decode(q, cache["k"], cache["v"], clp,
                                         clo, qpos, window=window, cap=cap)
        return common.combine_decode_partials(o, lse)
    k_s, v_s, kv_valid = _paged_kv_gather(cache, bt)
    o, lse = common.verify_attention_partial(
        q, k_s, v_s, pos=qpos, shard_offset=0, window=window, cap=cap,
        kv_valid=kv_valid)
    return _combine_partials(o, lse, ctx)


# ---------------------------------------------------------------------------
# forward: decode and speculative verify over the paged pool
# ---------------------------------------------------------------------------


def attn_verify_fwd(p, x, cache, qpos, ctx: Context, aux, kind="attn"):
    """Batched K1-token step: x [B, K1, D] — per slot the last committed
    token followed by K1 - 1 drafts (a decode step is K1 = 1); qpos
    [B, K1] the queries' absolute positions (a slot's base position plus
    0..K1-1).  Two cache layouts, as in the reference:

      paged (serving engine): cache {k, v} [P_loc + 1, psz, Hkv, dh] —
        the pool and its sink row — written through
        ``aux["block_table"]``; ``aux["page_list"]`` selects the kernel
        walk; ``aux["kv_write"]`` may carry precomputed
        ``paged_write_targets``.  KV for all K1 positions lands in the
        pool before attention, so a rejected draft's rows stay behind
        the committed position (never attended) until the next step
        overwrites them;
      dense (no block table; decode only, K1 = 1): cache {k, v}
        [B, Ss, Hkv, dh], the single-request serve path's, written at
        ``cache[slot, pos]`` (``_dense_kv_write``) and attended by
        ``common.decode_attention_partial`` over every cache entry at
        or before the position.

    Returns (x', cache)."""
    cfg = ctx.cfg
    d = attn_dims(cfg)
    dh = d["dh"]
    B, K1, _ = x.shape
    bt = aux.get("block_table")
    if bt is None and K1 != 1:
        raise NotImplementedError(
            f"dense per-slot cache with K1 = {K1}: the port verifies over "
            "the paged pool only (pass aux['block_table'])")
    h = common.norm(x, p["ln"], cfg.norm)
    h = boundary.wire_roundtrip(h, p["sp_in"], ctx.codec,
                                consumers=_consumers(ctx, p, "wq", "wk", "wv"))
    q = h @ p["wq"]
    k_new = h @ p["wk"]
    v_new = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k_new = k_new + p["bk"]
        v_new = v_new + p["bv"]
    q = _rope(cfg, q.reshape(B, K1, d["Hq"], dh), qpos)
    k_new = _rope(cfg, k_new.reshape(B, K1, d["Hkv"], dh), qpos)
    v_new = v_new.reshape(B, K1, d["Hkv"], dh)
    window = cfg.window if kind == "local" else 0
    if bt is None:
        pos = qpos[:, 0]
        cache = _dense_kv_write(cache, pos, k_new[:, 0], v_new[:, 0])
        o, lse = common.decode_attention_partial(
            q[:, 0], cache["k"], cache["v"], pos=pos, shard_offset=0,
            window=window, cap=cfg.attn_softcap)
        o = _combine_partials(o, lse, ctx)[:, None]
    else:
        cache = _paged_kv_write(cache, bt, qpos, k_new, v_new,
                                aux.get("kv_write"))
        o = _paged_attn_combined(q, cache, bt, aux.get("page_list"), qpos,
                                 ctx, window, cfg.attn_softcap)
    part = o.reshape(B, K1, d["Hq"] * dh).to(x.dtype) @ p["wo"]
    y = boundary.coded_psum(part, p["sp_out"], ctx.codec)
    if cfg.post_norm:
        y = common.norm(y, p["post_ln"], cfg.norm)
    return x + y, cache

