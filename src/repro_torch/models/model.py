"""Full model: embedding -> layer units -> LM head, at tp = 1.

The port of ``repro.models.model``.  A block is a mixer, then an
optional FFN:

  attn / global / local : attention (``blocks_attn``), then a dense MLP
  attn_moe              : attention, then the MoE FFN (``blocks_moe``)
  mamba / mamba_mlp / mamba_moe : the selective SSM (``blocks_ssm``),
                          then nothing / the dense MLP / the MoE FFN
  mlstm / slstm / rwkv  : the recurrent blocks of ``blocks_rnn``, each
                          self-contained

Attention blocks keep K/V (``{"kv": {"k", "v"}}``); the others keep a
recurrent state of O(1) per slot under ``ssm_state`` / ``rnn_state`` /
``rwkv_state``, slot-major ([U, slots, ...]) in the serving engine's
cache as in the dense one.  Parameters are a nested dict of tensors with
the reference's structure: per-unit leaves carry a leading unit dim and
the forward passes loop over units (the reference scans them).

  forward_prefill : one right-padded prompt batch -> logits at the last
                    (or ``last_pos``) position + the prompt's KV and
                    recurrent states (recurrent families are prefilled
                    at the prompt's exact length: padding would fold
                    into the state)
  forward_decode  : one token per slot over the serving engine's paged
                    KV pool, or over the dense per-slot cache that
                    forward_prefill returns -> next-token logits (cache
                    updated in place)
  forward_verify  : K1 = spec_k + 1 tokens per slot over the paged pool
                    -> logits at every position (speculative decoding;
                    attention families only: a recurrent state cannot
                    roll a rejected draft back)
  forward_logits  : teacher-forced logits at every position of a token
                    batch (the reference's ``make_logits_step``)
  forward_loss    : the training forward: mean next-token NLL plus the
                    coded boundaries' eq-10 penalty, every block
                    rematerialised in the backward (``_ckpt``)
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from . import blocks_attn, blocks_moe, blocks_rnn, blocks_ssm, common
from .context import Context
from .params import pdef, spike_pdefs, stack_defs

F32 = torch.float32

ATTN_KINDS = ("attn", "global", "local", "attn_moe")
MAMBA_KINDS = ("mamba", "mamba_mlp", "mamba_moe")

#: kind -> (the cache key of its mixer's state, the mixer's train /
#: prefill forward, its decode step, its parameter defs, its per-slot
#: state leaves) for the recurrent mixers
_RECURRENT = {
    **{k: ("ssm_state", blocks_ssm.mamba_fwd, blocks_ssm.mamba_decode_fwd,
           blocks_ssm.mamba_defs, blocks_ssm.mamba_state_shapes)
       for k in MAMBA_KINDS},
    "mlstm": ("rnn_state", blocks_rnn.mlstm_fwd, blocks_rnn.mlstm_decode_fwd,
              blocks_rnn.mlstm_defs, blocks_rnn.mlstm_state_shapes),
    "slstm": ("rnn_state", blocks_rnn.slstm_fwd, blocks_rnn.slstm_decode_fwd,
              blocks_rnn.slstm_defs, blocks_rnn.slstm_state_shapes),
    "rwkv": ("rwkv_state", blocks_rnn.rwkv_fwd, blocks_rnn.rwkv_decode_fwd,
             blocks_rnn.rwkv_defs, blocks_rnn.rwkv_state_shapes),
}

#: the cache keys of recurrent state (the reference's
#: ``_RECURRENT_CACHE_KEYS``)
STATE_KEYS = ("ssm_state", "rnn_state", "rwkv_state")

#: every block kind of the reference but the encoder-decoder's
BLOCK_KINDS = ATTN_KINDS + tuple(_RECURRENT)

#: kind -> its FFN after the mixer: the dense MLP, the MoE FFN or none
_FFN = {"attn": "mlp", "global": "mlp", "local": "mlp", "attn_moe": "moe",
        "mamba_mlp": "mlp", "mamba_moe": "moe"}


def _block_defs(cfg, kind):
    if kind not in BLOCK_KINDS:
        raise NotImplementedError(f"block kind {kind!r}: not ported yet")
    defs = (blocks_attn.attn_defs(cfg) if kind in ATTN_KINDS
            else _RECURRENT[kind][3](cfg))
    ffn = _FFN.get(kind)
    if ffn == "mlp":
        defs = {**defs, **blocks_attn.mlp_defs(cfg)}
    elif ffn == "moe":
        defs = {**defs, **blocks_moe.moe_defs(cfg)}
    return defs


def is_recurrent(cfg) -> bool:
    """True iff some block of ``cfg`` carries a recurrent state."""
    return any(k in _RECURRENT for k in cfg.pattern)


def state_shapes(cfg, kind):
    """``(cache key, {leaf: (per-slot shape, dtype)})`` of a recurrent
    block kind's state, or None for an attention kind."""
    if kind not in _RECURRENT:
        return None
    return _RECURRENT[kind][0], _RECURRENT[kind][4](cfg)


def ffn_fwd(p, x, ctx: Context, kind):
    """The FFN after a block's mixer: x -> (x', penalty, occupancy); the
    identity (with no statistics) for a self-contained block."""
    ffn = _FFN.get(kind)
    if ffn == "moe":
        return blocks_moe.moe_fwd(p, x, ctx)
    if ffn == "mlp":
        return blocks_attn.mlp_fwd(p, x, ctx)
    return x, None, None


def mixer_fwd(p, x, ctx: Context, aux, kind):
    """A block's mixer in train / prefill mode: x -> (x', (cache key,
    cache) in prefill mode else None, penalty, occupancy)."""
    if kind in ATTN_KINDS:
        x, kv, pe, oc = blocks_attn.attn_fwd(p, x, ctx, aux, kind=kind)
        return x, ("kv", kv), pe, oc
    key, fwd = _RECURRENT[kind][:2]
    x, st, pe, oc = fwd(p, x, ctx)
    return x, (key, st), pe, oc


def model_defs(cfg: ModelConfig, tp: int = 1):
    if tp != 1:
        raise NotImplementedError("the port builds tp=1 parameters only")
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models: not ported yet")
    D = cfg.d_model
    Vp = cfg.vocab_padded(tp)
    defs: dict[str, Any] = {
        "embed": pdef(Vp, D, tp=0, fsdp=1, init="embed"),
        "final_ln": pdef(D, init="zeros"),
        "sp_embed": spike_pdefs(D),
        "sp_head": spike_pdefs(D),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = pdef(D, Vp, tp=1, fsdp=0)
    unit = {f"pos{i}": _block_defs(cfg, kind)
            for i, kind in enumerate(cfg.pattern)}
    defs["units"] = stack_defs(unit, cfg.n_units)
    return defs


def unit_slice(tree, u: int):
    """The per-unit view ``tree[...][u]`` of a unit-stacked tree."""
    if isinstance(tree, dict):
        return {k: unit_slice(v, u) for k, v in tree.items()}
    return tree[u]


def _head_w(p, cfg):
    if cfg.tie_embeddings:
        return p["embed"].T.to(cfg.dtype)
    return p["lm_head"]


def embed_tokens(p, tokens):
    """tokens [...] -> embeddings [..., D] (vocab unsharded at tp=1)."""
    return p["embed"][tokens.long()]


def lm_logits_local(p, x, ctx: Context):
    """x [B, S, D] -> logits [B, S, V] f32 (tp=1: no head boundary)."""
    cfg = ctx.cfg
    h = common.norm(x, p["final_ln"], cfg.norm)
    return (h @ _head_w(p, cfg)).to(F32)


def forward_prefill(params, tokens, ctx: Context, last_pos=None):
    """Prefill a [B, S] right-padded token batch.

    ``last_pos`` (optional [B] int tensor): per-sequence index of the
    last real prompt token; defaults to the final position.  Returns
    (logits [B, V] f32, caches): ``{"posI": {"kv": {"k", "v"}}}`` with
    leaves [U, B, S, Hkv, dh] at attention positions, and the state
    leaves [U, B, ...] under ``ssm_state`` / ``rnn_state`` /
    ``rwkv_state`` at recurrent ones.
    """
    cfg = ctx.cfg
    ctx = ctx.with_(mode="prefill")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    aux = {"positions": positions}
    x = embed_tokens(params, tokens)
    per_unit = []
    for u in range(cfg.n_units):
        unit_p = unit_slice(params["units"], u)
        caches = {}
        for i, kind in enumerate(cfg.pattern):
            p = unit_p[f"pos{i}"]
            x, (key, c), _, _ = mixer_fwd(p, x, ctx, aux, kind)
            x, _, _ = ffn_fwd(p, x, ctx, kind)
            caches[f"pos{i}"] = {key: c}
        per_unit.append(caches)
    caches = {}
    for i in range(len(cfg.pattern)):
        (key, first), = per_unit[0][f"pos{i}"].items()
        caches[f"pos{i}"] = {key: {
            n: torch.stack([c[f"pos{i}"][key][n] for c in per_unit])
            for n in first}}
    last = common.norm(x, params["final_ln"], cfg.norm)
    if last_pos is not None:
        lidx = last_pos.long().reshape(-1).expand(B) % S
        x_last = last[torch.arange(B, device=last.device), lidx]
    else:
        x_last = last[:, -1]
    logits = (x_last @ _head_w(params, cfg)).to(F32)
    if cfg.final_softcap:
        logits = common.softcap(logits, cfg.final_softcap)
    return logits, caches


def forward_logits(params, tokens, ctx: Context):
    """Teacher-forced logits of a [B, S] token batch at every position:
    [B, S, V] f32, through the training path's coded boundaries (mode
    ``train``) with no loss reduction and no cache, as the reference's
    ``launch.serve.make_logits_step`` computes them.  Like the
    reference's ``lm_logits_local`` it applies no ``final_softcap``."""
    cfg = ctx.cfg
    ctx = ctx.with_(mode="train", collect_stats=False)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    aux = {"positions": positions}
    x = embed_tokens(params, tokens)
    for u in range(cfg.n_units):
        unit_p = unit_slice(params["units"], u)
        for i, kind in enumerate(cfg.pattern):
            p = unit_p[f"pos{i}"]
            x, _, _, _ = mixer_fwd(p, x, ctx, aux, kind)
            x, _, _ = ffn_fwd(p, x, ctx, kind)
    return lm_logits_local(params, x, ctx)


def _forward_steps(params, cache, tokens, qpos, ctx: Context, aux_extra):
    """K1 tokens per slot: tokens [B, K1] int at absolute positions qpos
    [B, K1] -> logits [B, K1, V] f32.  Attention runs over the paged KV
    pool when ``aux_extra`` carries a ``"block_table"``, else over the
    dense per-slot cache (K1 = 1); the new K/V rows are written in
    place.  A recurrent block (K1 = 1) steps its slot-major state, which
    is overwritten in place with the new state."""
    cfg = ctx.cfg
    ctx = ctx.with_(mode="decode")
    aux = dict(aux_extra or {})
    x = embed_tokens(params, tokens).to(cfg.dtype)
    attn_pos = [i for i, k in enumerate(cfg.pattern) if k in ATTN_KINDS]
    if aux.get("block_table") is not None and attn_pos:
        kv0 = cache[f"pos{attn_pos[0]}"]["kv"]["k"]
        aux["kv_write"] = blocks_attn.paged_write_targets(
            aux["block_table"], qpos, kv0.shape[1] - 1, kv0.shape[2])
    for u in range(cfg.n_units):
        unit_p = unit_slice(params["units"], u)
        for i, kind in enumerate(cfg.pattern):
            p = unit_p[f"pos{i}"]
            if kind in ATTN_KINDS:
                kv = cache[f"pos{i}"]["kv"]
                kv_u = {"k": kv["k"][u], "v": kv["v"][u]}
                x, _ = blocks_attn.attn_verify_fwd(p, x, kv_u, qpos, ctx,
                                                   aux, kind=kind)
            else:
                key, _, step = _RECURRENT[kind][:3]
                st = cache[f"pos{i}"][key]
                x, new = step(p, x, {n: v[u] for n, v in st.items()}, ctx)
                for n, v in st.items():
                    v[u].copy_(new[n])
            x, _, _ = ffn_fwd(p, x, ctx, kind)
    h = common.norm(x, params["final_ln"], cfg.norm)
    logits = (h @ _head_w(params, cfg)).to(F32)
    if cfg.final_softcap:
        logits = common.softcap(logits, cfg.final_softcap)
    return logits


def forward_decode(params, cache, token, pos, ctx: Context, aux_extra=None):
    """One decode step.

    token [B] int; pos an int, a 0-d tensor or [B] per-slot positions.
    Two cache layouts, as in the reference:

      paged (serving engine): ``aux_extra`` carries ``"block_table"``
        [B, PPS] and, for the kernel walk, ``"page_list"`` ``(clp,
        clo)`` [B, 1, ppc]; cache ``{"posI": {"kv": {"k", "v"}}}`` pool
        leaves [U, P, psz, Hkv, dh];
      dense (single-request serve path, no block table): the same tree
        with leaves [U, B, S, Hkv, dh], as ``forward_prefill`` returns
        it; slot b writes ``cache[:, b, pos[b]]`` if ``pos[b] < S`` and
        attends to every entry at or before ``pos[b]``.

    The new K/V rows are written in place.  Returns (logits [B, V] f32,
    cache).
    """
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device).reshape(-1).expand(B)
    logits = _forward_steps(params, cache, token[:, None], pos[:, None],
                            ctx, aux_extra)
    return logits[:, 0], cache


def forward_verify(params, cache, tokens, pos, ctx: Context, aux_extra=None,
                   return_hidden=False):
    """Batched speculative-verify step: score K1 = spec_k + 1 positions of
    every slot in one forward — the decode-boundary traffic of K1 steps
    through one set of coded boundaries.

    tokens [B, K1] int — per slot the last committed token followed by
    spec_k drafts; pos [B] the base position of each slot's first token.
    KV for position pos + j is written for every j through
    ``aux_extra["block_table"]`` (the scheduler must have mapped pages
    covering pos..pos+K1-1); acceptance and the page-exact rollback of
    rejected positions are the scheduler's.  ``aux_extra`` is that of
    ``forward_decode``.  Returns (logits [B, K1, V] f32, cache);
    logits[:, j] condition on tokens[:, :j+1].  ``return_hidden`` (the
    final hidden the learned draft heads read) is not ported.
    """
    if return_hidden:
        raise NotImplementedError(
            "forward_verify(return_hidden=True): the learned draft heads "
            "are not ported yet")
    if is_recurrent(ctx.cfg):
        raise NotImplementedError(
            f"verify step over the recurrent blocks of {ctx.cfg.pattern}: "
            "their state cannot roll back rejected drafts (the engine "
            "falls back to spec_k=0)")
    B, K1 = tokens.shape
    pos = pos.reshape(-1).expand(B)
    qpos = pos[:, None] + torch.arange(K1, dtype=pos.dtype,
                                       device=pos.device)[None, :]
    return _forward_steps(params, cache, tokens, qpos, ctx, aux_extra), cache


# ---------------------------------------------------------------------------
# training: the stack with its statistics, the LM loss, forward_loss
# ---------------------------------------------------------------------------


def _ckpt(fn, ctx: Context):
    """Per-block rematerialisation in train mode (the reference's
    ``jax.checkpoint``): the backward recomputes one block at a time
    instead of holding every block's activations."""
    if ctx.mode != "train" or not torch.is_grad_enabled():
        return fn
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False)


def _run_stack(params, x, ctx: Context, aux):
    """Every unit in train mode -> (x, penalty sum, occupancy mean): the
    occupancy averages a unit's blocks, then the units, in the
    reference's order of sums."""
    cfg = ctx.cfg
    pen = torch.zeros((), dtype=F32, device=x.device)
    occ = torch.zeros((), dtype=F32, device=x.device)
    for u in range(cfg.n_units):
        unit_p = unit_slice(params["units"], u)
        pe_u = torch.zeros((), dtype=F32, device=x.device)
        oc_u = torch.zeros((), dtype=F32, device=x.device)
        n = 0
        for i, kind in enumerate(cfg.pattern):
            p = unit_p[f"pos{i}"]
            x, _, pe, oc = _ckpt(
                lambda p_, x_, k=kind: mixer_fwd(p_, x_, ctx, aux, k), ctx)(
                    p, x)
            pe_u, oc_u, n = pe_u + pe, oc_u + oc, n + 1
            if kind in _FFN:
                x, pe, oc = _ckpt(
                    lambda p_, x_, k=kind: ffn_fwd(p_, x_, ctx, k), ctx)(p, x)
                pe_u, oc_u, n = pe_u + pe, oc_u + oc, n + 1
        pen = pen + pe_u
        occ = occ + (oc_u / max(n, 1)) / cfg.n_units
    return x, pen, occ


def _nll(logits, labels, mask=None):
    """Mean next-token NLL of f32 logits [B, S, V] (over ``mask`` where
    given)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def lm_loss_chunked(p, x, labels, ctx: Context, mask=None):
    """Final norm -> head -> cross-entropy at tp = 1 (the reference's
    tp = 1 branch: no head boundary, no chunking).  Returns (mean NLL,
    penalty 0)."""
    cfg = ctx.cfg
    h = common.norm(x, p["final_ln"], cfg.norm)
    logits = (h @ _head_w(p, cfg)).to(F32)
    if cfg.final_softcap:
        logits = common.softcap(logits, cfg.final_softcap)
    return _nll(logits, labels, mask), torch.zeros((), dtype=F32,
                                                   device=x.device)


def xent_loss(logits, labels, ctx: Context, mask=None):
    """Cross-entropy of logits [B, S, V] at tp = 1 -> mean NLL over the
    tokens (``final_softcap`` applied first)."""
    if ctx.cfg.final_softcap:
        logits = common.softcap(logits, ctx.cfg.final_softcap)
    return _nll(logits, labels, mask)


def forward_loss(params, batch, ctx: Context):
    """Training forward.  batch: ``tokens`` / ``labels`` [B, S] int
    tensors (+ optional ``mask``).  Returns (loss, metrics): the loss is
    the mean NLL plus every boundary's eq-10 penalty; metrics are the
    NLL (``loss``), the ``penalty`` and the mean ``occupancy``."""
    cfg = ctx.cfg
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder training: not ported")
    tokens = batch["tokens"]
    B, S = tokens.shape
    aux = {"positions": torch.arange(S, device=tokens.device)[None]
           .expand(B, S)}
    x = embed_tokens(params, tokens)
    x, pen, occ = _run_stack(params, x, ctx, aux)
    loss_ce, pen_h = lm_loss_chunked(params, x, batch["labels"], ctx,
                                     mask=batch.get("mask"))
    pen_total = torch.zeros((), dtype=F32, device=x.device) + pen + pen_h
    loss = loss_ce + pen_total
    return loss, {"loss": loss_ce, "penalty": pen_total, "occupancy": occ}
