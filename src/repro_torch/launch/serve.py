"""Serving steps: prefill (fills the dense per-slot cache) and decode.

The port of ``repro.launch.serve`` at world size 1.  The reference
builds each step from a cell plan and a mesh and returns it jitted
under ``shard_map``; with one device there is nothing to shard, so each
builder here takes the config and the device the step runs on, and
returns a plain callable with the reference step's arguments and
results.  These are the single-request building blocks (the quickstart
sequence: prefill a [B, S] batch, then greedy decode steps against its
cache); the batched continuous-batching engine lives in
``repro_torch.serving``.

Every step runs on ``device``: None means the current CUDA device, and
raises when there is no card (pass ``device="cpu"`` for the plain
PyTorch path).  The parameters and inputs must already lie there.
"""
from __future__ import annotations

import torch

from ..models import model as M
from ..models.context import make_context
from ..serving.engine import resolve_device


def _on(device, *tensors):
    for t in tensors:
        if torch.is_tensor(t) and t.device != device:
            raise ValueError(f"an input lies on {t.device}, the step runs "
                             f"on {device}")


def make_prefill_step(cfg, device=None):
    """prefill(params, batch) -> (last_logits [B, V] f32, cache).

    ``batch["tokens"]`` [B, S] int; the cache is ``{"posI": {"kv": {"k",
    "v"}}}`` with leaves [U, B, S, Hkv, dh] at attention positions and
    the recurrent state (``ssm_state`` / ``rnn_state`` / ``rwkv_state``
    leaves [U, B, ...]) at the others: the dense per-slot layout
    ``make_decode_step`` takes."""
    dev = resolve_device(device)
    ctx = make_context(cfg, "prefill")

    def prefill(params, batch):
        tokens = batch["tokens"]
        _on(dev, params["embed"], tokens)
        return M.forward_prefill(params, tokens, ctx)

    return prefill


def make_decode_step(cfg, device=None):
    """decode(params, cache, token, pos) -> (logits [B, V] f32, cache).

    token [B] int; pos an int, a 0-d tensor or [B] per-slot positions;
    cache the dense per-slot cache of ``make_prefill_step``.  Slot b
    writes its new K/V row at ``pos[b]`` only when that lies inside the
    cache, and attends to every entry at or before it; a recurrent
    block steps slot b's state.  The reference
    donates the cache to its step; here it is updated in place and
    returned.  The reference's ``replicate_weights`` knob has no
    counterpart: at world size 1 there are no data axes to replicate the
    weights over, so it would be a no-op."""
    dev = resolve_device(device)
    ctx = make_context(cfg, "decode")

    def decode(params, cache, token, pos):
        _on(dev, params["embed"], token, pos)
        return M.forward_decode(params, cache, token, pos, ctx)

    return decode


def make_logits_step(cfg, device=None):
    """logits(params, batch) -> [B, S, V] float32: full-sequence
    teacher-forced logits through the training path's coded boundaries,
    no loss reduction (parity / eval harness).  As in the reference, no
    ``final_softcap`` is applied."""
    dev = resolve_device(device)
    ctx = make_context(cfg, "train")

    def logits(params, batch):
        tokens = batch["tokens"]
        _on(dev, params["embed"], tokens)
        return M.forward_logits(params, tokens, ctx)

    return logits


def greedy_sample(logits):
    """Greedy next token of logits [B, V]: int32 ids, the lowest on
    ties (example-driver helper; the engine samples through
    ``serving.sampling``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
