"""Next-token sampling from the decode logits, on the device.

The port of ``repro.serving.sampling`` at tp = 1.  This slice serves
greedy decoding only: the argmax over the vocabulary, lowest id on ties
(as ``jnp.argmax``).  Temperature, top-k and top-p sampling raise
``NotImplementedError`` until they are ported.
"""
from __future__ import annotations

import torch


def dist_argmax(vals):
    """Argmax over the (unsharded) last axis -> int32 ids."""
    return torch.argmax(vals, dim=-1).to(torch.int32)


def sample(logits, temps):
    """Next tokens [B] from logits [B, V]; ``temps`` [B] host floats, 0 =
    greedy.  Only greedy is ported."""
    if bool((torch.as_tensor(temps) > 0).any()):
        raise NotImplementedError(
            "temperature sampling: not ported yet (greedy only)")
    return dist_argmax(logits.to(torch.float32))
