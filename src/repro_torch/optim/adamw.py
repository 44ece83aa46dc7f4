"""AdamW with warmup-cosine schedule and global-norm clipping.

The port of ``repro.optim.adamw``.  Parameters and optimizer state are
nested dicts of tensors: float32 moments ``m`` and ``v`` shaped like the
parameters and an int32 step ``count``.  Decoupled weight decay applies
to leaves of two or more dims only.  ``apply_updates`` returns new
tensors and changes none it was given.
"""
from __future__ import annotations

import dataclasses
import math

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_opt_state(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)  # noqa: E731
    dev = next(iter(tree_leaves(params))).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def tree_leaves(tree):
    """The leaves of nested dicts, keys sorted (the reference's
    flattening order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def schedule(cfg: AdamWConfig, step):
    """Learning rate at ``step`` (an integer tensor): linear warmup, then
    a cosine down to ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def apply_updates(params, grads, opt_state, *, gnorm=None,
                  cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step -> (new params, new state).  ``gnorm`` (the global
    gradient norm, a tensor) clips the gradients to ``clip_norm``."""
    count = opt_state["count"] + 1
    lr = schedule(cfg, count)
    if gnorm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = 1.0
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** count.to(F32)
    bc2 = 1 - b2 ** count.to(F32)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mh = m2 / bc1
        vh = v2 / bc2
        step = mh / (torch.sqrt(vh) + cfg.eps)
        if p.ndim >= 2:                  # decay matrices only
            step = step + cfg.weight_decay * p.to(F32)
        p2 = p.to(F32) - lr * step
        return p2.to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}
