"""Parameter definitions and seeded initialisation.

Every parameter is described once by a ``ParamDef`` (global shape,
initialiser), as in ``repro.models.params``.  The defs tree has the
reference's structure and path names, so a JAX parameter tree carries
across leaf by leaf (``checkpoint.convert.params_from_jax``).  Sharding
fields (``tp_dim``/``fsdp_dim``) are kept for that correspondence; the
port places every leaf whole on one device.

``init_params`` draws from an explicit ``torch.Generator`` with the same
shapes, dtypes and distributions as the reference's ``_init_leaf`` —
not the same bits (torch's generator is not JAX's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    tp_dim: Optional[int] = None
    fsdp_dim: Optional[int] = None
    init: str = "normal"      # normal|zeros|ones|alog|theta|logscale|embed|dtbias|half
    scale: float = 0.02
    dtype: Any = None         # None -> cfg dtype


def pdef(*shape, tp=None, fsdp=None, init="normal", scale=0.02, dtype=None):
    return ParamDef(tuple(shape), tp, fsdp, init, scale, dtype)


def tree_map_defs(fn, defs):
    """Apply ``fn(path, def)`` to every ``ParamDef`` of a nested dict,
    in sorted key order (the reference's pytree flattening order)."""
    def rec(node, path):
        if isinstance(node, ParamDef):
            return fn(path, node)
        return {k: rec(node[k], path + (k,)) for k in sorted(node)}
    return rec(defs, ())


def stack_defs(defs, U: int):
    """Prepend the unit dim to every def in a tree of ParamDefs."""
    def f(_, d: ParamDef) -> ParamDef:
        tp = None if d.tp_dim is None else d.tp_dim + 1
        fs = None if d.fsdp_dim is None else d.fsdp_dim + 1
        return ParamDef((U,) + d.shape, tp, fs, d.init, d.scale, d.dtype)
    return tree_map_defs(f, defs)


def _init_leaf(d: ParamDef, gen: torch.Generator, dtype, device):
    dt = d.dtype or dtype
    f32 = torch.float32
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init in ("normal", "embed"):
        # scaled in place: a large leaf (a stacked expert weight) needs
        # no second float32 copy while it is drawn
        x = torch.randn(d.shape, generator=gen, dtype=f32, device=device)
        return x.mul_(d.scale).to(dt)
    if d.init == "alog":   # mamba A_log: log(1..N) per state row
        n = d.shape[-1]
        a = torch.arange(1, n + 1, dtype=f32, device=device)
        return torch.log(a).expand(d.shape).to(dt).clone()
    if d.init == "theta":  # spike firing gate
        return torch.full(d.shape, 0.01, dtype=f32, device=device)
    if d.init == "logscale":
        return torch.zeros(d.shape, dtype=f32, device=device)
    if d.init == "dtbias":  # mamba dt bias: softplus^-1 of ~0.01..0.1
        return torch.full(d.shape, -4.6, dtype=f32, device=device)
    if d.init == "half":
        return torch.full(d.shape, 0.5, dtype=f32, device=device)
    raise ValueError(d.init)


def init_params(defs, gen: torch.Generator, dtype=torch.bfloat16, *,
                device):
    """Materialise a defs tree into tensors on ``device``.  ``gen`` must
    be a generator of that device (``torch.Generator(device=device)``)."""
    return tree_map_defs(lambda _, d: _init_leaf(d, gen, dtype, device),
                         defs)


def spike_pdefs(dim: int):
    """Learnable boundary codec params for one boundary of width dim."""
    return {"theta": pdef(dim, init="theta", dtype=torch.float32),
            "log_scale": pdef(dim, init="logscale", dtype=torch.float32)}
