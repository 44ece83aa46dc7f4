"""Carry the JAX reference's parameters into the port.

The JAX package's parameter tree, handed over as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), is flattened to the path
strings its checkpoint manifest uses (``repro.checkpoint.manager.
_tree_paths``: ``jax.tree_util.keystr`` of each dict path, such as
``"['units']['pos0']['wq']"``) and matched leaf for leaf against the
port's parameter defs.  A missing, extra or mis-shaped leaf raises.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..models.model import model_defs
from ..models.params import ParamDef, tree_map_defs


def keystr(path) -> str:
    """The JAX ``keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def tree_paths(tree, prefix=()):
    """``[(path string, leaf)]`` of nested dicts, tuples and lists, in the
    reference's flattening order (dict keys sorted, sequences in
    order)."""
    if isinstance(tree, Mapping):
        return [item for k in sorted(tree)
                for item in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree)
                for item in tree_paths(v, prefix + (i,))]
    return [(keystr(prefix), tree)]


def params_from_jax(np_tree, cfg, *, device=None):
    """JAX parameters as a nested dict of numpy arrays -> the port's
    parameter tree of tensors on ``device`` (None -> ``cuda``).

    Each leaf takes its def's dtype (the config's where the def names
    none), as the reference's init does.  Raises ``KeyError`` on a missing or extra
    path and ``ValueError`` on a shape mismatch.
    """
    device = torch.device("cuda" if device is None else device)
    defs = model_defs(cfg)
    want = {}
    tree_map_defs(lambda p, d: want.__setitem__(keystr(p), d), defs)
    have = dict(tree_paths(np_tree))
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    if missing or extra:
        raise KeyError(f"params_from_jax: missing {missing}, extra {extra}")

    def convert(path, d: ParamDef):
        arr = np.asarray(have[keystr(path)])
        if tuple(arr.shape) != tuple(d.shape):
            raise ValueError(f"params_from_jax: {keystr(path)} has shape "
                             f"{tuple(arr.shape)}, expected {d.shape}")
        dt = d.dtype or cfg.dtype
        if arr.dtype.name == "bfloat16":     # ml_dtypes bf16: via f32
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=dt)
        return torch.tensor(arr, device=device).to(dt)

    return tree_map_defs(convert, defs)
