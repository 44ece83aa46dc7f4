"""Shared helpers of the recurrent blocks' tests (``test_torch_rnn.py``,
``test_torch_ssm.py``): one block of the port and of the JAX reference
on the same numpy-seeded parameters and inputs.

The reference's blocks gather their input and scatter their output
over the tensor-parallel axis, so the JAX side runs each block under
``shard_map`` on a 1x1 mesh (every input and output replicated), as
the model does.  Every parameter leaf is seeded: weights as their
init's normal draws (numpy), the leaves the init holds constant (norm
scales, RWKV's decays, bonuses and mixes, mamba's dt bias, A and skip)
at their init value plus 0.3 x standard normal.  ANN mode (codec
``none``), float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeCell  # noqa: E402
from repro.configs.reduced import reduced as jax_reduced  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models.context import make_context  # noqa: E402
from repro_torch.models.params import ParamDef, tree_map_defs  # noqa: E402

MESH = make_mesh((1, 1), ("data", "model"))
_BASE = {"zeros": 0.0, "ones": 1.0, "half": 0.5, "dtbias": -4.6}


def configs(arch, overrides=None):
    """(JAX config, port config) of the reduced ``arch`` in ANN f32."""
    over = dict(overrides or {})
    jcfg = jax_reduced(jax_get_config(arch, hnn_mode="ann")).replace(
        codec="none", dtype=jnp.float32, **over)
    tcfg = reduced(get_config(arch, hnn_mode="ann")).replace(
        codec="none", dtype=torch.float32, **over)
    return jcfg, tcfg


def block_params(defs, seed=0):
    """numpy values of a block's defs, every leaf seeded."""
    rng = np.random.RandomState(seed)

    def leaf(_, d: ParamDef):
        noise = rng.standard_normal(d.shape)
        if d.init in ("normal", "embed"):
            v = noise * d.scale
        elif d.init == "theta":
            v = np.full(d.shape, 0.01)
        elif d.init == "logscale":
            v = np.zeros(d.shape)
        elif d.init == "alog":
            v = np.log(np.arange(1, d.shape[-1] + 1)) + 0.3 * noise
        else:
            v = _BASE[d.init] + 0.3 * noise
        return v.astype(np.float32)

    return tree_map_defs(leaf, defs)


def to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)), tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.tensor(np.array(tree))


def jax_block(jcfg, fn, mode, B, S):
    """The reference block ``fn(p, *args, ctx, aux)`` under ``shard_map``
    on a 1x1 mesh in ``mode``, jitted."""
    plan = SP.make_plan(jcfg, ShapeCell("block", S, B, mode), MESH)
    ctx = SP.make_context(plan, mode)

    def run(p, *args):
        return fn(p, *args, ctx, {})

    return jax.jit(jax.shard_map(run, mesh=MESH, in_specs=P(),
                                 out_specs=P(), check_vma=False))


def port_ctx(tcfg, mode):
    return make_context(tcfg, mode)


def rel_err(got, want):
    """max |got - want| over max |want| (numpy / torch / jax arrays)."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)
