"""Checkpoints of the MoE family carry the MoE leaves by the
reference's paths (``['units']['posI']['we1']``, ``wr``, ``ws1``,
``sp_disp``, ``sp_comb``, ...), both ways.

Reduced ``qwen2-moe-a2.7b`` and ``llama4-maverick-400b-a17b`` (its MoE
leaves under ``pos1``), float32, with the JAX package's own init on a
1x1 mesh: a JAX ``CheckpointManager`` save restores in the port's
manager into a template from the port's own init, leaf for leaf equal
to ``params_from_jax``; the port's save of those tensors restores in
JAX's manager, and both packages write the same manifest.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke_shape  # noqa: E402
from repro.configs.reduced import reduced as jax_reduced  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch import train as TR  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402

from repro_torch.checkpoint.convert import params_from_jax, tree_paths  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models.model import model_defs  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

torch.set_num_threads(1)

#: arch -> the pattern position of its MoE blocks
ARCHS = {"qwen2-moe-a2.7b": "pos0", "llama4-maverick-400b-a17b": "pos1"}
MOE_LEAVES = ("wr", "we1", "we2", "we3", "ws1", "ws2", "ws3", "sp_disp",
              "sp_comb")


def _both(arch):
    jcfg = jax_reduced(jax_get_config(arch)).replace(dtype=jnp.float32)
    tcfg = reduced(get_config(arch)).replace(dtype=torch.float32)
    mesh = make_mesh((1, 1), ("data", "model"))
    plan = SP.make_plan(jcfg, smoke_shape("train"), mesh)
    jp = TR.init_sharded_params(jcfg, plan, mesh, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_checkpoints_carry_across(arch, tmp_path):
    _, tcfg, jp = _both(arch)
    unit = jp["units"][ARCHS[arch]]
    assert all(k in unit for k in MOE_LEAVES)
    JCkpt(str(tmp_path / "j")).save(3, jp)
    template = init_params(model_defs(tcfg), torch.Generator().manual_seed(
        1), tcfg.dtype, device="cpu")
    tree, step = CheckpointManager(str(tmp_path / "j")).restore(template)
    assert step == 3
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    got, ref = dict(tree_paths(tree)), dict(tree_paths(want))
    assert sorted(got) == sorted(ref)
    assert any("['we1']" in k for k in got)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    CheckpointManager(str(tmp_path / "t")).save(3, want)
    back, step = JCkpt(str(tmp_path / "t")).restore(jp)
    assert step == 3
    for (k, a), (_, b) in zip(tree_paths(back), tree_paths(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), k)
    man = [json.load(open(tmp_path / d / "step_000000003" / "MANIFEST.json"))
           for d in ("t", "j")]
    assert man[0] == man[1]
