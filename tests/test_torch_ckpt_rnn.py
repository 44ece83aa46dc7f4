"""Checkpoints of the recurrent-state families carry their leaves by
the reference's paths (RWKV's ``['units']['pos0']['time_decay']``,
``mix_kvr``, ``wk_tm``, ``sp_in2``; mLSTM's ``wif``; sLSTM's ``r``,
``wgates``; mamba's ``a_log``, ``dt_bias``, ``conv_w``, ``d_skip``,
...), both ways.

Reduced ``rwkv-paper``, ``xlstm-125m`` and one unit of
``jamba-1.5-large-398b`` (``n_layers=8``), float32, with the JAX
package's own init on a 1x1 mesh, its constant leaves seeded: a JAX
``CheckpointManager`` save restores in the port's manager into a
template from the port's own init (whose ``alog``, ``dtbias`` and
``half`` leaves equal the reference's init), leaf for leaf equal to
``params_from_jax``; the port's save restores in JAX's manager, and
both packages write the same manifest.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_rec import JAMBA_ONE_UNIT, seed_leaves  # noqa: E402

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

#: arch -> (overrides, leaves that must be in the checkpoint)
ARCHS = {
    "rwkv-paper": (None, ("time_decay", "time_first", "mix_kvr", "mix_cm",
                          "wk_tm", "wv_cm", "sp_in2", "sp_out2")),
    "xlstm-125m": (None, ("wif", "wq", "wgates", "r", "wz")),
    "jamba-1.5-large-398b": (JAMBA_ONE_UNIT, ("a_log", "dt_bias", "conv_w",
                                              "d_skip", "wdt1", "we1",
                                              "wq")),
}
#: the port's init of the leaves that draw nothing equals the
#: reference's (``a_log`` within one float32 ulp: XLA's ``log(7)`` on
#: the CPU is one ulp above the correctly rounded value torch returns)
CONSTANT = ("a_log", "dt_bias", "d_skip", "mix_kvr", "mix_cm",
            "time_decay", "time_first", "ln1", "ln2")


def _both(arch):
    over = dict(ARCHS[arch][0] or {})
    jcfg = jax_reduced(jax_get_config(arch)).replace(dtype=jnp.float32,
                                                     **over)
    tcfg = reduced(get_config(arch)).replace(dtype=torch.float32, **over)
    mesh = make_mesh((1, 1), ("data", "model"))
    plan = SP.make_plan(jcfg, smoke_shape("train"), mesh)
    jp = TR.init_sharded_params(jcfg, plan, mesh, jax.random.PRNGKey(0))
    return tcfg, jp


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_recurrent_checkpoints_carry_across(arch, tmp_path):
    tcfg, jp0 = _both(arch)
    template = init_params(model_defs(tcfg), torch.Generator().manual_seed(
        1), tcfg.dtype, device="cpu")
    init = dict(tree_paths(template))
    for k, v in tree_paths(jax.tree.map(np.asarray, jp0)):
        name = k.split("'")[-2]
        if name == "a_log":
            np.testing.assert_allclose(init[k].numpy(), v, rtol=1.2e-7,
                                       atol=0, err_msg=k)
        elif name in CONSTANT:
            np.testing.assert_array_equal(init[k].numpy(), v, k)
    jp = seed_leaves(jp0)
    found = {n for k, _ in tree_paths(jp) for n in k.split("'")[1::2]}
    assert set(ARCHS[arch][1]) <= found
    JCkpt(str(tmp_path / "j")).save(3, jp)
    tree, step = CheckpointManager(str(tmp_path / "j")).restore(template)
    assert step == 3
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    got, ref = dict(tree_paths(tree)), dict(tree_paths(want))
    assert sorted(got) == sorted(ref)
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
