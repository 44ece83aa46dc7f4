"""The paper's Table 4 setup (``examples/table4_accuracy.py``) through
the port's training CLI: ``repro_torch.launch.train_cli.main`` with the
argument list the example builds (``--arch rwkv-paper --reduced --mesh
1x1 --no-resume --lr 2e-3``, its default ``--batch 8 --seq 128``) for 2
steps, against ``repro.launch.train_cli.main`` on the same arguments.

The CLI resolves ``--arch`` through ``get_config``, so registering the
config is all it needs.  The two CLIs draw their parameters from
different generators, so the port's run starts from the reference
CLI's init (``init_train_params`` is given ``params_from_jax`` of
``init_sharded_params(PRNGKey(seed))``); the data is the same
``SyntheticLM`` stream.  The first step's loss must lie within 1e-5 of
the reference's, relative: the reduced config computes in bfloat16,
where XLA and torch round at other places (ANN reads ~4e-6, HNN and SNN
~1e-7, whose coded boundaries snap the rounding away).  ANN here, SNN
and HNN in ``test_torch_table4_{snn,hnn}.py`` (the reference CLI
compiles its step once per mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke_shape  # noqa: E402
from repro.configs.reduced import reduced as jax_reduced  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.launch import train_cli as JCLI  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402

from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.launch import train_cli as TCLI  # noqa: E402

torch.set_num_threads(1)


def table4_argv(mode, ckpt_dir):
    """``examples/table4_accuracy.py``'s argument list (its defaults,
    ``--reduced``) for 2 steps."""
    return ["--arch", "rwkv-paper", "--steps", "2", "--batch", "8",
            "--seq", "128", "--mesh", "1x1", "--hnn-mode", mode,
            "--ckpt-dir", str(ckpt_dir), "--no-resume", "--lr", "2e-3",
            "--log-every", "100", "--reduced"]


def jax_init(cfg, seed=0, *, device=None):
    """The reference CLI's parameters of ``cfg``, as the port's tree."""
    jcfg = jax_reduced(jax_get_config(cfg.name, hnn_mode=cfg.hnn_mode,
                                      codec=cfg.codec))
    mesh = make_mesh((1, 1), ("data", "model"))
    plan = SP.make_plan(jcfg, smoke_shape("train"), mesh)
    params = JTR.init_sharded_params(jcfg, plan, mesh,
                                     jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree.map(np.asarray, params), cfg,
                           device=device)


def check(mode, tmp_path, monkeypatch):
    _, jm = JCLI.main(table4_argv(mode, tmp_path / "jax"))
    monkeypatch.setattr(TTR, "init_train_params", jax_init)
    out, tm = TCLI.main(table4_argv(mode, tmp_path / "port")
                        + ["--device", "cpu"])
    assert out["arch"] == "rwkv-paper" and out["mode"] == mode
    assert len(tm) == 2 and out["nan_skips"] == 0
    np.testing.assert_allclose(float(tm[0]["loss"]), float(jm[0]["loss"]),
                               rtol=1e-5, atol=0)
    assert np.isfinite([float(m["loss"]) for m in tm]).all()


def test_table4_ann_first_loss_matches_jax(tmp_path, monkeypatch):
    check("ann", tmp_path, monkeypatch)
