"""The port's architecture registry against the JAX package's.

Every architecture the port registers (the dense attention family:
``qwen1.5-0.5b``, ``qwen1.5-4b``, ``gemma2-2b``, ``granite-20b``; the
MoE family: ``qwen2-moe-a2.7b``, ``llama4-maverick-400b-a17b``; the
recurrent-state families: ``rwkv-paper``, ``xlstm-125m``,
``jamba-1.5-large-398b``) equals the JAX registry's config field for
field, at full size and reduced (the dtype by name: a torch dtype here,
a jnp one there); an architecture whose family is not ported (the mrope
``qwen2-vl-2b``) raises ``KeyError``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.reduced import reduced as jax_reduced  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402

ARCHS = ("gemma2-2b", "granite-20b", "jamba-1.5-large-398b",
         "llama4-maverick-400b-a17b", "qwen1.5-0.5b", "qwen1.5-4b",
         "qwen2-moe-a2.7b", "rwkv-paper", "xlstm-125m")


def _fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = getattr(out["dtype"], "__name__", None) or str(
        out["dtype"]).split(".")[-1]
    return out


def test_registry_holds_the_dense_attention_family():
    assert tuple(list_archs()) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch):
    assert _fields(get_config(arch)) == _fields(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_equals_jax(arch):
    over = dict(hnn_mode="ann", codec="none")
    assert (_fields(reduced(get_config(arch, **over)))
            == _fields(jax_reduced(jax_get_config(arch, **over))))


def test_unported_family_raises():
    with pytest.raises(KeyError):
        get_config("qwen2-vl-2b")
