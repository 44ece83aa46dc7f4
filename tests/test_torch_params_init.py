"""``models.params.init_params`` draws each normal leaf in float32 and
scales it in place, so that a large leaf (a stacked expert weight of
15.5 GiB at qwen2-moe-a2.7b's full width) needs no second float32 copy
while it is drawn.  Every leaf must keep the bits of the out-of-place
expression it replaced, ``(x * scale).to(dtype)``, which earlier seeded
runs were drawn with: the digest of every tensor of a reduced config's
init, in float32 and bfloat16, for the dense and both MoE patterns,
equals the digest of that expression computed here from the same
generator stream.
"""
import hashlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.convert import tree_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models.model import model_defs  # noqa: E402
from repro_torch.models.params import init_params, tree_map_defs  # noqa: E402

torch.set_num_threads(1)


def old_init_leaf(d, gen, dtype):
    """The expression ``_init_leaf`` used before it scaled in place."""
    dt = d.dtype or dtype
    if d.init in ("normal", "embed"):
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32)
        return (x * d.scale).to(dt)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt)
    if d.init == "theta":
        return torch.full(d.shape, 0.01, dtype=torch.float32)
    assert d.init == "logscale"
    return torch.zeros(d.shape, dtype=torch.float32)


def digest(tree):
    """sha256 over every leaf's path, dtype, shape and bytes, in sorted
    path order."""
    h = hashlib.sha256()
    for path, t in tree_paths(tree):
        h.update(repr((path, t.dtype, tuple(t.shape))).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-moe-a2.7b",
                                  "llama4-maverick-400b-a17b"])
def test_in_place_init_keeps_the_bits(arch, dtype):
    cfg = reduced(get_config(arch))
    dt = getattr(torch, dtype)
    defs = model_defs(cfg)
    new = init_params(defs, torch.Generator().manual_seed(0), dt,
                      device="cpu")
    gen = torch.Generator().manual_seed(0)
    old = tree_map_defs(lambda _, d: old_init_leaf(d, gen, dt), defs)
    assert digest(new) == digest(old)
