"""The port's pipelined engine against the JAX model-level steps.

``test_torch_async.py``'s runs at ``async_depth`` 1 and 2 (the schedule
of ``test_torch_engine.py`` plainly, with ``spec_k=3`` (the n-gram
drafter), under an 8-page pool that preempts (``pool_pressure``) and
with an EOS that stops a request while its next step is in flight),
each stream held to the request's solo greedy loop through the JAX
model-level steps (``JaxModel.greedy_solo`` on the reference attention
walk; under EOS the loop's stream cut after its first EOS) under
``test_torch_model.py``'s margin rule.  ``test_torch_async.py`` holds
the same runs to the port's own ``async_depth=0`` runs, exactly.

This file runs ``none``, ``spike_fused`` and ``spike``;
``test_torch_async_jax_wire.py`` runs ``spike_pack4`` and
``sparse_topk`` (each JAX model compiles once per file, so the codecs
are split to keep each file short).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_async import eos_of, serve  # noqa: E402
from test_torch_engine import SCHEDULE  # noqa: E402
from test_torch_model import MODELS, assert_greedy_agrees  # noqa: E402

torch.set_num_threads(1)

_JAX_SOLO = {}


def jax_solo(codec):
    """[(tokens, margins)] of every request of the schedule alone, by
    the JAX model-level steps, once per codec."""
    if codec not in _JAX_SOLO:
        _JAX_SOLO[codec] = [
            MODELS[codec].greedy_solo(p, m, kernel="reference")
            for p, m in SCHEDULE]
    return _JAX_SOLO[codec]


def assert_jax_agrees(codec, streams, eos_id=None):
    """Every stream against its request's JAX solo stream (cut after
    its first ``eos_id``), under the margin rule."""
    assert sorted(streams) == list(range(len(SCHEDULE)))
    for rid, (toks, margins) in enumerate(jax_solo(codec)):
        if eos_id in toks:
            cut = toks.index(eos_id) + 1
            toks, margins = toks[:cut], margins[:cut]
        assert_greedy_agrees(toks, margins, streams[rid])


def check_async_against_jax(codec, depth):
    plain, *_ = serve(codec, async_depth=depth)
    assert_jax_agrees(codec, plain)
    spec, *_ = serve(codec, spec_k=3, async_depth=depth)
    assert_jax_agrees(codec, spec)
    tight, _, eng, kinds = serve(codec, num_pages=8, async_depth=depth)
    assert eng.preemptions > 0 and set(kinds) == {"pool_pressure"}
    assert_jax_agrees(codec, tight)
    eos, rid, t = eos_of(plain)
    early, *_ = serve(codec, eos_id=eos, async_depth=depth)
    assert early[rid] == plain[rid][:t + 1]
    assert_jax_agrees(codec, early, eos_id=eos)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("codec", ["none", "spike_fused", "spike"])
def test_async_streams_agree_with_jax(codec, depth):
    check_async_against_jax(codec, depth)
