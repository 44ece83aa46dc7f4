"""The port's dispatch/commit pipeline on the CPU: ``async_depth`` 1 and 2
against the port's own ``async_depth=0`` engine.

``test_torch_engine.py``'s schedule (seven requests of mixed prompt
lengths and budgets on three slots) is served with every codec at
``async_depth`` 0, 1 and 2: plainly, with ``spec_k=3`` (the n-gram
drafter), under an 8-page pool that preempts (``pool_pressure``) and
with an EOS id that stops a request while its next step is already in
flight (the zombie column is dropped at commit).  Each pipelined run
must give the ``async_depth=0`` run's streams and margins exactly: the
steps run the same ops on the same shapes, and only when a request is
admitted or retired moves.  ``test_torch_async_jax.py`` holds the same
pipelined runs to the JAX model-level steps.  After every run the
engine is idle, every page and slot is free, the limbo is empty and
every dispatched step has committed.

Also: ``async_depth < 0`` is refused; ``warmup`` and ``reset_stats``
commit the in-flight steps first; the host feeds a step was staged from
are copies of their own, so changing the host arrays right after a
dispatch changes nothing.  Parameters come from the JAX init through
``params_from_jax`` (``test_torch_model.py``'s ``MODELS``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import SCHEDULE  # noqa: E402
from test_torch_model import (MAX_SEQ, MODELS, PREFILL, PSZ,  # noqa: E402
                              SLOTS)

from repro_torch.serving import (WARMUP_RID, EngineConfig,  # noqa: E402
                                 EngineConfigError, Request, ServingEngine)

torch.set_num_threads(1)

CODECS = ("spike_fused", "none", "spike", "spike_pack4", "sparse_topk")
REQS = list(enumerate(SCHEDULE))


class PreemptKinds:
    """Observer: the ``kind`` of every ``on_preempt``."""

    def __init__(self):
        self.kinds = []

    def on_preempt(self, rid, kind):
        self.kinds.append(kind)


def assert_drained(eng):
    alloc = eng.cache.allocator
    assert eng.idle and not eng._inflight
    assert alloc._dispatched == alloc._committed
    assert (alloc.pages_in_use, alloc.pages_in_limbo, alloc.num_free) == (
        0, 0, alloc.num_slots)
    assert sum(map(alloc.free_pages_in_group,
                   range(alloc.num_groups))) == alloc.num_pages
    assert (alloc.block_table == -1).all()


def make_engine(codec, **kw):
    jm = MODELS[codec]
    return ServingEngine(jm.tcfg, jm.tparams, EngineConfig(
        num_slots=SLOTS, max_seq=MAX_SEQ, prefill_len=PREFILL,
        page_size=PSZ, **kw), device="cpu")


def serve(codec, reqs=REQS, **kw):
    """One run of ``reqs`` [(rid, (prompt, max new))]; the engine must
    drain clean.  Returns (streams, margins, engine, preempt kinds)."""
    eng = make_engine(codec, **kw)
    kinds = PreemptKinds()
    eng.observers.append(kinds)
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in reqs])
    assert_drained(eng)
    return out, eng.margins, eng, kinds.kinds


_SYNC = {}


def serve_sync(codec, **kw):
    """``serve`` at ``async_depth=0``, once per codec and knobs."""
    key = (codec, tuple(sorted(kw.items())))
    if key not in _SYNC:
        _SYNC[key] = serve(codec, **kw)
    return _SYNC[key]


def eos_of(streams):
    """An EOS id that stops some request mid-stream: the first token new
    to its stream, neither its first nor its last.  Returns (eos, rid,
    index of the EOS in that stream)."""
    for rid in sorted(streams):
        toks = streams[rid]
        for t in range(1, len(toks) - 1):
            if toks[t] not in toks[:t]:
                return toks[t], rid, t
    raise AssertionError("no request has a new token mid-stream")


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("codec", CODECS)
def test_async_streams_equal_sync(codec, depth):
    plain0, m0, eng0, _ = serve_sync(codec)
    plain, m, eng, _ = serve(codec, async_depth=depth)
    assert plain == plain0 and m == m0
    assert eng.tokens_generated == eng0.tokens_generated == sum(
        n for _, (_, n) in REQS)
    # spec: every verify dispatch joins the pipeline first
    spec0, sm0, eng0, _ = serve_sync(codec, spec_k=3)
    spec, sm, eng, _ = serve(codec, spec_k=3, async_depth=depth)
    assert spec == spec0 and sm == sm0
    assert eng.spec_commits == eng0.spec_commits
    # a tight pool: the pool, not the slot count, binds
    tight0, tm0, eng0, kinds0 = serve_sync(codec, num_pages=8)
    tight, tm, eng, kinds = serve(codec, num_pages=8, async_depth=depth)
    assert tight == tight0 and tm == tm0
    assert eng0.preemptions > 0 and eng.preemptions > 0
    assert set(kinds0) == set(kinds) == {"pool_pressure"}
    # EOS inside the pipeline: the request's next step is in flight when
    # its EOS commits, and that zombie column is dropped
    eos, rid, t = eos_of(plain0)
    early0, em0, *_ = serve_sync(codec, eos_id=eos)
    early, em, *_ = serve(codec, eos_id=eos, async_depth=depth)
    assert early == early0 and em == em0
    assert early[rid] == plain0[rid][:t + 1]


def test_negative_depth_is_refused():
    with pytest.raises(EngineConfigError):
        make_engine("none", async_depth=-1)


@pytest.mark.parametrize("depth", [1, 2])
def test_reset_stats_and_warmup_flush(depth):
    ref, *_ = serve_sync("none")
    eng = make_engine("none", async_depth=depth)
    for i, (p, m) in REQS:
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=m))
    results = {}
    for _ in range(4):
        results.update((r.rid, o) for r, o in eng.step())
    assert len(eng._inflight) == depth
    eng.reset_stats()
    assert not eng._inflight
    assert (eng.tokens_generated, eng.decode_steps, eng.prefills) == (0, 0, 0)
    while not eng.idle:
        results.update((r.rid, o) for r, o in eng.step())
    assert results == ref
    assert_drained(eng)
    # warmup serves a throwaway request, then zeroes the stats
    eng = make_engine("none", async_depth=depth)
    eng.warmup(REQS[0][1][0])
    assert_drained(eng)
    assert (eng.tokens_generated, eng.decode_steps, eng.prefills) == (0, 0, 0)
    assert WARMUP_RID not in eng.margins
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in REQS])
    assert out == ref
    assert eng.tokens_generated == sum(n for _, (_, n) in REQS)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_staged_feeds_are_copies(spec_k):
    """Every device feed a step was staged from keeps the value its host
    array had at staging, though the host arrays the engine goes on
    changing (tokens, positions, block table, page lists) are written
    over with garbage right after each dispatch and then changed by the
    engine's own bookkeeping; and the committed tokens do not change.
    On the CPU a step has run by the time ``dispatch`` returns; the card
    test writes garbage while the copies may still be queued."""
    ref, *_ = serve_sync("spike_fused", spec_k=spec_k)
    eng = make_engine("spike_fused", async_depth=1, spec_k=spec_k)
    alloc = eng.cache.allocator
    arrays = (eng._tokens, eng._pos, alloc.block_table, alloc.page_list_loc,
              alloc.page_list_pos)
    stage, dispatch, staged, seen = eng._stage, eng.dispatch, [], []

    def recorded_stage(arr):
        dev = stage(arr)
        staged.append((np.array(arr, copy=True), dev))
        return dev

    def garbled_dispatch():
        first = len(staged)
        launched = dispatch()
        if launched:
            seen.append(len(staged) - first)
            saved = [a.copy() for a in arrays]
            for a in arrays:
                a[...] = 99
            for host, dev in staged[first:]:
                np.testing.assert_array_equal(dev.numpy(), host)
            for a, old in zip(arrays, saved):
                a[...] = old
        return launched

    eng._stage, eng.dispatch = recorded_stage, garbled_dispatch
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in REQS])
    assert out == ref and seen and min(seen) >= 4
    for host, dev in staged:
        np.testing.assert_array_equal(dev.numpy(), host)
    assert_drained(eng)
