"""The port's speculative verify step and its engine path on the CPU.

The model step: the port's ``forward_verify`` over a shared pool of
three slots of mixed lengths, K1 = 4, through the kernel walk and the
reference walk, against the JAX model-level ``forward_verify`` under
``jax.shard_map`` on a 1x1 mesh (built as ``make_engine_verify_step``
builds it, returning logits) on the same params, for every codec
(``test_torch_model.py``'s ``JaxModel``).  Three verify steps each
write K1 KV rows; the next starts 1, 2 or 4 positions on, after the
allocator rolled the rejected tail back, so later steps overwrite
rejected rows.  Logits agree within ``LOGIT_TOL`` = 1e-5, the pools
within 1e-5 (the tolerances of ``test_torch_model.py``, for the same
reason: float32 on both sides, summed in different orders).

The engine: with ``spec_k=3`` the port's engine must commit its own
``spec_k=0`` greedy streams under the margin rule of
``test_torch_model.py`` (ANN mode: nothing rounds on a wire, so only a
near-tie may part them), on ``test_torch_engine.py``'s schedule, with
three drafters: a stub proposing the ``spec_k=0`` continuation (every
draft accepted), a stub whose first draft is never the next token (one
token a step) and the n-gram drafter.  The stubs replace
``NGramDrafter.propose``.  A tight pool that preempts under spec and an
EOS inside an accepted run give the same streams.  Every page is free
at the end of every run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import SCHEDULE  # noqa: E402
from test_torch_model import (LOGIT_TOL, MARGIN, MAX_SEQ, MODELS,  # noqa: E402
                              NUM_PAGES, PREFILL, PSZ, SLOTS,
                              assert_greedy_agrees,
                              assert_pools_close, margin, step_aux,
                              three_slots)

from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.context import make_context  # noqa: E402
from repro_torch.serving import (EngineConfig, EngineConfigError,  # noqa: E402
                                 Request, ServingEngine)
from repro_torch.serving.draft import NGramDrafter  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache  # noqa: E402

torch.set_num_threads(1)

K1 = 4
CODECS = ("none", "spike_fused", "spike", "spike_pack4", "sparse_topk")


@pytest.mark.parametrize("codec", CODECS)
def test_forward_verify_matches_jax(codec):
    check_verify(MODELS[codec])


def check_verify(jm):
    """Three K1-token verify steps of three slots over one pool, both
    walks, port vs JAX's model-level ``forward_verify``: logits, then
    the pools.  Between steps the slots advance 1, 2 or 4 positions and
    the allocator rolls the rejected tail back."""
    rng = np.random.RandomState(13)
    ctx = make_context(jm.tcfg)
    alloc, jcache, tcache, pos = three_slots(jm, rng, ctx)
    for advance in (1, 2, 4):
        for s in range(SLOTS):
            alloc.ensure(s, int(pos[s]) + K1)
        tokens = rng.randint(0, jm.tcfg.vocab, (SLOTS, K1)).astype(np.int32)
        for kernel in ("fused", "reference"):
            jl, jcache[kernel] = jm.jax_verify(kernel, jcache[kernel],
                                               tokens, pos, alloc)
            tl, _ = TM.forward_verify(jm.tparams, tcache[kernel].buffers,
                                      torch.tensor(tokens),
                                      torch.tensor(pos), ctx,
                                      aux_extra=step_aux(alloc, kernel))
            assert tl.shape == (SLOTS, K1, jm.tcfg.vocab)
            np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL,
                                       rtol=0)
            for s in range(SLOTS):
                for j in range(K1):
                    if margin(jl[s, j]) > MARGIN:
                        assert (int(np.argmax(jl[s, j]))
                                == int(torch.argmax(tl[s, j])))
        pos += advance
        for s in range(SLOTS):
            alloc.rollback(s, int(pos[s]))
    assert_pools_close(tcache, jcache)


def test_forward_verify_refuses_hidden():
    """The final hidden serves the learned draft heads, not ported."""
    jm = MODELS["none"]
    tc = PagedKVCache(jm.tcfg, num_slots=SLOTS, max_seq=MAX_SEQ,
                      page_size=PSZ, num_pages=NUM_PAGES, device="cpu")
    with pytest.raises(NotImplementedError):
        TM.forward_verify(jm.tparams, tc.buffers,
                          torch.zeros((SLOTS, K1), dtype=torch.int32),
                          torch.zeros(SLOTS, dtype=torch.int32),
                          make_context(jm.tcfg),
                          aux_extra={"block_table": torch.tensor(
                              tc.block_table)},
                          return_hidden=True)


# ---------------------------------------------------------------------------
# the engine's spec path
# ---------------------------------------------------------------------------


def _serve(reqs, codec="none", **kw):
    """One engine run of ``reqs`` ({rid: (prompt, max new tokens)});
    every page must be free at the end.  Returns (streams, engine)."""
    jm = MODELS[codec]
    ecfg = EngineConfig(num_slots=SLOTS, max_seq=MAX_SEQ,
                        prefill_len=PREFILL, page_size=PSZ, **kw)
    eng = ServingEngine(jm.tcfg, jm.tparams, ecfg, device="cpu")
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in reqs.items()])
    alloc = eng.cache.allocator
    assert (alloc.pages_in_use, alloc.pages_in_limbo, alloc.num_free) == (
        0, 0, SLOTS)
    assert sum(map(alloc.free_pages_in_group,
                   range(alloc.num_groups))) == alloc.num_pages
    assert (alloc.block_table == -1).all()
    assert eng.idle
    return out, eng


REQS = dict(enumerate(SCHEDULE))
_VANILLA = []


def _vanilla():
    """The ``spec_k=0`` streams, margins and decode steps of the
    schedule (served once)."""
    if not _VANILLA:
        _VANILLA.append(_vanilla_of(REQS))
    return _VANILLA[0]


def _vanilla_of(reqs):
    out, eng = _serve(reqs)
    return out, eng.margins, eng.decode_steps


class _Stub:
    """Replace ``NGramDrafter.propose`` by the ``spec_k=0`` continuation
    of the drafter's request (``accept=True``) or by tokens one off it
    (never the next token) while active."""

    def __init__(self, streams, accept, vocab, reqs=REQS):
        self.streams = {tuple(p): streams[i] for i, (p, _) in reqs.items()}
        self.accept, self.vocab = accept, vocab

    def propose(self, drafter, k):
        h = drafter.history
        for prompt, ref in self.streams.items():
            n = len(h) - len(prompt)
            if (n >= 0 and tuple(h[:len(prompt)]) == prompt
                    and h[len(prompt):] == ref[:n]):
                cont = list(ref[n:n + k])
                cont += [cont[-1] if cont else 0] * (k - len(cont))
                if self.accept:
                    return cont
                return [(t + 1) % self.vocab for t in cont]
        # a stream parted from the vanilla one at a near-tie
        return [h[-1]] * k

    def __enter__(self):
        self.orig = NGramDrafter.propose
        stub = self
        NGramDrafter.propose = lambda d, k: stub.propose(d, k)

    def __exit__(self, *exc):
        NGramDrafter.propose = self.orig


def _assert_streams_agree(ref, ref_margins, out):
    assert sorted(out) == sorted(ref)
    for i in ref:
        assert_greedy_agrees(ref[i], ref_margins[i], out[i])


@pytest.mark.parametrize("drafter", ["accept_all", "reject_all", "ngram"])
def test_spec_streams_match_vanilla(drafter):
    ref, ref_margins, steps = _vanilla()
    vocab = MODELS["none"].tcfg.vocab
    if drafter == "ngram":
        out, eng = _serve(REQS, spec_k=3)
    else:
        with _Stub(ref, drafter == "accept_all", vocab):
            out, eng = _serve(REQS, spec_k=3)
    _assert_streams_agree(ref, ref_margins, out)
    n_first = len(REQS)          # each request's first token is prefilled
    assert eng.spec_commits == sum(map(len, out.values())) - n_first
    assert eng.spec_verifies > 0
    if drafter == "accept_all":
        assert eng.mean_accepted_len() > 1
        # fewer verify steps than a vanilla run has decode steps
        assert eng.decode_steps < steps
    if drafter == "reject_all":
        assert eng.mean_accepted_len() == 1.0
    # the same configuration serves the same streams again
    if drafter == "ngram":
        assert _serve(REQS, spec_k=3)[0] == out
        ref_walk, _ = _serve(REQS, spec_k=3, attn_kernel="reference")
        _assert_streams_agree(ref, ref_margins, ref_walk)


@pytest.mark.parametrize("accept", [False, True])
def test_spec_rollback_returns_fresh_page(accept):
    """A 7-token prompt's first verify step writes positions 7..10, so
    it maps the slot's second page.  Rejecting every draft commits one
    token (occupancy 8): that page returns to the pool at once.
    Accepting them all keeps it (occupancy 11)."""
    prompt, _ = SCHEDULE[0]
    reqs = {0: ((prompt * 7)[:7], 12)}
    ref, _, _ = _vanilla_of(reqs)
    jm = MODELS["none"]
    eng = ServingEngine(jm.tcfg, jm.tparams, EngineConfig(
        num_slots=SLOTS, max_seq=MAX_SEQ, prefill_len=PREFILL,
        page_size=PSZ, spec_k=3), device="cpu")
    alloc = eng.cache.allocator
    eng.submit(Request(rid=0, prompt=reqs[0][0], max_new_tokens=12))
    with _Stub(ref, accept, jm.tcfg.vocab, reqs):
        eng.step()
        assert alloc.pages_in_use == (2 if accept else 1)
        assert alloc.pages_in_limbo == 0
        assert alloc.free_pages_in_group(0) == NUM_PAGES - alloc.pages_in_use
        while not eng.idle:
            eng.step()
    assert alloc.pages_in_use == 0 and alloc.num_free == SLOTS


def test_spec_tight_pool_preempts_without_changing_streams():
    """An 8-page pool under three slots whose requests grow to 2-4 pages
    each, and a verify step that maps up to K1 positions ahead: the pool
    binds, preempted requests restart, the streams stay the vanilla
    ones."""
    ref, ref_margins, _ = _vanilla()
    with _Stub(ref, True, MODELS["none"].tcfg.vocab):
        out, eng = _serve(REQS, spec_k=3, num_pages=8)
    assert eng.preemptions > 0
    _assert_streams_agree(ref, ref_margins, out)
    out, eng = _serve(REQS, spec_k=3, num_pages=8)
    assert eng.preemptions > 0
    _assert_streams_agree(ref, ref_margins, out)


def test_spec_eos_inside_an_accepted_run():
    """EOS = a token first seen in the middle of a verify step's accepted
    run (every draft accepted, so step s commits tokens 4s-3 .. 4s): its
    request stops right there, the rest of the run is dropped and the
    rejected tail's pages return.  Every other request stops at its own
    first EOS, or at admission if its first token is EOS."""
    ref, ref_margins, _ = _vanilla()
    for r in sorted(ref):
        toks = ref[r]
        cut = [t for t in range(2, len(toks))
               if toks[t] not in toks[:t] and (t - 1) % K1 != 0
               and ref_margins[r][t] > MARGIN]
        if cut:
            break
    eos, t = toks[cut[0]], cut[0]
    with _Stub(ref, True, MODELS["none"].tcfg.vocab):
        out, eng = _serve(REQS, spec_k=3, eos_id=eos)
    assert eng.mean_accepted_len() > 1
    assert out[r] == toks[:t + 1]
    want = {i: s[:s.index(eos) + 1] if eos in s else s
            for i, s in ref.items()}
    _assert_streams_agree(want, ref_margins, out)


def test_spec_engine_config():
    jm = MODELS["none"]
    for kw in ({"spec_k": -1}, {"spec_k": 2, "drafter": "heads"},
               {"spec_k": 2, "async_depth": -1}, {"drafter": "medusa"}):
        with pytest.raises(EngineConfigError):
            ServingEngine(jm.tcfg, jm.tparams, EngineConfig(**kw),
                          device="cpu")
    out, eng = _serve({0: (SCHEDULE[0][0], 1)}, spec_k=3)
    assert len(out[0]) == 1 and eng.spec_verifies == 0
