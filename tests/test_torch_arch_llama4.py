"""Reduced ``llama4-maverick-400b-a17b`` in the port against the JAX
reference: units of a dense block and an ``attn_moe`` block (GQA, then
a MoE FFN of 8 experts, top-1, with one shared expert; the reduced
config keeps 2 units, 4 layers).

The biases and norm scales, zero at the init, are seeded on the JAX
parameters before they are carried across
(``test_torch_model.seed_zero_init_leaves``).  With
``test_torch_model.py``'s ``JaxModel`` and tolerances (logits 1e-5,
greedy tokens exact up to a margin of 1e-4): prefill logits and prompt
KV, five teacher-forced decode steps and three K1 = 4 verify steps over
a shared pool through both walks.

The engine's streams are held to a replay of the engine's own batches
through JAX's model-level steps (``check_streams_replay``), not to a
solo greedy loop: with top-1 routing over 8 experts, a decode step of
the three slots has a capacity of C = ceil(3 / 8 x 4.0) = 2, so when
all three slots' tokens (a dead slot's among them) pick one expert the
last loses its routed output, and a request's stream depends on the
batch it is served in.  Every prefill (its padded prompt, the slot and
block-table row it lands in) and every decode step (every slot's token
and position, dead slots included, and the block table and page lists)
of the port's engine is recorded and replayed through JAX's
``forward_prefill`` / insert / ``forward_decode``; each request's stream
must equal the replay's greedy tokens under the margin rule, and each
step's live logits JAX's within 1e-5.  One prompt in all three slots
shows the drop itself: the third slot's routed output is dropped in
the first MoE layer, on both sides.

Codec ``none`` here; ``spike_fused``, ``spike_pack4`` and ``spike`` in
``test_torch_arch_llama4_{fused,pack4,spike}.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_engine import SCHEDULE, run_engine  # noqa: E402
from test_torch_model import (LOGIT_TOL, MAX_SEQ, NUM_PAGES,  # noqa: E402
                              PREFILL, PSZ, SLOTS, _Models,
                              assert_greedy_agrees, check_prefill,
                              check_teacher_forced, margin, own_copy,
                              step_aux)
from test_torch_verify import check_verify  # noqa: E402

from repro_torch.models import blocks_moe as TMOE  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.context import make_context  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache, SlotAllocator  # noqa: E402

torch.set_num_threads(1)

ARCH = "llama4-maverick-400b-a17b"
MODELS = _Models(ARCH, seeded=True)
CODEC = "none"


class BatchRecorder:
    """Records the port engine's batches while active: per prefill the
    request, its padded prompt, its logits and the slot and block-table
    row its cache lands in; per decode step the token feed and positions
    of every slot, the block table and page lists, each slot's progress
    (``slot_progress``) and the logits."""

    def __init__(self):
        self.events = []
        self._eng = None
        self._entry = None

    def __enter__(self):
        rec = self
        self._saved = (ServingEngine._admit, ServingEngine._dispatch_decode,
                       PagedKVCache.admit, TM.forward_prefill,
                       TM.forward_decode)
        admit, dispatch, cache_admit, prefill, decode = self._saved

        def _admit(eng, entry):
            rec._eng, rec._entry = eng, entry
            return admit(eng, entry)

        def _dispatch_decode(eng, live):
            rec._eng = eng
            return dispatch(eng, live)

        def _cache_admit(cache, pre, seq_len):
            slot = cache_admit(cache, pre, seq_len)
            ev = rec.events[-1]
            ev.update(slot=slot, bt=cache.allocator.block_table[slot].copy())
            return slot

        def _prefill(params, tokens, ctx, last_pos=None):
            logits, pre = prefill(params, tokens, ctx, last_pos=last_pos)
            rec.events.append(dict(
                kind="prefill", rid=rec._entry.rid,
                prompt=tokens[0, :int(last_pos[0]) + 1].numpy().copy(),
                logits=logits[0].numpy().copy()))
            return logits, pre

        def _decode(params, cache, token, pos, ctx, aux_extra=None):
            logits, cache = decode(params, cache, token, pos, ctx,
                                   aux_extra)
            aux = aux_extra
            rec.events.append(dict(
                kind="decode", token=token.numpy().copy(),
                pos=pos.numpy().copy(),
                bt=aux["block_table"].numpy().copy(),
                clp=aux["page_list"][0].numpy().copy(),
                clo=aux["page_list"][1].numpy().copy(),
                prog=rec._eng.slot_progress(),
                logits=logits.numpy().copy()))
            return logits, cache

        ServingEngine._admit = _admit
        ServingEngine._dispatch_decode = _dispatch_decode
        PagedKVCache.admit = _cache_admit
        TM.forward_prefill = _prefill
        TM.forward_decode = _decode
        return self

    def __exit__(self, *exc):
        (ServingEngine._admit, ServingEngine._dispatch_decode,
         PagedKVCache.admit, TM.forward_prefill,
         TM.forward_decode) = self._saved


def replay(jm, events):
    """The recorded batches through JAX's model-level steps (kernel walk):
    per request, the greedy tokens and their margins."""
    jcache = jm.init_cache()
    toks, margins = {}, {}
    for ev in events:
        if ev["kind"] == "prefill":
            jl, pre = jm.jax_prefill(ev["prompt"])
            np.testing.assert_allclose(ev["logits"], jl, atol=LOGIT_TOL,
                                       rtol=0)
            jcache = jm.insert(jcache, pre, jnp.asarray(ev["slot"],
                                                        jnp.int32),
                               own_copy(ev["bt"]))
            toks[ev["rid"]] = [int(np.argmax(jl))]
            margins[ev["rid"]] = [margin(jl)]
            continue
        alloc = types.SimpleNamespace(block_table=ev["bt"],
                                      page_list_loc=ev["clp"],
                                      page_list_pos=ev["clo"])
        jl, jcache = jm.jax_decode("fused", jcache, ev["token"], ev["pos"],
                                   alloc)
        for s, prog in enumerate(ev["prog"]):
            if prog is None:
                continue
            rid, n = prog
            np.testing.assert_allclose(ev["logits"][s], jl[s],
                                       atol=LOGIT_TOL, rtol=0)
            assert len(toks[rid]) == n
            toks[rid].append(int(np.argmax(jl[s])))
            margins[rid].append(margin(jl[s]))
    return toks, margins


def check_streams_replay(jm, schedule=SCHEDULE):
    """The engine's greedy streams of ``schedule``: both walks serve the
    same streams, and each request's stream equals the JAX replay of the
    engine's own batches under the margin rule."""
    reqs = list(enumerate(schedule))
    with BatchRecorder() as rec:
        batched, _ = run_engine(jm, reqs)
    ref, _ = run_engine(jm, reqs, attn_kernel="reference")
    assert ref == batched
    toks, margins = replay(jm, rec.events)
    assert sorted(toks) == sorted(batched)
    for i, (_, m) in reqs:
        assert len(batched[i]) == m
        assert_greedy_agrees(toks[i], margins[i], batched[i])
    return rec.events


def check_third_slot_dropped(jm):
    """One prompt prefilled into all three slots, then one decode step
    with one token at one position in every slot: the three rows are
    equal going into the first MoE layer, pick one expert, and the
    third exceeds C = 2, so its routed output is dropped.  On both sides
    the first two slots' logits are equal and the third's differ; the
    port's keep mask is [kept, kept, dropped] in that layer; the logits
    agree with JAX's."""
    rng = np.random.RandomState(14)
    ctx = make_context(jm.tcfg)
    prompt = rng.randint(0, jm.tcfg.vocab, 11).astype(np.int32)
    alloc = SlotAllocator(SLOTS, MAX_SEQ, PSZ, num_pages=NUM_PAGES)
    jcache = jm.init_cache()
    tcache = PagedKVCache(jm.tcfg, num_slots=SLOTS, max_seq=MAX_SEQ,
                          page_size=PSZ, num_pages=NUM_PAGES, device="cpu")
    _, jpre = jm.jax_prefill(prompt)
    toks = np.zeros((1, PREFILL), np.int32)
    toks[0, :len(prompt)] = prompt
    _, tpre = TM.forward_prefill(jm.tparams, torch.tensor(toks), ctx,
                                 last_pos=torch.tensor([len(prompt) - 1]))
    for _ in range(SLOTS):
        slot = alloc.alloc(len(prompt))
        jcache = jm.insert(jcache, jpre, jnp.asarray(slot, jnp.int32),
                           own_copy(alloc.block_table[slot]))
        tcache.insert(tpre, alloc.block_table[slot])
    pos = np.full(SLOTS, len(prompt), np.int32)
    for s in range(SLOTS):
        alloc.ensure(s, len(prompt) + 1)
    token = np.full(SLOTS, 7, np.int32)
    jl, _ = jm.jax_decode("fused", jcache, token, pos, alloc)
    keeps = []
    orig = TMOE._dispatch_slots

    def spy(idx, E, C):
        keep, row = orig(idx, E, C)
        keeps.append((keep.numpy().copy(), C))
        return keep, row

    TMOE._dispatch_slots = spy
    try:
        tl, _ = TM.forward_decode(jm.tparams, tcache.buffers,
                                  torch.tensor(token), torch.tensor(pos),
                                  ctx, aux_extra=step_aux(alloc, "fused"))
    finally:
        TMOE._dispatch_slots = orig
    moe_layers = jm.tcfg.pattern.count("attn_moe") * jm.tcfg.n_units
    assert len(keeps) == moe_layers
    # the first MoE layer drops the third slot; past it that slot's rows
    # differ from the others', which stay equal and kept
    np.testing.assert_array_equal(keeps[0][0], [True, True, False])
    for keep, C in keeps:
        assert C == 2 and keep[0] and keep[1]
    tl = tl.numpy()
    np.testing.assert_allclose(tl, jl, atol=LOGIT_TOL, rtol=0)
    for logits in (tl, jl):
        np.testing.assert_array_equal(logits[0], logits[1])
        assert np.abs(logits[2] - logits[0]).max() > 100 * LOGIT_TOL


def test_prefill_matches_jax():
    check_prefill(MODELS[CODEC])


def test_teacher_forced_paged_decode_matches_jax():
    check_teacher_forced(MODELS[CODEC])


def test_forward_verify_matches_jax():
    check_verify(MODELS[CODEC])


def test_engine_streams_match_jax_replay():
    check_streams_replay(MODELS[CODEC])


def test_third_slot_routed_output_dropped():
    check_third_slot_dropped(MODELS[CODEC])
