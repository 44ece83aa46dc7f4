"""The port's serving engine on the CPU: greedy streams under continuous
batching.

One fixed schedule — seven requests of mixed prompt lengths and budgets
on three slots, so requests queue, admit into freed slots and share the
page pool — runs through the port's ``ServingEngine`` for every codec
(``spike_fused``, ``none``, ``spike``, ``spike_pack4``,
``sparse_topk``).  Each request's stream must equal:

1. its solo greedy loop through the JAX model-level steps (the helpers
   of ``test_torch_model.py``), under that file's margin rule.  The JAX
   ``ServingEngine`` class is not the oracle: on the CPU its greedy
   tokens differ from run to run;
2. the port's own solo run of the request;
3. the port's ``attn_kernel="reference"`` run of the whole schedule;
4. a second run of the same engine configuration.

Every page is free at the end.  A tight pool (preemption) and an EOS
schedule run the same comparisons.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_model import (MAX_SEQ, MODELS, PREFILL, PSZ,  # noqa: E402
                              SLOTS, assert_greedy_agrees)

from repro_torch.serving import (EngineConfig, EngineConfigError,  # noqa: E402
                                 PagePoolExhausted, Request, ServingEngine)

torch.set_num_threads(1)


def _schedule(seed=21, n=7):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, PREFILL + 1, n)
    news = rng.randint(3, 11, n)
    return [(rng.randint(0, 256, int(L)).astype(np.int32).tolist(), int(m))
            for L, m in zip(lens, news)]


SCHEDULE = _schedule()
_JAX_SOLO = {}


def _jax_solo(codec, eos_id=None):
    key = (codec, eos_id)
    if key not in _JAX_SOLO:
        _JAX_SOLO[key] = [MODELS[codec].greedy_solo(p, m, eos_id=eos_id)
                          for p, m in SCHEDULE]
    return _JAX_SOLO[key]


def _run(codec, reqs, **kw):
    return run_engine(MODELS[codec], reqs, **kw)


def run_engine(jm, reqs, **kw):
    """One port engine run of ``reqs`` ((rid, (prompt, new)) pairs) on
    ``jm``'s port parameters; every page and slot free at the end.
    Returns (streams, engine)."""
    ecfg = EngineConfig(num_slots=SLOTS, max_seq=MAX_SEQ,
                        prefill_len=PREFILL, page_size=PSZ, **kw)
    eng = ServingEngine(jm.tcfg, jm.tparams, ecfg, device="cpu")
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in reqs])
    alloc = eng.cache.allocator
    assert alloc.pages_in_use == 0 and alloc.num_free == SLOTS
    assert eng.idle
    return out, eng


def _check_schedule(codec, **kw):
    reqs = list(enumerate(SCHEDULE))
    batched, eng = _run(codec, reqs, **kw)
    assert sorted(batched) == list(range(len(SCHEDULE)))
    again, _ = _run(codec, reqs, **kw)
    assert again == batched
    ref, _ = _run(codec, reqs, attn_kernel="reference", **kw)
    assert ref == batched
    for i, (p, m) in reqs:
        solo, _ = _run(codec, [(i, (p, m))], **kw)
        assert solo[i] == batched[i], i
        toks, margins = _jax_solo(codec, kw.get("eos_id"))[i]
        assert_greedy_agrees(toks, margins, batched[i])
        # the recorded margins are the logit gaps the tokens came from
        if toks == batched[i]:
            np.testing.assert_allclose(eng.margins[i], margins, atol=1e-5)
    return batched, eng


def check_streams_match_jax(jm, schedule=SCHEDULE):
    """The port engine's greedy streams of ``schedule`` on ``jm``: both
    walks give the same streams, and each equals its JAX solo greedy
    loop (``JaxModel.greedy_solo``) under the margin rule."""
    reqs = list(enumerate(schedule))
    batched, _ = run_engine(jm, reqs)
    ref, _ = run_engine(jm, reqs, attn_kernel="reference")
    assert ref == batched
    for i, (p, m) in reqs:
        assert len(batched[i]) == m
        toks, margins = jm.greedy_solo(p, m)
        assert_greedy_agrees(toks, margins, batched[i])


@pytest.mark.parametrize("codec", ["spike_fused", "none", "spike",
                                   "spike_pack4", "sparse_topk"])
def test_engine_streams_match_solo_reference_and_jax(codec):
    batched, eng = _check_schedule(codec)
    for i, (_, m) in enumerate(SCHEDULE):
        assert len(batched[i]) == m
    assert eng.preemptions == 0


def test_engine_tight_pool_preempts_without_changing_streams():
    """An 8-page pool under three slots whose requests grow to 2-4 pages
    each: the pool, not the slot count, binds, and preempted requests
    restart with identical streams."""
    batched, eng = _check_schedule("spike_fused", num_pages=8)
    assert eng.preemptions > 0
    with pytest.raises(PagePoolExhausted):
        _check_schedule("spike_fused", num_pages=8, preempt=False)


def test_engine_eos_retires_early():
    """EOS = the first token new to its stream in the first request whose
    stream has one; that request stops right there, and any request whose
    first token is that id retires at admission."""
    for r, (toks, _) in enumerate(_jax_solo("spike_fused")):
        cut = [i for i in range(1, len(toks)) if toks[i] not in toks[:i]]
        if cut:
            break
    batched, _ = _check_schedule("spike_fused", eos_id=toks[cut[0]])
    assert batched[r] == toks[:cut[0] + 1]


def test_engine_config_limits():
    jm = MODELS["none"]
    for kw in ({"spec_k": 1, "drafter": "heads"}, {"async_depth": -1},
               {"top_k": -1}, {"top_p": 1.5}, {"disagg": True},
               {"attn_kernel": "dense"}):
        with pytest.raises(EngineConfigError):
            ServingEngine(jm.tcfg, jm.tparams, EngineConfig(**kw),
                          device="cpu")
    # sampling knobs and the n-gram spec path are honoured
    eng = ServingEngine(jm.tcfg, jm.tparams, EngineConfig(
        max_seq=32, top_k=4, top_p=0.9, seed=3, spec_k=1), device="cpu")
    out = eng.run([Request(rid=0, prompt=[1, 2], max_new_tokens=3,
                           temperature=0.7)])
    assert len(out[0]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ServingEngine(jm.tcfg, jm.tparams, EngineConfig())
