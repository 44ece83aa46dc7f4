"""The port's sampler against ``repro.serving.sampling`` at tp = 1.

On the same numpy-seeded logits:

* the top-k masks equal JAX's ``_apply_top_k`` for several k;
* the top-p masks equal JAX's ``_apply_top_p`` and the minimal nucleus
  of a sorted cumulative sum, for p in {0.1, 0.3, 0.6, 0.9, 0.99};
* greedy rows equal JAX's ``sample`` exactly in a batch that mixes them
  with stochastic rows, and stochastic rows stay inside the filters;
* 4096 draws of one row are within total-variation distance 0.06 of
  ``tests/_ref_sampling.host_reference_probs`` with no filter, top-k 8
  and top-p 0.6 (the JAX test's bound, row and draw count): torch's
  random numbers are not JAX's, so the stochastic path is held to the
  distribution, not to JAX's draws;
* the same seed gives the same draws, another seed others;
* ``sample_verify`` flattens [B, K1, V] into rows in order and repeats
  each slot's temperature K1 times;
* the engine samples at a request's temperature from admission on, two
  runs with one seed give the same streams, and the greedy requests of
  a sampled batch keep their greedy streams.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _ref_sampling import host_reference_probs  # noqa: E402
from repro.serving import sampling as JS  # noqa: E402

from repro_torch.serving import sampling as TS  # noqa: E402

torch.set_num_threads(1)


def _logits(seed, B, V, scale=3.0):
    return (np.random.RandomState(seed).standard_normal((B, V))
            * scale).astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("k", [1, 4, 8, 50, 128, 300])
def test_top_k_mask_matches_jax(k):
    lt = _logits(1, 8, 128)
    want = np.asarray(JS._apply_top_k(jnp.array(lt), k, None, 1))
    got = TS._apply_top_k(torch.tensor(lt), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.isfinite(got).sum(-1) == min(k, 128)).all()


@pytest.mark.parametrize("p", [0.1, 0.3, 0.6, 0.9, 0.99])
def test_top_p_mask_matches_jax_and_minimal_nucleus(p):
    B, V = 16, 128
    lt = _logits(2, B, V)
    want = np.asarray(JS._apply_top_p(jnp.array(lt), p, None, 1))
    got = TS._apply_top_p(torch.tensor(lt), p).numpy()
    np.testing.assert_array_equal(got, want)
    lt64 = lt.astype(np.float64)
    probs = np.exp(lt64 - lt64.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    for b in range(B):
        order = np.argsort(-probs[b])
        n_ref = int((np.cumsum(probs[b][order]) < p).sum()) + 1
        ref = np.zeros(V, bool)
        ref[order[:n_ref]] = True
        np.testing.assert_array_equal(np.isfinite(got[b]), ref)


@pytest.mark.parametrize("scfg", [dict(), dict(top_k=4), dict(top_p=0.5),
                                  dict(top_k=8, top_p=0.6)])
def test_greedy_rows_exact_in_a_mixed_batch(scfg):
    B, V = 8, 128
    logits = _logits(3, B, V)
    temps = np.array([0.0, 1.0, 0.0, 0.7] * 2, np.float32)
    want = np.asarray(JS.sample(jnp.array(logits), jax.random.PRNGKey(3),
                                jnp.array(temps), tp=None, tp_size=1,
                                cfg=JS.SamplingConfig(**scfg)))
    got = TS.sample(torch.tensor(logits), temps, _gen(3),
                    TS.SamplingConfig(**scfg)).numpy()
    assert got.dtype == np.int32 and got.shape == (B,)
    greedy = temps == 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    np.testing.assert_array_equal(got[greedy], logits[greedy].argmax(-1))
    # every stochastic draw lies inside the rows' filtered support
    lt = torch.tensor(logits) / torch.tensor(np.maximum(temps, 1e-6))[:, None]
    if scfg.get("top_k"):
        lt = TS._apply_top_k(lt, scfg["top_k"])
    if scfg.get("top_p"):
        lt = TS._apply_top_p(lt, scfg["top_p"])
    for b in np.flatnonzero(~greedy):
        assert np.isfinite(lt[b, got[b]].item())
    # an all-greedy batch draws nothing and needs no generator
    np.testing.assert_array_equal(
        TS.sample(torch.tensor(logits), np.zeros(B, np.float32)).numpy(),
        logits.argmax(-1))
    with pytest.raises(ValueError):
        TS.sample(torch.tensor(logits), temps)


@pytest.mark.parametrize("scfg", [dict(), dict(top_k=8), dict(top_p=0.6)])
def test_sampling_statistics_match_host_reference(scfg):
    """Per-row independence turns one [DRAWS, V] batch into DRAWS
    independent draws of one distribution."""
    V, DRAWS, TEMP = 64, 4096, 0.7
    row = np.random.RandomState(5).randn(V) * 2.0
    logits = torch.tensor(np.broadcast_to(row, (DRAWS, V)),
                          dtype=torch.float32)
    tok = TS.sample(logits, np.full(DRAWS, TEMP, np.float32), _gen(11),
                    TS.SamplingConfig(**scfg)).numpy()
    emp = np.bincount(tok, minlength=V) / DRAWS
    ref = host_reference_probs(row, TEMP, **scfg)
    tv = 0.5 * np.abs(emp - ref).sum()
    assert tv < 0.06, (scfg, tv)


def test_same_seed_same_draws():
    logits = torch.tensor(_logits(4, 64, 128, scale=1.0))
    temps = np.ones(64, np.float32)
    cfg = TS.SamplingConfig(top_k=50, top_p=0.9)
    a = TS.sample(logits, temps, _gen(7), cfg)
    b = TS.sample(logits, temps, _gen(7), cfg)
    c = TS.sample(logits, temps, _gen(8), cfg)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_gumbel_never_meets_log_zero():
    """A uniform draw of exactly 0 is clamped to the smallest normal
    float, as ``jax.random.gumbel`` draws it: the noise stays finite."""
    gen = _gen(0)
    g = TS.gumbel((4096, 64), gen, "cpu")
    assert torch.isfinite(g).all()
    orig = torch.rand
    try:
        torch.rand = lambda shape, **kw: torch.zeros(shape, dtype=kw["dtype"])
        g0 = TS.gumbel((2, 3), gen, "cpu")
    finally:
        torch.rand = orig
    tiny = np.float32(np.finfo(np.float32).tiny)
    want = -np.log(-np.log(tiny, dtype=np.float32), dtype=np.float32)
    assert torch.isfinite(g0).all() and np.allclose(g0.numpy(), want)


def test_sample_verify_shape_and_order():
    B, K1, V = 3, 4, 96
    logits = _logits(6, B * K1, V).reshape(B, K1, V)
    temps = np.array([0.0, 0.9, 0.0], np.float32)
    cfg = TS.SamplingConfig(top_k=16)
    got = TS.sample_verify(torch.tensor(logits), temps, _gen(9), cfg)
    assert got.shape == (B, K1) and got.dtype == torch.int32
    # the rows of sample() on the flattened logits, slot-major
    flat = TS.sample(torch.tensor(logits.reshape(B * K1, V)),
                     np.repeat(temps, K1), _gen(9), cfg)
    assert torch.equal(got, flat.reshape(B, K1))
    np.testing.assert_array_equal(got[0].numpy(), logits[0].argmax(-1))
    np.testing.assert_array_equal(got[2].numpy(), logits[2].argmax(-1))
    want = np.asarray(JS.sample_verify(
        jnp.array(logits), jax.random.PRNGKey(0), jnp.array(temps),
        tp=None, tp_size=1, cfg=JS.SamplingConfig(top_k=16)))
    np.testing.assert_array_equal(got.numpy()[[0, 2]], want[[0, 2]])


def test_engine_sampled_runs_repeat_and_keep_greedy_rows():
    """Three requests at temperature 0.8 (top-k 50, top-p 0.9) beside two
    greedy ones on three slots: the same seed gives the same streams,
    another seed other sampled streams, and the greedy requests keep
    the streams of an all-greedy run.  Under spec (n-gram drafter) the
    greedy requests keep them too."""
    from test_torch_engine import SCHEDULE
    from test_torch_model import (MAX_SEQ, MODELS, PREFILL, PSZ, SLOTS,
                                  assert_greedy_agrees)

    from repro_torch.serving import EngineConfig, Request, ServingEngine
    jm = MODELS["none"]
    temps = [0.8, 0.0, 0.8, 0.0, 0.8]

    def serve(seed, temps, **kw):
        eng = ServingEngine(jm.tcfg, jm.tparams, EngineConfig(
            num_slots=SLOTS, max_seq=MAX_SEQ, prefill_len=PREFILL,
            page_size=PSZ, top_k=50, top_p=0.9, seed=seed, **kw),
            device="cpu")
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=12,
                               temperature=t)
                       for i, ((p, _), t) in enumerate(zip(SCHEDULE, temps))])
        assert eng.cache.allocator.pages_in_use == 0
        return out, eng.margins

    a, _ = serve(1, temps)
    assert serve(1, temps)[0] == a
    b, _ = serve(2, temps)
    assert any(a[i] != b[i] for i, t in enumerate(temps) if t > 0)
    greedy, margins = serve(1, [0.0] * len(temps))
    for i, t in enumerate(temps):
        assert len(a[i]) == 12
        if t == 0:
            assert_greedy_agrees(greedy[i], margins[i], a[i])
            assert_greedy_agrees(greedy[i], margins[i], b[i])
    spec, _ = serve(1, temps, spec_k=3)
    assert serve(1, temps, spec_k=3)[0] == spec
    for i, t in enumerate(temps):
        if t == 0:
            assert_greedy_agrees(greedy[i], margins[i], spec[i])
