"""The port's serving engine on the recurrent-state families (reduced
``rwkv-paper``, ``xlstm-125m`` and one unit of ``jamba-1.5-large-398b``,
ANN float32, the port's seeded init; no JAX here).

* Exact-length prefill: every admission prefills the prompt (or, after
  a work-preserving resume, prompt plus committed tokens) at its own
  length, never right-padded to ``prefill_len``; the batched streams of
  prompts of lengths 4, 10 and 16 equal each request's solo run.
* ``spec_k=3`` is forced to 0 (a recurrent state cannot roll a rejected
  draft back): no verify step runs and the streams equal ``spec_k=0``'s.
* The slot-major state: ``state_bytes_per_slot() > 0``; a pool page
  holds KV only where there is attention (jamba), and ``rwkv-paper`` /
  ``xlstm-125m`` have no KV leaf while their allocator books pages as
  for any other family.
* ``preempt_slot`` and ``suspend`` / ``resume`` mid-run: the engine
  drains slot-, page- and limbo-clean and the streams equal the plain
  run's, token for token where its top-1/top-2 margin exceeds 1e-4 (a
  re-prefill sums what the decode steps summed, in another order).
* ``async_depth=1`` serves the ``async_depth=0`` streams.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_async import assert_drained  # noqa: E402
from test_torch_model import assert_greedy_agrees  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving import (EngineConfig, Request,  # noqa: E402
                                 ServingEngine)

torch.set_num_threads(1)

ARCHS = {"rwkv-paper": {}, "xlstm-125m": {},
         "jamba-1.5-large-398b": {"n_layers": 8}}
LENGTHS = (4, 10, 16, 10, 4, 16)
SLOTS = 3
_MODELS = {}


def model(arch):
    if arch not in _MODELS:
        cfg = reduced(get_config(arch, hnn_mode="ann")).replace(
            codec="none", dtype=torch.float32, **ARCHS[arch])
        gen = torch.Generator().manual_seed(0)
        _MODELS[arch] = cfg, init_params(M.model_defs(cfg), gen,
                                         torch.float32, device="cpu")
    return _MODELS[arch]


def requests(seed=3):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, prompt=rng.randint(0, 256, L).tolist(),
                    max_new_tokens=int(rng.randint(4, 9)))
            for i, L in enumerate(LENGTHS)]


def engine(arch, **kw):
    cfg, params = model(arch)
    return ServingEngine(cfg, params, EngineConfig(
        num_slots=SLOTS, max_seq=48, prefill_len=32, page_size=8, **kw),
        device="cpu")


class Prefills:
    """Records the token shape of every ``forward_prefill``."""

    def __init__(self, monkeypatch):
        self.shapes = []
        orig = M.forward_prefill

        def rec(params, tokens, ctx, last_pos=None):
            self.shapes.append(tuple(tokens.shape))
            return orig(params, tokens, ctx, last_pos=last_pos)

        monkeypatch.setattr(M, "forward_prefill", rec)


def run(eng, reqs, on_step=None):
    out = eng.run(reqs, on_step=on_step)
    assert_drained(eng)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_exact_length_prefill_and_solo_streams(arch, monkeypatch):
    rec = Prefills(monkeypatch)
    eng = engine(arch)
    batched = run(eng, requests())
    assert rec.shapes == [(1, len(r.prompt)) for r in requests()]
    for r in requests():
        assert len(batched[r.rid]) == r.max_new_tokens
        assert run(engine(arch), [r])[r.rid] == batched[r.rid]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_k_is_forced_to_zero(arch, monkeypatch):
    def no_verify(*a, **k):
        raise AssertionError("a recurrent family ran a verify step")

    monkeypatch.setattr(M, "forward_verify", no_verify)
    eng = engine(arch, spec_k=3)
    assert eng.spec_k == 0
    assert run(eng, requests()) == run(engine(arch), requests())
    assert eng.spec_verifies == 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_and_page_bytes(arch):
    eng = engine(arch)
    cache = eng.cache
    assert cache.state_bytes_per_slot() > 0
    if arch.startswith("jamba"):
        assert cache.kv_page_bytes() > 0
    else:
        assert cache.kv_page_bytes() == 0
        assert all("kv" not in c for c in cache.buffers.values())
    alloc = cache.allocator
    slot = alloc.alloc(10)
    assert alloc.pages_in_use == 2          # pages of 8 booked as ever
    alloc.free(slot)
    if arch == "rwkv-paper":
        pp = cache.buffers["pos0"]["rwkv_state"]["pp"]
        assert pp.shape[:2] == (2, SLOTS) and bool((pp == -1e30).all())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_preempt_and_suspend_resume(arch, monkeypatch):
    ref_eng = engine(arch)
    ref = run(ref_eng, requests())
    rec = Prefills(monkeypatch)
    eng = engine(arch)
    ticks = []

    def fault(e):
        ticks.append(len(ticks))
        if len(ticks) == 3 and e.active_slots():
            e.preempt_slot(e.active_slots()[-1], kind="injected_preempt")
        if len(ticks) == 5:
            e.resume(e.suspend())

    got = run(eng, requests(), on_step=fault)
    assert eng.preemptions == 1 and eng.suspends == 1
    # a resumed request re-prefills prompt + committed tokens, exactly
    assert any(s[1] not in LENGTHS for s in rec.shapes), rec.shapes
    for r in requests():
        assert_greedy_agrees(ref[r.rid], ref_eng.margins[r.rid], got[r.rid])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_async_depth_one_serves_the_sync_streams(arch):
    assert (run(engine(arch, async_depth=1), requests())
            == run(engine(arch), requests()))
