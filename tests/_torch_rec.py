"""Shared helpers of the recurrent-state families' tests (``rwkv-paper``,
``xlstm-125m``, ``jamba-1.5-large-398b``): the JAX reference model with
exact-length prefill, and the model-level checks of the port against it.

The reference engine prefills a recurrent family at the prompt's exact
length (one program per length, ``ServingEngine._prefill_for``), since
right-padding would fold into the state; ``RecJaxModel`` does the same
with the model-level steps: ``forward_prefill`` under ``shard_map`` on a
1x1 mesh per prompt length, ``kv_cache.make_insert_fn`` per length (its
KV scatter reads the prefill's length), and ``JaxModel``'s decode steps
over the paged pool and slot-major state.  The reference's chunked scans
take only lengths of at most one chunk (64 in ``blocks_rnn``, 256 in
``blocks_ssm``) or a multiple of one, so every length here is one the
reference takes.

Tolerance: logits and every state leaf within 1e-5 of the largest entry
of the JAX value (``assert_close_to_scale``).  Both sides compute in
float32; XLA and torch reassociate sums (the reference's mamba scan is
an associative scan, the port's a recurrence; the port's RWKV prefill
takes a chunk of tokens at once), and the largest difference seen on
these inputs is far below the bound (``test_torch_rnn.py`` records it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import ShapeCell  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import kv_cache as JKV  # noqa: E402

from test_torch_model import (MARGIN, MAX_SEQ, NUM_PAGES, PSZ,  # noqa: E402
                              SLOTS, JaxModel, assert_greedy_agrees,
                              margin, own_copy, step_aux)

from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.context import make_context  # noqa: E402
from repro_torch.serving import (EngineConfig, Request,  # noqa: E402
                                 ServingEngine)
from repro_torch.serving.kv_cache import PagedKVCache, SlotAllocator  # noqa: E402

TOL = 1e-5
#: jamba at one unit of its 8-layer pattern, on both sides
JAMBA_ONE_UNIT = {"n_layers": 8}
#: the recurrent blocks' leaves the init leaves constant (zero scales,
#: RWKV's decays and bonuses, mixes of 0.5, mamba's dt bias, A and skip),
#: seeded so that no test would see one dropped or misplaced
SEEDED = ("ln", "ln1", "ln2", "final_ln", "time_decay", "time_first",
          "mix_kvr", "mix_cm", "dt_bias", "d_skip", "a_log")


def seed_leaves(params, seed=16, scale=0.3):
    """A JAX parameter tree whose ``SEEDED`` leaves hold their init plus
    ``scale`` x standard normal values (numpy ``seed``, sorted path
    order)."""
    rng = np.random.RandomState(seed)

    def visit(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = visit(v)
            elif k in SEEDED:
                new = (np.asarray(v, np.float32)
                       + scale * rng.standard_normal(v.shape)).astype(
                           np.float32)
                out[k] = jax.device_put(jnp.asarray(new, v.dtype),
                                        v.sharding)
            else:
                out[k] = v
        return out

    return visit(params)


def assert_close_to_scale(got, want, tol=TOL, what=""):
    """``|got - want| <= tol * max|want|`` elementwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)
    return err / scale


class RecJaxModel(JaxModel):
    """``JaxModel`` of a recurrent family, prefilled at exact lengths."""

    def __init__(self, hnn, codec, arch, overrides=None, dtype="float32",
                 seeded=True):
        super().__init__(hnn, codec, dtype, arch, overrides)
        self.plan = SP.make_plan(self.jcfg, ShapeCell(
            "serve_decode", MAX_SEQ, SLOTS, "decode"), self.mesh)
        if seeded:
            self.params = seed_leaves(self.params)
            self.tparams = params_from_jax(
                jax.tree.map(np.asarray, self.params), self.tcfg,
                device="cpu")
        self._pre = {}
        self.insert = self._insert

    def _programs(self, S):
        """(prefill, insert) of an S-token prompt, built on first use."""
        if S not in self._pre:
            plan_pre = SP.make_plan(self.jcfg, ShapeCell(
                "serve_admit", S, 1, "prefill"), self.mesh)
            _, cspecs = SP.cache_specs(plan_pre)
            ctx = SP.make_context(plan_pre, "prefill")

            def prefill(params, tokens):
                return JM.forward_prefill(params, {"tokens": tokens}, ctx)

            self._pre[S] = (
                jax.jit(jax.shard_map(
                    prefill, mesh=self.mesh,
                    in_specs=(self.pspecs, P(None, "model")),
                    out_specs=(P(None), cspecs), check_vma=False)),
                JKV.make_insert_fn(self.plan, plan_pre, self.mesh, PSZ,
                                   NUM_PAGES))
        return self._pre[S]

    def jax_prefill(self, prompt):
        prompt = np.asarray(prompt, np.int32)
        self._last_len = len(prompt)
        logits, pre = self._programs(len(prompt))[0](
            self.params, jnp.array(prompt[None]))
        return np.asarray(logits)[0], pre

    def _insert(self, cache, pre, slot, row):
        """The insert of the last prompt ``jax_prefill`` ran."""
        return self._programs(self._last_len)[1](cache, pre, slot, row)


class RecModels(dict):
    """(hnn, codec) -> ``RecJaxModel`` of ``arch``, built on first use."""

    def __init__(self, arch, overrides=None):
        super().__init__()
        self.arch, self.overrides = arch, overrides

    def __missing__(self, key):
        hnn, codec = key
        model = RecJaxModel(hnn, codec, self.arch, self.overrides)
        self[key] = model
        return model


def port_prefill(jm, prompt, ctx=None):
    ctx = ctx or make_context(jm.tcfg)
    prompt = np.asarray(prompt, np.int64)
    return TM.forward_prefill(jm.tparams, torch.tensor(prompt[None]), ctx)


def assert_caches_close(tcache, jcache, what=""):
    """Every leaf of a port cache (state leaves, KV pool pages; the
    port's sink row left out) within ``TOL`` of the largest entry of the
    JAX leaf."""
    for pos, c in jcache.items():
        for key, leaves in c.items():
            for n, want in leaves.items():
                got = tcache[pos][key][n]
                if key == "kv" and got.shape[1] == want.shape[1] + 1:
                    got = got[:, :-1]
                assert_close_to_scale(got.numpy(), np.asarray(want),
                                      what=f"{what}{pos}/{key}/{n}")


def check_prefill(jm, lengths=(16, 32)):
    """Prefill logits and the prompt's caches (every state leaf, KV at
    attention positions) at exact lengths, port vs JAX."""
    rng = np.random.RandomState(11)
    for S in lengths:
        prompt = rng.randint(0, jm.tcfg.vocab, S)
        jl, jpre = jm.jax_prefill(prompt)
        tl, tpre = port_prefill(jm, prompt)
        assert_close_to_scale(tl[0].numpy(), jl, what=f"S={S} logits ")
        if margin(jl) > MARGIN:
            assert int(np.argmax(jl)) == int(torch.argmax(tl[0]))
        assert_caches_close(tpre, jpre, f"S={S} ")


def three_slots(jm, rng, lengths=(4, 10, 16)):
    """Three prompts prefilled at their exact lengths and inserted into
    one pool and state on both sides, once per walk.  Returns
    (allocator, JAX caches, port caches, per-slot next positions)."""
    alloc = SlotAllocator(SLOTS, MAX_SEQ, PSZ, num_pages=NUM_PAGES)
    jcache = {k: jm.init_cache() for k in ("fused", "reference")}
    tcache = {k: PagedKVCache(jm.tcfg, num_slots=SLOTS, max_seq=MAX_SEQ,
                              page_size=PSZ, num_pages=NUM_PAGES,
                              device="cpu")
              for k in ("fused", "reference")}
    pos = np.zeros(SLOTS, np.int32)
    for S in lengths:
        prompt = rng.randint(0, jm.tcfg.vocab, S)
        _, jpre = jm.jax_prefill(prompt)
        _, tpre = port_prefill(jm, prompt)
        slot = alloc.alloc(S)
        pos[slot] = S
        for k in jcache:
            jcache[k] = jm.insert(jcache[k], jpre,
                                  jnp.asarray(slot, jnp.int32),
                                  own_copy(alloc.block_table[slot]))
            tcache[k].insert(tpre, alloc.block_table[slot], slot)
    return alloc, jcache, tcache, pos


def check_teacher_forced(jm, steps=4, walks=("fused", "reference")):
    """Teacher-forced decode steps of three slots over one pool and
    state, port vs JAX: logits every step, then every cache leaf."""
    rng = np.random.RandomState(12)
    ctx = make_context(jm.tcfg)
    alloc, jcache, tcache, pos = three_slots(jm, rng)
    for _ in range(steps):
        for s in range(SLOTS):
            alloc.ensure(s, int(pos[s]) + 1)
        token = rng.randint(0, jm.tcfg.vocab, SLOTS).astype(np.int32)
        for kernel in walks:
            jl, jcache[kernel] = jm.jax_decode(kernel, jcache[kernel], token,
                                               pos, alloc)
            tl, _ = TM.forward_decode(jm.tparams, tcache[kernel].buffers,
                                      torch.tensor(token), torch.tensor(pos),
                                      ctx, aux_extra=step_aux(alloc, kernel))
            assert_close_to_scale(tl.numpy(), jl, what=f"{kernel} logits ")
        pos += 1
    for kernel in walks:
        assert_caches_close(tcache[kernel].buffers, jcache[kernel],
                            f"{kernel} ")


def check_logits(jm, S=32):
    """Teacher-forced logits at every position (``forward_logits``, the
    reference's ``make_logits_step``) of two rows, port vs JAX."""
    plan = SP.make_plan(jm.jcfg, ShapeCell("logits", S, 2, "train"),
                        jm.mesh)
    ctx = SP.make_context(plan, "train").with_(collect_stats=False)

    def step(params, tokens):
        aux = JM._make_aux({"tokens": tokens}, ctx)
        x = JM.embed_tokens(params, tokens, ctx)
        x, _, _, _ = JM._run_stack(params, x, ctx, aux)
        return JM.lm_logits_local(params, x, ctx)[0]

    fn = jax.jit(jax.shard_map(step, mesh=jm.mesh,
                               in_specs=(jm.pspecs, P(None, "model")),
                               out_specs=P(None, None, "model"),
                               check_vma=False))
    toks = np.random.RandomState(13).randint(0, jm.tcfg.vocab, (2, S))
    jl = np.asarray(fn(jm.params, jnp.array(toks, jnp.int32)))
    tl = TM.forward_logits(jm.tparams, torch.tensor(toks),
                           make_context(jm.tcfg))
    assert_close_to_scale(tl.numpy(), jl, what="forward_logits ")


#: the engine schedule of the recurrent families: prompt lengths 4, 10
#: and 16 (one JAX prefill program each), mixed budgets, more requests
#: than slots
def schedule(seed=21, lengths=(4, 10, 16, 10, 4, 16, 10), vocab=256):
    rng = np.random.RandomState(seed)
    news = rng.randint(3, 9, len(lengths))
    return [(rng.randint(0, vocab, L).astype(np.int32).tolist(), int(m))
            for L, m in zip(lengths, news)]


def run_engine(jm, reqs, **kw):
    """One port engine run; every page and slot free at the end.
    Returns (streams, engine)."""
    ecfg = EngineConfig(num_slots=SLOTS, max_seq=MAX_SEQ, prefill_len=32,
                        page_size=PSZ, **kw)
    eng = ServingEngine(jm.tcfg, jm.tparams, ecfg, device="cpu")
    out = eng.run([Request(rid=i, prompt=p, max_new_tokens=m)
                   for i, (p, m) in reqs])
    alloc = eng.cache.allocator
    assert alloc.pages_in_use == 0 and alloc.num_free == SLOTS
    assert eng.idle
    return out, eng


def check_streams(jm, sched=None, walks=("fused", "reference")):
    """The port engine's greedy streams of a schedule: every walk gives
    the same streams, and each equals its JAX solo greedy loop under the
    margin rule (``JaxModel.greedy_solo`` with exact-length prefill)."""
    sched = sched or schedule(vocab=jm.tcfg.vocab)
    reqs = list(enumerate(sched))
    runs = [run_engine(jm, reqs, attn_kernel=k)[0] for k in walks]
    assert all(r == runs[0] for r in runs)
    for i, (p, m) in reqs:
        assert len(runs[0][i]) == m
        toks, margins = jm.greedy_solo(p, m)
        assert_greedy_agrees(toks, margins, runs[0][i])
    return runs[0]


def check_split_prefill(jm, S=100, head=64):
    """At a length the reference cannot prefill (its chunked scans take
    only multiples of a chunk past the first), the port's prefill state
    equals its prefill of the first ``head`` tokens followed by ``S -
    head`` teacher-forced decode steps of the same tokens, within
    ``TOL`` of each leaf's largest entry, and so do the last logits."""
    tcfg = jm.tcfg
    ctx = make_context(tcfg)
    prompt = np.random.RandomState(14).randint(0, tcfg.vocab, S)
    full_logits, full = port_prefill(jm, prompt, ctx)
    logits, part = port_prefill(jm, prompt[:head], ctx)
    cache = PagedKVCache(tcfg, num_slots=1, max_seq=S + 8, page_size=PSZ,
                         num_pages=-(-(S + 8) // PSZ), device="cpu")
    slot = cache.admit(part, head)
    for t in range(head, S):
        cache.ensure(slot, t + 1)
        logits, _ = TM.forward_decode(
            jm.tparams, cache.buffers, torch.tensor([int(prompt[t])]),
            torch.tensor([t]), ctx,
            aux_extra={"block_table": torch.tensor(cache.block_table)})
    for pos, c in full.items():
        for key, leaves in c.items():
            if key == "kv":
                continue
            for n, want in leaves.items():
                assert_close_to_scale(cache.buffers[pos][key][n][:, 0],
                                      want[:, 0], what=f"{pos}/{key}/{n}")
    assert_close_to_scale(logits[0].numpy(), full_logits[0].numpy(),
                          what="logits ")
