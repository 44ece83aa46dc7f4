"""The port's model against the JAX reference's model-level steps.

Reduced ``qwen1.5-0.5b`` in float32 with the JAX package's own init
(``init_sharded_params`` on a 1x1 mesh, as ``benchmarks/serve_bench.py``
builds it), carried across with ``params_from_jax``.  For ``ann``/codec
``none`` and, in HNN mode, every coded boundary codec (``spike_fused``;
``spike``, the T-tick IF encoder; ``spike_pack4``, T=7 packed two per
byte; ``sparse_topk``):

* prefill logits and prompt KV of right-padded prompts (``last_pos``),
* five teacher-forced decode steps over a shared paged pool holding
  three slots of mixed lengths, through the kernel walk (compacted page
  lists) and the reference walk (full block-table gather).

The reference steps are ``M.forward_prefill``, ``kv_cache.make_insert_fn``
and ``M.forward_decode`` under ``jax.shard_map`` on a 1x1 mesh, wrapped
as the serving engine wraps them but returning logits, built once per
codec on first use.  Every input is
made with numpy from a fixed seed and handed to each side as a fresh
copy — a JAX call is dispatched asynchronously and on the CPU may alias
a numpy buffer, so each gets its own (``own_copy``).  This module also
holds the helpers ``test_torch_engine.py`` shares: the JAX reference
model and its solo greedy loop.

The same reduced model in bfloat16 (the config's published dtype) runs
under ``spike`` through prefill and teacher-forced decode, with every
spike encode of both sides recorded: the counts must be equal up to the
first rounding split — a count whose two input values differ by at most
one bf16 ulp — and the logits within one bf16 ulp of each row's largest
JAX logit until then.  bf16 rounds at other places in XLA and torch
(XLA keeps some products in float32), so the boundaries' inputs differ
by bf16 rounding and exact equality can only be asked of the coded
values; on these inputs the counts never split and the logits differ by
at most 1.6e-3 at a largest logit of 0.58 (0.4 ulp).  bf16 argmax
streams are not compared: ties flip them.

Tolerance: logits agree within ``LOGIT_TOL`` = 1e-5 absolute, prompt
KV within 1e-5.  Both sides compute in float32, but XLA and torch sum
matmuls and softmaxes in different orders; the largest difference seen
on these inputs is 2.4e-7, so the bound leaves 40x headroom for that
reassociation.  It does not absorb a spike count landing on the other
side of a rounding boundary (a 1/15 step in one channel), which the
seeded inputs here do not produce.  Greedy tokens must be identical
wherever the JAX top-1/top-2 margin exceeds ``MARGIN`` = 1e-4.
"""
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeCell  # noqa: E402
from repro.configs.reduced import reduced as jax_reduced  # noqa: E402
from repro.core import spike as JS  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch import train as TR  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import kv_cache as JKV  # noqa: E402

from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.core import spike as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.context import make_context  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache, SlotAllocator  # noqa: E402

torch.set_num_threads(1)

ARCH = "qwen1.5-0.5b"
SLOTS, MAX_SEQ, PREFILL, PSZ = 3, 64, 32, 8
NUM_PAGES = SLOTS * (MAX_SEQ // PSZ)
LOGIT_TOL = 1e-5
MARGIN = 1e-4
CODECS = (("ann", "none"), ("hnn", "spike_fused"), ("hnn", "spike"),
          ("hnn", "spike_pack4"), ("hnn", "sparse_topk"))


class JaxModel:
    """The JAX reference at one codec: params, the port's copy of them,
    and the model-level prefill / insert / decode steps (jit-compiled
    lazily, once per process).  ``arch`` names the reduced architecture
    (``ARCH`` by default); ``overrides`` are config fields replaced on
    both sides alike (a GQA-keeping variant, say)."""

    def __init__(self, hnn, codec, dtype="float32", arch=ARCH,
                 overrides=None):
        over = dict(overrides or {})
        self.jcfg = jax_reduced(jax_get_config(arch, hnn_mode=hnn)).replace(
            codec=codec, dtype=getattr(jnp, dtype), **over)
        self.tcfg = reduced(get_config(arch, hnn_mode=hnn)).replace(
            codec=codec, dtype=getattr(torch, dtype), **over)
        mesh = self.mesh = make_mesh((1, 1), ("data", "model"))
        plan = SP.make_plan(self.jcfg, ShapeCell("serve_decode", MAX_SEQ,
                                                 SLOTS, "decode"), mesh)
        plan_pre = SP.make_plan(self.jcfg, ShapeCell("serve_admit", PREFILL,
                                                     1, "prefill"), mesh)
        self.params = TR.init_sharded_params(self.jcfg, plan, mesh,
                                             jax.random.PRNGKey(0))
        self.tparams = params_from_jax(jax.tree.map(np.asarray, self.params),
                                       self.tcfg, device="cpu")
        _, pspecs, _ = TR.shard_params_specs(self.jcfg, plan)
        self.pspecs = pspecs
        _, cspecs = SP.cache_specs(plan_pre)
        ctx_pre = SP.make_context(plan_pre, "prefill")

        def prefill(params, tokens, last_pos):
            return JM.forward_prefill(params, {"tokens": tokens}, ctx_pre,
                                      last_pos=last_pos)

        self.prefill = jax.jit(jax.shard_map(
            prefill, mesh=mesh, in_specs=(pspecs, P(None, "model"), P(None)),
            out_specs=(P(None), cspecs), check_vma=False))
        self.init_cache = JKV.make_init_fn(plan, mesh, PSZ, NUM_PAGES)
        self.insert = JKV.make_insert_fn(plan, plan_pre, mesh, PSZ,
                                         NUM_PAGES)
        _, ispecs = SP.serve_decode_input_specs(plan, PSZ, NUM_PAGES)
        ctx = SP.make_context(plan, "decode")
        self.decode = {}
        for kernel in ("fused", "reference"):
            def step(params, cache, token, pos, bt, clp, clo,
                     fused=kernel == "fused"):
                aux = {"block_table": bt}
                if fused:
                    aux["page_list"] = (clp, clo)
                return JM.forward_decode(params, cache, token, pos, ctx,
                                         aux_extra=aux)
            self.decode[kernel] = jax.jit(jax.shard_map(
                step, mesh=mesh,
                in_specs=(pspecs, ispecs["cache"], ispecs["token"],
                          ispecs["pos"], ispecs["bt"], ispecs["clp"],
                          ispecs["clo"]),
                out_specs=(P("data", "model"), ispecs["cache"]),
                check_vma=False))

        self._verify = {}

    def jax_verify(self, kernel, cache, tokens, pos, alloc):
        """The model-level ``forward_verify`` over the pool, as
        ``make_engine_verify_step`` builds it but returning logits
        [SLOTS, K1, V] (compiled on first use per walk and K1)."""
        K1 = tokens.shape[1]
        if (kernel, K1) not in self._verify:
            plan = SP.make_plan(self.jcfg, SP.verify_shape_cell(
                MAX_SEQ, SLOTS, K1 - 1), self.mesh)
            _, ispecs = SP.serve_verify_input_specs(plan, K1 - 1, PSZ,
                                                    NUM_PAGES)
            ctx = SP.make_context(plan, "decode")

            def step(params, cache, tokens, pos, bt, clp, clo,
                     fused=kernel == "fused"):
                aux = {"block_table": bt}
                if fused:
                    aux["page_list"] = (clp, clo)
                return JM.forward_verify(params, cache, tokens, pos, ctx,
                                         aux_extra=aux)
            self._verify[kernel, K1] = jax.jit(jax.shard_map(
                step, mesh=self.mesh,
                in_specs=(self.pspecs, ispecs["cache"], ispecs["token"],
                          ispecs["pos"], ispecs["bt"], ispecs["clp"],
                          ispecs["clo"]),
                out_specs=(P("data", None, "model"), ispecs["cache"]),
                check_vma=False))
        logits, cache = self._verify[kernel, K1](
            self.params, cache, jnp.array(tokens, jnp.int32),
            jnp.array(pos, jnp.int32), jnp.array(alloc.block_table),
            jnp.array(alloc.page_list_loc), jnp.array(alloc.page_list_pos))
        return np.asarray(logits), cache

    def jax_prefill(self, prompt):
        toks = np.zeros((1, PREFILL), np.int32)
        toks[0, :len(prompt)] = prompt
        logits, pre = self.prefill(self.params, jnp.array(toks),
                                   jnp.array([len(prompt) - 1], jnp.int32))
        return np.asarray(logits)[0], pre

    def jax_decode(self, kernel, cache, token, pos, alloc):
        logits, cache = self.decode[kernel](
            self.params, cache, jnp.array(token, jnp.int32),
            jnp.array(pos, jnp.int32), jnp.array(alloc.block_table),
            jnp.array(alloc.page_list_loc), jnp.array(alloc.page_list_pos))
        return np.asarray(logits), cache

    def greedy_solo(self, prompt, max_new_tokens, eos_id=None,
                    kernel="fused"):
        """The reference greedy stream of one request alone, by the
        model-level steps: (tokens, JAX top-1/top-2 margin per token)."""
        alloc = JKV.SlotAllocator(SLOTS, MAX_SEQ, PSZ, num_pages=NUM_PAGES)
        logits, pre = self.jax_prefill(prompt)
        slot = alloc.alloc(len(prompt))
        cache = self.insert(self.init_cache(), pre,
                            jnp.asarray(slot, jnp.int32),
                            own_copy(alloc.block_table[slot]))
        out, margins = [int(np.argmax(logits))], [margin(logits)]
        while not (len(out) >= max_new_tokens
                   or (eos_id is not None and out[-1] == eos_id)
                   or len(prompt) + len(out) - 1 >= MAX_SEQ):
            pos = len(prompt) + len(out) - 1
            alloc.ensure(slot, pos + 1)
            token = np.zeros(SLOTS, np.int32)
            posv = np.zeros(SLOTS, np.int32)
            token[slot], posv[slot] = out[-1], pos
            logits, cache = self.jax_decode(kernel, cache, token, posv,
                                            alloc)
            out.append(int(np.argmax(logits[slot])))
            margins.append(margin(logits[slot]))
        return out, margins


def own_copy(host):
    """A device array of its own for a host array the caller goes on
    changing.  A JAX call is dispatched asynchronously, and on the CPU
    ``jnp.asarray`` of a numpy view may alias the host buffer: an insert
    handed a block-table row that ``alloc.ensure`` extends before the
    insert has run scatters the prompt's padding into the newly mapped
    page."""
    return jnp.array(np.array(host))


def margin(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def assert_greedy_agrees(ref_tokens, ref_margins, tokens):
    """Streams agree token for token up to the first step whose JAX
    margin is at most ``MARGIN``; past a near-tie the continuation is
    not comparable."""
    for t, (a, b, m) in enumerate(zip(ref_tokens, tokens, ref_margins)):
        if m <= MARGIN:
            return
        assert a == b, (t, ref_tokens, tokens)
    assert len(ref_tokens) == len(tokens), (ref_tokens, tokens)


#: the parameter leaves the seeded init leaves at zero (biases, and the
#: norm scales, used as ``1 + scale``), so that no test would see one
#: dropped or misplaced
ZERO_INIT_LEAVES = ("bq", "bk", "bv", "ln", "ln2", "post_ln", "post_ln2",
                    "final_ln")


def seed_zero_init_leaves(jm, seed=16, scale=0.1):
    """Give every ``ZERO_INIT_LEAVES`` leaf of ``jm``'s JAX parameters
    seeded nonzero values (``seeded_leaves``), then carry the tree
    across to the port again."""
    jm.params = seeded_leaves(jm.params, seed, scale)
    jm.tparams = params_from_jax(jax.tree.map(np.asarray, jm.params),
                                 jm.tcfg, device="cpu")
    return jm


def seeded_leaves(params, seed=16, scale=0.1):
    """A JAX parameter tree whose ``ZERO_INIT_LEAVES`` leaves hold
    ``scale`` x standard normal values (numpy ``seed``, in sorted path
    order), each with its old leaf's dtype and sharding."""
    rng = np.random.RandomState(seed)

    def visit(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = visit(v)
            elif k in ZERO_INIT_LEAVES:
                new = (scale * rng.standard_normal(v.shape)).astype(
                    np.float32)
                out[k] = jax.device_put(jnp.asarray(new, v.dtype),
                                        v.sharding)
            else:
                out[k] = v
        return out

    return visit(params)


class _Models(dict):
    """codec -> ``JaxModel``, each built (and compiled) on first use, of
    ``arch`` with ``overrides``; ``seeded`` gives the zero-init leaves
    seeded values (``seed_zero_init_leaves``)."""

    def __init__(self, arch=ARCH, overrides=None, seeded=False):
        super().__init__()
        self.arch, self.overrides, self.seeded = arch, overrides, seeded

    def __missing__(self, codec):
        hnn = {c: h for h, c in CODECS}[codec]
        model = JaxModel(hnn, codec, arch=self.arch,
                         overrides=self.overrides)
        if self.seeded:
            seed_zero_init_leaves(model)
        self[codec] = model
        return model


MODELS = _Models()


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["none", "spike_fused"])
def test_params_carry_across(codec):
    jm = MODELS[codec]
    flat = jax.tree_util.tree_flatten_with_path(jm.params)[0]
    from repro_torch.checkpoint.convert import tree_paths
    port = dict(tree_paths(jm.tparams))
    assert sorted(port) == sorted(jax.tree_util.keystr(k) for k, _ in flat)
    for k, v in flat:
        np.testing.assert_array_equal(port[jax.tree_util.keystr(k)].numpy(),
                                      np.asarray(v))


def test_params_from_jax_rejects_bad_trees():
    jm = MODELS["none"]
    tree = jax.tree.map(np.asarray, jm.params)
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError):
        params_from_jax(bad, jm.tcfg, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "final_ln"}
    with pytest.raises(KeyError):
        params_from_jax(bad, jm.tcfg, device="cpu")
    bad = dict(tree, final_ln=np.zeros(7, np.float32))
    with pytest.raises(ValueError):
        params_from_jax(bad, jm.tcfg, device="cpu")


@pytest.mark.parametrize("codec", [c for _, c in CODECS])
def test_prefill_logits_and_kv(codec):
    check_prefill(MODELS[codec])


def check_prefill(jm):
    """Prefill logits and prompt KV of right-padded prompts, port vs
    JAX."""
    rng = np.random.RandomState(11)
    ctx = make_context(jm.tcfg)
    for P_len in (1, 13, PREFILL):
        prompt = rng.randint(0, jm.tcfg.vocab, P_len).astype(np.int32)
        jl, jpre = jm.jax_prefill(prompt)
        toks = np.zeros((1, PREFILL), np.int32)
        toks[0, :P_len] = prompt
        tl, tpre = TM.forward_prefill(jm.tparams, torch.tensor(toks), ctx,
                                      last_pos=torch.tensor([P_len - 1]))
        np.testing.assert_allclose(tl[0].numpy(), jl, atol=LOGIT_TOL,
                                   rtol=0)
        if margin(jl) > MARGIN:
            assert int(np.argmax(jl)) == int(torch.argmax(tl[0]))
        for i in range(len(jm.tcfg.pattern)):
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    tpre[f"pos{i}"]["kv"][n].numpy(),
                    np.asarray(jpre[f"pos{i}"]["kv"][n]), atol=1e-5,
                    rtol=1e-5)


@pytest.mark.parametrize("codec", [c for _, c in CODECS])
def test_teacher_forced_paged_decode(codec):
    """Three slots of mixed lengths share one pool; five decode steps
    feed fixed tokens (teacher forcing) through both attention walks on
    both sides."""
    check_teacher_forced(MODELS[codec])


def three_slots(jm, rng, ctx):
    """Three prompts of mixed lengths (5, 19, PREFILL) prefilled and
    inserted into one pool on both sides, once per walk.  Returns
    (allocator, JAX pools, port caches, per-slot next positions)."""
    alloc = SlotAllocator(SLOTS, MAX_SEQ, PSZ, num_pages=NUM_PAGES)
    jcache = {k: jm.init_cache() for k in ("fused", "reference")}
    tcache = {k: PagedKVCache(jm.tcfg, num_slots=SLOTS, max_seq=MAX_SEQ,
                              page_size=PSZ, num_pages=NUM_PAGES,
                              device="cpu")
              for k in ("fused", "reference")}
    pos = np.zeros(SLOTS, np.int32)
    for P_len in (5, 19, PREFILL):
        prompt = rng.randint(0, jm.tcfg.vocab, P_len).astype(np.int32)
        _, jpre = jm.jax_prefill(prompt)
        toks = np.zeros((1, PREFILL), np.int32)
        toks[0, :P_len] = prompt
        _, tpre = TM.forward_prefill(jm.tparams, torch.tensor(toks), ctx,
                                     last_pos=torch.tensor([P_len - 1]))
        slot = alloc.alloc(P_len)
        pos[slot] = P_len
        for k in jcache:
            jcache[k] = jm.insert(jcache[k], jpre,
                                  jnp.asarray(slot, jnp.int32),
                                  own_copy(alloc.block_table[slot]))
            tcache[k].insert(tpre, alloc.block_table[slot])
    return alloc, jcache, tcache, pos


def step_aux(alloc, kernel):
    """The port's ``aux_extra`` of one step on a walk."""
    aux = {"block_table": torch.tensor(alloc.block_table)}
    if kernel == "fused":
        aux["page_list"] = (torch.tensor(alloc.page_list_loc),
                            torch.tensor(alloc.page_list_pos))
    return aux


def assert_pools_close(tcache, jcache):
    """The port's pool pages equal JAX's (the port's last pool row is
    the sink of dropped writes, which JAX has no counterpart of)."""
    for kernel in jcache:
        for pos in jcache[kernel]:
            for n in ("k", "v"):
                np.testing.assert_allclose(
                    tcache[kernel].buffers[pos]["kv"][n][:, :NUM_PAGES]
                    .numpy(), np.asarray(jcache[kernel][pos]["kv"][n]),
                    atol=1e-5, rtol=1e-5)


def check_teacher_forced(jm):
    """Five teacher-forced decode steps of three slots over one pool,
    both walks, port vs JAX: logits, then the pools."""
    rng = np.random.RandomState(12)
    ctx = make_context(jm.tcfg)
    alloc, jcache, tcache, pos = three_slots(jm, rng, ctx)
    for _ in range(5):
        for s in range(SLOTS):
            alloc.ensure(s, int(pos[s]) + 1)
        token = rng.randint(0, jm.tcfg.vocab, SLOTS).astype(np.int32)
        for kernel in ("fused", "reference"):
            jl, jcache[kernel] = jm.jax_decode(kernel, jcache[kernel], token,
                                               pos, alloc)
            tl, _ = TM.forward_decode(jm.tparams, tcache[kernel].buffers,
                                      torch.tensor(token), torch.tensor(pos),
                                      ctx, aux_extra=step_aux(alloc, kernel))
            np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL,
                                       rtol=0)
            for s in range(SLOTS):
                if margin(jl[s]) > MARGIN:
                    assert int(np.argmax(jl[s])) == int(torch.argmax(tl[s]))
        pos += 1
    assert_pools_close(tcache, jcache)


# ---------------------------------------------------------------------------
# bfloat16 under the ``spike`` codec
# ---------------------------------------------------------------------------


def bf16_ulp(a):
    """The spacing of bf16 values at magnitude ``|a|`` (float32 array)."""
    a = np.maximum(np.abs(np.asarray(a, np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


class Bf16Spike:
    """The reduced model in bfloat16, codec ``spike``, on both sides, with
    every spike encode of a step recorded: the value its counts were
    rounded from and the counts.  On the JAX side a host callback at each
    encode site reports them (``JS.encode`` is patched while the steps
    are traced, which happens on their first call, inside ``traced``);
    the sites are numbered as they are traced and each fires once per
    scanned unit.  ``step(fn)`` returns both sides' events in the port's
    order: unit by unit, boundary by boundary."""

    def __init__(self):
        self.jm = JaxModel("hnn", "spike", "bfloat16")
        self.ctx = make_context(self.jm.tcfg)
        self._jax = {}
        self._port = []
        self._sites = itertools.count()

    def _record_jax(self, site, x, counts):
        self._jax.setdefault(site, []).append(
            (np.asarray(x, np.float32), np.asarray(counts, np.float32)))

    def _jax_encode(self, orig, x, params, cfg):
        counts = orig(x, params, cfg)
        jax.debug.callback(functools.partial(self._record_jax,
                                             next(self._sites)),
                           x.astype(jnp.float32), counts.astype(jnp.float32))
        return counts

    def _port_encode(self, orig, x, params, cfg):
        counts = orig(x, params, cfg)
        self._port.append((x.float().numpy().copy(),
                           counts.float().numpy().copy()))
        return counts

    def traced(self, jax_fn, port_fn):
        """Run ``jax_fn()`` and ``port_fn()`` with every encode recorded;
        returns (jax result, port result, jax events, port events)."""
        self._jax, self._port = {}, []
        j_orig, t_orig = JS.encode, TS.encode
        JS.encode = functools.partial(self._jax_encode, j_orig)
        TS.encode = functools.partial(self._port_encode, t_orig)
        try:
            jout = jax_fn()
            jax.effects_barrier()
            tout = port_fn()
        finally:
            JS.encode, TS.encode = j_orig, t_orig
        sites = sorted(self._jax)
        units = len(self._jax[sites[0]])
        jev = [self._jax[s][u] for u in range(units) for s in sites]
        return jout, tout, jev, self._port


_BF16 = []


def bf16_spike() -> Bf16Spike:
    if not _BF16:
        _BF16.append(Bf16Spike())
    return _BF16[0]


def first_rounding_split(jev, tev):
    """Index of the first encode whose counts differ on the two sides, or
    None.  Raises unless it is a rounding split: at every count that
    differs, the two values rounded from differ, by at most one bf16
    ulp, so each lies within one ulp of the count boundary between them
    (equal values must give equal counts: both codecs are exact)."""
    assert len(jev) == len(tev) > 0
    for i, ((jx, jc), (tx, tc)) in enumerate(zip(jev, tev)):
        assert jc.shape == tc.shape
        diff = jc != tc
        if diff.any():
            gap = np.abs(jx - tx)[diff]
            ulp = bf16_ulp(np.maximum(np.abs(jx), np.abs(tx))[diff])
            assert ((gap > 0) & (gap <= ulp)).all(), (i, gap, ulp)
            return i
    return None


def assert_bf16_logits_close(tl, jl):
    """Each row within one bf16 ulp of its largest JAX logit (the head
    matmul rounds to bf16)."""
    jl = np.asarray(jl, np.float32).reshape(-1, jl.shape[-1])
    tl = np.asarray(tl, np.float32).reshape(jl.shape)
    tol = bf16_ulp(np.abs(jl).max(axis=-1, keepdims=True))
    assert (np.abs(tl - jl) <= tol).all(), float(np.abs(tl - jl).max())


def test_bf16_spike_prefill_coded_values_and_logits():
    """Prefill of right-padded prompts in bf16 under ``spike``: every
    boundary's spike counts equal JAX's up to the first rounding split,
    and the logits within one bf16 ulp of the row's largest until then.
    (The boundaries' inputs differ by bf16 rounding elsewhere in the
    block — XLA keeps some products in float32 — so exact counts can only
    be asked up to a split; on these inputs none occurs.)"""
    bs = bf16_spike()
    rng = np.random.RandomState(11)
    for P_len in (1, 13, PREFILL):
        prompt = rng.randint(0, bs.jm.tcfg.vocab, P_len).astype(np.int32)
        toks = np.zeros((1, PREFILL), np.int32)
        toks[0, :P_len] = prompt
        (jl, _), (tl, _), jev, tev = bs.traced(
            lambda: bs.jm.jax_prefill(prompt),
            lambda: TM.forward_prefill(bs.jm.tparams, torch.tensor(toks),
                                       bs.ctx,
                                       last_pos=torch.tensor([P_len - 1])))
        assert len(jev) == 4 * bs.jm.tcfg.n_layers
        assert any(c.any() for _, c in tev)      # the wires carry spikes
        assert tl.dtype == torch.float32 and torch.isfinite(tl).all()
        if first_rounding_split(jev, tev) is None:
            assert_bf16_logits_close(tl[0].numpy(), jl)


def test_bf16_spike_teacher_forced_paged_decode():
    """Three slots of mixed lengths, five teacher-forced decode steps
    through both attention walks, bf16 pool: coded values and logits as
    in the prefill test, step by step until the first rounding split."""
    bs = bf16_spike()
    jm = bs.jm
    rng = np.random.RandomState(12)
    alloc, jcache, tcache, pos = three_slots(jm, rng, bs.ctx)
    split = {k: False for k in jcache}
    for _ in range(5):
        for s in range(SLOTS):
            alloc.ensure(s, int(pos[s]) + 1)
        token = rng.randint(0, jm.tcfg.vocab, SLOTS).astype(np.int32)
        for kernel in ("fused", "reference"):
            aux = step_aux(alloc, kernel)
            (jl, jcache[kernel]), (tl, _), jev, tev = bs.traced(
                lambda: jm.jax_decode(kernel, jcache[kernel], token, pos,
                                      alloc),
                lambda: TM.forward_decode(
                    jm.tparams, tcache[kernel].buffers, torch.tensor(token),
                    torch.tensor(pos), bs.ctx, aux_extra=aux))
            assert len(jev) == 4 * jm.tcfg.n_layers
            assert torch.isfinite(tl).all()
            if split[kernel]:
                continue
            split[kernel] = first_rounding_split(jev, tev) is not None
            if not split[kernel]:
                assert_bf16_logits_close(tl.numpy(), jl)
        pos += 1
