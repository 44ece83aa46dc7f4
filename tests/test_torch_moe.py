"""The port's MoE block against the JAX reference's, at reduced widths.

``repro_torch.models.blocks_moe.moe_fwd`` and ``repro.models.blocks_moe.
moe_fwd`` (tp = 1, so no collective: the JAX block runs outside
``shard_map``) on the same numpy-seeded parameters and inputs, for the
reduced ``qwen2-moe-a2.7b`` (8 experts, top-2, one shared expert) and
``llama4-maverick-400b-a17b`` (8 experts, top-1, one shared expert), in
prefill (one 32-token prompt: cf 4.0), decode (three slots, K1 = 1 and
the verify step's K1 = 4: cf 4.0) and train mode (2 x 16 tokens: cf
1.25, with the ``sp_disp`` penalty and the aux loss), in float32 and
bfloat16:

* the router's expert indices equal JAX's ``_route``'s, its gates
  within 1e-6;
* the assignments kept equal those of the reference's capacity rule
  (its token-major cumsum over the flattened one-hot, here written with
  JAX ops on JAX's indices);
* the block's output within 1e-5 (float32; bfloat16 within two bf16
  steps of each row's largest value: XLA and torch round bf16
  intermediates at other places) and the penalty within 1e-5.

Identical rows force drops: every token picks the same experts, so all
but C of each expert's assignments are dropped (llama4's three decode
slots at C = 2, qwen2-moe's 32 training tokens at C = 5).  The
fixed-order combine gives the same bits on a second call.  The
bfloat16 cases and SNN mode are in ``test_torch_moe_bf16.py`` (JAX
compiles each op once per shape and dtype, so the dtypes are split over
files for the 30 s budget).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.reduced import reduced as jax_reduced  # noqa: E402
from repro.models import blocks_moe as JMOE  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models.context import Context as JContext  # noqa: E402
from repro.models.context import codec_from_name as jax_codec  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import blocks_moe as TMOE  # noqa: E402
from repro_torch.models.context import make_context  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b")
#: (mode, B, S): one prompt, a decode step and a verify step of three
#: slots, a training microbatch
SHAPES = (("prefill", 1, 32), ("decode", 3, 1), ("decode", 3, 4),
          ("train", 2, 16))
TOL = 1e-5
GATE_TOL = 1e-6


def configs(arch, dtype, hnn="hnn", codec="spike_fused"):
    jcfg = jax_reduced(jax_get_config(arch, hnn_mode=hnn)).replace(
        codec=codec, dtype=getattr(jnp, dtype))
    tcfg = reduced(get_config(arch, hnn_mode=hnn)).replace(
        codec=codec, dtype=getattr(torch, dtype))
    return jcfg, tcfg


def block_params(tcfg, seed=0):
    """numpy parameters of one MoE block, every leaf seeded (norm scale,
    router, experts, shared expert, boundary thresholds and scales)."""
    rng = np.random.RandomState(seed)
    out = {}
    defs = TMOE.moe_defs(tcfg)
    for name in sorted(defs):
        d = defs[name]
        if isinstance(d, dict):       # a boundary's theta and log_scale
            C = d["theta"].shape[0]
            out[name] = {"theta": rng.uniform(0.0, 0.1, C).astype(np.float32),
                         "log_scale": rng.uniform(-0.5, 0.5, C).astype(
                             np.float32)}
            continue
        scale = {"ln2": 0.1, "wr": 0.3}.get(name, 0.1)
        out[name] = (scale * rng.standard_normal(d.shape)).astype(np.float32)
    return out


def _to_jax(tree, jcfg):
    def leaf(name, v):
        dt = jnp.float32 if name in ("wr", "theta", "log_scale") else \
            jcfg.dtype
        return jnp.asarray(v, dt)
    return {k: ({n: leaf(n, a) for n, a in v.items()} if isinstance(v, dict)
                else leaf(k, v)) for k, v in tree.items()}


def _to_torch(tree, tcfg):
    def leaf(name, v):
        dt = torch.float32 if name in ("wr", "theta", "log_scale") else \
            tcfg.dtype
        return torch.tensor(v).to(dt)
    return {k: ({n: leaf(n, a) for n, a in v.items()} if isinstance(v, dict)
                else leaf(k, v)) for k, v in tree.items()}


def jax_context(jcfg, mode):
    return JContext(cfg=jcfg, dp=("data",), tp="model", dp_size=1,
                    tp_size=1, codec=jax_codec(jcfg.codec, jcfg.hnn_mode),
                    mode=mode)


def jax_keep(idx, E, C):
    """The reference's capacity rule (``blocks_moe.moe_fwd``), on JAX's
    indices."""
    T, k = idx.shape
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = onehot.reshape(T * k, E)
    ranks = jnp.cumsum(flat, axis=0) - flat
    rank = jnp.sum(ranks * flat, axis=-1)
    return np.asarray(rank < C)


def inputs(shape, D, seed, same_rows=False):
    rng = np.random.RandomState(seed)
    _, B, S = shape
    if same_rows:
        return np.tile(rng.standard_normal((1, 1, D)), (B, S, 1)).astype(
            np.float32)
    return rng.standard_normal((B, S, D)).astype(np.float32)


def run_both(arch, dtype, shape, seed=1, same_rows=False, hnn="hnn",
             codec="spike_fused"):
    """Both blocks on one input: a dict of numpy results."""
    mode, B, S = shape
    jcfg, tcfg = configs(arch, dtype, hnn, codec)
    p = block_params(tcfg)
    x = inputs(shape, tcfg.d_model, seed, same_rows)
    jp, tp = _to_jax(p, jcfg), _to_torch(p, tcfg)
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.tensor(x).to(tcfg.dtype)
    jctx = jax_context(jcfg, mode)
    jy, jpen, jocc = JMOE.moe_fwd(jp, jx, jctx, {})
    d = JMOE.moe_dims(jcfg, 1)
    jh = JC.norm(jx, jp["ln2"], jcfg.norm).reshape(B * S, -1)
    jg, jidx, _ = JMOE._route(jcfg, d, jh, jp["wr"])
    C = TMOE.capacity(tcfg, B * S, mode)

    seen = {}
    orig = TMOE._dispatch_slots

    def spy(idx, E, C_):
        keep, row = orig(idx, E, C_)
        seen.update(keep=keep.numpy().copy(), C=C_)
        return keep, row

    TMOE._dispatch_slots = spy
    try:
        ty, tpen, tocc = TMOE.moe_fwd(tp, tx, make_context(tcfg, mode))
        ty2, _, _ = TMOE.moe_fwd(tp, tx, make_context(tcfg, mode))
    finally:
        TMOE._dispatch_slots = orig
    th = TMOE.common.norm(tx, tp["ln2"], tcfg.norm)
    tg, tidx, _ = TMOE._route(tcfg, TMOE.moe_dims(tcfg), th, tp["wr"])
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return dict(jy=f32(jy), ty=ty.float().numpy(), ty2=ty2,
                ty_bits=ty, jidx=np.asarray(jidx), tidx=tidx.numpy(),
                jg=np.asarray(jg), tg=tg.numpy(), C=C, seen=seen,
                jkeep=jax_keep(jidx, d["E"], C), jpen=jpen, tpen=tpen,
                jocc=jocc, tocc=tocc)


def assert_outputs_close(r, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(r["ty"], r["jy"], rtol=TOL, atol=TOL)
        return
    step = np.exp2(np.floor(np.log2(np.abs(r["jy"]).max(-1, keepdims=True)))
                   - 7)
    assert (np.abs(r["ty"] - r["jy"]) <= 2 * step).all()


def shape_id(s):
    return f"{s[0]}_{s[1]}x{s[2]}"


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, shape):
    check_block(arch, shape, "float32")


def check_block(arch, shape, dtype):
    r = run_both(arch, dtype, shape)
    np.testing.assert_array_equal(r["tidx"], r["jidx"])
    np.testing.assert_allclose(r["tg"], r["jg"], rtol=0, atol=GATE_TOL)
    np.testing.assert_array_equal(r["seen"]["keep"], r["jkeep"])
    assert r["seen"]["C"] == r["C"]
    assert_outputs_close(r, dtype)
    if shape[0] == "train":
        np.testing.assert_allclose(float(r["tpen"]), float(r["jpen"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(r["tocc"]), float(r["jocc"]),
                                   rtol=TOL, atol=TOL)
        assert float(r["tpen"]) > 0
    else:
        assert r["tpen"] is None and r["tocc"] is None


def test_capacity_factor_by_mode():
    """C = ceil(T k / E cf): cf 1.25 in train mode, 4.0 in prefill and
    decode, at full width and reduced."""
    q = get_config("qwen2-moe-a2.7b")
    ll = get_config("llama4-maverick-400b-a17b")
    assert TMOE.capacity(q, 4, "decode") == 2
    assert TMOE.capacity(q, 16, "decode") == 5
    assert TMOE.capacity(ll, 4, "decode") == 1
    assert TMOE.capacity(ll, 16, "decode") == 1
    assert TMOE.capacity(q, 1024, "train") == math.ceil(1024 * 4 / 60 * 1.25)
    rq, rl = reduced(q), reduced(ll)
    for T in (3, 12, 32):
        assert TMOE.capacity(rq, T, "decode") == T      # never drops
    assert TMOE.capacity(rl, 3, "decode") == 2
    assert TMOE.capacity(rl, 3, "prefill") == 2
    assert TMOE.capacity(rl, 3, "train") == 1


@pytest.mark.parametrize("arch,shape", [
    ("llama4-maverick-400b-a17b", ("decode", 3, 1)),
    ("qwen2-moe-a2.7b", ("train", 2, 16)),
    ("llama4-maverick-400b-a17b", ("prefill", 1, 32))])
def test_identical_rows_force_drops(arch, shape):
    """Every token routes alike, so each chosen expert keeps only its
    first C assignments: the port keeps exactly those, as the reference
    does, and the outputs agree."""
    r = run_both(arch, "float32", shape, same_rows=True)
    np.testing.assert_array_equal(r["tidx"], r["jidx"])
    keep = r["seen"]["keep"]
    np.testing.assert_array_equal(keep, r["jkeep"])
    T, k = r["tidx"].shape
    assert (~keep).sum() == T * k - k * r["C"]
    # the first C tokens keep their assignments, the others lose them
    np.testing.assert_array_equal(keep.reshape(T, k)[:, 0],
                                  np.arange(T) < r["C"])
    assert_outputs_close(r, "float32")
    # a dropped token's routed output is gone: it differs from a kept one
    assert not np.allclose(r["ty"].reshape(T, -1)[0],
                           r["ty"].reshape(T, -1)[-1])


def test_fixed_order_combine_same_bits():
    check_combine("float32")


def check_combine(dtype):
    """Each token's k gated outputs are summed left to right, no
    scatter-add: a second call gives the same bits, and the combine
    equals that explicit sum."""
    r = run_both("qwen2-moe-a2.7b", dtype, ("decode", 3, 4))
    assert torch.equal(r["ty_bits"], r["ty2"])
    jcfg, tcfg = configs("qwen2-moe-a2.7b", dtype)
    tp = _to_torch(block_params(tcfg), tcfg)
    x = torch.tensor(inputs(("decode", 3, 4), tcfg.d_model, 1)).to(
        tcfg.dtype)
    ctx = make_context(tcfg, "decode")
    terms = []
    orig = torch.bmm

    def grab(a, b):
        out = orig(a, b)
        terms.append(out)
        return out

    TMOE.torch.bmm = grab
    try:
        y, _, _ = TMOE.moe_fwd(tp, x, ctx)
    finally:
        TMOE.torch.bmm = orig
    assert torch.equal(y, r["ty_bits"])
    yb = terms[-1]                                  # [E, C, D]
    E, C, D = yb.shape
    h = TMOE.common.norm(x, tp["ln2"], tcfg.norm)
    gates, idx, _ = TMOE._route(tcfg, TMOE.moe_dims(tcfg), h, tp["wr"])
    keep, row = TMOE._dispatch_slots(idx, E, C)
    assert keep.all()                               # C >= T here
    flat = yb.reshape(E * C, D)[row]
    w = gates.reshape(-1, 1).to(flat.dtype)
    T, k = idx.shape
    acc = (flat * w).view(T, k, D)
    want = acc[:, 0]
    for j in range(1, k):
        want = want + acc[:, j]
    h2 = h.reshape(T, D)
    want = want + (TMOE.common.act_fn(h2 @ tp["ws1"], tcfg.act)
                   * (h2 @ tp["ws3"])) @ tp["ws2"]
    assert torch.equal(y, x + want.reshape(x.shape))


def test_router_ties_take_the_lower_expert():
    """Equal probabilities: the stable descending sort keeps the lower
    expert first, as ``lax.top_k``; ``torch.topk`` promises no order."""
    jcfg, tcfg = configs("qwen2-moe-a2.7b", "float32")
    d = TMOE.moe_dims(tcfg)
    D, E = tcfg.d_model, d["E"]
    h = np.zeros((1, 4, D), np.float32)
    h[0, :, 0] = 1.0
    wr = np.zeros((D, E), np.float32)
    wr[0] = [0.5, 1.0, 1.0, 0.2, 1.0, 0.5, 0.0, 1.0]
    _, tidx, _ = TMOE._route(tcfg, d, torch.tensor(h), torch.tensor(wr))
    _, jidx, _ = JMOE._route(jcfg, JMOE.moe_dims(jcfg, 1),
                             jnp.asarray(h.reshape(4, D)), jnp.asarray(wr))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx.numpy()[0], [1, 2])
