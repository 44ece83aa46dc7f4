"""The port's recurrent blocks (``repro_torch.models.blocks_rnn``) and
``layer_norm`` against the JAX reference's, at reduced widths.

``rwkv_fwd`` (reduced ``rwkv-paper``: width 64, d_ff 128), ``mlstm_fwd``
and ``slstm_fwd`` (reduced ``xlstm-125m``: width 64, 4 heads of 16) in
prefill mode on two rows of S = 16, 64 and 128 tokens — lengths the
reference's chunked scans take (one chunk of 64, or a multiple) — and
each block's decode step from the reference's prefill state, on the same
numpy-seeded parameters and inputs (``_torch_blocks.py``).  The block
output and every state leaf (RWKV ``x_tm``, ``x_cm``, ``aa``, ``bb``,
``pp``; mLSTM ``C``, ``n``, ``m``; sLSTM ``c``, ``n``, ``h``, ``m``)
must lie within ``TOL`` = 1e-5 of the JAX value's largest entry, ANN
f32.  Both sides compute in float32: the mLSTM and sLSTM recurrences
step token by token on both sides, and the port's RWKV prefill sums a
chunk of tokens at once where the reference steps (the same sums,
reassociated); the largest relative differences seen here are ~1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_blocks import (block_params, configs, jax_block,  # noqa: E402
                           port_ctx, rel_err, to_jax, to_torch)

from repro.models import blocks_rnn as JR  # noqa: E402
from repro.models import common as JC  # noqa: E402

from repro_torch.models import blocks_rnn as TR  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
B = 2
LENGTHS = (16, 64, 128)
#: kind -> (arch, port defs, port prefill, port decode, JAX prefill,
#: JAX decode)
BLOCKS = {
    "rwkv": ("rwkv-paper", TR.rwkv_defs, TR.rwkv_fwd, TR.rwkv_decode_fwd,
             JR.rwkv_fwd, JR.rwkv_decode_fwd),
    "mlstm": ("xlstm-125m", TR.mlstm_defs, TR.mlstm_fwd,
              TR.mlstm_decode_fwd, JR.mlstm_fwd, JR.mlstm_decode_fwd),
    "slstm": ("xlstm-125m", TR.slstm_defs, TR.slstm_fwd,
              TR.slstm_decode_fwd, JR.slstm_fwd, JR.slstm_decode_fwd),
}


def check_block(kind, S, blocks=BLOCKS):
    """Prefill of [B, S] then one decode step, port vs JAX; returns the
    largest relative difference."""
    arch, defs, t_fwd, t_dec, j_fwd, j_dec = blocks[kind]
    jcfg, tcfg = configs(arch)
    p = block_params(defs(tcfg), seed=S)
    rng = np.random.RandomState(100 + S)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    jy, jst, _, _ = jax_block(jcfg, j_fwd, "prefill", B, S)(
        to_jax(p), jnp.asarray(x))
    ty, tst, _, _ = t_fwd(to_torch(p), torch.tensor(x),
                          port_ctx(tcfg, "prefill"))
    errs = [rel_err(ty, jy)]
    assert sorted(tst) == sorted(jst)
    errs += [rel_err(tst[n], jst[n]) for n in jst]
    jy1, jst1 = jax_block(jcfg, j_dec, "decode", B, 1)(
        to_jax(p), jnp.asarray(x1), jst, jnp.full((B,), S, jnp.int32))
    ty1, tst1 = t_dec(to_torch(p), torch.tensor(x1),
                      {n: torch.tensor(np.array(v)) for n, v in jst.items()},
                      port_ctx(tcfg, "decode"))
    errs += [rel_err(ty1, jy1)]
    errs += [rel_err(tst1[n], jst1[n]) for n in jst1]
    assert max(errs) <= TOL, (kind, S, errs)
    return max(errs)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_prefill_and_decode_match_jax(kind, S):
    check_block(kind, S)


def test_layer_norm_matches_jax():
    """``layer_norm`` with and without a bias, and ``norm(kind=
    "layernorm")``, against the reference's: the population variance
    (``torch.var`` would divide by n - 1), eps 1e-5, ``1 + scale``."""
    rng = np.random.RandomState(3)
    x = (3 * rng.standard_normal((4, 7, 64)) + 1.5).astype(np.float32)
    scale = (0.3 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(64)).astype(np.float32)
    for b in (None, bias):
        want = np.asarray(JC.layer_norm(
            jnp.asarray(x), jnp.asarray(scale),
            None if b is None else jnp.asarray(b)))
        got = TC.layer_norm(torch.tensor(x), torch.tensor(scale),
                            None if b is None else torch.tensor(b))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(JC.norm(jnp.asarray(x), jnp.asarray(scale),
                              "layernorm"))
    got = TC.norm(torch.tensor(x), torch.tensor(scale), "layernorm")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # a bf16 input keeps its dtype, computed in f32
    xb = torch.tensor(x).to(torch.bfloat16)
    assert TC.layer_norm(xb, torch.tensor(scale)).dtype == torch.bfloat16


def test_wkv_chunk_matches_the_step():
    """The port's chunked wkv (a chunk of tokens at once) against the
    reference's step applied token by token (``_wkv_step``, ported op
    for op), across a chunk boundary and from a nonzero state, at
    decays large enough that most weights underflow."""
    rng = np.random.RandomState(5)
    Bq, S, C = 2, 80, 8
    k = torch.tensor(3 * rng.standard_normal((Bq, S, C)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((Bq, S, C)), dtype=torch.float32)
    w = -torch.exp(torch.tensor(rng.standard_normal(C) + 1.0,
                                dtype=torch.float32))
    u = torch.tensor(rng.standard_normal(C), dtype=torch.float32)
    state0 = (torch.tensor(rng.random((Bq, C)), dtype=torch.float32),
              torch.tensor(1 + rng.random((Bq, C)), dtype=torch.float32),
              torch.tensor(rng.standard_normal((Bq, C)), dtype=torch.float32))
    out, st = TR._wkv_scan(k, v, w, u, state0, chunk=32)
    ref_st, ref = state0, []
    for t in range(S):
        ref_st, o = TR._wkv_step(ref_st, k[:, t], v[:, t], w, u)
        ref.append(o)
    assert rel_err(out, torch.stack(ref, 1)) <= TOL
    # the state is stabilised by its own maximum: compare the true sums
    for a, b in zip(st[:2], ref_st[:2]):
        assert rel_err(a * torch.exp(st[2] - ref_st[2]), b) <= TOL
    assert rel_err(st[2], ref_st[2]) <= TOL
