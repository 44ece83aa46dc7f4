"""The port's mamba block (``repro_torch.models.blocks_ssm``) against
the JAX reference's, at reduced ``jamba-1.5-large-398b`` widths (width
64, d_inner 128, d_state 8, d_conv 4, dt rank 8).

``mamba_fwd`` in prefill mode on two rows of S = 16 and 256 tokens
(lengths the reference's scan takes: one chunk of 256, or less), then
``mamba_decode_fwd`` from the reference's prefill state, on the same
numpy-seeded parameters and inputs (``_torch_blocks.py``): the output
and both state leaves (``conv``, the last K-1 rows of the activated
convolution output; ``ssm``, the float32 state) within ``TOL`` = 1e-5 of
the JAX value's largest entry, ANN f32.  The reference's chunk is an
associative scan over materialised decays, the port's a recurrence over
the same decays: the same products, reassociated.  Prefills of 1 and 2
tokens keep fewer than K-1 conv rows on both sides (the reference's
slice); their shapes are compared too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_blocks import (block_params, configs, jax_block,  # noqa: E402
                           port_ctx, rel_err, to_jax, to_torch)
from test_torch_rnn import check_block  # noqa: E402

from repro.models import blocks_ssm as JS  # noqa: E402

from repro_torch.models import blocks_ssm as TS  # noqa: E402

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"
BLOCKS = {"mamba": (ARCH, TS.mamba_defs, TS.mamba_fwd, TS.mamba_decode_fwd,
                    JS.mamba_fwd, JS.mamba_decode_fwd)}


@pytest.mark.parametrize("S", (16, 256))
def test_mamba_prefill_and_decode_match_jax(S):
    check_block("mamba", S, BLOCKS)


@pytest.mark.parametrize("S", (1, 2, 3))
def test_mamba_short_prefill_state_matches_jax(S):
    jcfg, tcfg = configs(ARCH)
    p = block_params(TS.mamba_defs(tcfg), seed=S)
    x = np.random.RandomState(S).standard_normal(
        (1, S, tcfg.d_model)).astype(np.float32)
    jy, jst, _, _ = jax_block(jcfg, JS.mamba_fwd, "prefill", 1, S)(
        to_jax(p), jnp.asarray(x))
    ty, tst, _, _ = TS.mamba_fwd(to_torch(p), torch.tensor(x),
                                 port_ctx(tcfg, "prefill"))
    assert tuple(tst["conv"].shape) == tuple(jst["conv"].shape)
    for got, want in ((ty, jy), (tst["conv"], jst["conv"]),
                      (tst["ssm"], jst["ssm"])):
        assert rel_err(got, want) <= 1e-5


def test_causal_conv_matches_jax():
    """The K shifted products against ``lax.conv_general_dilated``."""
    rng = np.random.RandomState(7)
    x = rng.standard_normal((2, 19, 32)).astype(np.float32)
    w = rng.standard_normal((32, 4)).astype(np.float32)
    want = np.asarray(JS._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    got = TS._causal_conv(torch.tensor(x), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
