"""The port's spike-count matmul against the JAX package.

Same numpy inputs (``repro_torch.kernels.cases.count_matmul_case``:
int8 counts spanning -T..T with all-zero rows and columns, weights of
the model's init scale (normal, std 0.02), scales in [0.5, 2)) through
``ops.count_matmul`` on CPU tensors — the plain version — and through
the JAX wrapper ``ops.count_matmul`` (interpreted Pallas on the CPU, as
``tests/test_kernels.py`` runs it) and the JAX oracle
``ref.count_matmul_ref``: the shapes of ``test_kernels.py`` and ragged
ones, T = 7 and 15, weights in float32 and bfloat16, results in float32
and bfloat16.

Tolerance: a float32 result within rtol = atol = 2e-5 of JAX's, the
bound of ``test_kernels.py`` (the two sides sum K products in different
orders).  It holds for sums of the magnitudes served traffic gives
them; at unit-variance weights and K = 1000 the reassociation alone
reaches 3.1e-5 at a sum of 0.28 (seen here), so the cases draw the
weights at the model's scale.  A bfloat16 result must be the bf16
rounding of a float32 value within that tolerance of JAX's float32 sum
(``count_matmul_agrees``): the same bf16 value, or one bf16 step apart
where the two float32 sums round differently; more only where the
tolerance itself spans several bf16 steps, at sums that cancel to
within a few atol of 0.

The decode factor is ``scale * f32(1/T)`` on both sides, as the TPU
kernel computes it, not the oracle's ``scale / T``: a test places
scales where the two differ and checks each side's value bit for bit.
The CUDA kernel needs the card: ``tests/test_torch_gpu.py`` holds it
against this plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    bf16_steps, count_matmul_agrees, count_matmul_case)

torch.set_num_threads(1)

#: (M, K, N, T, weight dtype): the shapes of ``test_kernels.py`` and
#: ragged ones (M = 1 and 33; K = 300 and 1000; N = 130 and 200), each
#: weight dtype and T three times
CASES = [(8, 128, 128, 7, "float32"), (64, 300, 200, 15, "bfloat16"),
         (256, 512, 256, 15, "bfloat16"), (256, 512, 256, 7, "float32"),
         (33, 1000, 130, 7, "float32"), (1, 300, 200, 15, "bfloat16")]


def _inputs(M, K, N, T, wdt):
    counts, w, scale = count_matmul_case(M, K, N, T, seed=M + K + N)
    jin = (jnp.array(counts), jnp.array(w, getattr(jnp, wdt)),
           jnp.array(scale))
    tin = (torch.tensor(counts), torch.tensor(w).to(getattr(torch, wdt)),
           torch.tensor(scale))
    return jin, tin


@pytest.mark.parametrize("M,K,N,T,wdt", CASES)
def test_plain_matches_jax_wrapper_and_oracle(M, K, N, T, wdt):
    jin, tin = _inputs(M, K, N, T, wdt)
    got32 = ops.count_matmul(*tin, T=T, out_dtype=torch.float32)
    got16 = ops.count_matmul(*tin, T=T)
    assert got32.shape == got16.shape == (M, N)
    assert got32.dtype == torch.float32 and got16.dtype == torch.bfloat16
    for fn in (jops.count_matmul, jref.count_matmul_ref):
        want32 = np.asarray(fn(*jin, T=T, out_dtype=jnp.float32))
        np.testing.assert_allclose(got32.numpy(), want32, rtol=2e-5,
                                   atol=2e-5)
        ok, _ = count_matmul_agrees(got16, torch.tensor(want32))
        assert ok, fn
    if wdt == "bfloat16":
        # and JAX's own bf16 result (its default), by the same rule
        # against the port's f32 sum
        want16 = jops.count_matmul(*jin, T=T)
        assert want16.dtype == jnp.bfloat16
        j16 = torch.tensor(np.asarray(want16.astype(jnp.float32))).to(
            torch.bfloat16)
        ok, _ = count_matmul_agrees(j16, got32)
        assert ok
    # rows and columns of zero counts give exact zeros on both sides
    zero_rows = np.flatnonzero(~np.asarray(jin[0]).any(axis=1))
    assert (got32.numpy()[zero_rows] == 0).all()


def test_decode_factor_is_scale_times_inverse_T():
    """One count of 1 per output and an identity W, so each output is
    the decode factor of its channel alone: ``scale * f32(1/T)`` on the
    port and in the JAX wrapper, bit for bit, and ``scale / T`` in the
    oracle; the scales are drawn where the two differ."""
    T, K = 15, 64
    rng = np.random.RandomState(3)
    cand = rng.uniform(0.5, 2.0, 4096).astype(np.float32)
    mul = cand * np.float32(1.0 / T)
    div = cand / np.float32(T)
    scale = cand[mul != div][:K]
    assert scale.size == K
    counts = np.ones((1, K), np.int8)
    w = np.eye(K, dtype=np.float32)
    port = ops.count_matmul(torch.tensor(counts), torch.tensor(w),
                            torch.tensor(scale), T=T,
                            out_dtype=torch.float32).numpy()[0]
    jin = (jnp.array(counts), jnp.array(w), jnp.array(scale))
    wrapper = np.asarray(jops.count_matmul(*jin, T=T,
                                           out_dtype=jnp.float32))[0]
    oracle = np.asarray(jref.count_matmul_ref(*jin, T=T,
                                              out_dtype=jnp.float32))[0]
    np.testing.assert_array_equal(port, scale * np.float32(1.0 / T))
    np.testing.assert_array_equal(wrapper, port)
    np.testing.assert_array_equal(oracle, scale / np.float32(T))
    assert (oracle != port).all()


def test_agreement_rule():
    """``bf16_steps`` counts representable values, across 0; the f32
    rule is rtol = atol = 2e-5 and the bf16 rule takes exactly the bf16
    roundings of that interval, which near 0 span many steps."""
    bf = torch.bfloat16
    one, above = torch.tensor([1.0]).to(bf), torch.tensor([1.0078125]).to(bf)
    assert bf16_steps(one, one) == 0 and bf16_steps(one, above) == 1
    zeros = torch.tensor([0.0, -0.0]).to(bf)
    assert bf16_steps(zeros[:1], zeros[1:]) == 0
    want = torch.tensor([1.0, 1e-6, 100.0])
    assert count_matmul_agrees(want, want)[0]
    assert not count_matmul_agrees(want + 1e-3, want)[0]
    assert count_matmul_agrees(want.to(bf), want) == (True, 0)
    # one step above bf16(1.0), but outside 1 +- 4e-5
    off = torch.tensor([1.0078125, 1e-6, 100.0]).to(bf)
    assert not count_matmul_agrees(off, want)[0]
    # near 0 the tolerance spans many bf16 steps; such outputs are not
    # counted in the steps
    near0 = torch.tensor([1.0, -1e-5, 100.0]).to(bf)
    assert count_matmul_agrees(near0, want) == (True, 0)
    assert bf16_steps(near0, want.to(bf)) > 1
    # where the tolerance is finer than a bf16 step, one step counts
    big = torch.tensor([3.0, 0.0, 100.0])
    assert count_matmul_agrees(big.to(bf), big) == (True, 0)
    assert count_matmul_agrees(torch.tensor([3.0, 1e-9, 100.5]).to(bf),
                               big) == (False, 1)


def test_counts_device_and_shapes_checked():
    meta = torch.zeros(2, 4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        ops.count_matmul(meta, torch.zeros(4, 3, device="meta"),
                         torch.ones(4, device="meta"))
    with pytest.raises(RuntimeError):
        ops.count_matmul(torch.zeros(2, 4, dtype=torch.int8),
                         torch.zeros(5, 3), torch.ones(4))
