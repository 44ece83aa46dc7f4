"""The port's 4-bit wire packing against the JAX package.

Same numpy inputs (``repro_torch.kernels.cases.PACK4_CASES``: every byte
value, and random 4-bit wires of ragged row counts) through
``pack4_plain`` / ``unpack4_plain`` (via ``ops.pack4`` / ``ops.unpack4``
on CPU tensors) and the JAX oracles ``ref.pack4_ref`` /
``ref.unpack4_ref``, the JAX wrappers ``ops.pack4`` / ``ops.unpack4``
(interpreted Pallas on the CPU) and ``spike.unpack4``: all exactly
equal, and unpack inverts pack on 4-bit values.  The codec's
``pack4_counts`` (bias and pack in one call) and ``wire_u8_to_counts``
equal JAX's wire helpers on every count in {-15..15}.  The receiving
side's ``unpack4_decode`` (unpack, unbias and rate decode in one call)
equals JAX's ``decode(wire_u8_to_counts(unpack4(p), T, dtype), ...)``
bit for bit.  An odd last axis raises, as the TPU kernel's assertion
does.  The CUDA kernels
need the card: ``tests/test_torch_gpu.py`` holds them against these
plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import spike as JS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.core import spike as TS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    PACK4_CASES, UNPACK4_LOG_SCALES, pack4_case, unpack4_log_scale)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", PACK4_CASES)
def test_pack4_matches_jax(name):
    v = pack4_case(name)
    got = ops.pack4(torch.tensor(v))
    assert got.dtype == torch.uint8 and got.shape == (v.shape[0],
                                                      v.shape[1] // 2)
    jv = jnp.array(v)
    for want in (jref.pack4_ref(jv), jops.pack4(jv), JS.pack4(jv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if v.max() < 16:
        np.testing.assert_array_equal(ops.unpack4(got).numpy(), v)


@pytest.mark.parametrize("name", PACK4_CASES)
def test_unpack4_matches_jax(name):
    p = pack4_case(name)
    got = ops.unpack4(torch.tensor(p))
    assert got.dtype == torch.uint8 and got.shape == (p.shape[0],
                                                      2 * p.shape[1])
    jp = jnp.array(p)
    for want in (jref.unpack4_ref(jp), jops.unpack4(jp), JS.unpack4(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ops.pack4(got).numpy(), p)


def test_spike_pack4_on_leading_dims_and_wire_helpers():
    rng = np.random.RandomState(4)
    counts = rng.randint(-7, 8, (3, 2, 10)).astype(np.float32)
    for T in (7, 15):
        c = (counts * T / 7).round().astype(np.float32)
        w = np.asarray(JS.counts_to_wire_u8(jnp.array(c), T))
        back = TS.wire_u8_to_counts(torch.tensor(w), T)
        np.testing.assert_array_equal(back.numpy(), np.asarray(
            JS.wire_u8_to_counts(jnp.array(w), T)))
        np.testing.assert_array_equal(back.numpy(), c)
    w = np.asarray(JS.counts_to_wire_u8(jnp.array(counts), 7))
    packed = TS.pack4_counts(torch.tensor(counts), 7)
    assert packed.shape == (3, 2, 5)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JS.pack4(jnp.array(w))))
    np.testing.assert_array_equal(TS.unpack4(packed).numpy(), w)


def test_odd_last_axis_and_other_devices_raise():
    with pytest.raises(ValueError):
        ops.pack4(torch.zeros(4, 7, dtype=torch.uint8))
    meta = torch.zeros(2, 4, dtype=torch.uint8, device="meta")
    for fn in (ops.pack4, ops.unpack4):
        with pytest.raises(ValueError):
            fn(meta)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PACK4_CASES)
def test_pack4_counts_matches_jax(name, dtype):
    """The bias and the pack in one call: signed counts (float32 or
    bf16) at T = 7 and 15 against JAX's ``pack4(counts_to_wire_u8(...))``,
    exactly (at T = 15 the biased values pass 15, and the uint8
    semantics of the pack decide the bytes); the codec's ``pack4_counts``
    on leading dims likewise."""
    from repro_torch.kernels.cases import pack4_counts_case
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for T in (7, 15):
        c = pack4_counts_case(name, T)
        want = np.asarray(JS.pack4(JS.counts_to_wire_u8(jnp.array(c, jdt),
                                                        T)))
        got = ops.pack4_counts(torch.tensor(c).to(tdt), T)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        lead = TS.pack4_counts(torch.tensor(c).to(tdt).reshape(
            1, c.shape[0], c.shape[1]), T)
        np.testing.assert_array_equal(lead[0].numpy(), want)


def _jax_unpack4_decode(p, log_scale, T, jdt):
    """JAX's receiving side of a packed wire, as float32 numpy."""
    out = JS.decode(JS.wire_u8_to_counts(JS.unpack4(jnp.array(p)), T, jdt),
                    {"log_scale": jnp.array(log_scale)}, JS.SpikeConfig(T=T),
                    jdt)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("T", [7, 1])
@pytest.mark.parametrize("log_scale", UNPACK4_LOG_SCALES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PACK4_CASES)
def test_unpack4_decode_matches_jax(name, dtype, log_scale, T):
    """The unpack, the unbias and the rate decode in one call, against
    JAX's ``decode(wire_u8_to_counts(unpack4(p), T, dtype), ...)``, bit
    for bit: ``ops.unpack4_decode`` fed JAX's decoded scale
    ``exp(log_scale)`` in ``dtype`` (XLA's and torch's f32 ``exp`` may
    differ in the last place), divided by T here as the codec does; and
    the codec's ``spike.unpack4_decode`` on leading dims, on the
    log-scales where the two ``exp`` agree."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    p = pack4_case(name)
    C = 2 * p.shape[1]
    ls = unpack4_log_scale(log_scale, C)
    want = _jax_unpack4_decode(p, ls, T, jdt)
    jscale = np.asarray(jnp.exp(jnp.array(ls)).astype(jdt)
                        .astype(jnp.float32))
    got = ops.unpack4_decode(torch.tensor(p), T,
                             torch.tensor(jscale).to(tdt) / T)
    assert got.dtype == tdt and got.shape == (p.shape[0], C)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (want != 0).any() and (want < 0).any()
    tscale = torch.exp(torch.tensor(ls)).to(tdt).float().numpy()
    same = np.where(tscale == jscale, ls, np.float32(0.0))
    lead = TS.unpack4_decode(torch.tensor(p)[None],
                             {"log_scale": torch.tensor(same)},
                             TS.SpikeConfig(T=T), tdt)
    assert lead.dtype == tdt and lead.shape == (1, p.shape[0], C)
    np.testing.assert_array_equal(lead[0].float().numpy(),
                                  _jax_unpack4_decode(p, same, T, jdt))
