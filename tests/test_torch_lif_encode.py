"""The port's T-tick IF spike encoder against the JAX package.

Same numpy inputs (``repro_torch.kernels.cases.LIF_CASES``: random
f32/bf16 activations, drives on and next to half-integer tick counts
for T=15 and T=7, zeros, -0.0, saturation, zero thresholds) through:

* ``lif_encode_plain`` (via ``ops.lif_encode`` on CPU tensors) against
  the JAX oracle ``ref.lif_encode_ref``, the JAX wrapper
  ``ops.lif_encode`` (interpreted Pallas on the CPU, as
  ``tests/test_kernels.py`` runs it) and the body of the JAX faithful
  codec, ``spike.lif_rate_encode_signed(x/scale, theta/scale)`` — all
  exactly equal;
* the port's codec ``spike.encode(..., SpikeConfig(faithful=True))``
  against JAX's, exactly, and its autograd path (the surrogate spike in
  the tick loop) against ``jax.grad`` within 2e-5 of the largest
  gradient entry.  The chain through T ticks multiplies by factors up
  to |1 - 10| (the surrogate's slope), so rounding grows along it: both
  sides sit ~5e-6 (relative to the largest entry) from a float64
  evaluation of the same function on these inputs.

The one input where the oracle and the codec part — ``|x| < theta``
with ``fl(|x|/s) == fl(theta/s)`` — is built and each side's choice
recorded: the oracle gates it off, the JAX codec and the port fire.
The CUDA kernel needs the card: ``tests/test_torch_gpu.py`` holds it
against this plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import spike as JS  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.core import spike as TS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    LIF_CASES, lif_case, lif_tensors)

torch.set_num_threads(1)


def _jax_in(name):
    x, theta, scale, T, dt = lif_case(name)
    return jnp.array(x, dtype=getattr(jnp, dt)), jnp.array(theta), \
        jnp.array(scale), T


@pytest.mark.parametrize("name", LIF_CASES)
def test_plain_matches_jax_oracle_wrapper_and_codec_body(name):
    x, theta, scale, T = lif_tensors(name, "cpu")
    got = ops.lif_encode(x, theta, scale, T=T)
    assert got.dtype == torch.int8 and got.shape == x.shape
    jx, jth, js, _ = _jax_in(name)
    want = np.asarray(jref.lif_encode_ref(jx, jth, js, T=T))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.lif_encode(jx, jth, js, T=T)))
    xf = jx.astype(jnp.float32)
    codec = JS.lif_rate_encode_signed(xf / js, jth / js, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(codec))
    if name.startswith("half_ticks"):
        # the IF encoder, not the closed form: they part on these drives
        closed = JS.rate_encode_signed(xf, js, jth, T)
        assert (np.asarray(closed) != got.numpy()).any()


def _one_population(name, dt):
    """The CUDA kernel's algorithm in compute type ``dt`` against the
    plain version's on-minus-off difference in the same type."""
    from repro_torch.kernels.lif_encode import if_count
    x, theta, scale, T = lif_tensors(name, "cpu")
    s = scale.to(dt)
    xn = x.to(dt) / s
    count = if_count(torch.clamp(torch.abs(xn), 0.0, 1.0), T)
    gate = torch.abs(xn) - theta.to(dt) / s >= 0.0
    one = torch.where(gate, torch.where(xn < 0, -count, count),
                      torch.zeros_like(count)).to(torch.int8)
    np.testing.assert_array_equal(one.numpy(), ops.lif_encode(
        x, theta, scale, T=T, math_dtype=dt).numpy())


@pytest.mark.parametrize("name", LIF_CASES)
def test_one_population_gives_the_count_difference(name):
    """The CUDA kernel integrates one population, ``clip(|x/s|, 0, 1)``,
    where the gate is open, and signs the count; on every case that is
    the plain version's on-minus-off difference, bit for bit."""
    _one_population(name, torch.float32)


@pytest.mark.parametrize("name", LIF_CASES)
def test_one_population_gives_the_count_difference_in_bf16(name):
    """The same identity with every op rounded to bf16 (the kernel's bf16
    mode): the idle population's membrane stays at bf16(0.5), and
    ``-xn == |xn|`` exactly, so one population still gives the count."""
    _one_population(name, torch.bfloat16)


def test_gate_tie_oracle_and_codec_part():
    """x one float below theta, where x/s and theta/s round to the same
    float: the oracle compares raw values and gates off; the codec, and
    the port with it, compare normalised values and fire."""
    theta, s = np.float32(2.0), np.float32(2.9)
    x = np.nextafter(theta, np.float32(0))
    assert x < theta and x / s == theta / s
    xs = np.float32([[x, -x, theta]])
    th = np.full(3, theta, np.float32)
    sc = np.full(3, s, np.float32)
    port = ops.lif_encode(torch.tensor(xs), torch.tensor(th),
                          torch.tensor(sc), T=15).numpy()
    oracle = np.asarray(jref.lif_encode_ref(jnp.array(xs), jnp.array(th),
                                            jnp.array(sc), T=15))
    codec = np.asarray(JS.lif_rate_encode_signed(
        jnp.array(xs) / jnp.array(sc), jnp.array(th) / jnp.array(sc), 15))
    np.testing.assert_array_equal(oracle[0], [0, 0, 10])
    np.testing.assert_array_equal(codec[0], [10, -10, 10])
    np.testing.assert_array_equal(port[0], codec[0])


def _codec_params(C, seed):
    rng = np.random.RandomState(seed)
    return {"theta": rng.uniform(0.0, 0.3, C).astype(np.float32),
            "log_scale": rng.uniform(-1.0, 1.0, C).astype(np.float32)}


@pytest.mark.parametrize("T", [15, 7])
def test_faithful_codec_matches_jax(T):
    """``encode`` end to end, each side computing its own
    ``exp(log_scale)``: random activations, and the half-tick drives at
    scale 1 (log_scale 0, where both exps are exact)."""
    cfg_j, cfg_t = (JS.SpikeConfig(T=T, faithful=True),
                    TS.SpikeConfig(T=T, faithful=True))
    rng = np.random.RandomState(T)
    x = (rng.standard_normal((3, 4, 40)) * 1.5).astype(np.float32)
    half, _ = lif_case(f"half_ticks_t{T}")[:2]
    inputs = [(x, _codec_params(40, T)),
              (half, {"theta": np.zeros(half.shape[1], np.float32),
                      "log_scale": np.zeros(half.shape[1], np.float32)})]
    for xs, p in inputs:
        jc = JS.encode(jnp.array(xs), {k: jnp.array(v) for k, v in
                                       p.items()}, cfg_j)
        tc = TS.encode(torch.tensor(xs), {k: torch.tensor(v) for k, v in
                                          p.items()}, cfg_t)
        assert tc.dtype == torch.float32 and tc.shape == xs.shape
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_faithful_autograd_path_matches_jax():
    rng = np.random.RandomState(5)
    x = (rng.standard_normal((5, 24)) * 1.2).astype(np.float32)
    w = rng.standard_normal((5, 24)).astype(np.float32)
    p = _codec_params(24, 6)
    cfg = JS.SpikeConfig(T=15, faithful=True)

    def f(v, th, ls):
        return jnp.sum(JS.encode(v, {"theta": th, "log_scale": ls}, cfg)
                       * jnp.array(w))

    jg = jax.grad(f, argnums=(0, 1, 2))(jnp.array(x), jnp.array(p["theta"]),
                                        jnp.array(p["log_scale"]))
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    counts = TS.encode(tx, tp, TS.SpikeConfig(T=15, faithful=True))
    with torch.no_grad():
        served = TS.encode(tx, tp, TS.SpikeConfig(T=15, faithful=True))
    np.testing.assert_array_equal(counts.detach().numpy(), served.numpy())
    (counts * torch.tensor(w)).sum().backward()
    for got, want in zip((tx.grad, tp["theta"].grad, tp["log_scale"].grad),
                         jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max())


def test_faithful_codec_refuses_bf16_and_other_devices(monkeypatch):
    """bf16 activations are served now (the kernel's bf16 mode): the
    codec's counts equal the JAX codec's on 256 x 1024 values at T = 15
    and 7, where computing in float32 would differ.  float16 and other
    devices are still refused.  A gradient off the CPU goes to the
    kernels' autograd Function (``spike._LIFEncode``), never to the CPU
    autograd path; on a device with no kernel its launch refuses it."""
    rng = np.random.RandomState(21)
    x = (rng.standard_normal((256, 1024)) * 1.5).astype(np.float32)
    pn = _codec_params(1024, 22)
    for T in (15, 7):
        jc = np.asarray(JS.encode(
            jnp.array(x, jnp.bfloat16), {k: jnp.array(v) for k, v in
                                         pn.items()},
            JS.SpikeConfig(T=T, faithful=True)).astype(jnp.float32))
        tx = torch.tensor(x).to(torch.bfloat16)
        tp = {k: torch.tensor(v) for k, v in pn.items()}
        tc = TS.encode(tx, tp, TS.SpikeConfig(T=T, faithful=True))
        assert tc.dtype == torch.bfloat16
        np.testing.assert_array_equal(tc.float().numpy(), jc)
        f32 = TS.encode(tx.float(), tp, TS.SpikeConfig(T=T, faithful=True))
        assert (f32.numpy() != jc).sum() > 100
    p = {"theta": torch.zeros(4), "log_scale": torch.zeros(4)}
    with pytest.raises(NotImplementedError):
        TS.encode(torch.zeros(2, 4, dtype=torch.float16), p,
                  TS.SpikeConfig(faithful=True))
    meta = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError):
        ops.lif_encode(meta, torch.zeros(4, device="meta"),
                       torch.ones(4, device="meta"))
    # off the CPU a gradient routes to the kernels' Function, never to
    # the CPU autograd path; the meta device has no kernel
    pm = {k: v.to("meta") for k, v in p.items()}
    routed = []
    real = TS._LIFEncode.apply
    monkeypatch.setattr(TS._LIFEncode, "apply",
                        lambda *a: routed.append(a) or real(*a))
    monkeypatch.setattr(TS, "lif_rate_encode_signed", None)
    with pytest.raises(ValueError):
        TS.encode(meta.clone().requires_grad_(), pm,
                  TS.SpikeConfig(faithful=True))
    assert len(routed) == 1 and routed[0][0].device.type == "meta"


def _same_exp(log_scale, dtype):
    """``log_scale`` with 0 wherever torch's and XLA's ``exp`` differ in
    ``dtype`` (float32 ``exp`` differs in the last place for some
    arguments): the decode multiplies by that scale, so only equal
    scales can give equal bits."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    te = torch.exp(torch.tensor(log_scale)).to(tdt).float().numpy()
    je = np.asarray(jnp.exp(jnp.array(log_scale)).astype(jdt)
                    .astype(jnp.float32))
    return np.where(te == je, log_scale, np.float32(0.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [15, 7])
def test_decode_epilogue_and_encode_decode_match_jax(T, dtype):
    """The faithful codec's encode then decode in the activation's dtype,
    JAX against the port: ``spike.encode_decode`` (counts and decoded
    values) and the kernel's plain version with the decode epilogue
    (``decode_scale = exp(log_scale) / T`` in that dtype), bit for
    bit."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.RandomState(30 + T)
    x = (rng.standard_normal((3, 4, 40)) * 1.5).astype(np.float32)
    p = _codec_params(40, 40 + T)
    p["log_scale"] = _same_exp(p["log_scale"], dtype)
    jp = {k: jnp.array(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    cfg_j = JS.SpikeConfig(T=T, faithful=True)
    jc = JS.encode(jnp.array(x, jdt), jp, cfg_j)
    jd = np.asarray(JS.decode(jc, jp, cfg_j, jdt).astype(jnp.float32))
    jc = np.asarray(jc.astype(jnp.float32))
    assert (jc != 0).any() and (jc == 0).any()
    tx = torch.tensor(x).to(tdt)
    counts, dec = TS.encode_decode(tx, tp, TS.SpikeConfig(T=T,
                                                          faithful=True))
    assert dec.dtype == tdt and dec.shape == x.shape
    np.testing.assert_array_equal(counts.float().numpy(), jc)
    np.testing.assert_array_equal(dec.float().numpy(), jd)
    scale = torch.exp(tp["log_scale"]).to(tdt)
    c8, d8 = ops.lif_encode(tx.reshape(-1, 40), tp["theta"].to(tdt), scale,
                            T=T, math_dtype=tdt, decode_scale=scale / T)
    assert c8.dtype == torch.int8 and d8.dtype == tdt
    np.testing.assert_array_equal(c8.numpy(), jc.reshape(-1, 40))
    np.testing.assert_array_equal(d8.float().numpy(), jd.reshape(-1, 40))
