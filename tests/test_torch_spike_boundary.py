"""The port's spike codec and world-size-1 boundaries against JAX.

Same numpy inputs through ``repro.core`` and ``repro_torch.core``:

* spike counts are exactly equal, including inputs placed exactly on
  half-integer ties (T=16 makes ``|x|/scale*T`` land on ``k + 0.5``
  exactly), which both round half to even;
* ``quantize_partial`` is exactly equal;
* the integer wire of every coded mode (``_encode_local``: int8 and
  its scales, spike counts, the packed 4-bit bytes of ``spike_pack4``)
  is exactly equal;
* in bfloat16, the ``spike`` and ``spike_pack4`` boundaries' wires and
  decoded values exactly equal;
* ``coded_psum``, ``coded_psum_scatter`` and ``coded_all_gather`` at
  size 1 (JAX under ``shard_map`` on a 1x1 mesh) and ``wire_roundtrip``
  agree within 1e-6 for all six modes (float32; the decode multiplies
  in the same order, so the bound covers reassociation inside XLA and
  the last place of ``exp(log_scale)``, in which XLA's and torch's exp
  may differ);
* ``sparse_topk``'s gather keeps exactly k channels per token, and on
  inputs full of ties at the k-th magnitude its indices and decoded
  output equal JAX's (``lax.top_k`` keeps the lower index among
  equals), while ``wire_roundtrip``'s threshold keeps every tie;
* the gradients of ``round_ste`` and of the encoder's surrogate path
  equal JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import boundary as JB  # noqa: E402
from repro.core import spike as JS  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402

from repro_torch.core import boundary as TB  # noqa: E402
from repro_torch.core import spike as TS  # noqa: E402

torch.set_num_threads(1)

MODES = ("none", "int8", "spike_fused", "spike", "spike_pack4",
         "sparse_topk")


def _params(rng, C):
    return {"theta": rng.uniform(0.0, 0.3, C).astype(np.float32),
            "log_scale": rng.uniform(-1.0, 1.0, C).astype(np.float32)}


def _jp(p):
    return {k: jnp.array(v) for k, v in p.items()}


def _tp(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _codec(mod, mode):
    """The codec of ``models.context.codec_from_name`` for ``mode``."""
    cfg = {"spike": mod.SpikeConfig(T=15, faithful=True),
           "spike_pack4": mod.SpikeConfig(T=7)}.get(mode,
                                                     mod.SpikeConfig(T=15))
    return mod.BoundaryCodec(mode=mode, cfg=cfg)


def test_counts_equal_random():
    rng = np.random.RandomState(0)
    x = (rng.standard_normal((6, 5, 48)) * 1.5).astype(np.float32)
    p = _params(rng, 48)
    for T in (15, 7):
        jc = JS.encode(jnp.array(x), _jp(p), JS.SpikeConfig(T=T))
        tc = TS.encode(torch.tensor(x), _tp(p), TS.SpikeConfig(T=T))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        jd = JS.decode(jc, _jp(p), JS.SpikeConfig(T=T), jnp.float32)
        td = TS.decode(tc, _tp(p), TS.SpikeConfig(T=T), torch.float32)
        # decode scales by exp(log_scale): XLA's and torch's exp may
        # differ in the last place
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


def test_counts_equal_on_half_integer_ties():
    T = 16
    k = np.arange(T, dtype=np.float32)
    x = np.concatenate([(k + 0.5) / T, -(k + 0.5) / T])[None]   # [1, 32]
    assert ((np.abs(x) * T) % 1 == 0.5).all()      # exact ties
    p = {"theta": np.zeros(x.shape[-1], np.float32),
         "log_scale": np.zeros(x.shape[-1], np.float32)}
    jc = np.asarray(JS.encode(jnp.array(x), _jp(p), JS.SpikeConfig(T=T)))
    tc = TS.encode(torch.tensor(x), _tp(p), TS.SpikeConfig(T=T)).numpy()
    np.testing.assert_array_equal(tc, jc)
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, ...
    np.testing.assert_array_equal(np.abs(tc[0, :T]), np.round(k + 0.5))


def test_quantize_partial_exact():
    rng = np.random.RandomState(1)
    o = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    o[0, 0, 0] = 0.0                                  # absmax floor row
    jw, js = JB.quantize_partial(jnp.array(o))
    tw, ts = TB.quantize_partial(torch.tensor(o))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


_MESH = make_mesh((1, 1), ("data", "model"))
_JPSUM = {mode: jax.jit(jax.shard_map(
    lambda x, th, ls, m=mode: JB.coded_psum(
        x, {"theta": th, "log_scale": ls}, _codec(JB, m), "model"),
    mesh=_MESH, in_specs=(P(), P(), P()), out_specs=P(), check_vma=False))
    for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_coded_psum_and_wire_roundtrip(mode):
    rng = np.random.RandomState(2)
    x = rng.standard_normal((4, 1, 32)).astype(np.float32)
    p = _params(rng, 32)
    jx, tx = jnp.array(x), torch.tensor(x)
    jout = _JPSUM[mode](jx, jnp.array(p["theta"]), jnp.array(p["log_scale"]))
    tout = TB.coded_psum(tx, _tp(p), _codec(TB, mode))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    jr = JB.wire_roundtrip(jx, _jp(p), _codec(JB, mode))
    tr = TB.wire_roundtrip(tx, _tp(p), _codec(TB, mode))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6)
    if mode != "none":
        assert not np.allclose(tr.numpy(), x)      # the codec really ran


def _shard_mapped(fn):
    return jax.jit(jax.shard_map(fn, mesh=_MESH, in_specs=(P(), P(), P()),
                                 out_specs=P(), check_vma=False))


_JTRAIN = {(name, mode): _shard_mapped(
    lambda x, th, ls, m=mode, f=fn: f(
        x, {"theta": th, "log_scale": ls}, _codec(JB, m), "model", axis=1))
    for name, fn in (("coded_all_gather", JB.coded_all_gather),
                     ("coded_psum_scatter", JB.coded_psum_scatter))
    for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["coded_all_gather", "coded_psum_scatter"])
def test_prefill_boundaries(name, mode):
    """The token-axis gather and reduce-scatter of a prefill block
    ([B, S, D], axis 1) at size 1."""
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    p = _params(rng, 32)
    jout = _JTRAIN[name, mode](jnp.array(x), jnp.array(p["theta"]),
                               jnp.array(p["log_scale"]))
    tout = getattr(TB, name)(torch.tensor(x), _tp(p), _codec(TB, mode),
                             axis=1)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    if mode != "none":
        assert not np.allclose(tout.numpy(), x)


@pytest.mark.parametrize("mode", [m for m in MODES if m != "none"])
def test_encode_local_wire_exact(mode):
    rng = np.random.RandomState(6)
    x = (rng.standard_normal((3, 4, 32)) * 1.5).astype(np.float32)
    p = _params(rng, 32)
    jw, js, _ = JB._encode_local(jnp.array(x), _jp(p), _codec(JB, mode))
    tw, ts, _ = TB._encode_local(torch.tensor(x), _tp(p), _codec(TB, mode))
    assert str(tw.dtype)[6:] == str(jw.dtype)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    if mode == "int8":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if mode == "spike_pack4":
        assert tw.shape == (3, 4, 16)


_JTOPK = _shard_mapped(lambda x, th, ls: JB.coded_all_gather(
    x, {"theta": th, "log_scale": ls}, _codec(JB, "sparse_topk"), "model",
    axis=1))


def test_sparse_topk_ties_follow_lax_top_k():
    """Activations from five levels at scale 1 put the counts of each
    token on a few magnitudes, so the k-th largest is tied many times
    over; the port must keep the same k channels as ``lax.top_k``."""
    rng = np.random.RandomState(7)
    C = 96                                    # k = 12
    levels = np.float32([0.0, 0.2, -0.4, 0.6, -0.6])
    x = levels[rng.randint(0, 5, (2, 5, C))]
    p = {"theta": np.zeros(C, np.float32),
         "log_scale": np.zeros(C, np.float32)}
    codec = _codec(TB, "sparse_topk")
    k = TB._topk_k(C, codec.capacity)
    counts = TB.spike.encode(torch.tensor(x), _tp(p), codec.cfg)
    mag = counts.abs()
    kth = torch.sort(mag, dim=-1, descending=True).values[..., k - 1:k]
    assert ((mag == kth).sum(-1) > 1).all()   # the k-th magnitude is tied
    idx, vals = TB.topk_wire(counts, k)
    _, jidx = jax.lax.top_k(jnp.abs(jnp.array(counts.numpy())), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(
        counts.numpy(), np.asarray(jidx), -1).astype(np.int8))
    tout = TB.coded_all_gather(torch.tensor(x), _tp(p), codec, axis=1)
    jout = _JTOPK(jnp.array(x), jnp.array(p["theta"]),
                  jnp.array(p["log_scale"]))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert ((tout != 0).sum(-1) <= k).all()
    # the decode path's threshold keeps every tie: more than k channels
    rt = TB.wire_roundtrip(torch.tensor(x), _tp(p), codec)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(JB.wire_roundtrip(
        jnp.array(x), _jp(p), _codec(JB, "sparse_topk"))))
    assert ((rt != 0).sum(-1) > k).any()


_JTOPK_GRAD = jax.jit(jax.shard_map(
    jax.grad(lambda x, th, ls, g: jnp.sum(JB.coded_all_gather(
        x, {"theta": th, "log_scale": ls}, _codec(JB, "sparse_topk"),
        "model", axis=1) * g), argnums=(0, 1, 2)),
    mesh=_MESH, in_specs=(P(), P(), P(), P()), out_specs=(P(), P(), P()),
    check_vma=False))


def test_sparse_topk_gather_refuses_gradients():
    """The gather's gradient is the reference's custom VJP (the VJP of
    its local view, the mask detached): x, theta and log_scale within
    1e-6 of ``jax.grad`` on a 1x1 mesh, for a seeded cotangent; without
    a gradient wanted it serves the same value."""
    rng = np.random.RandomState(8)
    xn = rng.standard_normal((2, 3, 64)).astype(np.float32)
    pn = _params(rng, 64)
    g = rng.standard_normal(xn.shape).astype(np.float32)
    x = torch.tensor(xn, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in pn.items()}
    codec = _codec(TB, "sparse_topk")
    y = TB.coded_all_gather(x, p, codec, axis=1)
    (y * torch.tensor(g)).sum().backward()
    want = _JTOPK_GRAD(jnp.array(xn), jnp.array(pn["theta"]),
                       jnp.array(pn["log_scale"]), jnp.array(g))
    for got, w in zip((x.grad, p["theta"].grad, p["log_scale"].grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert float(x.grad.abs().sum()) > 0
    with torch.no_grad():
        y0 = TB.coded_all_gather(x, p, codec, axis=1)
    assert torch.equal(y0, y.detach())


_JBF16 = {
    "coded_psum": _shard_mapped(lambda x, th, ls: JB.coded_psum(
        x, {"theta": th, "log_scale": ls}, _codec(JB, "spike"), "model")),
    "coded_all_gather": _shard_mapped(lambda x, th, ls: JB.coded_all_gather(
        x, {"theta": th, "log_scale": ls}, _codec(JB, "spike"), "model",
        axis=1))}


@pytest.mark.parametrize("name", ["wire_roundtrip", "coded_psum",
                                  "coded_all_gather"])
def test_bf16_spike_boundaries_match_jax(name):
    """The ``spike`` codec on bf16 activations, where both sides round
    every op of the encoder to bf16: the wire's counts exactly equal and
    the decoded values equal (1x1 mesh for the collectives)."""
    rng = np.random.RandomState(9)
    x = (rng.standard_normal((4, 16, 256)) * 1.5).astype(np.float32)
    p = _params(rng, 256)
    jx, tx = jnp.array(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    jcodec, tcodec = _codec(JB, "spike"), _codec(TB, "spike")
    # the decode scale, exp(log_scale) in bf16, is the same on both sides
    # here (XLA's and torch's f32 exp may differ in the last place)
    np.testing.assert_array_equal(
        torch.exp(torch.tensor(p["log_scale"])).to(torch.bfloat16)
        .float().numpy(),
        np.asarray(jnp.exp(jnp.array(p["log_scale"])).astype(jnp.bfloat16)
                   .astype(jnp.float32)))
    jw = JB._encode_local(jx, _jp(p), jcodec)[0]
    tw = TB._encode_local(tx, _tp(p), tcodec)[0]
    assert tw.dtype == torch.int8
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    if name == "wire_roundtrip":
        jout = JB.wire_roundtrip(jx, _jp(p), jcodec)
        tout = TB.wire_roundtrip(tx, _tp(p), tcodec)
    else:
        kw = {"axis": 1} if name == "coded_all_gather" else {}
        jout = _JBF16[name](jx, jnp.array(p["theta"]),
                            jnp.array(p["log_scale"]))
        tout = getattr(TB, name)(tx, _tp(p), tcodec, **kw)
    assert tout.dtype == torch.bfloat16 and tout.shape == x.shape
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))


_JPACK4_BF16 = {
    name: _shard_mapped(lambda x, th, ls, f=fn, kw=kw: f(
        x, {"theta": th, "log_scale": ls}, _codec(JB, "spike_pack4"),
        "model", **kw))
    for name, fn, kw in (("coded_psum", JB.coded_psum, {}),
                         ("coded_all_gather", JB.coded_all_gather,
                          {"axis": 1}),
                         ("coded_psum_scatter", JB.coded_psum_scatter,
                          {"axis": 1}))}


@pytest.mark.parametrize("name", ["wire_roundtrip", "coded_psum",
                                  "coded_all_gather", "coded_psum_scatter"])
def test_bf16_spike_pack4_boundaries_match_jax(name):
    """The ``spike_pack4`` codec (closed form at T = 7, two counts a
    byte) on bf16 activations: the packed wire exactly equal, and the
    decoded values of every exchange (the unpack, unbias and decode of
    ``spike.unpack4_decode``) and of the wire roundtrip equal JAX's (1x1
    mesh for the collectives)."""
    rng = np.random.RandomState(10)
    x = (rng.standard_normal((4, 16, 256)) * 1.5).astype(np.float32)
    p = _params(rng, 256)
    jx, tx = jnp.array(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    jcodec, tcodec = _codec(JB, "spike_pack4"), _codec(TB, "spike_pack4")
    # the decode scale, exp(log_scale) in bf16, is the same on both sides
    # here (XLA's and torch's f32 exp may differ in the last place)
    np.testing.assert_array_equal(
        torch.exp(torch.tensor(p["log_scale"])).to(torch.bfloat16)
        .float().numpy(),
        np.asarray(jnp.exp(jnp.array(p["log_scale"])).astype(jnp.bfloat16)
                   .astype(jnp.float32)))
    jw = JB._encode_local(jx, _jp(p), jcodec)[0]
    tw = TB._encode_local(tx, _tp(p), tcodec)[0]
    assert tw.dtype == torch.uint8 and tw.shape == (4, 16, 128)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    if name == "wire_roundtrip":
        jout = JB.wire_roundtrip(jx, _jp(p), jcodec)
        tout = TB.wire_roundtrip(tx, _tp(p), tcodec)
    else:
        kw = {} if name == "coded_psum" else {"axis": 1}
        jout = _JPACK4_BF16[name](jx, jnp.array(p["theta"]),
                                  jnp.array(p["log_scale"]))
        tout = getattr(TB, name)(tx, _tp(p), tcodec, **kw)
    assert tout.dtype == torch.bfloat16 and tout.shape == x.shape
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    assert not np.array_equal(tout.float().numpy(),
                              tx.float().numpy())   # the codec really ran


@pytest.mark.parametrize("name", ["wire_roundtrip", "coded_all_gather"])
def test_count_matmul_shadow(name, monkeypatch):
    """With consuming weights, a spike-count boundary also runs the count
    matmul on its wire's int8 counts, once per weight, and serves the
    same value; each product is the decoded value times the weight
    (float32, within 2e-5: the fused decode multiplies by f32(1/T) where
    the decode divides by T).  A wire without counts refuses weights."""
    rng = np.random.RandomState(12)
    x = torch.tensor(rng.standard_normal((3, 4, 32)).astype(np.float32))
    p = _tp(_params(rng, 32))
    ws = [torch.tensor(rng.standard_normal((32, n)).astype(np.float32))
          for n in (16, 40)]
    codec = _codec(TB, "spike")
    seen = []
    real = TB.kops.count_matmul

    def recorded(c, w, s, **kw):
        seen.append((c, w, real(c, w, s, **kw)))
        return seen[-1][2]

    monkeypatch.setattr(TB.kops, "count_matmul", recorded)
    kw = {"axis": 1} if name == "coded_all_gather" else {}
    fn = getattr(TB, name)
    served = fn(x, p, codec, **kw)
    assert not seen
    shadowed = fn(x, p, codec, consumers=tuple(ws), **kw)
    assert torch.equal(shadowed, served)
    assert [w for _, w, _ in seen] == ws
    counts = TB.spike.encode(x, p, codec.cfg).reshape(-1, 32)
    for c, w, y in seen:
        assert c.dtype == torch.int8 and torch.equal(c.float(), counts)
        torch.testing.assert_close(y, served.reshape(-1, 32) @ w,
                                   rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        fn(x, p, _codec(TB, "int8"), consumers=tuple(ws), **kw)


def test_unported_modes_raise():
    x = torch.zeros(2, 4)
    p = {"theta": torch.zeros(4), "log_scale": torch.zeros(4)}
    with pytest.raises(ValueError):
        TB.coded_psum(x, p, TB.BoundaryCodec(mode="spike_pack2"))
    with pytest.raises(NotImplementedError):
        TB.coded_psum(x, p, _codec(TB, "int8"), world_size=2)
    # bf16 ``spike`` is served now, as the reference serves it
    rng = np.random.RandomState(10)
    xb = (rng.standard_normal((2, 1, 64)) * 1.5).astype(np.float32)
    pb = _params(rng, 64)
    jout = _JBF16["coded_psum"](jnp.array(xb, jnp.bfloat16),
                                jnp.array(pb["theta"]),
                                jnp.array(pb["log_scale"]))
    tout = TB.coded_psum(torch.tensor(xb).to(torch.bfloat16), _tp(pb),
                         _codec(TB, "spike"))
    assert tout.dtype == torch.bfloat16
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))


def test_wire_bits_match_jax():
    for mode in MODES:
        assert (_codec(TB, mode).wire_bits()
                == _codec(JB, mode).wire_bits())


def test_round_ste_gradient():
    rng = np.random.RandomState(3)
    x = (rng.standard_normal(40) * 3).astype(np.float32)
    w = rng.standard_normal(40).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(JS.round_ste(v) * jnp.array(w)))(
        jnp.array(x))
    tx = torch.tensor(x, requires_grad=True)
    (TS.round_ste(tx) * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


def test_encode_surrogate_gradients():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    w = rng.standard_normal((5, 24)).astype(np.float32)
    p = _params(rng, 24)
    cfg = JS.SpikeConfig(T=15)

    def f(v, th, ls):
        return jnp.sum(JS.encode(v, {"theta": th, "log_scale": ls}, cfg)
                       * jnp.array(w))

    jg = jax.grad(f, argnums=(0, 1, 2))(jnp.array(x), jnp.array(p["theta"]),
                                        jnp.array(p["log_scale"]))
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    (TS.encode(tx, tp, TS.SpikeConfig(T=15)) * torch.tensor(w)).sum().backward()
    for got, want in zip((tx.grad, tp["theta"].grad, tp["log_scale"].grad),
                         jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
