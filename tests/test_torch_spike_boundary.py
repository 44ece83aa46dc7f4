"""The port's spike codec and world-size-1 boundaries against JAX.

Same numpy inputs through ``repro.core`` and ``repro_torch.core``:

* spike counts are exactly equal, including inputs placed exactly on
  half-integer ties (T=16 makes ``|x|/scale*T`` land on ``k + 0.5``
  exactly), which both round half to even;
* ``quantize_partial`` is exactly equal;
* ``coded_psum`` at size 1 (JAX under ``shard_map`` on a 1x1 mesh) and
  ``wire_roundtrip`` agree within 1e-6 for ``none``, ``int8`` and
  ``spike_fused`` (float32; the decode multiplies in the same order, so
  the bound only covers reassociation inside XLA);
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

MODES = ("none", "int8", "spike_fused")


def _params(rng, C):
    return {"theta": rng.uniform(0.0, 0.3, C).astype(np.float32),
            "log_scale": rng.uniform(-1.0, 1.0, C).astype(np.float32)}


def _jp(p):
    return {k: jnp.array(v) for k, v in p.items()}


def _tp(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _codec(mod, mode):
    return mod.BoundaryCodec(mode=mode, cfg=mod.SpikeConfig(T=15))


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


def test_unported_modes_raise():
    x = torch.zeros(2, 4)
    p = {"theta": torch.zeros(4), "log_scale": torch.zeros(4)}
    with pytest.raises(NotImplementedError):
        TB.coded_psum(x, p, TB.BoundaryCodec(mode="spike_pack4"))
    with pytest.raises(NotImplementedError):
        TB.coded_psum(x, p, _codec(TB, "int8"), world_size=2)


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
