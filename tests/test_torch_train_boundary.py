"""The coded boundaries' gradients and the sparsity penalty against JAX.

Same numpy inputs through ``repro.core`` and ``repro_torch.core``:

* the gradients (x, theta, log_scale) of ``coded_all_gather``,
  ``coded_psum_scatter`` and ``coded_psum`` equal ``jax.grad`` of the
  reference's under ``shard_map`` on a 1x1 mesh — its custom VJPs — for
  ``int8``, ``spike_fused``, ``spike``, ``spike_pack4``,
  ``sparse_topk``, ``spike_fused+bwd8`` and ``int8+bwd8``, within 1e-6
  (the cotangent is seeded; theta and log_scale are too, so the gate,
  the surrogate and the scale all act);
* the fault this repairs stays repaired: under ``spike_fused`` and
  ``spike_pack4`` x and theta get gradients, and ``int8``'s dx is the
  cotangent itself (straight through);
* ``spike.roundtrip_vjp`` (the ``roundtrip_bwd`` kernel's plain version)
  equals the reference's, float32 and bfloat16 activations.

The penalty and the faithful encoder's backward:
``test_torch_train_penalty.py``.

Log-scales are seeded in [-1, 1]: torch's and XLA's float32 ``exp``
differ in the last place for some arguments, which the 1e-6 bound
covers (a count that rounds the other way would not be covered; these
inputs give none).
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
from repro.models.context import codec_from_name as jcodec_from_name  # noqa: E402

from repro_torch.core import boundary as TB  # noqa: E402
from repro_torch.core import spike as TS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.context import codec_from_name  # noqa: E402

torch.set_num_threads(1)

CODECS = ("int8", "spike_fused", "spike", "spike_pack4", "sparse_topk",
          "spike_fused+bwd8", "int8+bwd8")
FNS = ("coded_all_gather", "coded_psum_scatter", "coded_psum")
TOL = 1e-6
_MESH = make_mesh((1, 1), ("data", "model"))


def _inputs(seed, shape=(2, 8, 64)):
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (rng.standard_normal(shape) * 0.8).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    p = {"theta": rng.uniform(0.0, 0.3, C).astype(np.float32),
         "log_scale": rng.uniform(-1.0, 1.0, C).astype(np.float32)}
    return x, g, p


_JGRAD = {}


def _jax_grads(name, codec_name, x, g, p):
    """``jax.grad`` of <g, f(x, theta, log_scale)> for the reference's
    collective under ``shard_map`` on a 1x1 mesh (jit-compiled once per
    function and codec)."""
    key = (name, codec_name)
    if key not in _JGRAD:
        codec = jcodec_from_name(codec_name, "hnn")
        fn = getattr(JB, name)
        kw = {} if name == "coded_psum" else {"axis": 1}

        def f(x, th, ls, g):
            y = fn(x, {"theta": th, "log_scale": ls}, codec, "model", **kw)
            return jnp.sum(y * g)

        _JGRAD[key] = jax.jit(jax.shard_map(
            jax.grad(f, argnums=(0, 1, 2)), mesh=_MESH,
            in_specs=(P(), P(), P(), P()), out_specs=(P(), P(), P()),
            check_vma=False))
    out = _JGRAD[key](jnp.array(x), jnp.array(p["theta"]),
                      jnp.array(p["log_scale"]), jnp.array(g))
    return [np.asarray(o) for o in out]


def _torch_grads(name, codec_name, x, g, p):
    codec = codec_from_name(codec_name, "hnn")
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    kw = {} if name == "coded_psum" else {"axis": 1}
    y = getattr(TB, name)(tx, tp, codec, **kw)
    (y * torch.tensor(g)).sum().backward()
    return [t.grad for t in (tx, tp["theta"], tp["log_scale"])]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("name", FNS)
def test_boundary_gradients_match_jax(name, codec):
    x, g, p = _inputs(1)
    want = _jax_grads(name, codec, x, g, p)
    got = _torch_grads(name, codec, x, g, p)
    for label, gt, w in zip(("x", "theta", "log_scale"), got, want):
        assert gt is not None, f"{label}: no gradient"
        np.testing.assert_allclose(gt.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {codec} d{label}")
    if codec.startswith("int8"):
        assert not want[1].any() and not want[2].any()
    else:
        assert np.abs(want[1]).sum() > 0 and np.abs(want[2]).sum() > 0


@pytest.mark.parametrize("codec", ["spike_fused", "spike_pack4", "int8"])
def test_coded_wire_passes_gradients(codec):
    """Unit cotangents on a [2, 8, 64] input: the spike codecs give x and
    theta gradients; int8 passes the cotangent straight through (sum
    |dx| = 1024, the element count)."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.standard_normal((2, 8, 64)).astype(np.float32),
                     requires_grad=True)
    p = {"theta": torch.full((64,), 0.01, requires_grad=True),
         "log_scale": torch.zeros(64, requires_grad=True)}
    for name in FNS:
        x.grad = p["theta"].grad = None
        kw = {} if name == "coded_psum" else {"axis": 1}
        getattr(TB, name)(x, p, codec_from_name(codec, "hnn"),
                          **kw).sum().backward()
        assert x.grad is not None
        if codec == "int8":
            assert float(x.grad.abs().sum()) == 1024.0
            assert torch.equal(x.grad, torch.ones_like(x))
        else:
            assert p["theta"].grad is not None
            assert float(p["theta"].grad.abs().sum()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [15, 7])
def test_roundtrip_vjp_matches_jax(T, dtype):
    x, g, p = _inputs(2, (3, 5, 48))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cfg_j, cfg_t = JS.SpikeConfig(T=T), TS.SpikeConfig(T=T)
    want = JS.roundtrip_vjp(jnp.array(x, jdt), jnp.array(p["theta"]),
                            jnp.array(p["log_scale"]), jnp.array(g, jdt),
                            cfg_j)
    got = TS.roundtrip_vjp(torch.tensor(x).to(tdt),
                           torch.tensor(p["theta"]),
                           torch.tensor(p["log_scale"]),
                           torch.tensor(g).to(tdt), cfg_t)
    assert got[0].dtype == tdt and got[0].shape == x.shape
    tol = TOL if dtype == "float32" else 1e-2
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_roundtrip_bwd_plain_parts():
    """The plain version's sums are the rows' sums of its element terms
    (the kernel's contract), and its dx is in x's dtype."""
    x, g, p = _inputs(3, (37, 40))
    s = torch.exp(torch.tensor(p["log_scale"]))
    dx, dth, dls = ops.roundtrip_bwd(torch.tensor(x), torch.tensor(g),
                                     torch.tensor(p["theta"]), s, s / 15,
                                     T=15)
    assert dx.shape == (37, 40) and dth.shape == dls.shape == (40,)
    for rows in (slice(0, 20), slice(20, 37)):
        part = ops.roundtrip_bwd(torch.tensor(x[rows]), torch.tensor(g[rows]),
                                 torch.tensor(p["theta"]), s, s / 15, T=15)
        torch.testing.assert_close(part[0], dx[rows], rtol=0, atol=0)
    halves = [ops.roundtrip_bwd(torch.tensor(x[r]), torch.tensor(g[r]),
                                torch.tensor(p["theta"]), s, s / 15, T=15)
              for r in (slice(0, 20), slice(20, 37))]
    torch.testing.assert_close(halves[0][1] + halves[1][1], dth, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(halves[0][2] + halves[1][2], dls, rtol=1e-6,
                               atol=1e-6)
