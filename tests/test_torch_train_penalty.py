"""The eq-10 sparsity penalty and the faithful encoder's backward
against JAX.

* The faithful encoder's CUDA autograd Function (``spike._LIFEncode``),
  run here on its kernels' plain versions, gives the CPU autograd
  path's counts and gradients, and its backward's plain version
  (``ops.lif_encode_bwd``, the K2 kernel's) gives ``jax.grad``'s
  element gradients;
* ``boundary_penalty``, ``sparsity_loss``, ``firing_rate`` and
  ``occupancy``: values and gradients equal JAX's (the penalty's
  gradient of ``|counts|`` at a count of 0 is JAX's +1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import boundary as JB  # noqa: E402
from repro.core import spike as JS  # noqa: E402
from repro.models.context import codec_from_name as jcodec_from_name  # noqa: E402

from repro_torch.core import boundary as TB  # noqa: E402
from repro_torch.core import spike as TS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.context import codec_from_name  # noqa: E402

from test_torch_train_boundary import _inputs  # noqa: E402

torch.set_num_threads(1)


def test_faithful_function_matches_autograd_path():
    """``spike._LIFEncode`` (the card's route for a faithful encode that
    wants a gradient), run on the CPU through its kernels' plain
    versions: the same counts and gradients as the autograd path."""
    x, g, p = _inputs(4, (6, 40))
    scale = torch.exp(torch.tensor(p["log_scale"]))
    outs = []
    for route in ("autograd", "function"):
        tx = torch.tensor(x, requires_grad=True)
        th = torch.tensor(p["theta"], requires_grad=True)
        xn, thn = tx / scale, th / scale
        if route == "autograd":
            y = TS.lif_rate_encode_signed(xn, thn, 15)
        else:
            y = TS._LIFEncode.apply(xn, thn, 15)
        (y * torch.tensor(g)).sum().backward()
        outs.append((y.detach(), tx.grad, th.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert float(outs[0][1].abs().sum()) > 0


def test_lif_encode_bwd_plain_matches_jax():
    """The K2 kernel's plain version: per-element gradients of
    ``lif_rate_encode_signed`` w.r.t. the normalised input and
    threshold, against ``jax.grad`` with the threshold broadcast to
    [M, C] (within 2e-5 of the largest gradient entry)."""
    x, g, p = _inputs(5, (16, 64))
    xn = (x * 1.3).astype(np.float32)
    thn = p["theta"]

    def f(a, t):
        return jnp.sum(JS.lif_rate_encode_signed(a, t, 15) * jnp.array(g))

    jdx, jdt = jax.grad(f, argnums=(0, 1))(
        jnp.array(xn), jnp.broadcast_to(jnp.array(thn), xn.shape))
    dx, dt = ops.lif_encode_bwd(torch.tensor(xn), torch.tensor(thn),
                                torch.tensor(g), T=15)
    scale = max(float(np.abs(jdx).max()), float(np.abs(jdt).max()))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(dt.numpy(), np.asarray(jdt), rtol=0,
                               atol=2e-5 * scale)
    assert np.abs(np.asarray(jdx)).max() > 1.0     # the surrogate acts


@pytest.mark.parametrize("codec", ["none", "int8", "spike_fused", "spike",
                                   "spike_pack4", "sparse_topk"])
def test_boundary_penalty_matches_jax(codec):
    x, _, p = _inputs(6, (2, 8, 64))     # firing rates above the target
    jc = jcodec_from_name(codec, "hnn")
    tc = codec_from_name(codec, "hnn")

    def f(a, th, ls):
        pen, occ = JB.boundary_penalty(a, {"theta": th, "log_scale": ls}, jc)
        return pen, occ

    (jpen, jocc) = f(jnp.array(x), jnp.array(p["theta"]),
                     jnp.array(p["log_scale"]))
    jg = jax.grad(lambda *a: f(*a)[0], argnums=(0, 1, 2))(
        jnp.array(x), jnp.array(p["theta"]), jnp.array(p["log_scale"]))
    tx = torch.tensor(x, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    pen, occ = TB.boundary_penalty(tx, tp, tc)
    np.testing.assert_allclose(pen.item(), float(jpen), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(occ.item(), float(jocc), rtol=1e-6, atol=0)
    if codec in ("none", "int8"):
        assert pen.item() == 0.0 and not pen.requires_grad
        return
    assert pen.item() > 0
    pen.backward()
    for gt, w in zip((tx.grad, tp["theta"].grad, tp["log_scale"].grad), jg):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-9)


def test_sparsity_stats_match_jax():
    rng = np.random.RandomState(7)
    counts = rng.randint(-15, 16, (4, 6, 32)).astype(np.float32)
    counts[rng.random_sample(counts.shape) < 0.6] = 0.0
    jc, tc = jnp.array(counts), torch.tensor(counts, requires_grad=True)
    for T, target, lam in ((15, 0.1, 1e-3), (7, 0.9, 0.5)):
        want = JS.sparsity_loss(jc, T, target, lam)
        got = TS.sparsity_loss(tc, T, target, lam)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        jg = jax.grad(lambda c: JS.sparsity_loss(c, T, target, lam))(jc)
        (tg,) = torch.autograd.grad(got, tc)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(TS.firing_rate(tc, T).item(),
                                   float(JS.firing_rate(jc, T)), rtol=1e-6)
    assert TS.sparsity_loss(tc, 15, 0.9, 1.0).item() == 0.0  # below target
    np.testing.assert_allclose(TS.occupancy(tc).item(),
                               float(JS.occupancy(jc)), rtol=1e-6)
