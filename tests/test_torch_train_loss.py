"""The port's training forward against the JAX reference's.

Reduced ``qwen1.5-0.5b`` in float32 with the JAX package's own init
(``init_sharded_params`` on a 1x1 mesh), carried across with
``params_from_jax``, on the reference's smoke train shape (2 x 32
tokens) with the batch of ``examples/quickstart.py``: uniform tokens
from ``jax.random.randint(PRNGKey(1), ...)``, labels rolled by one.
``forward_loss`` — the NLL, the eq-10 penalty and the occupancy — and
the gradient of every parameter leaf equal
``jax.value_and_grad(M.forward_loss)`` under ``shard_map``: ANN mode
(codec ``none``), HNN ``spike_fused`` and SNN ``spike_fused`` here; HNN
``spike`` in ``test_torch_train_loss_spike.py`` and ``spike_pack4``,
``sparse_topk`` and ``spike_fused+bwd8`` in
``test_torch_train_loss_wire.py`` (one JAX model compiles per codec, so
the codecs are split over files).  On this batch one AdamW step of the
reference reads NLL 5.5641, penalty 0.00211, occupancy 0.9708 and a
grad norm of 1.5102 (``spike_fused``) or 18.43 (``spike``).

Tolerance 1e-5, relative and absolute.  Both sides compute in float32
but sum matmuls in different orders; HNN is compared up to the first
rounding split (a spike count whose input lies within float noise of a
rounding boundary), and on these inputs no count splits, so every
value is compared.

One exception, the ``spike`` codec's gradients (its values keep the
1e-5 bound).  Its penalty's gradient runs the fast-sigmoid surrogate
through 15 IF ticks, a product of factors up to 9 in size, so the
reference's own gradient moves with float noise: a relative change of
1e-7 in the embedding (float32 noise) moves some leaves by far more
than 1e-5 of their norm on these inputs (the same change moves
``spike_fused``'s by ~1e-7), and no elementwise 1e-5 bound can hold
between two float32 implementations there.  Each leaf of the port's
gradient must lie within 1e-5 of JAX's (relative L2 over the leaf) or,
where the leaf's own measured response to that noise is larger, within
``NOISE_FACTOR`` = 4 times that response (the larger of two seeded
perturbations; the port-to-JAX difference is itself float noise, and
the factor leaves room for the spread between samples).  The rule is
per leaf, so a wrong boundary-parameter gradient cannot hide in the
weights' norm.  This module holds the helpers the other training
tests share.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import smoke_shape  # noqa: E402
from repro.configs.reduced import reduced as jax_reduced  # noqa: E402
from repro.launch import specs as SP  # noqa: E402
from repro.launch import train as TR  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402

from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.checkpoint.convert import tree_paths  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.context import make_context  # noqa: E402

torch.set_num_threads(1)

ARCH = "qwen1.5-0.5b"
TOL = 1e-5
#: how many times the measured response to float noise a difference
#: from JAX may be, where the reference's gradient is ill-conditioned
NOISE_FACTOR = 4
MESH = make_mesh((1, 1), ("data", "model"))


def configs(hnn, codec, arch=ARCH, overrides=None):
    """(JAX config, port config, plan) of the reduced model in f32, with
    ``overrides`` replaced on both sides."""
    over = dict(overrides or {})
    jcfg = jax_reduced(jax_get_config(arch, hnn_mode=hnn)).replace(
        codec=codec, dtype=jnp.float32, **over)
    tcfg = reduced(get_config(arch, hnn_mode=hnn)).replace(
        codec=codec, dtype=torch.float32, **over)
    return jcfg, tcfg, SP.make_plan(jcfg, smoke_shape("train"), MESH)


def jax_params(jcfg, plan):
    return TR.init_sharded_params(jcfg, plan, MESH, jax.random.PRNGKey(0))


def smoke_batch(step=0, global_batch=2):
    """The smoke train shape's batch ``step`` (numpy, [B, 32]): the
    batch of ``examples/quickstart.py`` (uniform tokens from
    ``PRNGKey(1 + step)``, labels rolled by one)."""
    tok = np.asarray(jax.random.randint(jax.random.PRNGKey(1 + step),
                                        (global_batch, 32), 0, 256,
                                        jnp.int32))
    return {"tokens": tok, "labels": np.roll(tok, -1, 1)}


def assert_leaves_conditioned(got, ref, noisy, base, what):
    """Per leaf (dicts of numpy arrays): ``got - base`` within 1e-5 of
    ``ref - base`` (relative L2) or within ``NOISE_FACTOR`` times the
    leaf's response to float noise, ``|noisy - got|`` (each ``noisy``
    a list of perturbed results; the largest response counts).
    Returns the largest response relative to its leaf."""
    worst = 0.0
    for k, r in ref.items():
        b = 0 if base is None else base[k].astype(np.float64)
        g, r = got[k].astype(np.float64) - b, r.astype(np.float64) - b
        noise = max(np.linalg.norm(n[k] - b - g) for n in noisy)
        diff, size = np.linalg.norm(g - r), np.linalg.norm(r)
        assert diff <= max(TOL * size, NOISE_FACTOR * noise), (
            f"{what}{k}", diff / max(size, 1e-30), noise / max(size, 1e-30))
        worst = max(worst, noise / max(size, 1e-30))
    return worst


def flat(tree):
    """{keystr path: numpy array} of a JAX or a port tree (nested dicts,
    tuples and lists, in the reference's flattening order)."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in tree_paths(tree)}


def assert_trees_close(got, want, tol=TOL, what=""):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol,
                                   err_msg=f"{what}{k}")


def check_forward_loss(hnn, codec, arch=ARCH, overrides=None, seed=None):
    """``forward_loss`` and every leaf's gradient of the reduced ``arch``
    (with ``overrides``), port vs JAX; ``seed(params)``, where given,
    reseeds the JAX parameters first.  Returns (JAX loss, JAX metrics,
    JAX gradients by path)."""
    jcfg, tcfg, plan = configs(hnn, codec, arch, overrides)
    params = jax_params(jcfg, plan)
    if seed is not None:
        params = seed(params)
    _, pspecs, _ = TR.shard_params_specs(jcfg, plan)
    _, bspecs = SP.train_input_specs(plan)
    ctx = SP.make_context(plan, "train")
    mspec = {k: P() for k in ("loss", "penalty", "occupancy")}
    vg = jax.jit(jax.shard_map(
        jax.value_and_grad(lambda p, b: JM.forward_loss(p, b, ctx),
                           has_aux=True),
        mesh=MESH, in_specs=(pspecs, bspecs),
        out_specs=((P(), mspec), pspecs), check_vma=False))
    batch = smoke_batch()
    (jloss, jm), jgrads = vg(params, {k: jnp.array(v)
                                      for k, v in batch.items()})
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    leaves = [leaf.requires_grad_() for _, leaf in tree_paths(tparams)]
    loss, tm = TM.forward_loss(tparams, {k: torch.tensor(v) for k, v in
                                         batch.items()},
                               make_context(tcfg, "train"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
    for k in ("loss", "penalty", "occupancy"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    # a leaf the loss does not reach (the tp > 1 boundaries' params)
    # gets no gradient here and zeros in JAX
    grads = {k: torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
             for (k, _), leaf in zip(tree_paths(tparams), leaves)}
    want = flat(jgrads)
    if codec == "spike":
        got = {k: grads[k].numpy() for k in want}
        noisy = [noisy_grads(tparams, batch, tcfg, seed) for seed in (1, 2)]
        worst = assert_leaves_conditioned(got, want, noisy, None,
                                          f"{hnn}/{codec} grad ")
        assert worst > TOL                # the measure is needed here
    else:
        for k, w in want.items():
            np.testing.assert_allclose(grads[k].numpy(), w, rtol=TOL,
                                       atol=TOL,
                                       err_msg=f"{hnn}/{codec} grad {k}")
    if codec != "none" and hnn != "ann":
        assert float(jm["penalty"]) > 0
        sp = [k for k in want if "sp_in" in k]
        assert sp and all(np.abs(want[k]).sum() > 0 for k in sp)
    return float(jloss), {k: float(v) for k, v in jm.items()}, want


def perturbed(tparams, seed=1):
    """``tparams`` with the embedding changed by a seeded relative 1e-7,
    float32 noise."""
    gen = torch.Generator().manual_seed(seed)
    emb = tparams["embed"].detach()
    return dict(tparams, embed=emb * (1 + 1e-7 * torch.randn(
        emb.shape, generator=gen)))


def noisy_grads(tparams, batch, tcfg, seed):
    """{path: numpy} gradient of the port's ``forward_loss`` at
    ``perturbed(tparams, seed)``."""
    noisy = perturbed(tparams, seed)
    paths = [k for k, _ in tree_paths(noisy)]
    leaves = [leaf.detach().requires_grad_()
              for _, leaf in tree_paths(noisy)]
    it = iter(leaves)
    noisy = _rebuild(noisy, it)
    loss, _ = TM.forward_loss(noisy, {k: torch.tensor(v) for k, v in
                                      batch.items()},
                              make_context(tcfg, "train"))
    out = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {k: (torch.zeros_like(v) if g is None else g).numpy()
            for k, v, g in zip(paths, leaves, out)}


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


@pytest.mark.parametrize("hnn,codec", [("ann", "none"),
                                       ("hnn", "spike_fused"),
                                       ("snn", "spike_fused")])
def test_forward_loss_matches_jax(hnn, codec):
    check_forward_loss(hnn, codec)
