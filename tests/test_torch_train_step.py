"""The port's train step and AdamW against the JAX reference's.

Reduced ``qwen1.5-0.5b`` in float32 with the JAX init (as in
``test_torch_train_loss.py``).  Three steps of ``make_train_step`` on
the smoke shape (2 x 32 tokens; 4 x 32 at two microbatches), batch
``s`` the uniform tokens of ``PRNGKey(1 + s)`` (``smoke_batch``; batch
0 at 2 x 32 is ``examples/quickstart.py``'s), AdamW with warmup: after
the first and the third step the parameters, ``m``, ``v``, ``count``
and the metrics (NLL, penalty, occupancy, grad norm) equal the JAX
step's, at microbatches 1 and 2, under ``spike_fused`` (HNN) here at
one microbatch and in ``test_torch_train_step_mb2.py`` at two, ``none``
(ANN) in ``test_torch_train_step_ann.py`` and ``spike`` in
``test_torch_train_step_spike.py`` and ``_spike_mb2.py`` (each JAX step
compiles once per codec and microbatch count, so they are split over
files for the 30 s budget of one file).  The first step at one
microbatch is the reference's own run: NLL 5.5641, penalty 0.00211,
occupancy 0.9708, grad norm 1.5102 under ``spike_fused`` and 18.43
under ``spike`` (the surrogate through the IF ticks).

Tolerance 1e-5 (absolute and relative) on every leaf and metric.  The
first AdamW step moves each weight by about ``lr * g / (|g| + eps)``,
so a gradient entry near ``eps`` whose value is float noise would show
as a large difference; none does under ``spike_fused`` and ``none``.
Under ``spike`` the reference's gradient itself moves with float noise
(``test_torch_train_loss.py``), and a few such entries do: there the
forward metrics keep the 1e-5 bound; the grad norm must lie within
``NOISE_FACTOR`` times the gradient's response to a relative 1e-7
change of the embedding (the larger of two seeded changes); and each
state update (new minus old parameters, ``m``, ``v``) within 1e-5 of
JAX's or ``NOISE_FACTOR`` times that leaf's own response, leaf by leaf
(``assert_leaves_conditioned``).  Each step there starts from the JAX
step's state, so one step's noise is set against one step's.
``apply_updates`` and ``schedule`` are also held to JAX's on random
trees, with the global norm clipping and without.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import train as TR  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402

from repro_torch.checkpoint.convert import params_from_jax  # noqa: E402
from repro_torch.checkpoint.convert import keystr  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

from test_torch_train_loss import (MESH, NOISE_FACTOR, TOL,  # noqa: E402
                                   assert_leaves_conditioned,
                                   assert_trees_close, configs, flat,
                                   jax_params, perturbed, smoke_batch)

torch.set_num_threads(1)

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS = 3


def _copy(tree):
    return jax.tree.map(lambda a: jnp.array(np.asarray(a)), tree)


def _unflat(like, arrays, prefix=()):
    """A port tree shaped as ``like`` from {path: numpy} ``arrays``."""
    if isinstance(like, dict):
        return {k: _unflat(v, arrays, prefix + (k,)) for k, v in like.items()}
    return torch.tensor(np.asarray(arrays[keystr(prefix)]))


def check_train_steps(hnn, codec, microbatches):
    jcfg, tcfg, plan = configs(hnn, codec)
    params = jax_params(jcfg, plan)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    jstep, *_ = TR.make_train_step(jcfg, plan, MESH,
                                   microbatches=microbatches,
                                   opt_cfg=JA.AdamWConfig(**OPT))
    tstep = TT.make_train_step(tcfg, microbatches=microbatches,
                               opt_cfg=TA.AdamWConfig(**OPT), device="cpu")
    gstep = TT.make_train_step(tcfg, microbatches=microbatches,
                               with_optimizer=False, device="cpu")
    if codec == "spike":
        jgstep = TR.make_train_step(jcfg, plan, MESH,
                                    microbatches=microbatches,
                                    with_optimizer=False)[0]
    jopt, topt = JA.init_opt_state(params), TA.init_opt_state(tparams)
    B = 2 * microbatches
    first = None
    for s in range(STEPS):
        batch = smoke_batch(s, global_batch=B)
        before, before_opt = params, jopt
        # the JAX step donates its inputs: hand it copies, made alike at
        # every step so that it compiles once
        params, jopt, jm = jstep(_copy(params), _copy(jopt),
                                 {k: jnp.array(v) for k, v in batch.items()})
        if codec == "spike" and s > 0:
            # from JAX's state: each step's float noise alone
            tparams = params_from_jax(jax.tree.map(np.asarray, before),
                                      tcfg, device="cpu")
            topt = TA.tree_map(lambda a: torch.tensor(np.asarray(a)),
                               before_opt)
        prev, prev_opt = tparams, topt
        tparams, topt, tm = tstep(tparams, topt, batch)
        for k in ("loss", "penalty", "occupancy", "grad_norm"):
            if k == "grad_norm" and codec == "spike":
                continue
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"step {s} {k}")
        if codec == "spike":
            # the gradient, leaf by leaf, within its own response to
            # float noise of JAX's; the grad norm within the whole
            # gradient's response
            g0 = flat(gstep(prev, batch)[1])
            noisy = [flat(gstep(perturbed(prev, seed), batch)[1])
                     for seed in (1, 2)]
            jg = flat(jgstep(_copy(before),
                             {k: jnp.array(v)
                                      for k, v in batch.items()})[1])
            assert_leaves_conditioned(g0, jg, noisy, None,
                                      f"step {s} grad ")
            keys = sorted(g0)
            v0 = np.concatenate([g0[k].ravel() for k in keys])
            noise = max(np.linalg.norm(np.concatenate(
                [n[k].ravel() for k in keys]) - v0) for n in noisy)
            gn, jgn = tm["grad_norm"].item(), float(jm["grad_norm"])
            assert abs(gn - jgn) / jgn <= max(
                TOL, NOISE_FACTOR * noise / np.linalg.norm(v0)), (
                s, gn, jgn, noise)
        if s not in (0, STEPS - 1):
            continue
        if codec == "spike":
            # the step is AdamW on that gradient, and AdamW on JAX's
            # gradient gives JAX's state within 1e-5
            tg = _unflat(prev, g0)
            want = TA.apply_updates(prev, tg, prev_opt,
                                    gnorm=TT.global_grad_norm(tg),
                                    cfg=TA.AdamWConfig(**OPT))
            for a, b in zip(flat((tparams, topt)).values(),
                            flat(want).values()):
                assert np.array_equal(a, b)
            p1, o1 = TA.apply_updates(
                prev, _unflat(prev, jg), prev_opt,
                gnorm=torch.tensor(np.float32(jm["grad_norm"])),
                cfg=TA.AdamWConfig(**OPT))
            assert_trees_close(p1, params, what=f"step {s} params ")
            assert_trees_close(o1, jopt, what=f"step {s} opt ")
        else:
            assert_trees_close(tparams, params, what=f"step {s} params ")
            assert_trees_close(topt, jopt, what=f"step {s} opt ")
        if first is None:
            first = {k: float(v) for k, v in jm.items()}
    assert int(topt["count"]) == STEPS
    return first


def test_train_steps_match_jax():
    first = check_train_steps("hnn", "spike_fused", 1)
    check_oracle(first, 1.5102, 1e-4)


def check_oracle(first, grad_norm, atol):
    """The reference's first step on the quickstart batch, as measured:
    NLL 5.5641, penalty 0.00211, occupancy 0.9708, and ``grad_norm``."""
    np.testing.assert_allclose(first["loss"], 5.5641, atol=1e-4)
    np.testing.assert_allclose(first["penalty"], 0.00211, atol=5e-6)
    np.testing.assert_allclose(first["occupancy"], 0.9708, atol=1e-4)
    np.testing.assert_allclose(first["grad_norm"], grad_norm, atol=atol)


def test_step_leaves_its_inputs_unchanged():
    """The step returns new tensors; the ones it was given keep their
    values (the reference's jit donates them instead)."""
    _, tcfg, _ = configs("hnn", "spike_fused")
    params = TT.init_train_params(tcfg, 0, device="cpu")
    opt = TA.init_opt_state(params)
    keep = {k: v.copy() for k, v in flat(params).items()}
    keep_m = {k: v.copy() for k, v in flat(opt).items()}
    step = TT.make_train_step(tcfg, device="cpu")
    new, new_opt, m = step(params, opt, smoke_batch())
    assert all(np.array_equal(v, flat(params)[k]) for k, v in keep.items())
    assert all(np.array_equal(v, flat(opt)[k]) for k, v in keep_m.items())
    assert int(new_opt["count"]) == 1 and int(opt["count"]) == 0
    assert not np.array_equal(flat(new)["['embed']"], keep["['embed']"])
    loss, grads, metrics = TT.make_train_step(
        tcfg, device="cpu", with_optimizer=False)(params, smoke_batch())
    np.testing.assert_allclose(
        float(loss), float(metrics["loss"] + metrics["penalty"]), rtol=1e-6)
    assert sorted(flat(grads)) == sorted(keep)


def _random_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "inner": {"m": rng.standard_normal((3, 4, 2)).astype(np.float32),
                      "s": rng.standard_normal(()).astype(np.float32)}}


@pytest.mark.parametrize("clip", [None, 0.5])
def test_apply_updates_and_schedule_match_jax(clip):
    rng = np.random.RandomState(3)
    cfg_kw = dict(lr=3e-3, warmup_steps=3, total_steps=8, weight_decay=0.1)
    jcfg, tcfg = JA.AdamWConfig(**cfg_kw), TA.AdamWConfig(**cfg_kw)
    p = _random_tree(rng)
    jp = jax.tree.map(jnp.array, p)
    tp = TA.tree_map(torch.tensor, p)
    jo, to = JA.init_opt_state(jp), TA.init_opt_state(tp)
    for s in range(6):
        g = _random_tree(rng)
        gn = float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                               for v in jax.tree.leaves(g))))
        jgn = None if clip is None else jnp.float32(gn / clip)
        tgn = None if clip is None else torch.tensor(np.float32(gn / clip))
        jp, jo = JA.apply_updates(jp, jax.tree.map(jnp.array, g), jo,
                                  gnorm=jgn, cfg=jcfg)
        tp, to = TA.apply_updates(tp, TA.tree_map(torch.tensor, g), to,
                                  gnorm=tgn, cfg=tcfg)
        assert_trees_close(tp, jp, tol=1e-6, what=f"step {s} params ")
        assert_trees_close(to, jo, tol=1e-6, what=f"step {s} opt ")
    for step in range(0, 12):
        np.testing.assert_allclose(
            TA.schedule(tcfg, torch.tensor(step, dtype=torch.int32)).item(),
            float(JA.schedule(jcfg, jnp.int32(step))), rtol=1e-6, atol=0)
