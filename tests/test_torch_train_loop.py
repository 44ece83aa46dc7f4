"""The port's checkpoints, data pipeline and fault-tolerant train loop.

* Checkpoints: a ``(params, opt_state)`` pair written by the JAX
  package's ``CheckpointManager`` restores in the port's (every leaf
  bit-equal, on its template's device, bf16 leaves too), and one
  written by the port restores in the JAX package's; both write the
  same manifest (paths, keys, shapes, dtypes); an interrupted save
  (no ``COMMIT``) is skipped; old steps are collected.
* ``SyntheticLM`` and ``FileByteSource`` batches equal the JAX
  package's bit for bit; the ``Prefetcher`` keeps the step order.
* ``TrainLoop``: the cases of ``tests/test_ft.py`` through the port —
  restart from the newest checkpoint, the NaN guard, the straggler
  watch, and the injected preemption, replica loss (with and without a
  checkpoint before it) and suspend — with a quadratic toy step on
  torch tensors; and the port's ``serving.slo.FaultInjector`` driving
  the loop with the reference test's plan.
* ``train_cli.main`` on the reduced config: a run of 4 steps with a
  checkpoint every 2, then a resume to 6, gives the losses of an
  uninterrupted 6-step run (exactly, on the CPU); ``--lam`` and
  ``--target-rate`` reach the penalty; ``--mesh`` other than ``1x1``,
  ``--draft-heads``, ``--draft-hidden`` and ``--init-from`` raise
  ``NotImplementedError``.  The
  runs stay inside the warmup, where the learning rate does not depend
  on the run's length.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch import train_cli  # noqa: E402
from repro_torch.runtime.ft import FTConfig, TrainLoop  # noqa: E402
from repro_torch.serving.slo import FaultInjector, FaultPlan  # noqa: E402

torch.set_num_threads(1)


def _state(rng):
    params = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
              "units": {"pos0": {"wq": rng.standard_normal((2, 4, 4))
                                 .astype(np.float32),
                                 "ln": rng.standard_normal((2, 4))
                                 .astype(np.float32)}},
              "half": rng.standard_normal((3, 2)).astype(np.float32)}
    opt = {"m": {k: np.zeros_like(v) for k, v in params.items()
                 if k != "units"},
           "count": np.int32(7)}
    return params, opt


def _jax_tree(params, opt):
    jp = jax.tree.map(jnp.array, params)
    jp["half"] = jp["half"].astype(jnp.bfloat16)
    return jp, jax.tree.map(jnp.array, opt)


def _torch_tree(params, opt):
    tp = jax.tree.map(torch.tensor, params)
    tp["half"] = tp["half"].to(torch.bfloat16)
    return tp, jax.tree.map(lambda a: torch.tensor(np.asarray(a)), opt)


def _assert_same(torch_tree, jax_tree):
    tl = jax.tree.leaves(torch_tree)
    jl = jax.tree.leaves(jax_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert str(j.dtype) == "bfloat16"
            np.testing.assert_array_equal(t.float().numpy(),
                                          j.astype(np.float32))
        else:
            assert t.numpy().dtype == j.dtype
            np.testing.assert_array_equal(t.numpy(), j)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    params, opt = _state(np.random.RandomState(0))
    jtree = _jax_tree(params, opt)
    JCkpt(str(tmp_path)).save(5, jtree)
    template = _torch_tree(*_state(np.random.RandomState(1)))
    tree, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 5 and isinstance(tree, tuple)
    _assert_same(tree, jtree)


def test_port_checkpoint_restores_in_jax(tmp_path):
    params, opt = _state(np.random.RandomState(2))
    ttree = _torch_tree(params, opt)
    CheckpointManager(str(tmp_path / "t")).save(9, ttree)
    template = _jax_tree(*_state(np.random.RandomState(3)))
    jtree, step = JCkpt(str(tmp_path / "t")).restore(template)
    assert step == 9
    _assert_same(ttree, jtree)
    # the two packages write the same manifest
    JCkpt(str(tmp_path / "j")).save(9, _jax_tree(params, opt))
    man = [json.load(open(tmp_path / d / "step_000000009" / "MANIFEST.json"))
           for d in ("t", "j")]
    assert man[0] == man[1]


def test_uncommitted_save_is_skipped_and_old_steps_collected(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(3, dtype=torch.float32)}
    for s in (1, 2, 3):
        ck.save(s, {"w": tree["w"] + s}, blocking=s != 2)
        ck.wait()
    assert ck.committed_steps() == [2, 3]
    os.makedirs(tmp_path / "step_000000004")      # a save cut short
    assert ck.latest_step() == 3
    got, step = ck.restore({"w": torch.zeros(3)})
    assert step == 3 and torch.equal(got["w"], tree["w"] + 3)
    with pytest.raises(ValueError):
        ck.restore({"w": torch.zeros(4)})


def test_data_sources_match_jax(tmp_path):
    for kw in ({}, {"vocab": 300, "seq_len": 17, "global_batch": 4,
                    "seed": 5}, {"global_batch": 4, "n_hosts": 2,
                                 "host_id": 1}):
        tsrc = TP.SyntheticLM(TP.DataConfig(**kw))
        jsrc = JP.SyntheticLM(JP.DataConfig(**kw))
        for step in (0, 3):
            tb, jb = tsrc.batch(step), jsrc.batch(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(tb[k], jb[k])
    path = tmp_path / "corpus.bin"
    np.random.RandomState(0).randint(0, 256, 4000).astype(np.uint8).tofile(
        path)
    cfg = dict(seq_len=31, global_batch=3, seed=2)
    tb = TP.FileByteSource(TP.DataConfig(**cfg), str(path)).batch(4)
    jb = JP.FileByteSource(JP.DataConfig(**cfg), str(path)).batch(4)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(tb[k], jb[k])
    src = TP.SyntheticLM(TP.DataConfig(global_batch=2, seq_len=8))
    pf = TP.Prefetcher(src, start_step=3)
    try:
        for want in (3, 4, 5):
            step, b = next(pf)
            assert step == want
            np.testing.assert_array_equal(b["tokens"],
                                          src.batch(want)["tokens"])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# TrainLoop: the cases of tests/test_ft.py through the port
# ---------------------------------------------------------------------------


class ToyStep:
    """Quadratic toy step with injectable failures."""

    def __init__(self, nan_at=(), slow_at=()):
        self.nan_at = set(nan_at)
        self.slow_at = set(slow_at)
        self.calls = 0

    def __call__(self, params, opt, batch):
        import time
        step = self.calls
        self.calls += 1
        if step in self.slow_at:
            time.sleep(0.25)
        w = params["w"]
        new = {"w": w - 0.1 * (2 * w)}
        loss = float(torch.sum(w ** 2))
        if step in self.nan_at:
            loss = float("nan")
        return new, opt, {"loss": torch.tensor(loss)}


def _loop(tmp_path, step_fn, every=3):
    cfg = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=every,
                   async_ckpt=False)
    data = TP.SyntheticLM(TP.DataConfig(global_batch=2, seq_len=4))
    return TrainLoop(step_fn, data, cfg, log_fn=lambda *_: None)


def test_restart_resumes_from_checkpoint(tmp_path):
    params = {"w": torch.tensor([4.0])}
    _loop(tmp_path, ToyStep()).run(params, {}, n_steps=7)
    loop2 = _loop(tmp_path, ToyStep())
    _, _, hist = loop2.run(params, {}, n_steps=10, resume=True)
    assert loop2.ckpt.latest_step() >= 9
    assert len(hist) <= 5          # only the remaining steps ran


def test_nan_guard_skips_update(tmp_path):
    loop = _loop(tmp_path, ToyStep(nan_at={2}))
    p, _, _ = loop.run({"w": torch.tensor([4.0])}, {}, n_steps=5,
                       resume=False)
    assert loop.nan_skips == 1
    assert np.isfinite(float(p["w"][0]))


def test_straggler_detection(tmp_path):
    loop = _loop(tmp_path, ToyStep(slow_at={5}))
    loop.run({"w": torch.tensor([1.0])}, {}, n_steps=8, resume=False)
    assert loop.straggler_events >= 1


class ScriptedInjector:
    """Minimal ``next_fault()`` duck-type: a scripted kind per tick."""

    def __init__(self, kinds):
        self.kinds = list(kinds)
        self.injected = {"preempt": 0, "replica_loss": 0, "suspend": 0}

    def next_fault(self):
        return (self.kinds.pop(0) if self.kinds else None), 0.0


def test_injected_preempt_checkpoints_and_exits_clean(tmp_path):
    loop = _loop(tmp_path, ToyStep())
    inj = ScriptedInjector([None, None, "preempt"])
    _, _, hist = loop.run({"w": torch.tensor([4.0])}, {}, n_steps=10,
                          resume=False, injector=inj)
    assert loop.preempted and len(hist) == 3
    assert loop.injected == {"preempt": 1} and inj.injected["preempt"] == 1
    assert loop.ckpt.latest_step() == 3


def test_injected_replica_loss_replays_bit_exact(tmp_path):
    params = {"w": torch.tensor([4.0])}
    _, _, ref = _loop(tmp_path / "clean", ToyStep()).run(
        params, {}, n_steps=8, resume=False)
    loop = _loop(tmp_path / "faulty", ToyStep())
    inj = ScriptedInjector([None] * 5 + ["replica_loss"])
    _, _, hist = loop.run(params, {}, n_steps=8, resume=False, injector=inj)
    assert loop.injected == {"replica_loss": 1}
    assert len(hist) == len(ref) == 8
    assert [h["loss"] for h in hist] == [r["loss"] for r in ref]


def test_injected_replica_loss_without_prior_checkpoint(tmp_path):
    loop = _loop(tmp_path, ToyStep())
    _, _, hist = loop.run({"w": torch.tensor([2.0])}, {}, n_steps=4,
                          resume=False,
                          injector=ScriptedInjector(["replica_loss"]))
    assert len(hist) == 4 and loop.injected == {"replica_loss": 1}


def test_injected_suspend_trips_straggler_watch(tmp_path):
    loop = _loop(tmp_path, ToyStep())
    loop.run({"w": torch.tensor([1.0])}, {}, n_steps=6, resume=False,
             injector=ScriptedInjector([None, None, None, "suspend"]))
    assert loop.injected == {"suspend": 1}
    assert loop.straggler_events >= 1


def test_real_fault_injector_drives_train_loop(tmp_path):
    loop = _loop(tmp_path, ToyStep())
    inj = FaultInjector(FaultPlan(seed=3, p_suspend=0.5, max_faults=2))
    loop.run({"w": torch.tensor([1.0])}, {}, n_steps=12, resume=False,
             injector=inj)
    assert 1 <= loop.injected.get("suspend", 0) <= 2
    assert loop.injected["suspend"] == inj.injected["suspend"]
    assert inj.total_injected <= 2


# ---------------------------------------------------------------------------
# the CLI: checkpoint, resume, refusals
# ---------------------------------------------------------------------------


def _cli(tmp_path, name, steps, *extra):
    return train_cli.main([
        "--reduced", "--device", "cpu", "--steps", str(steps), "--batch",
        "2", "--seq", "16", "--ckpt-every", "2", "--warmup", "8",
        "--log-every", "100", "--ckpt-dir", str(tmp_path / name), *extra])


def test_cli_resume_continues_the_run(tmp_path):
    _, straight = _cli(tmp_path, "straight", 6)
    _, first = _cli(tmp_path, "resumed", 4)
    # a second launch for 6 steps resumes from the step-4 checkpoint;
    # inside the warmup (8 steps) the schedule does not depend on
    # ``--steps``, so the three runs take the same learning rates
    out, rest = _cli(tmp_path, "resumed", 6)
    assert len(first) == 4 and len(rest) == 2 and out["steps"] == 2
    losses = [m["loss"] for m in straight]
    assert [m["loss"] for m in rest] == losses[4:]
    assert np.isfinite(losses).all() and out["nan_skips"] == 0


def test_cli_refuses_unported_options(tmp_path):
    with pytest.raises(NotImplementedError):
        _cli(tmp_path, "a", 1, "--mesh", "2x1")
    with pytest.raises(NotImplementedError):
        _cli(tmp_path, "b", 1, "--draft-heads", "2")
    with pytest.raises(NotImplementedError):
        _cli(tmp_path, "c", 1, "--draft-hidden", "64")
    with pytest.raises(NotImplementedError):
        _cli(tmp_path, "d", 1, "--init-from", str(tmp_path))


def test_cli_sparsity_flags_reach_the_penalty(tmp_path):
    """``--lam`` scales the first step's eq-10 penalty (the codec's
    weight is 1e-3) up to bfloat16 rounding (the reduced config's dtype;
    each side rounds the product once); a ``--target-rate`` of 1 (no
    rate exceeds it) switches it off."""
    base = _cli(tmp_path, "a", 1)[1][0]
    lam = _cli(tmp_path, "b", 1, "--lam", "0.1")[1][0]
    off = _cli(tmp_path, "c", 1, "--target-rate", "1.0")[1][0]
    assert base["penalty"] > 0
    np.testing.assert_allclose(lam["penalty"], 100 * base["penalty"],
                               rtol=2.0**-7)
    assert off["penalty"] == 0.0
    assert lam["loss"] == base["loss"] == off["loss"]
