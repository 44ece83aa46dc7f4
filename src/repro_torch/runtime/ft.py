"""Fault-tolerance runtime: restart loop, straggler watch, preemption.

The port of ``repro.runtime.ft``.  ``TrainLoop`` drives a train step
(``launch.train.make_train_step``):

  * checkpoint/restart — resumes from the newest committed step
    (``checkpoint.manager``, the reference's format); the deterministic
    data pipeline replays batch k bit-exactly.
  * preemption handling — SIGTERM sets a flag; the loop checkpoints and
    exits cleanly.
  * straggler watch — per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x EWMA are logged and counted.
  * NaN/overflow guard — skips the update and counts the event.
  * fault injection — ``run(injector=...)`` takes anything with the
    ``serving.slo.FaultInjector.next_fault()`` contract and maps its
    kinds as the reference does: ``preempt`` takes the SIGTERM
    checkpoint + clean-exit path, ``replica_loss`` restores the newest
    committed checkpoint and replays forward, ``suspend`` books an
    injected straggler tick into the EWMA watch.

At world size 1 there is no mesh to re-shard to: a restore places each
leaf on the device of the state the loop was given.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from ..checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    async_ckpt: bool = True
    straggler_factor: float = 2.0
    ewma_alpha: float = 0.1
    max_nan_skips: int = 10


class TrainLoop:
    def __init__(self, step_fn: Callable, data_source, cfg: FTConfig,
                 log_fn: Callable[[str], None] = print):
        self.step_fn = step_fn
        self.data = data_source
        self.cfg = cfg
        self.log = log_fn
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.preempted = False
        self.straggler_events = 0
        self.nan_skips = 0
        #: per-kind injected-fault tally (``run(injector=...)``)
        self.injected: dict = {}
        self._ewma: Optional[float] = None
        try:
            signal.signal(signal.SIGTERM, self._on_preempt)
        except ValueError:
            pass  # not main thread (tests)

    def _on_preempt(self, *_):
        self.log("[ft] preemption signal received; will checkpoint+exit")
        self.preempted = True

    # ------------------------------------------------------------------
    def run(self, params, opt_state, n_steps: int, resume: bool = True,
            injector=None):
        """Drive ``step_fn`` for ``n_steps`` with checkpoint/restart.

        ``injector`` (optional) is rolled once per step BEFORE the step
        runs — duck-typed on ``next_fault() -> (kind, pick)`` (see
        ``serving.slo.FaultInjector``):

          ``preempt``       the scheduler's preemption notice: same path
                            as SIGTERM — checkpoint, clean exit
          ``replica_loss``  revert to the newest committed checkpoint
                            and replay from there (the deterministic
                            data pipeline makes the redone steps
                            bit-exact); with no checkpoint yet, restart
                            from the initial state at step 0
          ``suspend``       a stalled host: the step's recorded wall
                            time is inflated past the straggler
                            threshold so the EWMA watch fires

        Injected events are tallied on ``self.injected`` and, when the
        injector carries a compatible dict, on ``injector.injected``.
        """
        start = 0
        if resume and self.ckpt.latest_step() is not None:
            (params, opt_state), start = self.ckpt.restore(
                (params, opt_state))
            self.log(f"[ft] resumed from step {start}")
        if injector is not None and self.ckpt.latest_step() is None:
            # a replica-loss-tolerant run always has a base checkpoint
            # to fall back to, as in the reference
            self.ckpt.save(start, (params, opt_state), blocking=True)

        def _tally(kind):
            self.injected[kind] = self.injected.get(kind, 0) + 1
            inj = getattr(injector, "injected", None)
            if isinstance(inj, dict):
                inj[kind] = inj.get(kind, 0) + 1

        metrics_hist = []
        step = start
        while step < n_steps:
            fault = None
            if injector is not None:
                fault, _ = injector.next_fault()
            if fault == "preempt":
                _tally("preempt")
                self.log(f"[ft] step {step}: injected preemption notice")
                self.preempted = True
            elif fault == "replica_loss":
                _tally("replica_loss")
                (params, opt_state), step = self.ckpt.restore(
                    (params, opt_state))
                self.log(f"[ft] replica loss: replaying from step {step}")
                del metrics_hist[max(step - start, 0):]
                continue
            batch = self.data.batch(step)
            t0 = time.time()
            new_params, new_opt, metrics = self.step_fn(
                params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if fault == "suspend":
                _tally("suspend")
                # a stalled host shows up as wall time, nothing else:
                # push this tick past the straggler threshold so the
                # watch (and its re-shard callback story) exercises
                dt += self.cfg.straggler_factor * max(self._ewma or dt,
                                                      dt) + 1e-3

            # NaN guard: skip poisoned updates
            if not np.isfinite(loss):
                self.nan_skips += 1
                self.log(f"[ft] step {step}: non-finite loss, skipping "
                         f"update ({self.nan_skips}/{self.cfg.max_nan_skips})")
                if self.nan_skips > self.cfg.max_nan_skips:
                    raise RuntimeError("too many non-finite steps")
            else:
                params, opt_state = new_params, new_opt

            # straggler watch
            if self._ewma is None:
                self._ewma = dt
            elif dt > self.cfg.straggler_factor * self._ewma:
                self.straggler_events += 1
                self.log(f"[ft] step {step}: straggler ({dt:.3f}s vs "
                         f"EWMA {self._ewma:.3f}s)")
            self._ewma = (1 - self.cfg.ewma_alpha) * self._ewma \
                + self.cfg.ewma_alpha * dt

            metrics_hist.append({k: float(v) for k, v in metrics.items()})

            if (step + 1) % self.cfg.ckpt_every == 0 or self.preempted:
                self.ckpt.save(step + 1, (params, opt_state),
                               blocking=not self.cfg.async_ckpt)
            if self.preempted:
                self.ckpt.wait()
                self.log(f"[ft] clean exit at step {step + 1}")
                break
            step += 1
        self.ckpt.wait()
        return params, opt_state, metrics_hist
