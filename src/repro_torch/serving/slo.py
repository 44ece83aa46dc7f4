"""Serving observability: per-request SLOs and fault injection.

The port's copy of ``repro.serving.slo`` (numpy only), without the
``BENCH_serve.json`` schema.  Both pieces are host-side and
engine-agnostic: they attach to a ``ServingEngine`` through its
observer hooks and the ``on_step`` callback, with no device work.

``SLOMonitor``
    Records the request lifecycle (submit -> first token -> finish,
    preemptions/restarts in between) and one ``StepEvent`` per scheduler
    tick (host latency, step kind, tokens committed, queue depth, pool
    pressure, wire bytes — split per collective stream when a stream
    profile is registered).  ``report()`` reduces that to TTFT/TPOT/
    step-latency p50/p95/p99 and SLO *attainment* — the fraction of
    finished requests meeting the ``SLOTargets`` — plus queue/pool
    pressure peaks and fault counts.  TTFT is measured from the ORIGINAL
    submit, so a preempted-and-re-served request pays its requeue
    penalty in the percentiles instead of hiding it.  Its ``clock`` is
    injectable (``time.perf_counter`` by default).

``FaultInjector``
    A seeded chaos source driven once per tick: preemption of the
    youngest slot (``p_preempt``), replica loss of a random active slot
    (``p_replica_loss``, pages reclaimed + request re-admitted from the
    queue), and simulated host preemption (``p_suspend``: drain the
    pipeline, snapshot every request, resume).  All three ride the
    engine's graceful-degradation paths, under which greedy streams do
    not change.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from .engine import WARMUP_RID

__all__ = ["FaultInjector", "FaultPlan", "SLOMonitor", "SLOTargets",
           "StepEvent", "load_trace", "percentiles"]


# ---------------------------------------------------------------------------
# percentile helpers
# ---------------------------------------------------------------------------


def percentiles(xs: Sequence[float]) -> Dict[str, float]:
    """{"p50","p95","p99","mean","n"} of ``xs`` (zeros when empty)."""
    xs = np.asarray(list(xs), np.float64)
    if xs.size == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "n": 0}
    p50, p95, p99 = np.percentile(xs, [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99),
            "mean": float(xs.mean()), "n": int(xs.size)}


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOTargets:
    """Per-request targets the attainment numbers are judged against."""

    ttft_ms: float = 500.0           # submit -> first token
    tpot_ms: float = 100.0           # mean per-token after the first


@dataclasses.dataclass
class StepEvent:
    """One scheduler tick's measurements."""

    t: float                         # monitor-clock timestamp (s)
    dt: float                        # host wall time since previous tick
    kind: str                        # "decode" | "verify"
    tokens: int                      # tokens committed during the tick
    queue_depth: int
    active: int
    pages_in_use: int
    pages_in_limbo: int
    wire_bytes: float                # total die-to-die bytes the tick's
    #                                  device step moved (0 if unknown),
    #                                  INCLUDING any KV migration below
    mig_bytes: float = 0.0           # disagg KV-migration bytes folded
    #                                  into this tick's wire_bytes
    accepted_len: float = 0.0        # mean tokens committed per (slot,
    #                                  verify-step) this tick — 0.0 on
    #                                  non-speculative ticks
    #: per-collective split of ``wire_bytes`` (stream kind -> bytes:
    #: psum / head_all_gather / partial_combine / kv_migrate / ...);
    #: always sums to ``wire_bytes``, empty when only the scalar was
    #: registered
    wire_streams: Dict[str, float] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class _ReqRecord:
    cls: str
    prompt_len: int
    t_submit: float                  # ORIGINAL submit (restarts keep it)
    t_first: Optional[float] = None
    t_finish: Optional[float] = None
    n_tokens: int = 0
    restarts: int = 0


class SLOMonitor:
    """Engine observer + ``on_step`` recorder; see module docstring.

    Attach with ``engine.observers.append(monitor)`` (or pass it to
    ``workload.replay``) and call ``monitor.on_step(engine)`` after
    every tick — ``engine.run(..., on_step=monitor.on_step)`` does.
    ``wire_streams_per_step`` maps step kind -> {stream kind -> bytes}
    of one step (the caller's profile: the port's engine has no
    ``wire_stream_profile()`` yet), so every tick records a
    per-collective ``wire_streams`` breakdown for a NoC co-simulation;
    ``wire_bytes_per_step`` is the scalar-only form.  A tick whose step
    kind has NO registered bytes would silently price at 0, so it warns
    (once per kind): register every kind the engine can emit —
    ``decode`` AND ``verify``.
    """

    def __init__(self, targets: Optional[SLOTargets] = None,
                 wire_bytes_per_step: Optional[Dict[str, float]] = None,
                 clock=time.perf_counter,
                 wire_streams_per_step: Optional[
                     Dict[str, Dict[str, float]]] = None):
        self.targets = targets or SLOTargets()
        self.wire_streams_per_step = {
            k: dict(v) for k, v in (wire_streams_per_step or {}).items()}
        self.wire_bytes_per_step = dict(wire_bytes_per_step or {})
        for k, streams in self.wire_streams_per_step.items():
            self.wire_bytes_per_step.setdefault(
                k, float(sum(streams.values())))
        self._warned_kinds: set = set()
        self.clock = clock
        self.requests: Dict[object, _ReqRecord] = {}
        self.steps: List[StepEvent] = []
        self.preemptions = 0
        self.suspends = 0
        self.migrations = 0
        self.migrated_bytes = 0.0
        self._t_last: Optional[float] = None
        self._tokens_last = 0
        self._steps_last = 0
        self._pending_mig_bytes = 0.0
        self._spec_commits_last = 0
        self._spec_verifies_last = 0
        self._spec_k = 0
        #: per-tick mean accepted-draft lengths (speculative ticks only)
        self.accepted_lens: List[float] = []

    # -- engine observer hooks (duck-typed; all optional) ------------------

    def on_submit(self, rid, prompt_len: int):
        if rid is WARMUP_RID:
            return
        rec = self.requests.get(rid)
        if rec is None:
            cls = rid.split("/")[1] if (isinstance(rid, str)
                                        and rid.count("/") >= 2) else ""
            self.requests[rid] = _ReqRecord(cls, prompt_len, self.clock())
        else:
            # re-submit after suspend/preempt: the request restarts from
            # scratch but its clock does NOT — the requeue penalty is
            # the SLO story, so t_submit stays and first/finish clear
            rec.restarts += 1
            rec.t_first = rec.t_finish = None
            rec.n_tokens = 0

    def on_first_token(self, rid):
        rec = self.requests.get(rid)
        if rec is not None and rec.t_first is None:
            rec.t_first = self.clock()

    def on_finish(self, rid, n_tokens: int):
        rec = self.requests.get(rid)
        if rec is not None:
            rec.t_finish = self.clock()
            rec.n_tokens = n_tokens

    def on_preempt(self, rid, kind: str):
        self.preemptions += 1
        rec = self.requests.get(rid)
        if rec is not None:
            rec.restarts += 1
            rec.t_first = rec.t_finish = None
            rec.n_tokens = 0

    def on_suspend(self, rids: Sequence):
        """One drain+snapshot event; ``rids`` are the mid-generation
        requests losing their work — they restart from scratch on
        resume, so their first-token clocks reset (TTFT keeps measuring
        from the ORIGINAL submit, same as preemption)."""
        self.suspends += 1
        for rid in rids:
            rec = self.requests.get(rid)
            if rec is not None:
                rec.restarts += 1
                rec.t_first = rec.t_finish = None
                rec.n_tokens = 0

    def on_migrate(self, rid, src_group: int, dst_group: int,
                   wire_bytes: int):
        """Disaggregated KV handoff: ``wire_bytes`` moved from the
        prefill group to the decode group for ``rid``.  Migrations fire
        during admission, between ticks — the bytes are held pending and
        folded into the NEXT ``StepEvent``'s ``wire_bytes`` (and
        surfaced separately as ``mig_bytes``) so a co-simulation
        prices them with the step that paid for them."""
        self.migrations += 1
        self.migrated_bytes += wire_bytes
        self._pending_mig_bytes += wire_bytes

    # -- per-tick recorder -------------------------------------------------

    def on_step(self, engine):
        now = self.clock()
        dt = 0.0 if self._t_last is None else now - self._t_last
        self._t_last = now
        kind = "verify" if engine.spec_k > 0 else "decode"
        d_tokens = engine.tokens_generated - self._tokens_last
        self._tokens_last = engine.tokens_generated
        d_steps = engine.decode_steps - self._steps_last
        self._steps_last = engine.decode_steps
        alloc = engine.cache.allocator
        mig, self._pending_mig_bytes = self._pending_mig_bytes, 0.0
        # per-step accepted-draft length: how many of this tick's verify
        # participations' tokens the drafter paid for (the acceptance
        # signal the drafter benches compare ngram vs heads on).
        # getattr: observers are duck-typed and host-side stub engines
        # (tests, other callers) may not carry the spec counters
        self._spec_k = max(self._spec_k, int(engine.spec_k))
        commits = getattr(engine, "spec_commits", 0)
        verifies = getattr(engine, "spec_verifies", 0)
        d_acc = commits - self._spec_commits_last
        d_ver = verifies - self._spec_verifies_last
        self._spec_commits_last = commits
        self._spec_verifies_last = verifies
        acc_len = d_acc / d_ver if d_ver > 0 else 0.0
        if d_ver > 0:
            self.accepted_lens.append(acc_len)
        if (d_steps > 0 and self.wire_bytes_per_step
                and kind not in self.wire_bytes_per_step
                and kind not in self._warned_kinds):
            # a registered-but-incomplete pricing table would silently
            # record 0 wire bytes for every tick of this kind, skewing
            # the co-simulation — warn once per kind instead
            self._warned_kinds.add(kind)
            warnings.warn(
                f"SLOMonitor: step kind {kind!r} has no registered wire "
                f"bytes (known: {sorted(self.wire_bytes_per_step)}); its "
                "ticks are priced at 0 bytes — register every kind the "
                "engine can emit (decode AND verify)", RuntimeWarning,
                stacklevel=2)
        base = self.wire_bytes_per_step.get(kind, 0.0) * d_steps
        if kind in self.wire_streams_per_step:
            streams = {k: v * d_steps for k, v
                       in self.wire_streams_per_step[kind].items()}
        elif base > 0:
            streams = {"total": base}
        else:
            streams = {}
        if mig > 0:
            streams["kv_migrate"] = streams.get("kv_migrate", 0.0) + mig
        self.steps.append(StepEvent(
            t=now, dt=dt, kind=kind, tokens=max(d_tokens, 0),
            queue_depth=engine.queue_depth, active=engine.num_active,
            pages_in_use=alloc.pages_in_use,
            pages_in_limbo=alloc.pages_in_limbo,
            wire_bytes=base + mig,
            mig_bytes=mig, accepted_len=acc_len, wire_streams=streams))

    def _flush_pending_mig(self):
        """Fold migration bytes still pending after the LAST tick into a
        terminal ``kind="drain"`` event so they are never dropped from
        wire accounting (a migration admitted on the final tick has no
        following ``on_step`` to absorb it).  ``dt=0.0`` keeps the event
        out of the step-latency percentiles."""
        mig, self._pending_mig_bytes = self._pending_mig_bytes, 0.0
        if mig <= 0:
            return
        last = self.steps[-1] if self.steps else None
        self.steps.append(StepEvent(
            t=self._t_last if self._t_last is not None else self.clock(),
            dt=0.0, kind="drain", tokens=0,
            queue_depth=last.queue_depth if last else 0,
            active=last.active if last else 0,
            pages_in_use=last.pages_in_use if last else 0,
            pages_in_limbo=last.pages_in_limbo if last else 0,
            wire_bytes=mig, mig_bytes=mig,
            wire_streams={"kv_migrate": mig}))

    # -- reductions --------------------------------------------------------

    def _finished(self) -> List[_ReqRecord]:
        return [r for r in self.requests.values()
                if r.t_finish is not None and r.t_first is not None]

    def report(self) -> dict:
        """Structured SLO report."""
        self._flush_pending_mig()
        fin = self._finished()
        t = self.targets
        ttft = [(r.t_first - r.t_submit) * 1e3 for r in fin]
        tpot = [(r.t_finish - r.t_first) / (r.n_tokens - 1) * 1e3
                for r in fin if r.n_tokens > 1]
        ok_ttft = [r for r in fin
                   if (r.t_first - r.t_submit) * 1e3 <= t.ttft_ms]
        ok_tpot = [r for r in fin if r.n_tokens <= 1
                   or (r.t_finish - r.t_first) / (r.n_tokens - 1) * 1e3
                   <= t.tpot_ms]
        tpot_ids = {id(r) for r in ok_tpot}
        ok_both = [r for r in ok_ttft if id(r) in tpot_ids]
        n = max(len(fin), 1)
        steps = [s for s in self.steps if s.dt > 0]
        tokens = sum(r.n_tokens for r in fin)
        span = (self.steps[-1].t - self.steps[0].t
                if len(self.steps) > 1 else 0.0)
        return {
            "requests": {
                "submitted": len(self.requests),
                "finished": len(fin),
                "restarts": sum(r.restarts for r in self.requests.values()),
            },
            "tokens_per_s": tokens / span if span > 0 else 0.0,
            "ttft_ms": percentiles(ttft),
            "tpot_ms": percentiles(tpot),
            "step_us": percentiles([s.dt * 1e6 for s in steps]),
            "queue_depth": {
                "mean": float(np.mean([s.queue_depth for s in self.steps]))
                if self.steps else 0.0,
                "max": max((s.queue_depth for s in self.steps), default=0),
            },
            "pool": {
                "peak_pages_in_use": max((s.pages_in_use
                                          for s in self.steps), default=0),
                "peak_pages_in_limbo": max((s.pages_in_limbo
                                            for s in self.steps), default=0),
            },
            "slo": {
                "ttft_target_ms": t.ttft_ms,
                "tpot_target_ms": t.tpot_ms,
                "ttft_attainment": len(ok_ttft) / n,
                "tpot_attainment": len(ok_tpot) / n,
                "attainment": len(ok_both) / n,
            },
            "faults": {
                "preemptions": self.preemptions,
                "suspends": self.suspends,
            },
            # accepted-draft stats (all-zero on non-speculative runs):
            # accepted_len counts the correction token too, so rate =
            # (accepted_len - 1) / spec_k is the fraction of DRAFTS kept
            "acceptance": {
                "accepted_len": percentiles(self.accepted_lens),
                "rate": (max(float(np.mean(self.accepted_lens)) - 1.0, 0.0)
                         / self._spec_k
                         if self.accepted_lens and self._spec_k else 0.0),
            },
            "migration": {
                "count": self.migrations,
                "kb_total": self.migrated_bytes / 1e3,
                "kb_per_request": (self.migrated_bytes / 1e3
                                   / max(len(fin), 1)),
            },
        }

    def per_class_report(self) -> dict:
        """TTFT/TPOT percentiles split by request class (multi-tenant
        traces encode the class in the rid: ``t<seed>/<class>/<idx>``)."""
        out: dict = {}
        for cls in sorted({r.cls for r in self._finished()}):
            sub = [r for r in self._finished() if r.cls == cls]
            out[cls] = {
                "finished": len(sub),
                "ttft_ms": percentiles(
                    [(r.t_first - r.t_submit) * 1e3 for r in sub]),
                "tpot_ms": percentiles(
                    [(r.t_finish - r.t_first) / (r.n_tokens - 1) * 1e3
                     for r in sub if r.n_tokens > 1]),
            }
        return out

    # -- step-trace export ---------------------------------------------------

    def step_trace(self) -> List[dict]:
        """Per-tick records: the fields a NoC co-simulation consumes
        (``wire_streams``, ``wire_bytes``, ``tokens``) plus scheduling
        context."""
        self._flush_pending_mig()
        return [{"t": s.t, "dt_us": s.dt * 1e6, "kind": s.kind,
                 "tokens": s.tokens, "queue_depth": s.queue_depth,
                 "active": s.active, "pages_in_use": s.pages_in_use,
                 "pages_in_limbo": s.pages_in_limbo,
                 "wire_bytes": s.wire_bytes, "mig_bytes": s.mig_bytes,
                 "accepted_len": s.accepted_len,
                 "wire_streams": dict(s.wire_streams)}
                for s in self.steps]

    def write_trace(self, path: str):
        """Write the step trace as JSON lines (one tick per line)."""
        with open(path, "w") as f:
            for rec in self.step_trace():
                f.write(json.dumps(rec) + "\n")


def load_trace(path: str) -> List[dict]:
    """Read a ``write_trace`` JSONL file back (the NoC bridge's input)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded per-tick fault probabilities (at most one fault per tick).

    The draws come from one ``RandomState(seed)`` consumed once per
    tick, so a plan replayed over the same deterministic schedule
    injects the same faults at the same ticks — which is what lets the
    fault fuzz assert bit-identical greedy streams.
    """

    seed: int = 0
    p_preempt: float = 0.0           # evict + re-queue the youngest slot
    p_replica_loss: float = 0.0      # evict + re-queue a random slot
    p_suspend: float = 0.0           # drain + snapshot + resume
    max_faults: int = 1 << 30

    def __post_init__(self):
        if self.p_preempt + self.p_replica_loss + self.p_suspend > 1.0:
            raise ValueError("fault probabilities must sum to <= 1")


class FaultInjector:
    """Drives a ``FaultPlan``, one roll per tick.

    Attach as a serving-engine observer: ``on_step`` preempts or
    suspends slots.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.RandomState(plan.seed)
        self.injected = {"preempt": 0, "replica_loss": 0, "suspend": 0}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def next_fault(self):
        """Roll this tick's fault dice WITHOUT touching an engine.

        Returns ``(kind, pick)`` where ``kind`` is ``"preempt"`` /
        ``"replica_loss"`` / ``"suspend"`` / ``None`` and ``pick`` a
        second uniform draw for victim selection.  ALWAYS consumes
        exactly two draws, whether or not a fault lands — the fault
        schedule stays a pure function of the tick index, independent
        of consumer state, so a seeded plan replays the same fault
        timeline into any consumer.
        """
        p = self.plan
        u, pick = self.rng.rand(), self.rng.rand()
        if self.total_injected >= p.max_faults:
            return None, pick
        if u >= p.p_preempt + p.p_replica_loss + p.p_suspend:
            return None, pick
        if u < p.p_preempt:
            return "preempt", pick
        if u < p.p_preempt + p.p_replica_loss:
            return "replica_loss", pick
        return "suspend", pick

    def on_step(self, engine):
        kind, pick = self.next_fault()
        if kind is None:
            return
        active = engine.active_slots()
        if kind == "preempt":
            if len(active) >= 1:
                engine.preempt_slot(active[-1], kind="injected_preempt")
                self.injected["preempt"] += 1
        elif kind == "replica_loss":
            if len(active) >= 1:
                slot = active[int(pick * len(active)) % len(active)]
                engine.preempt_slot(slot, kind="replica_loss")
                self.injected["replica_loss"] += 1
        else:
            if len(active) >= 1 or engine.queue_depth:
                engine.resume(engine.suspend())
                self.injected["suspend"] += 1
