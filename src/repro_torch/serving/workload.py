"""Trace-driven serving workloads: seeded, replayable request traces.

The port's copy of ``repro.serving.workload`` (numpy only): the same
seed gives the reference's trace, field for field, built from the port's
``Request``.

A serving benchmark is only as honest as its arrival process.  Uniform
back-to-back requests hide every queueing effect that matters in
production — TTFT blowups under bursts, pool-pressure preemption, queue
growth during on/off tenant storms — so this module generates *traces*:
timestamped ``Request`` streams drawn from a mix of request classes,
fully determined by a seed (same seed, same trace, bit-for-bit), that
``replay`` feeds into a ``ServingEngine`` on a logical or wall clock.

Building blocks
---------------
``RequestClass``
    One tenant/workload type: an arrival process (``poisson`` — memory-
    less gaps at ``rate`` req/s — or ``onoff`` — exponential on/off
    phases; arrivals only while on, which is what makes a trace bursty),
    a prompt-length distribution with an optional long-context tail
    (``tail_p``/``tail_len`` model the retrieval-augmented minority that
    dominates KV-pool pressure), a generation-length range, and a
    sampling temperature.
``make_trace``
    Merge the per-class arrival streams over a horizon into one
    time-sorted ``Trace``.  Request ids encode the class (``"t2/chat/7"``
    = trace seed namespace, class, per-class index) so per-tenant SLOs
    can be split out of one run.
``zoo_mix`` / ``PRESETS``
    Canned multi-tenant mixes whose shape statistics follow the
    ``repro.configs`` zoo families: short chat turns (qwen-0.5b-style
    interactive), mid-length completion (gemma2/granite), long-context
    retrieval tails (jamba-style hybrids are why the tail knob exists),
    and a bursty on/off batch tenant.  All lengths scale to the
    engine's ``prefill_len``/``gen`` budget at trace-build time.
``replay``
    Drive an engine through a trace: submit every request whose arrival
    time has passed, tick the engine, notify observers/injectors.  The
    default clock is *logical* (``steps_per_s`` scheduler ticks per
    trace second — deterministic, so fault-injection tests replay
    exactly); ``wall=True`` uses the host clock instead (what the
    benches report).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .engine import Request

__all__ = ["PRESETS", "RequestClass", "Trace", "TracedRequest",
           "make_trace", "preset_trace", "replay", "zoo_mix"]


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One tenant's traffic model (all randomness comes from the trace
    seed — a class is pure data and safely shared between traces)."""

    name: str
    rate: float                      # mean arrivals per second while on
    arrival: str = "poisson"         # "poisson" | "onoff"
    on_s: float = 1.0                # mean on-phase length (onoff only)
    off_s: float = 1.0               # mean off-phase length (onoff only)
    prompt_len: Tuple[int, int] = (4, 16)     # uniform [lo, hi]
    tail_p: float = 0.0              # long-context tail probability
    tail_len: Tuple[int, int] = (16, 16)      # tail prompt range
    gen_len: Tuple[int, int] = (4, 16)        # uniform [lo, hi]
    temperature: float = 0.0
    distinct_tokens: bool = False    # draw each prompt WITHOUT
    #                                  replacement: no token (hence no
    #                                  n-gram) ever repeats inside a
    #                                  prompt, so prompt-lookup drafting
    #                                  has nothing to match — the
    #                                  workload where a learned drafter
    #                                  must carry speculation alone

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"class {self.name}: rate must be > 0")
        if self.arrival not in ("poisson", "onoff"):
            raise ValueError(f"class {self.name}: arrival {self.arrival}")
        for lo, hi in (self.prompt_len, self.tail_len, self.gen_len):
            if not 0 < lo <= hi:
                raise ValueError(f"class {self.name}: bad range {(lo, hi)}")
        if not 0.0 <= self.tail_p <= 1.0:
            raise ValueError(f"class {self.name}: tail_p {self.tail_p}")


@dataclasses.dataclass(frozen=True)
class TracedRequest:
    """One arrival: when it lands and what it asks for."""

    t: float                         # arrival time (s from trace start)
    cls: str                         # originating RequestClass.name
    req: Request


@dataclasses.dataclass(frozen=True)
class Trace:
    """A time-sorted, seed-determined request stream."""

    requests: Tuple[TracedRequest, ...]
    horizon_s: float
    seed: int

    def __len__(self):
        return len(self.requests)

    def by_class(self) -> dict:
        out: dict = {}
        for tr in self.requests:
            out.setdefault(tr.cls, []).append(tr)
        return out


def _arrival_times(cls: RequestClass, horizon_s: float,
                   rng: np.random.RandomState) -> List[float]:
    """Arrival timestamps for one class over [0, horizon_s)."""
    times: List[float] = []
    if cls.arrival == "poisson":
        t = rng.exponential(1.0 / cls.rate)
        while t < horizon_s:
            times.append(t)
            t += rng.exponential(1.0 / cls.rate)
        return times
    # on/off: exponential phase lengths, arrivals only while on — the
    # burst arrives at `rate` even though the long-run average is
    # rate * on/(on+off)
    t, on = 0.0, rng.rand() < cls.on_s / (cls.on_s + cls.off_s)
    while t < horizon_s:
        phase = rng.exponential(cls.on_s if on else cls.off_s)
        end = min(t + phase, horizon_s)
        if on:
            a = t + rng.exponential(1.0 / cls.rate)
            while a < end:
                times.append(a)
                a += rng.exponential(1.0 / cls.rate)
        t, on = end, not on
    return times


def make_trace(classes: Sequence[RequestClass], horizon_s: float,
               seed: int = 0, vocab: int = 256,
               max_prompt_len: Optional[int] = None,
               max_gen: Optional[int] = None,
               fixed_prompt_len: Optional[int] = None) -> Trace:
    """Merge the classes' arrival streams into one replayable trace.

    ``max_prompt_len``/``max_gen`` clamp every drawn length to the
    engine's budget (``prefill_len`` / ``max_seq - prefill_len``);
    ``fixed_prompt_len`` forces every prompt to exactly that length —
    required when serving recurrent-state families, whose prompts must
    arrive at ``prefill_len`` tokens.  Each class draws from its own
    ``fold_in``-style derived seed, so adding a class never perturbs
    the other classes' streams.
    """
    if not classes:
        raise ValueError("make_trace: need at least one RequestClass")
    out: List[TracedRequest] = []
    for ci, cls in enumerate(classes):
        rng = np.random.RandomState((seed * 1000003 + ci) % (2 ** 31 - 1))
        for j, t in enumerate(_arrival_times(cls, horizon_s, rng)):
            if fixed_prompt_len is not None:
                plen = fixed_prompt_len
            else:
                lo, hi = cls.prompt_len
                if cls.tail_p > 0 and rng.rand() < cls.tail_p:
                    lo, hi = cls.tail_len
                plen = int(rng.randint(lo, hi + 1))
                if max_prompt_len is not None:
                    plen = max(1, min(plen, max_prompt_len))
            glo, ghi = cls.gen_len
            gen = int(rng.randint(glo, ghi + 1))
            if max_gen is not None:
                gen = max(1, min(gen, max_gen))
            if cls.distinct_tokens:
                plen = min(plen, vocab)
                prompt = [int(x) for x in rng.choice(vocab, plen,
                                                     replace=False)]
            else:
                prompt = [int(x) for x in rng.randint(0, vocab, plen)]
            out.append(TracedRequest(
                t=float(t), cls=cls.name,
                req=Request(rid=f"t{seed}/{cls.name}/{j}", prompt=prompt,
                            max_new_tokens=gen,
                            temperature=cls.temperature)))
    out.sort(key=lambda tr: (tr.t, tr.req.rid))
    return Trace(requests=tuple(out), horizon_s=horizon_s, seed=seed)


def zoo_mix(prefill_len: int = 16, max_gen: int = 16,
            load: float = 8.0) -> List[RequestClass]:
    """The default multi-tenant mix, shaped after the config-zoo
    families: interactive chat (short prompts, short decodes —
    qwen1.5-0.5b-style traffic), completion (mid prompts/decodes —
    gemma2/granite-class), retrieval (long-context tail — the jamba-
    style workload that stresses the KV pool), and a bursty on/off
    batch tenant.  ``load`` is the aggregate mean arrival rate (req/s)
    split across the tenants; lengths scale to the engine budget.
    """
    p = max(prefill_len, 2)
    g = max(max_gen, 2)
    return [
        RequestClass("chat", rate=0.4 * load,
                     prompt_len=(max(1, p // 8), max(2, p // 2)),
                     gen_len=(max(1, g // 4), max(2, g // 2))),
        RequestClass("completion", rate=0.3 * load,
                     prompt_len=(max(1, p // 4), max(2, 3 * p // 4)),
                     gen_len=(max(1, g // 2), g)),
        RequestClass("retrieval", rate=0.15 * load,
                     prompt_len=(max(1, p // 2), max(2, 3 * p // 4)),
                     tail_p=0.5, tail_len=(max(1, 7 * p // 8), p),
                     gen_len=(max(1, g // 4), max(2, g // 2))),
        RequestClass("batch", rate=0.15 * load, arrival="onoff",
                     on_s=0.5, off_s=2.0,
                     prompt_len=(max(1, p // 4), p),
                     gen_len=(max(1, g // 2), g)),
    ]


#: Named workload presets: name -> (classes factory, description).
PRESETS = {
    "steady": (lambda p, g, load: [
        RequestClass("steady", rate=load,
                     prompt_len=(max(1, p // 2), p),
                     gen_len=(max(1, g // 2), g))],
        "single-tenant memoryless Poisson arrivals"),
    "bursty": (lambda p, g, load: [
        RequestClass("burst", rate=2.0 * load, arrival="onoff",
                     on_s=0.4, off_s=1.6,
                     prompt_len=(max(1, p // 2), p),
                     gen_len=(max(1, g // 2), g))],
        "on/off storms at 2x the mean rate while on"),
    "longtail": (lambda p, g, load: [
        RequestClass("body", rate=0.8 * load,
                     prompt_len=(max(1, p // 8), max(2, p // 2)),
                     gen_len=(max(1, g // 2), g)),
        RequestClass("tail", rate=0.2 * load,
                     prompt_len=(max(1, p // 2), max(2, 3 * p // 4)),
                     tail_p=0.8, tail_len=(max(1, 7 * p // 8), p),
                     gen_len=(max(1, g // 4), max(2, g // 2)))],
        "short-prompt body plus a long-context tail minority"),
    "multitenant": (zoo_mix, "chat/completion/retrieval/batch zoo mix"),
    "lowmatch": (lambda p, g, load: [
        RequestClass("lowmatch", rate=load,
                     prompt_len=(max(1, p // 2), p),
                     gen_len=(max(1, g // 2), g),
                     distinct_tokens=True)],
        "non-repetitive prompts (distinct tokens): n-gram prompt-lookup "
        "drafting degrades to repeat-last, learned draft heads do not"),
}


def preset_trace(name: str, horizon_s: float, seed: int = 0,
                 prefill_len: int = 16, max_gen: int = 16,
                 load: float = 8.0, vocab: int = 256,
                 fixed_prompt_len: Optional[int] = None) -> Trace:
    """Build a named preset's trace scaled to the engine budget."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    classes, _ = PRESETS[name]
    return make_trace(classes(prefill_len, max_gen, load), horizon_s,
                      seed=seed, vocab=vocab, max_prompt_len=prefill_len,
                      max_gen=max_gen, fixed_prompt_len=fixed_prompt_len)


def replay(engine, trace: Trace, observers: Sequence = (),
           steps_per_s: float = 50.0, wall: bool = False,
           max_steps: int = 100000) -> dict:
    """Feed ``trace`` into ``engine`` and serve it to completion.

    Requests are submitted once their arrival time has passed on the
    replay clock — logical by default (tick ``i`` is trace time
    ``i / steps_per_s``; fully deterministic, the mode every identity
    test uses), or the host wall clock with ``wall=True``.  After every
    scheduler tick each observer's ``on_step(engine)`` runs (SLO
    monitors record, fault injectors strike).  Returns ``{rid: tokens}``
    for every request in the trace.

    Observers that mutate the engine (``FaultInjector``) re-queue work;
    the loop keeps ticking until the engine drains, so a fault landing
    on the very last tick still gets re-served.
    """
    from .errors import SchedulerStall
    for obs in observers:
        if obs not in engine.observers:
            engine.observers.append(obs)
    pending = list(trace.requests)
    results: dict = {}
    t0 = time.perf_counter()
    for tick in range(max_steps):
        now = (time.perf_counter() - t0) if wall else tick / steps_per_s
        while pending and pending[0].t <= now:
            engine.submit(pending.pop(0).req)
        for req, out in engine.step():
            results[req.rid] = out
        for obs in observers:
            on_step = getattr(obs, "on_step", None)
            if on_step is not None:
                on_step(engine)
        if not pending and engine.idle:
            break
    else:
        raise SchedulerStall(
            f"replay: {len(pending)} arrivals unsubmitted, "
            f"{engine.num_active} slots active after {max_steps} ticks")
    return results
