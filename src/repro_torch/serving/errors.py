"""Typed serving-engine error family.

Every failure mode the engine or its allocator can hit is a distinct
exception type (never a bare ``assert`` or ``RuntimeError``): asserts
vanish under ``python -O``, and callers — schedulers, admission
controllers, tests — need to tell "the configuration can never serve"
from "the pool is full right now" without string-matching messages.

Hierarchy:

  ValueError
    EngineConfigError   unserveable (mesh/shape/family) configuration
    CacheOverflowError  a slot asked to grow past ``max_seq``
  RuntimeError
    SchedulerStall      ``run`` hit ``max_steps`` with work in flight
    SlotsExhausted      no free request slot (admission backpressure)
    PagePoolExhausted   no free KV page in the slot's pool group

``SlotsExhausted`` means "queue the request"; ``PagePoolExhausted`` on
admission means the same, but raised from a mid-flight ``ensure`` it
means the operator sized ``num_pages`` below the workload's concurrent
context demand — the pool, not the slot count, is the binding limit.
With ``EngineConfig.preempt`` (the default) a mid-flight
``PagePoolExhausted`` is absorbed by graceful degradation — the engine
evicts + re-queues the youngest slot of the starving group and retries
(``engine.preemptions`` counts these) — and only escapes to the caller
when preemption could not possibly help: the starving group has a
single live slot, i.e. the pool cannot hold even one request's demand.
``preempt=False`` restores the raw typed error for schedulers that
implement their own policy.

Async serving (``EngineConfig.async_depth > 0``) shifts WHEN, not
WHETHER, these fire: pages freed by a retirement or rollback park in
the allocator's deferred-free limbo until every dispatched block-table
snapshot has committed, so under overlap an ``ensure``/admission can
hit ``PagePoolExhausted`` one step earlier than the synchronous
schedule would (the pages are coming back, just not yet safe), and an
``ensure`` may even be charged to a slot whose EOS the host has not
discovered yet.  On a pool sized for the workload neither occurs; on a
deliberately undersized pool the failure is the same typed error, at
most one pipelined step sooner.
"""
from __future__ import annotations


class EngineConfigError(ValueError):
    """Unserveable engine configuration (bad mesh/shape/family combo).

    Raised from ``ServingEngine.__init__`` instead of ``assert`` so the
    checks survive ``python -O``.
    """


class CacheOverflowError(ValueError):
    """A slot was asked to grow beyond ``max_seq`` cache positions.

    Replaces the old silent ``min(len + n, max_seq)`` clamp in
    ``SlotAllocator.extend``: a clamp hides scheduler bugs (the engine
    must retire a slot at ``max_seq``, never keep decoding into it).
    """


class SchedulerStall(RuntimeError):
    """``run`` exhausted ``max_steps`` with requests still in flight."""


class SlotsExhausted(RuntimeError):
    """No free request slot; the scheduler should queue the request."""


class PagePoolExhausted(RuntimeError):
    """No free KV page (in the requesting slot's pool group).

    Distinct from ``SlotsExhausted``: slots may be free while the page
    pool is not — that is exactly the regime block-table paging enables
    (``num_pages`` sized below ``num_slots * pages_per_slot``).
    """
