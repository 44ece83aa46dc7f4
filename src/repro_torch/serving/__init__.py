"""Batched serving over a paged KV pool: the synchronous slice.

``ServingEngine`` (continuous batching, block-table paging, decode and
speculative verify through the paged-decode kernel, greedy or sampled),
``EngineConfig``, ``Request`` and the typed error family of
``serving.errors``.
"""
from .engine import (EngineConfig, Request, ServingEngine,  # noqa: F401
                     resolve_device)
from .errors import (CacheOverflowError, EngineConfigError,  # noqa: F401
                     PagePoolExhausted, SchedulerStall, SlotsExhausted)
