"""Batched serving over a paged KV pool: the sync greedy slice.

``ServingEngine`` (continuous batching, block-table paging, greedy
decode through the paged-decode kernel), ``EngineConfig``, ``Request``
and the typed error family of ``serving.errors``.
"""
from .engine import (EngineConfig, Request, ServingEngine,  # noqa: F401
                     resolve_device)
from .errors import (CacheOverflowError, EngineConfigError,  # noqa: F401
                     PagePoolExhausted, SchedulerStall, SlotsExhausted)
