"""Batched serving over a paged KV pool.

``ServingEngine`` (continuous batching, block-table paging, decode and
speculative verify through the paged-decode kernel, greedy or sampled,
the dispatch/commit pipeline of ``async_depth``, preemption, suspend and
resume, lifecycle observers), ``EngineConfig``, ``Request`` and the
typed error family of ``serving.errors``; seeded request traces and
their replay (``serving.workload``); the SLO monitor and the fault
injector (``serving.slo``).
"""
from .engine import (WARMUP_RID, EngineConfig, Request,  # noqa: F401
                     ServingEngine, resolve_device)
from .errors import (CacheOverflowError, EngineConfigError,  # noqa: F401
                     PagePoolExhausted, SchedulerStall, SlotsExhausted)
from .kv_cache import SlotAllocator  # noqa: F401
from .slo import (FaultInjector, FaultPlan, SLOMonitor,  # noqa: F401
                  SLOTargets, StepEvent, load_trace, percentiles)
from .workload import (PRESETS, RequestClass, Trace,  # noqa: F401
                       TracedRequest, make_trace, preset_trace, replay,
                       zoo_mix)
