"""Continuous-batching serving engine.

The port of ``repro.serving.engine.ServingEngine`` on one card.  One
engine owns a fixed pool of request slots (the decode batch) and a
``PagedKVCache``:

  prefill : B=1, right-padded prompt of ``prefill_len`` tokens -> the
            first token (sampled from the logits at the true last prompt
            position) + the prompt's KV; a recurrent family (mamba,
            xLSTM, RWKV blocks) prefills at the prompt's exact length,
            since padding would fold into its state, and returns its
            state too
  insert  : splice that KV into the pages mapped for a free slot, and
            the state into the slot's rows of the slot-major state
  decode  : ONE step for ALL slots — per-slot positions, block table and
            compacted page lists — whose attention runs the paged-decode
            kernel (``attn_kernel="fused"``) or gathers the full block
            table (``"reference"``)
  verify  : (``spec_k > 0``) the speculative sibling of decode: scores
            K1 = spec_k + 1 positions per slot in one batched forward
            (the last committed token + spec_k drafts of the n-gram
            drafter, ``serving.draft``), writes KV for all of them,
            accepts the longest draft prefix the sampled tokens confirm
            plus the correction token, and rolls the rejected tail's
            pages back.  Greedy spec decoding commits the ``spec_k=0``
            tokens; only the number of forwards changes.  A recurrent
            state cannot roll a rejected draft back, so those families
            serve with ``spec_k=0`` whatever ``EngineConfig.spec_k``
            says, as in the reference.

The engine is a dispatch/commit pipeline (``EngineConfig.async_depth``).
``dispatch()`` admits what fits and LAUNCHES one batched step without
waiting for its tokens: the sampled tokens and their logit margins are
copied to host buffers of the step's own (pinned on CUDA) by
non-blocking copies, and a CUDA event is recorded after them.
``commit()`` waits on the oldest step's event — the only host sync of
the decode hot path — and applies its bookkeeping.  ``async_depth=0``
commits every dispatch at once (the synchronous loop);
``async_depth=d`` keeps up to ``d`` steps in flight, so the host
schedules step t+1 while the card runs step t.  The token feed of step
t+1 is step t's sampled-token DEVICE tensor chained back in (never a
host round trip); positions advance by one at dispatch; every host feed
(tokens to patch, positions, block table, page lists) is staged through
a fresh host buffer of its own (``staging.to_device``), so the host may
change its arrays for the next tick while a copy is still queued.  All
of it runs on the current stream of the engine's device.  On the CPU the same code runs with synchronous
copies and no events.

Retirement the host can predict (token budget, context end) applies at
dispatch, so a finished slot is never scheduled again; EOS shows only at
commit, one step late under overlap: the already-dispatched step's
token for that slot is discarded (the slot OBJECT, not the index, ties
a step's outputs to requests) and the pages it touched return through
the allocator's deferred-free epochs (``SlotAllocator.note_dispatch`` /
``note_commit``), never to a step still in flight.  Admission prefills
run between decode dispatches and never sync: the first token stays a
device tensor that the next decode feed patches in, and its value
(copied like a step's) folds into host bookkeeping at the slot's first
commit.  With the n-gram drafter the host needs step t's tokens to
draft step t+1, so a verify dispatch first joins the pipeline; what
overlaps is admission against the in-flight verify step.

Faults: when a live slot cannot map its next page (``PagePoolExhausted``)
and ``preempt`` is on, the engine first drains the pipeline (limbo
pages rejoin the pool at commit), then evicts and re-queues the
youngest slot of the starving group (``preempt_slot(kind=
"pool_pressure")``), which restarts from scratch: greedy streams do not
change.  ``preempt_slot`` serves fault injectors (``serving.slo.
FaultInjector``: ``"injected_preempt"``, ``"replica_loss"``), and
``suspend`` / ``resume`` drain the engine, snapshot every request
(mid-generation ones with their committed tokens, re-prefilled as part
of the prompt) and re-admit them.  Objects in ``engine.observers`` get
``on_submit`` / ``on_admit`` / ``on_first_token`` / ``on_finish`` /
``on_preempt`` / ``on_suspend`` calls (``serving.slo.SLOMonitor``).

Sampling (``serving.sampling``): per-request ``temperature`` (0 =
greedy) with the engine's ``top_k`` and ``top_p``.  The noise comes
from one ``torch.Generator`` of the engine's device, reseeded from
``seed`` and a tick before every prefill and step (as the reference
folds the tick into its key), so sampled streams repeat for a fixed
schedule.

Per-slot computation is batch-independent — no reduction mixes slots,
int8 scales are per token — so a slot's greedy stream does not depend
on which requests share the batch, nor on ``async_depth``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import model as M
from ..models.context import make_context
from . import sampling
from .draft import NGramDrafter
from .errors import (CacheOverflowError, EngineConfigError,
                     PagePoolExhausted, SchedulerStall, SlotsExhausted)
from .kv_cache import PagedKVCache, default_num_pages
from .staging import HostCopy, to_device

__all__ = ["CacheOverflowError", "EngineConfig", "EngineConfigError",
           "PagePoolExhausted", "Request", "SchedulerStall",
           "ServingEngine", "SlotsExhausted", "WARMUP_RID",
           "resolve_device"]


#: Reserved request id of ``warmup``'s throwaway request: a fresh
#: ``object()`` equals only itself, so no user rid can collide with it.
WARMUP_RID = object()


@dataclasses.dataclass
class Request:
    """One generation request."""

    rid: int
    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's engine knobs.  The port honours ``num_slots``,
    ``max_seq``, ``prefill_len`` (0 -> ``max_seq``), ``page_size``,
    ``num_pages`` (0 -> every slot can map ``max_seq``), ``top_k``,
    ``top_p``, ``eos_id``, ``seed``, ``spec_k`` with ``drafter="ngram"``,
    ``async_depth``, ``preempt`` and ``attn_kernel``; every other field
    set away from its default (``drafter="heads"``, ``disagg`` among
    them) raises ``EngineConfigError``."""

    num_slots: int = 4
    max_seq: int = 128
    prefill_len: int = 0
    page_size: int = 64
    num_pages: int = 0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: Optional[int] = None
    replicate_weights: bool = False
    seed: int = 0
    spec_k: int = 0
    drafter: str = "ngram"
    async_depth: int = 0
    preempt: bool = True
    attn_kernel: str = "fused"
    disagg: bool = False
    prefill_groups: int = 1
    kv_wire: str = "fp"
    router: str = "load"


_HONOURED = ("num_slots", "max_seq", "prefill_len", "page_size",
             "num_pages", "top_k", "top_p", "eos_id", "seed", "spec_k",
             "drafter", "async_depth", "preempt", "attn_kernel")


@dataclasses.dataclass
class _Slot:
    req: Request
    out: list
    #: top-1/top-2 logit margin of each token in ``out``
    margins: list = dataclasses.field(default_factory=list)
    #: the n-gram drafter over the committed stream (``spec_k > 0``),
    #: created when the first token folds
    drafter: Optional[NGramDrafter] = None
    #: dispatched, uncommitted steps this slot takes part in
    inflight: int = 0
    #: scheduled for future dispatches; False once the host knows (or can
    #: predict) the request is finished
    live: bool = True
    #: admission order — preemption picks victims youngest-first
    seq: int = 0
    #: the admit prefill's first token and margin, copying to the host
    #: (their device tensors feed the next decode step); None once folded
    pending_first: Optional[HostCopy] = None


@dataclasses.dataclass
class _Resume:
    """Queue entry of a suspended mid-generation request: re-admitted
    with its committed tokens as part of the prompt (work-preserving),
    its slot's ``out`` and ``margins`` seeded with them."""

    req: Request
    prior: list
    prior_margins: list

    @property
    def rid(self):
        return self.req.rid


@dataclasses.dataclass
class _InFlight:
    """One dispatched, not yet committed batched step."""

    kind: str                     # "decode" | "verify"
    #: (slot index, _Slot) pairs scheduled at dispatch: the OBJECT ties
    #: the step's outputs to requests, so a slot retired or re-admitted
    #: before the commit drops its column
    entries: list
    #: the sampled tokens [B] or [B, K1] and their margins, copying to
    #: host buffers of this step's own
    result: HostCopy
    drafts: Optional[np.ndarray] = None       # [B, spec_k] (verify)


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; a CUDA device without a
    card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ServingEngine:
    """Batched continuous-batching decode over a slot pool.

    For every finished request it also keeps the gap between the top two
    logits each of its tokens was chosen from (``self.margins[rid]``,
    aligned with the tokens): two runs whose float arithmetic differs
    may only disagree where that gap is tiny, and the margins let a
    caller check exactly that.
    """

    def __init__(self, cfg, params, ecfg: EngineConfig = EngineConfig(), *,
                 device=None):
        default = EngineConfig()
        for f in dataclasses.fields(EngineConfig):
            if (f.name not in _HONOURED
                    and getattr(ecfg, f.name) != getattr(default, f.name)):
                raise EngineConfigError(
                    f"EngineConfig.{f.name}={getattr(ecfg, f.name)!r}: not "
                    "ported yet")
        if cfg.is_encdec:
            raise EngineConfigError("encoder-decoder serving: not ported")
        if any(k not in M.BLOCK_KINDS for k in cfg.pattern):
            raise EngineConfigError(
                f"pattern {cfg.pattern}: block kinds "
                f"{sorted(set(cfg.pattern) - set(M.BLOCK_KINDS))} are not "
                "ported")
        if ecfg.page_size < 1:
            raise EngineConfigError(f"page_size={ecfg.page_size} must be "
                                    ">= 1")
        if ecfg.attn_kernel not in ("fused", "reference"):
            raise EngineConfigError(
                f"attn_kernel={ecfg.attn_kernel!r}: expected 'fused' or "
                "'reference'")
        if ecfg.spec_k < 0:
            raise EngineConfigError(f"spec_k={ecfg.spec_k} must be >= 0")
        if ecfg.async_depth < 0:
            raise EngineConfigError(
                f"async_depth={ecfg.async_depth} must be >= 0")
        if ecfg.drafter != "ngram":
            raise EngineConfigError(
                f"drafter={ecfg.drafter!r}: only 'ngram' is ported (the "
                "learned draft heads are not)")
        if ecfg.top_k < 0 or not 0.0 <= ecfg.top_p <= 1.0:
            raise EngineConfigError(
                f"top_k={ecfg.top_k}, top_p={ecfg.top_p}: expected "
                "top_k >= 0 and 0 <= top_p <= 1")
        self.device = resolve_device(device)
        leaf = params["embed"]
        if leaf.device != self.device:
            raise ValueError(f"params lie on {leaf.device}, the engine runs "
                             f"on {self.device}")
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.async_depth = ecfg.async_depth
        self.ctx = make_context(cfg)
        self._scfg = sampling.SamplingConfig(top_k=ecfg.top_k,
                                             top_p=ecfg.top_p)
        self._gen = torch.Generator(device=self.device)
        self._tick = 0
        self.prefill_len = ecfg.prefill_len or ecfg.max_seq
        self.num_pages = ecfg.num_pages or default_num_pages(
            ecfg.num_slots, ecfg.max_seq, ecfg.page_size)
        self.cache = PagedKVCache(cfg, num_slots=ecfg.num_slots,
                                  max_seq=ecfg.max_seq,
                                  page_size=ecfg.page_size,
                                  num_pages=self.num_pages,
                                  device=self.device)
        self._has_state = any(k in M.STATE_KEYS
                              for pos in self.cache.buffers.values()
                              for k in pos)
        # a recurrent state folds every token in and cannot roll back a
        # rejected draft: those families serve vanilla (spec_k=0)
        self.spec_k = 0 if self._has_state else ecfg.spec_k
        #: the sequence-sharding granularity of an exact-length prefill
        #: (the reference's tp_size; 1 at world size 1)
        self.tp_size = 1
        n = ecfg.num_slots
        self._tokens = np.zeros(n, np.int32)       # host token shadow
        self._pos = np.zeros(n, np.int32)          # dispatch-side positions
        self._temp = np.zeros(n, np.float32)
        self._slots: list[Optional[_Slot]] = [None] * n
        self._queue: deque = deque()
        self._retired: list = []
        self._inflight: deque[_InFlight] = deque()
        #: the last decode dispatch's sampled tokens (device [B]): the
        #: next decode feed, with the slots below patched in
        self._tok_dev: Optional[torch.Tensor] = None
        #: slots whose next feed token comes from the host shadow (their
        #: first token folded to the host before a feed consumed it)
        self._tok_dirty: set = set()
        #: slot -> the admit prefill's first token (device [1]), patched
        #: into the next decode feed
        self._tok_pending: dict = {}
        self._admit_seq = 0
        self.margins: dict = {}
        self.observers: list = []
        self.tokens_generated = 0
        self.decode_steps = 0      # decode and verify steps committed
        self.prefills = 0
        self.preemptions = 0       # pool pressure and injected faults
        self.suspends = 0
        self.spec_commits = 0      # tokens committed by verify steps
        self.spec_verifies = 0     # (slot, verify-step) participations

    # -- request lifecycle -------------------------------------------------

    def submit(self, req: Request):
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (admit always "
                             "samples one token from the prefill logits)")
        P_len = len(req.prompt)
        if not 0 < P_len <= self.prefill_len:
            raise ValueError(
                f"prompt len {P_len} not in (0, {self.prefill_len}]")
        if self._has_state and P_len % self.tp_size != 0:
            raise ValueError(
                "recurrent-state families prefill exact-length buckets: "
                f"prompt len {P_len} must be a multiple of tp_size "
                f"({self.tp_size})")
        alloc = self.cache.allocator
        if alloc.pages_needed(P_len) > alloc.pages_per_group:
            raise ValueError(
                f"prompt needs {alloc.pages_needed(P_len)} KV pages but the "
                f"pool only holds {alloc.pages_per_group} "
                f"(num_pages={self.num_pages}): it could never be admitted")
        self._queue.append(req)
        self._emit("on_submit", req.rid, P_len)

    def _emit(self, event: str, *args):
        for obs in self.observers:
            fn = getattr(obs, event, None)
            if fn is not None:
                fn(*args)

    def _stage(self, arr) -> torch.Tensor:
        """A device copy of host feed ``arr`` through a host buffer of
        its own."""
        return to_device(arr, self.device)

    def _next_generator(self) -> torch.Generator:
        """The engine's generator, reseeded from ``seed`` and the next
        tick (the reference's ``fold_in(key, tick)``); every prefill and
        step takes one tick, whether or not it samples."""
        self._tick += 1
        return self._gen.manual_seed(
            (self.ecfg.seed * 0x9E3779B97F4A7C15 + self._tick) % 2**64)

    @staticmethod
    def _margin(logits):
        """Top-1 minus top-2 logit per row (on the device)."""
        top = torch.topk(logits.to(torch.float32), 2, dim=-1).values
        return top[..., 0] - top[..., 1]

    @staticmethod
    def _entry_parts(entry):
        """(request, prior tokens, their margins, prefill prompt) of a
        queue entry — a ``Request`` or a suspend-time ``_Resume``."""
        if isinstance(entry, _Resume):
            return (entry.req, entry.prior, entry.prior_margins,
                    list(entry.req.prompt) + list(entry.prior))
        return entry, [], [], list(entry.prompt)

    @torch.no_grad()
    def _admit(self, entry):
        """Prefill a queue entry into a free slot, with no host sync: the
        first token stays a device tensor for the next decode feed, and
        its value copies to the host for the slot's first commit."""
        req, prior, prior_margins, prompt = self._entry_parts(entry)
        P_len = len(prompt)
        # a recurrent family folds every position into its state, so it
        # prefills the prompt at its exact length (nothing compiles per
        # length here: no bucket cache); attention families right-pad
        toks = np.zeros((1, P_len if self._has_state else self.prefill_len),
                        np.int32)
        toks[0, :P_len] = np.asarray(prompt, np.int32)
        logits, pre_cache = M.forward_prefill(
            self.params, self._stage(toks), self.ctx,
            last_pos=self._stage(np.array([P_len - 1], np.int64)))
        first = sampling.sample(logits, [req.temperature],
                                self._next_generator(), self._scfg)
        self.prefills += 1
        slot = self.cache.admit(pre_cache, P_len)
        st = _Slot(req, list(prior), list(prior_margins),
                   seq=self._admit_seq,
                   pending_first=HostCopy(first, self._margin(logits)))
        self._admit_seq += 1
        self._slots[slot] = st
        self._pos[slot] = P_len
        self._temp[slot] = req.temperature
        self._tok_dirty.discard(slot)
        self._tok_pending[slot] = first
        self.tokens_generated += 1
        self._emit("on_admit", req.rid, slot)
        # retirement the host can predict without the token's value
        if (self._n_committed(st) >= req.max_new_tokens
                or self._committed_pos(st) >= self.ecfg.max_seq):
            st.live = False

    def _n_committed(self, st: _Slot) -> int:
        """Tokens generated as far as the host knows: the committed
        ``out`` and the pending first token."""
        return len(st.out) + (1 if st.pending_first is not None else 0)

    def _committed_pos(self, st: _Slot) -> int:
        """The slot's committed cache occupancy / next write position
        (``self._pos`` runs ahead of it under overlap)."""
        return len(st.req.prompt) + self._n_committed(st) - 1

    def _fold_first(self, slot: int, st: _Slot) -> bool:
        """Fold the pending first token into host bookkeeping (its copy
        has run by every call site).  Returns True iff the slot is still
        occupied by ``st`` afterwards."""
        if st.pending_first is None:
            return self._slots[slot] is st
        first, margin = st.pending_first.numpy()
        st.pending_first = None
        first = int(first[0])
        st.out.append(first)
        st.margins.append(float(margin[0]))
        self._tokens[slot] = first
        if self._tok_pending.pop(slot, None) is not None:
            # no feed consumed the device value: the next feed takes it
            # from the host shadow
            self._tok_dirty.add(slot)
        if self.spec_k > 0 and st.drafter is None:
            st.drafter = NGramDrafter(list(st.req.prompt) + st.out)
        self._emit("on_first_token", st.req.rid)
        self._maybe_retire(slot, first)
        return self._slots[slot] is st

    def _fold_pending(self):
        """Fold every slot's pending first token."""
        for i, st in enumerate(self._slots):
            if st is not None and st.pending_first is not None:
                self._fold_first(i, st)

    def _maybe_retire(self, slot: int, tok: int):
        st = self._slots[slot]
        done = (len(st.out) >= st.req.max_new_tokens
                or (self.ecfg.eos_id is not None and tok == self.ecfg.eos_id)
                or self._committed_pos(st) >= self.ecfg.max_seq)
        if done:
            # evict turns the slot's block-table row to -1, so the stale
            # pos/token the free row still carries into the next batched
            # step can only produce dropped writes; under overlap its
            # pages wait in limbo until every dispatched step committed
            st.live = False
            self.cache.evict(slot)
            self._slots[slot] = None
            self._retired.append((st.req, st.out))
            self.margins[st.req.rid] = st.margins
            self._emit("on_finish", st.req.rid, len(st.out))

    # -- scheduling --------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return (not self._queue and self.num_active == 0
                and not self._inflight)

    def slot_progress(self) -> list:
        """Per slot, ``(rid, index in its stream of the token the next
        dispatched step produces)`` — a verify step's row j produces the
        token after that, if the drafts before it are accepted — or None
        for a slot the next step does not schedule (free, or finished
        but not yet retired)."""
        return [None if st is None or not st.live
                else (st.req.rid, self._n_committed(st) + st.inflight)
                for st in self._slots]

    def _live_slots(self) -> list:
        return [i for i, s in enumerate(self._slots)
                if s is not None and s.live]

    def active_slots(self) -> list:
        """Occupied slots, oldest admission first — the fault injector's
        victim menu (``[-1]`` is the youngest)."""
        return sorted((i for i, s in enumerate(self._slots) if s is not None),
                      key=lambda i: self._slots[i].seq)

    def _can_admit_next(self) -> bool:
        """Limbo-aware admission gate for the queue head: pages still in
        limbo count as taken, so an admission never claims pages the
        pipeline owes to growing slots."""
        prompt = self._entry_parts(self._queue[0])[3]
        return self.cache.allocator.can_admit(len(prompt))

    # -- faults ------------------------------------------------------------

    def preempt_slot(self, slot: int, kind: str = "preempt"):
        """Evict ``slot`` and re-queue its request at the front, to
        restart from scratch on re-admit (greedy streams do not change).
        Safe mid-pipeline: freed pages wait in limbo, and an in-flight
        step's column for the slot is dropped at commit.  ``kind``
        (``"pool_pressure"``, ``"injected_preempt"``, ``"replica_loss"``)
        reaches the ``on_preempt`` observers."""
        st = self._slots[slot]
        if st is None:
            raise ValueError(f"preempt_slot: slot {slot} is free")
        st.live = False
        self.cache.evict(slot)
        self._slots[slot] = None
        self._tok_pending.pop(slot, None)
        self._tok_dirty.discard(slot)
        self.preemptions += 1
        self._queue.appendleft(st.req)
        self._emit("on_preempt", st.req.rid, kind)

    def _suspend_entry(self, st: _Slot):
        """A ``_Resume`` carrying ``st``'s committed tokens when prompt
        plus tokens still fit the prefill window and a pool group, else
        the plain request (restart from scratch)."""
        if st.out:
            L = len(st.req.prompt) + len(st.out)
            alloc = self.cache.allocator
            if (L <= self.prefill_len
                    and alloc.pages_needed(L) <= alloc.pages_per_group):
                return _Resume(st.req, list(st.out), list(st.margins))
        return st.req

    def suspend(self) -> list:
        """Simulated host preemption: drain the pipeline, snapshot every
        pending request and release every slot and page.  Returns the
        entries still owed output — mid-generation slots in admission
        order (work-preserving ``_Resume`` entries where they fit), then
        the untouched queue — for ``resume``."""
        self.flush()
        self._fold_pending()
        entries = []
        for i in self.active_slots():
            st = self._slots[i]
            self.cache.evict(i)
            self._slots[i] = None
            entries.append(self._suspend_entry(st))
        self._emit("on_suspend", [e.rid for e in entries])
        self._tok_pending.clear()
        self._tok_dirty.clear()
        self._tok_dev = None
        entries.extend(self._queue)
        self._queue.clear()
        self.suspends += 1
        return entries

    def resume(self, entries: Sequence):
        """Re-queue ``suspend``'s snapshot at the front, in its order."""
        for e in reversed(list(entries)):
            self._queue.appendleft(e)

    # -- the pipeline ------------------------------------------------------

    def step(self) -> list:
        """One scheduler tick: dispatch one step, then commit down to
        ``async_depth`` steps in flight (all of them when nothing was
        dispatched, so the engine always reaches ``idle``).  Returns the
        requests finished this tick as (request, tokens) pairs."""
        dispatched = self.dispatch()
        target = self.async_depth if dispatched else 0
        while len(self._inflight) > target:
            self.commit()
        out, self._retired = self._retired, []
        return out

    def dispatch(self) -> bool:
        """Admit what fits, then launch one batched decode (or verify)
        step without waiting for it.  Returns True iff a step was
        launched."""
        while self._queue and self._can_admit_next():
            self._admit(self._queue.popleft())
        if self.spec_k > 0:
            # drafting reads committed tokens: join the pipeline, then
            # fold every pending first token
            self.flush()
            self._fold_pending()
            live = self._live_slots()
            return bool(live) and self._dispatch_verify(live)
        # slots retired by prediction at admit are never scheduled, so no
        # commit folds their first token: fold it here
        for i, st in enumerate(self._slots):
            if (st is not None and not st.live
                    and st.pending_first is not None):
                self._fold_first(i, st)
        live = self._live_slots()
        return bool(live) and self._dispatch_decode(live)

    def commit(self):
        """Join the OLDEST in-flight step — wait on its event — and apply
        its bookkeeping."""
        if not self._inflight:
            raise ValueError("commit: no dispatched step in flight")
        rec = self._inflight.popleft()
        out, margin = rec.result.numpy()
        self.cache.allocator.note_commit()
        self.decode_steps += 1
        if rec.kind == "verify":
            self._commit_verify(rec, out, margin)
        else:
            self._commit_decode(rec, out, margin)

    def flush(self):
        """Commit every in-flight step."""
        while self._inflight:
            self.commit()

    def _ensure_for_step(self, live, need):
        """Map the pages every live slot writes next (``need(slot)`` is
        the occupancy the step must cover).  On ``PagePoolExhausted`` with
        ``preempt`` on: drain the pipeline (limbo pages rejoin the pool),
        and if the group is still dry, preempt its youngest slot and
        retry; a group with one live slot lets the typed error out.
        Returns the (possibly shrunk) live list."""
        alloc = self.cache.allocator
        while True:
            try:
                for i in live:
                    self.cache.ensure(i, need(i))
                return live
            except PagePoolExhausted:
                if not self.ecfg.preempt:
                    raise
                starving = i
            if self._inflight:
                self.flush()
                live = [j for j in live if self._slots[j] is not None
                        and self._slots[j].live]
                continue
            grp = alloc.group_of(starving)
            victims = [j for j in live if alloc.group_of(j) == grp]
            if len(victims) < 2:
                for i in live:
                    self.cache.ensure(i, need(i))
                return live
            victim = max(victims, key=lambda j: self._slots[j].seq)
            self.preempt_slot(victim, kind="pool_pressure")
            live = [j for j in live if j != victim]

    def _step_aux(self):
        """The block table and, on the kernel walk, the compacted page
        lists, staged for one step."""
        aux = {"block_table": self._stage(self.cache.block_table)}
        if self.ecfg.attn_kernel == "fused":
            aux["page_list"] = (self._stage(self.cache.page_list_loc),
                                self._stage(self.cache.page_list_pos))
        return aux

    def _token_feed(self):
        """The next decode step's token feed: the last decode step's
        device tokens, with host-folded slots (``_tok_dirty``) taken from
        the host shadow and freshly admitted ones (``_tok_pending``) from
        their prefill's device token.  Other slots keep what the device
        tensor carries: free rows write nothing."""
        if self._tok_dev is None:
            self._tok_dirty.clear()
            feed = self._stage(self._tokens)
        else:
            feed = self._tok_dev
            if self._tok_dirty:
                mask = np.zeros(len(self._tokens), bool)
                mask[sorted(self._tok_dirty)] = True
                feed = torch.where(self._stage(mask),
                                   self._stage(self._tokens), feed)
                self._tok_dirty.clear()
        if self._tok_pending:
            feed = feed.clone()
            for s in sorted(self._tok_pending):
                feed[s] = self._tok_pending[s][0]
            self._tok_pending.clear()
        return feed

    def _launch(self, kind, live, out, margin, drafts=None):
        """Record a launched step: start its results' copies to the host
        and queue it for commit."""
        self.cache.allocator.note_dispatch()
        self._inflight.append(_InFlight(
            kind, [(i, self._slots[i]) for i in live],
            HostCopy(out, margin), drafts))
        for i in live:
            self._slots[i].inflight += 1

    @torch.no_grad()
    def _dispatch_decode(self, live) -> bool:
        # the step writes KV at position pos: map its page first (a slot
        # finished at a still-uncommitted step gets its page back
        # through limbo at that step's commit)
        live = self._ensure_for_step(live, lambda i: int(self._pos[i]) + 1)
        if not live:
            return False
        tok = self._token_feed()
        logits, self.cache.buffers = M.forward_decode(
            self.params, self.cache.buffers, tok,
            self._stage(self._pos), self.ctx,
            aux_extra=self._step_aux())
        out = sampling.sample(logits, self._temp, self._next_generator(),
                              self._scfg)
        self._tok_dev = out
        self._launch("decode", live, out, self._margin(logits))
        for i in live:
            st = self._slots[i]
            self._pos[i] += 1
            # predictable retirement applies at dispatch; EOS shows at
            # commit, and the next step's column is then a zombie
            if (self._n_committed(st) + st.inflight >= st.req.max_new_tokens
                    or int(self._pos[i]) >= self.ecfg.max_seq):
                st.live = False
        return True

    @torch.no_grad()
    def _dispatch_verify(self, live) -> bool:
        """Launch one speculative step: draft spec_k tokens per slot and
        score all K1 = spec_k + 1 positions in one batched forward;
        acceptance happens at commit.  Under greedy sampling a draft is
        accepted only where it equals the argmax a vanilla step would
        take, so the committed stream is the ``spec_k=0`` stream."""
        k = self.spec_k
        # the step writes KV at pos..pos+k (clipped at the context end):
        # map those pages first; the rejected tail's roll back at commit
        live = self._ensure_for_step(
            live, lambda i: min(int(self._pos[i]) + k + 1,
                                self.ecfg.max_seq))
        if not live:
            return False
        drafts = np.zeros((self.ecfg.num_slots, k), np.int32)
        for i in live:
            drafts[i] = self._slots[i].drafter.propose(k)
        feed = np.concatenate([self._tokens[:, None], drafts], axis=1)
        self._tok_dirty.clear()      # the feed read every host token
        logits, self.cache.buffers = M.forward_verify(
            self.params, self.cache.buffers, self._stage(feed),
            self._stage(self._pos), self.ctx,
            aux_extra=self._step_aux())
        out = sampling.sample_verify(logits, self._temp,
                                     self._next_generator(), self._scfg)
        self._launch("verify", live, out, self._margin(logits), drafts)
        return True

    def _commit_decode(self, rec: _InFlight, out, margin):
        for i, st in rec.entries:
            if self._slots[i] is not st:
                continue     # retired (late EOS), preempted or re-admitted
                #              since the dispatch: a zombie column
            st.inflight -= 1
            if not self._fold_first(i, st):
                continue     # the first token was EOS: the column is a
                #              zombie whose write landed beyond occupancy
            tok = int(out[i])
            st.out.append(tok)
            st.margins.append(float(margin[i]))
            self._tokens[i] = tok
            self.tokens_generated += 1
            self._maybe_retire(i, tok)

    def _commit_verify(self, rec: _InFlight, out, margin):
        """Accept the longest draft prefix the sampled tokens confirm
        plus the correction token; roll the rejected tail back."""
        k = self.spec_k
        max_seq = self.ecfg.max_seq
        eos = self.ecfg.eos_id
        for i, st in rec.entries:
            if self._slots[i] is not st:
                continue
            st.inflight -= 1
            a = 0
            while a < k and rec.drafts[i, a] == out[i, a]:
                a += 1
            committed = 0
            for j in range(a + 1):              # accepted drafts + fixup
                tok = int(out[i, j])
                st.out.append(tok)
                st.margins.append(float(margin[i, j]))
                st.drafter.extend([tok])
                self._tokens[i] = tok
                self._pos[i] += 1
                self.tokens_generated += 1
                committed += 1
                if (len(st.out) >= st.req.max_new_tokens
                        or (eos is not None and tok == eos)
                        or self._pos[i] >= max_seq):
                    break
            self.cache.rollback(i, int(self._pos[i]))
            self.spec_commits += committed
            self.spec_verifies += 1
            self._maybe_retire(i, int(self._tokens[i]))

    def mean_accepted_len(self) -> float:
        """Mean tokens committed per (slot, verify step): above 1 the
        drafter pays for itself."""
        return self.spec_commits / max(self.spec_verifies, 1)

    def run(self, requests: Sequence[Request], max_steps: int = 100000,
            on_step=None):
        """Serve ``requests`` to completion; {rid: generated tokens}.
        ``on_step(self)`` (optional) runs after every tick."""
        for r in requests:
            self.submit(r)
        results = {}
        for _ in range(max_steps):
            for req, out in self.step():
                results[req.rid] = out
            if on_step is not None:
                on_step(self)
            if self.idle:
                break
        if not self.idle:
            raise SchedulerStall(
                f"run: {self.num_active} slots still active, "
                f"{len(self._queue)} requests queued and "
                f"{len(self._inflight)} steps in flight after {max_steps} "
                "steps")
        return results

    def warmup(self, prompt: Sequence[int]):
        """Serve one throwaway request (``WARMUP_RID``) — first launches,
        library handles, the caching allocator — then zero the stats."""
        self.run([Request(rid=WARMUP_RID, prompt=prompt, max_new_tokens=2)])
        self.margins.pop(WARMUP_RID, None)
        self.reset_stats()

    def reset_stats(self):
        """Zero the counters, after committing every in-flight step (a
        step straddling the reset would leak its tokens into the next
        measurement; what it retires stays buffered for ``step()``)."""
        self.flush()
        self.tokens_generated = 0
        self.decode_steps = 0
        self.prefills = 0
        self.preemptions = 0
        self.suspends = 0
        self.spec_commits = 0
        self.spec_verifies = 0
