"""Continuous-batching serving engine, synchronous slice.

The port of ``repro.serving.engine.ServingEngine`` at ``async_depth=0``
on one card.  One engine owns a fixed pool of request slots (the decode
batch) and a ``PagedKVCache``:

  prefill : B=1, right-padded prompt of ``prefill_len`` tokens -> the
            first token (sampled from the logits at the true last prompt
            position) + the prompt's KV
  insert  : splice that KV into the pages mapped for a free slot
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
            tokens; only the number of forwards changes.

Every ``step()`` admits queued requests into free slots while the slot
and page pools allow, then runs one batched decode (or verify) step and
commits it: finished requests (max tokens, EOS, or context full) retire
at once and their slot and pages return to the pool.  Before a step,
every live slot maps the pages its writes need (alloc-on-extend); when
the pool is dry and ``preempt`` is on, the youngest slot of the
starving group is evicted and re-queued (restart from scratch — greedy
streams are unchanged by it).

Sampling (``serving.sampling``): per-request ``temperature`` (0 =
greedy) with the engine's ``top_k`` and ``top_p``.  The noise comes
from one ``torch.Generator`` of the engine's device, reseeded from
``seed`` and a tick before every prefill and step (as the reference
folds the tick into its key), so the numbers a slot's row gets depend
only on the tick and the row.

The first token of an admission stays a device tensor until the step's
commit (as in the reference's deferred first-token sync), so the host
blocks once per step, on the sampled tokens.  The spec path folds it
before drafting, since the drafter reads committed tokens.  Host feeds
are staged as explicit device copies (``torch.tensor(arr,
device=...)``): the host may change its arrays for the next tick while
nothing on the device aliases them.

Per-slot computation is batch-independent — no reduction mixes slots,
int8 scales are per token — so a slot's greedy stream does not depend
on which requests share the batch.
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

__all__ = ["CacheOverflowError", "EngineConfig", "EngineConfigError",
           "PagePoolExhausted", "Request", "SchedulerStall",
           "ServingEngine", "SlotsExhausted", "resolve_device"]


@dataclasses.dataclass
class Request:
    """One generation request."""

    rid: int
    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's engine knobs.  This slice honours ``num_slots``,
    ``max_seq``, ``prefill_len`` (0 -> ``max_seq``), ``page_size``,
    ``num_pages`` (0 -> every slot can map ``max_seq``), ``top_k``,
    ``top_p``, ``eos_id``, ``seed``, ``spec_k`` with ``drafter="ngram"``,
    ``preempt`` and ``attn_kernel``; every other field set away from its
    default (``drafter="heads"`` and ``async_depth > 0`` among them)
    raises ``EngineConfigError``."""

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
             "drafter", "preempt", "attn_kernel")


@dataclasses.dataclass
class _Slot:
    req: Request
    out: list
    #: scheduled for future steps; False once the host knows (or can
    #: predict) the request is finished
    live: bool = True
    #: admission order — preemption picks victims youngest-first
    seq: int = 0
    #: the admit prefill's first token, still a device [1] tensor
    pending_first: Optional[torch.Tensor] = None
    #: top-1/top-2 logit margin of each token in ``out``, and that of
    #: the pending first token
    margins: list = dataclasses.field(default_factory=list)
    pending_margin: Optional[torch.Tensor] = None
    #: the n-gram drafter over the committed stream (``spec_k > 0``),
    #: created when the first token folds
    drafter: Optional[NGramDrafter] = None


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
                    "ported yet (this slice serves synchronous decoding)")
        if cfg.is_encdec:
            raise EngineConfigError("encoder-decoder serving: not ported")
        if any(k not in ("attn", "global", "local") for k in cfg.pattern):
            raise EngineConfigError(
                f"pattern {cfg.pattern}: only attention families are ported")
        if ecfg.page_size < 1:
            raise EngineConfigError(f"page_size={ecfg.page_size} must be "
                                    ">= 1")
        if ecfg.attn_kernel not in ("fused", "reference"):
            raise EngineConfigError(
                f"attn_kernel={ecfg.attn_kernel!r}: expected 'fused' or "
                "'reference'")
        if ecfg.spec_k < 0:
            raise EngineConfigError(f"spec_k={ecfg.spec_k} must be >= 0")
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
        n = ecfg.num_slots
        self._tokens = np.zeros(n, np.int32)
        self._pos = np.zeros(n, np.int32)
        self._temp = np.zeros(n, np.float32)
        self._slots: list[Optional[_Slot]] = [None] * n
        self._queue: deque = deque()
        self._retired: list = []
        self._admit_seq = 0
        self.margins: dict = {}
        self.tokens_generated = 0
        self.decode_steps = 0      # decode and verify steps
        self.prefills = 0
        self.preemptions = 0
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
        alloc = self.cache.allocator
        if alloc.pages_needed(P_len) > alloc.pages_per_group:
            raise ValueError(
                f"prompt needs {alloc.pages_needed(P_len)} KV pages but the "
                f"pool only holds {alloc.pages_per_group} "
                f"(num_pages={self.num_pages}): it could never be admitted")
        self._queue.append(req)

    def _stage(self, arr, dtype=None) -> torch.Tensor:
        """Explicit device copy of a host feed array."""
        return torch.tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def _next_generator(self) -> torch.Generator:
        """The engine's generator, reseeded from ``seed`` and the next
        tick (the reference's ``fold_in(key, tick)``); every prefill and
        step takes one tick, whether or not it samples."""
        self._tick += 1
        return self._gen.manual_seed(
            (self.ecfg.seed * 0x9E3779B97F4A7C15 + self._tick) % 2**64)

    @torch.no_grad()
    def _prefill(self, req: Request):
        prompt = req.prompt
        toks = np.zeros((1, self.prefill_len), np.int32)
        toks[0, :len(prompt)] = np.asarray(prompt, np.int32)
        self.prefills += 1
        logits, pre_cache = M.forward_prefill(
            self.params, self._stage(toks), self.ctx,
            last_pos=self._stage([len(prompt) - 1]))
        first = sampling.sample(logits, [req.temperature],
                                self._next_generator(), self._scfg)
        return first, self._margin(logits), pre_cache

    @staticmethod
    def _margin(logits):
        """Top-1 minus top-2 logit per row (on the device)."""
        top = torch.topk(logits.to(torch.float32), 2, dim=-1).values
        return top[:, 0] - top[:, 1]

    def _admit(self, req: Request):
        """Prefill a queued request into a free slot; its first token
        stays on the device until the step's commit."""
        P_len = len(req.prompt)
        first, margin, pre_cache = self._prefill(req)
        slot = self.cache.admit(pre_cache, P_len)
        st = _Slot(req, [], seq=self._admit_seq, pending_first=first,
                   pending_margin=margin)
        self._admit_seq += 1
        self._slots[slot] = st
        self._pos[slot] = P_len
        self._temp[slot] = req.temperature
        self.tokens_generated += 1
        # retirement the host can predict without the token's value
        if (self._n_committed(st) >= req.max_new_tokens
                or self._committed_pos(st) >= self.ecfg.max_seq):
            st.live = False

    def _n_committed(self, st: _Slot) -> int:
        """Tokens generated so far, the pending first token included."""
        return len(st.out) + (1 if st.pending_first is not None else 0)

    def _committed_pos(self, st: _Slot) -> int:
        """The slot's committed cache occupancy / next write position."""
        return len(st.req.prompt) + self._n_committed(st) - 1

    def _fold_first(self, slot: int, st: _Slot) -> bool:
        """Sync the pending first token into host bookkeeping.  Returns
        True iff the slot is still occupied by ``st`` afterwards."""
        if st.pending_first is None:
            return self._slots[slot] is st
        first = int(st.pending_first.cpu()[0])
        st.pending_first = None
        st.out.append(first)
        st.margins.append(float(st.pending_margin.cpu()[0]))
        st.pending_margin = None
        self._tokens[slot] = first
        if self.ecfg.spec_k > 0 and st.drafter is None:
            st.drafter = NGramDrafter(list(st.req.prompt) + st.out)
        self._maybe_retire(slot, first)
        return self._slots[slot] is st

    def _maybe_retire(self, slot: int, tok: int):
        st = self._slots[slot]
        done = (len(st.out) >= st.req.max_new_tokens
                or (self.ecfg.eos_id is not None and tok == self.ecfg.eos_id)
                or self._committed_pos(st) >= self.ecfg.max_seq)
        if done:
            # evict turns the slot's block-table row to -1, so the stale
            # pos/token the free row still carries into the next batched
            # step can only produce dropped writes
            st.live = False
            self.cache.evict(slot)
            self._slots[slot] = None
            self._retired.append((st.req, st.out))
            self.margins[st.req.rid] = st.margins

    # -- scheduling --------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def idle(self) -> bool:
        return not self._queue and self.num_active == 0

    def slot_progress(self) -> list:
        """Per slot, ``(rid, index in its stream of the token the next
        step produces)`` of the request it holds — a verify step's row j
        produces the token after that, if the drafts before it are
        accepted — or None for a slot the next step does not schedule
        (free, or finished but not yet retired)."""
        return [None if st is None or not st.live
                else (st.req.rid, self._n_committed(st))
                for st in self._slots]

    def _live_slots(self) -> list:
        return [i for i, s in enumerate(self._slots)
                if s is not None and s.live]

    def preempt_slot(self, slot: int):
        """Evict ``slot`` and re-queue its request at the front, to
        restart from scratch on re-admit."""
        st = self._slots[slot]
        if st is None:
            raise ValueError(f"preempt_slot: slot {slot} is free")
        st.live = False
        self.cache.evict(slot)
        self._slots[slot] = None
        self.preemptions += 1
        self._queue.appendleft(st.req)

    def step(self) -> list:
        """One scheduler tick: admit what fits, run one batched decode
        (or, with ``spec_k > 0``, verify) step over the live slots and
        commit it.  Returns the requests finished this tick as (request,
        tokens) pairs."""
        while (self._queue and self.cache.allocator.can_admit(
                len(self._queue[0].prompt))):
            self._admit(self._queue.popleft())
        # slots retired by prediction at admit are never scheduled:
        # fold their first token here or they would never retire.  The
        # drafter reads committed tokens, so spec folds every one.
        for i, st in enumerate(self._slots):
            if (st is not None and st.pending_first is not None
                    and (self.ecfg.spec_k > 0 or not st.live)):
                self._fold_first(i, st)
        live = self._live_slots()
        if live:
            if self.ecfg.spec_k > 0:
                self._verify(live)
            else:
                self._decode(live)
        out, self._retired = self._retired, []
        return out

    def _ensure_for_step(self, live, need):
        """Map the pages every live slot writes next (``need(slot)`` is
        the occupancy the step must cover), preempting the youngest slot
        of a starving group when ``preempt`` is on."""
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
            grp = alloc.group_of(starving)
            victims = [j for j in live if alloc.group_of(j) == grp]
            if len(victims) < 2:
                # a sole live slot cannot be helped by preemption: retry
                # so the typed error propagates
                for i in live:
                    self.cache.ensure(i, need(i))
                return live
            victim = max(victims, key=lambda j: self._slots[j].seq)
            self.preempt_slot(victim)
            live = [j for j in live if j != victim]

    def _step_aux(self):
        """The block table and, on the kernel walk, the compacted page
        lists, staged for one step."""
        aux = {"block_table": self._stage(self.cache.block_table)}
        if self.ecfg.attn_kernel == "fused":
            aux["page_list"] = (self._stage(self.cache.page_list_loc),
                                self._stage(self.cache.page_list_pos))
        return aux

    @torch.no_grad()
    def _decode(self, live):
        live = self._ensure_for_step(live, lambda i: int(self._pos[i]) + 1)
        if not live:
            return
        tok = self._stage(self._tokens)
        pending = [(i, self._slots[i].pending_first) for i in live
                   if self._slots[i].pending_first is not None]
        for i, first in pending:
            tok[i] = first[0]
        logits, self.cache.buffers = M.forward_decode(
            self.params, self.cache.buffers, tok, self._stage(self._pos),
            self.ctx, aux_extra=self._step_aux())
        out = sampling.sample(logits, self._temp, self._next_generator(),
                              self._scfg).cpu().numpy()
        margin = self._margin(logits).cpu().numpy()
        entries = [(i, self._slots[i]) for i in live]
        for i, st in entries:
            self._pos[i] += 1
            if (self._n_committed(st) + 1 >= st.req.max_new_tokens
                    or int(self._pos[i]) >= self.ecfg.max_seq):
                st.live = False
        self.decode_steps += 1
        for i, st in entries:
            if not self._fold_first(i, st):
                continue     # the first token was EOS: this column is a
                #              zombie whose write landed beyond occupancy
            tok_i = int(out[i])
            st.out.append(tok_i)
            st.margins.append(float(margin[i]))
            self._tokens[i] = tok_i
            self.tokens_generated += 1
            self._maybe_retire(i, tok_i)

    @torch.no_grad()
    def _verify(self, live):
        """One speculative step: draft spec_k tokens per slot, score all
        K1 = spec_k + 1 positions in one batched forward, accept the
        longest draft prefix equal to the sampled tokens plus the
        correction token, and roll the rejected tail's pages back.
        Under greedy sampling a draft is accepted only where it equals
        the argmax a vanilla step would take, so the committed stream
        is the ``spec_k=0`` stream."""
        k = self.ecfg.spec_k
        max_seq = self.ecfg.max_seq
        # the step writes KV at pos..pos+k (clipped at the context end):
        # map those pages first; the rejected tail's roll back at commit
        live = self._ensure_for_step(
            live, lambda i: min(int(self._pos[i]) + k + 1, max_seq))
        if not live:
            return
        drafts = np.zeros((self.ecfg.num_slots, k), np.int32)
        for i in live:
            drafts[i] = self._slots[i].drafter.propose(k)
        feed = np.concatenate([self._tokens[:, None], drafts], axis=1)
        logits, self.cache.buffers = M.forward_verify(
            self.params, self.cache.buffers, self._stage(feed),
            self._stage(self._pos), self.ctx, aux_extra=self._step_aux())
        out = sampling.sample_verify(logits, self._temp,
                                     self._next_generator(),
                                     self._scfg).cpu().numpy()
        B, K1, V = logits.shape
        margin = self._margin(logits.reshape(B * K1, V)).reshape(
            B, K1).cpu().numpy()
        self.decode_steps += 1
        eos = self.ecfg.eos_id
        for i in live:
            st = self._slots[i]
            a = 0
            while a < k and drafts[i, a] == out[i, a]:
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
                f"run: {self.num_active} slots still active and "
                f"{len(self._queue)} requests queued after {max_steps} "
                "steps")
        return results
