"""Pooled KV page cache + slot-major state cache for the serving engine.

The port of ``repro.serving.kv_cache``.  Attention KV lives in one
shared page pool ``[U, num_pages, page_size, Hkv, dh]`` per attention
pattern position, and each request slot maps an ordered list of pages
through a per-slot block-table row of global page ids (-1 = unmapped),
so a slot's device footprint is ``ceil(len / page_size)`` pages, not a
dense ``max_seq`` reservation.  Recurrent state (mamba / xLSTM / RWKV)
stays slot-major, ``[U, num_slots, ...]``: it is O(1) per slot and every
step reads all of it, so paging buys it nothing.  An admission
overwrites its slot's state rows; an evicted slot's rows wait for the
next admission.  A family without attention (``rwkv-paper``,
``xlstm-125m``) has no KV leaf at all, while the allocator books its
pages and positions as for any other.

``SlotAllocator`` is the host side, ported op for op from the reference
(host numpy): slot free list, per-group/per-shard page free lists,
alloc-on-extend, page-exact rollback/free, deferred-free epochs, the
compacted per-shard page lists the paged-decode kernel walks, and the
cross-group migration primitives.  ``PagedKVCache`` is the device side
on one card: the zeroed pool and state, the insert of a prefilled
prompt's KV into its freshly mapped pages and of its state into its
slot's rows, and ensure/evict/rollback.

Safety invariant (why stale pool rows never leak between slots): a
slot's visible positions ``[0, len)`` are always positions the slot
itself wrote, and every read masks entries beyond the slot's own
positions, so a recycled page's previous contents are overwritten
before they could ever score.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..models import blocks_attn
from ..models import model as M
from ..models.blocks_rnn import PP_INIT
from .errors import CacheOverflowError, PagePoolExhausted, SlotsExhausted
from .staging import to_device


def pages_per_slot(max_seq: int, page_size: int) -> int:
    """Block-table width: pages a slot at full ``max_seq`` occupancy maps."""
    return -(-max_seq // page_size)


class SlotAllocator:
    """Free-list slot allocation + a real shared-pool page allocator.

    ``num_pages`` defaults to ``num_slots * pages_per_slot`` (the dense
    reservation — can never exhaust before the slots do); sizing it
    smaller is the paging payoff: slots share the pool and long-context
    slots no longer reserve ``max_seq`` up front.  ``num_groups`` > 1
    partitions the pool into equal contiguous regions and pins each
    slot to the region of its dp group (``slot // slots_per_group``),
    matching the device-side page sharding over dp x tp.

    Compacted per-shard page lists: with ``shards_per_group`` > 1 each
    group's region further splits into one contiguous range per tp
    shard (``pages_local`` pages each — the device-side pool slice),
    and alongside the block table the allocator maintains
    ``page_list_loc`` / ``page_list_pos``: ``[num_slots,
    shards_per_group, pages_per_shard]`` int32 arrays naming, for each
    (slot, shard), the shard-LOCAL pool rows of the slot's resident
    pages and the absolute position of each page's first token
    (ordinal * page_size); -1 = no page.  The fused paged-decode
    kernel walks these lists instead of the full block table, so every
    page a slot maps must land within ``pages_per_shard =
    ceil(pages_per_slot / shards_per_group)`` rows on its shard —
    ``_map_pages`` balances placement to keep that invariant (fewest
    of the slot's pages first).  The cost of the static per-shard
    width is a mild admission tightening: free pages clustered on one
    shard beyond ``pages_per_shard`` are unusable by a single slot, so
    capacity checks count ``min(free_on_shard, headroom_on_shard)``
    per shard rather than the group total.  An overflowing page would
    be invisible to the fused kernel (silently unattended positions),
    so the invariant is enforced at allocation, never best-effort.
    ``shards_per_group=1`` (the default) keeps one list per group and
    is behavior-identical to the pre-compaction allocator.
    """

    def __init__(self, num_slots: int, max_seq: int, page_size: int = 64,
                 num_pages: int | None = None, num_groups: int = 1,
                 shards_per_group: int = 1):
        if num_slots <= 0 or page_size <= 0 or max_seq <= 0:
            raise ValueError((num_slots, max_seq, page_size))
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot(max_seq, page_size)
        if num_pages is None:
            num_pages = num_slots * self.pages_per_slot
        if num_pages <= 0 or num_pages % num_groups != 0 \
                or num_slots % num_groups != 0:
            raise ValueError(
                f"num_pages={num_pages} / num_slots={num_slots} must be "
                f"positive multiples of num_groups={num_groups}")
        self.num_pages = num_pages
        self.num_groups = num_groups
        self.pages_per_group = num_pages // num_groups
        if shards_per_group <= 0 \
                or self.pages_per_group % shards_per_group != 0:
            raise ValueError(
                f"pages_per_group={self.pages_per_group} must be a "
                f"positive multiple of shards_per_group={shards_per_group}")
        self.shards_per_group = shards_per_group
        #: pages of one (group, shard) range — the device pool slice size
        self.pages_local = self.pages_per_group // shards_per_group
        #: static width of one (slot, shard) compacted page list
        self.pages_per_shard = -(-self.pages_per_slot // shards_per_group)
        self._slots_per_group = num_slots // num_groups
        self._free = deque(range(num_slots))
        self._free_pages = [
            [deque(range(g * self.pages_per_group + s * self.pages_local,
                         g * self.pages_per_group
                         + (s + 1) * self.pages_local))
             for s in range(shards_per_group)]
            for g in range(num_groups)]
        self._len = np.zeros(num_slots, np.int64)   # current seq occupancy
        self._pages: list[list[int]] = [[] for _ in range(num_slots)]
        #: pages each slot holds on each shard (compacted-list fill level)
        self._shard_count = np.zeros((num_slots, shards_per_group),
                                     np.int32)
        # deferred-free epoch state: device steps launched vs joined, and
        # pages freed while a snapshot may still name them —
        # (release_epoch, page) pairs, nondecreasing in epoch
        self._dispatched = 0
        self._committed = 0
        self._limbo: deque[tuple[int, int]] = deque()
        #: [num_slots, pages_per_slot] int32 global page ids, -1 unmapped —
        #: passed verbatim as the device block table every step
        self.block_table = np.full((num_slots, self.pages_per_slot), -1,
                                   np.int32)
        #: [num_slots, shards_per_group, pages_per_shard] int32 — the
        #: compacted per-shard page lists the fused decode kernel walks:
        #: shard-local pool row of each resident page (-1 = none), and
        #: the absolute position of the page's first token.  Staged to
        #: device per dispatch exactly like the block table.
        self.page_list_loc = np.full(
            (num_slots, shards_per_group, self.pages_per_shard), -1,
            np.int32)
        self.page_list_pos = np.full(
            (num_slots, shards_per_group, self.pages_per_shard), -1,
            np.int32)

    # -- sizing / introspection -------------------------------------------

    def group_of(self, slot: int) -> int:
        return slot // self._slots_per_group

    def _shard_of(self, page: int) -> int:
        """tp-shard index (within its group) holding global ``page``."""
        return (page // self.pages_local) % self.shards_per_group

    @property
    def num_free(self) -> int:
        return len(self._free)

    def free_pages_in_group(self, group: int) -> int:
        return sum(len(d) for d in self._free_pages[group])

    def limbo_pages_in_group(self, group: int) -> int:
        """Pages of ``group`` parked in deferred-free limbo (freed, but an
        uncommitted device step's snapshot may still name them)."""
        lo = group * self.pages_per_group
        hi = lo + self.pages_per_group
        return sum(1 for _, p in self._limbo if lo <= p < hi)

    def _limbo_by_shard(self, group: int) -> list:
        """Limbo page count per tp shard of ``group`` — what each shard's
        free deque gets back once the pipeline drains."""
        counts = [0] * self.shards_per_group
        lo = group * self.pages_per_group
        hi = lo + self.pages_per_group
        for _, p in self._limbo:
            if lo <= p < hi:
                counts[self._shard_of(p)] += 1
        return counts

    def _fresh_capacity(self, group: int) -> int:
        """Pages a FRESH slot of ``group`` could map right now: per-shard
        free pages, capped at the compacted-list width per shard."""
        return sum(min(len(d), self.pages_per_shard)
                   for d in self._free_pages[group])

    def _admit_capacity(self, group: int, after_flush: bool = False) -> int:
        """Pages ADMISSION may count on for a fresh slot of ``group``.

        Unlike ``_fresh_capacity`` (the mechanism ``alloc`` enforces),
        this is admission POLICY and it is limbo-aware: pages parked in
        deferred-free limbo are claims the pool already owes to slots
        that will grow — admitting against them lets a request in whose
        first alloc-on-extend then starves the group mid-flight and
        triggers needless preemption churn.  Limbo pages count AGAINST
        the free list here, so a dry-pool-plus-limbo group reports 0.
        With ``after_flush=True`` the same capacity is computed as if
        the pipeline had drained (limbo pages rejoined their shards'
        free deques) — the engine uses it to decide whether a
        flush-then-retry would unblock the queue head.
        """
        limbo = self._limbo_by_shard(group)
        if after_flush:
            return sum(min(len(d) + limbo[s], self.pages_per_shard)
                       for s, d in enumerate(self._free_pages[group]))
        return max(0, self._fresh_capacity(group) - sum(limbo))

    def _slot_capacity(self, slot: int) -> int:
        """Additional pages ``slot`` could map right now (per-shard free
        pages capped at the slot's remaining compacted-list headroom)."""
        free = self._free_pages[self.group_of(slot)]
        cnt = self._shard_count[slot]
        return sum(min(len(free[s]), self.pages_per_shard - int(cnt[s]))
                   for s in range(self.shards_per_group))

    def pages_needed(self, seq_len: int) -> int:
        return -(-seq_len // self.page_size)

    def pages_used(self, slot: int) -> int:
        return len(self._pages[slot])

    @property
    def total_pages(self) -> int:
        return self.num_pages

    @property
    def pages_in_use(self) -> int:
        return sum(len(p) for p in self._pages)

    @property
    def pages_in_limbo(self) -> int:
        """Pages freed but not yet safe to remap (an uncommitted device
        step's block-table snapshot may still name them)."""
        return len(self._limbo)

    @property
    def pressure(self) -> float:
        """Fraction of the pool unavailable for new mappings (mapped or
        parked in limbo).  1.0 means the next alloc-on-extend in a dry
        group triggers the engine's pool-pressure preemption path (or
        a typed ``PagePoolExhausted`` with ``preempt=False``) — the
        per-step signal ``repro.serving.slo.SLOMonitor`` trends."""
        return (self.pages_in_use + self.pages_in_limbo) / self.num_pages

    # -- deferred-free epochs (async dispatch/commit) ----------------------

    def note_dispatch(self):
        """A device step was launched against the CURRENT block table.

        Until the matching ``note_commit``, any page freed (evict,
        rollback) parks on the limbo list instead of the free pool: the
        in-flight step's snapshot may still read or write it, and
        handing it to a new slot would let two owners race on one page.
        """
        self._dispatched += 1

    def note_commit(self):
        """The OLDEST in-flight device step joined the host (its output
        was synced, so its reads/writes have fully executed).  Limbo
        pages whose every possible holder has now committed rejoin their
        group's free pool."""
        if self._committed >= self._dispatched:
            raise ValueError("note_commit without a matching "
                             "note_dispatch: no device step is in flight")
        self._committed += 1
        while self._limbo and self._limbo[0][0] <= self._committed:
            _, page = self._limbo.popleft()
            g = page // self.pages_per_group
            self._free_pages[g][self._shard_of(page)].append(page)

    def _release_page(self, page: int):
        if self._dispatched > self._committed:
            # unsafe until every step dispatched so far has committed:
            # tag with the newest epoch that could hold a snapshot
            self._limbo.append((self._dispatched, page))
        else:
            g = page // self.pages_per_group
            self._free_pages[g][self._shard_of(page)].append(page)

    # -- page mapping (internal) ------------------------------------------

    def _map_pages(self, slot: int, n: int):
        g = self.group_of(slot)
        if n > self._slot_capacity(slot):
            free = self.free_pages_in_group(g)
            raise PagePoolExhausted(
                f"slot {slot} (group {g}) needs {n} page(s); capacity "
                f"{self._slot_capacity(slot)} ({free} free of "
                f"{self.pages_per_group} in its group, per-shard "
                f"compacted-list width {self.pages_per_shard}; "
                f"{self.pages_in_use}/{self.num_pages} mapped pool-wide)")
        free = self._free_pages[g]
        cnt = self._shard_count[slot]
        for _ in range(n):
            # balanced placement: the shard where this slot holds the
            # fewest pages (so no shard's compacted list overflows its
            # static width), tie-broken toward the shard with the most
            # free pages (global balance), then lowest index (determinism)
            s = min((s for s in range(self.shards_per_group)
                     if free[s] and cnt[s] < self.pages_per_shard),
                    key=lambda s: (int(cnt[s]), -len(free[s]), s))
            page = free[s].popleft()
            ordinal = len(self._pages[slot])
            self.block_table[slot, ordinal] = page
            self.page_list_loc[slot, s, cnt[s]] = page % self.pages_local
            self.page_list_pos[slot, s, cnt[s]] = ordinal * self.page_size
            cnt[s] += 1
            self._pages[slot].append(page)

    def _unmap_tail(self, slot: int, keep: int):
        cnt = self._shard_count[slot]
        while len(self._pages[slot]) > keep:
            page = self._pages[slot].pop()
            self.block_table[slot, len(self._pages[slot])] = -1
            # the popped page has the slot's highest ordinal, and each
            # per-shard list is ordinal-ordered, so it is the LAST live
            # entry of its own shard's compacted list
            s = self._shard_of(page)
            cnt[s] -= 1
            self.page_list_loc[slot, s, cnt[s]] = -1
            self.page_list_pos[slot, s, cnt[s]] = -1
            self._release_page(page)

    # -- slot lifecycle ----------------------------------------------------

    def can_admit(self, seq_len: int, after_flush: bool = False,
                  groups=None) -> bool:
        """True iff some free slot's group can map ``seq_len`` tokens.

        Limbo-aware (see ``_admit_capacity``): pages parked in
        deferred-free limbo never count toward admission, so a dry pool
        with parked pages rejects instead of admitting a request that
        would starve mid-flight.  ``after_flush=True`` answers the
        counterfactual "would this admit pass once the pipeline drains
        and limbo pages rejoin the pool?" — the engine's
        flush-then-retry gate.  ``groups`` (optional iterable) restricts
        the candidate free slots to those dp groups — the disaggregated
        engine admits prefills into prefill-role groups only.
        """
        if not 0 < seq_len <= self.max_seq:
            return False
        need = self.pages_needed(seq_len)
        cand = set(groups) if groups is not None else None
        return any(need <= self._admit_capacity(self.group_of(s),
                                                after_flush=after_flush)
                   for s in self._free
                   if cand is None or self.group_of(s) in cand)

    def alloc(self, seq_len: int, groups=None) -> int:
        """Claim a slot + map pages for ``seq_len`` already-held tokens.

        Picks the first free slot (FIFO) whose group has enough free
        pages; ``groups`` (optional iterable) restricts candidates to
        those dp groups (disaggregated admission targets prefill-role
        groups).  Typed failures: ``SlotsExhausted`` when no slot is
        free, ``PagePoolExhausted`` when slots are free but no group can
        map the request — the caller queues in either case.  Deliberately
        limbo-PERMISSIVE (mechanism, not policy): free-list pages are
        usable the instant they are free — admission policy
        (``can_admit``) is where limbo pressure gates new work.
        """
        if not 0 < seq_len <= self.max_seq:
            raise ValueError(f"seq_len {seq_len} not in (0, {self.max_seq}]")
        cand = set(groups) if groups is not None else None
        free = [s for s in self._free
                if cand is None or self.group_of(s) in cand]
        if not free:
            raise SlotsExhausted(
                f"all {self.num_slots} slots in use"
                + ("" if cand is None else f" (groups {sorted(cand)})"))
        need = self.pages_needed(seq_len)
        for slot in free:
            if need <= self._fresh_capacity(self.group_of(slot)):
                break
        else:
            raise PagePoolExhausted(
                f"{need} page(s) for seq_len {seq_len}: no free slot's "
                f"group has them ({self.pages_in_use}/{self.num_pages} "
                "mapped)")
        self._free.remove(slot)
        self._map_pages(slot, need)
        self._len[slot] = seq_len
        return slot

    def ensure(self, slot: int, new_len: int):
        """Alloc-on-extend: grow ``slot``'s mapping to cover ``new_len``
        positions (no-op if already covered).  The engine calls this
        BEFORE launching a decode/verify step so every position the step
        writes has a mapped page.  Raises ``CacheOverflowError`` past
        ``max_seq`` (the old silent clamp hid scheduler bugs) and
        ``PagePoolExhausted`` when the slot's group has no page left.
        """
        if self._len[slot] <= 0:
            raise ValueError(f"ensure on free slot {slot}")
        if new_len > self.max_seq:
            raise CacheOverflowError(
                f"slot {slot}: {new_len} positions > max_seq "
                f"{self.max_seq}")
        self._map_pages(slot,
                        self.pages_needed(new_len) - self.pages_used(slot))
        self._len[slot] = max(self._len[slot], new_len)

    def extend(self, slot: int, n: int = 1):
        self.ensure(slot, int(self._len[slot]) + n)

    def rollback(self, slot: int, new_len: int):
        """Roll a slot's occupancy back to ``new_len`` positions,
        returning the rejected tail's pages to the pool (page-exact).

        Speculative decoding maps+writes KV for every draft position
        before acceptance is known; the scheduler calls this to shrink
        to the committed length.  Only shrinking (or no-op) is legal —
        growth goes through ``ensure``/``extend``.
        """
        if not 0 < new_len <= self._len[slot]:
            raise ValueError(
                f"rollback slot {slot} to {new_len}: occupancy is "
                f"{int(self._len[slot])} (must shrink to a positive length)")
        self._unmap_tail(slot, self.pages_needed(new_len))
        self._len[slot] = new_len

    def free(self, slot: int):
        if self._len[slot] <= 0:
            # typed (not assert): a double free surviving `python -O`
            # would put the slot on the free list twice and hand it to
            # two requests at once
            raise ValueError(f"slot {slot} already free")
        self._unmap_tail(slot, 0)
        self._len[slot] = 0
        self._free.append(slot)

    # -- cross-group migration (disaggregated prefill/decode) --------------

    def pages_in_use_by_group(self, group: int) -> int:
        lo = group * self._slots_per_group
        return sum(len(self._pages[s])
                   for s in range(lo, lo + self._slots_per_group))

    def free_slot_in_group(self, group: int) -> int | None:
        """First free slot of ``group`` (FIFO), or None."""
        for s in self._free:
            if self.group_of(s) == group:
                return s
        return None

    def placement_counts(self, group: int, need: int) -> list | None:
        """Per-shard page counts balanced placement WOULD give a fresh
        slot of ``group`` mapping ``need`` pages right now, or None if
        the group cannot map them.  Pure simulation (no mutation) — the
        disaggregated router uses it to predict, before a prefill runs,
        whether a decode group could mirror the resulting placement.
        """
        avail = [len(d) for d in self._free_pages[group]]
        cnt = [0] * self.shards_per_group
        for _ in range(need):
            cands = [s for s in range(self.shards_per_group)
                     if avail[s] and cnt[s] < self.pages_per_shard]
            if not cands:
                return None
            s = min(cands, key=lambda s: (cnt[s], -avail[s], s))
            avail[s] -= 1
            cnt[s] += 1
        return cnt

    def peek_alloc(self, seq_len: int, groups=None) -> int | None:
        """The slot ``alloc(seq_len, groups)`` would claim RIGHT NOW (no
        mutation), or None if it would raise.  The disaggregated router
        runs its whole admission pre-check — prefill-group capacity,
        placement simulation, decode-group mirror capacity — against
        this prediction before popping the queue head, so an admission
        that starts can always finish."""
        if not 0 < seq_len <= self.max_seq:
            return None
        cand = set(groups) if groups is not None else None
        need = self.pages_needed(seq_len)
        for s in self._free:
            if cand is not None and self.group_of(s) not in cand:
                continue
            if need <= self._fresh_capacity(self.group_of(s)):
                return s
        return None

    def can_place_mirror(self, dst_group: int, counts) -> bool:
        """True iff ``dst_group`` has a free slot and each tp shard s can
        supply ``counts[s]`` pages from its free deque — the mirror
        feasibility test against a SIMULATED source placement
        (``placement_counts``), used before the source pages even
        exist."""
        if self.free_slot_in_group(dst_group) is None:
            return False
        free = self._free_pages[dst_group]
        return all(int(c) <= len(free[s]) for s, c in enumerate(counts))

    def can_migrate(self, src_slot: int, dst_group: int) -> bool:
        """True iff ``dst_group`` has a free slot AND every tp shard can
        mirror ``src_slot``'s per-shard page counts from its own free
        deque.  Mirroring is stricter than balanced placement — the
        device migration is ONE ppermute in which shard s of the source
        group sends its pages straight to shard s of the destination —
        so a group passing ``can_admit`` may still refuse a migration;
        the router treats that as starvation and keeps the request
        queued (or falls back to another decode group).
        """
        if self._len[src_slot] <= 0 or dst_group == self.group_of(src_slot):
            return False
        if self.free_slot_in_group(dst_group) is None:
            return False
        cnt = self._shard_count[src_slot]
        free = self._free_pages[dst_group]
        return all(int(cnt[s]) <= len(free[s])
                   for s in range(self.shards_per_group))

    def migrate_slot(self, src_slot: int, dst_group: int) -> int:
        """Move ``src_slot``'s mapping to a fresh slot of ``dst_group``
        with SHARD-MIRRORED placement; returns the new slot id.

        For each source page held on tp shard s (in compacted-list
        order), a destination page is popped from ``dst_group``'s
        shard-s free deque and placed at the SAME list position with the
        SAME position offset — so the device-side handoff is a single
        ``ppermute`` over the dp axis (shard s talks only to shard s)
        and the destination compacted lists/block table describe the
        received pages without any re-indexing.  The source slot is then
        freed through the ordinary ``free``/limbo machinery: with steps
        in flight its pages park in deferred-free limbo, so a migration
        can never hand a page to a new owner while an uncommitted
        snapshot still names it.  Raises ``SlotsExhausted`` /
        ``PagePoolExhausted`` (typed) when ``dst_group`` cannot take the
        slot — callers should gate on ``can_migrate``.
        """
        if self._len[src_slot] <= 0:
            raise ValueError(f"migrate_slot: slot {src_slot} is free")
        src_group = self.group_of(src_slot)
        if dst_group == src_group or not 0 <= dst_group < self.num_groups:
            raise ValueError(
                f"migrate_slot: dst_group {dst_group} invalid for slot "
                f"{src_slot} of group {src_group}")
        dst_slot = self.free_slot_in_group(dst_group)
        if dst_slot is None:
            raise SlotsExhausted(f"no free slot in group {dst_group}")
        cnt = self._shard_count[src_slot]
        free = self._free_pages[dst_group]
        for s in range(self.shards_per_group):
            if int(cnt[s]) > len(free[s]):
                raise PagePoolExhausted(
                    f"migrate slot {src_slot} -> group {dst_group}: shard "
                    f"{s} must mirror {int(cnt[s])} page(s) but has "
                    f"{len(free[s])} free")
        self._free.remove(dst_slot)
        pages_by_ordinal = {}
        for s in range(self.shards_per_group):
            for j in range(int(cnt[s])):
                page = free[s].popleft()
                self.page_list_loc[dst_slot, s, j] = page % self.pages_local
                pos = int(self.page_list_pos[src_slot, s, j])
                self.page_list_pos[dst_slot, s, j] = pos
                ordinal = pos // self.page_size
                self.block_table[dst_slot, ordinal] = page
                pages_by_ordinal[ordinal] = page
        self._pages[dst_slot] = [pages_by_ordinal[o]
                                 for o in sorted(pages_by_ordinal)]
        self._shard_count[dst_slot] = cnt
        self._len[dst_slot] = self._len[src_slot]
        self.free(src_slot)
        return dst_slot


def default_num_pages(num_slots: int, max_seq: int, page_size: int) -> int:
    """Pool size reproducing the dense reservation exactly: every slot
    can map ``pages_per_slot`` pages, so the pool never exhausts before
    the slots do (the reference's default at tp = dp = 1)."""
    return num_slots * pages_per_slot(max_seq, page_size)


class PagedKVCache:
    """Device page pool and slot-major state + host ``SlotAllocator`` on
    one card.

    ``buffers`` is ``{"posI": {"kv": {"k", "v"}}}`` at attention
    positions, with pool leaves ``[U, num_pages + 1, page_size, Hkv,
    dh]`` in the config's dtype, and ``{"posI": {key: {leaf}}}`` at
    recurrent ones (``key`` one of ``ssm_state``, ``rnn_state``,
    ``rwkv_state``), with leaves ``[U, num_slots, ...]`` in the shapes
    and dtypes of the reference's cache specs, zero but RWKV's ``pp``
    (-1e30).  All are allocated once and updated in place by inserts
    and decode steps.  Pool row ``num_pages`` is the sink that a step's
    dropped KV writes land in (``blocks_attn.paged_write_targets``); no
    block table maps it.
    """

    def __init__(self, cfg, *, num_slots: int, max_seq: int,
                 page_size: int, num_pages: int, device):
        self.page_size = page_size
        self.num_pages = num_pages
        self.device = torch.device(device)
        self.allocator = SlotAllocator(num_slots, max_seq, page_size,
                                       num_pages=num_pages)
        d = blocks_attn.attn_dims(cfg)
        shape = (cfg.n_units, num_pages + 1, page_size, d["Hkv"], d["dh"])
        self.buffers = {}
        for i, kind in enumerate(cfg.pattern):
            st = M.state_shapes(cfg, kind)
            if st is None:
                self.buffers[f"pos{i}"] = {"kv": {
                    n: torch.zeros(shape, dtype=cfg.dtype, device=self.device)
                    for n in ("k", "v")}}
                continue
            key, leaves = st
            self.buffers[f"pos{i}"] = {key: {
                n: torch.full((cfg.n_units, num_slots) + shp,
                              PP_INIT if n == "pp" else 0.0, dtype=dt,
                              device=self.device)
                for n, (shp, dt) in leaves.items()}}

    def _leaves(self, kv: bool):
        """(position, cache key, leaf name, tensor) of every KV (``kv``)
        or state leaf."""
        return [(pos, key, n, t) for pos, c in self.buffers.items()
                for key, leaves in c.items() if (key == "kv") == kv
                for n, t in leaves.items()]

    def kv_page_bytes(self) -> int:
        """Device bytes of ONE pool page summed over layers/units (0
        without attention)."""
        return sum(t.nbytes // (self.num_pages + 1)
                   for *_, t in self._leaves(kv=True))

    def state_bytes_per_slot(self) -> int:
        """Slot-major (recurrent state) bytes per slot — unchanged by
        paging, reported so the pool numbers are not mistaken for the
        whole cache."""
        return sum(t.nbytes // t.shape[1]
                   for *_, t in self._leaves(kv=False))

    @property
    def block_table(self) -> np.ndarray:
        """Host block table [slots, pages_per_slot] int32, -1 unmapped."""
        return self.allocator.block_table

    @property
    def page_list_loc(self) -> np.ndarray:
        """Compacted page lists [slots, 1, pages_per_shard] int32: pool
        row of each resident page, -1 = none."""
        return self.allocator.page_list_loc

    @property
    def page_list_pos(self) -> np.ndarray:
        """Absolute position of each listed page's first token, -1 = no
        page."""
        return self.allocator.page_list_pos

    def insert(self, pre_cache, pages: np.ndarray, slot: int = None):
        """Splice a B=1 prefill cache into one slot: its KV (leaves [U, 1,
        S_pre, Hkv, dh]) into the pool pages of the block-table row
        ``pages`` [pages_per_slot] (host int32, -1 beyond the prompt),
        and its recurrent state (leaves [U, 1, ...]) into row ``slot``
        of the state leaves, overwriting whatever the slot held.  Only
        mapped pages are written: an admit touches O(prompt_len) pool
        bytes."""
        state = self._leaves(kv=False)
        if state and slot is None:
            raise ValueError("insert: a recurrent state needs its slot")
        for pos, key, n, buf in state:
            # a mamba prefill shorter than K-1 tokens keeps fewer conv
            # rows; they broadcast over the slot's rows, as the
            # reference's insert broadcasts them
            buf[:, slot] = pre_cache[pos][key][n][:, 0].to(buf.dtype)
        psz = self.page_size
        rows = np.flatnonzero((pages >= 0) & (pages < self.num_pages))
        if rows.size == 0:
            return
        ordinals = to_device(rows, self.device, torch.long)
        dst = to_device(pages[rows], self.device, torch.long)
        for pos, _, n, pool in self._leaves(kv=True):
            full = pre_cache[pos]["kv"][n][:, 0]         # [U, S_pre, ..]
            S_pre = full.shape[1]
            gpos = (ordinals[:, None] * psz
                    + torch.arange(psz, device=self.device))
            src = full[:, gpos.clamp(max=S_pre - 1)]     # [U, n, psz, ..]
            pool[:, dst] = src.to(pool.dtype)

    def admit(self, pre_cache, seq_len: int) -> int:
        """Allocate a slot, map ``ceil(seq_len/page_size)`` pages and
        splice the prefilled cache into them and the slot's state
        rows."""
        slot = self.allocator.alloc(seq_len)
        self.insert(pre_cache, self.allocator.block_table[slot], slot)
        return slot

    def ensure(self, slot: int, new_len: int):
        """Map pages (alloc-on-extend) so positions < ``new_len`` are
        writable; called before every decode step."""
        self.allocator.ensure(slot, new_len)

    def evict(self, slot: int):
        """Retire a slot: its pages return to the pool and its block
        table row becomes -1, so a stale write it still carries drops."""
        self.allocator.free(slot)

    def rollback(self, slot: int, new_len: int):
        """Page-exact rollback of a slot's occupancy to ``new_len``."""
        self.allocator.rollback(slot, new_len)
