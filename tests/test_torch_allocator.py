"""The port's ``SlotAllocator`` against the JAX package's, op for op.

One op sequence drawn from a fixed ``RandomState`` — alloc, ensure,
extend, rollback, free, deferred-free dispatch/commit epochs and
cross-group migration — drives both allocators on a pool of two groups
with two shards each (so the compacted per-shard lists are exercised).
After every op ``block_table``, ``page_list_loc`` and ``page_list_pos``
are equal, both raise the same typed error (by name) or neither does,
and the port's state holds the structural invariants the paged-decode
kernel relies on (those of ``tests/test_paged_decode.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.kv_cache import SlotAllocator as JaxAllocator  # noqa: E402

from repro_torch.serving.kv_cache import SlotAllocator  # noqa: E402

torch.set_num_threads(1)


def _check_lists(a):
    """Every structural invariant the paged-decode kernel relies on."""
    live_all = []
    for slot in range(a.num_slots):
        pages = a._pages[slot]
        live_all.extend(pages)
        base = a.group_of(slot) * a.pages_per_group
        seen = []
        for s in range(a.shards_per_group):
            cnt = int(a._shard_count[slot, s])
            loc = a.page_list_loc[slot, s]
            pos = a.page_list_pos[slot, s]
            assert (loc[:cnt] >= 0).all() and (loc[cnt:] == -1).all()
            assert (pos[:cnt] >= 0).all() and (pos[cnt:] == -1).all()
            assert (loc[:cnt] < a.pages_local).all()
            assert (np.diff(pos[:cnt]) > 0).all()
            for j in range(cnt):
                page = base + s * a.pages_local + int(loc[j])
                assert a._shard_of(page) == s
                assert int(pos[j]) == pages.index(page) * a.page_size
                seen.append(page)
        assert sorted(seen) == sorted(pages)
        bt = a.block_table[slot]
        assert list(bt[:len(pages)]) == pages
        assert (bt[len(pages):] == -1).all()
    assert len(live_all) == len(set(live_all))


def _apply(a, op, args):
    try:
        return "ok", getattr(a, op)(*args)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, None


def _ops(rng, n, num_slots, max_seq):
    ops = []
    for _ in range(n):
        k = rng.randint(9)
        slot = int(rng.randint(num_slots))
        if k <= 1:
            ops.append(("alloc", (int(rng.randint(1, max_seq + 1)),)))
        elif k == 2:
            ops.append(("ensure", (slot, int(rng.randint(1, max_seq + 17)))))
        elif k == 3:
            ops.append(("extend", (slot, int(rng.randint(1, 9)))))
        elif k == 4:
            ops.append(("rollback", (slot, int(rng.randint(1, max_seq)))))
        elif k == 5:
            ops.append(("free", (slot,)))
        elif k == 6:
            ops.append(("note_dispatch", ()))
        elif k == 7:
            ops.append(("note_commit", ()))
        else:
            ops.append(("migrate_slot", (slot, int(rng.randint(2)))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_ops_same_tables(seed):
    kw = dict(num_slots=6, max_seq=48, page_size=8, num_pages=24,
              num_groups=2, shards_per_group=2)
    a, b = JaxAllocator(**kw), SlotAllocator(**kw)
    rng = np.random.RandomState(seed)
    outcomes = set()
    for op, args in _ops(rng, 400, kw["num_slots"], kw["max_seq"]):
        ra, rb = _apply(a, op, args), _apply(b, op, args)
        assert ra == rb, (op, args)
        outcomes.add((op, ra[0]))
        for name in ("block_table", "page_list_loc", "page_list_pos"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        assert (b.num_free, b.pages_in_use, b.pages_in_limbo) == (
            a.num_free, a.pages_in_use, a.pages_in_limbo)
        _check_lists(b)
    # the sequence reached the allocator's interesting outcomes
    assert {("alloc", "ok"), ("alloc", "PagePoolExhausted"),
            ("ensure", "CacheOverflowError"), ("free", "ok"),
            ("migrate_slot", "ok")} <= outcomes
