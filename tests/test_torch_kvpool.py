"""The port's host-side page bookkeeping (``repro_torch.serving.kvpool``)
held against the JAX package's, operation by operation: seeded random
sequences of alloc, ref, release, radix lookup, insert and LRU evict (with
opaque snapshots and partial-page COW hits) applied to both packages'
``PagePool`` and ``RadixCache``.  After every step the return values,
raised errors, refcounts, free lists, tree sizes, counters and
``verify()`` must be equal."""

import numpy as np
import pytest

from repro.serving import kvpool as ref
from repro_torch.serving import kvpool as port


def _call(fn, *args, **kw):
    """(result, None) or (None, (error type, message))."""
    try:
        return fn(*args, **kw), None
    except (ValueError, RuntimeError) as e:
        return None, (type(e).__name__, str(e))


def _both(a, b, name, *args, **kw):
    ra = _call(getattr(a, name), *args, **kw)
    rb = _call(getattr(b, name), *args, **kw)
    assert ra == rb, (name, args, kw)
    return ra[0]


def _hit(h):
    if h is None:
        return None
    return (list(h.pages), h.length, h.partial, h.cow_src, h.snapshot)


def _state(pool, radix):
    return (pool.refcount.tolist(), list(pool._free), pool.available,
            pool.in_use, radix.n_pages, radix.evictable_pages(),
            radix.lookups, radix.hits, radix.tokens_hit, radix._n_snapshots,
            _call(pool.verify)[1], _call(radix.verify)[1])


@pytest.mark.parametrize("seed", range(8))
def test_random_operation_sequences_match_reference(seed):
    rng = np.random.default_rng(seed)
    page_len = int(rng.choice([1, 2, 4]))
    n_pages = int(rng.integers(6, 24))
    pools = (ref.PagePool(n_pages, page_len),
             port.PagePool(n_pages, page_len))
    trees = (ref.RadixCache(pools[0], snapshot_limit=2),
             port.RadixCache(pools[1], snapshot_limit=2))
    # prompts over a 3-token alphabet share prefixes often
    stems = [rng.integers(0, 3, size=int(rng.integers(1, 4 * page_len + 3)))
             .astype(np.int32) for _ in range(4)]
    slots = []                              # page lists held by "slots"
    for step in range(160):
        op = rng.choice(["alloc", "alloc", "release", "ref", "bad",
                         "insert", "lookup", "lookup", "evict"])
        if op == "alloc":
            got = _both(*pools, "alloc", int(rng.integers(0, 5)))
            if got:
                slots.append(list(got))
        elif op == "release" and slots:
            pages = slots.pop(int(rng.integers(len(slots))))
            _both(*pools, "release", pages)
        elif op == "ref" and slots:
            pages = slots[int(rng.integers(len(slots)))]
            _both(*pools, "ref", pages)
            slots.append(list(pages))
        elif op == "bad":
            # free, trash or out-of-range ids: both refuse the same way
            page = int(rng.integers(-1, n_pages + 1))
            _both(*pools, "ref" if rng.random() < 0.5 else "release",
                  [page])
        elif op == "insert" and slots:
            pages = slots[int(rng.integers(len(slots)))]
            stem = stems[int(rng.integers(len(stems)))]
            prompt = stem[:len(pages) * page_len]
            snap = ("snapshot", step) if rng.random() < 0.4 else None
            _both(*trees, "insert", prompt, lambda i, p=pages: p[i],
                  snapshot=snap)
        elif op == "lookup":
            stem = stems[int(rng.integers(len(stems)))]
            tail = rng.integers(0, 3, size=int(rng.integers(0, 5)))
            prompt = np.concatenate([stem[:int(rng.integers(1, len(stem)
                                                            + 1))],
                                     tail]).astype(np.int32)
            kw = dict(max_hit=len(prompt) - int(rng.integers(0, 2)),
                      need_snapshot=bool(rng.random() < 0.25),
                      min_hit=int(rng.integers(0, 2 * page_len)),
                      allow_partial=bool(rng.random() < 0.8))
            ha = _call(trees[0].lookup, prompt, **kw)
            hb = _call(trees[1].lookup, prompt, **kw)
            assert (_hit(ha[0]), ha[1]) == (_hit(hb[0]), hb[1])
        elif op == "evict":
            _both(*trees, "evict", int(rng.integers(0, n_pages)))
        assert _state(pools[0], trees[0]) == _state(pools[1], trees[1]), \
            (seed, step, op)
    _both(*trees, "clear")
    assert _state(pools[0], trees[0]) == _state(pools[1], trees[1])


def test_alloc_refuses_referenced_free_list_page_like_reference():
    errs = []
    for mod in (ref, port):
        pool = mod.PagePool(6, 4)
        (page,) = pool.alloc(1)
        pool._free.append(page)                  # corrupt: live page freed
        errs.append(_call(pool.alloc, pool.available)[1])
    assert errs[0] == errs[1] and errs[0][0] == "RuntimeError"


@pytest.mark.parametrize("n_pages,page_len", [(1, 4), (4, 0)])
def test_pool_constructor_errors_match(n_pages, page_len):
    assert (_call(ref.PagePool, n_pages, page_len)[1]
            == _call(port.PagePool, n_pages, page_len)[1])


def test_byte_models_and_blocks_match():
    for n in range(0, 40):
        for pl in (1, 3, 4, 16):
            assert (port.blocks_for_tokens(n, pl)
                    == ref.blocks_for_tokens(n, pl))
    for pl, g, d in ((4, 1, 16), (16, 3, 64)):
        for layers in (1, 30):
            for quant in (False, True):
                for bits in (2, 4, 8):
                    kw = dict(layers=layers, quant=quant, kv_bits=bits,
                              dtype_bytes=2)
                    assert (port.page_kv_bytes(pl, g, d, **kw)
                            == ref.page_kv_bytes(pl, g, d, **kw))
            assert (port.tail_ring_bytes(pl, g, d, layers=layers)
                    == ref.tail_ring_bytes(pl, g, d, layers=layers))
    assert port.TRASH_PAGE == ref.TRASH_PAGE == 0
