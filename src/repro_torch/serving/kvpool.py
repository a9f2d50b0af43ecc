"""Host-side paged-KV bookkeeping: the page allocator and the radix
prefix cache (port of ``src/repro/serving/kvpool.py``, whole).

Plain numpy and Python, no torch: the same objects, return values,
refcounts, free-list order and error messages as the reference, held
against it operation by operation in ``tests/test_torch_kvpool.py``.  The
device-side pool layout (``models.model.init_paged_pool``), the
scatter-write / page-walk read path (``models.attention``) and the
scheduler (``serving/scheduler.py``) consume these objects.

* :class:`PagePool` — refcounted page allocator.  Page 0 is reserved as
  the **trash page**: every free/finished slot's page-table entries point
  at it, so masked junk writes (inactive rows in a decode tick, pad
  positions of a prompt chunk) land in a page nothing ever reads
  unmasked.  A page is freed when its refcount reaches zero — shared
  prefix pages survive any single holder's release.
* :class:`RadixCache` — a radix tree over prompt token ids at **page
  granularity**: each edge is the exact ``page_len``-token content of one
  page, so a cache hit is a run of whole pages that can be aliased into
  the new slot's page table (one ``ref`` per page, zero copies).  The
  final partially-matching page, if any, is surfaced as a **copy-on-write
  source**: the scheduler copies it into a fresh page the new slot owns
  exclusively, extending the hit below page granularity while shared
  pages stay immutable.
* **Snapshots** — nodes can carry an opaque host snapshot (the reference
  stores SSM/conv state there for hybrid models); the tree only counts
  and LRU-trims them.  The port's scheduler serves attention models and
  passes none yet.
"""

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TRASH_PAGE = 0


class PagePool:
    """Refcounted fixed-size page allocator (host metadata only).

    ``n_pages`` counts the whole device pool including the reserved trash
    page; ``capacity`` (usable pages) is ``n_pages - 1``.  ``alloc`` is
    all-or-nothing: it never hands out a partial allocation, so a failed
    admission leaves the pool untouched.
    """

    def __init__(self, n_pages: int, page_len: int):
        if n_pages < 2:
            raise ValueError(f"n_pages={n_pages}: need >= 2 (page 0 is the "
                             f"reserved trash page)")
        if page_len < 1:
            raise ValueError(f"page_len={page_len} must be >= 1")
        self.n_pages = int(n_pages)
        self.page_len = int(page_len)
        self.refcount = np.zeros((n_pages,), np.int32)
        self.refcount[TRASH_PAGE] = 1          # never allocated, never freed
        # LIFO free list: pages freed by a retiring request are re-used
        # first, which keeps the touched working set small
        self._free: List[int] = list(range(n_pages - 1, 0, -1))

    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.available

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` free pages (refcount 1 each), or ``None`` if fewer
        than ``n`` are free — all-or-nothing, the pool is untouched on
        failure."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        if any(self.refcount[p] != 0 for p in pages):
            # A page on the free list with a live reference means some
            # holder's id would silently alias a new allocation — the
            # device-side page tables (and the paged-attention kernel's
            # table walk) have no staleness check, so fail loudly here
            # rather than serve another request's KV.
            bad = [p for p in pages if self.refcount[p] != 0]
            raise RuntimeError(
                f"PagePool.alloc: free-list pages {bad} still referenced "
                f"(refcounts {[int(self.refcount[p]) for p in bad]}) — "
                f"page ids must stay stable while referenced")
        self.refcount[pages] += 1
        return pages

    def ref(self, pages: Sequence[int]) -> None:
        """Take one additional reference on each page (prefix sharing)."""
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"ref: bad page id {p}")
            if self.refcount[p] <= 0:
                raise ValueError(f"ref: page {p} is free")
            self.refcount[p] += 1

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; pages reaching refcount 0 return
        to the free list.  Returns the page ids actually freed."""
        freed = []
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"release: bad page id {p}")
            if self.refcount[p] <= 0:
                raise ValueError(f"release: page {p} already free")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def is_shared(self, page: int) -> bool:
        return self.refcount[page] > 1

    def verify(self) -> None:
        """Cross-check refcounts against the free list; raises
        ``ValueError`` on any inconsistency.  Used by the pool-to-pool
        transplant tests (``serving/workers.py``): after a span export
        donates/releases prefill-side pages and an import allocates
        decode-side pages, BOTH pools must still satisfy the invariants
        — no referenced page on the free list, no leaked page (refcount
        0 yet unavailable), trash page pinned exactly once."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise ValueError("PagePool.verify: free list has duplicates")
        if TRASH_PAGE in free or self.refcount[TRASH_PAGE] != 1:
            raise ValueError("PagePool.verify: trash page not pinned")
        for p in range(1, self.n_pages):
            rc = int(self.refcount[p])
            if rc < 0:
                raise ValueError(f"PagePool.verify: page {p} refcount {rc}")
            if p in free and rc != 0:
                raise ValueError(f"PagePool.verify: page {p} on the free "
                                 f"list with refcount {rc}")
            if p not in free and rc == 0:
                raise ValueError(f"PagePool.verify: page {p} leaked "
                                 f"(refcount 0 but not on the free list)")


@dataclasses.dataclass
class _Node:
    """One radix-tree edge: the exact token content of one page."""
    page: int                               # page id holding this block's KV
    children: Dict[Tuple[int, ...], "_Node"] = \
        dataclasses.field(default_factory=dict)
    last_used: int = 0
    snapshot: Optional[tuple] = None        # host SSM/conv state AT the end
                                            # of this block (hybrid models)
    depth: int = 0                          # blocks from root, 1-based


@dataclasses.dataclass
class PrefixHit:
    """Result of a radix lookup.

    ``pages`` are whole shared pages (the caller must ``ref`` them);
    ``cow_src`` is the partially-matching page to copy-on-write, covering
    ``partial`` extra tokens beyond ``len(pages) * page_len``.
    ``length = len(pages) * page_len + partial`` prompt tokens are served
    from cache; ``snapshot`` is the SSM/conv state at ``length`` (None
    for attention-only models).
    """
    pages: List[int]
    length: int = 0
    partial: int = 0
    cow_src: Optional[int] = None
    snapshot: Optional[tuple] = None


class RadixCache:
    """Page-granular radix tree over prompt token ids.

    Each edge key is the exact ``page_len``-token tuple of one page, so
    walking the tree IS the longest-common-prefix match at page
    granularity; the deepest reachable node's children are additionally
    scanned for the longest *partial* block match (returned as a COW
    source).  The tree holds one pool reference per resident page;
    :meth:`evict` trims least-recently-used leaves to free pool pages.
    """

    def __init__(self, pool: PagePool, *, snapshot_limit: int = 8):
        self.pool = pool
        self.page_len = pool.page_len
        self.snapshot_limit = int(snapshot_limit)
        self._root = _Node(page=TRASH_PAGE)
        self._clock = itertools.count(1)
        self._n_snapshots = 0
        # observability (serve_bench --prefix-trace)
        self.lookups = 0
        self.hits = 0
        self.tokens_hit = 0

    # ------------------------------------------------------------- internals

    def _blocks(self, prompt: np.ndarray) -> List[Tuple[int, ...]]:
        pl = self.page_len
        n = len(prompt) // pl
        return [tuple(int(t) for t in prompt[i * pl:(i + 1) * pl])
                for i in range(n)]

    def _walk(self, prompt: np.ndarray) -> List[_Node]:
        """Nodes along the longest whole-block match, root excluded."""
        path = []
        node = self._root
        for blk in self._blocks(prompt):
            child = node.children.get(blk)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def _iter_nodes(self):
        stack = [self._root]
        while stack:
            node = stack.pop()
            for key, child in node.children.items():
                yield node, key, child
                stack.append(child)

    # ------------------------------------------------------------------ API

    @property
    def n_pages(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    def verify(self) -> None:
        """Tree/pool consistency: every resident node holds a live page
        reference (depth consistent with its parent, snapshot count
        matching the bound's counter).  Raises ``ValueError`` on any
        violation — paired with :meth:`PagePool.verify` in the
        disaggregated transplant tests."""
        snaps = 0
        for parent, _, child in self._iter_nodes():
            if not 0 < child.page < self.pool.n_pages:
                raise ValueError(f"RadixCache.verify: node page "
                                 f"{child.page} out of range")
            if self.pool.refcount[child.page] < 1:
                raise ValueError(f"RadixCache.verify: node page "
                                 f"{child.page} has no live reference")
            if child.depth != parent.depth + 1:
                raise ValueError(f"RadixCache.verify: node at depth "
                                 f"{child.depth} under parent depth "
                                 f"{parent.depth}")
            snaps += child.snapshot is not None
        if snaps != self._n_snapshots:
            raise ValueError(f"RadixCache.verify: {snaps} snapshots in the "
                             f"tree, counter says {self._n_snapshots}")

    def lookup(self, prompt: np.ndarray, *, max_hit: int,
               need_snapshot: bool = False, min_hit: int = 1,
               allow_partial: bool = True) -> Optional[PrefixHit]:
        """Longest usable cached prefix of ``prompt``.

        ``max_hit`` caps the hit length (pass ``len(prompt) - 1`` so at
        least one suffix token remains to produce the first logits).
        ``need_snapshot`` (SSM/hybrid models) restricts the hit to the
        deepest node carrying a state snapshot and disables partial-page
        extension; ``min_hit`` drops hits too short to be worth the
        chunked suffix path.  Touches matched nodes' LRU clocks.
        """
        self.lookups += 1
        now = next(self._clock)
        path = self._walk(prompt)
        while path and path[-1].depth * self.page_len > max_hit:
            path.pop()
        if need_snapshot:
            while path and path[-1].snapshot is None:
                path.pop()
        for node in path:
            node.last_used = now
        pages = [n.page for n in path]
        hit_len = len(pages) * self.page_len
        partial, cow_src = 0, None
        if allow_partial and not need_snapshot:
            tail = self._root if not path else path[-1]
            rest = np.asarray(prompt[hit_len:])
            best = 0
            for key, child in tail.children.items():
                k = np.asarray(key, rest.dtype)
                lim = min(len(rest), self.page_len, max_hit - hit_len)
                if lim <= best:
                    continue
                eq = k[:lim] == rest[:lim]
                run = int(eq.argmin()) if not eq.all() else lim
                if run > best:
                    best, cow_src = run, child.page
                    if run == lim:
                        break
            if best > 0:
                partial = best
        hit_len += partial
        if hit_len < max(min_hit, 1):
            return None
        self.hits += 1
        self.tokens_hit += hit_len
        return PrefixHit(pages=pages, length=hit_len, partial=partial,
                         cow_src=cow_src if partial else None,
                         snapshot=path[-1].snapshot if path else None)

    def insert(self, prompt: np.ndarray, page_of_block, *,
               snapshot: Optional[tuple] = None) -> int:
        """Insert ``prompt``'s whole-page blocks; ``page_of_block(i)``
        supplies the page id holding block ``i``'s KV (the retiring
        slot's page table).  Existing nodes are re-used (their pages are
        already resident); each NEW node takes one pool reference on its
        page.  ``snapshot`` attaches at the deepest inserted node (the
        cacheable prompt boundary).  Returns the number of new nodes.
        """
        now = next(self._clock)
        node = self._root
        created = 0
        blocks = self._blocks(prompt)
        for i, blk in enumerate(blocks):
            child = node.children.get(blk)
            if child is None:
                page = int(page_of_block(i))
                if page == TRASH_PAGE:
                    break                      # slot never filled this block
                self.pool.ref([page])
                child = _Node(page=page, depth=node.depth + 1)
                node.children[blk] = child
                created += 1
            child.last_used = now
            node = child
        if snapshot is not None and node is not self._root:
            if node.snapshot is None:
                self._n_snapshots += 1
            node.snapshot = snapshot
            self._trim_snapshots(keep=node)
        return created

    def _trim_snapshots(self, keep: Optional[_Node] = None) -> None:
        while self._n_snapshots > self.snapshot_limit:
            cands = [c for _, _, c in self._iter_nodes()
                     if c.snapshot is not None and c is not keep]
            if not cands:
                break
            victim = min(cands, key=lambda n: n.last_used)
            victim.snapshot = None             # pages stay shareable
            self._n_snapshots -= 1

    def evictable_pages(self) -> int:
        """Resident pages eviction could actually free right now: tree
        pages whose only reference is the tree's own (a page a live slot
        still aliases survives its node's eviction)."""
        return sum(1 for _, _, child in self._iter_nodes()
                   if self.pool.refcount[child.page] == 1)

    def evict(self, n_pages_needed: int) -> int:
        """Drop least-recently-used LEAF nodes (releasing their pool
        reference) until at least ``n_pages_needed`` pages are free or
        nothing evictable remains.  A released page is only truly freed
        once no live slot references it.  Returns the number of nodes
        dropped.

        Stops as soon as no resident node could free a page
        (:meth:`evictable_pages` == 0): when every tree page is still
        aliased by a live slot, continuing to drop nodes cannot satisfy
        the request — it would only destroy prefix entries whose pages
        come back to the tree-shareable state the moment those slots
        retire.  (The scheduler guards its call with ``available +
        evictable_pages() >= n``, but evict itself must not over-drain
        on an unsatisfiable ask.)"""
        dropped = 0
        while self.pool.available < n_pages_needed:
            if self.evictable_pages() == 0:
                break
            leaves = [(parent, key, child)
                      for parent, key, child in self._iter_nodes()
                      if not child.children]
            if not leaves:
                break
            parent, key, child = min(leaves, key=lambda t: t[2].last_used)
            if child.snapshot is not None:
                self._n_snapshots -= 1
            del parent.children[key]
            self.pool.release([child.page])
            dropped += 1
        return dropped

    def clear(self) -> None:
        """Release every resident page and reset the tree."""
        for _, _, child in self._iter_nodes():
            self.pool.release([child.page])
        self._root = _Node(page=TRASH_PAGE)
        self._n_snapshots = 0


def blocks_for_tokens(n_tokens: int, page_len: int) -> int:
    """Pages needed to hold ``n_tokens`` (ceil division)."""
    return -(-int(n_tokens) // int(page_len))


def page_kv_bytes(page_len: int, n_kv_heads: int, head_dim: int, *,
                  layers: int = 1, quant: bool = False, kv_bits: int = 4,
                  dtype_bytes: int = 4) -> int:
    """Device bytes ONE pool page holds (K and V, ``layers`` attention
    layer-repeats).  Dense pages store ``dtype_bytes`` per element; log2-
    quantized pages store one packed wire code per element
    (``core.logquant.code_dtype``: 1 byte below 8 exponent bits, else 2)
    plus a per-(page, head) int32 scale exponent.  Pure arithmetic — the
    EXACT-gated byte rows of ``serve_bench --kv-quant`` come from here,
    not from measurement."""
    elems = int(page_len) * int(n_kv_heads) * int(head_dim)
    if quant:
        code = 2 if int(kv_bits) >= 8 else 1
        per = elems * code + int(n_kv_heads) * 4
    else:
        per = elems * int(dtype_bytes)
    return 2 * int(layers) * per


def tail_ring_bytes(page_len: int, n_kv_heads: int, head_dim: int, *,
                    layers: int = 1, dtype_bytes: int = 4) -> int:
    """Device bytes of ONE slot's dense tail ring (quantized pools only):
    ``2 * page_len + 1`` rows — two pages plus the junk bin — per
    direction per layer-repeat.  Per-slot decode-adjacent working set,
    amortized per request by the bench."""
    rows = 2 * int(page_len) + 1
    return (2 * int(layers) * rows * int(n_kv_heads) * int(head_dim)
            * int(dtype_bytes))
