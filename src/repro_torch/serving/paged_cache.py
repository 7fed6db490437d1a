"""Paged KV cache: fixed-size pages, refcounted free-list allocator,
per-row page tables, and a prefix-sharing radix tree.

The device side is a physical page pool per layer-stacked k/v
(``model.init_paged_cache``); this module is the *host-side* bookkeeping
the engine drives every tick:

- ``PageAllocator`` — a refcounted free-list over physical page ids.
  Page 0 is reserved as the **trash page**: idle decode rows point their
  whole table at it so their (masked, discarded) writes land somewhere
  harmless, and no live row ever owns it.
- ``PrefixIndex`` — a radix tree over page-granular token-id chunks:
  each node indexes the physical page holding the K/V of one *full*
  page of tokens; nodes additionally carry *partial tail* entries for
  the last, partially-filled page of an indexed sequence.  Matching a
  new request's feed against the tree yields pages that can be mapped
  by reference instead of recomputed.
- ``PagedKVCache`` — per-row page lists, the dense ``(rows, MAXP)``
  int32 table the decode step consumes, per-row lengths, and the
  prefix-sharing/COW lifecycle.

Refcount / copy-on-write lifecycle invariants (property-tested in
tests/test_serving.py and tests/test_serving_fuzz.py):

- Every allocated page's refcount equals the number of *holders*: rows
  whose table maps it, plus one if the prefix tree indexes it, plus one
  while it is pinned as a gather source (``RowMeta.tail_page``).
- A page is only ever **written** while its refcount is 1 and its sole
  holder is the writing row.  ``admit_row`` maps shared prefix pages
  read-only; the partially-filled boundary page is never written in
  place when shared — the row gets a private copy (copy-on-write):
  either rebuilt from the gathered prefix during chunked prefill, or,
  when a decode write targets a shared page, via ``ensure_decode_room``
  allocating a replacement and scheduling a device page copy
  (``pending_copies``).
- ``release_row`` and preemption *decrement* refcounts; pages the
  prefix tree still indexes survive the owning request and serve later
  prefix hits.  Tree-held pages with refcount 1 are reclaimed
  least-recently-used when the allocator runs dry.
- ``leak_check`` asserts the full accounting after any sequence of
  operations: refcounts match holders exactly, no page is free and
  referenced at once, and free + used == usable.

This is the PyTorch port's own copy of the JAX package's host-side
bookkeeping (it holds no tensors, so the two stay line-for-line alike).
Tensor-parallel page pools are not ported yet (ROADMAP Queue A item 12).
"""
from __future__ import annotations

import dataclasses
from collections import Counter, deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

TRASH_PAGE = 0


class PageAllocator:
    """Refcounted free-list allocator over physical pages [1, num_pages).

    ``alloc`` hands out pages at refcount 1; ``incref`` adds a holder
    (prefix sharing); ``decref``/``free`` drop holders and return the
    page to the free list when the count reaches zero.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one is the trash page)")
        self.num_pages = num_pages
        self._free = deque(range(1, num_pages))
        self._ref: Dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return len(self._ref)

    def refcount(self, page: int) -> int:
        """Current holder count; 0 means the page is on the free list."""
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Grant n pages at refcount 1, or None (all-or-nothing) if fewer
        are free."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            assert p not in self._ref, f"double-assigned page {p}"
            self._ref[p] = 1
        return pages

    def incref(self, page: int) -> None:
        if page not in self._ref:
            raise ValueError(f"incref on unallocated page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one holder; True if the page was freed by this call."""
        if page not in self._ref:
            raise ValueError(f"freeing page {page} that is not allocated")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)
            return True
        return False

    def free(self, pages: List[int]) -> None:
        """Drop one holder per page (a row releasing its table)."""
        for p in pages:
            self.decref(p)


def _common_prefix(a, b) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class _TrieNode:
    __slots__ = ("chunk", "page", "children", "partials", "parent", "stamp")

    def __init__(self, chunk: Tuple[int, ...], page: Optional[int],
                 parent: Optional["_TrieNode"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _TrieNode] = {}
        # partial boundary pages: token-tuple -> [page, fill, stamp]
        self.partials: Dict[Tuple[int, ...], list] = {}
        self.stamp = 0


class PrefixIndex:
    """Radix tree over token-id chunks of one page each.

    Depth d indexes the page holding K/V for absolute positions
    [d*ps, (d+1)*ps) of any sequence whose first (d+1)*ps token ids
    spell the path — K/V of a token depends only on the tokens before
    it, so a common prefix means bitwise-identical pages, and positions
    stay aligned because matches always start at position 0.

    The tree holds one allocator reference per indexed page; entries
    whose page has no other holder (refcount 1) are evicted LRU when
    the allocator runs dry.
    """

    def __init__(self, page_size: int, alloc: PageAllocator,
                 metrics: Optional[MetricsRegistry] = None):
        self.ps = page_size
        self.alloc = alloc
        self.root = _TrieNode((), None, None)
        self._clock = 0
        m = metrics if metrics is not None else MetricsRegistry()
        # live view into the registry (prefix.* metrics); short keys
        # preserved for existing readers
        self.stats = m.group("prefix", keys=(
            "hit_tokens", "miss_tokens", "indexed_pages", "evictions"))

    # ------------------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def pages(self) -> Iterator[int]:
        """Every page the tree holds a reference on (leak accounting)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.page is not None:
                yield node.page
            for ent in node.partials.values():
                yield ent[0]
            stack.extend(node.children.values())

    @property
    def num_pages(self) -> int:
        return sum(1 for _ in self.pages())

    def evictable(self) -> int:
        """Upper bound on pages eviction could free right now.  Rows map
        prefixes contiguously from the root, so a node with a row holder
        implies its parent has one too — refcount-1 subtrees are whole,
        and every refcount-1 page is eventually freeable leaf-first."""
        return sum(1 for p in self.pages() if self.alloc.refcount(p) == 1)

    # ------------------------------------------------------------------
    def match(self, tokens, peek: bool = False
              ) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest page-granular prefix of ``tokens`` in the tree.

        Returns (full_pages, tail): pages covering whole leading pages,
        plus an optional (page, use) source for the next, partial page —
        the best common-prefix among this node's partial entries and
        full children (a full page whose chunk *starts with* the
        remaining feed is a valid partial source: only its first ``use``
        positions are read).  ``peek`` skips LRU stamping (admissibility
        probes must not perturb eviction order).
        """
        toks = [int(t) for t in tokens]
        stamp = None if peek else self._tick()
        node = self.root
        fulls: List[int] = []
        i = 0
        while i + self.ps <= len(toks):
            child = node.children.get(tuple(toks[i:i + self.ps]))
            if child is None:
                break
            node = child
            fulls.append(child.page)
            i += self.ps
            if stamp is not None:
                node.stamp = stamp
        rest = toks[i:i + self.ps]
        tail: Optional[Tuple[int, int]] = None
        best, winner = 0, None
        for ptoks, ent in node.partials.items():
            use = _common_prefix(ptoks, rest)
            if use > best:
                best, tail, winner = use, (ent[0], use), ent
        for chunk, child in node.children.items():
            use = _common_prefix(chunk, rest)
            if use > best:
                best, tail, winner = use, (child.page, use), child
        if stamp is not None and winner is not None:
            # stamp only the candidate actually returned: refreshing
            # losers would shield never-used pages from LRU eviction
            if isinstance(winner, _TrieNode):
                winner.stamp = stamp
            else:
                winner[2] = stamp
        return fulls, tail

    def insert(self, tokens, pages: List[int], n_tokens: int) -> None:
        """Index ``pages`` as holding K/V for tokens[:n_tokens].

        Full pages become tree nodes; a trailing partial page becomes a
        partial entry at its node.  The tree increfs each page it newly
        claims; chunks already indexed (by this row earlier, or by a
        concurrent row with identical content) are walked, not re-claimed
        — the caller's duplicate page simply stays private to it.
        """
        stamp = self._tick()
        node = self.root
        i, j = 0, 0
        n_tokens = min(n_tokens, len(tokens), len(pages) * self.ps)
        while i + self.ps <= n_tokens:
            chunk = tuple(int(t) for t in tokens[i:i + self.ps])
            child = node.children.get(chunk)
            if child is None:
                page = pages[j]
                self.alloc.incref(page)
                child = _TrieNode(chunk, page, node)
                node.children[chunk] = child
                self.stats["indexed_pages"] += 1
            child.stamp = stamp
            node = child
            i += self.ps
            j += 1
        fill = n_tokens - i
        if fill > 0:
            ptoks = tuple(int(t) for t in tokens[i:n_tokens])
            if ptoks not in node.partials:
                self.alloc.incref(pages[j])
                node.partials[ptoks] = [pages[j], fill, stamp]
                self.stats["indexed_pages"] += 1

    def evict(self, need: int) -> int:
        """Free >= ``need`` pages by dropping LRU entries whose page has
        no other holder.  Nodes go leaf-first (a parent becomes a leaf
        once its subtree is gone); returns how many pages were freed.

        One DFS per tree "level": each pass collects every currently
        evictable candidate and drops them in LRU order (evicting a leaf
        never un-leafs anything, so the batch stays valid); parents
        exposed by a pass are picked up by the next one."""
        freed = 0
        while freed < need:
            cands = []             # (stamp, node, partial_key_or_None)
            stack = [self.root]
            while stack:
                node = stack.pop()
                for ptoks, ent in node.partials.items():
                    if self.alloc.refcount(ent[0]) == 1:
                        cands.append((ent[2], node, ptoks))
                if node.page is not None and not node.children \
                        and not node.partials \
                        and self.alloc.refcount(node.page) == 1:
                    cands.append((node.stamp, node, None))
                stack.extend(node.children.values())
            if not cands:
                break
            cands.sort(key=lambda c: c[0])
            for _, node, pkey in cands:
                if freed >= need:
                    break
                if pkey is not None:
                    page = node.partials.pop(pkey)[0]
                else:
                    page = node.page
                    node.parent.children.pop(node.chunk)
                self.alloc.decref(page)
                self.stats["evictions"] += 1
                freed += 1
        return freed


@dataclasses.dataclass
class RowMeta:
    """Prefix-sharing bookkeeping for one admitted row.

    ``shared`` leading table slots are mapped by reference (read-only);
    ``hit_tokens`` cached positions were served from the prefix tree
    (the engine's prefill starts there instead of position 0).
    ``tail_page`` pins a partial-page gather source — the engine copies
    its first ``tail_use`` positions into the row's private boundary
    page (the COW copy) and then drops the pin (``drop_tail_ref``)."""
    shared: int = 0
    hit_tokens: int = 0
    tail_page: Optional[int] = None
    tail_use: int = 0


class PagedKVCache:
    """Row-indexed page-table bookkeeping over a PageAllocator.

    ``rows`` is the static decode-batch width; ``max_pages_per_seq`` the
    static table width (ceil(max_len / page_size)).  Device page pools
    are owned by the engine; this class only tracks who owns what.
    With ``prefix_cache=True`` a PrefixIndex dedups shared prompt
    prefixes across rows (see the module docstring for the refcount /
    copy-on-write lifecycle).
    """

    def __init__(self, num_pages: int, page_size: int, rows: int,
                 max_pages_per_seq: int, prefix_cache: bool = False,
                 metrics: Optional[MetricsRegistry] = None,
                 alloc: Optional[PageAllocator] = None,
                 page_quota: Optional[int] = None):
        self.page_size = page_size
        self.rows = rows
        self.maxp = max_pages_per_seq
        # `alloc` lets several caches (one per hosted model) share ONE
        # physical pool; `page_quota` caps how many distinct pages THIS
        # cache may hold at once — the per-tenant fairness knob of the
        # multi-model engine (None = bounded only by the pool).
        if alloc is not None and alloc.num_pages != num_pages:
            raise ValueError(f"shared allocator has {alloc.num_pages} "
                             f"pages, cache expects {num_pages}")
        self._shared_alloc = alloc is not None
        self.alloc = alloc if alloc is not None else PageAllocator(num_pages)
        if page_quota is not None and page_quota < 1:
            raise ValueError(f"page_quota must be >= 1: {page_quota}")
        self.page_quota = page_quota
        self.table = np.zeros((rows, max_pages_per_seq), np.int32)
        self.lengths = np.zeros((rows,), np.int32)
        self.row_pages: Dict[int, List[int]] = {}
        self.row_meta: Dict[int, RowMeta] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.prefix = PrefixIndex(page_size, self.alloc,
                                  metrics=self.metrics) if prefix_cache \
            else None
        # device page copies the engine must perform before the next
        # write to the pool (copy-on-write sources -> private targets)
        self.pending_copies: List[Tuple[int, int]] = []
        # kv.* registry counters behind the legacy short-key dict view
        self.stats = self.metrics.group("kv", keys=(
            "pages_fresh", "pages_shared", "cow_copies"))

    # ------------------------------------------------------------------
    @property
    def usable_pages(self) -> int:
        return self.alloc.num_pages - 1          # minus the trash page

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def pages_held(self) -> int:
        """Distinct physical pages this cache currently references: row
        tables, pinned gather tails, and prefix-tree entries.  This is
        the quantity ``page_quota`` bounds — on a shared allocator it is
        the cache's true pool footprint (holders across *different*
        caches never share a page: sharing happens only through a
        cache-private prefix tree)."""
        held = set()
        for pages in self.row_pages.values():
            held.update(pages)
        for meta in self.row_meta.values():
            if meta.tail_page is not None:
                held.add(meta.tail_page)
        if self.prefix is not None:
            held.update(self.prefix.pages())
        return len(held)

    def fits_ever(self, tokens: int) -> bool:
        """Could a request whose feed ever reaches ``tokens`` cached
        positions hold its working set in an otherwise empty pool?
        (Submit-time guard: prevents un-admittable requests from wedging
        the FIFO head forever — with this bound, an admission that keeps
        failing eventually succeeds once the pool drains.)"""
        cap = min(self.usable_pages, self.maxp)
        if self.page_quota is not None:
            cap = min(cap, self.page_quota)
        return self.pages_for(tokens) <= cap

    def can_admit(self, tokens: int, token_ids=None) -> bool:
        """Pages available right now to cache ``tokens`` prefilled
        positions AND address the first decode write at position
        ``tokens`` (pages_for(tokens + 1) covers both: one extra page
        exactly when the feed ends on a page boundary).  With a prefix
        index this is an *optimistic* gate: shared pages reduce the need
        and tree-held reclaimable pages extend the supply, but the two
        sets may overlap — callers must tolerate ``admit_row`` failing
        and re-queue (liveness holds: on a drained pool the estimate is
        exact, so a ``fits_ever`` request is eventually admitted)."""
        need = self.pages_for(tokens + 1)
        avail = self.alloc.num_free
        evictable = 0
        if self.prefix is not None:
            if token_ids is not None and tokens > 0:
                fulls, _ = self.prefix.match(token_ids, peek=True)
                need -= min(len(fulls), (tokens - 1) // self.page_size)
            evictable = self.prefix.evictable()
            avail += evictable
        if self.page_quota is not None:
            # optimistic quota gate mirroring the pool gate: prefix-hit
            # pages are already in the footprint (the tree holds them),
            # only the fresh `need` grows it, and quota-driven eviction
            # can shrink it by at most `evictable`
            if self.pages_held() - evictable + need > self.page_quota:
                return False
        return need <= avail

    def _alloc_or_evict(self, n: int) -> Optional[List[int]]:
        """Grant ``n`` fresh pages, evicting this cache's own prefix
        entries to satisfy pool pressure or the per-cache quota.  The
        quota gate lives here — the one chokepoint every fresh
        allocation (admission, decode growth, COW) funnels through —
        so shared/prefix mappings never charge against it (they do not
        grow the distinct-page footprint)."""
        if self.page_quota is not None and n > 0:
            over = self.pages_held() + n - self.page_quota
            if over > 0 and self.prefix is not None:
                # shed tree-only pages first: quota pressure should
                # reclaim cache, not refuse live work
                self.prefix.evict(over)
            if self.pages_held() + n > self.page_quota:
                return None
        got = self.alloc.alloc(n)
        if got is None and self.prefix is not None:
            self.prefix.evict(n - self.alloc.num_free)
            got = self.alloc.alloc(n)
        return got

    # ------------------------------------------------------------------
    def admit_row(self, row: int, tokens: int, token_ids=None) -> bool:
        """Bind ``row`` to pages covering ``tokens`` cached positions.
        False (nothing changed) if pages are short.

        With ``token_ids`` and a prefix index, leading pages whose full
        token chunk is already indexed are mapped **by reference**
        (shared, read-only) instead of freshly allocated; a partial-page
        source for the boundary is pinned for the engine to gather from
        (``gather_table``/``drop_tail_ref``).  The usable prefix is
        capped at tokens-1 so at least one position is always computed —
        prefill must produce last-token logits to sample from."""
        assert row not in self.row_pages, f"row {row} already bound"
        meta = RowMeta()
        shared: List[int] = []
        if self.prefix is not None and token_ids is not None and tokens > 1:
            fulls, tail = self.prefix.match(token_ids)
            cap = tokens - 1
            n_full = min(len(fulls), cap // self.page_size)
            shared = fulls[:n_full]
            tail_page, tail_use = None, 0
            if n_full < len(fulls):
                # cap dropped a matched full page: its leading positions
                # still serve as the boundary-page source (unless the
                # cap landed exactly on the page boundary)
                tail_use = cap - n_full * self.page_size
                tail_page = fulls[n_full] if tail_use > 0 else None
            elif tail is not None:
                tail_use = min(tail[1], cap - n_full * self.page_size)
                tail_page = tail[0] if tail_use > 0 else None
            for p in shared:
                self.alloc.incref(p)
            if tail_page is not None:
                self.alloc.incref(tail_page)
            meta = RowMeta(shared=len(shared),
                           hit_tokens=n_full * self.page_size + tail_use,
                           tail_page=tail_page, tail_use=tail_use)
        fresh = self._alloc_or_evict(self.pages_for(tokens) - len(shared))
        if fresh is None and meta.tail_page is not None:
            # the tail pin itself can hold the last reclaimable page
            # hostage (a drained pool whose every page the tree retains
            # for this very prompt): trade the partial-page reuse for
            # admission — unpin, making it evictable, and retry
            self.alloc.decref(meta.tail_page)
            meta = RowMeta(shared=meta.shared,
                           hit_tokens=len(shared) * self.page_size)
            fresh = self._alloc_or_evict(self.pages_for(tokens)
                                         - len(shared))
        if fresh is None:
            for p in shared:
                self.alloc.decref(p)
            return False
        pages = shared + fresh
        self.row_pages[row] = pages
        self.row_meta[row] = meta
        self.table[row, :] = TRASH_PAGE
        self.table[row, :len(pages)] = pages
        self.lengths[row] = tokens
        self.stats["pages_fresh"] += len(fresh)
        self.stats["pages_shared"] += len(shared)
        if self.prefix is not None and token_ids is not None:
            self.prefix.stats["hit_tokens"] += meta.hit_tokens
            self.prefix.stats["miss_tokens"] += tokens - meta.hit_tokens
        return True

    def gather_table(self, row: int) -> np.ndarray:
        """Page ids to gather the row's prefix K/V from: the row's own
        table with the boundary slot redirected to the pinned partial
        source.  Valid until ``drop_tail_ref``."""
        meta = self.row_meta[row]
        pids = self.table[row].copy()
        if meta.tail_page is not None:
            pids[meta.shared] = meta.tail_page
        return pids

    def drop_tail_ref(self, row: int) -> None:
        """Unpin the gather source once the engine dispatched the gather
        (device ordering keeps the read ahead of any later reuse)."""
        meta = self.row_meta[row]
        if meta.tail_page is not None:
            self.alloc.decref(meta.tail_page)
            meta.tail_page = None

    def first_private_page(self, row: int) -> int:
        """First table slot the row may write (everything before is
        mapped by reference)."""
        meta = self.row_meta.get(row)
        return meta.shared if meta is not None else 0

    # ------------------------------------------------------------------
    def ensure_decode_room(self, row: int) -> str:
        """Make position ``lengths[row]`` addressable AND writable (the
        next token's k/v write) — the single-token decode case of
        :meth:`ensure_room`."""
        return self.ensure_room(row, self.lengths[row] + 1)

    def ensure_room(self, row: int, upto: int) -> str:
        """Make positions ``lengths[row] .. upto-1`` addressable AND
        writable (a k/v write block — speculative verify writes k+1
        positions in one dispatch).  Allocates the page shortfall plus,
        when the write-cursor page is shared (refcount > 1), one more
        for a private copy-on-write replacement — the device copy is
        queued on ``pending_copies`` for the engine to drain before the
        write.  Only the cursor page needs the COW check: sharers (the
        prefix tree, sibling rows) only ever reference fully-cached
        pages, all at or before the cursor, and pages past it are fresh
        allocations or truncate-trimmed privates.  (The engine's
        admission discipline keeps shared pages strictly behind the
        write cursor, so the COW branch is its defense-in-depth
        backstop; the stateful refcount tests drive it directly.)
        Returns:

        - "ok"   — every position addressable and privately writable,
        - "oom"  — pool exhausted (caller preempts a row and retries),
        - "full" — table width (max_len) hit (caller force-retires).
        """
        need = self.pages_for(upto)
        pages = self.row_pages[row]
        if len(pages) < need:
            if need > self.maxp:
                return "full"
            got = self._alloc_or_evict(need - len(pages))
            if got is None:
                return "oom"
            self.table[row, len(pages):need] = got
            pages.extend(got)
        j = self.lengths[row] // self.page_size
        if self.alloc.refcount(pages[j]) > 1:
            got = self._alloc_or_evict(1)
            if got is None:
                return "oom"
            old, new = pages[j], got[0]
            self.pending_copies.append((old, new))
            # the remaining holder (tree / other row) keeps `old` alive
            # until the engine performs the queued device copy
            self.alloc.decref(old)
            pages[j] = new
            self.table[row, j] = new
            meta = self.row_meta.get(row)
            if meta is not None and j < meta.shared:
                meta.shared = j
            self.stats["cow_copies"] += 1
        return "ok"

    def advance(self, row: int) -> None:
        self.lengths[row] += 1

    def truncate_row(self, row: int, keep_tokens: int) -> None:
        """Roll the row back to at most ``keep_tokens`` cached
        positions, freeing pages wholly past the new end (speculative
        rollback).  Popped pages are always privately held: rollback
        only ever discards positions past the last committed token, and
        nothing past the commit point is ever published to the prefix
        tree or mapped by another row."""
        keep = self.pages_for(keep_tokens)
        pages = self.row_pages[row]
        while len(pages) > keep:
            p = pages.pop()
            assert self.alloc.refcount(p) == 1, \
                f"truncating shared page {p} of row {row}"
            self.alloc.free([p])
            self.table[row, len(pages)] = TRASH_PAGE
        if self.lengths[row] > keep_tokens:
            self.lengths[row] = keep_tokens

    def release_row(self, row: int) -> None:
        """Drop the row's references.  Shared pages survive while other
        holders (the prefix tree, concurrent rows) remain."""
        pages = self.row_pages.pop(row)
        meta = self.row_meta.pop(row, None)
        if meta is not None and meta.tail_page is not None:
            self.alloc.decref(meta.tail_page)
        self.alloc.free(pages)
        self.table[row, :] = TRASH_PAGE
        self.lengths[row] = 0

    def index_row(self, row: int, token_ids, n_tokens: int) -> None:
        """Publish the row's first ``n_tokens`` cached positions to the
        prefix tree (token_ids spell their content).  No-op without a
        prefix index."""
        if self.prefix is None or row not in self.row_pages or n_tokens <= 0:
            return
        self.prefix.insert(token_ids, self.row_pages[row], n_tokens)

    def prefix_stats(self) -> Dict[str, float]:
        out = dict(self.stats)
        if self.prefix is not None:
            out.update(self.prefix.stats)
            total = out["hit_tokens"] + out["miss_tokens"]
            out["prefix_hit_rate"] = out["hit_tokens"] / total if total \
                else 0.0
            out["trie_pages"] = self.prefix.num_pages
        denom = out["pages_fresh"] + out["pages_shared"]
        out["pages_saved_frac"] = out["pages_shared"] / denom if denom \
            else 0.0
        return out

    def leak_check(self) -> None:
        """Refcounts match holders exactly: every allocated page is held
        by the rows mapping it + the prefix tree + pending gather pins,
        no free page is referenced, and free + used == usable."""
        refs: Counter = Counter()
        for pages in self.row_pages.values():
            assert len(pages) == len(set(pages)), \
                "row maps a page twice"
            refs.update(pages)
        for meta in self.row_meta.values():
            if meta.tail_page is not None:
                refs[meta.tail_page] += 1
        if self.prefix is not None:
            tree_pages = list(self.prefix.pages())
            assert len(tree_pages) == len(set(tree_pages)), \
                "prefix tree claims a page twice"
            refs.update(tree_pages)
        assert TRASH_PAGE not in refs, "trash page was allocated"
        held = {p: self.alloc.refcount(p) for p in refs}
        assert all(c > 0 for c in held.values()), "holder of a free page"
        assert dict(refs) == held, (dict(refs), held)
        if self._shared_alloc:
            # sibling caches hold the rest of num_used; pages are still
            # disjoint across caches (per-page equality above proves no
            # foreign holder on OUR pages)
            assert len(refs) <= self.alloc.num_used, \
                (len(refs), self.alloc.num_used)
        else:
            assert len(refs) == self.alloc.num_used, \
                (len(refs), self.alloc.num_used)
        assert self.alloc.num_free + self.alloc.num_used \
            == self.usable_pages
        if self.page_quota is not None:
            assert len(refs) <= self.page_quota, \
                (len(refs), self.page_quota)
