"""Block allocator with a hash-keyed prefix cache over `PagePool` — the
port of `attention_tpu.engine.allocator` (same policy, no telemetry).

The engine's memory layer.  One logical `PagePool` serves every model
layer: the engine keeps per-layer physical pools (same page geometry),
so a single page-id allocation is valid in all of them and one table
row per request drives the whole stack — exactly the id discipline
`generate_paged` already uses (its per-layer pools replay identical
allocation sequences).

Prefix cache (vLLM-style, page granularity): committed prompt pages
are published under a content key — ``tuple(tokens[:i * page_size])``
for the i-th page, i.e. the exact token prefix the page's KV encodes —
and a later request whose prompt starts with the same tokens adopts
the pages by reference (`PagePool.incref`) instead of recomputing
them.  Exact-tuple keys rather than a digest: collisions would silently
serve another prompt's KV, and at serving-trace scale the dict is
small.  The cache holds its own reference on every published page, so
pages survive their computing request; eviction is LRU over *leaf*
entries nobody else references (refcount 1 = cache-only), which keeps
chains consistent — a parent page is only evictable after every longer
prefix built on it is gone.

Watermark: admission-path allocations must leave ``watermark_pages``
free (a reserve so already-running requests can keep appending decode
tokens); decode-path allocations may drain the reserve, then the
cache, and only then fail — the scheduler turns that failure into
preemption-by-recompute.
"""

from __future__ import annotations

import dataclasses

from attention_tpu_torch.ops.paged import OutOfPagesError, PagePool



def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` KV rows (>= 1 row per page)."""
    return -(-n_tokens // page_size)


@dataclasses.dataclass
class _PrefixEntry:
    key: tuple[int, ...]          # the token prefix this page completes
    page: int                     # physical page holding its last page's KV
    parent: tuple[int, ...] | None
    children: set = dataclasses.field(default_factory=set)
    last_use: int = 0


class BlockAllocator:
    """Watermark-guarded page allocation + prefix cache for one pool."""

    def __init__(self, pool: PagePool, page_size: int, *,
                 watermark_pages: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if not (0 <= watermark_pages < pool.num_pages):
            raise ValueError(
                f"watermark_pages {watermark_pages} outside "
                f"[0, {pool.num_pages})"
            )
        self.pool = pool
        self.page_size = page_size
        self.watermark_pages = watermark_pages
        self._prefix: dict[tuple[int, ...], _PrefixEntry] = {}
        # counters the metrics layer reports
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0

    # -- capacity ---------------------------------------------------------

    @property
    def cached_pages(self) -> int:
        return len(self._prefix)

    def _evictable(self) -> list[_PrefixEntry]:
        """Leaf entries whose page only the cache references."""
        return [
            e for e in self._prefix.values()
            if not e.children and self.pool.refcount(e.page) == 1
        ]

    def evict_lru(self) -> int | None:
        """Evict the least-recently-used evictable prefix page; returns
        the freed page id, or None when nothing is evictable."""
        victims = self._evictable()
        if not victims:
            return None
        victim = min(victims, key=lambda e: (e.last_use, e.key))
        del self._prefix[victim.key]
        if victim.parent is not None and victim.parent in self._prefix:
            self._prefix[victim.parent].children.discard(victim.key)
        self.pool.free([victim.page])
        self.prefix_evictions += 1
        return victim.page

    def allocate(self, n: int, *, for_decode: bool = False) -> list[int]:
        """Allocate ``n`` pages, evicting LRU prefix pages as needed.

        Admission/prefill calls (``for_decode=False``) must leave the
        watermark reserve free *after* the allocation; decode appends
        may drain it.  Raises `OutOfPagesError` when even full eviction
        cannot satisfy the request — the scheduler's preemption signal.
        """
        if n == 0:
            return []
        reserve = 0 if for_decode else self.watermark_pages
        # evict until the allocation fits above the reserve; evicting a
        # leaf can expose its parent, so the loop re-scans each round
        while self.pool.free_pages < n + reserve:
            if self.evict_lru() is None:
                raise OutOfPagesError(
                    f"allocation of {n} page(s) would breach the "
                    f"{'decode floor' if for_decode else 'watermark'}"
                    f": free {self.pool.free_pages}, nothing "
                    f"evictable, reserve {reserve}"
                )
        return self.pool.alloc(n)

    def free(self, pages) -> None:
        """Drop the caller's reference on ``pages`` (cache references,
        if any, keep prefix pages alive for future hits)."""
        self.pool.free(pages)

    # -- prefix cache -----------------------------------------------------

    def lookup_prefix(self, tokens, *, now: int) -> list[int]:
        """Longest cached page-aligned prefix of ``tokens``; increfs and
        returns the matched pages (caller owns one reference each).

        At least one token is always left uncached — the last prompt
        token must run through the model to produce the logits the
        first sampled token comes from.
        """
        toks = tuple(tokens)
        limit = (len(toks) - 1) // self.page_size
        pages: list[int] = []
        for i in range(1, limit + 1):
            entry = self._prefix.get(toks[: i * self.page_size])
            if entry is None:
                break
            entry.last_use = now
            pages.append(entry.page)
        if pages:
            self.pool.incref(pages)
            self.prefix_hits += 1
            self.prefix_hit_tokens += len(pages) * self.page_size
        else:
            self.prefix_misses += 1
        return pages

    def commit_prefix(self, tokens, pages, *, now: int) -> int:
        """Publish every full page of ``tokens`` (whose KV now lives in
        ``pages``, logical order) into the cache; returns how many new
        entries were inserted.  Already-published prefixes are just
        touched — a concurrent identical prompt that missed keeps its
        private pages and the first publisher's copy stays canonical
        (content-identical, so reads through either id agree)."""
        toks = tuple(tokens)
        if len(pages) < len(toks) // self.page_size:
            raise ValueError(
                f"commit_prefix: {len(pages)} pages cannot cover "
                f"{len(toks) // self.page_size} full page(s) of tokens"
            )
        inserted = 0
        parent: tuple[int, ...] | None = None
        for i in range(1, len(toks) // self.page_size + 1):
            key = toks[: i * self.page_size]
            entry = self._prefix.get(key)
            if entry is None:
                page = pages[i - 1]
                self.pool.incref([page])  # the cache's own reference
                entry = _PrefixEntry(key=key, page=page, parent=parent,
                                     last_use=now)
                self._prefix[key] = entry
                if parent is not None and parent in self._prefix:
                    self._prefix[parent].children.add(key)
                inserted += 1
            else:
                entry.last_use = now
            parent = key
        return inserted
