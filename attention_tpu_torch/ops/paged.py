"""Host-side page pool: the port of `attention_tpu.ops.paged`'s
`PagePool` and its typed errors (the paged decode kernel comes in a
later slice).

A refcounted free-list allocator over ``num_pages`` physical pages.  It
lives outside any kernel (allocation happens between steps) and hands
out page-id lists that become page-table rows; ``incref`` supports
prefix sharing — a page referenced by several sequences returns to the
free list only when every reference is freed.
"""

from __future__ import annotations


class OutOfPagesError(RuntimeError):
    """`PagePool.alloc` asked for more pages than the free list holds —
    the capacity-pressure signal the serving engine turns into prefix
    eviction, admission refusal or preemption-by-recompute."""


class PageAccountingError(ValueError):
    """Refcount misuse on a `PagePool`: double free, freeing or
    increfing a page that was never allocated, or an out-of-range page
    id — always a caller bug."""


class PagePool:
    """Host-side refcounted free-list allocator over ``num_pages``
    physical pages."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._refs = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        """Current reference count of one page (0 = free)."""
        if not (0 <= page < self.num_pages):
            raise PageAccountingError(f"bad page id {page}")
        return self._refs[page]

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPagesError(
                f"page pool exhausted: want {n}, free {len(self._free)}"
            )
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, pages) -> None:
        """Add a reference to already-allocated pages (prefix sharing)."""
        for p in pages:
            if not (0 <= p < self.num_pages) or self._refs[p] == 0:
                raise PageAccountingError(f"incref of unallocated page {p}")
            self._refs[p] += 1

    def free(self, pages) -> None:
        """Drop one reference per page; recycle at refcount zero."""
        for p in pages:
            if not (0 <= p < self.num_pages):
                raise PageAccountingError(f"bad page id {p}")
            if self._refs[p] == 0:
                raise PageAccountingError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
