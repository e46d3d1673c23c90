"""Paged KV cache: the port of `attention_tpu.ops.paged`.

KV lives in pools of fixed-size pages, (P, Hkv, page_size, d), shared by
every sequence; a per-sequence page table maps logical cache blocks to
physical pages (`PagedKV`).  `PagePool` is the host-side refcounted
free-list allocator that hands out the pages.

`paged_flash_decode` scores one token (or, with a 4-D ``q``, an
appended chunk) per sequence through the table: for CUDA tensors it
launches the Hopper kernel ``csrc/paged_decode.cu`` (which replaces the
TPU kernel `_paged_kernel`), for CPU tensors it runs
`paged_flash_decode_plain`; on the card it splits each sequence's keys
across CTAs as the dense kernel does (`ops.decode.split_plan`).
`paged_sink_decode` composes its partials
output with a rotated read copy of the sink rows.  `paged_append`,
`paged_append_chunk` and `paged_from_dense` write into the pools; the
appends write in place (the pools are the caller's, and a copy per
layer per step would double the cache traffic) with the JAX version's
drop and sticky ``-1`` poison rules.  `paged_fork` forks one sequence
into several that share its full pages (parallel sampling over one
prompt), and `recommended_page_size` picks a pool's page size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from attention_tpu_torch.ops import _native
from attention_tpu_torch.ops._native import DTYPE_CODES, MAX_HEAD_DIM, F, \
    I, L, P
from attention_tpu_torch.ops.decode import check_band, lengths_tensor, \
    split_launch
from attention_tpu_torch.ops.reference import check_softcap, \
    decode_reference
from attention_tpu_torch.ops.rope import apply_rope

KERNEL = "paged_decode"
_ARGTYPES = [P] * 10 + [I] * 9 + [L] * 6 + [I, I, F, F, I, I, P]


class PagedKV(NamedTuple):
    """Paged KV state: shared pools plus per-sequence translation.

    ``k_pool``/``v_pool``: (P, Hkv, page_size, d).  ``page_table``:
    (B, max_pages) int32 physical page ids (-1 for an unclaimed entry;
    entries past the used prefix are ignored).  ``lengths``: (B,) int32
    valid tokens (-1 for a poisoned sequence)."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor

    @property
    def length(self):
        """Per-sequence lengths (the name every cache type shares, so the
        RoPE offsets need no special case)."""
        return self.lengths

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[2]

    @property
    def max_tokens(self) -> int:
        return self.page_table.shape[1] * self.page_size


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

    def table_row(self, pages: list[int], max_pages: int) -> torch.Tensor:
        """A fixed-width (``max_pages``,) int32 table row of ``pages``;
        unused entries hold the -1 sentinel (the kernel never follows
        one; an append that lands on one poisons its sequence)."""
        if len(pages) > max_pages:
            raise ValueError(f"{len(pages)} pages > max_pages {max_pages}")
        return torch.tensor(list(pages) + [-1] * (max_pages - len(pages)),
                            dtype=torch.int32)


def recommended_page_size(cache_len: int) -> int:
    """Page size to build a pool with for a capacity of ``cache_len``:
    the largest power-of-two page up to 2048 that divides it (a page
    must divide the capacity for `paged_from_dense`), else 128. The JAX
    package looks a tuned page up first, keyed on the serving shape; the
    port has no tuning table, so it takes the capacity alone."""
    for page in (2048, 1024, 512, 256):
        if cache_len % page == 0:
            return page
    return 128


def _validate(q: torch.Tensor, cache: PagedKV) -> None:
    if q.dim() not in (3, 4):
        raise ValueError(f"expected q (B,H,d) or (B,H,S,d), got "
                         f"{tuple(q.shape)}")
    b, h, d = q.shape[0], q.shape[1], q.shape[-1]
    p_, hkv, page, dk = cache.k_pool.shape
    if (dk != d or tuple(cache.v_pool.shape[:3]) != (p_, hkv, page)
            or cache.page_table.dim() != 2
            or cache.page_table.shape[0] != b):
        raise ValueError(
            f"paged cache shapes inconsistent: Q{tuple(q.shape)} "
            f"K{tuple(cache.k_pool.shape)} V{tuple(cache.v_pool.shape)} "
            f"table{tuple(cache.page_table.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")


def paged_flash_decode_plain(q, cache: PagedKV, *, scale=None, softcap=None,
                             window=None, sinks=None, return_stats=False):
    """The plain PyTorch version of `paged_flash_decode`: each sequence's
    whole table gathered into a dense cache (a ``-1`` entry reads page
    0, as the kernel does), then the decode arithmetic of
    `reference.decode_reference`."""
    _validate(q, cache)
    check_band(window, sinks)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    b, hkv = q.shape[0], cache.k_pool.shape[1]
    lens = lengths_tensor(cache.lengths, b, q.device)
    pages = cache.page_table.long().clamp(min=0)

    def dense(pool):  # (B, max_pages, Hkv, page, d) -> (B, Hkv, N, d)
        return pool[pages].transpose(1, 2).reshape(b, hkv, -1,
                                                   pool.shape[-1])

    q4 = q if q.dim() == 4 else q[:, :, None]
    res = decode_reference(q4, dense(cache.k_pool), dense(cache.v_pool),
                           lens, scale=scale, softcap=softcap, window=window,
                           sinks=sinks, partials=return_stats)
    if return_stats:
        return tuple(t[:, :, 0] for t in res)
    poisoned = (lens < 0)[:, None, None, None]
    res = torch.where(poisoned, torch.full_like(res, float("nan")), res)
    return res if q.dim() == 4 else res[:, :, 0]


def _launch(q4, cache, lens, *, scale, softcap, window, sinks, stats):
    dtype = cache.v_pool.dtype
    if (dtype not in DTYPE_CODES or q4.dtype != dtype
            or cache.k_pool.dtype != dtype):
        raise TypeError(
            f"paged kernel takes float32 or bfloat16 q/pools of one "
            f"dtype, got {q4.dtype}/{cache.k_pool.dtype}/{dtype}")
    table = cache.page_table
    if any(t.device != q4.device
           for t in (cache.k_pool, cache.v_pool, table)):
        raise ValueError("q, the pools and the page table must be on one "
                         "device")
    if table.dtype != torch.int32 or not table.is_contiguous():
        raise TypeError("the page table must be contiguous int32")
    if not (cache.k_pool.is_contiguous() and cache.v_pool.is_contiguous()):
        raise ValueError("the K/V pools must be contiguous")
    b, h, s_new, d = q4.shape
    hkv, page = cache.k_pool.shape[1], cache.k_pool.shape[2]
    dv = cache.v_pool.shape[-1]
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
    if q4.stride(-1) != 1:
        q4 = q4.contiguous()
    dev = q4.device
    if stats:
        out = torch.empty((b, h, s_new, dv), dtype=torch.float32,
                          device=dev)
        m, l_ = (torch.empty((b, h, s_new), dtype=torch.float32, device=dev)
                 for _ in range(2))
        ptrs = (0, out.data_ptr(), m.data_ptr(), l_.data_ptr())
    else:
        # (B, S, H, dv) storage: the attention layer's head merge is a view
        out = torch.empty((b, s_new, h, dv), dtype=dtype,
                          device=dev).transpose(1, 2)
        ptrs = (out.data_ptr(), 0, 0, 0)
    splits, chunk, part = split_launch(q4, hkv, table.shape[1] * page, dv,
                                       window)
    fn = _native.function(KERNEL, "paged_decode_fwd", _ARGTYPES)
    idx = dev.index  # an int takes torch.cuda's short path
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(idx).cuda_stream
        err = fn(q4.data_ptr(), cache.k_pool.data_ptr(),
                 cache.v_pool.data_ptr(), table.data_ptr(), lens.data_ptr(),
                 *ptrs, 0 if part is None else part.data_ptr(),
                 DTYPE_CODES[dtype], b, h, hkv, s_new, table.shape[1],
                 page, d, dv, *q4.stride()[:3], *out.stride()[:3],
                 window or 0, sinks or 0, float(scale),
                 float(softcap or 0.0), splits, chunk, stream)
    _native.check(KERNEL, err)
    _native.count_launch(KERNEL)
    return (out, m, l_) if stats else out


def paged_flash_decode(q: torch.Tensor, cache: PagedKV, *,
                       scale: float | None = None,
                       softcap: float | None = None,
                       window: int | None = None, sinks: int | None = None,
                       return_stats: bool = False):
    """softmax(q K[:len]ᵀ · scale) V[:len] through the page table: q
    (B, H, d) -> (B, H, dv).

    ``window``/``sinks``: the per-sequence band of `ops.decode.
    flash_decode`, on logical positions before page translation.  A 4-D
    ``q`` (B, H, S, d) is chunk mode (`flash_decode_chunk` semantics):
    the S rows are already appended through the table, ``lengths`` is
    the post-append length -> (B, H, S, dv).  A sequence with a negative
    length (poisoned by an append) comes out NaN; a ``-1`` table entry
    is never followed.  ``return_stats`` (decode mode only) returns the
    float32 (unnormalized output, row max in natural log, row sum), the
    merge hook of `paged_sink_decode`.  CUDA tensors run the Hopper
    kernel, CPU tensors `paged_flash_decode_plain`."""
    check_softcap(softcap)
    check_band(window, sinks)
    _validate(q, cache)
    chunk = q.dim() == 4
    if chunk and return_stats:
        raise ValueError(
            "return_stats (the paged_sink_decode merge hook) is a "
            "decode-step feature; chunk mode has no sink-merge path")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    kw = dict(scale=scale, softcap=softcap, window=window, sinks=sinks)
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, cache, return_stats=return_stats,
                                        **kw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on cuda or cpu, not "
                         f"{q.device.type}")
    lens = lengths_tensor(cache.lengths, q.shape[0], q.device)
    out = _launch(q if chunk else q[:, :, None], cache, lens,
                  stats=return_stats, **kw)
    if return_stats:
        return tuple(t[:, :, 0] for t in out)
    return out if chunk else out[:, :, 0]


def paged_sink_decode(q: torch.Tensor, cache: PagedKV, *, window: int,
                      sinks: int, theta: float = 10000.0,
                      scale: float | None = None,
                      softcap: float | None = None) -> torch.Tensor:
    """Windowed rope+sinks decode through the page table: q (B, H, d) ->
    (B, H, dv).

    The sink KEY rows must be re-rotated by a per-sequence delta, but
    pool pages may be shared across sequences, so they stay read-only:
    each sequence's first ``sinks`` rows are copied out of its first
    logical page and rotated by ``delta = max(len - (window + sinks),
    0)``.  The paged kernel's partials over the window band and the
    sink copy's partials merge with the online-softmax rescale.  Sink
    rows inside the band (only while delta == 0, where the rotation is
    a no-op) are masked out of the copy, so nothing counts twice."""
    check_band(window, sinks)
    if sinks is None or window is None:
        raise ValueError("paged_sink_decode requires window and sinks")
    page = cache.page_size
    if sinks > page:
        raise ValueError(
            f"sinks {sinks} > page_size {page}: sink rows must fit the "
            "first logical page")
    b, h, d = q.shape
    group = h // cache.k_pool.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out_a, m_a, l_a = paged_flash_decode(
        q, cache, scale=scale, softcap=softcap, window=window,
        return_stats=True)

    lens_raw = lengths_tensor(cache.lengths, b, q.device).long()
    lens = lens_raw.clamp(min=0)
    first = cache.page_table[:, 0].long().clamp(min=0)
    k_sink = cache.k_pool[first, :, :sinks].float()    # (B, Hkv, sinks, d)
    v_sink = cache.v_pool[first, :, :sinks].float()
    delta = (lens - (window + sinks)).clamp(min=0)
    k_rot = apply_rope(k_sink, delta[:, None, None], theta)
    k_rot = k_rot.repeat_interleave(group, dim=1)
    v_sink = v_sink.repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k_rot) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    lim = torch.minimum((lens - window).clamp(min=0), lens).clamp(max=sinks)
    mask = torch.arange(sinks, device=q.device)[None, None] < lim[:, None,
                                                                  None]
    s = s.masked_fill(~mask, float("-inf"))
    m_b = s.amax(dim=-1)
    p = torch.where(m_b[..., None] == float("-inf"), torch.zeros_like(s),
                    torch.exp(s - m_b[..., None]))
    l_b = p.sum(dim=-1)
    out_b = torch.einsum("bhs,bhsd->bhd", p, v_sink)

    m = torch.maximum(m_a, m_b)
    c_a = torch.where(m_a == float("-inf"), torch.zeros_like(m),
                      torch.exp(m_a - m))
    c_b = torch.where(m_b == float("-inf"), torch.zeros_like(m),
                      torch.exp(m_b - m))
    l_ = l_a * c_a + l_b * c_b
    l_ = torch.where(l_ == 0.0, torch.ones_like(l_), l_)
    out = (out_a * c_a[..., None] + out_b * c_b[..., None]) / l_[..., None]
    out = torch.where((lens_raw < 0)[:, None, None],
                      torch.full_like(out, float("nan")), out)
    return out.to(cache.v_pool.dtype)


def paged_append_chunk(cache: PagedKV, k_new: torch.Tensor,
                       v_new: torch.Tensor) -> PagedKV:
    """Write S new rows per sequence (k/v (B, Hkv, S, d)) at each
    sequence's next slots, in place in the pools; returns the cache with
    lengths + S.

    The rows' pages must already be in the table.  The JAX version's
    row-by-row contract, vectorised: the first row that lands past the
    table's capacity or on an unclaimed (-1) entry, and every later row
    of its sequence, writes nothing, and the sequence's length becomes
    -1 (sticky: a poisoned sequence writes nothing more).  Rollback
    after rejected drafts is a length rewind by the caller."""
    if (k_new.dim() != 4 or v_new.dim() != 4
            or k_new.shape[:3] != v_new.shape[:3]):
        # head dims may differ (dk != dv caches are supported throughout)
        raise ValueError(
            f"expected (B, Hkv, S, d) chunks: K{tuple(k_new.shape)} "
            f"V{tuple(v_new.shape)}")
    b, _, s_new, _ = k_new.shape
    page = cache.page_size
    max_pages = cache.page_table.shape[1]
    lens = lengths_tensor(cache.lengths, b, k_new.device).long()
    pos = lens.clamp(min=0)[:, None] + torch.arange(s_new,
                                                    device=k_new.device)
    logical = torch.div(pos, page, rounding_mode="floor")
    phys = cache.page_table.long().gather(1, logical.clamp(max=max_pages - 1))
    bad = (lens[:, None] < 0) | (logical >= max_pages) | (phys < 0)
    bad = torch.cumsum(bad, dim=1) > 0      # the first bad row stops the rest
    keep = ~bad
    pages, rows = phys[keep], (pos % page)[keep]
    for pool, new in ((cache.k_pool, k_new), (cache.v_pool, v_new)):
        pool[pages, :, rows] = new.transpose(1, 2)[keep].to(pool.dtype)
    new_lens = torch.where(bad[:, -1], torch.full_like(lens, -1),
                           lens + s_new)
    return cache._replace(lengths=new_lens.to(torch.int32))


def paged_append(cache: PagedKV, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> PagedKV:
    """Write one new token per sequence (k/v (B, Hkv, 1, d)) at each
    sequence's next slot, in place; returns the cache with lengths + 1
    (-1 where the slot is past the table or unclaimed: nothing is
    written there, and the decode then emits NaN for that sequence)."""
    if k_new.dim() != 4 or k_new.shape[2] != 1:
        raise ValueError(f"expected (B, Hkv, 1, d) rows: "
                         f"K{tuple(k_new.shape)}")
    return paged_append_chunk(cache, k_new, v_new)


def paged_from_dense(k_cache: torch.Tensor, v_cache: torch.Tensor, lengths,
                     pool: PagePool, *, num_pages: int, page_size: int = 128,
                     total_pages_per_seq: int | None = None) -> PagedKV:
    """Scatter dense (B, Hkv, N, d) prefill caches into fresh pools: each
    sequence claims ceil(len/page) pages from ``pool`` (at least one),
    or exactly ``total_pages_per_seq`` (>= used) to reserve decode
    headroom up front.  Unused table entries hold -1.  The caller keeps
    the `PagePool` (and the returned table) for later ``free``."""
    b, hkv, n, d = k_cache.shape
    if n % page_size:
        raise ValueError(f"capacity {n} not a multiple of {page_size}")
    if page_size % 128:
        raise ValueError(f"page_size {page_size} must be a 128-multiple")
    max_pages = n // page_size
    lens = lengths_tensor(lengths, b, k_cache.device)
    rows = torch.full((b, max_pages), -1, dtype=torch.int32)
    phys_ids, src_bi, src_lp = [], [], []
    for bi, length in enumerate(lens.tolist()):
        used = max(-(-length // page_size), 1)
        total = used if total_pages_per_seq is None else total_pages_per_seq
        if total < used or total > max_pages:
            raise ValueError(
                f"total_pages_per_seq {total} outside [{used}, {max_pages}]")
        pages = pool.alloc(total)
        rows[bi, :total] = torch.tensor(pages, dtype=torch.int32)
        phys_ids.extend(pages[:used])
        src_bi.extend([bi] * used)
        src_lp.extend(range(used))

    dev = k_cache.device
    ids, sb, sl = (torch.tensor(x, dtype=torch.long, device=dev)
                   for x in (phys_ids, src_bi, src_lp))
    pools = []
    for cache in (k_cache, v_cache):
        # (B, max_pages, Hkv, page, d) view -> one gather + one scatter
        src = cache.reshape(b, hkv, max_pages, page_size, -1).transpose(1, 2)
        pool_t = torch.zeros((num_pages, hkv, page_size, cache.shape[-1]),
                             dtype=cache.dtype, device=dev)
        pool_t[ids] = src[sb, sl]
        pools.append(pool_t)
    return PagedKV(pools[0], pools[1], rows.to(dev), lens)


def paged_fork(cache: PagedKV, pool: PagePool, src_row: int, n_copies: int,
               *, reserve_pages: int = 0) -> PagedKV:
    """Fork sequence ``src_row`` into ``n_copies`` new sequences that share
    its full prefix pages (vLLM's parallel sampling over one prompt).

    Full pages are shared by reference (``pool.incref``); the partial
    tail page, the only one a later append can touch, is copied into a
    private page per fork, so shared pages stay read-only and no copy on
    write is ever needed.  ``reserve_pages`` claims that many more
    private pages per fork up front, as decode headroom.  Every claim is
    rolled back if the pool runs out partway.  Returns a cache whose
    batch is the forks, over the same pool tensors (the tails are copied
    into them in place, in one index copy each); the source row stays
    valid in ``cache`` and keeps its own references."""
    if n_copies < 1:
        raise ValueError(f"n_copies must be >= 1, got {n_copies}")
    b = cache.page_table.shape[0]
    if not (0 <= src_row < b):
        raise ValueError(f"src_row {src_row} outside [0, {b})")
    page = cache.page_size
    length = int(cache.lengths[src_row])
    if length < 0:
        raise ValueError(f"src_row {src_row} is poisoned (length < 0)")
    row = cache.page_table[src_row].tolist()
    full, has_partial = length // page, length % page != 0
    shared = row[:full]
    max_pages = cache.page_table.shape[1]
    tail_after = full + has_partial
    if tail_after + reserve_pages > max_pages:
        raise ValueError(
            f"reserve_pages {reserve_pages} overflows the table "
            f"({tail_after} + {reserve_pages} > {max_pages})")

    # claim everything first, with rollback, so that running out of pages
    # partway leaks no reference and no page
    increfs, allocs = [], []
    rows = torch.full((n_copies, max_pages), -1, dtype=torch.int32)
    try:
        for c in range(n_copies):
            pool.incref(shared)
            increfs.append(shared)
            tail = pool.alloc(int(has_partial))
            allocs += tail
            extra = pool.alloc(reserve_pages)
            allocs += extra
            rows[c, :tail_after + reserve_pages] = torch.tensor(
                shared + tail + extra, dtype=torch.int32)
    except (OutOfPagesError, PageAccountingError):
        for pages in increfs:
            pool.free(pages)
        pool.free(allocs)
        raise

    dev = cache.page_table.device
    if has_partial:
        # one batched copy a pool: every fork's private tail = src's tail
        ids = rows[:, full].to(dev, torch.long)
        for pool_t in (cache.k_pool, cache.v_pool):
            pool_t[ids] = pool_t[row[full]].clone()
    lengths = torch.full((n_copies,), length, dtype=torch.int32, device=dev)
    return PagedKV(cache.k_pool, cache.v_pool, rows.to(dev), lengths)
