"""Ring attention, the forward: the port of `attention_tpu.parallel.ring`.

Q and K/V are both sequence-sharded over a mesh axis.  K/V shards
rotate around the ring (`Mesh.ppermute`, JAX's ``lax.ppermute``) while
each rank merges the flash kernel's partials for its own Q block, one
call a step: after R steps every rank has attended its queries to the
whole sequence with only neighbour traffic and O(n/R) K/V per step.

The reference's ping-pong lives on in two forms: the per-step merge of
(contrib, lmax, lsum) is the rmax/rsum rescale of
`attention-mpi.c:179-181` across ring steps (`_merge_step`), and the next
shard's exchange is started before the step's kernel call and waited
for after it, the ``MPI_Ibcast``/compute overlap of
`attention-mpi.c:319-330`.

``schedule="zigzag"`` (causal only) gives rank d the sequence chunks (d,
2R-1-d), so every rank carries equal unmasked work at every step.  As
in JAX each rank makes three kernel calls a step: the fourth chunk pair
(q_lo, kv_hi) lies wholly in the queries' future and is skipped when
the schedule is built; of (q_lo, kv_lo) and (q_hi, kv_hi) the kernel's
causal range skips the tiles of whichever sees nothing this step, whose
partials come out as row max -inf and sum 0.

The kernel's masking surface flows through both schedules, as in JAX
(attention_tpu/parallel/ring.py:365-411, :547-580, :680): ``window`` and
``sinks`` in global positions through each call's ``kv_offset``, and
packed-sequence segment ids as global vectors that every rank holds,
padded (-1 for query rows, -2 for key rows: ids no real row holds), each
call slicing the ids of its rows and keys.  Under a window no step is
skipped: the launch counts stay R per call and 3R for zigzag.

Every rank passes the full tensors, takes its contiguous block of the
sequence at entry and returns the full output (an all_gather of the
blocks).  `ring_attention` is forward-only, as JAX's is.

`ring_attention_diff` trains through the ring with O(n/R) K/V memory in
both passes (JAX's custom VJPs `_ring_diff` and `_zig_diff`).  The
forward is the same schedule, saving each row's lse; the backward runs a
second ring in which each rank calls the backward kernels
(`flash_bwd.flash_backward`, with the step's ``q_offset``,
``kv_offset`` and ``kv_valid``, its gradients kept float32) on its
queries against the visiting shard, and float32 dK/dV buffers travel
with their shard (added to, then rotated), one last rotation sending
them home: each gradient rounds once, at the end.  With ``sinks`` the
kernels take the band alone (sink positions are absolute, and a call
with a ``kv_offset`` cannot name them), and `flash_bwd.sink_patch` adds
the sink pairs once per rank against shard 0's sink rows, its dK/dV into
shard 0's travelling buffer on the step where it is resident.  The
zigzag backward makes the forward's three chunk-pair calls a step.  The
model calls the local cores (`ring_diff_local`, `zigzag_diff_local`) on
its own block of the sequence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from attention_tpu_torch.ops.flash import (
    check_segments,
    check_window,
    flash_attention_partials,
)
from attention_tpu_torch.ops.flash_bwd import flash_backward, sink_patch
from attention_tpu_torch.parallel.kv_sharded import (
    _forward_only,
    _rows,
    _unported,
    pad_ids,
)
from attention_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    gather_blocks,
    ppermute_diff,
    shard_blocks,
    whole_layout,
)

NEG_INF = float("-inf")


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "sp",
    scale: float | None = None,
    block_sizes=None,
    causal: bool = False,
    softcap: float | None = None,
    schedule: str = "contiguous",
    window: int | None = None,
    sinks: int | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    max_mode: str = "bound",
) -> torch.Tensor:
    """Ring attention over a mesh axis; every rank returns the full
    output.

    Takes `flash_attention`'s 2-D/3-D/4-D shapes.  The sequence axes of
    Q and K/V are cut into one block per rank, padded to a multiple of
    the ring, padded keys masked by each step's ``kv_valid`` and padded
    query rows dropped.  ``schedule="zigzag"`` balances causal work (see
    the module docstring; self-attention shapes, m == n).  ``window``,
    ``sinks`` and segment ids ((m,) and (n,), 2-D and 3-D inputs) as
    `flash_attention` takes them, in global positions."""
    _unported(block_sizes=block_sizes, max_mode=max_mode)
    _forward_only(q, k, v)
    ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    check_window(causal, window, sinks, ids[0] is not None)
    seg = None if ids[0] is None else ids
    if mesh is None:
        mesh = default_mesh(axis_name)
    n_dev, idx = mesh.shape[axis_name], mesh.index(axis_name)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if schedule not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring schedule {schedule!r}")
    if schedule == "zigzag":
        if not causal:
            raise ValueError(
                "zigzag schedule only helps causal attention (non-causal "
                "ring work is already balanced); use schedule='contiguous'"
            )
        return _zigzag_ring(q, k, v, mesh=mesh, axis_name=axis_name,
                            scale=scale, softcap=softcap, window=window,
                            sinks=sinks, seg=seg, max_mode=max_mode)

    m, n = q.shape[-2], k.shape[-2]
    m_local, n_local = -(-m // n_dev), -(-n // n_dev)
    cfg = _RingCfg(axis_name=axis_name, n_dev=n_dev, n=n, m_local=m_local,
                   n_local=n_local, scale=scale, causal=causal,
                   softcap=softcap, window=window, sinks=sinks,
                   max_mode=max_mode)
    if seg is not None:
        # Q ids cut with Q's rows; K/V ids whole, sliced at each step
        seg = (pad_ids(seg[0], m_local * n_dev, -1)[
            idx * m_local:(idx + 1) * m_local],
               pad_ids(seg[1], n_local * n_dev, -2))
    out, _ = _ring_fwd_loop(_rows(q, idx * m_local, m_local),
                            _rows(k, idx * n_local, n_local),
                            _rows(v, idx * n_local, n_local), cfg, mesh,
                            seg=seg)
    return mesh.all_gather(out, axis_name, dim=-2)[..., :m, :]


class _RingCfg(NamedTuple):
    axis_name: str
    n_dev: int
    n: int
    m_local: int
    n_local: int
    scale: float
    causal: bool
    softcap: "float | None"
    window: "int | None" = None
    sinks: "int | None" = None
    max_mode: str = "bound"


def _ring_fwd_loop(q, k, v, cfg: _RingCfg, mesh: Mesh, seg=None):
    """Contiguous ring forward on this rank's blocks: the one copy of the
    rotate/merge schedule (`ring_attention` drops the lse, the training
    path will save it).  ``seg``: None, or (this block's query ids, the
    whole padded key ids), each step slicing the arriving shard's.
    Returns (normalised out in q's dtype, natural-log lse, -inf for a row
    that saw no key)."""
    idx = mesh.index(cfg.axis_name)
    perm = [(j, (j + 1) % cfg.n_dev) for j in range(cfg.n_dev)]
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32,
                      device=q.device)
    m_run = torch.full(q.shape[:-1], NEG_INF, device=q.device)
    l_run = torch.zeros(q.shape[:-1], device=q.device)
    k_cur, v_cur = k, v
    for t in range(cfg.n_dev):
        # prefetch-then-compute: the next shard's exchange is started
        # before this step's kernel call and waited for after it
        if t + 1 < cfg.n_dev:
            nxt = mesh.ppermute((k_cur, v_cur), cfg.axis_name, perm)
        shard = (idx - t) % cfg.n_dev
        ids = {} if seg is None else dict(
            q_segment_ids=seg[0], kv_segment_ids=seg[1][
                shard * cfg.n_local:(shard + 1) * cfg.n_local])
        parts = flash_attention_partials(
            q, k_cur, v_cur, scale=cfg.scale, causal=cfg.causal,
            q_offset=idx * cfg.m_local, kv_offset=shard * cfg.n_local,
            kv_valid=min(max(cfg.n - shard * cfg.n_local, 0), cfg.n_local),
            softcap=cfg.softcap, window=cfg.window, sinks=cfg.sinks,
            max_mode=cfg.max_mode, **ids)
        acc, m_run, l_run = _merge_step((acc, m_run, l_run), *parts)
        if t + 1 < cfg.n_dev:
            k_cur, v_cur = nxt.wait()
    return _finalize((acc, m_run, l_run), q.dtype)


def _merge_step(state, out_un, lmax, lsum):
    """Online merge of one partials call into a running (acc, m, l)
    state: the rmax/rsum recurrence (`attention-mpi.c:179-181`) across
    ring steps; a call that saw nothing (row sum 0, whatever its row max:
    under "bound" that is finite) changes nothing."""
    acc, m_run, l_run = state
    lmax = torch.where(lsum == 0.0, NEG_INF, lmax)
    m_new = torch.maximum(m_run, lmax)
    c_old = torch.where(m_run == NEG_INF, 0.0, torch.exp(m_run - m_new))
    c_new = torch.where(lmax == NEG_INF, 0.0, torch.exp(lmax - m_new))
    return (acc * c_old[..., None] + out_un * c_new[..., None], m_new,
            l_run * c_old + lsum * c_new)


def _finalize(state, dtype):
    """(acc / l in ``dtype``, lse): a row that saw no key comes out zero
    with lse -inf."""
    acc, m_run, l_run = state
    l_safe = torch.where(l_run == 0.0, 1.0, l_run)
    out = (acc / l_safe[..., None]).to(dtype)
    lse = torch.where(l_run == 0.0, NEG_INF, m_run + torch.log(l_safe))
    return out, lse


def _zig_prepare(q, k, n_dev: int) -> int:
    """The zigzag preamble: the self-attention shape check, and the
    chunk (rows) of the sequence cut into 2R chunks after padding it to
    a multiple of 2R."""
    m, n = q.shape[-2], k.shape[-2]
    if m != n:
        raise ValueError(
            f"zigzag ring is self-attention-shaped (m == n), got {m} != {n}"
        )
    return -(-n // (2 * n_dev))


class _ZigCfg(NamedTuple):
    axis_name: str
    n_dev: int
    n: int
    chunk: int
    scale: float
    softcap: "float | None"
    window: "int | None" = None
    sinks: "int | None" = None
    max_mode: str = "bound"


def _zigzag_ring(q, k, v, *, mesh: Mesh, axis_name: str, scale, softcap,
                 window=None, sinks=None, seg=None, max_mode="bound"):
    """Causal ring attention with the zigzag layout (llama-3 style).

    The sequence is cut into 2R chunks; rank d holds chunks (d, 2R-1-d),
    one early and one late, so at every ring step each rank carries the
    same causal work, 2·C² scores (C = chunk rows): the early chunk's
    missing future work is made up by the late chunk's past work (the
    per-step analog of the reference's ±1-row owner balance,
    `attention-mpi.c:19-27`).  Each rank takes its contiguous block
    (chunks 2d, 2d+1), `_zigzag_exchange` trades it for its zigzag pair
    and back, and an all_gather of the blocks gives the full output.
    Segment ids (``seg``: the global (q, kv) pair) stay in global order,
    padded to the 2R chunks, and each chunk-pair call slices its chunks'
    ids by chunk id (JAX's `_zig_pad_ids` and `_zig_chunk_ids`)."""
    n_dev, idx = mesh.shape[axis_name], mesh.index(axis_name)
    chunk = _zig_prepare(q, k, n_dev)
    width = 2 * chunk
    blocks = [_rows(x, idx * width, width) for x in (q, k, v)]
    q_z, k_z, v_z = _zigzag_exchange(blocks, mesh, axis_name, n_dev, chunk)
    zcfg = _ZigCfg(axis_name=axis_name, n_dev=n_dev, n=k.shape[-2],
                   chunk=chunk, scale=scale, softcap=softcap, window=window,
                   sinks=sinks, max_mode=max_mode)
    if seg is not None:
        seg = (pad_ids(seg[0], 2 * n_dev * chunk, -1),
               pad_ids(seg[1], 2 * n_dev * chunk, -2))
    out_lo, _, out_hi, _ = _zig_fwd_loop(q_z, k_z, v_z, zcfg, mesh, seg=seg)
    out, = _zigzag_exchange([torch.cat([out_lo, out_hi], dim=-2)], mesh,
                            axis_name, n_dev, chunk, inverse=True)
    return mesh.all_gather(out, axis_name, dim=-2)[..., :q.shape[-2], :]


def _zig_slices(ndim: int, chunk: int):
    sl_lo = tuple([slice(None)] * (ndim - 2) + [slice(0, chunk)])
    sl_hi = tuple([slice(None)] * (ndim - 2) + [slice(chunk, None)])
    return sl_lo, sl_hi


def _zig_fwd_loop(q_local, k_local, v_local, z: _ZigCfg, mesh: Mesh,
                  seg=None):
    """The one copy of the zigzag rotate/merge schedule on this rank's
    (early, late) chunk pair.  ``seg``: None, or the global (q, kv) id
    vectors padded to the 2R chunks.  Returns (out_lo, lse_lo, out_hi,
    lse_hi) for its two chunks."""
    n_chunks = 2 * z.n_dev
    idx_d = mesh.index(z.axis_name)
    a = idx_d  # early chunk id
    b = n_chunks - 1 - idx_d  # late chunk id
    perm = [(j, (j + 1) % z.n_dev) for j in range(z.n_dev)]
    sl_lo, sl_hi = _zig_slices(q_local.dim(), z.chunk)
    q_lo, q_hi = q_local[sl_lo], q_local[sl_hi]

    def fresh(q_c):
        shape = q_c.shape[:-1]
        return (torch.zeros(shape + (v_local.shape[-1],),
                            dtype=torch.float32, device=q_c.device),
                torch.full(shape, NEG_INF, device=q_c.device),
                torch.zeros(shape, device=q_c.device))

    def partial_call(q_c, k_c, v_c, q_cid, kv_cid):
        ids = {} if seg is None else dict(
            q_segment_ids=seg[0][q_cid * z.chunk:(q_cid + 1) * z.chunk],
            kv_segment_ids=seg[1][kv_cid * z.chunk:(kv_cid + 1) * z.chunk])
        return flash_attention_partials(
            q_c, k_c, v_c, scale=z.scale, causal=True,
            q_offset=q_cid * z.chunk, kv_offset=kv_cid * z.chunk,
            kv_valid=min(max(z.n - kv_cid * z.chunk, 0), z.chunk),
            softcap=z.softcap, window=z.window, sinks=z.sinks,
            max_mode=z.max_mode, **ids)

    lo, hi = fresh(q_lo), fresh(q_hi)
    k_cur, v_cur = k_local, v_local
    for t in range(z.n_dev):
        if t + 1 < z.n_dev:
            nxt = mesh.ppermute((k_cur, v_cur), z.axis_name, perm)
        e = (idx_d - t) % z.n_dev  # whose chunk pair we hold now
        ae, be = e, n_chunks - 1 - e
        k_lo, k_hi = k_cur[sl_lo], k_cur[sl_hi]
        v_lo, v_hi = v_cur[sl_lo], v_cur[sl_hi]
        # (q_hi, kv_lo): always fully unmasked (b > ae)
        hi = _merge_step(hi, *partial_call(q_hi, k_lo, v_lo, b, ae))
        # (q_lo, kv_lo): sees keys iff ae <= a; else the kernel skips
        lo = _merge_step(lo, *partial_call(q_lo, k_lo, v_lo, a, ae))
        # (q_hi, kv_hi): sees keys iff be <= b; else the kernel skips
        hi = _merge_step(hi, *partial_call(q_hi, k_hi, v_hi, b, be))
        # (q_lo, kv_hi): empty by construction, never called
        if t + 1 < z.n_dev:
            k_cur, v_cur = nxt.wait()
    out_lo, lse_lo = _finalize(lo, q_lo.dtype)
    out_hi, lse_hi = _finalize(hi, q_hi.dtype)
    return out_lo, lse_lo, out_hi, lse_hi


def _zigzag_exchange(xs, mesh: Mesh, axis_name: str, n_dev: int,
                     chunk: int, *, inverse: bool = False):
    """Trade each rank's contiguous block (chunks 2d, 2d+1) of every
    tensor in ``xs`` for its zigzag pair (chunks r, 2R-1-r), or back with
    ``inverse``: two half-block ppermutes (`ppermute_diff`, so that
    autograd takes the inverse exchange back) and a per-rank choice of
    slot, with no global gather.  2R-1 is odd, so a rank's two zigzag chunks
    have opposite parity and the even-chunk and odd-chunk flows are each
    a permutation of the ranks."""
    n_chunks = 2 * n_dev
    sl_lo, sl_hi = _zig_slices(xs[0].dim(), chunk)
    even = mesh.index(axis_name) % 2 == 0

    def dest_of_chunk(c):
        return c if c < n_dev else n_chunks - 1 - c

    if not inverse:
        # chunk 2d to the rank that holds it in zigzag order, then 2d+1
        perm0 = [(d, dest_of_chunk(2 * d)) for d in range(n_dev)]
        perm1 = [(d, dest_of_chunk(2 * d + 1)) for d in range(n_dev)]
        arr0 = ppermute_diff([x[sl_lo] for x in xs], mesh, axis_name,
                             perm0)
        arr1 = ppermute_diff([x[sl_hi] for x in xs], mesh, axis_name,
                             perm1)
        # rank r's early chunk is r (parity r % 2), its late 2R-1-r
        pairs = zip(arr0, arr1) if even else zip(arr1, arr0)
        return [torch.cat(pair, dim=-2) for pair in pairs]
    # inverse: the even and odd chunks go back to contiguous rank c // 2
    evens = [x[sl_lo] if even else x[sl_hi] for x in xs]
    odds = [x[sl_hi] if even else x[sl_lo] for x in xs]
    perm_a = [(s, (s if s % 2 == 0 else n_chunks - 1 - s) // 2)
              for s in range(n_dev)]
    perm_b = [(s, ((n_chunks - 1 - s) if s % 2 == 0 else s) // 2)
              for s in range(n_dev)]
    arr_a = ppermute_diff(evens, mesh, axis_name, perm_a)  # chunk 2d
    arr_b = ppermute_diff(odds, mesh, axis_name, perm_b)  # chunk 2d+1
    return [torch.cat(pair, dim=-2) for pair in zip(arr_a, arr_b)]


def ring_attention_diff(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "sp",
    batch_axis: str | None = "dp",
    head_axis: str | None = "tp",
    scale: float | None = None,
    block_sizes=None,
    causal: bool = False,
    softcap: float | None = None,
    window: int | None = None,
    sinks: int | None = None,
    schedule: str = "contiguous",
    q_segment_ids=None,
    kv_segment_ids=None,
    max_mode: str = "bound",
) -> torch.Tensor:
    """Differentiable ring attention: O(n/R) K/V memory per rank in both
    passes (see the module docstring).

    (h, m, d) or (b, h, m, d) inputs, GQA, whole on every rank (every
    rank returns the whole output and, under autograd, the whole
    gradients, the same bits on each); the sequence axes are cut over
    ``axis_name`` after padding to a multiple of its size (of twice it
    for ``schedule="zigzag"``, self-attention shapes only), the batch and
    heads over ``batch_axis`` and ``head_axis`` where the mesh has them
    and they divide.  ``window`` (causal only), ``sinks`` (with a window,
    at most one shard or zigzag chunk of rows) and segment ids ((m,) and
    (n,), 3-D inputs) in global positions.  JAX's refusals, as
    `ValueError`: 2-D inputs, an unknown schedule, unpaired ids, ids on
    4-D inputs, sinks without a window or with ids, zigzag without
    causal, sinks larger than a shard or a chunk."""
    if mesh is None:
        mesh = default_mesh(axis_name)
    n_dev, idx = mesh.shape[axis_name], mesh.index(axis_name)
    if q.dim() not in (3, 4):
        raise ValueError(f"ring_attention_diff takes 3D/4D, got {q.dim()}D")
    if schedule not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring schedule {schedule!r}")
    q_ids, kv_ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    check_window(causal, window, sinks, q_ids is not None)
    if schedule == "zigzag" and not causal:
        raise ValueError("zigzag schedule requires causal=True")
    _unported(block_sizes=block_sizes, max_mode=max_mode)
    layout = whole_layout(q, k, mesh, axis_name, batch_axis, head_axis)
    m, n = q.shape[-2], k.shape[-2]
    kw = dict(mesh=mesh, axis_name=axis_name, scale=scale, causal=causal,
              softcap=softcap, window=window, sinks=sinks, kv_valid=n,
              max_mode=max_mode)
    if schedule == "zigzag":
        rows = 2 * n_dev * _zig_prepare(q, k, n_dev)
        blocks = shard_blocks([_rows(x, 0, rows) for x in (q, k, v)], mesh,
                              layout)
        if q_ids is not None:
            q_ids, kv_ids = pad_ids(q_ids, rows, -1), pad_ids(kv_ids, rows,
                                                              -2)
        out = zigzag_diff_local(*blocks, q_segment_ids=q_ids,
                                kv_segment_ids=kv_ids, **kw)
    else:
        m_local, n_local = -(-m // n_dev), -(-n // n_dev)
        blocks = shard_blocks(
            (_rows(q, 0, m_local * n_dev), _rows(k, 0, n_local * n_dev),
             _rows(v, 0, n_local * n_dev)), mesh, layout)
        if q_ids is not None:
            q_ids = pad_ids(q_ids, m_local * n_dev, -1)[
                idx * m_local:(idx + 1) * m_local]
            kv_ids = pad_ids(kv_ids, n_local * n_dev, -2)
        out = ring_diff_local(*blocks, q_segment_ids=q_ids,
                              kv_segment_ids=kv_ids, **kw)
    return gather_blocks(out, mesh, layout)[..., :m, :]


def ring_diff_local(q, k, v, *, mesh: Mesh, axis_name: str = "sp",
                    scale=None, causal: bool = False, softcap=None,
                    window=None, sinks=None, kv_valid=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    max_mode: str = "bound"):
    """The differentiable contiguous ring on this rank's blocks (JAX's
    `_ring_diff`, what it runs inside ``shard_map``).  ``kv_valid``
    masks a padded key tail (global count); ``q_segment_ids`` are this
    block's, ``kv_segment_ids`` the whole (padded) sequence's; each
    step's partials run under ``max_mode``.  Sinks must fit in one shard
    (`ValueError`)."""
    n_dev, n_local = mesh.shape[axis_name], k.shape[-2]
    if sinks is not None and sinks > n_local:
        raise ValueError(f"sinks ({sinks}) must fit in one KV shard "
                         f"({n_local} rows)")
    cfg = _RingCfg(
        axis_name=axis_name, n_dev=n_dev,
        n=n_dev * n_local if kv_valid is None else kv_valid,
        m_local=q.shape[-2], n_local=n_local,
        scale=1.0 / (q.shape[-1] ** 0.5) if scale is None else scale,
        causal=causal, softcap=softcap, window=window, sinks=sinks,
        max_mode=max_mode)
    return _RingDiff.apply(q, k, v, q_segment_ids, kv_segment_ids, cfg,
                           mesh)


def zigzag_diff_local(q, k, v, *, mesh: Mesh, axis_name: str = "sp",
                      scale=None, causal: bool = True, softcap=None,
                      window=None, sinks=None, kv_valid=None,
                      q_segment_ids=None, kv_segment_ids=None,
                      max_mode: str = "bound"):
    """The differentiable zigzag ring on this rank's contiguous blocks
    (chunks 2d, 2d+1, each half the block's rows): the exchange to the
    zigzag pair, JAX's `_zig_diff` and the exchange back, each
    differentiable.  ``kv_valid`` masks a padded key tail (global
    count); the segment ids are the global sequence's, padded to the 2R
    chunks.  JAX's refusals, as `ValueError`: an odd block, a schedule
    without causal, sinks larger than one chunk."""
    n_dev, rows = mesh.shape[axis_name], q.shape[-2]
    if rows % 2:
        raise ValueError(
            f"zigzag cuts each rank's {rows} rows into two chunks; pad the "
            f"sequence to a multiple of {2 * n_dev}")
    if not causal:
        raise ValueError("zigzag schedule requires causal=True")
    chunk = rows // 2
    if sinks is not None and sinks > chunk:
        raise ValueError(f"sinks ({sinks}) must fit in one zigzag chunk "
                         f"({chunk} rows)")
    z = _ZigCfg(axis_name=axis_name, n_dev=n_dev,
                n=n_dev * rows if kv_valid is None else kv_valid,
                chunk=chunk,
                scale=1.0 / (q.shape[-1] ** 0.5) if scale is None else scale,
                softcap=softcap, window=window, sinks=sinks,
                max_mode=max_mode)
    q_z, k_z, v_z = _zigzag_exchange([q, k, v], mesh, axis_name, n_dev,
                                     chunk)
    out = _ZigDiff.apply(q_z, k_z, v_z, q_segment_ids, kv_segment_ids, z,
                         mesh)
    out, = _zigzag_exchange([out], mesh, axis_name, n_dev, chunk,
                            inverse=True)
    return out


def _ids(seg, q_rows: slice | None, kv_rows: slice):
    """The segment-id keywords of one kernel call: ``seg``'s query ids
    (whole, or ``q_rows`` of them) and ``kv_rows`` of its key ids."""
    if seg is None:
        return {}
    q_ids = seg[0] if q_rows is None else seg[0][q_rows]
    return dict(q_segment_ids=q_ids, kv_segment_ids=seg[1][kv_rows])


def _sink_rows_of_shard0(k, v, sinks, mesh: Mesh, axis_name: str):
    """The first min(``sinks``, rows) key and value rows of the block
    that rank 0 along ``axis_name`` holds (one small all_gather): the
    absolute sink rows, which sit in shard 0 (or zigzag chunk 0)."""
    se0 = min(sinks, k.shape[-2])
    return [mesh.all_gather(x[..., :se0, :].contiguous(), axis_name,
                            dim=-2)[..., :se0, :] for x in (k, v)]


class _RingDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, cfg, mesh):
        seg = None if q_ids is None else (q_ids, kv_ids)
        out, lse = _ring_fwd_loop(q, k, v, cfg, mesh, seg=seg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg, ctx.mesh, ctx.seg = cfg, mesh, seg
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_bwd_loop(q, k, v, out, lse, dout.contiguous(),
                               ctx.cfg, ctx.mesh, ctx.seg)
        return (*grads, None, None, None, None)


def _ring_bwd_loop(q, k, v, out, lse, dout, cfg: _RingCfg, mesh: Mesh,
                   seg=None):
    """The contiguous ring's backward (JAX's `_ring_diff_bwd`): R calls of
    the backward kernels, the visiting shard's float32 dK/dV buffer
    added to and rotated with it, a last rotation home.  One exchange is
    in flight at a time: the next K/V shard's during the kernel call,
    then the gradient buffers'."""
    idx = mesh.index(cfg.axis_name)
    perm = [(j, (j + 1) % cfg.n_dev) for j in range(cfg.n_dev)]
    q_offset = idx * cfg.m_local
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    if cfg.sinks is not None:
        # computed once against shard 0's sink rows (always real: padding
        # lives in the last shard, and sinks <= n_local)
        k_sink, v_sink = _sink_rows_of_shard0(k, v, cfg.sinks, mesh,
                                              cfg.axis_name)
        dq_s, dk_s, dv_s, se = sink_patch(
            q, k_sink, v_sink, out, lse, dout, scale=cfg.scale,
            window=cfg.window, sinks=cfg.sinks, softcap=cfg.softcap,
            q_offset=q_offset)
        dq += dq_s
    k_cur, v_cur = k, v
    for t in range(cfg.n_dev):
        if t + 1 < cfg.n_dev:
            nxt = mesh.ppermute((k_cur, v_cur), cfg.axis_name, perm)
        shard = (idx - t) % cfg.n_dev
        kv_rows = slice(shard * cfg.n_local, (shard + 1) * cfg.n_local)
        dq_i, dk_i, dv_i = flash_backward(
            q, k_cur, v_cur, out, lse, dout, scale=cfg.scale,
            causal=cfg.causal, softcap=cfg.softcap, window=cfg.window,
            q_offset=q_offset, kv_offset=shard * cfg.n_local,
            kv_valid=min(max(cfg.n - shard * cfg.n_local, 0), cfg.n_local),
            grad_dtype=torch.float32, **_ids(seg, None, kv_rows))
        dq += dq_i
        dk_cur = dk_cur + dk_i
        dv_cur = dv_cur + dv_i
        if cfg.sinks is not None and shard == 0:
            dk_cur[..., :se, :] += dk_s
            dv_cur[..., :se, :] += dv_s
        if t + 1 < cfg.n_dev:
            k_cur, v_cur = nxt.wait()
            dk_cur, dv_cur = mesh.ppermute((dk_cur, dv_cur), cfg.axis_name,
                                           perm).wait()
    # shard s now sits on rank s - 1: one more rotation takes it home
    dk, dv = mesh.ppermute((dk_cur, dv_cur), cfg.axis_name, perm).wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ZigDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, z, mesh):
        seg = None if q_ids is None else (q_ids, kv_ids)
        out_lo, lse_lo, out_hi, lse_hi = _zig_fwd_loop(q, k, v, z, mesh,
                                                       seg=seg)
        ctx.save_for_backward(q, k, v, out_lo, lse_lo, out_hi, lse_hi)
        ctx.z, ctx.mesh, ctx.seg = z, mesh, seg
        return torch.cat([out_lo, out_hi], dim=-2)

    @staticmethod
    def backward(ctx, dout):
        grads = _zig_bwd_loop(*ctx.saved_tensors, dout.contiguous(), ctx.z,
                              ctx.mesh, ctx.seg)
        return (*grads, None, None, None, None)


def _zig_bwd_loop(q, k, v, out_lo, lse_lo, out_hi, lse_hi, dout,
                  z: _ZigCfg, mesh: Mesh, seg=None):
    """The zigzag ring's backward (JAX's `_zig_diff_bwd`): the forward's
    three chunk-pair calls a step, differentiated, the visiting pair's
    float32 dK/dV buffer travelling with it; both local query chunks'
    sink patches computed once, added on the step where chunk 0 visits
    as the early chunk."""
    n_chunks = 2 * z.n_dev
    a = mesh.index(z.axis_name)
    b = n_chunks - 1 - a
    perm = [(j, (j + 1) % z.n_dev) for j in range(z.n_dev)]
    sl_lo, sl_hi = _zig_slices(q.dim(), z.chunk)
    q_lo, q_hi = q[sl_lo], q[sl_hi]
    do_lo, do_hi = dout[sl_lo], dout[sl_hi]
    dq_lo = torch.zeros(q_lo.shape, dtype=torch.float32, device=q.device)
    dq_hi = torch.zeros(q_hi.shape, dtype=torch.float32, device=q.device)
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=v.device)

    def chunk_rows(c):
        return slice(c * z.chunk, (c + 1) * z.chunk)

    if z.sinks is not None:
        # chunk 0 (rank 0's early chunk) holds the sink rows, always real
        k_sink, v_sink = _sink_rows_of_shard0(k[sl_lo], v[sl_lo], z.sinks,
                                              mesh, z.axis_name)
        patches = [sink_patch(q_c, k_sink, v_sink, o_c, l_c, d_c,
                              scale=z.scale, window=z.window, sinks=z.sinks,
                              softcap=z.softcap, q_offset=c * z.chunk)
                   for q_c, o_c, l_c, d_c, c in (
                       (q_hi, out_hi, lse_hi, do_hi, b),
                       (q_lo, out_lo, lse_lo, do_lo, a))]
        dq_hi += patches[0][0]
        dq_lo += patches[1][0]
        se = patches[0][3]
        dk_s = patches[0][1] + patches[1][1]
        dv_s = patches[0][2] + patches[1][2]

    def bwd_call(q_c, k_c, v_c, out_c, lse_c, do_c, q_cid, kv_cid):
        return flash_backward(
            q_c, k_c, v_c, out_c, lse_c, do_c, scale=z.scale, causal=True,
            softcap=z.softcap, window=z.window, q_offset=q_cid * z.chunk,
            kv_offset=kv_cid * z.chunk,
            kv_valid=min(max(z.n - kv_cid * z.chunk, 0), z.chunk),
            grad_dtype=torch.float32,
            **_ids(seg, chunk_rows(q_cid), chunk_rows(kv_cid)))

    k_cur, v_cur = k, v
    for t in range(z.n_dev):
        if t + 1 < z.n_dev:
            nxt = mesh.ppermute((k_cur, v_cur), z.axis_name, perm)
        e = (a - t) % z.n_dev
        ae, be = e, n_chunks - 1 - e
        k_lo, k_hi = k_cur[sl_lo], k_cur[sl_hi]
        v_lo, v_hi = v_cur[sl_lo], v_cur[sl_hi]
        g1 = bwd_call(q_hi, k_lo, v_lo, out_hi, lse_hi, do_hi, b, ae)
        g2 = bwd_call(q_lo, k_lo, v_lo, out_lo, lse_lo, do_lo, a, ae)
        g3 = bwd_call(q_hi, k_hi, v_hi, out_hi, lse_hi, do_hi, b, be)
        dq_hi += g1[0] + g3[0]
        dq_lo += g2[0]
        dk_cur = dk_cur + torch.cat([g1[1] + g2[1], g3[1]], dim=-2)
        dv_cur = dv_cur + torch.cat([g1[2] + g2[2], g3[2]], dim=-2)
        if z.sinks is not None and ae == 0:
            dk_cur[..., :se, :] += dk_s
            dv_cur[..., :se, :] += dv_s
        if t + 1 < z.n_dev:
            k_cur, v_cur = nxt.wait()
            dk_cur, dv_cur = mesh.ppermute((dk_cur, dv_cur), z.axis_name,
                                           perm).wait()
    dk, dv = mesh.ppermute((dk_cur, dv_cur), z.axis_name, perm).wait()
    dq = torch.cat([dq_lo, dq_hi], dim=-2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
