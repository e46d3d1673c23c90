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
blocks).  The differentiable ring (`ring_attention_diff` and the zigzag
backward) comes with the training path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from attention_tpu_torch.ops.flash import (
    check_segments,
    check_window,
    flash_attention_partials,
)
from attention_tpu_torch.parallel.kv_sharded import _rows, _unported, pad_ids
from attention_tpu_torch.parallel.mesh import Mesh, default_mesh

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
    _unported(q=q, k=k, v=v, block_sizes=block_sizes, max_mode=max_mode)
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
                            sinks=sinks, seg=seg)

    m, n = q.shape[-2], k.shape[-2]
    m_local, n_local = -(-m // n_dev), -(-n // n_dev)
    cfg = _RingCfg(axis_name=axis_name, n_dev=n_dev, n=n, m_local=m_local,
                   n_local=n_local, scale=scale, causal=causal,
                   softcap=softcap, window=window, sinks=sinks)
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
            softcap=cfg.softcap, window=cfg.window, sinks=cfg.sinks, **ids)
        acc, m_run, l_run = _merge_step((acc, m_run, l_run), *parts)
        if t + 1 < cfg.n_dev:
            k_cur, v_cur = nxt.wait()
    return _finalize((acc, m_run, l_run), q.dtype)


def _merge_step(state, out_un, lmax, lsum):
    """Online merge of one partials call into a running (acc, m, l)
    state: the rmax/rsum recurrence (`attention-mpi.c:179-181`) across
    ring steps; a call that saw nothing (lmax -inf) changes nothing."""
    acc, m_run, l_run = state
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


def _zigzag_ring(q, k, v, *, mesh: Mesh, axis_name: str, scale, softcap,
                 window=None, sinks=None, seg=None):
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
                   sinks=sinks)
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
            softcap=z.softcap, window=z.window, sinks=z.sinks, **ids)

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
    ``inverse``: two half-block ppermutes and a per-rank choice of slot,
    with no global gather.  2R-1 is odd, so a rank's two zigzag chunks
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
        arr0 = mesh.ppermute([x[sl_lo] for x in xs], axis_name,
                             perm0).wait()
        arr1 = mesh.ppermute([x[sl_hi] for x in xs], axis_name,
                             perm1).wait()
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
    arr_a = mesh.ppermute(evens, axis_name, perm_a).wait()  # chunk 2d
    arr_b = mesh.ppermute(odds, axis_name, perm_b).wait()  # chunk 2d+1
    return [torch.cat(pair, dim=-2) for pair in zip(arr_a, arr_b)]
