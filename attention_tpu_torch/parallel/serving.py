"""Sharded autoregressive decoding: serve a KV cache across a mesh, the
port of `attention_tpu.parallel.serving`.

* Tensor-parallel serving (axis "tp"): every cache and pool sharded over
  its KV heads.  Rank r holds the contiguous block of ``Hkv / R`` kv
  heads ``[r·Hkv/R, (r+1)·Hkv/R)`` and the ``H / R`` q heads that read
  them, so each GQA group stays whole on one rank and the unchanged
  kernel runs on the rank's block; the rank's output heads are then
  all-gathered (`Mesh.all_gather`) so that every rank holds the whole
  output, as JAX's ``out_specs`` gives every device the whole array.
  `head_sharded_prefill` (the flash kernel: cached prefill, chunked
  append), `head_sharded_decode` (the decode kernel; a 4-D q runs its
  chunk mode), `head_sharded_decode_quantized` (the int8 kernel, every
  field of the cache cut by kv head), `head_sharded_decode_paged` (the
  paged kernel: pools cut, page table and lengths replicated, page ids
  being head-agnostic) and `head_sharded_ragged_step` (the serving
  engine's packed step: append and the ragged kernel on the rank's pool
  slice, every packed index array replicated).
* Sequence-parallel serving (axis "sp"): `cache_sharded_decode` cuts the
  cache *rows* over the mesh; each rank's flash partials over its rows
  (``kv_valid`` clipped to the shard) are merged by the two-phase
  MAX/SUM merge (`kv_sharded.merge_partials`, the reference's
  `attention-mpi.c:340-380` applied to one query row).

Two conventions, as `parallel.cp` has.  The public functions take the
whole tensors on every rank and return the whole output on every rank
(the port's convention, `parallel.mesh`), comparable to JAX's function
for function.  Each ``*_local`` form takes this rank's block (its heads;
its rows for `cache_sharded_decode_local`) and returns the whole output:
the model's cached paths (`models.attention_layer`, ``tp_axis``) and the
serving engine (``EngineConfig.mesh_shards``) call those, each rank
holding only its block of every cache and pool.

A geometry that cannot split is `MeshConfigError` (a `ValueError`), with
JAX's messages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from attention_tpu_torch.ops.decode import flash_decode, flash_decode_chunk
from attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_partials,
)
from attention_tpu_torch.ops.paged import PagedKV, paged_flash_decode
from attention_tpu_torch.ops.quant import (
    QuantizedKV,
    flash_decode_quantized,
    flash_decode_quantized_chunk,
)
from attention_tpu_torch.ops.ragged_paged import (
    RaggedPagedStep,
    ragged_paged_append,
    ragged_paged_attention,
)
from attention_tpu_torch.parallel.kv_sharded import _unported, \
    merge_partials
from attention_tpu_torch.parallel.mesh import Mesh, default_mesh


class MeshConfigError(ValueError):
    """A sharded serving geometry cannot split over the mesh: a head
    count the axis size does not divide (an uneven split would mis-cut
    the contiguous head blocks that GQA groups depend on), or an engine
    ``mesh_shards`` larger than the world.  A `ValueError`, so argument
    checks keep catching it; typed, so a caller can tell "fix the shard
    count" from a kernel fault."""


def check_heads(hkv: int, n_dev: int, hq: int | None = None) -> None:
    """Raise `MeshConfigError` unless ``n_dev`` divides the kv heads
    (and the q heads, where given), JAX's messages."""
    if hkv % n_dev:
        raise MeshConfigError(
            f"kv heads {hkv} not divisible by mesh size {n_dev}")
    if hq is not None and hq % n_dev:
        raise MeshConfigError(
            f"q heads {hq} not divisible by mesh size {n_dev}")


def head_block(x: torch.Tensor, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s heads (axis 1), a
    contiguous copy: the ``P(None, axis_name, ...)`` in_spec of JAX's
    head-sharded calls."""
    width = x.shape[1] // mesh.shape[axis_name]
    return x.narrow(1, mesh.index(axis_name) * width, width).contiguous()


def _mesh(mesh, axis_name: str) -> Mesh:
    return default_mesh(axis_name) if mesh is None else mesh


#: the axis of a ``mesh_shards`` engine's mesh (`serving_mesh`), which
#: the engine and its snapshots read
TP_AXIS = "tp"

#: {shards: (the world group it was cut from, its mesh)}: holding the
#: group keeps its id from reuse, and a new world misses the cache
_SERVING_MESHES: dict[int, tuple[object, Mesh]] = {}


def serving_mesh(shards: int) -> Mesh:
    """The world cut into blocks of ``shards`` consecutive ranks, one
    `TP_AXIS` mesh each (a world of exactly ``shards`` ranks is one
    block; more blocks serve as replicas of one another): the mesh of a
    ``mesh_shards`` engine.  `MeshConfigError` when the world has fewer
    ranks than ``shards`` (JAX's "available device(s)" refusal) or is not
    a whole number of blocks.  Every rank must call it, in the same
    order (process groups are created collectively); the mesh of a given
    size is made once per world."""
    size, rank = (dist.get_world_size(), dist.get_rank()) \
        if dist.is_available() and dist.is_initialized() else (1, 0)
    if shards > size:
        raise MeshConfigError(
            f"mesh_shards {shards} exceeds the {size} available device(s) "
            "(ranks of the torch.distributed world)")
    if size % shards:
        raise MeshConfigError(
            f"mesh_shards {shards} does not divide the world's {size} ranks")
    world = dist.group.WORLD if size > 1 else None
    cached = _SERVING_MESHES.get(shards)
    if cached is None or cached[0] is not world:
        base = rank - rank % shards
        group = None
        if shards > 1:
            for start in range(0, size, shards):
                line = dist.new_group(list(range(start, start + shards)))
                if start == base:
                    group = line
        cached = _SERVING_MESHES[shards] = (world, Mesh(
            (TP_AXIS,), (shards,), (rank - base,),
            (list(range(base, base + shards)),), (group,)))
    return cached[1]


def _gather_heads(out: torch.Tensor, mesh: Mesh, axis_name: str):
    """The ranks' output head blocks (axis 1) in index order, whole on
    every rank."""
    return mesh.all_gather(out, axis_name, dim=1)


# -- the local forms: this rank's head block in, the whole output out ----


def head_sharded_prefill_local(q, k, v, *, mesh: Mesh, axis_name: str = "tp",
                               **kw) -> torch.Tensor:
    """The flash kernel (cached prefill, chunked append) on this rank's
    head block of (B, H, S, d) q and its kv block; ``kw`` as
    `ops.flash.flash_attention` takes it."""
    return _gather_heads(flash_attention(q, k, v, **kw), mesh, axis_name)


def head_sharded_decode_local(q, k_cache, v_cache, lengths, *, mesh: Mesh,
                              axis_name: str = "tp", **kw) -> torch.Tensor:
    """The decode kernel on this rank's head block: q (B, H/R, d) for a
    one-token step, (B, H/R, S, d) for the speculative-verify chunk mode
    (``lengths`` then after the append)."""
    fn = flash_decode_chunk if q.dim() == 4 else flash_decode
    return _gather_heads(fn(q, k_cache, v_cache, lengths, **kw), mesh,
                         axis_name)


def head_sharded_decode_quantized_local(q, cache: QuantizedKV, lengths, *,
                                        mesh: Mesh, axis_name: str = "tp",
                                        **kw) -> torch.Tensor:
    """The int8 decode kernel on this rank's head block of q and of every
    field of the int8 cache; a 4-D q runs the chunk mode."""
    fn = (flash_decode_quantized_chunk if q.dim() == 4
          else flash_decode_quantized)
    return _gather_heads(fn(q, cache, lengths, **kw), mesh, axis_name)


def head_sharded_decode_paged_local(q, cache: PagedKV, *, mesh: Mesh,
                                    axis_name: str = "tp",
                                    **kw) -> torch.Tensor:
    """The paged decode kernel on this rank's head block of q and of the
    pools; the page table and lengths are the whole batch's."""
    return _gather_heads(paged_flash_decode(q, cache, **kw), mesh,
                         axis_name)


def head_sharded_ragged_step_local(q, cache: RaggedPagedStep, k_new, v_new,
                                   *, mesh: Mesh, axis_name: str = "tp",
                                   **kw):
    """The packed serving step on this rank's head block: the new K/V
    rows appended through the page tables into the rank's pool slice (in
    place), then the ragged kernel.  Returns ``(out, cache)``: the whole
    (1, Hq, T, dv) output, and the step with post-append lengths (every
    rank computes the same ones from the replicated index arrays)."""
    cache = ragged_paged_append(cache, k_new, v_new)
    out = ragged_paged_attention(q, cache, **kw)
    return _gather_heads(out, mesh, axis_name), cache


def cache_sharded_decode_local(q, k_rows, v_rows, length, capacity: int, *,
                               mesh: Mesh, axis_name: str = "sp",
                               scale: float | None = None,
                               softcap: float | None = None) -> torch.Tensor:
    """One query row per sequence over this rank's block of the cache
    rows: q (B, H, d) whole, ``k_rows``/``v_rows`` (B, Hkv, capacity / R,
    d) this rank's rows, ``length`` the valid rows of the whole cache.
    Each (sequence, kv head) is one kernel head whose query rows are its
    GQA group; the rank's partials (``kv_valid`` clipped to its rows, 0
    for a shard past the valid prefix) meet the others' in the two-phase
    merge.  Returns the whole (B, H, dv) output on every rank."""
    b, h, d = q.shape
    _, hkv, shard_n, dv = v_rows.shape
    group = h // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    lo = mesh.index(axis_name) * (capacity // mesh.shape[axis_name])
    kv_valid = min(max(int(length) - lo, 0), shard_n)
    out_un, lmax, lsum = flash_attention_partials(
        q.reshape(b * hkv, group, d), k_rows.reshape(b * hkv, shard_n, d),
        v_rows.reshape(b * hkv, shard_n, dv), scale=scale,
        kv_valid=kv_valid, softcap=softcap)
    out = merge_partials(out_un, lmax, lsum, axis_name, mesh=mesh)
    return out.reshape(b, h, dv).to(v_rows.dtype)


# -- the public forms: whole tensors in, the whole output out ------------


def head_sharded_prefill(q, k, v, *, mesh: Mesh | None = None,
                         axis_name: str = "tp", **kw) -> torch.Tensor:
    """Batch flash attention (cached prefill, chunked append) with the
    heads sharded over ``axis_name``: (B, H, S, d) whole on every rank,
    the whole output on every rank.  ``kw`` passes to
    `ops.flash.flash_attention` (``q_offset``, ``kv_valid``, ``causal``,
    the band, ``softcap``)."""
    mesh = _mesh(mesh, axis_name)
    check_heads(k.shape[1], mesh.shape[axis_name])
    return head_sharded_prefill_local(
        *(head_block(t, mesh, axis_name) for t in (q, k, v)), mesh=mesh,
        axis_name=axis_name, **kw)


def head_sharded_decode(q, k_cache, v_cache, lengths, *,
                        mesh: Mesh | None = None, axis_name: str = "tp",
                        scale: float | None = None,
                        softcap: float | None = None,
                        window: int | None = None,
                        sinks: int | None = None) -> torch.Tensor:
    """Tensor-parallel decode, KV heads sharded: q (B, H, d), caches (B,
    Hkv, N, d), ``lengths`` an int or (B,) -> (B, H, dv) on every rank.
    Contiguous head blocks keep q head j with kv head j // group, so each
    rank runs a whole `flash_decode` on its block.  A 4-D q (B, H, S, d)
    runs the chunk kernel (`ops.decode.flash_decode_chunk`), ``lengths``
    then after the append."""
    mesh = _mesh(mesh, axis_name)
    check_heads(k_cache.shape[1], mesh.shape[axis_name])
    return head_sharded_decode_local(
        *(head_block(t, mesh, axis_name) for t in (q, k_cache, v_cache)),
        lengths, mesh=mesh, axis_name=axis_name, scale=scale,
        softcap=softcap, window=window, sinks=sinks)


def head_sharded_decode_quantized(q, cache: QuantizedKV, lengths, *,
                                  mesh: Mesh | None = None,
                                  axis_name: str = "tp",
                                  scale: float | None = None,
                                  softcap: float | None = None,
                                  window: int | None = None,
                                  sinks: int | None = None) -> torch.Tensor:
    """Tensor-parallel decode against an int8 cache: every field of the
    `QuantizedKV` (the int8 values and their per-token scales) cut by kv
    head, a whole `flash_decode_quantized` on each rank's block; a 4-D q
    runs the chunk kernel."""
    mesh = _mesh(mesh, axis_name)
    check_heads(cache.k_q.shape[1], mesh.shape[axis_name])
    block = QuantizedKV(*(head_block(t, mesh, axis_name) for t in cache))
    return head_sharded_decode_quantized_local(
        head_block(q, mesh, axis_name), block, lengths, mesh=mesh,
        axis_name=axis_name, scale=scale, softcap=softcap, window=window,
        sinks=sinks)


def head_sharded_decode_paged(q, cache: PagedKV, *, mesh: Mesh | None = None,
                              axis_name: str = "tp",
                              scale: float | None = None,
                              softcap: float | None = None,
                              window: int | None = None,
                              sinks: int | None = None) -> torch.Tensor:
    """Tensor-parallel decode through a paged pool: the pools (P, Hkv,
    page, d) cut by kv head, the page table and lengths replicated, so
    each rank translates the same logical pages into its own head slice
    of the pool and runs a whole `paged_flash_decode`.  A 4-D q runs the
    chunk mode."""
    mesh = _mesh(mesh, axis_name)
    check_heads(cache.k_pool.shape[1], mesh.shape[axis_name])
    block = cache._replace(k_pool=head_block(cache.k_pool, mesh, axis_name),
                           v_pool=head_block(cache.v_pool, mesh, axis_name))
    return head_sharded_decode_paged_local(
        head_block(q, mesh, axis_name), block, mesh=mesh,
        axis_name=axis_name, scale=scale, softcap=softcap, window=window,
        sinks=sinks)


def head_sharded_ragged_step(q, cache: RaggedPagedStep, k_new, v_new, *,
                             mesh: Mesh | None = None, axis_name: str = "tp",
                             softcap: float | None = None,
                             window: int | None = None,
                             sinks: int | None = None):
    """The packed serving step (append, then ragged attention) with the
    KV heads sharded: q (1, Hq, T, d), k_new/v_new (1, Hkv, T, d) and the
    step's pools whole on every rank.  The step's pools are appended to
    in place, whole, as the single-device `ragged_paged_append` does;
    each rank runs the ragged kernel on its head block of the pools.
    Returns ``(out, cache)`` like the single-device pair.  Checks both
    the q and the kv heads against the mesh."""
    mesh = _mesh(mesh, axis_name)
    n_dev = mesh.shape[axis_name]
    check_heads(cache.k_pool.shape[1], n_dev, q.shape[1])
    cache = ragged_paged_append(cache, k_new, v_new)
    block = cache._replace(k_pool=head_block(cache.k_pool, mesh, axis_name),
                           v_pool=head_block(cache.v_pool, mesh, axis_name))
    out = ragged_paged_attention(head_block(q, mesh, axis_name), block,
                                 softcap=softcap, window=window, sinks=sinks)
    return _gather_heads(out, mesh, axis_name), cache


def cache_sharded_decode(q, k_cache, v_cache, length, *,
                         mesh: Mesh | None = None, axis_name: str = "sp",
                         scale: float | None = None, block_sizes=None,
                         softcap: float | None = None) -> torch.Tensor:
    """Sequence-parallel decode, cache rows sharded: q (B, H, d), caches
    (B, Hkv, N, d) whole on every rank, ``length`` the valid rows (one
    for the batch) -> (B, H, dv) on every rank, in the cache's dtype.
    Each rank's flash partials over its N / R rows are merged by the
    two-phase MAX/SUM merge (`cache_sharded_decode_local`).  The JAX
    refusals are `ValueError`s: N not divisible by the mesh, H not a
    multiple of Hkv; ``block_sizes`` raises `NotImplementedError`."""
    _unported(block_sizes=block_sizes)
    mesh = _mesh(mesh, axis_name)
    n_dev = mesh.shape[axis_name]
    n = k_cache.shape[2]
    if n % n_dev:
        raise ValueError(
            f"cache capacity {n} not divisible by mesh size {n_dev}")
    if q.shape[1] % k_cache.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k_cache.shape[1]}")
    rows = n // n_dev
    lo = mesh.index(axis_name) * rows
    return cache_sharded_decode_local(
        q, k_cache[:, :, lo:lo + rows].contiguous(),
        v_cache[:, :, lo:lo + rows].contiguous(), length, n, mesh=mesh,
        axis_name=axis_name, scale=scale, softcap=softcap)
