"""Ulysses sequence parallelism, the forward: the port of
`attention_tpu.parallel.ulysses`.

One all_to_all turns sequence-sharding into head-sharding, each rank
runs whole-sequence attention for its subset of heads (no softmax
collective at all), and a second all_to_all turns it back: two
collectives a call, cheaper than a ring when the head count divides the
mesh and sequences are moderately long.

GQA: when the mesh size does not divide the KV head count, KV heads are
repeated just enough to make the reshard uniform, normally up to the
mesh size (32 q / 4 kv heads on 8 ranks repeat 2x), falling back to the
full Q head count only for ratios that divide neither way.

After the first all_to_all each rank holds the whole sequence for its
heads, so the kernel's whole masking surface applies as it is: ``window``
and ``sinks`` in absolute positions and the global segment ids (3-D
inputs), as in JAX (attention_tpu/parallel/ulysses.py:131-140).

Every rank passes the full tensors, takes its block of the sequence (and
of the batch, over ``batch_axis``) at entry and returns the full output
(all_gathers of the blocks).  The path is differentiable end to end: the
inner call is `ops.flash_vjp.flash_attention_diff`, the all_to_alls are
`mesh.all_to_all_diff` (backward: the inverse all_to_all), the GQA
repeat is summed back by autograd, and the entry's blocks and the
output's gathers are `mesh.shard_whole` / `mesh.gather_whole`.  The
model calls `ulysses_local` on its own block of the sequence.
"""

from __future__ import annotations

import torch

from attention_tpu_torch.ops.flash import check_segments, check_window
from attention_tpu_torch.ops.flash_vjp import flash_attention_diff
from attention_tpu_torch.parallel.kv_sharded import _unported
from attention_tpu_torch.parallel.mesh import (
    Mesh,
    all_to_all_diff,
    default_mesh,
    gather_blocks,
    shard_blocks,
    whole_layout,
)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "sp",
    batch_axis: str | None = "dp",
    scale: float | None = None,
    block_sizes=None,
    causal: bool = False,
    softcap: float | None = None,
    window: int | None = None,
    sinks: int | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    max_mode: str = "bound",
) -> torch.Tensor:
    """All-to-all sequence-parallel attention for multi-head inputs,
    differentiable end to end.

    Shapes: (h, m, d) or (b, h, m, d); the sequence axes are cut over
    ``axis_name`` (4-D batches also over ``batch_axis`` where the mesh
    has it and it divides).  The Q head count and both sequence lengths
    must be multiples of the mesh size.  ``window``, ``sinks`` and the
    segment ids ((m,) and (n,), 3-D inputs) as `flash_attention` takes
    them."""
    _unported(block_sizes=block_sizes, max_mode=max_mode)
    q_ids, kv_ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    check_window(causal, window, sinks, q_ids is not None)
    if mesh is None:
        mesh = default_mesh(axis_name)
    n_dev = mesh.shape[axis_name]
    if q.dim() not in (3, 4):
        raise ValueError(
            f"ulysses needs (h, m, d) or (b, h, m, d); got {tuple(q.shape)}")
    m, n = q.shape[-2], k.shape[-2]
    if m % n_dev != 0 or n % n_dev != 0:
        raise ValueError(f"sequence lengths {m}/{n} not divisible by mesh "
                         f"size {n_dev}")
    layout = whole_layout(q, k, mesh, axis_name, batch_axis, None)
    out = ulysses_local(*shard_blocks((q, k, v), mesh, layout), mesh=mesh,
                        axis_name=axis_name, scale=scale, causal=causal,
                        softcap=softcap, window=window, sinks=sinks,
                        q_segment_ids=q_ids, kv_segment_ids=kv_ids,
                        max_mode=max_mode)
    return gather_blocks(out, mesh, layout)


def ulysses_local(q, k, v, *, mesh: Mesh, axis_name: str = "sp",
                  scale=None, causal: bool = False, softcap=None,
                  window=None, sinks=None, q_segment_ids=None,
                  kv_segment_ids=None, max_mode: str = "bound"):
    """Ulysses on this rank's blocks of the sequence (what JAX runs inside
    ``shard_map``): the GQA repeat where the mesh size does not divide the
    KV heads, the all_to_all to head shards (whole sequence), the flash
    kernels, the all_to_all back.  Segment ids are the whole
    sequence's.  The q heads must divide over the mesh (`ValueError`)."""
    n_dev = mesh.shape[axis_name]
    hq, hkv = q.shape[-3], k.shape[-3]
    if hq % n_dev != 0:
        raise ValueError(f"q heads {hq} not divisible by mesh size {n_dev}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    # GQA survives the all_to_all untouched iff the mesh size divides the
    # KV head count.  Otherwise repeat KV heads up to the mesh size: rank
    # r then holds q heads [r·hq/R, (r+1)·hq/R) and expanded kv head r,
    # whose original head r // (R/hkv) is the one those q heads read.
    # Ratios that divide neither way fall back to the full repeat.
    if hkv != hq and hkv % n_dev != 0:
        if hq % hkv != 0:
            raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
        expand = n_dev // hkv if n_dev % hkv == 0 else hq // hkv
        k = k.repeat_interleave(expand, dim=-3)
        v = v.repeat_interleave(expand, dim=-3)
    head_axis, seq_axis = q.dim() - 3, q.dim() - 2
    # sequence-sharded -> head-sharded: split heads, gather the sequence
    qh, kh, vh = (all_to_all_diff(x, mesh, axis_name, head_axis, seq_axis)
                  for x in (q, k, v))
    out = flash_attention_diff(qh, kh, vh, scale=scale, causal=causal,
                               softcap=softcap, window=window, sinks=sinks,
                               q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids,
                               max_mode=max_mode)
    # head-sharded -> sequence-sharded
    return all_to_all_diff(out, mesh, axis_name, seq_axis, head_axis)
