"""Differentiable context-parallel flash attention: the port of
`attention_tpu.parallel.cp`.

The integration the reference is (`attention-mpi.c:191-407`: partition,
distribute, local online softmax, merge, in one entry), made
differentiable so that training runs through it.  Activations are
sequence-sharded over the ``sp`` axis; each rank all-gathers the (small,
GQA) K/V heads over the axis and runs the flash kernels on its block of
queries with ``q_offset = index * m_local``, so that causal, window and
sink masking stay global.  The backward is the flash backward kernels on
the same offsets, then the all-gather's backward (JAX's
``psum_scatter``: the sum over the axis and this rank's block of it; gloo
has no reduce_scatter, so an all_reduce and a slice) sends each rank's
contribution to dK/dV back to the rank that holds those rows.  Both live
in one autograd function (`flash_attention_diff`'s ``kv_gather``), so
that dK and dV stay float32 from the kernels through the sum over the
ranks and round once.

Against the ring (`parallel.ring.ring_attention_diff`) this holds the
whole K/V on every rank for one bulk collective: the Megatron/MaxText
training layout.

`cp_flash_attention` takes the whole tensors on every rank and returns
the whole output (`mesh.shard_whole` / `mesh.gather_whole`); the model
calls `cp_attention_local` on its own block of the sequence.
"""

from __future__ import annotations

import torch

from attention_tpu_torch.ops.flash import check_segments
from attention_tpu_torch.ops.flash_vjp import KVGather, flash_attention_diff
from attention_tpu_torch.parallel.kv_sharded import _rows, _unported, \
    pad_ids
from attention_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    gather_blocks,
    shard_blocks,
    whole_layout,
)


def cp_attention_local(q, k, v, *, mesh: Mesh, axis_name: str = "sp",
                       scale=None, causal: bool = True, window=None,
                       sinks=None, softcap=None, kv_valid=None,
                       q_segment_ids=None, kv_segment_ids=None,
                       block_sizes=None, bwd_impl: str = "pallas",
                       max_mode: str = "bound"):
    """The all-gather CP attention of this rank's blocks (what JAX runs
    inside ``shard_map``): K/V gathered over ``axis_name``, then
    `flash_attention_diff` of the local queries at ``q_offset = index *
    m_local``, whose backward sums each rank's float32 dK/dV over the
    axis and keeps this rank's block (its ``kv_gather``).  ``kv_valid``
    masks a padded key tail; ``q_segment_ids`` are this block's,
    ``kv_segment_ids`` the whole sequence's."""
    idx, rows = mesh.index(axis_name), k.shape[-2]

    def gather(x):
        return mesh.all_gather(x, axis_name, dim=-2)

    def sum_block(g):
        return mesh.all_reduce(g, axis_name, "sum").narrow(-2, idx * rows,
                                                           rows)

    return flash_attention_diff(
        q, k, v, scale=scale, causal=causal, q_offset=idx * q.shape[-2],
        kv_valid=kv_valid, window=window, sinks=sinks, softcap=softcap,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        block_sizes=block_sizes, bwd_impl=bwd_impl, max_mode=max_mode,
        kv_gather=KVGather(gather, sum_block, rows * mesh.shape[axis_name])
        if mesh.shape[axis_name] > 1 else None)


def cp_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "sp",
    batch_axis: str | None = "dp",
    head_axis: str | None = "tp",
    scale: float | None = None,
    causal: bool = True,
    window: int | None = None,
    sinks: int | None = None,
    softcap: float | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    block_sizes=None,
    bwd_impl: str = "pallas",
    max_mode: str = "bound",
) -> torch.Tensor:
    """Context-parallel fused attention, differentiable end to end.

    (b, h, s, d) or (h, s, d) inputs, whole on every rank (every rank
    returns the whole output and, under autograd, the whole gradients,
    the same bits on each); the sequence axes are cut over
    ``axis_name`` after padding them to a multiple of its size (padded
    keys masked by ``kv_valid``, padded query rows dropped), the batch
    and heads over ``batch_axis`` and ``head_axis`` where the mesh has
    them and they divide.  GQA, ``window`` (causal only), ``sinks``,
    ``softcap`` and segment ids ((m,) and (n,), 3-D inputs) as
    `flash_attention_diff` takes them, in global positions.  The
    refusals are JAX's, as `ValueError`: a mesh without the axis, 2-D
    inputs, unpaired ids, ids on 4-D inputs."""
    if mesh is None:
        mesh = default_mesh(axis_name)
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no axis {axis_name!r}")
    if q.dim() not in (3, 4):
        raise ValueError(f"cp attention takes 3D/4D inputs, got {q.dim()}D")
    q_ids, kv_ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    _unported(block_sizes=block_sizes, max_mode=max_mode)
    n_dev = mesh.shape[axis_name]
    m, n = q.shape[-2], k.shape[-2]
    m_local, n_local = -(-m // n_dev), -(-n // n_dev)
    layout = whole_layout(q, k, mesh, axis_name, batch_axis, head_axis)
    ql, kl, vl = shard_blocks(
        (_rows(q, 0, m_local * n_dev), _rows(k, 0, n_local * n_dev),
         _rows(v, 0, n_local * n_dev)), mesh, layout)
    if q_ids is not None:
        lo = mesh.index(axis_name) * m_local
        q_ids = pad_ids(q_ids, m_local * n_dev, -1)[lo:lo + m_local]
        kv_ids = pad_ids(kv_ids, n_local * n_dev, -2)
    out = cp_attention_local(
        ql, kl, vl, mesh=mesh, axis_name=axis_name, scale=scale,
        causal=causal, window=window, sinks=sinks, softcap=softcap,
        kv_valid=n if n_local * n_dev != n else None, q_segment_ids=q_ids,
        kv_segment_ids=kv_ids, bwd_impl=bwd_impl, max_mode=max_mode)
    return gather_blocks(out, mesh, layout)[..., :m, :]
