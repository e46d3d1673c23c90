"""KV-sharded distributed attention with the two-phase softmax merge: the
port of `attention_tpu.parallel.kv_sharded`.

The reference's distributed algorithm (`attention-mpi.c:191-407`):

  * KV rows block-sharded over ranks (the owner partitioner,
    `attention-mpi.c:19-27`): each rank slices its own block of K/V, Q
    whole;
  * each rank's local pass producing (contrib, lmax, lsum)
    (`attention-mpi.c:333-338`): `flash_attention_partials`, the flash
    kernel's partials epilogue on the card;
  * phase 1, ``MPI_Iallreduce(lmax, MAX)`` and the rescale by
    exp(lmax - gmax) (`attention-mpi.c:342-351`), phase 2,
    ``MPI_Iallreduce(lsum, SUM)`` and the 1/gsum normalisation
    (`:354-362`), then the contributions' SUM (`:380`, a reduce to the
    root there, an all_reduce here so every rank holds the output):
    `merge_partials`, over ``torch.distributed`` (`mesh.Mesh`).

Every rank passes the full tensors, as JAX's functions take global
arrays, slices its own shard at entry (``shard_map``'s ``in_specs``) and
returns the full output.  The kernel's masking surface flows through, as
in JAX (attention_tpu/parallel/kv_sharded.py:163-197): ``window`` and
``sinks`` in global positions through each shard's ``kv_offset``, and
packed-sequence segment ids with their rows (Q's whole on every rank,
K/V's cut with K/V, the padded tail -2, an id no real row holds).
``max_mode`` (JAX's default here, "bound") reaches each shard's
`flash_attention_partials`; the merge weighs a shard by its row sum,
since under "bound" a shard that saw no key has a finite row max.
``block_sizes`` and ``max_mode="auto"`` raise `NotImplementedError`.
"""

from __future__ import annotations

import torch

from attention_tpu_torch.ops.flash import (
    check_max_mode,
    check_segments,
    check_window,
    flash_attention,
    flash_attention_partials,
)
from attention_tpu_torch.ops.reference import attention_reference_partials
from attention_tpu_torch.parallel.mesh import Mesh, default_mesh

NEG_INF = float("-inf")


def _unported(*, block_sizes=None, max_mode="bound") -> None:
    """Raise `NotImplementedError` for what the sharded paths do not
    carry yet: ``block_sizes`` and ``max_mode="auto"`` (an unknown mode
    is JAX's `ValueError`)."""
    check_max_mode(max_mode)
    if block_sizes is not None:
        raise NotImplementedError(
            "block_sizes=... is not ported to the sharded paths yet")


def _forward_only(q, k, v) -> None:
    """Raise `NotImplementedError` for gradients: kv-sharded, q-sharded
    and `ring_attention` are forward-only, as in JAX, whose versions call
    kernels without a VJP."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "kv-sharded, q-sharded and ring_attention are forward-only, as "
            "in the JAX package; train through cp_flash_attention, "
            "ring_attention_diff or ulysses_attention")


def pad_ids(ids, length: int, fill: int):
    """Segment ids padded to ``length`` with ``fill`` (None stays None):
    -1 for query rows, -2 for key rows, as JAX's `_ring_pad_ids`, ids no
    real (non-negative) row holds and that match each other neither."""
    if ids is None or ids.shape[0] == length:
        return ids
    return torch.nn.functional.pad(ids, (0, length - ids.shape[0]),
                                   value=fill)


def _rows(x: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """Rows [lo, lo + width) of ``x`` (axis -2), zero rows past its end:
    one rank's block of the sequence padded to a multiple of the mesh."""
    part = x[..., lo:lo + width, :]
    if part.shape[-2] == width:
        return part
    return torch.nn.functional.pad(part, (0, 0, 0, width - part.shape[-2]))


def merge_partials(out_un, lmax, lsum, axis_name: str, *, mesh: Mesh):
    """Two-phase global softmax merge over a mesh axis.

    Inputs are each rank's (contrib, row max, row sum of exp); returns
    the globally normalised output on every rank: steps 2-4 of the
    reference (`attention-mpi.c:340-380`).  A shard whose row sum is 0
    saw no key and weighs 0, whatever its row max (under "bound" it is
    finite, and could exceed the others')."""
    lmax = torch.where(lsum == 0.0, NEG_INF, lmax)
    gmax = mesh.all_reduce(lmax, axis_name, "max")  # phase 1: MAX
    corr = torch.where(lmax == NEG_INF, 0.0, torch.exp(lmax - gmax))
    gsum = mesh.all_reduce(lsum * corr, axis_name, "sum")  # phase 2: SUM
    total = mesh.all_reduce(out_un * corr[..., None], axis_name, "sum")
    gsum_safe = torch.where(gsum == 0.0, 1.0, gsum)  # (:358-362)
    return total / gsum_safe[..., None]


def _local_partials(q, k, v, *, impl, scale, kv_valid, causal=False,
                    q_offset=0, kv_offset=0, softcap=None, window=None,
                    sinks=None, q_segment_ids=None, kv_segment_ids=None,
                    max_mode="online"):
    """One rank's partials: ``impl="flash"`` the flash kernel's partials
    epilogue under ``max_mode`` (its plain version for CPU tensors),
    ``impl="torch"`` the plain PyTorch partials (JAX's ``impl="xla"``,
    whose exact max is the online recurrence's)."""
    fn = {"flash": flash_attention_partials,
          "torch": attention_reference_partials}.get(impl)
    if fn is None:
        raise ValueError(f"unknown impl {impl!r}; 'flash' or 'torch'")
    extra = dict(max_mode=max_mode) if impl == "flash" else {}
    return fn(q, k, v, scale=scale, kv_valid=kv_valid, causal=causal, **extra,
              q_offset=q_offset, kv_offset=kv_offset, softcap=softcap,
              window=window, sinks=sinks, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids)


def kv_sharded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "kv",
    scale: float | None = None,
    block_sizes=None,
    impl: str = "flash",
    causal: bool = False,
    softcap: float | None = None,
    window: int | None = None,
    sinks: int | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    max_mode: str = "bound",
) -> torch.Tensor:
    """Distributed attention with K/V rows sharded over a mesh axis.

    Q is whole on every rank (the reference's broadcast role,
    `attention-mpi.c:232-241`); each rank attends it to its block of K/V
    rows (the scatter role, `:242-266`), the sequence padded to a
    multiple of the mesh and each block's padded tail masked by its
    ``kv_valid``; the two-phase merge makes the softmax shard-invariant.
    Every rank returns the full output, in q's dtype.  Shapes as
    `flash_attention`: (m, d), (h, m, d) or (b, h, m, d), GQA for 3-D
    and 4-D; the key axis (-2) is the sharded one.  ``window`` and
    ``sinks`` are masked in global positions (each shard's
    ``kv_offset``); segment ids ((m,) and (n,), 2-D and 3-D inputs) go
    whole for Q and cut with their K/V rows."""
    _unported(block_sizes=block_sizes, max_mode=max_mode)
    _forward_only(q, k, v)
    q_ids, kv_ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    check_window(causal, window, sinks, q_ids is not None)
    if mesh is None:
        mesh = default_mesh(axis_name)
    n_dev, idx = mesh.shape[axis_name], mesh.index(axis_name)
    n = k.shape[-2]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n_local = -(-n // n_dev)
    lo = idx * n_local
    kv_ids = pad_ids(kv_ids, n_local * n_dev, -2)
    out_un, lmax, lsum = _local_partials(
        q, _rows(k, lo, n_local), _rows(v, lo, n_local), impl=impl,
        scale=scale, kv_valid=min(max(n - lo, 0), n_local), causal=causal,
        kv_offset=lo, softcap=softcap, window=window, sinks=sinks,
        q_segment_ids=q_ids,
        kv_segment_ids=None if kv_ids is None else kv_ids[lo:lo + n_local],
        max_mode=max_mode)
    return merge_partials(out_un, lmax, lsum, axis_name,
                          mesh=mesh).to(q.dtype)


def q_sharded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh | None = None,
    axis_name: str = "kv",
    scale: float | None = None,
    block_sizes=None,
    causal: bool = False,
    softcap: float | None = None,
    max_mode: str = "bound",
) -> torch.Tensor:
    """Replicated-KV attention with Q rows sharded: the 'replicate' arm
    of the placement policy (small KV, `attention-mpi.c:217-241`).

    Each rank runs the flash kernel on its block of Q rows (padded to a
    multiple of the mesh) against the whole K/V, with no collective in
    the attention itself; an all_gather of the blocks gives every rank
    the full output."""
    _unported(block_sizes=block_sizes, max_mode=max_mode)
    _forward_only(q, k, v)
    if mesh is None:
        mesh = default_mesh(axis_name)
    n_dev, idx = mesh.shape[axis_name], mesh.index(axis_name)
    m = q.shape[-2]
    m_local = -(-m // n_dev)
    out = flash_attention(_rows(q, idx * m_local, m_local), k, v,
                          scale=scale, causal=causal,
                          q_offset=idx * m_local, softcap=softcap,
                          max_mode=max_mode)
    return mesh.all_gather(out, axis_name, dim=-2)[..., :m, :]
