"""Differentiable flash attention: the port of
`attention_tpu.ops.flash_vjp`.

`flash_attention_diff` is a `torch.autograd.Function` around the flash
kernels.  Its forward runs `flash_attention_partials` and normalizes, as
JAX's `_flash_fwd_impl` does, saving only (q, k, v, out, lse) instead of
the probability matrix; its backward is `ops.flash_bwd.flash_backward`,
which recomputes the probabilities from the saved log-sum-exp.
Packed-sequence segment ids ride through both as arguments without a
gradient.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from attention_tpu_torch.ops.flash import (
    _canon,
    _offsets,
    _unsupported,
    check_max_mode,
    check_segments,
    flash_attention_partials,
)
from attention_tpu_torch.ops.flash_bwd import (
    check_backward_band,
    flash_backward,
    flash_backward_plain,
)


class KVGather(NamedTuple):
    """How a context-parallel caller (`parallel.cp`) hands
    `flash_attention_diff` this rank's blocks of the keys: ``gather(x)``
    gives the whole sequence's (rows on axis -2), ``sum_block(g)`` of a
    float32 gradient of the whole keys this rank's block of its sum over
    the ranks (JAX's ``psum_scatter``), ``rows`` the whole sequence's key
    rows."""

    gather: Callable
    sum_block: Callable
    rows: int


def _flash_fwd_impl(q, k, v, **kw):
    """(out in q's dtype, lse (..., m) float32 in the natural-log
    domain, -inf for a row that sees no key), from the variant's stats
    as JAX's `_flash_fwd_impl` derives them: lse = row max + log(row
    sum) for each variant (flashd's row max is the lse, its sum 1), and a
    row whose sum is 0 saw no key, whatever its max (bound's is finite)."""
    out_un, row_max, row_sum = flash_attention_partials(q, k, v, **kw)
    seen = row_sum != 0.0
    l_safe = torch.where(seen, row_sum, 1.0)
    out = (out_un / l_safe[..., None]).to(q.dtype)
    lse = torch.where(seen, row_max + torch.log(l_safe), float("-inf"))
    return out, lse


class _FlashDiff(torch.autograd.Function):
    """q, k, v differentiable; the segment ids (int32 or None) are not,
    and their gradient is None, where JAX returns a float0 cotangent
    (attention_tpu/ops/flash_vjp.py:61)."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, opts):
        ids = dict(q_segment_ids=q_ids, kv_segment_ids=kv_ids)
        if opts["kv_gather"] is not None:
            k, v = (opts["kv_gather"].gather(x) for x in (k, v))
        out, lse = _flash_fwd_impl(q, k, v, **opts["fwd"], **ids,
                                   max_mode=opts["max_mode"])
        ctx.save_for_backward(q, k, v, out, lse, q_ids, kv_ids)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_ids, kv_ids = ctx.saved_tensors
        opts, fwd = ctx.opts, ctx.opts["fwd"]
        ids = dict(q_segment_ids=q_ids, kv_segment_ids=kv_ids)
        gather = opts["kv_gather"]
        if opts["bwd_impl"] == "xla":
            grads = flash_backward_plain(
                q, k, v, out, lse, dout, scale=fwd["scale"],
                causal=fwd["causal"], softcap=fwd["softcap"],
                window=fwd["window"], sinks=fwd["sinks"],
                chunk=opts["bwd_chunk"], **ids,
                **_offsets(k.shape[-2], fwd["q_offset"], fwd["kv_offset"],
                           fwd["kv_valid"]))
        else:
            grads = flash_backward(
                q, k, v, out, lse, dout, **fwd, **ids,
                grad_dtype=None if gather is None else torch.float32)
        if gather is not None:
            dq, dk, dv = grads
            grads = (dq.to(q.dtype),
                     gather.sum_block(dk.float()).to(k.dtype),
                     gather.sum_block(dv.float()).to(v.dtype))
        return (*grads, None, None, None)


def flash_attention_diff(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = False,
    block_sizes=None,
    bwd_chunk: int = 512,
    bwd_impl: str = "pallas",
    q_segment_ids=None,
    kv_segment_ids=None,
    window: int | None = None,
    softcap: float | None = None,
    sinks: int | None = None,
    q_offset=None,
    kv_offset=None,
    kv_valid=None,
    max_mode: str = "online",
    kv_gather=None,
) -> torch.Tensor:
    """Differentiable fused attention with `flash_attention`'s shape
    contract: (m, d), (h, m, d) or (b, h, m, d) inputs, dk != dv allowed,
    GQA for 3-D/4-D.  Gradients flow to q, k and v.

    ``bwd_impl`` names the backward as the JAX package does: ``"pallas"``
    (the default) is `flash_backward`, which on CUDA tensors launches the
    hand-written backward kernels (the fused one, or the dQ and dK/dV
    pair under `flash_bwd._FORCE_TWO_KERNEL`) and on CPU tensors runs
    their plain version; ``"xla"`` runs the plain blocked recompute
    `flash_backward_plain` on any device, in blocks of ``bwd_chunk``
    query rows.  ``max_mode`` ("online", "bound", "flashd", "amla")
    is the forward's rescaling math (`flash_attention_partials`, resolved
    as there); every variant gives the same output and lse, and the
    backward kernels read only the lse.  "auto" raises
    `NotImplementedError`.  A
    ``window`` (causal only) with ``sinks`` runs the forward kernel over
    the band and its sinks, and the backward kernels over the band with
    the sink pairs outside it added by `flash_bwd.sink_patch`.
    ``q_segment_ids`` (m,) and ``kv_segment_ids`` (n,) (2-D and 3-D
    inputs, shared across heads) mask attention across packed-sequence
    boundaries in the forward and both backwards.  The refusals are
    `flash_bwd.flash_backward`'s; ``block_sizes`` raises
    `NotImplementedError`.

    ``kv_gather`` (a `KVGather`, from a context-parallel caller,
    `parallel.cp`): ``k`` and ``v`` are this rank's blocks of the keys,
    gathered whole for the forward (``kv_valid``, ``kv_segment_ids`` and
    the mask are the whole sequence's); the backward keeps dQ, dK and dV
    in float32 (`flash_backward`'s ``grad_dtype``) until dK and dV are
    summed over the ranks, and rounds each once."""
    if bwd_impl not in ("pallas", "xla"):
        raise ValueError(f"unknown bwd_impl {bwd_impl!r}")
    check_max_mode(max_mode)
    q_ids, kv_ids = check_segments(
        q, k, q_segment_ids, kv_segment_ids,
        n=None if kv_gather is None else kv_gather.rows)
    check_backward_band(causal, window, sinks, kv_offset,
                        q_ids is not None)
    _unsupported(block_sizes=block_sizes)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    q4, k4, v4 = _canon(q, k, v)
    if q_ids is not None:
        # ids take 2-D and 3-D inputs: one (h, m, d) call
        q4, k4, v4 = q4[0], k4[0], v4[0]
    fwd = dict(scale=scale, causal=causal, softcap=softcap,
               q_offset=q_offset, kv_offset=kv_offset, kv_valid=kv_valid,
               window=window, sinks=sinks)
    out = _FlashDiff.apply(q4, k4, v4, q_ids, kv_ids,
                           dict(fwd=fwd, bwd_impl=bwd_impl,
                                max_mode=max_mode,
                                bwd_chunk=bwd_chunk, kv_gather=kv_gather))
    return out[(0,) * (q4.dim() - q.dim())]
