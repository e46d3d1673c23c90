"""Grouped-query self-attention: the port of
`attention_tpu.models.attention_layer.GQASelfAttention`, with its cache
types.

The layer dispatches on ``cache``:

* ``None``: the uncached forward, the flash kernel over the sequence;
  when autograd needs a gradient (training), the differentiable
  `flash_attention_diff`, whose backward runs the backward kernels;
* `KVCache` (dense, one length for the batch): the S new K/V rows are
  written at ``length``; S == 1 runs the decode kernel, S > 1 (prefill)
  the flash kernel with ``q_offset=length`` and ``kv_valid`` the new
  length;
* `RaggedKVCache` (dense, per-sequence lengths): rows written at each
  sequence's own length; the decode kernel, in chunk mode for S > 1;
* `PagedKV`: rows appended through the page table; the paged decode
  kernel, in chunk mode for S > 1;
* `QuantKVCache` (int8, one length for the batch, from
  `KVCache.quantize` after a prefill): the S new rows quantized in at
  ``length``; the int8 decode kernel, in chunk mode (speculative
  verify) for S > 1;
* `RollingKVCache` (a windowed model's ring buffer of sinks + window
  slots): the decode kernel over the valid slots for S == 1; a prefill
  into a fresh cache runs the flash kernel over the chunk alone;
* `RaggedPagedStep`: the serving engine's packed step, the ragged
  kernel.

That is ``impl="flash"``.  ``impl="xla"`` (`ATTN_IMPLS`) runs the
uncached forward and the dense `KVCache` in PyTorch ops (einsums, the
GQA repeat, softcap, the mask, softmax in float32), as the JAX layer's
XLA path does, and refuses every other cache with the JAX layer's
message: a baseline to time the kernels against, never their fallback.

A windowed model (``window``, with ``attn_sinks`` StreamingLLM sinks)
passes its band to every kernel, the backward kernels of training
included (the uncached forward rotates each key, the sinks too, at its
own position, as JAX's does).  With rope and sinks, one-token decode
reads the sink keys re-rotated to their in-cache positions
(`_sink_read_keys`; the paged cache through `paged_sink_decode`, the
int8 one through `sink_read_rotation`); the stored keys keep their
absolute rotations.

Dense, rolling and int8 caches are updated in place and returned with
their new length.  Writing past a dense cache's capacity makes that
output NaN, loudly (an int8 cache poisons the scales it writes, to the
same end).

Context parallelism (``cp_axis`` of a ``mesh``, `CP_IMPLS`): the
uncached forward takes this rank's block of the sequence (the train
step cuts it, `models.train.make_train_step`), rotates it at its global
positions and runs a differentiable sharded core on local blocks:
"allgather" (`parallel.cp.cp_attention_local`), "ring" and "zigzag"
(`parallel.ring.ring_diff_local`, `zigzag_diff_local`) or "ulysses"
(`parallel.ulysses.ulysses_local`); activations stay O(S/sp) per rank.
Cached paths are unaffected.

Tensor-parallel serving (``tp_axis`` of a ``mesh``, JAX's layout, not
Megatron's): the projections stay whole on every rank and compute every
head; on a cached call the layer then keeps this rank's contiguous block
of the heads (``Hkv / tp`` kv heads and the ``H / tp`` q heads that read
them), every cache and pool holding only that block
(`TinyDecoder.init_caches`, the engine's pools), and each kernel call
goes through its ``*_local`` form in `parallel.serving`, which runs the
unchanged kernel on the block and all-gathers the output heads, so every
rank projects the same whole output.  The uncached forward (training,
``cp_axis``) is unaffected, as in JAX; the two axes may share one mesh.

The trainer's tensor-parallel layout (`models.train.shard_params` on a
mesh with a "tp" axis, Megatron's split; ``tp_split`` names the weights
it split) changes the uncached forward: q, k and v are column-parallel
over this rank's ``H / tp`` heads (the input enters through
`parallel.mesh.tp_copy`); where the kv heads do not divide, k and v stay
whole and each rank projects only its q heads' kv group (the weights
through `tp_copy`, so that their gradient is whole on every rank); the
attention (the flash kernels or a context-parallel core) runs on the
rank's heads, and ``o_proj`` is row-parallel, its partial products
kept float32 through the sum over tp and rounded once
(`parallel.mesh.row_parallel_linear`).  Where the q
heads do not divide, every rank attends over every head and ``o_proj``,
if it is split, is gathered at use.  Cached calls need whole weights and
refuse a split layer.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from attention_tpu_torch.ops.decode import flash_decode, flash_decode_chunk
from attention_tpu_torch.ops.flash import flash_attention
from attention_tpu_torch.ops.flash_vjp import flash_attention_diff
from attention_tpu_torch.ops.paged import (
    PagedKV,
    paged_append,
    paged_append_chunk,
    paged_flash_decode,
    paged_sink_decode,
)
from attention_tpu_torch.ops.quant import (
    QuantizedKV,
    flash_decode_quantized,
    flash_decode_quantized_chunk,
    quantize_kv,
    sink_read_rows,
    update_quantized_kv,
)
from attention_tpu_torch.ops.ragged_paged import (
    RaggedPagedStep,
    ragged_paged_append,
    ragged_paged_attention,
)
from attention_tpu_torch.ops.reference import (
    _gqa_repeat,
    _masked_scores,
    attention_reference,
)
from attention_tpu_torch.ops.rope import apply_rope
from attention_tpu_torch.parallel import serving
from attention_tpu_torch.parallel.cp import cp_attention_local
from attention_tpu_torch.parallel.mesh import (
    gather_whole,
    row_parallel_linear,
    tp_copy,
)
from attention_tpu_torch.parallel.ring import ring_diff_local, \
    zigzag_diff_local
from attention_tpu_torch.parallel.ulysses import ulysses_local


class KVCache(NamedTuple):
    """Per-layer decode cache: K/V (B, Hkv, N, dh) and the valid length
    shared by the batch (a Python int: prefill runs on equal-length or
    right-padded prompts)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def create(cls, batch: int, num_kv_heads: int, capacity: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> "KVCache":
        shape = (batch, num_kv_heads, capacity, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    def quantize(self) -> "QuantKVCache":
        """One-shot int8 conversion (after a prefill): about half the
        bytes of a bf16 cache for the rest of the decode loop."""
        return QuantKVCache(quantize_kv(self.k, self.v), self.length)


class QuantKVCache(NamedTuple):
    """int8 decode cache: `QuantizedKV` (int8 values and per-token
    scales) and the valid length shared by the batch.  The serving flow
    is a bf16 prefill, `KVCache.quantize`, then int8 decode steps (S ==
    1) or speculative-verify chunks (S > 1)."""

    kv: QuantizedKV
    length: int


class RollingKVCache(NamedTuple):
    """Ring-buffer cache of a sliding-window model (optionally with
    StreamingLLM sinks): its memory is bounded by sinks + window, not by
    the sequence, however long generation runs.

    Slots ``[0, sinks)`` hold the first ``sinks`` tokens for good; slots
    ``[sinks, sinks + window)`` the last ``window`` tokens in wrapped
    order (token t at ``sinks + (t - sinks) % window`` once past the
    sinks).  The capacity rounds ``sinks + window`` up to 128 rows, as
    the JAX package's does; the tail slots are never written and reads
    mask by the valid count.  Softmax does not depend on the order of
    the key rows, which is what makes the ring correct.  ``length``
    counts every token seen (a Python int)."""

    k: torch.Tensor  # (B, Hkv, C, dh)
    v: torch.Tensor
    length: int

    @classmethod
    def create(cls, batch: int, num_kv_heads: int, window: int,
               head_dim: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda", *,
               sinks: int = 0) -> "RollingKVCache":
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        shape = (batch, num_kv_heads, cls.capacity_for(window, sinks),
                 head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @staticmethod
    def capacity_for(window: int, sinks: int = 0) -> int:
        """sinks pinned slots + window ring slots, rounded up to 128."""
        return -(-(window + sinks) // 128) * 128


class RaggedKVCache(NamedTuple):
    """Decode cache with per-sequence valid lengths (B,) int32: one
    batch mixes prompts of different lengths.  Built from a padded
    prompt's prefill on `KVCache` (causal masking keeps the pad keys
    out of every valid query's view); decode steps write each
    sequence's row at its own length, over the pad rows."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def length(self):
        """Per-sequence lengths (the name every cache type shares)."""
        return self.lengths

    @classmethod
    def from_prefill(cls, cache: KVCache, lengths) -> "RaggedKVCache":
        return cls(cache.k, cache.v, torch.as_tensor(
            lengths, dtype=torch.int32).to(cache.k.device))


def _sink_read_keys(kc, new_total, window: int, sinks: int, theta: float):
    """The ``sinks`` pinned key rows of ``kc`` (B, Hkv, N, dh) as one-
    token decode reads them (StreamingLLM's positions within the cache):
    keys are cached rotated at their absolute positions, which is exact
    for the window's keys but lets the query-to-sink distance grow
    without bound past ``sinks + window`` tokens.  Rotating only the
    sink rows forward by ``delta = max(new_total - (window + sinks),
    0)`` (``new_total`` an int or per-sequence (B,) totals; rotations
    compose) pins each sink just before the window's start.  Returns
    (B, Hkv, sinks, dh) in the cache's dtype."""
    delta = torch.as_tensor(new_total, device=kc.device)
    delta = (delta.to(torch.int64) - (window + sinks)).clamp(min=0)
    if delta.dim():  # per-sequence (B,) totals -> (B, 1, 1) positions
        delta = delta[:, None, None]
    return apply_rope(kc[:, :, :sinks], delta, theta).to(kc.dtype)


@contextlib.contextmanager
def _reading(rows):
    """Each (tensor, rows) pair's rows written over the tensor's first
    rows (axis 2) for the duration, the old rows back after: the sink
    read copy of a cache in place, where a copy would move the whole
    capacity every step.  Stream-ordered on the card."""
    saved = [(t, t[:, :, :r.shape[2]].clone()) for t, r in rows]
    for t, r in rows:
        t[:, :, :r.shape[2]] = r
    try:
        yield
    finally:
        for t, old in saved:
            t[:, :, :old.shape[2]] = old


def _xla_cached_attention(q, kc, vc, *, start: int, new_len: int,
                          causal: bool, window=None, softcap=None,
                          sinks: int = 0):
    """Dense attention in PyTorch ops of q (B, H, S, dh) over the caches
    (B, Hkv, N, dh), masked to the first ``new_len`` rows and, under
    ``causal``, to the keys at or before each query's position ``start``
    + s (and within its ``window``, or among the ``sinks``): the JAX
    layer's ``_xla_cached_attention``.  Scores and softmax in float32, P
    rounded to the cache's dtype for the product; a row that sees no key
    comes out NaN, as JAX's softmax gives it."""
    kc, vc = _gqa_repeat(q, kc, vc)
    s = _masked_scores(q, kc, scale=None, causal=causal, softcap=softcap,
                       q_offset=start, kv_offset=0, kv_valid=new_len,
                       window=window, sinks=sinks or None)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(vc.dtype).float(), vc.float()).to(vc.dtype)


def _xla_mha(q, k, v, *, causal: bool, window=None, softcap=None,
             sinks: int = 0):
    """Attention over (B, H, S, dh) in PyTorch ops, differentiable by
    autograd: the JAX layer's ``_xla_mha`` (`attention_xla` for
    non-causal calls, the cached path's mask at start 0 for causal
    ones).  A timing baseline beside the kernels, never their
    fallback."""
    if not causal:
        return attention_reference(q, k, v, softcap=softcap)
    return _xla_cached_attention(q, k, v, start=0, new_len=k.shape[2],
                                 causal=True, window=window,
                                 softcap=softcap, sinks=sinks)


def _flash_mha(q, k, v, *, causal: bool, window=None, softcap=None,
               sinks: int = 0):
    """The kernels: the differentiable `flash_attention_diff` when
    autograd needs a gradient (training; the JAX layer's max_mode
    "bound", which the port runs as the online recurrence), else the
    flash kernel."""
    band = dict(window=window, sinks=sinks or None)
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_attention_diff(q, k, v, causal=causal, softcap=softcap,
                                    max_mode="bound", **band)
    return flash_attention(q, k, v, causal=causal, softcap=softcap, **band)


#: the attention of an uncached call, by the layers' ``impl``
ATTN_IMPLS = {"xla": _xla_mha, "flash": _flash_mha}

#: the cached paths that run the kernels only, by cache type: an
#: ``impl="xla"`` layer refuses them as the JAX layer does
_FLASH_ONLY = {RollingKVCache: "rolling-cache",
               RaggedKVCache: "ragged-cache",
               RaggedPagedStep: "ragged paged-step",
               PagedKV: "paged-cache",
               QuantKVCache: "quantized-cache"}


def check_impl(impl: str) -> None:
    """An attention ``impl`` must be one of `ATTN_IMPLS`."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"impl {impl!r} not in {sorted(ATTN_IMPLS)}")


#: the context-parallel local-block cores by ``cp_impl``, in JAX's order
_CP_LOCAL = {"allgather": cp_attention_local, "ring": ring_diff_local,
             "zigzag": zigzag_diff_local, "ulysses": ulysses_local}
CP_IMPLS = tuple(_CP_LOCAL)


def check_cp(cp_axis, cp_impl: str, mesh, impl: str) -> None:
    """The JAX layer's refusals of a context-parallel configuration, as
    `ValueError`: ``cp_axis`` needs the flash path and a ``mesh`` that
    has the axis, and ``cp_impl`` one of `CP_IMPLS`."""
    if cp_axis is None:
        return
    if impl != "flash":
        raise ValueError(
            "cp_axis (context-parallel attention) runs the fused flash "
            f"path; impl {impl!r} is not supported")
    if mesh is None:
        raise ValueError("cp_axis requires mesh=")
    if cp_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no axis {cp_axis!r}")
    if cp_impl not in CP_IMPLS:
        raise ValueError(f"unknown cp_impl {cp_impl!r} (supported: "
                         f"{list(CP_IMPLS)})")


def check_tp(tp_axis, mesh, impl: str, num_kv_heads: int) -> None:
    """The JAX layer's refusals of a tensor-parallel serving
    configuration, as `ValueError` with its messages: ``tp_axis`` needs
    the flash path, a ``mesh`` that has the axis, and kv heads that the
    axis size divides."""
    if tp_axis is None:
        return
    if impl != "flash":
        raise ValueError(
            "tp_axis (head-sharded serving) runs the fused flash kernels; "
            f"impl {impl!r} is not supported")
    if mesh is None:
        raise ValueError("tp_axis requires mesh=")
    if tp_axis not in mesh.axis_names:
        raise ValueError(f"tp_axis {tp_axis!r} is not an axis of the mesh "
                         f"{tuple(mesh.axis_names)}")
    tp_size = mesh.shape[tp_axis]
    if num_kv_heads % tp_size:
        raise ValueError(f"kv heads {num_kv_heads} not divisible by tp_axis "
                         f"{tp_axis!r} size {tp_size}")


class GQASelfAttention(nn.Module):
    """(B, S, D) -> (B, S, D) with ``num_q_heads`` query heads sharing
    ``num_kv_heads`` key/value heads.  Projections carry no bias; the
    weights live in ``dtype`` on ``device``.  ``window`` (causal only)
    makes it sliding-window attention and ``attn_sinks`` keeps the first
    positions attendable beside the window (StreamingLLM).  ``impl``
    "flash" runs the kernels; "xla" runs the uncached and the dense-cache
    paths in PyTorch ops (`ATTN_IMPLS`) and refuses every other cache.
    ``cp_axis`` (an axis of ``mesh``) runs the uncached forward context-
    parallel on this rank's block of the sequence by ``cp_impl``;
    ``tp_axis`` (an axis of ``mesh``) serves every cached path on this
    rank's block of the heads (see the module docstring)."""

    def __init__(self, dim: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, causal: bool = True, impl: str = "flash",
                 dtype: torch.dtype = torch.bfloat16,
                 window: int | None = None, attn_sinks: int = 0,
                 rope: bool = False, rope_theta: float = 10000.0,
                 softcap: float | None = None, cp_axis: str | None = None,
                 cp_impl: str = "allgather", tp_axis: str | None = None,
                 mesh=None, device: str | torch.device = "cuda"):
        super().__init__()
        check_impl(impl)
        if num_q_heads % num_kv_heads != 0:
            raise ValueError(
                f"q heads {num_q_heads} not a multiple of kv heads "
                f"{num_kv_heads}")
        check_cp(cp_axis, cp_impl, mesh, impl)
        check_tp(tp_axis, mesh, impl, num_kv_heads)
        if window is not None:
            if not causal:
                raise ValueError("window requires causal=True")
            if window < 1:
                raise ValueError(f"window must be >= 1, got {window}")
        if attn_sinks and window is None:
            raise ValueError("attn_sinks require a windowed model")
        if attn_sinks < 0:
            raise ValueError(f"attn_sinks must be >= 0, got {attn_sinks}")
        self.impl = impl
        self.window = window
        self.attn_sinks = attn_sinks
        self.num_q_heads = num_q_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.causal = causal
        self.rope = rope
        self.rope_theta = rope_theta
        self.softcap = softcap
        self.cp_axis, self.cp_impl, self.mesh = cp_axis, cp_impl, mesh
        self.tp_axis = tp_axis
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q_proj = nn.Linear(dim, num_q_heads * head_dim, **kw)
        self.k_proj = nn.Linear(dim, num_kv_heads * head_dim, **kw)
        self.v_proj = nn.Linear(dim, num_kv_heads * head_dim, **kw)
        self.o_proj = nn.Linear(num_q_heads * head_dim, dim, **kw)
        #: set by `models.train.shard_params`: the mesh whose "tp" axis
        #: splits this layer's weights, and the names of those it splits
        self.tp_mesh, self.tp_split = None, frozenset()

    def _split_projections(self, x: torch.Tensor):
        """q, k and v of this rank's q heads and their kv group under
        the trainer's tp split (see the module docstring)."""
        w = [m.weight for m in (self.q_proj, self.k_proj, self.v_proj)]
        mesh = self.tp_mesh
        if "k_proj.weight" not in self.tp_split:
            # kv heads whole: keep those this rank's q heads read
            rows = self._kv_rows()
            hd = self.head_dim
            w[1:] = (tp_copy(t, mesh, "tp").view(self.num_kv_heads, hd, -1)
                     [rows].reshape(len(rows) * hd, -1) for t in w[1:])
        x = tp_copy(x, mesh, "tp")
        return tuple(F.linear(x, t) for t in w)

    def _kv_rows(self) -> list[int]:
        """The kv heads this rank's block of q heads reads, in order: the
        group of each whole group, one head for a block inside a group,
        else one kv head per q head (plain multi-head)."""
        n, r = self.tp_mesh.shape["tp"], self.tp_mesh.index("tp")
        local = self.num_q_heads // n
        group = self.num_q_heads // self.num_kv_heads
        reads = [h // group for h in range(r * local, (r + 1) * local)]
        heads = sorted(set(reads))
        if local % len(heads) == 0 and reads == [
                h for h in heads for _ in range(local // len(heads))]:
            return heads
        return reads

    def _project_out(self, out: torch.Tensor) -> torch.Tensor:
        if "o_proj.weight" not in self.tp_split:
            return self.o_proj(out)
        mesh = self.tp_mesh
        if "q_proj.weight" in self.tp_split:
            return row_parallel_linear(out, self.o_proj.weight, mesh, "tp")
        # every head on every rank: the split weight gathered at use
        return F.linear(out, gather_whole(self.o_proj.weight, mesh, "tp", 1))

    def forward(self, x: torch.Tensor, cache=None):
        b, s, _ = x.shape
        hd = self.head_dim
        if self.tp_split and cache is not None:
            raise ValueError(
                "cached calls need whole weights; this layer's "
                f"{sorted(self.tp_split)} are split over tp by shard_params "
                "(serve with tp_axis= on whole weights)")

        def heads(t):  # (B, S, n*hd) -> (B, n, S, hd)
            return t.view(b, s, -1, hd).transpose(1, 2)

        if "q_proj.weight" in self.tp_split:
            q, k, v = map(heads, self._split_projections(x))
        else:
            q, k, v = (heads(m(x))
                       for m in (self.q_proj, self.k_proj, self.v_proj))
        if self.tp_axis is not None and cache is not None:
            # this rank's head block: its caches hold only these heads
            q, k, v = (serving.head_block(t, self.mesh, self.tp_axis)
                       for t in (q, k, v))
        if self.rope:
            # keys are cached already rotated at their absolute
            # positions; a packed step carries each token's own position
            if isinstance(cache, RaggedPagedStep):
                pos = cache.token_pos[None, None, :]
            else:
                pos = torch.arange(s, device=x.device)
                off = 0 if cache is None else cache.length
                if cache is None and self.cp_axis is not None:
                    off = self.mesh.index(self.cp_axis) * s
                if isinstance(off, torch.Tensor):
                    # per-sequence (B,) offsets -> (B, 1, S) positions
                    pos = (off.to(pos.device)[:, None] + pos)[:, None, :]
                else:
                    pos = pos + off
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        band = self._band
        flash_only = _FLASH_ONLY.get(type(cache))
        if self.impl != "flash" and flash_only:
            raise ValueError(f"impl {self.impl!r} has no {flash_only} path "
                             "(supported: ['flash'])")
        if cache is None and self.cp_axis is not None:
            out = self._cp_attention(q, k, v)
        elif cache is None:
            out = ATTN_IMPLS[self.impl](q, k, v, causal=self.causal,
                                        window=self.window,
                                        softcap=self.softcap,
                                        sinks=self.attn_sinks)
        elif isinstance(cache, RaggedPagedStep):
            if self._sink_rope:
                raise ValueError(
                    "rope+sinks needs the per-sequence rotated sink read "
                    "copy (paged_sink_decode), which the packed step does "
                    "not carry; serve such models with "
                    "step_mode='two_call'")
            if self.tp_axis is not None:
                out, cache = serving.head_sharded_ragged_step_local(
                    q, cache, k, v, softcap=self.softcap, **self._tp, **band)
            else:
                cache = ragged_paged_append(cache, k, v)
                out = ragged_paged_attention(q, cache, softcap=self.softcap,
                                             **band)
        elif isinstance(cache, RollingKVCache):
            out, cache = self._rolling_attention(q, k, v, cache)
        elif isinstance(cache, KVCache):
            out, cache = self._cached_attention(q, k, v, cache)
        elif isinstance(cache, RaggedKVCache):
            out, cache = self._ragged_attention(q, k, v, cache)
        elif isinstance(cache, PagedKV):
            out, cache = self._paged_attention(q, k, v, cache)
        elif isinstance(cache, QuantKVCache):
            out, cache = self._quantized_attention(q, k, v, cache)
        else:
            raise NotImplementedError(
                f"cache type {type(cache).__name__} is not ported yet")
        out = out.transpose(1, 2).reshape(b, s, -1)
        proj = self._project_out(out.to(x.dtype))
        return proj if cache is None else (proj, cache)

    def _cp_attention(self, q, k, v):
        """Context-parallel attention of this rank's block (B, H, s, dh)
        of the sequence, each rank's block s rows at s·index."""
        return _CP_LOCAL[self.cp_impl](
            q, k, v, mesh=self.mesh, axis_name=self.cp_axis,
            causal=self.causal, softcap=self.softcap, window=self.window,
            sinks=self.attn_sinks or None)

    @property
    def _tp(self) -> dict:
        """The mesh keywords of the `parallel.serving` local forms."""
        return dict(mesh=self.mesh, axis_name=self.tp_axis)

    def _flash_call(self, q, k, v, **kw):
        """The flash kernel of a cached prefill or chunked append:
        head-sharded over ``tp_axis`` (`serving.head_sharded_prefill_local`)
        when serving tensor-parallel."""
        if self.tp_axis is not None:
            return serving.head_sharded_prefill_local(q, k, v, **self._tp,
                                                      **kw)
        return flash_attention(q, k, v, **kw)

    @property
    def _band(self) -> dict:
        """The model's window and sinks as the kernels' keywords."""
        return dict(window=self.window, sinks=self.attn_sinks or None)

    @property
    def _sink_rope(self) -> bool:
        """Whether one-token decode reads re-rotated sink keys."""
        return bool(self.rope and self.attn_sinks and self.window)

    def _sink_read(self, kc, new_total):
        """The dense cache ``kc`` as one-token decode reads it: the sink
        rows re-rotated (`_sink_read_keys`) for the duration when the
        model has rope and sinks, else as it is."""
        if not self._sink_rope:
            return contextlib.nullcontext()
        return _reading([(kc, _sink_read_keys(
            kc, new_total, self.window, self.attn_sinks, self.rope_theta))])

    def _decode_call(self, q, kc, vc, lens, *, band=True):
        """The decode kernel: a one-token step for S == 1, the chunk
        mode (``lens`` after the append) for S > 1; with the model's
        band unless ``band`` is False."""
        kw = dict(softcap=self.softcap, **(self._band if band else {}))
        one = q.shape[2] == 1
        q1 = q[:, :, 0] if one else q
        if self.tp_axis is not None:
            out = serving.head_sharded_decode_local(q1, kc, vc, lens,
                                                    **self._tp, **kw)
        else:
            out = (flash_decode if one else flash_decode_chunk)(
                q1, kc, vc, lens, **kw)
        return out[:, :, None] if one else out

    def _cached_attention(self, q, k, v, cache: KVCache):
        """Append the S new rows at ``cache.length`` and attend over the
        valid prefix: the decode kernel for S == 1, the flash kernel
        with ``q_offset``/``kv_valid`` for a prefill.  Only one-token
        decode reads re-rotated sinks: a chunk's queries would each need
        their own shift, and a chunked append on a sink model is a
        prefill anyway, so it keeps the absolute rotations (as the JAX
        layer does)."""
        s_new = q.shape[2]
        capacity = cache.k.shape[2]
        # an overflowing write lands at the end (the JAX update's clamp);
        # its output is poisoned below
        at = min(cache.length, capacity - s_new)
        cache.k[:, :, at:at + s_new] = k
        cache.v[:, :, at:at + s_new] = v
        new_len = cache.length + s_new
        if self.impl == "xla":
            with (self._sink_read(cache.k, new_len) if s_new == 1
                  else contextlib.nullcontext()):
                out = _xla_cached_attention(
                    q, cache.k, cache.v, start=cache.length,
                    new_len=new_len, causal=self.causal, window=self.window,
                    softcap=self.softcap, sinks=self.attn_sinks)
        elif s_new == 1:
            with self._sink_read(cache.k, new_len):
                out = self._decode_call(q, cache.k, cache.v, new_len)
        else:
            out = self._flash_call(q, cache.k, cache.v, causal=self.causal,
                                   q_offset=cache.length, kv_valid=new_len,
                                   softcap=self.softcap, **self._band)
        if new_len > capacity:
            out = torch.full_like(out, float("nan"))
        return out, cache._replace(length=new_len)

    def _rolling_attention(self, q, k, v, cache: RollingKVCache):
        """The ring buffer of `RollingKVCache`.  S == 1: the new row goes
        to its slot (pinned for the first ``sinks`` tokens, the ring's
        after) and the decode kernel attends over the valid slots, with
        no band (slot order does not matter to softmax).  S > 1 is a
        prefill into a fresh cache: the chunk attends only to itself
        (the flash kernel with the band) and its first ``sinks`` and
        last ``window`` rows seed the buffer; into a cache that is not
        fresh it would drop history in the window, so the output is NaN,
        loudly."""
        if self.window is None:
            raise ValueError("RollingKVCache requires a windowed model")
        sinks, ring = self.attn_sinks, self.window
        expect = RollingKVCache.capacity_for(ring, sinks)
        if cache.capacity != expect:
            raise ValueError(
                f"rolling capacity {cache.capacity} != expected {expect} "
                f"(window {ring} + sinks {sinks}, rounded to the 128-slot "
                "granule)")
        s_new = q.shape[2]
        kc, vc = cache.k, cache.v
        if s_new == 1:
            t = cache.length
            slot = t if t < sinks else sinks + (t - sinks) % ring
            kc[:, :, slot] = k[:, :, 0]
            vc[:, :, slot] = v[:, :, 0]
            with self._sink_read(kc, t + 1):
                out = self._decode_call(q, kc, vc, min(t + 1, sinks + ring),
                                        band=False)
            return out, cache._replace(length=t + 1)
        out = self._flash_call(q, k, v, causal=True, window=ring,
                               softcap=self.softcap, sinks=sinks or None)
        if cache.length != 0:
            out = torch.full_like(out, float("nan"))
        head = min(s_new, sinks)
        kc[:, :, :head] = k[:, :, :head]
        vc[:, :, :head] = v[:, :, :head]
        keep = min(max(s_new - sinks, 0), ring)
        if keep:
            # the ring rows land rotated so that token t sits at slot
            # sinks + (t - sinks) % ring: one or two contiguous writes
            split = (s_new - keep - sinks) % ring
            first = min(ring - split, keep)
            for dst, src in ((kc, k), (vc, v)):
                rows = src[:, :, s_new - keep:]
                dst[:, :, sinks + split:sinks + split + first] = \
                    rows[:, :, :first]
                dst[:, :, sinks:sinks + keep - first] = rows[:, :, first:]
        return out, cache._replace(length=cache.length + s_new)

    def _ragged_attention(self, q, k, v, cache: RaggedKVCache):
        """Write each sequence's S rows at its own length and attend in
        one cache stream (chunk mode for S > 1)."""
        b, s_new = q.shape[0], q.shape[2]
        capacity = cache.k.shape[2]
        idx = (cache.lengths.long().clamp(max=capacity - s_new)[:, None]
               + torch.arange(s_new, device=q.device))      # (B, S)
        rows = torch.arange(b, device=q.device)[:, None]
        # (B, S) advanced indices around the head slice: (B, S, Hkv, d)
        cache.k[rows, :, idx] = k.transpose(1, 2).to(cache.k.dtype)
        cache.v[rows, :, idx] = v.transpose(1, 2).to(cache.v.dtype)
        new_lens = cache.lengths + s_new
        # one-token decode reads re-rotated sinks, each sequence by its
        # own delta; chunks keep the absolute rotations
        with (self._sink_read(cache.k, new_lens) if s_new == 1
              else contextlib.nullcontext()):
            out = self._decode_call(q, cache.k, cache.v, new_lens)
        # per-sequence overflow poison
        over = (new_lens > capacity)[:, None, None, None]
        out = torch.where(over, torch.full_like(out, float("nan")), out)
        return out.to(q.dtype), cache._replace(lengths=new_lens)

    def _paged_attention(self, q, k, v, cache: PagedKV):
        """Append the S new rows through the page table, then the paged
        decode kernel (chunk mode for S > 1).  With rope and sinks, one-
        token decode goes through `paged_sink_decode`: pool pages may be
        shared by sequences with different deltas, so the sink rows are
        rotated in a per-sequence read copy, never in the pool."""
        kw = dict(softcap=self.softcap, **self._band)
        paged = paged_flash_decode if self.tp_axis is None else \
            functools.partial(serving.head_sharded_decode_paged_local,
                              **self._tp)
        if q.shape[2] > 1:
            cache = paged_append_chunk(cache, k, v)
            out = paged(q, cache, **kw)
        elif self._sink_rope:
            if self.tp_axis is not None:
                raise ValueError(
                    "rope+sinks on the paged cache reads a per-sequence "
                    "rotated sink copy (paged_sink_decode), which has no "
                    "head-sharded form yet; serve rope+sink models "
                    "tensor-parallel on the dense/ragged/int8 caches")
            cache = paged_append(cache, k, v)
            out = paged_sink_decode(
                q[:, :, 0], cache, window=self.window, sinks=self.attn_sinks,
                theta=self.rope_theta, softcap=self.softcap)[:, :, None]
        else:
            cache = paged_append(cache, k, v)
            out = paged(q[:, :, 0], cache, **kw)[:, :, None]
        return out.to(q.dtype), cache

    def _quantized_attention(self, q, k, v, cache: QuantKVCache):
        """Quantize the S new rows in at ``cache.length``, then the int8
        decode kernel: one token for S == 1, the chunk mode for S > 1.
        The output is bf16 (cast back to q's dtype); an overflowing
        write poisons its scales, so the output reads NaN."""
        kv = update_quantized_kv(cache.kv, k, v, cache.length)
        new_len = cache.length + q.shape[2]
        kw = dict(softcap=self.softcap, **self._band)
        one, chunk = flash_decode_quantized, flash_decode_quantized_chunk
        if self.tp_axis is not None:
            # the local form takes the chunk mode from a 4-D q itself
            one = chunk = functools.partial(
                serving.head_sharded_decode_quantized_local, **self._tp)
        if q.shape[2] > 1:
            out = chunk(q, kv, new_len, **kw)
            return out.to(q.dtype), QuantKVCache(kv, new_len)
        reading = contextlib.nullcontext()
        if self._sink_rope:
            # the int8 `sink_read_rotation`: the sink rows dequantized,
            # rotated and requantized, read in place of the stored ones
            rows, scales = sink_read_rows(kv, new_len, self.window,
                                          self.attn_sinks, self.rope_theta)
            reading = _reading([(kv.k_q, rows), (kv.k_scale, scales)])
        with reading:
            out = one(q[:, :, 0], kv, new_len, **kw)[:, :, None]
        return out.to(q.dtype), QuantKVCache(kv, new_len)
