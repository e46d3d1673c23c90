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
* `RaggedPagedStep`: the serving engine's packed step, the ragged
  kernel.

Dense and int8 caches are updated in place and returned with their new
length.  Writing past a dense cache's capacity makes that output NaN,
loudly (an int8 cache poisons the scales it writes, to the same end).
The JAX layer's rolling caches, window/sinks (with the int8 cache's
sink read rotation), context parallelism (``cp_axis``) and head-sharded
serving (``tp_axis``) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from attention_tpu_torch.ops.decode import flash_decode, flash_decode_chunk
from attention_tpu_torch.ops.flash import flash_attention
from attention_tpu_torch.ops.flash_vjp import flash_attention_diff
from attention_tpu_torch.ops.paged import (
    PagedKV,
    paged_append,
    paged_append_chunk,
    paged_flash_decode,
)
from attention_tpu_torch.ops.quant import (
    QuantizedKV,
    flash_decode_quantized,
    flash_decode_quantized_chunk,
    quantize_kv,
    update_quantized_kv,
)
from attention_tpu_torch.ops.ragged_paged import (
    RaggedPagedStep,
    ragged_paged_append,
    ragged_paged_attention,
)
from attention_tpu_torch.ops.rope import apply_rope


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


class GQASelfAttention(nn.Module):
    """(B, S, D) -> (B, S, D) with ``num_q_heads`` query heads sharing
    ``num_kv_heads`` key/value heads.  Projections carry no bias; the
    weights live in ``dtype`` on ``device``."""

    def __init__(self, dim: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, causal: bool = True,
                 dtype: torch.dtype = torch.bfloat16,
                 rope: bool = False, rope_theta: float = 10000.0,
                 softcap: float | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if num_q_heads % num_kv_heads != 0:
            raise ValueError(
                f"q heads {num_q_heads} not a multiple of kv heads "
                f"{num_kv_heads}")
        self.num_q_heads = num_q_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.causal = causal
        self.rope = rope
        self.rope_theta = rope_theta
        self.softcap = softcap
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q_proj = nn.Linear(dim, num_q_heads * head_dim, **kw)
        self.k_proj = nn.Linear(dim, num_kv_heads * head_dim, **kw)
        self.v_proj = nn.Linear(dim, num_kv_heads * head_dim, **kw)
        self.o_proj = nn.Linear(num_q_heads * head_dim, dim, **kw)

    def forward(self, x: torch.Tensor, cache=None):
        b, s, _ = x.shape
        hd = self.head_dim

        def heads(t, n):  # (B, S, n*hd) -> (B, n, S, hd)
            return t.view(b, s, n, hd).transpose(1, 2)

        q = heads(self.q_proj(x), self.num_q_heads)
        k = heads(self.k_proj(x), self.num_kv_heads)
        v = heads(self.v_proj(x), self.num_kv_heads)
        if self.rope:
            # keys are cached already rotated at their absolute
            # positions; a packed step carries each token's own position
            if isinstance(cache, RaggedPagedStep):
                pos = cache.token_pos[None, None, :]
            else:
                pos = torch.arange(s, device=x.device)
                off = 0 if cache is None else cache.length
                if isinstance(off, torch.Tensor):
                    # per-sequence (B,) offsets -> (B, 1, S) positions
                    pos = (off.to(pos.device)[:, None] + pos)[:, None, :]
                else:
                    pos = pos + off
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        if cache is None and torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad):
            # the JAX layer's `_flash_mha` (max_mode "bound", which the
            # port runs as the online recurrence)
            out = flash_attention_diff(q, k, v, causal=self.causal,
                                       softcap=self.softcap,
                                       max_mode="bound")
        elif cache is None:
            out = flash_attention(q, k, v, causal=self.causal,
                                  softcap=self.softcap)
        elif isinstance(cache, RaggedPagedStep):
            cache = ragged_paged_append(cache, k, v)
            out = ragged_paged_attention(q, cache, softcap=self.softcap)
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
        proj = self.o_proj(out.to(x.dtype))
        return proj if cache is None else (proj, cache)

    def _decode_call(self, q, kc, vc, lens):
        """The decode kernel: a one-token step for S == 1, the chunk
        mode (``lens`` after the append) for S > 1."""
        if q.shape[2] == 1:
            return flash_decode(q[:, :, 0], kc, vc, lens,
                                softcap=self.softcap)[:, :, None]
        return flash_decode_chunk(q, kc, vc, lens, softcap=self.softcap)

    def _cached_attention(self, q, k, v, cache: KVCache):
        """Append the S new rows at ``cache.length`` and attend over the
        valid prefix: the decode kernel for S == 1, the flash kernel
        with ``q_offset``/``kv_valid`` for a prefill."""
        s_new = q.shape[2]
        capacity = cache.k.shape[2]
        # an overflowing write lands at the end (the JAX update's clamp);
        # its output is poisoned below
        at = min(cache.length, capacity - s_new)
        cache.k[:, :, at:at + s_new] = k
        cache.v[:, :, at:at + s_new] = v
        new_len = cache.length + s_new
        if s_new == 1:
            out = self._decode_call(q, cache.k, cache.v, new_len)
        else:
            out = flash_attention(q, cache.k, cache.v, causal=self.causal,
                                  q_offset=cache.length, kv_valid=new_len,
                                  softcap=self.softcap)
        if new_len > capacity:
            out = torch.full_like(out, float("nan"))
        return out, cache._replace(length=new_len)

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
        out = self._decode_call(q, cache.k, cache.v, new_lens)
        # per-sequence overflow poison
        over = (new_lens > capacity)[:, None, None, None]
        out = torch.where(over, torch.full_like(out, float("nan")), out)
        return out.to(q.dtype), cache._replace(lengths=new_lens)

    def _paged_attention(self, q, k, v, cache: PagedKV):
        """Append the S new rows through the page table, then the paged
        decode kernel (chunk mode for S > 1)."""
        if q.shape[2] > 1:
            cache = paged_append_chunk(cache, k, v)
            out = paged_flash_decode(q, cache, softcap=self.softcap)
        else:
            cache = paged_append(cache, k, v)
            out = paged_flash_decode(q[:, :, 0], cache,
                                     softcap=self.softcap)[:, :, None]
        return out.to(q.dtype), cache

    def _quantized_attention(self, q, k, v, cache: QuantKVCache):
        """Quantize the S new rows in at ``cache.length``, then the int8
        decode kernel: one token for S == 1, the chunk mode for S > 1.
        The output is bf16 (cast back to q's dtype); an overflowing
        write poisons its scales, so the output reads NaN."""
        kv = update_quantized_kv(cache.kv, k, v, cache.length)
        new_len = cache.length + q.shape[2]
        if q.shape[2] == 1:
            out = flash_decode_quantized(q[:, :, 0], kv, new_len,
                                         softcap=self.softcap)[:, :, None]
        else:
            out = flash_decode_quantized_chunk(q, kv, new_len,
                                               softcap=self.softcap)
        return out.to(q.dtype), QuantKVCache(kv, new_len)
