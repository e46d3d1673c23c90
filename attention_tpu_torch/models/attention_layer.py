"""Grouped-query self-attention: the port of
`attention_tpu.models.attention_layer.GQASelfAttention`.

This slice carries two paths: the uncached forward (``cache=None``),
which runs the flash kernel over the whole sequence, and the serving
engine's packed step (``cache`` a `RaggedPagedStep`), which appends the
step's K/V rows through the page tables and runs the ragged kernel.
The JAX layer's other cache types, context parallelism (``cp_axis``)
and head-sharded serving (``tp_axis``) raise `NotImplementedError`.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_tpu_torch.ops.flash import flash_attention
from attention_tpu_torch.ops.ragged_paged import (
    RaggedPagedStep,
    ragged_paged_append,
    ragged_paged_attention,
)
from attention_tpu_torch.ops.rope import apply_rope


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

    def forward(self, x: torch.Tensor, cache: RaggedPagedStep | None = None):
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
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        if cache is None:
            out = flash_attention(q, k, v, causal=self.causal,
                                  softcap=self.softcap)
        elif isinstance(cache, RaggedPagedStep):
            cache = ragged_paged_append(cache, k, v)
            out = ragged_paged_attention(q, cache, softcap=self.softcap)
        else:
            raise NotImplementedError(
                f"cache type {type(cache).__name__} is not ported yet; "
                "the port serves through RaggedPagedStep")
        out = out.transpose(1, 2).reshape(b, s, -1)
        proj = self.o_proj(out.to(x.dtype))
        return proj if cache is None else (proj, cache)
