"""Cross-attention: the port of `attention_tpu.models.cross_attention`.

Queries come from the decoder stream, keys and values from a memory of
its own length (the reference kernel's independent m and n,
`attention.c:20-75`, at the model layer), with the GQA head grouping and
the ``impl`` split of `GQASelfAttention`: "flash" runs the flash kernel,
non-causal with m != n (under autograd `flash_attention_diff`, whose
backward runs the backward kernels), "xla" PyTorch ops.  No causal mask
and no rope: queries and memory lie on different axes.
"""

from __future__ import annotations

import torch
from torch import nn

from attention_tpu_torch.models.attention_layer import ATTN_IMPLS, \
    check_impl


class GQACrossAttention(nn.Module):
    """(B, S, D) x and (B, T, D_mem) memory -> (B, S, D).

    ``memory_dim`` is D_mem (default ``dim``).  Pass ``memory=`` to
    project K/V in the call, or ``kv=``, the (B, Hkv, T, dh) pair of
    `project_kv`, to reuse a projection across decode steps."""

    def __init__(self, dim: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, memory_dim: int | None = None,
                 impl: str = "flash", dtype: torch.dtype = torch.bfloat16,
                 softcap: float | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        check_impl(impl)
        if num_q_heads % num_kv_heads != 0:
            raise ValueError(
                f"q heads {num_q_heads} not a multiple of kv heads "
                f"{num_kv_heads}")
        self.num_q_heads = num_q_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.impl = impl
        self.dtype = dtype
        self.softcap = softcap
        memory_dim = memory_dim or dim
        kw = dict(bias=False, dtype=dtype, device=device)
        self.q_proj = nn.Linear(dim, num_q_heads * head_dim, **kw)
        self.k_proj = nn.Linear(memory_dim, num_kv_heads * head_dim, **kw)
        self.v_proj = nn.Linear(memory_dim, num_kv_heads * head_dim, **kw)
        self.o_proj = nn.Linear(num_q_heads * head_dim, dim, **kw)

    def _heads(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """(B, L, n·dh) -> (B, n, L, dh), a view."""
        b, length = t.shape[:2]
        return t.view(b, length, n, self.head_dim).transpose(1, 2)

    def project_kv(self, memory: torch.Tensor):
        """The memory's (k, v), each (B, Hkv, T, dh), for ``kv=``: project
        it once and reuse it across decode steps."""
        mem = memory.to(self.dtype)
        return (self._heads(self.k_proj(mem), self.num_kv_heads),
                self._heads(self.v_proj(mem), self.num_kv_heads))

    def forward(self, x: torch.Tensor, memory: torch.Tensor | None = None,
                kv=None) -> torch.Tensor:
        if (memory is None) == (kv is None):
            raise ValueError("pass exactly one of memory= or kv=")
        b, s, _ = x.shape
        q = self._heads(self.q_proj(x), self.num_q_heads)
        k, v = self.project_kv(memory) if kv is None else kv
        out = ATTN_IMPLS[self.impl](q, k, v, causal=False,
                                    softcap=self.softcap)
        out = out.transpose(1, 2).reshape(b, s, -1)
        return self.o_proj(out.to(self.dtype))
