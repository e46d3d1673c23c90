"""Encoder-decoder models: the port of `attention_tpu.models.seq2seq`.

A bidirectional encoder over the source (`GQASelfAttention` with
``causal=False``: the flash kernel and, in training, the backward
kernels non-causal), a causal decoder with cached self-attention, and
per-layer cross-attention from the decoder stream into the encoded
memory (`GQACrossAttention`: m target rows over n source rows).
`seq2seq_loss` is the teacher-forced loss; `generate_seq2seq` encodes
once, projects each decoder layer's cross K/V once, and runs greedy
decode steps on dense caches (the decode kernel for the self-attention,
the flash kernel at m = 1 for the cross-attention).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from attention_tpu_torch.device import resolve_device
from attention_tpu_torch.models.attention_layer import (
    GQASelfAttention,
    KVCache,
)
from attention_tpu_torch.models.cross_attention import GQACrossAttention
from attention_tpu_torch.models.decode import _resolve_capacity
from attention_tpu_torch.models.transformer import MLP, RMSNorm


class EncoderBlock(nn.Module):
    """Pre-norm bidirectional block: non-causal self-attention over the
    source, then the MLP.  ``rope`` gives the encoder its source
    positions: without them the model is invariant to the source's
    order."""

    def __init__(self, dim: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, impl: str = "flash", dtype: torch.dtype,
                 rope: bool = True, softcap: float | None = None, device):
        super().__init__()
        self.norm1 = RMSNorm(dim, dtype=dtype, device=device)
        self.attn = GQASelfAttention(
            dim, num_q_heads, num_kv_heads, head_dim, causal=False,
            impl=impl, dtype=dtype, rope=rope, softcap=softcap,
            device=device)
        self.norm2 = RMSNorm(dim, dtype=dtype, device=device)
        self.mlp = MLP(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class Seq2SeqDecoderBlock(nn.Module):
    """Pre-norm decoder block: causal (cached) self-attention, then
    cross-attention into the memory, then the MLP.  ``forward(x, ...)``
    returns x, ``forward(x, ..., cache=c)`` returns (x, cache)."""

    def __init__(self, dim: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, impl: str = "flash", dtype: torch.dtype,
                 rope: bool = False, softcap: float | None = None, device):
        super().__init__()
        self.self_attn = GQASelfAttention(
            dim, num_q_heads, num_kv_heads, head_dim, causal=True,
            impl=impl, dtype=dtype, rope=rope, softcap=softcap,
            device=device)
        self.cross_attn = GQACrossAttention(
            dim, num_q_heads, num_kv_heads, head_dim, impl=impl,
            dtype=dtype, softcap=softcap, device=device)
        self.norm_self = RMSNorm(dim, dtype=dtype, device=device)
        self.norm_cross = RMSNorm(dim, dtype=dtype, device=device)
        self.norm_mlp = RMSNorm(dim, dtype=dtype, device=device)
        self.mlp = MLP(dim, dtype=dtype, device=device)

    def forward(self, x, memory=None, cross_kv=None, cache=None):
        sa = self.self_attn(self.norm_self(x), cache)
        if cache is not None:
            sa, cache = sa
        x = x + sa
        x = x + self.cross_attn(self.norm_cross(x), memory=memory,
                                kv=cross_kv)
        x = x + self.mlp(self.norm_mlp(x))
        return x if cache is None else (x, cache)


class TinySeq2Seq(nn.Module):
    """Encoder-decoder LM: ``forward(src, tgt)`` -> (B, S_tgt, vocab)
    float32 teacher-forcing logits; `encode`, `project_memory` and
    `decode` split the flow for cached generation
    (`generate_seq2seq`).  ``rope`` gives positions to the encoder's and
    the decoder's self-attention.  The logits head computes in the model
    dtype, as the JAX model's does."""

    def __init__(self, vocab: int, dim: int = 128, enc_depth: int = 2,
                 dec_depth: int = 2, num_q_heads: int = 4,
                 num_kv_heads: int = 2, impl: str = "flash",
                 dtype: torch.dtype = torch.bfloat16, rope: bool = True,
                 softcap: float | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        self.dec_depth = dec_depth
        self.num_kv_heads = num_kv_heads
        self.impl = impl
        self.dtype = dtype
        self.head_dim = dim // num_q_heads
        heads = (dim, num_q_heads, num_kv_heads, self.head_dim)
        kw = dict(impl=impl, dtype=dtype, rope=rope, softcap=softcap,
                  device=device)
        self.embed_src = nn.Embedding(vocab, dim, dtype=dtype, device=device)
        self.embed_tgt = nn.Embedding(vocab, dim, dtype=dtype, device=device)
        self.enc_blocks = nn.ModuleList(EncoderBlock(*heads, **kw)
                                        for _ in range(enc_depth))
        self.enc_norm = RMSNorm(dim, dtype=dtype, device=device)
        self.dec_blocks = nn.ModuleList(Seq2SeqDecoderBlock(*heads, **kw)
                                        for _ in range(dec_depth))
        self.dec_norm = RMSNorm(dim, dtype=dtype, device=device)
        self.lm_head = nn.Linear(dim, vocab, bias=False, dtype=dtype,
                                 device=device)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def encode(self, src: torch.Tensor) -> torch.Tensor:
        """(B, S_src) tokens -> (B, S_src, D) memory."""
        x = self.embed_src(src)
        for blk in self.enc_blocks:
            x = blk(x)
        return self.enc_norm(x)

    def project_memory(self, memory: torch.Tensor) -> tuple:
        """Each decoder layer's cross (k, v), (B, Hkv, T, dh) each,
        projected once for every decode step."""
        return tuple(blk.cross_attn.project_kv(memory)
                     for blk in self.dec_blocks)

    def decode(self, tgt: torch.Tensor, memory=None, cross_kvs=None,
               caches=None):
        """Teacher forcing (``caches=None``) or a cached step over the
        target tokens, with ``memory`` (cross K/V projected in the call:
        training) or ``cross_kvs`` from `project_memory` (serving).
        Returns the float32 logits, and with caches (logits, caches)."""
        x = self.embed_tgt(tgt)
        new_caches = []
        for i, blk in enumerate(self.dec_blocks):
            kv = None if cross_kvs is None else cross_kvs[i]
            if caches is None:
                x = blk(x, memory=memory, cross_kv=kv)
            else:
                x, c = blk(x, memory=memory, cross_kv=kv, cache=caches[i])
                new_caches.append(c)
        logits = self.lm_head(self.dec_norm(x)).float()
        return logits if caches is None else (logits, tuple(new_caches))

    def forward(self, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        return self.decode(tgt, memory=self.encode(src))

    def init_caches(self, batch: int, capacity: int,
                    cache_dtype: torch.dtype | None = None) -> tuple:
        """Fresh dense `KVCache`s of ``capacity`` rows for the decoder's
        self-attention, one a layer."""
        return tuple(
            KVCache.create(batch, self.num_kv_heads, capacity, self.head_dim,
                           cache_dtype or self.dtype, self.device)
            for _ in range(self.dec_depth))


def seq2seq_loss(model: TinySeq2Seq, src: torch.Tensor,
                 tgt: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of ``tgt[:, 1:]`` given ``tgt[:,
    :-1]`` and the encoded ``src`` (teacher forcing)."""
    logits = model(src, tgt[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt[:, 1:].reshape(-1))


@torch.no_grad()
def generate_seq2seq(model: TinySeq2Seq, src, *, steps: int, bos: int = 1,
                     capacity: int | None = None) -> torch.Tensor:
    """Greedy generation: (B, S_src) source -> (B, steps) target tokens
    after ``bos``.  Encodes once, projects each decoder layer's cross K/V
    once, then ``steps`` cached decode steps.  ``capacity`` is the
    decoder family's contract: a 128-multiple of at least steps + 1, or
    None for the least."""
    src = torch.as_tensor(src).to(model.device, torch.long)
    b = src.shape[0]
    capacity = _resolve_capacity(1, steps, capacity)
    cross_kvs = model.project_memory(model.encode(src))
    caches = model.init_caches(b, capacity)
    tok = torch.full((b,), bos, dtype=torch.long, device=model.device)
    out = []
    for _ in range(steps):
        logits, caches = model.decode(tok[:, None], cross_kvs=cross_kvs,
                                      caches=caches)
        tok = logits[:, -1].argmax(dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1)
