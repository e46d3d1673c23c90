"""Transformer block and tiny decoder LM: the port of
`attention_tpu.models.transformer`.

Pre-norm decoder blocks (RMSNorm -> GQA attention -> residual, RMSNorm
-> GELU MLP, or a mixture of experts, -> residual), then a final RMSNorm
and a float32 logits head, with the JAX modules' dtype rules: the blocks
compute in the model dtype, the norms, the MoE router and the head in
float32.  Weights come from `init_params` (seeded, on the model's
device) or from the JAX package's flax params through
`models.convert.params_from_jax`.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from attention_tpu_torch.device import resolve_device
from attention_tpu_torch.models.attention_layer import (
    GQASelfAttention,
    KVCache,
    RollingKVCache,
)
from attention_tpu_torch.models.moe import MoEMLP

RMS_EPS = 1e-6  # flax.linen.RMSNorm's default epsilon


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + RMS_EPS)
        return (y * self.scale).to(self.dtype)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden_mult: int = 4, *,
                 dtype: torch.dtype, device):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.up = nn.Linear(dim, dim * hidden_mult, **kw)
        self.down = nn.Linear(dim * hidden_mult, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class TransformerBlock(nn.Module):
    """One pre-norm block.  ``forward(x)`` returns ``(x, aux)`` and
    ``forward(x, cache)`` returns ``(x, cache, aux)``: ``aux`` is the
    MoE layer's load-balancing loss (None for a dense MLP), returned
    rather than kept on the module so that a recomputed block (remat)
    counts it once."""

    def __init__(self, dim: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, causal: bool = True,
                 dtype: torch.dtype, window: int | None = None,
                 attn_sinks: int = 0, rope: bool = False,
                 rope_theta: float = 10000.0,
                 softcap: float | None = None,
                 moe_experts: int | None = None, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, device):
        super().__init__()
        self.norm1 = RMSNorm(dim, dtype=dtype, device=device)
        self.attn = GQASelfAttention(
            dim, num_q_heads, num_kv_heads, head_dim, causal=causal,
            dtype=dtype, window=window, attn_sinks=attn_sinks, rope=rope,
            rope_theta=rope_theta, softcap=softcap, device=device)
        self.norm2 = RMSNorm(dim, dtype=dtype, device=device)
        self.mlp = (MoEMLP(dim, moe_experts, top_k=moe_top_k,
                           capacity_factor=moe_capacity_factor, dtype=dtype,
                           device=device)
                    if moe_experts else MLP(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, cache=None):
        attn_out = self.attn(self.norm1(x), cache)
        if cache is not None:
            attn_out, cache = attn_out
        x = x + attn_out
        mlp_out, aux = self.mlp(self.norm2(x)), None
        if isinstance(self.mlp, MoEMLP):
            mlp_out, aux = mlp_out
        x = x + mlp_out
        return (x, aux) if cache is None else (x, cache, aux)


class TinyDecoder(nn.Module):
    """Decoder-only LM: embed -> ``depth`` blocks -> norm -> logits.

    ``forward(tokens)`` runs the uncached causal forward (the flash
    kernel); ``forward(tokens, caches)`` with one cache per layer
    (`KVCache`, `RaggedKVCache`, `PagedKV`, `QuantKVCache`,
    `RollingKVCache` or the serving engine's `RaggedPagedStep`) runs a
    cached step and returns ``(logits, caches)``.  ``window`` makes
    every block sliding-window attention and ``attn_sinks`` adds
    StreamingLLM sinks, in serving and in training alike.
    ``moe_experts`` puts a top-``moe_top_k`` mixture of experts
    (`MoEMLP`) in place of every block's MLP; ``return_aux=True`` then
    also returns the sum of the blocks' load-balancing losses (0.0 for
    a dense model).  ``remat=True`` recomputes each block's activations
    in the backward pass (`torch.utils.checkpoint`), and is ignored on
    cached calls.  Options of the JAX model that the port does not have
    yet (context, tensor and expert parallelism) raise
    `NotImplementedError`."""

    def __init__(self, vocab: int = 256, dim: int = 256, depth: int = 2,
                 num_q_heads: int = 8, num_kv_heads: int = 2,
                 impl: str = "flash", dtype: torch.dtype = torch.bfloat16,
                 window: int | None = None, attn_sinks: int = 0,
                 rope: bool = False, rope_theta: float = 10000.0,
                 softcap: float | None = None, remat: bool = False,
                 moe_experts: int | None = None, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 device: str | torch.device = "cuda", **unported):
        super().__init__()
        if unported:
            raise NotImplementedError(
                f"TinyDecoder options not ported yet: {sorted(unported)}")
        if impl != "flash":
            raise NotImplementedError(
                f"impl {impl!r} is not ported; the port runs 'flash'")
        device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        self.depth = depth
        self.num_q_heads = num_q_heads
        self.num_kv_heads = num_kv_heads
        self.impl = impl
        self.dtype = dtype
        self.window = window
        self.attn_sinks = attn_sinks
        self.remat = remat
        self.moe_experts = moe_experts
        self.head_dim = dim // num_q_heads
        self.embed = nn.Embedding(vocab, dim, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_q_heads, num_kv_heads, self.head_dim,
                             dtype=dtype, window=window,
                             attn_sinks=attn_sinks, rope=rope,
                             rope_theta=rope_theta, softcap=softcap,
                             moe_experts=moe_experts, moe_top_k=moe_top_k,
                             moe_capacity_factor=moe_capacity_factor,
                             device=device)
            for _ in range(depth))
        self.norm = RMSNorm(dim, dtype=dtype, device=device)
        self.head = nn.Linear(dim, vocab, bias=False, dtype=torch.float32,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, tokens: torch.Tensor, caches=None,
                return_aux: bool = False):
        x = self.embed(tokens)
        new_caches, aux = [], 0.0
        for i, block in enumerate(self.blocks):
            if caches is None:
                if self.remat:
                    x, block_aux = checkpoint(block, x, use_reentrant=False)
                else:
                    x, block_aux = block(x)
            else:
                x, c, block_aux = block(x, caches[i])
                new_caches.append(c)
            if block_aux is not None:
                aux = aux + block_aux
        logits = self.head(self.norm(x).float())
        out = logits if caches is None else (logits, tuple(new_caches))
        return (out, aux) if return_aux else out

    def init_caches(self, batch: int, capacity: int,
                    cache_dtype: torch.dtype | None = None,
                    rolling: bool = False) -> tuple:
        """Fresh per-layer dense `KVCache`s of ``capacity`` rows on the
        model's device, in ``cache_dtype`` (default: the model's).
        ``rolling=True`` (windowed models only) gives ring-buffer
        `RollingKVCache`s instead, whose memory is bounded by the window
        and the sinks, not by ``capacity``."""
        if rolling:
            if self.window is None:
                raise ValueError("rolling caches require a windowed model")
            return tuple(
                RollingKVCache.create(batch, self.num_kv_heads, self.window,
                                      self.head_dim,
                                      cache_dtype or self.dtype,
                                      self.device, sinks=self.attn_sinks)
                for _ in range(self.depth))
        return tuple(
            KVCache.create(batch, self.num_kv_heads, capacity, self.head_dim,
                           cache_dtype or self.dtype, self.device)
            for _ in range(self.depth))


def _fan_in(name: str, shape: torch.Size) -> int:
    """A weight's fan-in: a ``Linear``'s or embedding's last axis, an
    expert tensor's (E, in, out) middle one."""
    if name.endswith(("experts_up", "experts_down")):
        return shape[1]
    return shape[-1]


def init_params(model: TinyDecoder, seed: int,
                dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """A seeded random ``state_dict`` for ``model``, drawn on its device
    (the card has no JAX, so the port makes its own weights): normal
    weights with std 1/sqrt(fan_in) (embedding: 1/sqrt(dim)), norm
    scales 1, in ``dtype`` (default: each parameter's own; float32 gives
    a trainer's unrounded masters).  Load it with
    ``model.load_state_dict``."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = {}
    for name, p in model.state_dict().items():
        if name.endswith("scale"):
            params[name] = torch.ones_like(p, dtype=dtype)
            continue
        w = torch.randn(p.shape, generator=gen, device=p.device,
                        dtype=torch.float32) / _fan_in(name, p.shape) ** 0.5
        params[name] = w.to(dtype or p.dtype)
    return params
