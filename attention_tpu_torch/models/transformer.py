"""Transformer block and tiny decoder LM: the port of
`attention_tpu.models.transformer`.

Pre-norm decoder blocks (RMSNorm -> GQA attention -> residual, RMSNorm
-> GELU MLP -> residual), then a final RMSNorm and a float32 logits
head, with the JAX modules' dtype rules: the blocks compute in the model
dtype, the norms in float32, the head in float32.  Weights come from
`init_params` (seeded, on the model's device) or from the JAX package's
flax params through `models.convert.params_from_jax`.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from attention_tpu_torch.device import resolve_device
from attention_tpu_torch.models.attention_layer import GQASelfAttention

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
    def __init__(self, dim: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, causal: bool = True,
                 dtype: torch.dtype, rope: bool = False,
                 rope_theta: float = 10000.0,
                 softcap: float | None = None, device):
        super().__init__()
        self.norm1 = RMSNorm(dim, dtype=dtype, device=device)
        self.attn = GQASelfAttention(
            dim, num_q_heads, num_kv_heads, head_dim, causal=causal,
            dtype=dtype, rope=rope, rope_theta=rope_theta,
            softcap=softcap, device=device)
        self.norm2 = RMSNorm(dim, dtype=dtype, device=device)
        self.mlp = MLP(dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, cache=None):
        attn_out = self.attn(self.norm1(x), cache)
        if cache is not None:
            attn_out, cache = attn_out
        x = x + attn_out
        x = x + self.mlp(self.norm2(x))
        return x if cache is None else (x, cache)


class TinyDecoder(nn.Module):
    """Decoder-only LM: embed -> ``depth`` blocks -> norm -> logits.

    ``forward(tokens)`` runs the uncached causal forward (the flash
    kernel); ``forward(tokens, caches)`` with one `RaggedPagedStep` per
    layer runs one packed serving step (the ragged kernel) and returns
    ``(logits, caches)``.  Options of the JAX model that this slice does
    not port (window, sinks, MoE, context or tensor parallelism, remat)
    raise `NotImplementedError`."""

    def __init__(self, vocab: int = 256, dim: int = 256, depth: int = 2,
                 num_q_heads: int = 8, num_kv_heads: int = 2,
                 impl: str = "flash", dtype: torch.dtype = torch.bfloat16,
                 rope: bool = False, rope_theta: float = 10000.0,
                 softcap: float | None = None,
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
        self.head_dim = dim // num_q_heads
        self.embed = nn.Embedding(vocab, dim, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_q_heads, num_kv_heads, self.head_dim,
                             dtype=dtype, rope=rope, rope_theta=rope_theta,
                             softcap=softcap, device=device)
            for _ in range(depth))
        self.norm = RMSNorm(dim, dtype=dtype, device=device)
        self.head = nn.Linear(dim, vocab, bias=False, dtype=torch.float32,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, tokens: torch.Tensor, caches=None):
        x = self.embed(tokens)
        new_caches = []
        for i, block in enumerate(self.blocks):
            if caches is None:
                x = block(x)
            else:
                x, c = block(x, caches[i])
                new_caches.append(c)
        logits = self.head(self.norm(x).float())
        return logits if caches is None else (logits, tuple(new_caches))


def init_params(model: TinyDecoder, seed: int) -> dict[str, torch.Tensor]:
    """A seeded random ``state_dict`` for ``model``, drawn on its device
    (the card has no JAX, so the port makes its own weights): normal
    weights with std 1/sqrt(fan_in) (embedding: 1/sqrt(dim)), norm
    scales 1.  Load it with ``model.load_state_dict``."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = {}
    for name, p in model.state_dict().items():
        if name.endswith("scale"):
            params[name] = torch.ones_like(p)
            continue
        fan_in = p.shape[-1]
        w = torch.randn(p.shape, generator=gen, device=p.device,
                        dtype=torch.float32) / fan_in ** 0.5
        params[name] = w.to(p.dtype)
    return params
