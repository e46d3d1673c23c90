"""Rotary position embeddings (RoPE), split-half convention.

Counterpart of `attention_tpu.ops.rope`: the head dim splits into two
halves that form the (real, imag) parts of dh/2 complex pairs, rotated
by the row's position.  Math in float32, result in ``x.dtype``.
"""

from __future__ import annotations

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for ``positions`` (any shape), float32, of
    shape ``positions.shape + (head_dim // 2,)``."""
    if head_dim % 2:
        raise ValueError(f"RoPE requires an even head_dim, got {head_dim}")
    half = head_dim // 2
    exponent = -torch.arange(half, dtype=torch.float32,
                             device=positions.device) / half
    inv_freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                      device=positions.device), exponent)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` (..., S, dh) by its per-row ``positions`` (..., S),
    which broadcast against x's leading axes."""
    half = x.shape[-1] // 2
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
