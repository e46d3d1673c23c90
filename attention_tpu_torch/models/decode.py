"""Sampling warp: the port of `attention_tpu.models.decode.warp_logits`
(the token loops `generate*` come in a later slice)."""

from __future__ import annotations

import torch


def warp_logits(logits: torch.Tensor, *, temperature: float,
                top_k: int | None, top_p: float | None) -> torch.Tensor:
    """Apply the sampling warp to (B, V) logits: temperature scaling,
    then top-k and nucleus top-p support truncation (removed entries
    become -inf).  Float32 throughout."""
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with mass >= top_p (always >= 1 token)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits
