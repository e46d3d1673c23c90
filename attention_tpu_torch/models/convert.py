"""Flax -> PyTorch weight conversion for the TinyDecoder family.

`params_from_jax` takes the JAX package's flax param tree as nested
dicts of numpy arrays (``jax.device_get`` of ``model.init(...)
["params"]``) and returns the port's ``state_dict``.  The mapping:
``DenseGeneral``/``Dense`` kernels (in, ..., out) become ``nn.Linear``
weights (out, in) by flattening the feature axes and transposing,
``Embed`` embeddings and ``RMSNorm`` scales carry over unchanged.
A gradient tree (``jax.grad`` of a loss over the params) has the params'
structure, so `params_from_jax` maps it too: the training parity tests
compare the port's ``.grad`` tensors with it, and need nothing more.
`quant_cache_from_jax` carries a quantized KV cache across, and
`rolling_cache_from_jax` a ring-buffer one.  This module imports neither
JAX nor flax: the caller hands over numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from attention_tpu_torch.models.attention_layer import RollingKVCache
from attention_tpu_torch.ops import quant


def _linear(kernel) -> torch.Tensor:
    """A flax kernel (in, *features) as an (out, in) Linear weight."""
    k = np.asarray(kernel)
    return torch.from_numpy(np.ascontiguousarray(k.reshape(k.shape[0], -1).T))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The port's TinyDecoder ``state_dict`` (float32 tensors on the
    CPU; ``load_state_dict`` casts and moves them) from a flax
    TinyDecoder param tree of numpy arrays."""
    sd = {
        "embed.weight": torch.from_numpy(
            np.array(tree["Embed_0"]["embedding"])),
        "norm.scale": torch.from_numpy(np.array(tree["RMSNorm_0"]["scale"])),
        "head.weight": _linear(tree["Dense_0"]["kernel"]),
    }
    depth = sum(1 for key in tree if key.startswith("TransformerBlock_"))
    for i in range(depth):
        blk = tree[f"TransformerBlock_{i}"]
        attn = blk["GQASelfAttention_0"]
        pre = f"blocks.{i}."
        sd[pre + "norm1.scale"] = torch.from_numpy(
            np.array(blk["RMSNorm_0"]["scale"]))
        sd[pre + "norm2.scale"] = torch.from_numpy(
            np.array(blk["RMSNorm_1"]["scale"]))
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[pre + f"attn.{name}.weight"] = _linear(attn[name]["kernel"])
        sd[pre + "mlp.up.weight"] = _linear(blk["MLP_0"]["Dense_0"]["kernel"])
        sd[pre + "mlp.down.weight"] = _linear(
            blk["MLP_0"]["Dense_1"]["kernel"])
    return sd


def quant_cache_from_jax(kv):
    """The port's quantized cache from a JAX package one (`QuantizedKV`,
    `Int4KV` or `Int4TokKV` of numpy arrays, told apart by type name):
    the same int8 bytes, and the scales as one float32 per token, (B,
    Hkv, N) in token order.  The JAX scales repeat each value over 8
    sublanes (row 0 is taken), or for the token-paired layout hold the
    even tokens' scales in rows 0-7 and the odd ones' in rows 8-15 (rows
    0 and 8 are interleaved).  Tensors on the CPU."""
    kind = {"QuantizedKV": quant.QuantizedKV, "Int4KV": quant.Int4KV,
            "Int4TokKV": quant.Int4TokKV}[type(kv).__name__]

    def scales(s):
        s = np.asarray(s, np.float32)
        if kind is quant.Int4TokKV:
            s = np.stack([s[:, :, 0], s[:, :, 8]], axis=-1)
            return s.reshape(*s.shape[:2], -1)
        return s[:, :, 0]

    return kind(*(torch.from_numpy(np.array(x)) for x in (
        kv.k_q, scales(kv.k_scale), kv.v_q, scales(kv.v_scale))))


def rolling_cache_from_jax(cache) -> RollingKVCache:
    """The port's `RollingKVCache` from a JAX package one of numpy
    arrays: the same slots, the length as an int.  Tensors on the
    CPU."""
    return RollingKVCache(torch.from_numpy(np.array(cache.k)),
                          torch.from_numpy(np.array(cache.v)),
                          int(cache.length))
