"""Flax -> PyTorch weight conversion for the TinyDecoder family.

`params_from_jax` takes the JAX package's flax param tree as nested
dicts of numpy arrays (``jax.device_get`` of ``model.init(...)
["params"]``) and returns the port's ``state_dict``.  The mapping:
``DenseGeneral``/``Dense`` kernels (in, ..., out) become ``nn.Linear``
weights (out, in) by flattening the feature axes and transposing,
``Embed`` embeddings, ``RMSNorm`` scales and ``MoEMLP``'s experts (E, d,
h), (E, h, d) carry over unchanged (its router kernel is a ``Dense``
kernel, `moe_from_jax`).  `seq2seq_params_from_jax` maps a flax
`TinySeq2Seq` tree the same way.
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
        "norm.scale": _scale(tree["RMSNorm_0"]),
        "head.weight": _linear(tree["Dense_0"]["kernel"]),
    }
    depth = sum(1 for key in tree if key.startswith("TransformerBlock_"))
    for i in range(depth):
        blk = tree[f"TransformerBlock_{i}"]
        pre = f"blocks.{i}."
        sd[pre + "norm1.scale"] = _scale(blk["RMSNorm_0"])
        sd[pre + "norm2.scale"] = _scale(blk["RMSNorm_1"])
        sd.update(_attention_from_jax(blk["GQASelfAttention_0"],
                                      pre + "attn"))
        if "MoEMLP_0" in blk:
            sd.update({pre + "mlp." + k: v
                       for k, v in moe_from_jax(blk["MoEMLP_0"]).items()})
        else:
            sd.update(_mlp_from_jax(blk["MLP_0"], pre + "mlp"))
    return sd


def _attention_from_jax(tree, pre: str) -> dict[str, torch.Tensor]:
    """An attention layer's four projections (self or cross: q, k, v
    (D, heads, dh) and o (heads·dh, D) kernels) under ``pre``."""
    return {f"{pre}.{name}.weight": _linear(tree[name]["kernel"])
            for name in ("q_proj", "k_proj", "v_proj", "o_proj")}


def _mlp_from_jax(tree, pre: str) -> dict[str, torch.Tensor]:
    return {f"{pre}.up.weight": _linear(tree["Dense_0"]["kernel"]),
            f"{pre}.down.weight": _linear(tree["Dense_1"]["kernel"])}


def _scale(tree) -> torch.Tensor:
    return torch.from_numpy(np.array(tree["scale"]))


def seq2seq_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The port's `TinySeq2Seq` ``state_dict`` (float32 tensors on the
    CPU) from a flax TinySeq2Seq param (or gradient) tree of numpy
    arrays: ``embed_src``/``embed_tgt`` embeddings, ``enc_blocks_{i}``
    (``RMSNorm_0``/``_1``, ``GQASelfAttention_0``, ``MLP_0``),
    ``dec_blocks_{i}`` (``self_attn``, ``cross_attn``, ``norm_self``,
    ``norm_cross``, ``norm_mlp``, ``mlp``), ``enc_norm``, ``dec_norm``
    and the ``lm_head`` kernel."""
    sd = {f"{name}.weight": torch.from_numpy(np.array(tree[name]["embedding"]))
          for name in ("embed_src", "embed_tgt")}
    sd["enc_norm.scale"] = _scale(tree["enc_norm"])
    sd["dec_norm.scale"] = _scale(tree["dec_norm"])
    sd["lm_head.weight"] = _linear(tree["lm_head"]["kernel"])
    for key, blk in tree.items():
        if key.startswith("enc_blocks_"):
            pre = f"enc_blocks.{key[len('enc_blocks_'):]}"
            sd[pre + ".norm1.scale"] = _scale(blk["RMSNorm_0"])
            sd[pre + ".norm2.scale"] = _scale(blk["RMSNorm_1"])
            sd.update(_attention_from_jax(blk["GQASelfAttention_0"],
                                          pre + ".attn"))
            sd.update(_mlp_from_jax(blk["MLP_0"], pre + ".mlp"))
        elif key.startswith("dec_blocks_"):
            pre = f"dec_blocks.{key[len('dec_blocks_'):]}"
            for name in ("norm_self", "norm_cross", "norm_mlp"):
                sd[f"{pre}.{name}.scale"] = _scale(blk[name])
            for name in ("self_attn", "cross_attn"):
                sd.update(_attention_from_jax(blk[name], f"{pre}.{name}"))
            sd.update(_mlp_from_jax(blk["mlp"], pre + ".mlp"))
    return sd


def moe_from_jax(tree) -> dict[str, torch.Tensor]:
    """An `MoEMLP` ``state_dict`` from a flax ``MoEMLP`` tree (params or
    gradients): the (d, E) router kernel as a ``Linear`` weight, the
    experts unchanged."""
    return {"router.weight": _linear(tree["router"]),
            "experts_up": torch.from_numpy(np.array(tree["experts_up"])),
            "experts_down": torch.from_numpy(np.array(tree["experts_down"]))}


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
