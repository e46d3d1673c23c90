"""Flax -> PyTorch weight conversion for the TinyDecoder family.

`params_from_jax` takes the JAX package's flax param tree as nested
dicts of numpy arrays (``jax.device_get`` of ``model.init(...)
["params"]``) and returns the port's ``state_dict``.  The mapping:
``DenseGeneral``/``Dense`` kernels (in, ..., out) become ``nn.Linear``
weights (out, in) by flattening the feature axes and transposing,
``Embed`` embeddings and ``RMSNorm`` scales carry over unchanged.  This
module imports neither JAX nor flax: the caller hands over numpy.
"""

from __future__ import annotations

import numpy as np
import torch


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
