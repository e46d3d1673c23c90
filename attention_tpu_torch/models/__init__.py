"""The port's model family (PyTorch modules around the kernels)."""

from attention_tpu_torch.models.attention_layer import (  # noqa: F401
    GQASelfAttention,
)
from attention_tpu_torch.models.convert import params_from_jax  # noqa: F401
from attention_tpu_torch.models.transformer import (  # noqa: F401
    MLP,
    TinyDecoder,
    TransformerBlock,
    init_params,
)
