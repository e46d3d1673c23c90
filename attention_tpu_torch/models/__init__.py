"""The port's model family (PyTorch modules around the kernels)."""

from attention_tpu_torch.models.attention_layer import (  # noqa: F401
    GQASelfAttention,
    RollingKVCache,
)
from attention_tpu_torch.models.checkpoint import (  # noqa: F401
    complete_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from attention_tpu_torch.models.convert import (  # noqa: F401
    moe_from_jax,
    params_from_jax,
    quant_cache_from_jax,
    rolling_cache_from_jax,
)
from attention_tpu_torch.models.moe import MoEMLP  # noqa: F401
from attention_tpu_torch.models.resilient import (  # noqa: F401
    train_with_recovery,
)
from attention_tpu_torch.models.transformer import (  # noqa: F401
    MLP,
    TinyDecoder,
    TransformerBlock,
    init_params,
)
from attention_tpu_torch.models.train import (  # noqa: F401
    MasterAdamW,
    init_train,
    loss_fn,
    make_train_step,
)
