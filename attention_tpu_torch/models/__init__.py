"""The port's model family (PyTorch modules around the kernels)."""

from attention_tpu_torch.models.attention_layer import (  # noqa: F401
    ATTN_IMPLS,
    GQASelfAttention,
    KVCache,
    QuantKVCache,
    RaggedKVCache,
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
    seq2seq_params_from_jax,
)
from attention_tpu_torch.models.cross_attention import (  # noqa: F401
    GQACrossAttention,
)
from attention_tpu_torch.models.decode import (  # noqa: F401
    decode_step,
    generate,
    generate_beam,
    generate_paged,
    generate_ragged,
    prefill,
)
from attention_tpu_torch.models.moe import MoEMLP  # noqa: F401
from attention_tpu_torch.models.pipeline import (  # noqa: F401
    init_pipelined_train,
    make_pipelined_train_step,
    pipelined_forward,
    pipelined_loss,
    stack_block_params,
)
from attention_tpu_torch.models.resilient import (  # noqa: F401
    train_with_recovery,
)
from attention_tpu_torch.models.seq2seq import (  # noqa: F401
    TinySeq2Seq,
    generate_seq2seq,
    seq2seq_loss,
)
from attention_tpu_torch.models.speculative import (  # noqa: F401
    generate_speculative,
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
    make_mesh_3d,
    make_train_step,
    value_and_grad,
)
