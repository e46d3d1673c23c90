"""Distributed attention over ``torch.distributed``: the port of
`attention_tpu.parallel` (meshes and the placement policy, the
KV-sharded two-phase merge, Q-sharded, ring and Ulysses, and the
differentiable context-parallel paths that training runs:
`cp_flash_attention`, `ring_attention_diff` and Ulysses, sharded
serving: the head-sharded cached-path kernels and the cache-sharded
decode of `parallel.serving`, and GPipe's `pipeline_apply`)."""

from attention_tpu_torch.parallel.mesh import (  # noqa: F401
    KV_REPLICATE_THRESHOLD_BYTES,
    choose_kv_placement,
    default_mesh,
    grid_mesh,
)
from attention_tpu_torch.parallel.kv_sharded import (  # noqa: F401
    kv_sharded_attention,
    q_sharded_attention,
)
from attention_tpu_torch.parallel.cp import cp_flash_attention  # noqa: F401
from attention_tpu_torch.parallel.ring import (  # noqa: F401
    ring_attention,
    ring_attention_diff,
)
from attention_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
)
from attention_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
)
from attention_tpu_torch.parallel.serving import (  # noqa: F401
    MeshConfigError,
    cache_sharded_decode,
    head_sharded_decode,
    head_sharded_decode_paged,
    head_sharded_decode_quantized,
    head_sharded_prefill,
    head_sharded_ragged_step,
)
