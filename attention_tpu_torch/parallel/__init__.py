"""Distributed attention over ``torch.distributed``: the port of
`attention_tpu.parallel` (meshes and the placement policy, the
KV-sharded two-phase merge, Q-sharded, ring and Ulysses; forward
only)."""

from attention_tpu_torch.parallel.mesh import (  # noqa: F401
    KV_REPLICATE_THRESHOLD_BYTES,
    choose_kv_placement,
    default_mesh,
)
from attention_tpu_torch.parallel.kv_sharded import (  # noqa: F401
    kv_sharded_attention,
    q_sharded_attention,
)
from attention_tpu_torch.parallel.ring import ring_attention  # noqa: F401
from attention_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
)
