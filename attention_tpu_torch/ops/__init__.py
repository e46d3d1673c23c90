"""The port's attention operators: plain PyTorch versions and the
wrappers of the hand-written Hopper kernels (see `_native`)."""

from attention_tpu_torch.ops._native import (  # noqa: F401
    build,
    demotion_count,
    launch_counts,
    reset_launch_counts,
    variant_counts,
)
from attention_tpu_torch.ops.paged import (  # noqa: F401
    OutOfPagesError,
    PageAccountingError,
    PagedKV,
    PagePool,
    paged_append,
    paged_append_chunk,
    paged_flash_decode,
    paged_fork,
    paged_from_dense,
    recommended_page_size,
)
