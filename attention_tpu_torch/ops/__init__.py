"""The port's attention operators: plain PyTorch versions and the
wrappers of the hand-written Hopper kernels (see `_native`)."""

from attention_tpu_torch.ops._native import (  # noqa: F401
    build,
    launch_counts,
    reset_launch_counts,
)
