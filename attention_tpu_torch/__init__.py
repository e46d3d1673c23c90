"""attention_tpu_torch: the PyTorch/CUDA port of attention_tpu.

The JAX package `attention_tpu` stays the reference; this package
mirrors its module names (``core``, ``ops``, ``models``, ``engine``,
``api``, ``cli``) and runs on an NVIDIA H100.  Each TPU kernel on a
ported path has a hand-written CUDA kernel for ``sm_90a`` under
``csrc/``, built at first use into ``_build/`` and launched through a
wrapper that counts its launches (`ops.launch_counts`); beside each
kernel sits its plain PyTorch version, which the wrapper runs for CPU
tensors only.  Entry points run on the card unless the caller passes
``device="cpu"``.  The package imports neither JAX nor `attention_tpu`.
"""

from attention_tpu_torch.api import attention, available_backends  # noqa: F401
