"""Public attention API and backend registry — the port of
`attention_tpu.api`.

Backends:

  * ``oracle`` — the fp64 NumPy serial oracle (the `attention.c` role).
  * ``torch``  — the plain PyTorch version (`ops.reference`).
  * ``flash``  — the hand-written Hopper flash kernel (`ops.flash`);
                 on CPU tensors its plain version.

The distributed backends of the JAX package come with later slices.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from attention_tpu_torch.core.oracle import attention_oracle
from attention_tpu_torch.device import resolve_device
from attention_tpu_torch.ops.flash import flash_attention
from attention_tpu_torch.ops.reference import attention_reference

_BACKENDS: dict[str, Callable[..., Any]] = {
    "oracle": lambda q, k, v, **kw: attention_oracle(
        *(np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float64)
          for x in (q, k, v)), **kw),
    "torch": attention_reference,
    "flash": flash_attention,
}


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def attention(q, k, v, *, backend: str = "flash",
              device: str | torch.device = "cuda", **kwargs):
    """Compute softmax(Q Kᵀ / sqrt(dk)) V with the named backend.

    ``q``/``k``/``v`` are numpy arrays or tensors; the torch backends
    move them to ``device`` (the card by default: without one this
    raises — pass ``device="cpu"`` for the plain versions on the CPU).
    The oracle returns a float64 numpy array, the others a tensor."""
    try:
        fn = _BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: "
            f"{available_backends()}") from None
    dev = resolve_device(device)
    if backend == "oracle":
        return fn(q, k, v, **kwargs)
    q, k, v = (torch.as_tensor(x).to(dev) for x in (q, k, v))
    return fn(q, k, v, **kwargs)
