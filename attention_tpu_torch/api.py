"""Public attention API and backend registry — the port of
`attention_tpu.api`.

Backends:

  * ``oracle`` — the fp64 NumPy serial oracle (the `attention.c` role).
  * ``torch``  — the plain PyTorch version (`ops.reference`).
  * ``flash``  — the hand-written Hopper flash kernel (`ops.flash`);
                 on CPU tensors its plain version.
  * ``kv-sharded`` — KV rows sharded over the ranks of a
                 ``torch.distributed`` world, the flash kernel's partials
                 per shard merged by the two-phase MAX/SUM softmax (the
                 `attention-mpi.c` role; `parallel.kv_sharded`).
  * ``q-sharded``  — Q rows sharded, KV whole on every rank (the
                 collective-free small-KV arm of the placement policy).
  * ``ring``   — ring attention (Q and KV sharded, KV shards rotating).
  * ``ulysses`` — all-to-all head/sequence reshard for multi-head inputs.
  * ``auto``   — q-sharded or kv-sharded by `choose_kv_placement`, the
                 reference's adaptive Bcast/Scatterv policy
                 (`attention-mpi.c:210-266`).

The distributed backends run on every rank of the default process
group (one rank without one): each rank passes the full inputs and
gets the full output (`attention_tpu_torch.parallel`).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from attention_tpu_torch.core.oracle import attention_oracle
from attention_tpu_torch.device import resolve_device
from attention_tpu_torch.ops.flash import flash_attention
from attention_tpu_torch.ops.reference import attention_reference
from attention_tpu_torch.parallel import (
    choose_kv_placement,
    default_mesh,
    kv_sharded_attention,
    q_sharded_attention,
    ring_attention,
    ulysses_attention,
)


def _auto(q, k, v, threshold_bytes=None, **kw):
    """The adaptive distribution policy (`attention-mpi.c:210-266`):
    small KV -> replicate KV and shard Q (no per-call collectives);
    large KV -> shard KV rows and merge by the two-phase softmax.  With
    the call's shapes the decision is `choose_kv_placement`'s byte
    model; an explicit ``threshold_bytes`` forces its bytes-only
    comparison (the escape hatch and test hook)."""
    mesh = kw.get("mesh") or default_mesh(kw.get("axis_name", "kv"))
    kw["mesh"] = mesh
    kv_heads = int(np.prod(k.shape[:-2]))
    shape = dict(itemsize=k.element_size(), kv_heads=kv_heads)
    if threshold_bytes is not None:
        shape.update(threshold_bytes=threshold_bytes)
    else:
        shape.update(m=q.shape[-2], q_heads=int(np.prod(q.shape[:-2])),
                     n_devices=mesh.shape[kw.get("axis_name", "kv")])
    if choose_kv_placement(k.shape[-2], k.shape[-1], v.shape[-1],
                           **shape) == "replicate":
        kw.pop("impl", None)  # q-sharded is always the flash kernel
        return q_sharded_attention(q, k, v, **kw)
    return kv_sharded_attention(q, k, v, **kw)


_BACKENDS: dict[str, Callable[..., Any]] = {
    "oracle": lambda q, k, v, **kw: attention_oracle(
        *(np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float64)
          for x in (q, k, v)), **kw),
    "torch": attention_reference,
    "flash": flash_attention,
    "kv-sharded": kv_sharded_attention,
    "q-sharded": q_sharded_attention,
    "ring": ring_attention,
    "ulysses": ulysses_attention,
    "auto": _auto,
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
