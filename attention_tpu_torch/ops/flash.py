"""Forward flash attention: the port of `attention_tpu.ops.flash`.

`flash_attention` keeps the JAX entry point's keywords for the set the
port supports (``scale``, ``causal``, ``softcap``, the offsets
``q_offset``/``kv_offset`` and ``kv_valid`` of cached prefill, GQA over
2-D, 3-D and 4-D inputs); `flash_attention_partials` returns the
unnormalized output with the row stats instead, as training's forward
saves them.  For a CUDA tensor both launch the hand-written Hopper kernel
``csrc/flash_fwd.cu`` (which replaces the TPU kernel `_flash_kernel`);
for a CPU tensor they run `flash_attention_plain` and
`flash_attention_partials_plain`, the plain PyTorch versions of the same
functions.  The remaining keywords of the JAX entry point raise
`NotImplementedError` until a later slice ports them.
"""

from __future__ import annotations

import torch

from attention_tpu_torch.ops import _native
from attention_tpu_torch.ops._native import (
    DTYPE_CODES,
    MAX_HEAD_DIM,
    F,
    I,
    L,
    P,
)
from attention_tpu_torch.ops.reference import (
    attention_reference,
    attention_reference_partials,
    check_softcap,
)

KERNEL = "flash_fwd"
_ARGTYPES = [P, P, P, P, I, I, I, I, I, I, I, I,
             *([L] * 12), F, F, I, I, I, I, P, P, P, P]


def _canon(q, k, v):
    """Validate (m, d) / (h, m, d) / (b, h, m, d) inputs, as the JAX
    package's ``_canon`` does, and return 4-D (b, h, m, d) views."""
    if q.dim() != k.dim() or q.dim() != v.dim():
        raise ValueError(
            f"rank mismatch: Q{tuple(q.shape)} K{tuple(k.shape)} "
            f"V{tuple(v.shape)}")
    if q.shape[-1] != k.shape[-1] or k.shape[-2] != v.shape[-2]:
        raise ValueError(
            f"shape mismatch: Q{tuple(q.shape)} K{tuple(k.shape)} "
            f"V{tuple(v.shape)}")
    if k.shape[:-2] != v.shape[:-2]:
        raise ValueError(
            f"K/V head dims differ: K{tuple(k.shape)} V{tuple(v.shape)}")
    if q.dim() == 4 and q.shape[0] != k.shape[0]:
        raise ValueError(
            f"batch mismatch: Q{tuple(q.shape)} K{tuple(k.shape)}")
    if q.dim() >= 3 and q.shape[-3] % k.shape[-3] != 0:
        raise ValueError(
            f"q heads {q.shape[-3]} not a multiple of kv heads "
            f"{k.shape[-3]}")
    if q.dim() not in (2, 3, 4):
        raise ValueError(f"unsupported rank {q.dim()} for flash attention")
    lead = 4 - q.dim()
    return tuple(t[(None,) * lead] for t in (q, k, v))


def _offsets(n, q_offset, kv_offset, kv_valid) -> dict:
    """The offsets as ints, ``kv_valid`` (default n) cut to [0, n]."""
    return dict(q_offset=int(q_offset or 0), kv_offset=int(kv_offset or 0),
                kv_valid=n if kv_valid is None
                else min(max(int(kv_valid), 0), n))


def _unsupported(**features) -> None:
    for name, value in features.items():
        if value is not None:
            raise NotImplementedError(
                f"flash attention's {name}=... is not ported yet; the port "
                "supports scale, causal, softcap, q_offset, kv_offset and "
                "kv_valid")


def flash_attention_plain(q, k, v, *, scale=None, causal=False,
                          softcap=None, q_offset=0, kv_offset=0,
                          kv_valid=None) -> torch.Tensor:
    """The plain PyTorch version of `flash_attention` (same inputs,
    same output dtype: ``v.dtype``)."""
    _canon(q, k, v)
    return attention_reference(q, k, v, scale=scale, causal=causal,
                               softcap=softcap, q_offset=q_offset,
                               kv_offset=kv_offset, kv_valid=kv_valid)


def flash_attention_partials_plain(q, k, v, *, scale=None, causal=False,
                                   softcap=None, q_offset=0, kv_offset=0,
                                   kv_valid=None):
    """The plain PyTorch version of `flash_attention_partials`."""
    _canon(q, k, v)
    return attention_reference_partials(
        q, k, v, scale=scale, causal=causal, softcap=softcap,
        q_offset=q_offset, kv_offset=kv_offset, kv_valid=kv_valid)


def _launch(q4, k4, v4, *, scale, causal, softcap, q_offset, kv_offset,
            kv_valid, partials=False):
    dtype = q4.dtype
    if dtype not in DTYPE_CODES or k4.dtype != dtype or v4.dtype != dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q4.dtype}/{k4.dtype}/{v4.dtype}")
    if not (q4.device == k4.device == v4.device):
        raise ValueError("q, k and v must be on one device")
    b, h, m, dk = q4.shape
    hkv, n, dv = k4.shape[1], k4.shape[2], v4.shape[-1]
    if max(dk, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {dk}/{dv} exceed {MAX_HEAD_DIM}")
    if min(m, n) < 1:
        raise ValueError(f"empty attention: m={m} n={n}")
    q4, k4, v4 = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in (q4, k4, v4))
    # (b, m, h, dv) storage: the attention layer's head merge is a view
    o4 = torch.empty((b, m, h, dv), dtype=torch.float32 if partials
                     else dtype, device=q4.device).transpose(1, 2)
    stats = (torch.empty((2, b, h, m), dtype=torch.float32,
                         device=q4.device) if partials else None)
    fn = _native.function(KERNEL, "flash_fwd", _ARGTYPES)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                 None if partials else o4.data_ptr(),
                 DTYPE_CODES[dtype], b, h, hkv, m, n, dk, dv,
                 *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
                 *o4.stride()[:3], float(scale),
                 float(softcap or 0.0), int(causal), q_offset, kv_offset,
                 kv_valid, *((o4.data_ptr(), stats[0].data_ptr(),
                              stats[1].data_ptr()) if partials
                             else (None, None, None)), stream)
    _native.check(KERNEL, err)
    _native.count_launch(KERNEL)
    return (o4, stats[0], stats[1]) if partials else o4


def _dispatch(q, k, v, plain, *, scale, causal, softcap, window, sinks,
              q_segment_ids, kv_segment_ids, q_offset, kv_offset, kv_valid,
              max_mode, partials):
    """Shared argument handling of the two entry points: validate, then
    the plain version for CPU tensors or the kernel for CUDA ones."""
    _unsupported(window=window, sinks=sinks, q_segment_ids=q_segment_ids,
                 kv_segment_ids=kv_segment_ids)
    if max_mode != "online":
        raise NotImplementedError(
            f"max_mode={max_mode!r} is not ported yet; only 'online'")
    check_softcap(softcap)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    q4, k4, v4 = _canon(q, k, v)
    offsets = _offsets(k.shape[-2], q_offset, kv_offset, kv_valid)
    if q.device.type == "cpu":
        return plain(q, k, v, scale=scale, causal=causal, softcap=softcap,
                     **offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    lead = (0,) * (4 - q.dim())
    out = _launch(q4, k4, v4, scale=scale, causal=causal, softcap=softcap,
                  partials=partials, **offsets)
    if partials:
        return tuple(t[lead] for t in out)
    return out[lead]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = False,
    softcap: float | None = None,
    window: int | None = None,
    sinks: int | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    q_offset=None,
    kv_offset=None,
    kv_valid=None,
    max_mode: str = "online",
) -> torch.Tensor:
    """Fused single-device attention: softmax(q kᵀ · scale) v.

    Accepts (m, d), (h, m, d) or (b, h, m, d) inputs with dk != dv
    allowed; for 3-D/4-D inputs the KV head count may divide the Q head
    count (GQA).  ``kv_valid`` (int) attends only the first ``kv_valid``
    key rows.  ``causal`` masks with global positions: query row i sits
    at ``q_offset + i`` and key row j at ``kv_offset + j`` (ints, default
    0).  ``softcap`` applies cap·tanh(s/cap) to the scaled scores before
    masking.  A row that sees no key comes out zero.  Output dtype is
    ``v.dtype``.  CUDA tensors run the Hopper kernel; CPU tensors run
    `flash_attention_plain`."""
    return _dispatch(q, k, v, flash_attention_plain, scale=scale,
                     causal=causal, softcap=softcap, window=window,
                     sinks=sinks, q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids, q_offset=q_offset,
                     kv_offset=kv_offset, kv_valid=kv_valid,
                     max_mode=max_mode, partials=False)


def flash_attention_partials(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = False,
    softcap: float | None = None,
    window: int | None = None,
    sinks: int | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    q_offset=None,
    kv_offset=None,
    kv_valid=None,
    max_mode: str = "online",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized attention with its row stats, as JAX's
    `flash_attention_partials`: ``(out_unnorm, row_max, row_sum)`` in
    float32, shapes (..., m, dv), (..., m), (..., m).  ``out_unnorm`` is
    the sum over keys of exp(s - row_max)·v, ``row_max`` the row's
    largest masked score in the natural-log domain (-inf for a row that
    sees no key, whose sum is then 0), ``row_sum`` the sum of
    exp(s - row_max).  Same inputs and keywords as `flash_attention`.
    CUDA tensors run the Hopper kernel's partials epilogue; CPU tensors
    run `flash_attention_partials_plain`."""
    return _dispatch(q, k, v, flash_attention_partials_plain, scale=scale,
                     causal=causal, softcap=softcap, window=window,
                     sinks=sinks, q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids, q_offset=q_offset,
                     kv_offset=kv_offset, kv_valid=kv_valid,
                     max_mode=max_mode, partials=True)
