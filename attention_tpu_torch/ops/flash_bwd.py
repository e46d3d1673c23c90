"""Flash-attention backward: the port of `attention_tpu.ops.flash_bwd`.

`flash_backward` takes the forward's inputs, its output and the saved
log-sum-exp, and the output's gradient, and returns (dQ, dK, dV).  For
CUDA tensors it launches the hand-written Hopper kernels: by default the
fused single-pass kernel ``csrc/flash_bwd_fused.cu`` (replaces
`_fused_bwd_kernel`), or, with the module global `_FORCE_TWO_KERNEL`
set, the pair ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``
(replace `_dq_kernel` and `_dkv_kernel`).  For CPU tensors it runs
`flash_backward_plain`, the plain PyTorch version of the same function:
the blocked recompute of `attention_tpu.ops.flash_vjp` (``bwd_impl=
"xla"``) with the kernels' rounding.

The numerics are the JAX kernels' (`flash_bwd.py:545-550`): Q is
pre-scaled by scale·log2(e) and rounded to the input dtype, P is
recomputed as exp2(S - lse·log2 e) (0 where masked or where the forward
saw no key), delta = rowsum(dO ∘ O) is taken in float32 outside the
kernels, softcap chains through 1 - tanh², P and dS are rounded to the
input dtype before each product, dK picks up ln 2 and dQ the plain
``scale``.  The fused kernel is the default on every shape: the card has
no resident-dQ VMEM limit, so the TPU's fused plan and its Q-row chunk
loop have no counterpart here.
"""

from __future__ import annotations

import math

import torch

from attention_tpu_torch.ops import _native
from attention_tpu_torch.ops._native import DTYPE_CODES, F, I, L, P
from attention_tpu_torch.ops.flash import _offsets, _unsupported
from attention_tpu_torch.ops.reference import check_softcap

LOG2E = 1.0 / math.log(2.0)
LN2 = math.log(2.0)
#: launch counters of the three kernels (one library each)
FUSED, DQ, DKV = "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"
#: largest head dim the backward kernels take
MAX_HEAD_DIM = 128
_ARGTYPES = [*([P] * 10), *([I] * 8), *([L] * 12), F, F, I, I, I, I, P]

# Send CUDA calls to the two-kernel pair (dQ, then dK/dV) instead of the
# fused kernel: a module global, as in the JAX package, that tests and
# the smoke set to run the pair.
_FORCE_TWO_KERNEL = False


def _four_d(*tensors):
    """(h, m, d) or (b, h, m, d) inputs as 4-D views, with the index that
    takes a 4-D result back to the inputs' rank."""
    rank = tensors[0].dim()
    if rank not in (3, 4) or any(t.dim() != rank for t in tensors):
        raise ValueError(
            "flash backward takes (h, m, d) or (b, h, m, d) tensors of one "
            f"rank, got {[tuple(t.shape) for t in tensors]}")
    lead = (0,) * (4 - rank)
    return [t[(None,) * len(lead)] for t in tensors], lead


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).float()


def flash_backward_plain(q, k, v, out, lse, dout, *, scale, causal=False,
                         softcap=None, q_offset=0, kv_offset=0,
                         kv_valid=None, chunk=512):
    """The plain PyTorch version of `flash_backward` (same inputs and
    outputs), blocked over ``chunk`` query rows so that memory stays
    O(chunk·n) per head."""
    (q4, k4, v4, o4, l4, do4), lead = _four_d(
        q, k, v, out, lse[..., None], dout)
    dtype = q.dtype
    b, h, m, d = q4.shape
    hkv, n, dv = v4.shape[1:]
    group = h // hkv
    valid = n if kv_valid is None else kv_valid
    kx = k4.repeat_interleave(group, dim=1).float()
    vx = v4.repeat_interleave(group, dim=1).float()
    qs = _round(q4.float() * (scale * LOG2E), dtype)
    do = _round(do4.float(), dtype)
    lse2 = l4[..., 0].float() * LOG2E
    delta = (do4.float() * o4.float()).sum(-1)
    cap2 = None if softcap is None else softcap * LOG2E
    col = torch.arange(n, device=q.device)
    dq = torch.empty((b, h, m, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
    dvx = torch.zeros((b, h, n, dv), dtype=torch.float32, device=q.device)
    for s0 in range(0, m, chunk):
        rows = slice(s0, min(s0 + chunk, m))
        s2 = torch.matmul(qs[:, :, rows], kx.transpose(-1, -2))
        dcap = None
        if cap2 is not None:
            t = torch.tanh(s2 / cap2)
            s2 = cap2 * t
            dcap = 1.0 - t * t
        l2 = lse2[:, :, rows, None]
        keep = (col < valid)[None, :] & (l2 != float("-inf"))
        if causal:
            row = torch.arange(rows.start, rows.stop, device=q.device)
            keep = keep & (col[None, :] + kv_offset <= row[:, None]
                           + q_offset)
        p = torch.where(keep, torch.exp2(s2 - l2), 0.0)
        dp = torch.matmul(do[:, :, rows], vx.transpose(-1, -2))
        ds = p * (dp - delta[:, :, rows, None])
        if dcap is not None:
            ds = ds * dcap
        p, ds = _round(p, dtype), _round(ds, dtype)
        dq[:, :, rows] = torch.matmul(ds, kx) * scale
        dk += torch.matmul(ds.transpose(-1, -2), qs[:, :, rows])
        dvx += torch.matmul(p.transpose(-1, -2), do[:, :, rows])
    dk = (dk * LN2).view(b, hkv, group, n, d).sum(2)
    dvx = dvx.view(b, hkv, group, n, dv).sum(2)
    return dq.to(dtype)[lead], dk.to(k.dtype)[lead], dvx.to(v.dtype)[lead]


def _prepare(q4, k4, v4, o4, lse4, do4, *, scale, causal, softcap,
             q_offset, kv_offset, kv_valid):
    """Check the 4-D CUDA operands and stage what the kernels read (Qs,
    dO in the input dtype, lse2 and delta in float32); returns
    ``run(kernel, dq32=, dq=, dk=, dvo=)``, which launches one backward
    kernel into the given outputs."""
    dtype = q4.dtype
    if dtype not in DTYPE_CODES or k4.dtype != dtype or v4.dtype != dtype:
        raise TypeError(
            "flash backward kernels take float32 or bfloat16 q/k/v of one "
            f"dtype, got {q4.dtype}/{k4.dtype}/{v4.dtype}")
    if len({t.device for t in (q4, k4, v4, o4, lse4, do4)}) != 1:
        raise ValueError("flash backward's tensors must be on one device")
    b, h, m, d = q4.shape
    hkv, n, dv = v4.shape[1:]
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
    if min(m, n) < 1:
        raise ValueError(f"empty attention: m={m} n={n}")
    qs = (q4.float() * (scale * LOG2E)).to(dtype)
    do = do4.to(dtype)
    qs, k4, v4, do = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (qs, k4, v4, do))
    lse2 = (lse4.float() * LOG2E).contiguous()
    delta = (do4.float() * o4.float()).sum(-1).contiguous()

    def run(kernel, dq32=None, dq=None, dk=None, dvo=None):
        fn = _native.function(kernel, kernel, _ARGTYPES)
        with torch.cuda.device(q4.device):
            stream = torch.cuda.current_stream(q4.device).cuda_stream
            err = fn(qs.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                     do.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                     *(None if t is None else t.data_ptr()
                       for t in (dq32, dq, dk, dvo)),
                     DTYPE_CODES[dtype], b, h, hkv, m, n, d, dv,
                     *qs.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
                     *do.stride()[:3], float(scale),
                     float(softcap * LOG2E if softcap else 0.0), int(causal),
                     q_offset, kv_offset, kv_valid, stream)
        _native.check(kernel, err)
        _native.count_launch(kernel)

    return run


def _launch(q4, k4, v4, o4, lse4, do4, **kw):
    """The fused kernel, or the dQ and dK/dV pair under
    `_FORCE_TWO_KERNEL`, on 4-D CUDA operands."""
    run = _prepare(q4, k4, v4, o4, lse4, do4, **kw)
    dtype = q4.dtype
    b, h, m, d = q4.shape
    hkv, n, dv = v4.shape[1:]
    f32 = dict(dtype=torch.float32, device=q4.device)
    if not _FORCE_TWO_KERNEL:
        dq32 = torch.zeros((b, h, m, d), **f32)
        dkp = torch.empty((b, h, n, d), **f32)
        dvp = torch.empty((b, h, n, dv), **f32)
        run(FUSED, dq32=dq32, dk=dkp, dvo=dvp)
        # per-Q-head partials, summed over each GQA group
        dk32 = dkp.view(b, hkv, h // hkv, n, d).sum(2)
        dv32 = dvp.view(b, hkv, h // hkv, n, dv).sum(2)
        return dq32.to(dtype), dk32.to(dtype), dv32.to(dtype)
    dq = torch.empty((b, h, m, d), dtype=dtype, device=q4.device)
    run(DQ, dq=dq)
    dk32 = torch.empty((b, hkv, n, d), **f32)
    dv32 = torch.empty((b, hkv, n, dv), **f32)
    run(DKV, dk=dk32, dvo=dv32)
    return dq, dk32.to(dtype), dv32.to(dtype)


def flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    scale: float,
    causal: bool = False,
    softcap: float | None = None,
    q_offset=None,
    kv_offset=None,
    kv_valid=None,
    window: int | None = None,
    sinks: int | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    block_sizes=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of flash attention from the saved forward.

    q (..., h, m, d), k (..., hkv, n, d), v (..., hkv, n, dv), out and
    dout (..., h, m, dv), lse (..., h, m) in the natural-log domain (-inf
    for a row that saw no key); 3-D or 4-D, hkv dividing h (GQA).
    ``scale``, ``causal``, ``softcap``, ``q_offset``/``kv_offset`` and
    ``kv_valid`` must be the forward's.  Gradients come back in the
    inputs' dtypes.  CUDA tensors run the fused Hopper kernel (or the dQ
    and dK/dV pair under `_FORCE_TWO_KERNEL`), float32 or bfloat16, head
    dims up to 128; CPU tensors run `flash_backward_plain`.  ``window``,
    ``sinks``, segment ids and ``block_sizes`` are not ported and
    raise `NotImplementedError`."""
    _unsupported(window=window, sinks=sinks, q_segment_ids=q_segment_ids,
                 kv_segment_ids=kv_segment_ids, block_sizes=block_sizes)
    check_softcap(softcap)
    offsets = _offsets(k.shape[-2], q_offset, kv_offset, kv_valid)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, dout, scale=scale,
                                    causal=causal, softcap=softcap,
                                    **offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on cuda or cpu, not "
                         f"{q.device.type}")
    tensors, lead = _four_d(q, k, v, out, lse[..., None], dout)
    tensors[4] = tensors[4][..., 0]
    return tuple(t[lead] for t in _launch(
        *tensors, scale=scale, causal=causal, softcap=softcap, **offsets))
