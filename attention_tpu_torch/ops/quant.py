"""Quantized KV caches and decode against them: the port of
`attention_tpu.ops.quant`.

Three storage formats, each with one float32 scale per cached token
(symmetric absmax: ``scale = amax / 127`` for int8, ``amax / 7`` for
int4, 1 for an all-zero row), stored (B, Hkv, N) in token order:

* `QuantizedKV`: int8 values (B, Hkv, N, d);
* `Int4KV`: feature-dim int4, (B, Hkv, N, d/2) bytes, byte f holding
  feature f in its low nibble and feature f + d/2 in its high nibble;
* `Int4TokKV`: token-paired int4, (B, Hkv, N/2, d) bytes, byte row r
  holding token 2r in its low nibbles and token 2r + 1 in its high ones.

The quantized values are bit-identical to the JAX package's; the JAX
package repeats each scale over 8 (or 16) sublanes, a TPU tiling rule,
which the port does not (`models.convert.quant_cache_from_jax` takes its
scales across).

A per-token scale commutes out of both products, so the decode kernels
never dequantize with a multiply per value: scores are ``(q·K_q)·s_K``
per column, the output ``(P·s_V)·V_q``.  The arithmetic, kernel and
plain version alike: q pre-scaled by ``scale·log2(e)`` and rounded to
bf16; float32 scores times the key scale, then softcap (in log2 units)
and the mask; an exp2 softmax whose row sum takes P unscaled; P times the
value scale rounded to bf16 for the product with the integer values; a
bf16 output whatever q's dtype.  A length of 0 gives a zero row.  For
CUDA tensors `flash_decode_quantized`, `flash_decode_quantized_chunk` and
`flash_decode_int4` launch ``csrc/quant_decode.cu`` (which replaces the
TPU kernel `_decode_q_kernel`), `flash_decode_int4_tok` launches
``csrc/quant_tok4_decode.cu`` (which replaces `_decode_tok4_kernel`);
for CPU tensors they run `quant_decode_plain`.  The kernels take every
head dim from 1 to 256 (int4: even, as the JAX package's packing
requires), caches of any row width and alignment with a contiguous last
dim, and q in float32 or bfloat16, which they scale and round
themselves.

On the card each sequence's keys are split across CTAs as the dense
decode kernel splits them (`ops.decode.split_plan`, the token-paired
capacity counted in tokens) and merged by a second kernel;
`launch_plan` names a call's split and key groups, and `split_partials`
(merged by `ops.decode.merge_splits`) is what the split CTAs compute,
which the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from attention_tpu_torch.ops import _native
from attention_tpu_torch.ops._native import MAX_HEAD_DIM, F, I, L, P
from attention_tpu_torch.ops.decode import ROW_BLOCK, check_band, \
    lengths_tensor, split_launch, split_owner, split_plan
from attention_tpu_torch.ops.reference import check_softcap
from attention_tpu_torch.ops.rope import apply_rope

LOG2E = math.log2(math.e)
#: rows of a kv head up to which the four warps share one 16-row tile (the
#: kernels' key groups, KG = 4), else 64-row blocks (KG = 1)
KEY_GROUP_ROWS = 16
_ARGTYPES = [P] * 8 + [I] * 7 + [L] * 12 + [I, I, F, F, I, I, I, P]


class QuantizedKV(NamedTuple):
    """int8 KV cache: values (B, Hkv, N, d) int8, per-token float32
    scales (B, Hkv, N)."""

    k_q: torch.Tensor
    k_scale: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k_q.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k_q.shape[3]


class Int4KV(NamedTuple):
    """Feature-dim int4 KV cache: values (B, Hkv, N, d/2) int8, two
    nibbles per byte, per-token float32 scales (B, Hkv, N)."""

    k_q: torch.Tensor
    k_scale: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k_q.shape[2]

    @property
    def head_dim(self) -> int:
        return 2 * self.k_q.shape[3]


class Int4TokKV(NamedTuple):
    """Token-paired int4 KV cache: values (B, Hkv, N/2, d) int8, tokens
    2r and 2r + 1 in the low and high nibbles of byte row r, per-token
    float32 scales (B, Hkv, N)."""

    k_q: torch.Tensor
    k_scale: torch.Tensor
    v_q: torch.Tensor
    v_scale: torch.Tensor

    @property
    def capacity(self) -> int:
        return 2 * self.k_q.shape[2]

    @property
    def head_dim(self) -> int:
        return self.k_q.shape[3]


def _absmax_rows(x: torch.Tensor, qmax: int):
    """Symmetric per-token absmax: (..., N, d) -> (int8 values in
    [-qmax, qmax], float32 scales (..., N))."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax == 0.0, 1.0, amax / qmax)
    q = torch.round(xf / scale[..., None]).clamp(-qmax, qmax)
    return q.to(torch.int8), scale


def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int4 value tensors -> one int8 byte each, lo in the low
    nibble."""
    return ((lo.to(torch.int32) & 0xF) | (hi.to(torch.int32) << 4)).to(
        torch.int8)


def _unpack_nibbles(packed: torch.Tensor):
    """int8 bytes -> (low, high) signed nibbles as int32: the low one
    re-signed (>= 8 -> -16), the high one an arithmetic shift."""
    p = packed.to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, p >> 4


def _quant_rows(x: torch.Tensor):
    """(..., N, d) -> (int8 values, (..., N) scales)."""
    return _absmax_rows(x, 127)


def _quant_rows_int4(x: torch.Tensor):
    """(..., N, d) -> (packed (..., N, d/2) int8, (..., N) scales)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"head_dim {d} must be even for int4 packing")
    q, scale = _absmax_rows(x, 7)
    return _pack_nibbles(q[..., :d // 2], q[..., d // 2:]), scale


def _quant_rows_int4_tok(x: torch.Tensor):
    """(..., N, d) -> (token-paired (..., N/2, d) int8, (..., N)
    scales)."""
    n = x.shape[-2]
    if n % 2:
        raise ValueError(f"cache length {n} must be even for token pairing")
    q, scale = _absmax_rows(x, 7)
    return _pack_nibbles(q[..., 0::2, :], q[..., 1::2, :]), scale


def quantize_kv(k: torch.Tensor, v: torch.Tensor) -> QuantizedKV:
    """Quantize full (B, Hkv, N, d) K/V caches to the int8 format."""
    return QuantizedKV(*_quant_rows(k), *_quant_rows(v))


def quantize_kv_int4(k: torch.Tensor, v: torch.Tensor) -> Int4KV:
    """Quantize full (B, Hkv, N, d) K/V caches to the feature-dim int4
    format.  An opt-in trade of accuracy for bytes: about 30 times
    int8's output error, outside the ±0.02 contract."""
    return Int4KV(*_quant_rows_int4(k), *_quant_rows_int4(v))


def quantize_kv_int4_tok(k: torch.Tensor, v: torch.Tensor) -> Int4TokKV:
    """Quantize full (B, Hkv, N, d) K/V caches to the token-paired int4
    format (the same values and error as `quantize_kv_int4`).  N must be
    a multiple of 256, as in the JAX package."""
    n = k.shape[-2]
    if n % 256:
        raise ValueError(
            f"token-paired int4 needs a 256-multiple cache capacity, got "
            f"{n} (use the feature-dim layout for smaller caches)")
    return Int4TokKV(*_quant_rows_int4_tok(k), *_quant_rows_int4_tok(v))


def update_quantized_kv(cache: QuantizedKV, k_new: torch.Tensor,
                        v_new: torch.Tensor, index: int) -> QuantizedKV:
    """Quantize S new rows (B, Hkv, S, d) and write them at ``index``,
    in place; returns ``cache``.  A write past the capacity (index + S >
    capacity) lands clamped at the end, as JAX's dynamic_update_slice
    does, and NaN-poisons the scales it writes, so every output that
    reads them comes out NaN."""
    s_new = k_new.shape[2]
    k_q, k_s = _quant_rows(k_new)
    v_q, v_s = _quant_rows(v_new)
    if index + s_new > cache.capacity:
        k_s = torch.full_like(k_s, float("nan"))
        v_s = torch.full_like(v_s, float("nan"))
    at = max(0, min(index, cache.capacity - s_new))
    cache.k_q[:, :, at:at + s_new] = k_q
    cache.k_scale[:, :, at:at + s_new] = k_s
    cache.v_q[:, :, at:at + s_new] = v_q
    cache.v_scale[:, :, at:at + s_new] = v_s
    return cache


def sink_read_rows(kv: QuantizedKV, new_total, window: int, sinks: int,
                   theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 key rows and scales of `sink_read_rotation`'s read copy
    at the ``sinks`` pinned positions: (B, Hkv, sinks, d) int8, (B, Hkv,
    sinks) float32."""
    k_sink = kv.k_q[:, :, :sinks].float() * kv.k_scale[:, :, :sinks, None]
    delta = torch.as_tensor(new_total, device=kv.k_q.device)
    delta = (delta.to(torch.int64) - (window + sinks)).clamp(min=0)
    if delta.dim():  # per-sequence (B,) totals -> (B, 1, 1) positions
        delta = delta[:, None, None]
    return _quant_rows(apply_rope(k_sink, delta, theta))


def sink_read_rotation(kv: QuantizedKV, new_total, window: int, sinks: int,
                       theta: float) -> QuantizedKV:
    """StreamingLLM's in-cache sink positions for an int8 cache, at read
    time: the ``sinks`` pinned key rows dequantized, rotated forward by
    ``delta = max(new_total - (window + sinks), 0)`` (``new_total`` an
    int or per-sequence (B,) totals), requantized into a read copy of
    the cache; the stored cache keeps its absolute rotations, so nothing
    drifts from step to step.  The double quantization of the sink rows
    adds int8-grade noise, inside the cache's error contract (the JAX
    package's `sink_read_rotation`)."""
    rows, scales = sink_read_rows(kv, new_total, window, sinks, theta)
    k_q, k_scale = kv.k_q.clone(), kv.k_scale.clone()
    k_q[:, :, :sinks] = rows
    k_scale[:, :, :sinks] = scales
    return kv._replace(k_q=k_q, k_scale=k_scale)


def dequantized_values(cache) -> tuple[torch.Tensor, torch.Tensor]:
    """The integer values of a quantized cache as float32 (B, Hkv, N, d),
    tokens and features in natural order (scales not applied)."""

    def values(x):
        if isinstance(cache, QuantizedKV):
            return x.float()
        lo, hi = _unpack_nibbles(x)
        if isinstance(cache, Int4KV):
            return torch.cat([lo, hi], dim=-1).float()
        b, hkv, half, d = x.shape
        return torch.stack([lo, hi], dim=-2).reshape(b, hkv, 2 * half,
                                                     d).float()

    return values(cache.k_q), values(cache.v_q)


def _validate(q, cache, *, chunk: bool) -> None:
    if not isinstance(cache, (QuantizedKV, Int4KV, Int4TokKV)):
        raise TypeError(f"expected a quantized cache, got "
                        f"{type(cache).__name__}")
    if q.dim() != (4 if chunk else 3):
        form = "(B,H,S,d)" if chunk else "(B,H,d)"
        raise ValueError(f"expected q {form}, got {tuple(q.shape)}")
    b, h, d = q.shape[0], q.shape[1], q.shape[-1]
    bk, hkv = cache.k_q.shape[:2]
    n = cache.capacity
    if (cache.k_q.dim() != 4 or bk != b or cache.head_dim != d
            or cache.v_q.shape != cache.k_q.shape):
        raise ValueError(
            f"cache shapes inconsistent: Q{tuple(q.shape)} "
            f"K{tuple(cache.k_q.shape)} V{tuple(cache.v_q.shape)}")
    if (tuple(cache.k_scale.shape) != (b, hkv, n)
            or tuple(cache.v_scale.shape) != (b, hkv, n)):
        raise ValueError(
            f"scale shapes {tuple(cache.k_scale.shape)}/"
            f"{tuple(cache.v_scale.shape)} != {(b, hkv, n)}")
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")
    if d % 2 and not isinstance(cache, QuantizedKV):
        raise ValueError(f"head_dim {d} must be even for int4 packing")


def _plain(q4, cache, lens, *, scale, softcap, window, sinks,
           columns=None, partials=False):
    """`quant_decode_plain` on (B, H, S, d) q and (B,) lengths, the cache
    columns cut to ``columns`` ((B, N) bool) where given; with
    ``partials`` the float32 (unnormalized output, row max in natural
    log, row sum), max -inf and sum 0 for a row that sees nothing."""
    b, h, s_new, d = q4.shape
    hkv, n = cache.k_q.shape[1], cache.capacity
    lens = lens.to(q4.device).long().clamp(min=0)
    kf, vf = dequantized_values(cache)
    # rows (g, s), s minor, of each kv head's group
    qs = (q4.float() * (scale * LOG2E)).to(torch.bfloat16).float()
    qs = qs.reshape(b, hkv, h // hkv * s_new, d)
    s = torch.matmul(qs, kf.transpose(-1, -2)) * cache.k_scale[:, :, None]
    if softcap is not None:
        cap2 = softcap * LOG2E
        s = cap2 * torch.tanh(s / cap2)
    row = torch.arange(s.shape[2], device=q4.device) % s_new
    pos = (lens[:, None] - s_new + row)[:, None, :, None]   # (B, 1, rows, 1)
    col = torch.arange(n, device=q4.device)
    keep = col <= pos
    if window is not None:
        band = col > pos - window
        if sinks is not None:
            band = band | (col < sinks)
        keep = keep & band
    if columns is not None:
        keep = keep & columns[:, None, None, :]
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - torch.where(m == float("-inf"), 0.0, m))
    denom = p.sum(dim=-1, keepdim=True)
    pv = (p * cache.v_scale[:, :, None]).to(torch.bfloat16).float()
    acc = torch.matmul(pv, vf)
    if partials:
        return (acc.reshape(b, h, s_new, d),
                (m * math.log(2.0)).reshape(b, h, s_new),
                denom.reshape(b, h, s_new))
    denom = torch.where(denom == 0.0, 1.0, denom)
    return (acc / denom).to(torch.bfloat16).reshape(b, h, s_new, d)


def quant_decode_plain(q, cache, lengths, *, scale=None, softcap=None,
                       window=None, sinks=None) -> torch.Tensor:
    """The plain PyTorch version of the quantized decode kernels: q (B, H,
    d), or (B, H, S, d) for S appended tokens (row s of sequence b at
    position ``lengths[b] - S + s``, attending its causal prefix), against
    any of the three cache formats -> bf16 of q's shape."""
    chunk = q.dim() == 4
    _validate(q, cache, chunk=chunk)
    check_softcap(softcap)
    check_band(window, sinks)
    q4 = q if chunk else q[:, :, None]
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    out = _plain(q4, cache, lengths_tensor(lengths, q.shape[0], q.device),
                 scale=scale, softcap=softcap, window=window, sinks=sinks)
    return out if chunk else out[:, :, 0]


def split_partials(q4, cache, lens, *, scale, softcap=None, window=None,
                   sinks=None, splits: int, chunk: int):
    """Each split's partials as the kernels' CTAs write them: the plain
    version cut to the columns `ops.decode.split_owner` gives each split,
    as float32 (unnormalized output (B, H, S, splits, d), row max in
    natural log and row sum (B, H, S, splits)); `ops.decode.merge_splits`
    merges them."""
    owner = split_owner(lens, cache.capacity, q4.shape[2], window, splits,
                        chunk)
    parts = [_plain(q4, cache, lens, scale=scale, softcap=softcap,
                    window=window, sinks=sinks, columns=owner == i,
                    partials=True) for i in range(splits)]
    return tuple(torch.stack(t, dim=3) for t in zip(*parts))


def _check_head_dim(d: int) -> None:
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the quantized decode kernels take head dims up "
                         f"to {MAX_HEAD_DIM}, got {d}")


def launch_plan(q, cache, window=None, *, sms: int) -> dict:
    """The launch a kernel call on ``q`` (B, H, d) or (B, H, S, d) and
    ``cache`` makes on a card of ``sms`` SMs: the key split of
    `ops.decode.split_plan` over the capacity in tokens (``splits``,
    ``chunk``), the key groups ``kg`` (4: the four warps share one 16-row
    tile) and the ``grid`` (row blocks, B·Hkv, splits)."""
    _check_head_dim(q.shape[-1])
    b, h = q.shape[:2]
    s_new = q.shape[2] if q.dim() == 4 else 1
    hkv = cache.k_q.shape[1]
    rows = h // hkv * s_new
    splits, chunk = split_plan(b, hkv, rows, cache.capacity, s_new, window,
                               sms=sms)
    kg = _key_groups(rows)
    return dict(splits=splits, chunk=chunk, kg=kg,
                grid=[-(-rows // (ROW_BLOCK // kg)), b * hkv, splits])


def _key_groups(rows: int) -> int:
    """The kernels' key groups for a kv head's ``rows`` query rows."""
    return 4 if rows <= KEY_GROUP_ROWS else 1


def kernel_resources(kind, d: int, kg: int) -> dict:
    """What the kernel instance that a call on a cache of type ``kind``
    at head dim ``d`` with ``kg`` key groups runs, its rows whole and
    aligned (at a ``d`` below the instance's, the one for any rows),
    costs an SM of the current card: registers a thread, dynamic shared
    bytes a CTA, CTAs an SM holds, spilled bytes a thread, and the
    instance's ``head_dim`` (the least of 32, 64, 128 and 256 at or above
    ``d``)."""
    kernel = _KERNEL_OF[kind][0]
    if kind is Int4TokKV:
        fn = _native.function(kernel, "quant_tok4_resources", [I, I, P])
        args = ()
    else:
        fn = _native.function(kernel, "quant_decode_resources",
                              [I, I, I, P])
        args = (int(kind is Int4KV),)
    out = (ctypes.c_int * 5)()
    _native.check(kernel, fn(*args, d, kg, ctypes.addressof(out)))
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm",
                     "spill_bytes", "head_dim"), out))


def _launch(kernel, symbol, q4, cache, lens, *, scale, softcap, window,
            sinks) -> torch.Tensor:
    if cache.k_q.dtype != torch.int8 or cache.v_q.dtype != torch.int8:
        raise TypeError(f"quantized values must be int8, got "
                        f"{cache.k_q.dtype}/{cache.v_q.dtype}")
    if (cache.k_scale.dtype != torch.float32
            or cache.v_scale.dtype != torch.float32):
        raise TypeError("quantized scales must be float32")
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q4.dtype}")
    if any(t.device != q4.device for t in cache):
        raise ValueError("q and the cache must be on one device")
    b, h, s_new, d = q4.shape
    _check_head_dim(d)
    for t, what in ((cache.k_q, "k_q"), (cache.v_q, "v_q")):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: the kernel takes rows with a "
                             f"contiguous last dim")
    if q4.stride(-1) != 1:
        q4 = q4.contiguous()
    hkv, n = cache.k_q.shape[1], cache.capacity
    ks, vs = (t if t.is_contiguous() else t.contiguous()
              for t in (cache.k_scale, cache.v_scale))
    # (B, S, H, d) storage: the attention layer's head merge is a view
    out = torch.empty((b, s_new, h, d), dtype=torch.bfloat16,
                      device=q4.device).transpose(1, 2)
    splits, chunk, part = split_launch(q4, hkv, n, d, window)
    fn = _native.function(kernel, symbol, _ARGTYPES)
    idx = q4.device.index  # an int takes torch.cuda's short path
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(idx).cuda_stream
        err = fn(q4.data_ptr(), cache.k_q.data_ptr(), cache.v_q.data_ptr(),
                 ks.data_ptr(), vs.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), 0 if part is None else part.data_ptr(),
                 int(q4.dtype == torch.float32), b, h, hkv, s_new, n, d,
                 *q4.stride()[:3], *cache.k_q.stride()[:3],
                 *cache.v_q.stride()[:3], *out.stride()[:3], window or 0,
                 sinks or 0, float(scale * LOG2E), float(softcap or 0.0),
                 splits, chunk, _key_groups(h // hkv * s_new), stream)
    _native.check(kernel, err)
    _native.count_launch(kernel)
    return out


#: cache type -> (kernel, C entry point)
_KERNEL_OF = {
    QuantizedKV: ("quant_decode", "quant_decode_int8_fwd"),
    Int4KV: ("quant_decode", "quant_decode_int4_fwd"),
    Int4TokKV: ("quant_tok4", "quant_decode_tok4_fwd"),
}


def _decode(q, cache, lengths, *, kind, chunk, scale, softcap, window,
            sinks) -> torch.Tensor:
    if not isinstance(cache, kind):
        raise TypeError(f"expected {kind.__name__}, got "
                        f"{type(cache).__name__}")
    check_softcap(softcap)
    check_band(window, sinks)
    _validate(q, cache, chunk=chunk)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return quant_decode_plain(q, cache, lengths, scale=scale,
                                  softcap=softcap, window=window, sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"quantized decode runs on cuda or cpu, not "
                         f"{q.device.type}")
    lens = lengths_tensor(lengths, q.shape[0], q.device)
    out = _launch(*_KERNEL_OF[kind], q if chunk else q[:, :, None], cache,
                  lens, scale=scale, softcap=softcap, window=window,
                  sinks=sinks)
    return out if chunk else out[:, :, 0]


def flash_decode_quantized(q: torch.Tensor, cache: QuantizedKV, lengths, *,
                           scale: float | None = None,
                           softcap: float | None = None,
                           window: int | None = None,
                           sinks: int | None = None) -> torch.Tensor:
    """softmax(q K[:len]ᵀ · scale) V[:len] against an int8 cache: q (B,
    H, d), ``lengths`` an int, a 0-d or a (B,) tensor -> (B, H, d) bf16.
    ``softcap``, ``window`` and ``sinks`` as in `ops.decode.flash_decode`."""
    return _decode(q, cache, lengths, kind=QuantizedKV, chunk=False,
                   scale=scale, softcap=softcap, window=window, sinks=sinks)


def flash_decode_quantized_chunk(q: torch.Tensor, cache: QuantizedKV,
                                 new_lengths, *, scale: float | None = None,
                                 softcap: float | None = None,
                                 window: int | None = None,
                                 sinks: int | None = None) -> torch.Tensor:
    """S appended tokens per sequence against an int8 cache in one
    stream (the speculative-verify primitive): q (B, H, S, d), the S rows
    already in the cache, ``new_lengths`` after the append -> (B, H, S,
    d) bf16, masked as `ops.decode.flash_decode_chunk`."""
    return _decode(q, cache, new_lengths, kind=QuantizedKV, chunk=True,
                   scale=scale, softcap=softcap, window=window, sinks=sinks)


def flash_decode_int4(q: torch.Tensor, cache: Int4KV, lengths, *,
                      scale: float | None = None,
                      softcap: float | None = None,
                      window: int | None = None,
                      sinks: int | None = None) -> torch.Tensor:
    """`flash_decode_quantized` against a feature-dim int4 cache."""
    return _decode(q, cache, lengths, kind=Int4KV, chunk=False, scale=scale,
                   softcap=softcap, window=window, sinks=sinks)


def flash_decode_int4_tok(q: torch.Tensor, cache: Int4TokKV, lengths, *,
                          scale: float | None = None,
                          softcap: float | None = None,
                          window: int | None = None,
                          sinks: int | None = None) -> torch.Tensor:
    """`flash_decode_quantized` against a token-paired int4 cache (one
    token per sequence; there is no chunk mode)."""
    return _decode(q, cache, lengths, kind=Int4TokKV, chunk=False,
                   scale=scale, softcap=softcap, window=window, sinks=sinks)
