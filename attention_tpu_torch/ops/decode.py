"""Decode against a dense KV cache: the port of `attention_tpu.ops.decode`.

`flash_decode` scores one new token per sequence, `flash_decode_chunk` S
appended tokens per sequence (the speculative-verify and ragged-append
primitive), both against (B, Hkv, N, d) caches with per-sequence
lengths, GQA, ``softcap`` and the ``window``/``sinks`` band.  For CUDA
tensors they launch the Hopper kernel ``csrc/decode.cu`` (which replaces
the TPU kernel `_decode_kernel`); for CPU tensors they run
`flash_decode_plain`.  The band contract (`check_band`): the window
``[len - w, len)`` per row plus the pinned first ``sinks`` rows; on the
card the kernel's loop bounds skip every key tile past the length and
below the band, where the TPU kernel clamped its DMA index maps
(`banded_block_clamp`).

On the card each sequence's keys are split across CTAs and the splits'
partials merged by a second kernel (``csrc/decode_rows.cuh``).
`split_plan` sizes the split from what the host knows, never the
lengths, and the wrappers pass its (splits, chunk) to the kernels;
`split_owner`, `split_partials` and `merge_splits` are the kernels'
partition and merge in PyTorch, which the tests hold against the JAX
package (the main path runs them only inside the kernels).
"""

from __future__ import annotations

import torch

from attention_tpu_torch.ops import _native
from attention_tpu_torch.ops._native import DTYPE_CODES, MAX_HEAD_DIM, F, \
    I, L, P
from attention_tpu_torch.ops.reference import check_softcap, \
    decode_reference

#: the C entry points' numbers of the rescaling-math variants of the
#: softmax recurrence (`ops.flash.MAX_MODES`)
VARIANT_CODES = {"online": 0, "bound": 1, "flashd": 2, "amla": 3}

KERNEL = "decode"
_ARGTYPES = [P] * 6 + [I] * 8 + [L] * 12 + [I, I, F, F, I, I, I, P]

#: key rows per tile of the kernels' loops: a split is a whole number of
#: them
KEY_TILE = 64
#: query rows per row block of the grid (rows that fit one 16-row tile
#: are one block, of a 16-row CTA)
ROW_BLOCK = 64
#: the rescaling-math variants the decode kernels take; "bound" is
#: forward-only, as in JAX: the decode grid carries no key norms
DECODE_MAX_MODES = ("online", "flashd", "amla")
#: CTAs per SM a split launch aims at.  Two of the bf16 one-token CTAs fit
#: an SM's shared memory at once; four per SM, two waves of short splits,
#: measured fastest of 2, 3, 4 and 8 on an H100 (PERF.md section 6)
CTAS_PER_SM = 4


def split_plan(batch: int, kv_heads: int, rows: int, n_cap: int,
               s_new: int, window: int | None, *, sms: int,
               ctas_per_sm: int | None = None) -> tuple[int, int]:
    """(splits, chunk): how a decode launch cuts each sequence's keys
    across CTAs, from what the host knows without reading the lengths.
    ``rows`` is a kv head's query rows (GQA group x ``s_new``).  The span
    a row block can see is the capacity, or with a window its band plus
    the S - 1 rows of a chunk and the key tile the band's start is
    rounded down to.  A launch whose row blocks leave SMs idle gets
    enough splits for ``ctas_per_sm`` (default `CTAS_PER_SM`) CTAs on
    each of ``sms`` SMs, at most one per key tile of the span; each split
    takes ``chunk`` columns, a whole number of key tiles."""
    span = n_cap if window is None else min(n_cap,
                                            window + s_new + KEY_TILE - 2)
    tiles = max(-(-span // KEY_TILE), 1)
    blocks = batch * kv_heads * -(-rows // ROW_BLOCK)
    if blocks >= sms:
        return 1, tiles * KEY_TILE
    target = CTAS_PER_SM if ctas_per_sm is None else ctas_per_sm
    splits = max(1, min(target * sms // blocks, tiles))
    per = -(-tiles // splits)
    return -(-tiles // per), per * KEY_TILE


def split_owner(lens: torch.Tensor, n: int, s_new: int, window, splits: int,
                chunk: int) -> torch.Tensor:
    """(B, n) the split that owns each cache column: split i owns
    ``[first + i·chunk, first + (i+1)·chunk)``, the last one the rest and
    split 0 every column below ``first``, where ``first`` is the lowest
    band start of the sequence's rows rounded down to a key tile (0
    without a window)."""
    lens = lens.to(torch.int64).clamp(min=0)
    first = torch.zeros_like(lens)
    if window is not None:
        first = (lens - s_new - window + 1).clamp(min=0) // KEY_TILE \
            * KEY_TILE
    col = torch.arange(n, device=lens.device)
    return ((col - first[:, None]).clamp(min=0) // chunk).clamp(
        max=splits - 1)


def split_partials(q4, k_cache, v_cache, lens, *, scale, softcap=None,
                   window=None, sinks=None, splits: int, chunk: int):
    """Each split's partials, as the kernel's CTAs write them: float32
    (unnormalized output (B, H, S, splits, dv), row max in natural log
    and row sum (B, H, S, splits)), max -inf and sum 0 for a split that
    sees nothing."""
    owner = split_owner(lens, k_cache.shape[2], q4.shape[2], window,
                        splits, chunk)
    parts = [decode_reference(q4, k_cache, v_cache, lens, scale=scale,
                              softcap=softcap, window=window, sinks=sinks,
                              partials=True, columns=owner == i)
             for i in range(splits)]
    return tuple(torch.stack(t, dim=3) for t in zip(*parts))


def merge_splits(acc, m, l_, *, dtype=None):
    """The splits' partials merged in split order, the two-phase max,
    rescale, sum of `attention_tpu.parallel.kv_sharded`: the normalized
    output in ``dtype`` (a row that saw nothing is zero), or with
    ``dtype`` None the partials of the whole row (acc, max, sum)."""
    mx = m.amax(dim=-1)
    seen = m != float("-inf")
    w = torch.where(seen, torch.exp(m - mx[..., None]), torch.zeros_like(m))
    total = (w[..., None] * acc).sum(dim=-2)
    gsum = (w * l_).sum(dim=-1)
    if dtype is None:
        return total, mx, gsum
    gsum = torch.where(gsum == 0.0, torch.ones_like(gsum), gsum)
    return (total / gsum[..., None]).to(dtype)


def split_launch(q4, kv_heads: int, n_cap: int, dv: int, window):
    """(splits, chunk, scratch) of a launch on q4's card: `split_plan`,
    and the fp32 scratch of the partials, B·H·S·splits·(dv + 2) values
    (None for one split)."""
    b, h, s_new = q4.shape[:3]
    splits, chunk = split_plan(b, kv_heads, h // kv_heads * s_new, n_cap,
                               s_new, window,
                               sms=_native.sm_count(q4.device.index))
    part = None
    if splits > 1:
        part = torch.empty(b * h * s_new * splits * (dv + 2),
                           dtype=torch.float32, device=q4.device)
    return splits, chunk, part


def check_max_mode(max_mode: str, allowed=tuple(VARIANT_CODES)) -> None:
    """JAX's ``max_mode`` contract on an entry that takes the variants
    ``allowed``: "auto" asks the tuning table, which the port does not
    carry yet (`NotImplementedError`); anything else outside ``allowed``
    is a `ValueError` ("bound" on the decode side: forward-only)."""
    if max_mode == "auto":
        raise NotImplementedError(
            "max_mode='auto' picks a variant from the tuning table, which "
            "is not ported yet; pass one of " + ", ".join(allowed))
    if max_mode not in allowed:
        note = " (bound mode is forward-only)" if max_mode == "bound" else ""
        raise ValueError(
            f"unknown max_mode {max_mode!r}; one of {allowed}{note}")


def check_band(window, sinks) -> None:
    """The decode-side window/sinks contract (mirrors
    flash_attention's): sinks require a window, both >= 1."""
    if sinks is not None:
        if window is None:
            raise ValueError("sinks require window= (see flash_attention)")
        if sinks < 1:
            raise ValueError(f"sinks must be >= 1, got {sinks}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def lengths_tensor(lengths, b: int, device) -> torch.Tensor:
    """(B,) contiguous int32 lengths on ``device`` from an int, a 0-d
    tensor (broadcast) or a (B,) tensor."""
    if isinstance(lengths, int):
        return torch.full((b,), lengths, dtype=torch.int32, device=device)
    lens = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
    if lens.dim() == 0:
        return lens.expand(b).contiguous()
    if tuple(lens.shape) != (b,):
        raise ValueError(f"lengths must be a scalar or ({b},), got "
                         f"{tuple(lens.shape)}")
    return lens.contiguous()


def _validate(q, k_cache, v_cache, *, chunk: bool) -> None:
    want = 4 if chunk else 3
    if q.dim() != want or k_cache.dim() != 4 or v_cache.dim() != 4:
        form = "(B,H,S,d)" if chunk else "(B,H,d)"
        raise ValueError(
            f"expected q {form}, caches (B,Hkv,N,d): got "
            f"Q{tuple(q.shape)} K{tuple(k_cache.shape)} "
            f"V{tuple(v_cache.shape)}")
    b, h, d = q.shape[0], q.shape[1], q.shape[-1]
    bk, hkv, n, dk = k_cache.shape
    if bk != b or tuple(v_cache.shape[:3]) != (b, hkv, n) or dk != d:
        raise ValueError(
            f"cache shapes inconsistent: Q{tuple(q.shape)} "
            f"K{tuple(k_cache.shape)} V{tuple(v_cache.shape)}")
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")


def _launch(q4, k_cache, v_cache, lens, *, scale, softcap, window,
            sinks, variant="online") -> torch.Tensor:
    dtype = q4.dtype
    if (dtype not in DTYPE_CODES or k_cache.dtype != dtype
            or v_cache.dtype != dtype):
        raise TypeError(
            f"decode kernel takes float32 or bfloat16 q/caches of one "
            f"dtype, got {q4.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if not (q4.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must be on one device")
    b, h, s_new, d = q4.shape
    hkv, n, dv = k_cache.shape[1], k_cache.shape[2], v_cache.shape[-1]
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
    q4, k_cache, v_cache = (t if t.stride(-1) == 1 else t.contiguous()
                            for t in (q4, k_cache, v_cache))
    # (B, S, H, dv) storage: the attention layer's head merge is a view
    out = torch.empty((b, s_new, h, dv), dtype=dtype,
                      device=q4.device).transpose(1, 2)
    splits, chunk, part = split_launch(q4, hkv, n, dv, window)
    fn = _native.function(KERNEL, "decode_fwd", _ARGTYPES)
    idx = q4.device.index  # an int takes torch.cuda's short path
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(idx).cuda_stream
        err = fn(q4.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 lens.data_ptr(), out.data_ptr(),
                 0 if part is None else part.data_ptr(), DTYPE_CODES[dtype],
                 b, h, hkv, s_new, n, d, dv, *q4.stride()[:3],
                 *k_cache.stride()[:3], *v_cache.stride()[:3],
                 *out.stride()[:3], window or 0, sinks or 0, float(scale),
                 float(softcap or 0.0), splits, chunk,
                 VARIANT_CODES[variant],
                 stream)
    _native.check(KERNEL, err)
    _native.count_launch(KERNEL, variant)
    return out


def flash_decode_plain(q, k_cache, v_cache, lengths, *, scale=None,
                       softcap=None, window=None, sinks=None
                       ) -> torch.Tensor:
    """The plain PyTorch version of `flash_decode` (3-D ``q``) and
    `flash_decode_chunk` (4-D ``q``)."""
    chunk = q.dim() == 4
    _validate(q, k_cache, v_cache, chunk=chunk)
    check_band(window, sinks)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    lens = lengths_tensor(lengths, q.shape[0], q.device)
    q4 = q if chunk else q[:, :, None]
    out = decode_reference(q4, k_cache, v_cache, lens, scale=scale,
                           softcap=softcap, window=window, sinks=sinks)
    return out if chunk else out[:, :, 0]


def _decode(q, k_cache, v_cache, lengths, *, chunk, scale, softcap,
            window, sinks, max_mode) -> torch.Tensor:
    check_max_mode(max_mode, DECODE_MAX_MODES)
    check_softcap(softcap)
    check_band(window, sinks)
    _validate(q, k_cache, v_cache, chunk=chunk)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, lengths, scale=scale,
                                  softcap=softcap, window=window, sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not "
                         f"{q.device.type}")
    lens = lengths_tensor(lengths, q.shape[0], q.device)
    out = _launch(q if chunk else q[:, :, None], k_cache, v_cache, lens,
                  scale=scale, softcap=softcap, window=window, sinks=sinks,
                  variant=max_mode)
    return out if chunk else out[:, :, 0]


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths, *,
                 scale: float | None = None, softcap: float | None = None,
                 window: int | None = None, sinks: int | None = None,
                 max_mode: str = "online") -> torch.Tensor:
    """softmax(q K[:len]ᵀ · scale) V[:len] per sequence: q (B, H, d),
    caches (B, Hkv, N, d|dv), ``lengths`` an int, a 0-d or a (B,)
    tensor of valid rows -> (B, H, dv).  ``softcap`` caps the scaled
    scores; ``window`` attends only the last ``window`` valid rows
    (each query sits at its sequence's ``len - 1``), ``sinks``
    additionally the first ``sinks`` rows.  A length of 0 gives a zero
    row.  ``max_mode`` is the kernel's rescaling math, "online", "flashd"
    or "amla" (the same output; the plain version is one for all three);
    "bound" is `ValueError` (forward-only), "auto"
    `NotImplementedError`."""
    return _decode(q, k_cache, v_cache, lengths, chunk=False, scale=scale,
                   softcap=softcap, window=window, sinks=sinks,
                   max_mode=max_mode)


def flash_decode_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, new_lengths, *,
                       scale: float | None = None,
                       softcap: float | None = None,
                       window: int | None = None, sinks: int | None = None,
                       max_mode: str = "online") -> torch.Tensor:
    """S appended tokens per sequence in one cache stream: q (B, H, S,
    d), the S rows already in the caches, ``new_lengths`` the lengths
    after the append -> (B, H, S, dv).  Token s of sequence b sits at
    position ``new_lengths[b] - S + s`` and attends its causal prefix,
    with the window band per row.  ``max_mode`` as `flash_decode`."""
    return _decode(q, k_cache, v_cache, new_lengths, chunk=True,
                   scale=scale, softcap=softcap, window=window, sinks=sinks,
                   max_mode=max_mode)
