"""Plain PyTorch attention: the arithmetic the port's kernels must match.

`attention_reference` is the counterpart of `attention_tpu.ops.reference.
attention_xla` (plus the causal mask with offsets, the sliding-window band
with sinks, the ``kv_valid`` cut and the GQA head grouping the flash
kernel takes), `decode_reference`
the arithmetic of the decode kernels (one token or an appended chunk per
sequence against a dense cache, with the window band and sinks), and
`ragged_paged_reference` the counterpart of the packed-step oracle
`ragged_paged_reference` there, here in the caller's working dtype.  Both compute scores, softmax and sums in float32 and
round the probabilities to the value dtype before the P·V product, as
the JAX package does; the output has the value dtype.  They are the
plain versions the kernel wrappers take for CPU tensors and that
``chip_smoke.py`` holds each kernel against on the card, through
`mismatch`.
"""

from __future__ import annotations

import torch

F32_ATOL = 1e-5
BF16_RTOL = 1.6e-2
BF16_ROW_ATOL = 2.0 ** -6
BF16_ATOL = 2e-2


def mismatch(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """How far ``got`` lies from ``want`` (say a kernel's output from
    its plain version's): (max abs difference, largest ratio of an
    element's difference to its limit).  The outputs agree when the
    ratio is at most 1.  Shapes, dtypes and NaN positions must match.

    float32: 1e-5 absolute.  Both sides compute in full f32 and differ
    only in summation order.

    bfloat16: 1.6e-2·|want| + 2^-6·rms(want's row), capped at 2e-2.
    The two sides round P to bf16 at different points (unnormalized in
    the kernel, normalized in the plain version), which leaves about
    1e-3 of a row's rms before the output is rounded; the row term is
    some ten of its standard deviations and scales with the row, so
    the limit holds at any sequence length.  Each side then rounds the
    output to bf16, one ulp being up to 2^-7 of the value; 1.6e-2 is
    two ulps.  A dropped key tile or a 2% error in the scale exceeds it
    (``chip_smoke.py`` plants both to show this)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError("NaN positions differ")
    g, w = got.float().nan_to_num(), want.float().nan_to_num()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        limit = torch.full_like(w, F32_ATOL)
    elif want.dtype == torch.bfloat16:
        row_rms = w.square().mean(dim=-1, keepdim=True).sqrt()
        limit = (BF16_RTOL * w.abs() + BF16_ROW_ATOL * row_rms).clamp(
            max=BF16_ATOL)
    else:
        raise TypeError(f"no tolerance for {want.dtype}")
    ratio = torch.where(err == 0, 0.0, err / limit)
    return err.max().item(), ratio.max().item()


def grad_mismatch(got: torch.Tensor,
                  want: torch.Tensor) -> tuple[float, float]:
    """`mismatch` for gradients: (max abs difference, largest ratio of an
    element's difference to its limit); they agree when the ratio is at
    most 1.

    bfloat16: 2^-7·|want| + 2^-6·rms(want's row) + 2^-10·rms(want).
    Each side rounds its float32 gradient to bf16 once, which costs at
    most one ulp, 2^-7 of the value; `mismatch`'s 2e-2 cap would be under
    one ulp for the gradients above 2.56 that a long sum builds (dK and
    dV sum over every query row of a GQA group: 4096 rows x 8 heads at
    the serving shape).  Before that rounding the float32 sums differ by
    their order and, more, where one P or dS value lies so near a bf16
    rounding boundary that the two sides round it apart: one ulp of that
    term, up to 2^-7 of it.  A row with few keys is dominated by a term
    of about its rms (measured on the card: a dQ row over 29 keys, one
    term 0.197, row rms 0.155, the sides 0.0012 apart): the row term
    covers a term twice the row's rms.  dS = P·(dP - delta) cancels to
    about 1e-7 for a row that sees one key, where the two sides keep
    different float32 residues of a gradient that is 0: the tensor term.
    A 2% error in the scale, or a dropped key tile, exceeds the limit
    (``chip_smoke.py`` plants both).

    float32: 2^-16·(|want| + rms(want's row)) + 2^-20·rms(want): the
    same arithmetic in another order (and other P values by 1 ulp from
    exp2), whose relative error grows with the length of the sums."""
    err, ratio = grad_ratios(got, want)
    return err.max().item(), ratio.max().item()


def grad_ratios(got: torch.Tensor, want: torch.Tensor):
    """`grad_mismatch` element by element: (each element's abs
    difference, its ratio to the element's limit), float32 tensors of
    want's shape."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError("NaN positions differ")
    g, w = got.float().nan_to_num(), want.float().nan_to_num()
    err = (g - w).abs()
    row_rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    rms = w.square().mean().sqrt()
    if want.dtype == torch.bfloat16:
        limit = 2.0 ** -7 * w.abs() + 2.0 ** -6 * row_rms + 2.0 ** -10 * rms
    elif want.dtype == torch.float32:
        limit = 2.0 ** -16 * (w.abs() + row_rms) + 2.0 ** -20 * rms
    else:
        raise TypeError(f"no tolerance for {want.dtype}")
    return err, torch.where(err == 0, 0.0, err / limit)


def check_softcap(softcap) -> None:
    """Shared entry-point validation for the softcap knob."""
    if softcap is not None and softcap <= 0.0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row softmax of float32 ``scores`` (masked entries -inf) times
    ``v``; rows with nothing to attend come out zero."""
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    p = torch.exp(scores - row_max)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    p = (p / denom).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(v.dtype)


def _partials_pv(scores: torch.Tensor, v: torch.Tensor):
    """The unnormalized form of `_softmax_pv`: (sum of exp(s - max)·v in
    float32, row max, row sum), max -inf and sum 0 for a row with
    nothing to attend.  P is rounded to ``v.dtype`` for the product,
    the sum uses it unrounded."""
    row_max = scores.amax(dim=-1)
    safe = torch.where(torch.isfinite(row_max), row_max,
                       torch.zeros_like(row_max))
    p = torch.exp(scores - safe[..., None])
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out, row_max, p.sum(dim=-1)


def _masked_scores(q, k, *, scale, causal, softcap, q_offset, kv_offset,
                   kv_valid, window=None, sinks=None, q_segment_ids=None,
                   kv_segment_ids=None):
    """float32 scores of `attention_reference` with masked entries -inf,
    and k's heads repeated over their GQA group."""
    check_softcap(softcap)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    keep = attention_mask(*scores.shape[-2:], causal=causal,
                          q_offset=q_offset, kv_offset=kv_offset,
                          kv_valid=kv_valid, window=window, sinks=sinks,
                          q_segment_ids=q_segment_ids,
                          kv_segment_ids=kv_segment_ids, device=q.device)
    return scores.masked_fill(~keep, float("-inf"))


def band_keep(col, pos, window, sinks):
    """Where the key at position ``col`` lies in the band of a query at
    position ``pos`` (broadcasting): one of the last ``window`` positions
    at or before it (the causal cut is the caller's), or below ``sinks``.
    All True without a window."""
    if window is None:
        return torch.ones_like(col > pos)
    band = col > pos - window
    return band if sinks is None else band | (col < sinks)


def attention_mask(m: int, n: int, *, causal=False, q_offset=0,
                   kv_offset=0, kv_valid=None, window=None, sinks=None,
                   q_segment_ids=None, kv_segment_ids=None,
                   device=None) -> torch.Tensor:
    """(m, n) bool, True where query row i attends key row j: j below
    ``kv_valid`` and, under ``causal``, ``kv_offset + j <=
    q_offset + i``; with a ``window`` (causal only) also in the band of
    `band_keep` at those positions; with segment ids ((m,) and (n,)
    integer vectors, packed sequences) also ``q_segment_ids[i] ==
    kv_segment_ids[j]``."""
    row = torch.arange(m, device=device)[:, None]
    col = torch.arange(n, device=device)[None, :]
    keep = col < (n if kv_valid is None else kv_valid)
    if causal:
        keep = keep & (col + kv_offset <= row + q_offset)
        keep = keep & band_keep(col + kv_offset, row + q_offset, window,
                                sinks)
    if q_segment_ids is not None:
        keep = keep & (q_segment_ids.to(device)[:, None]
                       == kv_segment_ids.to(device)[None, :])
    return keep.expand(m, n)


def _gqa_repeat(q, k, v):
    """k and v with each head repeated over its group of q heads."""
    if q.dim() >= 3 and q.shape[-3] != k.shape[-3]:
        group = q.shape[-3] // k.shape[-3]
        k = k.repeat_interleave(group, dim=-3)
        v = v.repeat_interleave(group, dim=-3)
    return k, v


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = False,
    softcap: float | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    kv_valid: int | None = None,
    window: int | None = None,
    sinks: int | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over the last two axes.

    Shapes: q (..., m, dk), k (..., n, dk), v (..., n, dv).  With three
    or more axes the head axis (-3) of q may be a multiple of k's (GQA:
    q head h reads kv head h // group).  Only the first ``kv_valid``
    key rows are attended.  ``causal`` masks key j against query i when
    ``kv_offset + j > q_offset + i``, and a ``window`` (causal only) also
    when ``kv_offset + j <= q_offset + i - window`` unless ``kv_offset + j
    < sinks``; segment ids ((m,) and (n,), shared across heads) keep a
    pair only where they are equal; ``softcap`` maps the scaled scores
    through cap·tanh(s/cap) before masking."""
    k, v = _gqa_repeat(q, k, v)
    return _softmax_pv(_masked_scores(
        q, k, scale=scale, causal=causal, softcap=softcap,
        q_offset=q_offset, kv_offset=kv_offset, kv_valid=kv_valid,
        window=window, sinks=sinks, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids), v)


def attention_reference_partials(q, k, v, *, scale=None, causal=False,
                                 softcap=None, q_offset=0, kv_offset=0,
                                 kv_valid=None, window=None, sinks=None,
                                 q_segment_ids=None, kv_segment_ids=None):
    """The unnormalized form of `attention_reference` (same inputs):
    float32 (sum of exp(s - max)·v, row max, row sum) of `_partials_pv`,
    the row max in the natural-log domain."""
    k, v = _gqa_repeat(q, k, v)
    return _partials_pv(_masked_scores(
        q, k, scale=scale, causal=causal, softcap=softcap,
        q_offset=q_offset, kv_offset=kv_offset, kv_valid=kv_valid,
        window=window, sinks=sinks, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids), v)


def decode_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    softcap: float | None = None,
    window: int | None = None,
    sinks: int | None = None,
    partials: bool = False,
    columns: torch.Tensor | None = None,
):
    """The S tokens appended last to each sequence, against its dense
    cache: q (B, H, S, d), k (B, Hkv, N, d), v (B, Hkv, N, dv), lengths
    (B,) after the append (a negative length reads as 0).  Row (b, h,
    s) sits at position ``lengths[b] - S + s`` and sees the cache rows
    at or before it; with ``window`` only the last ``window`` of them
    plus the first ``sinks``; with ``columns``, a (B, N) bool mask, only
    the cache rows it holds.  Returns (B, H, S, dv) in ``v.dtype``, or
    with ``partials`` the float32 (unnormalized output, row max, row
    sum) of `_partials_pv`."""
    check_softcap(softcap)
    b, h, s_new = q.shape[:3]
    hkv, n = k.shape[1], k.shape[2]
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    lens = lengths.to(device=q.device, dtype=torch.int64).clamp(min=0)
    pos = lens[:, None] - s_new + torch.arange(s_new, device=q.device)
    pos = pos[:, None, :, None]                         # (B, 1, S, 1)
    col = torch.arange(n, device=q.device)
    keep = (col <= pos) & band_keep(col, pos, window, sinks)
    if columns is not None:
        keep = keep & columns[:, None, None, :]
    scores = scores.masked_fill(~keep, float("-inf"))
    return _partials_pv(scores, v) if partials else _softmax_pv(scores, v)


def ragged_paged_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    kv_lens: torch.Tensor,
    cu_q_lens: torch.Tensor,
    distribution: torch.Tensor,
    *,
    scale: float | None = None,
    softcap: float | None = None,
    window: int | None = None,
    sinks: int | None = None,
) -> torch.Tensor:
    """One packed mixed decode/prefill step, slot by slot.

    ``q`` (1, Hq, T, d): slot ``s`` owns tokens ``[cu_q_lens[s],
    cu_q_lens[s+1])`` and reads its ``kv_lens[s]`` (post-append) cache
    rows through ``page_table[s]`` from the (P, Hkv, page, d) pools; the
    token at span offset ``t`` attends positions ``<= kv_len - q_len +
    t``, within the band of `band_keep` under a ``window``.  Slots at or
    beyond ``distribution[1]`` and empty slots write
    nothing, pad tokens stay zero, and a slot with ``kv_len < 0`` emits
    NaN rows.  Returns (1, Hq, T, dv) in the pools' dtype."""
    check_softcap(softcap)
    _, hq, t_pad, d = q.shape
    hkv, page = k_pool.shape[1], k_pool.shape[2]
    dv = v_pool.shape[-1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.zeros((1, hq, t_pad, dv), dtype=v_pool.dtype,
                      device=q.device)
    cu = cu_q_lens.tolist()
    lens = kv_lens.tolist()
    num_active = int(distribution[1])
    for s in range(num_active):
        q_start, q_len = cu[s], cu[s + 1] - cu[s]
        if q_len <= 0:
            continue
        kv_len = lens[s]
        if kv_len < 0:
            out[0, :, q_start:q_start + q_len] = float("nan")
            continue
        pages = page_table[s, :-(-kv_len // page)].long()
        # (pages, Hkv, page, d) -> (Hkv, pages * page, d), cut to kv_len
        keys = k_pool[pages].transpose(0, 1).reshape(hkv, -1, d)[:, :kv_len]
        vals = v_pool[pages].transpose(0, 1).reshape(hkv, -1, dv)
        vals = vals[:, :kv_len]
        qs = q[0, :, q_start:q_start + q_len]               # (Hq, q_len, d)
        keys = keys.repeat_interleave(group, dim=0)
        vals = vals.repeat_interleave(group, dim=0)
        scores = torch.matmul(qs.float(), keys.float().transpose(-1, -2))
        scores = scores * scale
        if softcap is not None:
            scores = softcap * torch.tanh(scores / softcap)
        pos = kv_len - q_len + torch.arange(q_len, device=q.device)
        col = torch.arange(kv_len, device=q.device)
        keep = (col[None, :] <= pos[:, None]) & band_keep(
            col[None, :], pos[:, None], window, sinks)
        scores = scores.masked_fill(~keep, float("-inf"))
        out[0, :, q_start:q_start + q_len] = _softmax_pv(scores, vals)
    return out
