"""Plain PyTorch attention: the arithmetic the port's kernels must match.

`attention_reference` is the counterpart of `attention_tpu.ops.reference.
attention_xla` (plus the causal mask and GQA head grouping the flash
kernel takes), and `ragged_paged_reference` the counterpart of the
packed-step oracle `ragged_paged_reference` there, here in the caller's
working dtype.  Both compute scores, softmax and sums in float32 and
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


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = False,
    softcap: float | None = None,
) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over the last two axes.

    Shapes: q (..., m, dk), k (..., n, dk), v (..., n, dv).  With three
    or more axes the head axis (-3) of q may be a multiple of k's (GQA:
    q head h reads kv head h // group).  ``causal`` masks column j > row
    i (global positions start at 0 for both); ``softcap`` maps the
    scaled scores through cap·tanh(s/cap) before masking."""
    check_softcap(softcap)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.dim() >= 3 and q.shape[-3] != k.shape[-3]:
        group = q.shape[-3] // k.shape[-3]
        k = k.repeat_interleave(group, dim=-3)
        v = v.repeat_interleave(group, dim=-3)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if causal:
        m, n = scores.shape[-2:]
        row = torch.arange(m, device=q.device)[:, None]
        col = torch.arange(n, device=q.device)[None, :]
        scores = scores.masked_fill(col > row, float("-inf"))
    return _softmax_pv(scores, v)


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
) -> torch.Tensor:
    """One packed mixed decode/prefill step, slot by slot.

    ``q`` (1, Hq, T, d): slot ``s`` owns tokens ``[cu_q_lens[s],
    cu_q_lens[s+1])`` and reads its ``kv_lens[s]`` (post-append) cache
    rows through ``page_table[s]`` from the (P, Hkv, page, d) pools; the
    token at span offset ``t`` attends positions ``<= kv_len - q_len +
    t``.  Slots at or beyond ``distribution[1]`` and empty slots write
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
        scores = scores.masked_fill(col[None, :] > pos[:, None],
                                    float("-inf"))
        out[0, :, q_start:q_start + q_len] = _softmax_pv(scores, vals)
    return out
