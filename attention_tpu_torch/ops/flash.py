"""Forward flash attention: the port of `attention_tpu.ops.flash`.

`flash_attention` keeps the JAX entry point's keywords for the set the
port supports (``scale``, ``causal``, ``softcap``, the offsets
``q_offset``/``kv_offset`` and ``kv_valid`` of cached prefill, the
sliding ``window`` with attention ``sinks``, packed-sequence segment
ids, GQA over 2-D, 3-D and 4-D inputs); `flash_attention_partials`
returns the
unnormalized output with the row stats instead, as training's forward
saves them.  For a CUDA tensor both launch the hand-written Hopper kernel
``csrc/flash_fwd.cu`` (which replaces the TPU kernel `_flash_kernel`);
for a CPU tensor they run `flash_attention_plain` and
`flash_attention_partials_plain`, the plain PyTorch versions of the same
functions.  ``max_mode`` picks the rescaling math of the softmax
recurrence, as in JAX: "online" (the running max), "bound" (a
Cauchy-Schwarz row bound in place of the max, guarded at run time),
"flashd" (FLASH-D: the accumulator kept normalized) and "amla" (AMLA:
the max ceiled to an integer, rescales as exponent adds).  All four give
the same output; `flash_attention_partials`' row stats follow each
variant's contract (`resolve_max_mode`, `variant_partials_plain`).
"auto" and ``block_sizes`` raise `NotImplementedError` until a later
slice ports the tuning table.

The kernel has two bodies, and `flash_body` names the one a call runs:
"wgmma" (``csrc/flash_fwd_sm90.cuh``) for bf16 at head dims 64/128 with
16-byte aligned operands, "fma" for the rest.  The wgmma body cuts each
row block's key tiles across CTAs where the grid would leave SMs idle
(`flash_split_plan`) and merges the splits' partials in a second kernel.
Under a window both bodies walk only a row block's sink tiles and its
band, as the TPU kernel's banded grid does.  Segment ids mask and do
not move the walk: a call with ids visits the tiles it would visit
without them and tests every element of each.  `tile_plan` and
`flash_split_partials` are the kernel's tiles and split in PyTorch,
which the CPU tests hold against the plain mask and against the JAX
package (the main path runs them only inside the kernel).
"""

from __future__ import annotations

import math
from typing import NamedTuple

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
from attention_tpu_torch.ops.decode import (
    VARIANT_CODES,
    check_band,
    check_max_mode,
)
from attention_tpu_torch.ops.reference import (
    attention_mask,
    attention_reference,
    attention_reference_partials,
    check_softcap,
)

KERNEL = "flash_fwd"
_ARGTYPES = [P, P, P, P, I, I, I, I, I, I, I, I,
             *([L] * 12), F, F, I, I, I, I, I, I, P, P, P, I, I, I, P, P, P,
             I, P, P, P]

#: the C entry point's codes of the two bodies
BODY_CODES = {"fma": 0, "wgmma": 1}
#: query rows per CTA and keys per tile of the wgmma body: a split is a
#: whole number of key tiles
ROW_BLOCK = 128
KEY_TILE = 128
#: most splits of one row block's keys
MAX_SPLITS = 16

#: the rescaling-math variants of the softmax recurrence, in the order
#: of their C entry points' numbers (`decode.VARIANT_CODES`)
MAX_MODES = tuple(VARIANT_CODES)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
#: bound mode's overshoot limit in log2 units: the bound b exceeds a row's
#: largest score by at most this, so the row's largest probability
#: exp2(s - b) stays a normal float (fp32 normals reach 2^-126) with 30
#: units of margin; a call whose estimate exceeds it runs the online body
SAFE_OVERSHOOT_LOG2 = 96.0
#: "bound" resolves to "online" below this many score elements (heads ·
#: m · n over whole 128-row tiles, halved when causal), JAX's static
#: resolution at JAX's value; a module global so that tests can pin it to
#: 0.  On the H100 the guard (the key norms and the estimate, torch ops
#: on the card) cost more than the bound body saved at every size
#: ``chip_smoke.py``'s max_modes phase measured (`PERF.md`).
_BOUND_MIN_SCORE_ELEMS = 24 * 2**20


def flash_body(dtype, dk: int, dv: int, strides, ptrs,
               variant: str = "online", segmented: bool = False) -> str:
    """The kernel body that runs a call: "wgmma" for bfloat16 at head
    dims 64 or 128 whose (batch, head, row) ``strides`` (in elements, of
    q, k, v and the output) are positive multiples of 8 and whose base
    pointers ``ptrs`` are 16-byte aligned, as the body's TMA copies need,
    where the body has an instance of the ``variant``: "online" at every
    such head dim, "bound" at dk == dv, "flashd" and "amla" at dk == dv
    without segment ids; "fma" (fp32 FMA on the CUDA cores) for
    everything else."""
    if (dtype == torch.bfloat16 and dk in (64, 128) and dv in (64, 128)
            and all(x > 0 and x % 8 == 0 for x in strides)
            and all(p % 16 == 0 for p in ptrs)
            and (variant == "online" or (dk == dv and (
                variant == "bound" or not segmented)))):
        return "wgmma"
    return "fma"


def flash_split_plan(batch: int, heads: int, m: int, kv_valid: int, *,
                     sms: int, window: int | None = None,
                     sinks: int | None = None) -> tuple[int, int]:
    """(splits, split_tiles): how the wgmma body cuts each row block's
    visited key tiles across CTAs.  One CTA fills an SM, so a launch of
    fewer row blocks (B·H·⌈m/128⌉) than ``sms`` gets as many splits as
    fit the SMs, at most one per tile a block visits (the tiles of
    ``kv_valid``, or under a ``window`` at most its band's tiles and the
    ``sinks``' tiles) and `MAX_SPLITS`; each split takes ``split_tiles``
    tiles.  One split (no merge) wherever the grid already fills the
    card."""
    tiles = max(-(-kv_valid // KEY_TILE), 1)
    if window is not None:
        band = -(-(window - 1 + ROW_BLOCK) // KEY_TILE) + 1
        tiles = min(tiles, band + -(-(sinks or 0) // KEY_TILE))
    blocks = batch * heads * -(-m // ROW_BLOCK)
    splits = max(1, min(sms // blocks, tiles, MAX_SPLITS))
    per = -(-tiles // splits)
    return -(-tiles // per), per


class TilePlan(NamedTuple):
    """The key tiles a row block's CTA visits and where it masks (the
    kernel's `TilePlan` in csrc/flash_fwd_sm90.cuh).  The block visits
    the sink tiles [0, ``sink``), then the band's tiles from ``base``
    on: visit i is tile `tile` (i), and the split takes the visits
    [``begin``, ``end``).  Without a band visit i is tile i.  Tiles in
    [``mask_lo``, ``mask``) are kept whole by every row of the block and
    skip the per-element test."""

    begin: int
    end: int
    mask: int
    sink: int = 0
    base: int = 0
    mask_lo: int = 0

    def tile(self, i: int) -> int:
        return i if i < self.sink else self.base + i - self.sink

    def tiles(self) -> list[int]:
        """The split's visited tiles, in order."""
        return [self.tile(i) for i in range(self.begin, self.end)]


def plan_tiles(n_end: int, mask: int, band: int, full: int, sink_end: int,
               split: int = 0, split_tiles: int | None = None) -> TilePlan:
    """A block's plan from its key columns (the kernel's `plan_tiles`):
    every kept key lies below ``n_end``, tiles below ``mask`` hold no key
    past a row's end, the block's band starts at column ``band`` and
    every row's has started by ``full``, the columns below ``sink_end``
    are sinks.  The visited tiles are those that hold a kept key."""
    end = -(-n_end // KEY_TILE)
    sink = -(-min(sink_end, n_end) // KEY_TILE)
    base = max(band // KEY_TILE, sink) if band < n_end else end
    count = sink + end - base
    if split_tiles is None:
        split_tiles = max(count, 1)
    begin = min(split * split_tiles, count)
    return TilePlan(begin, min(begin + split_tiles, count), mask, sink,
                    base, -(-full // KEY_TILE))


def tile_plan(m0: int, m: int, kv_valid: int, causal: bool, q_offset: int,
              kv_offset: int, split: int = 0,
              split_tiles: int | None = None, *, window: int | None = None,
              sinks: int | None = None) -> TilePlan:
    """The `TilePlan` of the wgmma body's CTA of rows [m0, m0 + 128) in
    its split: the tiles holding a key some row keeps (below
    ``kv_valid``; under causal masking at or before the block's last
    row; under a ``window`` in a row's band or among the ``sinks``), and
    ``mask``, the first tile that can hold a key past ``kv_valid`` or
    after the block's first row.  The kernel's `tile_plan` in
    csrc/flash_fwd_sm90.cuh."""
    n_end, mask = kv_valid, kv_valid // KEY_TILE
    band = full = sink_end = 0
    if causal:
        d = q_offset - kv_offset
        last = min(m0 + ROW_BLOCK, m) - 1
        n_end = max(0, min(n_end, last + d + 1))
        mask = min(mask, max(0, (m0 + d + 1) // KEY_TILE))
        if window is not None:
            band = max(0, m0 + d - window + 1)
            full = max(0, last + d - window + 1)
            sink_end = max(0, (sinks or 0) - kv_offset)
    return plan_tiles(n_end, mask, band, full, sink_end, split, split_tiles)


def _strides(t) -> list[int]:
    """The (batch, head, row) element strides of a 4-D tensor, each dim
    of extent 1 given the stride it would have if contiguous over the
    dims inside it: any stride reads the same elements there, and the
    wgmma body's tensor maps take only positive multiples of 16 bytes."""
    out = list(t.stride()[:3])
    span = t.shape[3]
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            out[i] = span
        span = t.shape[i] * out[i]
    return out


def _canon(q, k, v):
    """Validate (m, d) / (h, m, d) / (b, h, m, d) inputs, as the JAX
    package's ``_canon`` does, and return 4-D (b, h, m, d) views."""
    # plain tuples: slicing and comparing torch.Size costs microseconds a
    # call on the kernel's host path
    qs, ks, vs = tuple(q.shape), tuple(k.shape), tuple(v.shape)
    if len(qs) != len(ks) or len(qs) != len(vs):
        raise ValueError(f"rank mismatch: Q{qs} K{ks} V{vs}")
    if qs[-1] != ks[-1] or ks[-2] != vs[-2]:
        raise ValueError(f"shape mismatch: Q{qs} K{ks} V{vs}")
    if ks[:-2] != vs[:-2]:
        raise ValueError(f"K/V head dims differ: K{ks} V{vs}")
    if len(qs) == 4 and qs[0] != ks[0]:
        raise ValueError(f"batch mismatch: Q{qs} K{ks}")
    if len(qs) >= 3 and qs[-3] % ks[-3] != 0:
        raise ValueError(
            f"q heads {qs[-3]} not a multiple of kv heads {ks[-3]}")
    if len(qs) not in (2, 3, 4):
        raise ValueError(f"unsupported rank {len(qs)} for flash attention")
    lead = 4 - q.dim()
    return tuple(t[(None,) * lead] for t in (q, k, v))


def _offsets(n, q_offset, kv_offset, kv_valid) -> dict:
    """The offsets as ints, ``kv_valid`` (default n) cut to [0, n]."""
    return dict(q_offset=int(q_offset or 0), kv_offset=int(kv_offset or 0),
                kv_valid=n if kv_valid is None
                else min(max(int(kv_valid), 0), n))


def _unsupported(**features) -> None:
    """Raise `NotImplementedError` for a keyword the port still lacks
    (``block_sizes`` of the backward and the autograd entry)."""
    for name, value in features.items():
        if value is not None:
            raise NotImplementedError(
                f"flash attention's {name}=... is not ported yet; the port "
                "supports scale, causal, softcap, q_offset, kv_offset, "
                "kv_valid, window, sinks and segment ids")


def check_segments(q, k, q_segment_ids, kv_segment_ids, n=None):
    """The JAX entry points' contract for packed-sequence segment ids
    (attention_tpu/ops/flash.py:885-887, :1222-1240, :1354-1358), as
    `ValueError`: the two go together, the inputs are 2-D or 3-D (the
    ids are shared across heads and batch rows), and each is a 1-D
    vector of its sequence's length (q's m, k's n, or ``n`` where the
    keys are gathered from k's blocks).  Returns them as contiguous
    int32 on q's device, or (None, None) without ids."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    if q_segment_ids is None:
        return None, None
    if q.dim() == 4:
        raise ValueError(
            "segment ids support 2D/3D inputs (ids shared across heads); "
            "loop over the batch for per-sequence ids")
    ids = [torch.as_tensor(x, device=q.device)
           for x in (q_segment_ids, kv_segment_ids)]
    n = k.shape[-2] if n is None else n
    if (any(x.dim() != 1 for x in ids) or ids[0].shape[0] != q.shape[-2]
            or ids[1].shape[0] != n):
        raise ValueError(
            f"segment id shapes {tuple(ids[0].shape)}/{tuple(ids[1].shape)}"
            f" != ({q.shape[-2]},)/({n},)")
    return tuple(x.to(torch.int32).contiguous() for x in ids)


def check_window(causal, window, sinks, segmented=False) -> None:
    """The JAX entry point's window/sinks contract
    (attention_tpu/ops/flash.py:888-911): the decode kernels' band
    (`decode.check_band`), which here needs causal masking, and sinks do
    not compose with segment ids (their positions are absolute)."""
    if window is not None and not causal:
        raise ValueError(
            "window (sliding-window attention) requires causal=True")
    check_band(window, sinks)
    if sinks is not None and segmented:
        raise ValueError(
            "sinks do not compose with segment_ids (sink positions are "
            "absolute, not per-segment); unpack the batch")


def resolve_max_mode(max_mode: str, *, heads: int, m: int, n: int,
                     causal: bool, window=None) -> str:
    """The variant a call runs, resolved statically as JAX's
    `_flash_call` does: "bound" becomes "online" under a window (the band
    is short, the guard a fixed cost) and below `_BOUND_MIN_SCORE_ELEMS`
    score elements (``heads`` counts every batch row's heads).  Same
    output either way."""
    check_max_mode(max_mode)
    if max_mode != "bound":
        return max_mode
    elems = heads * -(-m // ROW_BLOCK) * ROW_BLOCK * -(-n // KEY_TILE) \
        * KEY_TILE * (0.5 if causal else 1.0)
    if window is not None or elems < _BOUND_MIN_SCORE_ELEMS:
        return "online"
    return "bound"


def key_norm_max(k4: torch.Tensor) -> torch.Tensor:
    """(B, Hkv) float32: the largest L2 norm among each kv head's key
    rows, every row of k counted (JAX's ``knmax``)."""
    return k4.float().square().sum(-1).sqrt().amax(-1)


def _row_bound(q4, knmax, qscale: float, softcap2) -> torch.Tensor:
    """(B, H, m) bound mode's row bound in the log2 domain: ||q|| ·
    qscale · knmax of the row's kv head (|s| <= ||q|| ||k||), capped at
    softcap · log2 e where a softcap is set (|cap · tanh(s / cap)| <=
    cap)."""
    group = q4.shape[1] // knmax.shape[1]
    b = torch.linalg.vector_norm(q4, dim=-1, dtype=torch.float32) * qscale \
        * knmax.repeat_interleave(group, dim=1)[..., None]
    return b if softcap2 is None else b.clamp(max=softcap2)


def bound_overshoot_estimate(q4, k4, knmax, *, scale, causal=False,
                             q_offset=0, kv_offset=0, kv_valid=None,
                             window=None, sinks=None, softcap=None,
                             q_segment_ids=None, kv_segment_ids=None,
                             static_diag=False) -> torch.Tensor:
    """A 0-d float32 upper bound on bound mode's overshoot b - max s over
    every row (log2 units), JAX's `_bound_overshoot_estimate`: any column
    certified attended by a row gives s_ref <= max s, so b - s_ref bounds
    b - max s, from one key row per query row.  The reference column: 0
    without causal masking; under it the row's diagonal cut into the
    valid prefix; under a window the cut diagonal where it lies in the
    band, else column 0 when there are sinks.  Rows that attend nothing
    count 0 (their zeros are right whatever b is); with segment ids a row
    whose reference column lies in another segment counts +inf.
    ``static_diag``: plain causal self-attention (m == n, no offsets, no
    kv_valid), row i's reference is key row i.  q4 (B, H, m, d), k4 (B,
    Hkv, n, d), knmax (B, Hkv); device ops only, no sync."""
    b, h, m, d = q4.shape
    hkv, n = k4.shape[1], k4.shape[2]
    group = h // hkv
    qscale = scale * LOG2E
    softcap2 = None if softcap is None else softcap * LOG2E
    valid = n if kv_valid is None else kv_valid
    dev = q4.device
    bnd = _row_bound(q4, knmax, qscale, softcap2)
    rows = torch.arange(m, device=dev)
    c_ref = None
    excluded = torch.zeros(m, dtype=torch.bool, device=dev)
    if causal and static_diag:
        kr = k4[:, :, :m]
    elif causal:
        diag = rows + q_offset - kv_offset
        excluded = diag < 0
        c_ref = torch.clamp(torch.clamp(diag, max=valid - 1), 0, n - 1)
        if window is not None:
            in_win = c_ref >= diag - (window - 1)
            if sinks is not None:
                c_ref = torch.where(in_win, c_ref, 0)
            else:
                excluded = excluded | ~in_win
        kr = k4[:, :, c_ref]
    else:
        kr = k4[:, :, :1]
    if valid <= 0:
        excluded = torch.ones_like(excluded)
    # each query row against its reference key row, one product per kv
    # head and row over the group's heads
    s_ref = torch.matmul(q4.reshape(b, hkv, group, m, d).transpose(2, 3),
                         kr.unsqueeze(-1)).squeeze(-1).float()
    s_ref = s_ref.transpose(2, 3).reshape(b, h, m) * qscale
    if softcap2 is not None:
        s_ref = softcap2 * torch.tanh(s_ref / softcap2)
    over = bnd - s_ref
    if q_segment_ids is not None:
        kv_ids = kv_segment_ids.to(torch.int32)
        if causal and static_diag:
            ref = kv_ids[:m]
        elif c_ref is None:
            ref = kv_ids[:1].expand(m)
        else:
            ref = kv_ids[c_ref]
        over = torch.where(ref == q_segment_ids.to(torch.int32), over,
                           math.inf)
    return torch.where(excluded, 0.0, over).amax()


def _static_diag(m, n, causal, q_offset, kv_offset, kv_valid) -> bool:
    """Whether row i's reference column is key row i: plain causal
    self-attention (the training layer's call)."""
    return bool(causal and m == n and not q_offset and not kv_offset
                and kv_valid in (None, n))


def _log2_scores(q, k, *, scale, softcap, **mask):
    """float32 scores in the log2 domain (scale · log2 e folded in, as
    the kernels take them), capped by softcap · log2 e, masked entries
    -inf; k's heads repeated over their GQA group."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.dim() >= 3 and q.shape[-3] != k.shape[-3]:
        k = k.repeat_interleave(q.shape[-3] // k.shape[-3], dim=-3)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (scale * LOG2E)
    if softcap is not None:
        cap2 = softcap * LOG2E
        s = cap2 * torch.tanh(s / cap2)
    keep = attention_mask(*s.shape[-2:], device=q.device, **mask)
    return s.masked_fill(~keep, float("-inf"))


def variant_partials_plain(q, k, v, variant: str, *, scale=None,
                           causal=False, softcap=None, q_offset=0,
                           kv_offset=0, kv_valid=None, window=None,
                           sinks=None, q_segment_ids=None,
                           kv_segment_ids=None):
    """`flash_attention_partials` under a resolved ``variant``, each
    variant's stats in closed form (none depends on the tiling):

    * "online": the row's largest score and the sum of exp(s - max);
    * "bound": the row bound b (`_row_bound`, natural-log units) and the
      sum of exp(s - b), for every row, also one that sees no key (sum
      0), unless the overshoot estimate exceeds `SAFE_OVERSHOOT_LOG2`,
      when the call takes online's stats, as the kernel's guard does;
    * "flashd": the normalized output, the row's log-sum-exp and 1;
    * "amla": the largest score ceiled to a whole number of log2 units
      (natural-log units out), and the sum of exp(s - that).

    A row that sees no key has sum 0, output 0, and row max -inf except
    under "bound".  P is rounded to v's dtype for the product; the sums
    use it unrounded."""
    mask = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
                kv_valid=kv_valid, window=window, sinks=sinks,
                q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    if variant == "flashd":
        out_un, mx, l_ = attention_reference_partials(
            q, k, v, scale=scale, softcap=softcap, **mask)
        seen = l_ != 0.0
        l_safe = torch.where(seen, l_, 1.0)
        return (out_un / l_safe[..., None],
                torch.where(seen, mx + torch.log(l_safe), -math.inf),
                seen.float())
    if variant == "online":
        return attention_reference_partials(q, k, v, scale=scale,
                                            softcap=softcap, **mask)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _log2_scores(q, k, scale=scale, softcap=softcap, **mask)
    if variant == "amla":
        sub = torch.ceil(s.amax(dim=-1))
    else:
        q4, k4, _ = _canon(q, k, v)
        lead = (0,) * (4 - q.dim())
        knmax = key_norm_max(k4)
        est = bound_overshoot_estimate(
            q4, k4, knmax, scale=scale, softcap=softcap,
            static_diag=_static_diag(q.shape[-2], k.shape[-2], causal,
                                     q_offset, kv_offset, kv_valid),
            **mask)
        if float(est) > SAFE_OVERSHOOT_LOG2:
            return attention_reference_partials(q, k, v, scale=scale,
                                                softcap=softcap, **mask)
        sub = _row_bound(q4, knmax, scale * LOG2E,
                         None if softcap is None else softcap * LOG2E)[lead]
    if q.dim() >= 3 and q.shape[-3] != v.shape[-3]:
        v = v.repeat_interleave(q.shape[-3] // v.shape[-3], dim=-3)
    safe = torch.where(torch.isfinite(sub), sub, 0.0)
    p = torch.exp2(s - safe[..., None])
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out, sub * LN2, p.sum(dim=-1)


def flash_attention_plain(q, k, v, *, scale=None, causal=False,
                          softcap=None, q_offset=0, kv_offset=0,
                          kv_valid=None, window=None, sinks=None,
                          q_segment_ids=None,
                          kv_segment_ids=None) -> torch.Tensor:
    """The plain PyTorch version of `flash_attention` (same inputs,
    same output dtype: ``v.dtype``)."""
    _canon(q, k, v)
    ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    check_window(causal, window, sinks, ids[0] is not None)
    return attention_reference(q, k, v, scale=scale, causal=causal,
                               softcap=softcap, q_offset=q_offset,
                               kv_offset=kv_offset, kv_valid=kv_valid,
                               window=window, sinks=sinks,
                               q_segment_ids=ids[0], kv_segment_ids=ids[1])


def flash_attention_partials_plain(q, k, v, *, scale=None, causal=False,
                                   softcap=None, q_offset=0, kv_offset=0,
                                   kv_valid=None, window=None, sinks=None,
                                   q_segment_ids=None, kv_segment_ids=None,
                                   max_mode="online"):
    """The plain PyTorch version of `flash_attention_partials`:
    ``max_mode`` resolved as the kernel's wrapper resolves it
    (`resolve_max_mode`), then `variant_partials_plain`."""
    q4, k4, _ = _canon(q, k, v)
    ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    check_window(causal, window, sinks, ids[0] is not None)
    variant = resolve_max_mode(
        max_mode, heads=q4.shape[0] * q4.shape[1], m=q.shape[-2],
        n=k.shape[-2], causal=causal, window=window)
    return variant_partials_plain(
        q, k, v, variant, scale=scale, causal=causal, softcap=softcap,
        q_offset=q_offset, kv_offset=kv_offset, kv_valid=kv_valid,
        window=window, sinks=sinks, q_segment_ids=ids[0],
        kv_segment_ids=ids[1])


def flash_split_partials(q, k, v, *, splits: int, split_tiles: int,
                         scale=None, causal=False, softcap=None,
                         q_offset=0, kv_offset=0, kv_valid=None):
    """Each split's partials as the wgmma body's split CTAs write them:
    split i takes the keys [i·w, (i+1)·w), w = ``split_tiles`` key tiles
    (a plan of `flash_split_plan`, whose every split starts below n).
    float32 (unnormalized output (..., m, splits, dv), row max in natural
    log and row sum (..., m, splits)), max -inf and sum 0 for a split
    that sees nothing; `ops.decode.merge_splits` merges them as the
    kernel's merge does."""
    _canon(q, k, v)
    n = k.shape[-2]
    valid = n if kv_valid is None else min(max(int(kv_valid), 0), n)
    width = split_tiles * KEY_TILE
    parts = []
    for i in range(splits):
        lo = i * width
        hi = min(lo + width, n)
        parts.append(attention_reference_partials(
            q, k[..., lo:hi, :], v[..., lo:hi, :], scale=scale,
            causal=causal, softcap=softcap, q_offset=q_offset,
            kv_offset=kv_offset + lo,
            kv_valid=min(max(valid - lo, 0), hi - lo)))
    acc, mx, sm = zip(*parts)
    return torch.stack(acc, dim=-2), torch.stack(mx, -1), torch.stack(sm, -1)


def flash_launch_plan(q, k, v, *, kv_valid=None, window=None,
                      sinks=None, variant="online",
                      segmented=False) -> dict:
    """How the kernel runs a call on these inputs (CUDA tensors, as the
    entry points take them) under a resolved ``variant``: the body
    (`flash_body`) and the key split (`flash_split_plan`; one split for
    the "fma" body).  The output lies in storage the wrapper allocates,
    always aligned, with (b, m, h, dv) strides."""
    q4, k4, v4 = (t if t.stride(-1) == 1 else t.contiguous()
                  for t in _canon(q, k, v))
    return _plan(q4, k4, v4, _offsets(k4.shape[2], None, None,
                                      kv_valid)["kv_valid"], window, sinks,
                 variant, segmented)


def _plan(q4, k4, v4, kv_valid, window, sinks, variant="online",
          segmented=False) -> dict:
    b, h, m, dk = q4.shape
    dv = v4.shape[-1]
    o_strides = [m * h * dv, dv, h * dv]
    strides = [*_strides(q4), *_strides(k4), *_strides(v4), *o_strides]
    body = flash_body(q4.dtype, dk, dv, strides,
                      [t.data_ptr() for t in (q4, k4, v4)], variant,
                      segmented)
    splits, split_tiles = 1, 0
    if body == "wgmma":
        splits, split_tiles = flash_split_plan(
            b, h, m, kv_valid, sms=_native.sm_count(q4.device.index),
            window=window, sinks=sinks)
    return dict(body=body, splits=splits, split_tiles=split_tiles,
                strides=strides)


def _launch(q4, k4, v4, *, scale, causal, softcap, q_offset, kv_offset,
            kv_valid, window, sinks, q_ids=None, kv_ids=None,
            partials=False, variant="online"):
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
    plan = _plan(q4, k4, v4, kv_valid, window, sinks, variant,
                 q_ids is not None)
    # (b, m, h, dv) storage: the attention layer's head merge is a view
    o4 = torch.empty((b, m, h, dv), dtype=torch.float32 if partials
                     else dtype, device=q4.device).transpose(1, 2)
    stats = (torch.empty((2, b, h, m), dtype=torch.float32,
                         device=q4.device) if partials else None)
    splits = plan["splits"]
    part = (torch.empty(splits * b * h * m * (dv + 2), dtype=torch.float32,
                        device=q4.device) if splits > 1 else None)
    if kv_ids is not None:
        # whole key tiles of ids, the tail -2 (no real id): the wgmma body
        # copies a tile's ids into its K/V stage in one bulk copy
        kv_ids = torch.nn.functional.pad(kv_ids, (0, -n % KEY_TILE),
                                         value=-2)
    knmax = demote = None
    if variant == "bound":
        # the guard on the device: the key norms and the overshoot
        # estimate are a few small launches, the verdict an int32 the
        # kernel reads at its start (1: run the online body); no sync
        knmax = key_norm_max(k4)
        demote = (bound_overshoot_estimate(
            q4, k4, knmax, scale=scale, causal=causal, q_offset=q_offset,
            kv_offset=kv_offset, kv_valid=kv_valid, window=window,
            sinks=sinks, softcap=softcap, q_segment_ids=q_ids,
            kv_segment_ids=kv_ids,
            static_diag=_static_diag(m, n, causal, q_offset, kv_offset,
                                     kv_valid))
            > SAFE_OVERSHOOT_LOG2).to(torch.int32)
    fn = _native.function(KERNEL, "flash_fwd", _ARGTYPES)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        err = fn(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                 None if partials else o4.data_ptr(),
                 DTYPE_CODES[dtype], b, h, hkv, m, n, dk, dv,
                 *plan["strides"], float(scale),
                 float(softcap or 0.0), int(causal), q_offset, kv_offset,
                 kv_valid, window or 0, sinks or 0,
                 *((o4.data_ptr(), stats[0].data_ptr(),
                              stats[1].data_ptr()) if partials
                             else (None, None, None)),
                 BODY_CODES[plan["body"]], splits, plan["split_tiles"],
                 None if part is None else part.data_ptr(),
                 *((None, None) if q_ids is None
                   else (q_ids.data_ptr(), kv_ids.data_ptr())),
                 VARIANT_CODES[variant],
                 None if knmax is None else knmax.data_ptr(),
                 None if demote is None else demote.data_ptr(), stream)
    _native.check(KERNEL, err)
    _native.count_launch(KERNEL, variant)
    if demote is not None:
        _native.count_demotion(demote)
    return (o4, stats[0], stats[1]) if partials else o4


def _dispatch(q, k, v, plain, *, scale, causal, softcap, window, sinks,
              q_segment_ids, kv_segment_ids, q_offset, kv_offset, kv_valid,
              max_mode, partials):
    """Shared argument handling of the two entry points: validate, then
    the plain version for CPU tensors or the kernel for CUDA ones."""
    q_ids, kv_ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    check_window(causal, window, sinks, q_ids is not None)
    check_max_mode(max_mode)
    check_softcap(softcap)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    q4, k4, v4 = _canon(q, k, v)
    offsets = _offsets(k.shape[-2], q_offset, kv_offset, kv_valid)
    band = dict(window=window, sinks=sinks)
    if q.device.type == "cpu":
        extra = dict(max_mode=max_mode) if partials else {}
        return plain(q, k, v, scale=scale, causal=causal, softcap=softcap,
                     q_segment_ids=q_ids, kv_segment_ids=kv_ids,
                     **offsets, **band, **extra)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    variant = resolve_max_mode(max_mode, heads=q4.shape[0] * q4.shape[1],
                               m=q4.shape[2], n=k4.shape[2], causal=causal,
                               window=window)
    lead = (0,) * (4 - q.dim())
    out = _launch(q4, k4, v4, scale=scale, causal=causal, softcap=softcap,
                  q_ids=q_ids, kv_ids=kv_ids, partials=partials, **offsets,
                  **band, variant=variant)
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
    masking.  ``window`` (causal only) keeps, of the keys at or before a
    query's position p, those after p - window, and ``sinks`` (with a
    window) the keys at positions below it too (StreamingLLM); the
    kernel then walks only those keys' tiles.  ``q_segment_ids`` (m,)
    and ``kv_segment_ids`` (n,) (integers, together, 2-D and 3-D inputs
    only: shared across heads) keep a pair only where they are equal, on
    top of every other mask: packed sequences attend within their own
    document.  A row that sees no key comes out zero.  Output dtype is
    ``v.dtype``.  ``max_mode`` ("online", "bound", "flashd", "amla")
    picks the kernel's rescaling math, resolved by `resolve_max_mode`
    ("bound" runs online under a window and on small calls; its guard
    demotes a call whose overshoot estimate could leave fp32's range to
    the online body, on the device); every variant gives the same output.
    "auto" raises `NotImplementedError`.  CUDA tensors run the Hopper
    kernel; CPU tensors run `flash_attention_plain`."""
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
    float32, shapes (..., m, dv), (..., m), (..., m).  ``row_max`` is
    the value the recurrence subtracted from the row's scores, in the
    natural-log domain, ``out_unnorm`` the sum over keys of
    exp(s - row_max)·v and ``row_sum`` the sum of exp(s - row_max).
    What was subtracted depends on the resolved ``max_mode``
    (`variant_partials_plain`): the row's largest score ("online"), the
    row bound ("bound"), the log-sum-exp with sum 1 and the output
    normalized ("flashd"), the largest score ceiled to a whole number of
    log2 units ("amla").  A row that sees no key has sum 0 and output 0,
    and row max -inf except under "bound": a merge of partials weighs a
    part by its sum.  Same inputs and keywords as `flash_attention`.
    CUDA tensors run the Hopper kernel's partials epilogue; CPU tensors
    run `flash_attention_partials_plain`."""
    return _dispatch(q, k, v, flash_attention_partials_plain, scale=scale,
                     causal=causal, softcap=softcap, window=window,
                     sinks=sinks, q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids, q_offset=q_offset,
                     kv_offset=kv_offset, kv_valid=kv_valid,
                     max_mode=max_mode, partials=True)
