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

Each kernel has two bodies, and `flash_bwd_body` names the one a call
runs: "wgmma" for bf16 at dk = dv = 64 or 128 with 16-byte aligned
operands, "fma" for the rest, head dims up to 256 (above 128 a CTA of
the FMA bodies owns 32 key or query rows instead of 64, as
`fma_resources` reports).
The fused and the dK/dV kernels' "wgmma" is one key-major body
(``csrc/flash_bwd_sm90.cuh``, the dK/dV instance without dQ), the dQ
kernel's a query-major one
(``csrc/flash_bwd_dq_sm90.cuh``) on the flash forward's schedule.
`bwd_tile_plan` and `bwd_work_plan` are the key-major body's query-tile
range and its cut of the call into work items, in Python, which the CPU
tests hold against the plain mask and the snake deal (the main path runs
them only inside the kernels, and the plan to size the launches); the dQ
body's key tiles are the flash forward's `ops.flash.tile_plan`.

Under a sliding ``window`` (causal only) the kernels walk only the band,
as the TPU kernels' banded grids do, with a window-only mask, and
``sinks`` add the sink pairs outside the band by `sink_patch`, the
port of JAX's `_sink_patch`: an m x sinks sliver in PyTorch products,
as JAX leaves it to XLA.

Packed-sequence segment ids mask every kernel's pairs on top of the
rest, as in the forward: the kernels walk the tiles they walk without
ids and test each element of each (the wgmma bodies in instances of
their own, `SEG`, so that a call without ids runs the code it ran
before them).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from attention_tpu_torch.ops import _native
from attention_tpu_torch.ops._native import DTYPE_CODES, F, I, L, P
from attention_tpu_torch.ops.flash import (
    _offsets,
    _strides,
    _unsupported,
    check_segments,
    check_window,
)
from attention_tpu_torch.ops.reference import band_keep, check_softcap

LOG2E = 1.0 / math.log(2.0)
LN2 = math.log(2.0)


#: launch counters of the three kernels (one library each)
FUSED, DQ, DKV = "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"
#: largest head dim the backward kernels take (the FMA bodies above 128)
MAX_HEAD_DIM = 256
#: the C entry points' codes of the two bodies
BODY_CODES = {"fma": 0, "wgmma": 1}
#: query rows per tile and keys per work item of the key-major wgmma body
QUERY_TILE = 64
KEY_BLOCK = 128
#: query rows per work item of the dQ wgmma body; lse2 and delta are
#: padded to whole items (whole query tiles too) for every body
DQ_ROWS = 128
#: the largest window the C entry points take: a wider one keeps the same
#: pairs, and its sums with row and key indices stay inside 32 bits
WINDOW_CAP = 1 << 30
#: `bwd_work_plan` splits a GQA group further until no CTA of the snake
#: deal carries more than this many times the mean load
BALANCE = 1.1
_ARGS = [*([I] * 9), *([L] * 12), F, F, I, I, I, I, I]
#: the C entry points' argument types: the operands and outputs, the
#: call's shape and options (`_ARGS`), the body and its slices, the
#: segment ids (two pointers, null without ids), the stream
ARGTYPES = {FUSED: [*([P] * 9), *_ARGS, I, I, P, P, P],
            DQ: [*([P] * 7), *_ARGS, I, P, P, P],
            DKV: [*([P] * 8), *_ARGS, I, I, P, P, P]}

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
                         kv_valid=None, window=None, sinks=None,
                         q_segment_ids=None, kv_segment_ids=None,
                         chunk=512):
    """The plain PyTorch version of `flash_backward` (same inputs and
    outputs), blocked over ``chunk`` query rows so that memory stays
    O(chunk·n) per head.  Under a ``window`` it takes the whole mask of
    the forward, band and ``sinks`` together (`reference.band_keep`),
    where the kernels take the band and `sink_patch` the sinks; segment
    ids mask the scores as JAX's blocked XLA backward does
    (attention_tpu/ops/flash_vjp.py:189-190)."""
    q_ids, kv_ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
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
            keep = keep & band_keep(col[None, :] + kv_offset,
                                    row[:, None] + q_offset, window, sinks)
        if q_ids is not None:
            keep = keep & (q_ids[rows, None] == kv_ids[None, :])
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


def sink_patch(q, k, v, out, lse, dout, *, scale, window, sinks,
               softcap=None, q_offset=0, kv_valid=None):
    """(dQ, dK, dV, se): the gradients of the sink pairs outside the
    window band, the port of JAX's `_sink_patch` (attention_tpu/ops/
    flash_bwd.py:619).  A windowed forward with sinks keeps two disjoint
    sets of pairs: the band, which the backward kernels take with a
    window-only mask, and the pairs of a row with the first ``sinks``
    keys that lie before its band (key < row + q_offset - (window - 1)),
    which this function takes.  P is recomputed from the saved lse over
    the same re-rounded Qs as the kernels', so each pair counts once with
    the forward's probability.  The sliver is m x se, se = min(sinks, n):
    O(m·sinks·d) operations in float32 products outside any kernel, as
    JAX takes them in XLA einsums.  dQ is (..., h, m, d) and dK, dV
    (..., hkv, se, d) summed over each GQA group, all float32, for the
    caller to add to the first ``se`` key rows.  Keys sit at positions 0..n
    - 1 (no kv_offset: sink positions are absolute); ``kv_valid`` masks a
    padded key tail."""
    (q4, k4, v4, o4, l4, do4), lead = _four_d(
        q, k, v, out, lse[..., None], dout)
    r0, dq_rows, dk, dvs, se = _sink_rows(
        q4, k4, v4, o4, l4[..., 0], do4, scale=scale, window=window,
        sinks=sinks, softcap=softcap, q_offset=q_offset, kv_valid=kv_valid)
    dq = torch.nn.functional.pad(dq_rows, (0, 0, r0, 0))
    return dq[lead], dk[lead], dvs[lead], se


def _sink_rows(q4, k4, v4, o4, lse4, do4, *, scale, window, sinks, softcap,
               q_offset, kv_valid, delta=None):
    """`sink_patch` on 4-D inputs ((b, h, m) lse), over the rows that keep
    a sink pair only: (r0, dQ of rows [r0, m), dK, dV, se).  A row keeps
    one once its band has passed key 0, from r0 = window - q_offset on;
    the rows before add nothing.  ``delta``, rowsum(dO ∘ O) in float32
    (b, h, >= m), is computed when not given."""
    b, h, m, d = q4.shape
    hkv, n, dv = v4.shape[1:]
    group = h // hkv
    se = min(sinks, n)
    r0 = min(m, max(0, window - q_offset))
    kx = k4[:, :, :se].float().repeat_interleave(group, dim=1)
    vx = v4[:, :, :se].float().repeat_interleave(group, dim=1)
    q32, do32 = q4[:, :, r0:].float(), do4[:, :, r0:].float()
    if delta is None:
        delta = (do32 * o4[:, :, r0:].float()).sum(-1, keepdim=True)
    else:
        delta = delta[:, :, r0:m, None]
    s = torch.matmul(_round(q32 * (scale * LOG2E), q4.dtype),
                     kx.transpose(-1, -2)) * LN2
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dcap = 1.0 - t * t
    lse32 = lse4[:, :, r0:, None].float()
    col = torch.arange(se, device=q4.device)
    rows = torch.arange(r0, m, device=q4.device) + q_offset
    mask = col[None, :] < rows[:, None] - (window - 1)
    if kv_valid is not None:
        mask = mask & (col < kv_valid)[None, :]
    mask = mask & (lse32 != float("-inf"))
    p = torch.where(mask, torch.exp(s - torch.where(mask, lse32, 0.0)), 0.0)
    ds = p * (torch.matmul(do32, vx.transpose(-1, -2)) - delta)
    if dcap is not None:
        ds = ds * dcap
    dq = torch.matmul(ds, kx) * scale
    dk = (torch.matmul(ds.transpose(-1, -2), q32) * scale).view(
        b, hkv, group, se, d).sum(2)
    dvs = torch.matmul(p.transpose(-1, -2), do32).view(
        b, hkv, group, se, dv).sum(2)
    return r0, dq, dk, dvs, se


def _add_patch(grads, patch) -> None:
    """Add `_sink_rows`'s (r0, dQ of rows [r0, m), dK, dV, se) to ``grads``
    (4-D dQ, dK, dV) in place, dK and dV on their first se key rows: to
    the float32 sums before their cast where a gradient is still float32,
    to the input dtype's values (one more rounding) where a kernel wrote
    that dtype."""
    r0, dq_s, dk_s, dv_s, se = patch
    for g, p in zip((grads[0][:, :, r0:], grads[1][:, :, :se],
                     grads[2][:, :, :se]), (dq_s, dk_s, dv_s)):
        g.copy_(g.float() + p)


def flash_bwd_body(dtype, d: int, dv: int, strides, ptrs) -> str:
    """The fused kernel's body that runs a call: "wgmma" for bfloat16 at
    dk = dv = 64 or 128 whose (batch, head, row) ``strides`` (in elements,
    of Qs, k, v and dO) are positive multiples of 8 and whose base
    pointers ``ptrs`` are 16-byte aligned, as the body's TMA copies need;
    "fma" (fp32 FMA on the CUDA cores) for everything else."""
    if (dtype == torch.bfloat16 and d == dv and d in (64, 128)
            and all(x > 0 and x % 8 == 0 for x in strides)
            and all(p % 16 == 0 for p in ptrs)):
        return "wgmma"
    return "fma"


class BwdTilePlan(NamedTuple):
    """The query tiles of 64 rows that the wgmma body's work item of keys
    [key0, key0 + 128) visits for each of its heads, [``begin``,
    ``end``), and where it masks: the tiles in [``mask_end``, ``edge``)
    keep every pair of the block and skip the per-element test.  Below
    ``mask_end`` a row may lie before a key (the causal diagonal) or the
    block holds a key at or past ``kv_valid``; from ``edge`` on a row's
    window band may have left the block's first keys behind."""

    begin: int
    end: int
    mask_end: int
    edge: int


def fma_resources(kernel: str, dtype, d: int, dv: int) -> dict:
    """What the "fma" instance of backward ``kernel`` (`FUSED`, `DQ` or
    `DKV`) that a ``dtype`` call at head dims (``d``, ``dv``) runs costs
    an SM of the current card: registers a thread, dynamic shared bytes a
    CTA, CTAs an SM holds, spilled bytes a thread, and the key
    (key-major) or query (query-major) rows a CTA owns."""
    fn = _native.function(kernel, f"{kernel}_fma_resources", [I, I, I, P])
    out = (ctypes.c_int * 5)()
    _native.check(kernel, fn(DTYPE_CODES[dtype], d, dv,
                             ctypes.addressof(out)))
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm",
                     "spill_bytes", "rows"), out))


def bwd_tile_plan(key0: int, m: int, kv_valid: int, causal: bool,
                  q_offset: int, kv_offset: int,
                  window: int | None = None) -> BwdTilePlan:
    """The `BwdTilePlan` of the wgmma body's work item of keys [key0,
    key0 + 128): the query tiles holding a row that keeps one of its keys
    (under causal masking at or after the key's position, under a
    ``window`` within ``window`` - 1 positions of it).  No tiles for a
    block past ``kv_valid``.  The kernel's `tile_plan` in
    csrc/flash_bwd_sm90.cuh."""
    tiles = -(-m // QUERY_TILE)
    if key0 >= kv_valid:
        return BwdTilePlan(0, 0, 0, 0)
    # causal: the first row that sees key0, and the first that sees the
    # block's last key 127 rows later; a window: the last row that sees
    # its last key below kv_valid, window - 1 rows after that key's first
    first = key0 + kv_offset - q_offset
    begin = (tiles if first >= m else max(0, first // QUERY_TILE)) \
        if causal else 0
    end = tiles
    if window is not None:
        span = min(KEY_BLOCK, kv_valid - key0)
        end = max(begin, min(tiles, (first + span + window - 2)
                             // QUERY_TILE + 1))
    if key0 + KEY_BLOCK > kv_valid:
        mask_end = end
    elif causal:
        mask_end = min(end, max(begin, -(-(first + KEY_BLOCK - 1)
                                         // QUERY_TILE)))
    else:
        mask_end = begin
    # a window: row first + window is the first whose band has left key0
    edge = end if window is None else min(end, max(
        mask_end, (first + window) // QUERY_TILE))
    return BwdTilePlan(begin, end, mask_end, edge)


def snake_loads(loads, grid: int) -> list:
    """Each CTA's summed load when the work items of ``loads`` (in launch
    order) are dealt to ``grid`` CTAs a round at a time, left to right in
    even rounds and right to left in odd ones, as `snake_item` in
    csrc/sm90.cuh deals them."""
    out = [0] * grid
    for i, load in enumerate(loads):
        r, pos = divmod(i, grid)
        out[grid - 1 - pos if r % 2 else pos] += load
    return out


def bwd_work_item(w: int, batch: int, kv_heads: int, group: int,
                  slices: int) -> tuple[int, int, int, range]:
    """(batch, kv head, key block, q heads) of the wgmma body's work item
    ``w``: the key block varies slowest, from block 0 (under causal
    masking the heaviest) up, then the batch, the kv head and the slice
    of its group, whose group/slices q heads the item walks in order.
    The kernel's `work_item` in csrc/flash_bwd_sm90.cuh."""
    kb, rest = divmod(w, batch * kv_heads * slices)
    bhk, part = divmod(rest, slices)
    b, hk = divmod(bhk, kv_heads)
    per = group // slices
    first = hk * group + part * per
    return b, hk, kb, range(first, first + per)


class WorkPlan(NamedTuple):
    """How the wgmma body cuts a call into work items."""
    slices: int  # slices of each GQA group: q heads per item group/slices
    items: int  # key blocks x batch x kv heads x slices
    grid: int  # CTAs of the persistent grid
    heaviest: int  # the largest CTA load of the snake deal, in query tiles
    mean: float  # the query tiles of the call over the SMs


@functools.lru_cache(maxsize=256)
def bwd_work_plan(batch: int, kv_heads: int, group: int, m: int, n: int,
                  kv_valid: int, causal: bool, q_offset: int,
                  kv_offset: int, window: int | None = None, *,
                  sms: int, min_slices: int = 1) -> WorkPlan:
    """The wgmma body's work items for a call: each is one block of 128
    keys of one kv head and one of ``slices`` equal slices of its group's
    q heads, walked in order (so dK and dV are summed over the group in a
    fixed order), heaviest key block first.  ``slices`` is the fewest
    whose snake deal over at most ``sms`` CTAs gives no CTA more than
    `BALANCE` times the mean load (a query tile of one head counts one);
    failing that, the slices of the lightest heaviest CTA.  One slice
    writes dK and dV directly, more write fp32 partials that the wrapper
    sums, so fewer slices are cheaper where they balance.  Under a
    ``window`` an item's load is its block's band of query tiles.
    ``min_slices`` (at most the group) is the fewest slices to take: 2
    makes the body write float32 partials wherever the group splits."""
    per_head = []
    for kb in range(-(-n // KEY_BLOCK)):
        plan = bwd_tile_plan(kb * KEY_BLOCK, m, kv_valid, causal, q_offset,
                             kv_offset, window)
        per_head.append(plan.end - plan.begin)
    mean = batch * kv_heads * group * sum(per_head) / sms
    best = None
    for slices in (s for s in range(min(min_slices, group), group + 1)
                   if group % s == 0):
        items = len(per_head) * batch * kv_heads * slices
        loads = []
        for w in range(items):
            _, _, kb, heads = bwd_work_item(w, batch, kv_heads, group,
                                            slices)
            loads.append(len(heads) * per_head[kb])
        grid = min(items, sms)
        plan = WorkPlan(slices, items, grid, max(snake_loads(loads, grid)),
                        mean)
        if plan.heaviest <= BALANCE * mean:
            return plan
        if best is None or plan.heaviest < best.heaviest:
            best = plan
    return best


def _scaled_q(q4: torch.Tensor, scale: float) -> torch.Tensor:
    """Qs = round(q·scale·log2 e) in q's dtype: one op, computed in float32
    and rounded once, the bits of ``(q.float() * c).to(q.dtype)``."""
    return q4 * (scale * LOG2E)


def _delta(do4: torch.Tensor, o4: torch.Tensor) -> torch.Tensor:
    """rowsum(dO ∘ O) in float32, the bits of ``(do.float() *
    o.float()).sum(-1)``: the product of two bf16 (or f32) values is
    exact in float32, and `addcmul` forms it from the inputs as they are
    (a float32 zero of shape (1,) sets the result type) instead of from
    two float32 copies."""
    zero = torch.zeros(1, dtype=torch.float32, device=do4.device)
    return torch.addcmul(zero, do4, o4).sum(-1)


def _lse2(lse4: torch.Tensor, rows: int) -> torch.Tensor:
    """lse·log2 e in float32 (the bits of ``lse.float() * LOG2E``) padded
    to ``rows`` with +inf, and +inf where the forward saw no key (-inf):
    the kernels' exp2(s - lse2) is then the 0 such a row needs, with no
    test."""
    x = lse4.float() * LOG2E
    x = torch.where(x == float("-inf"), float("inf"), x)
    return torch.nn.functional.pad(x, (0, rows - x.shape[-1]),
                                   value=float("inf"))


class _Staged:
    """The 4-D CUDA operands checked and staged as the kernels read them
    (Qs and dO in the input dtype, lse2 and delta in float32 padded to
    whole dQ items, the segment ids in int32 padded to whole dQ items
    with -1 and to whole key blocks with -2, ids no real row holds), the
    fused kernel's plan and the pair's, and their launches."""

    def __init__(self, q4, k4, v4, o4, lse4, do4, *, scale, causal, softcap,
                 q_offset, kv_offset, kv_valid, window=None, q_ids=None,
                 kv_ids=None, grad_dtype=None):
        dtype = q4.dtype
        if (dtype not in DTYPE_CODES or k4.dtype != dtype
                or v4.dtype != dtype):
            raise TypeError(
                "flash backward kernels take float32 or bfloat16 q/k/v of "
                f"one dtype, got {q4.dtype}/{k4.dtype}/{v4.dtype}")
        if len({t.device for t in (q4, k4, v4, o4, lse4, do4)}) != 1:
            raise ValueError("flash backward's tensors must be on one device")
        b, h, m, d = q4.shape
        hkv, n, dv = v4.shape[1:]
        if max(d, dv) > MAX_HEAD_DIM:
            raise ValueError(f"head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
        if min(m, n) < 1:
            raise ValueError(f"empty attention: m={m} n={n}")
        self.shape = (b, h, hkv, m, n, d, dv)
        self.dtype, self.device = dtype, q4.device
        self.grad_dtype = grad_dtype or dtype
        self.ls = -(-m // DQ_ROWS) * DQ_ROWS
        self.qs, self.k, self.v, self.do = (
            t if t.stride(-1) == 1 else t.contiguous()
            for t in (_scaled_q(q4, scale), k4, v4, do4.to(dtype)))
        self.lse2 = _lse2(lse4, self.ls)
        self.delta = torch.nn.functional.pad(_delta(do4, o4),
                                             (0, self.ls - m))
        self.ids = (None, None) if q_ids is None else (
            torch.nn.functional.pad(q_ids, (0, self.ls - m), value=-1),
            torch.nn.functional.pad(kv_ids, (0, -n % KEY_BLOCK), value=-2))
        self.strides = [x for t in (self.qs, self.k, self.v, self.do)
                        for x in _strides(t)]
        self.args = (DTYPE_CODES[dtype], b, h, hkv, m, n, d, dv, self.ls,
                     *self.strides, float(scale),
                     float(softcap * LOG2E if softcap else 0.0), int(causal),
                     q_offset, kv_offset, kv_valid,
                     0 if window is None else min(window, WINDOW_CAP))
        body = flash_bwd_body(dtype, d, dv, self.strides, [
            t.data_ptr() for t in (self.qs, self.k, self.v, self.do)])
        self.plan = dict(body=body, slices=1)
        # the pair: the dK/dV kernel on the fused kernel's work plan, the
        # dQ kernel's items
        self.pair_plan = dict(body=body, slices=1)
        if body == "wgmma":
            sms = _native.sm_count(q4.device.index)
            work = bwd_work_plan(b, hkv, h // hkv, m, n, kv_valid, causal,
                                 q_offset, kv_offset, window, sms=sms,
                                 min_slices=1 if grad_dtype is None else 2)
            self.plan.update(work._asdict())
            items = b * h * -(-m // DQ_ROWS)
            self.pair_plan.update(
                slices=work.slices, dq_items=items, dq_grid=min(items, sms),
                dkv_items=work.items, dkv_grid=work.grid)

    def _call(self, kernel, pointers, extra):
        fn = _native.function(kernel, kernel, ARGTYPES[kernel])
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = fn(self.qs.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                     self.do.data_ptr(), self.lse2.data_ptr(),
                     self.delta.data_ptr(), *(t.data_ptr() for t in pointers),
                     *self.args, *extra,
                     *(None if t is None else t.data_ptr() for t in self.ids),
                     stream)
        _native.check(kernel, err)
        _native.count_launch(kernel)

    def _kv_outputs(self, plan, per_q_head: bool) -> dict:
        """dK and dV as the plan's body writes them: "wgmma" in the input
        dtype for one slice, else fp32 slice partials (b, hkv, slices, n,
        d); "fma" in fp32, per Q head (the fused kernel) or summed over the
        group (the dK/dV kernel)."""
        b, h, hkv, m, n, d, dv = self.shape
        if plan["body"] == "fma":
            heads = h if per_q_head else hkv
            kv = [(b, heads, n, d), (b, heads, n, dv),
                  dict(dtype=torch.float32, device=self.device)]
        elif plan["slices"] == 1:
            kv = [(b, hkv, n, d), (b, hkv, n, dv),
                  dict(dtype=self.dtype, device=self.device)]
        else:
            kv = [(b, hkv, plan["slices"], n, d),
                  (b, hkv, plan["slices"], n, dv),
                  dict(dtype=torch.float32, device=self.device)]
        return dict(dk=torch.empty(kv[0], **kv[2]),
                    dvo=torch.empty(kv[1], **kv[2]))

    def _kv_grads(self, dq, dk, dvo, patch):
        """(dQ, dK, dV) in the gradient dtype (the input dtype unless the
        call asked for another) from the kernels' outputs: per-Q-head or
        slice partials of dK and dV summed over the group in order, and
        the sink ``patch`` of `_sink_rows` (or None) added
        (`_add_patch`)."""
        b, h, hkv, m, n, d, dv = self.shape
        if dk.dim() == 4 and dk.shape[1] != hkv:
            dk = dk.view(b, hkv, h // hkv, n, d)
            dvo = dvo.view(b, hkv, h // hkv, n, dv)
        if dk.dim() == 5:
            dk, dvo = dk.sum(2), dvo.sum(2)
        if patch is not None:
            _add_patch((dq, dk, dvo), patch)
        return tuple(t.to(self.grad_dtype) for t in (dq, dk, dvo))

    def fused_buffers(self) -> dict:
        """The fused kernel's outputs for this call's plan: dq32 (zeroed)
        and `_kv_outputs`."""
        b, h, hkv, m, n, d, dv = self.shape
        return dict(dq32=torch.zeros((b, h, m, d), dtype=torch.float32,
                                     device=self.device),
                    **self._kv_outputs(self.plan, per_q_head=True))

    def fused(self, dq32, dk, dvo) -> None:
        """Launch the fused kernel into `fused_buffers`."""
        self._call(FUSED, (dq32, dk, dvo),
                   (BODY_CODES[self.plan["body"]], self.plan["slices"]))

    def fused_grads(self, dq32, dk, dvo, patch=None):
        """(dQ, dK, dV) in the input dtype from the fused kernel's
        outputs, with the sink ``patch`` added to the float32 dQ."""
        return self._kv_grads(dq32, dk, dvo, patch)

    def pair_buffers(self) -> dict:
        """The pair's outputs for this call's plan: dQ in the input dtype
        and `_kv_outputs`."""
        b, h, hkv, m, n, d, dv = self.shape
        return dict(dq=torch.empty((b, h, m, d), dtype=self.dtype,
                                   device=self.device),
                    **self._kv_outputs(self.pair_plan, per_q_head=False))

    def pair(self, kernel, dq=None, dk=None, dvo=None) -> None:
        """Launch the dQ or the dK/dV kernel into `pair_buffers`."""
        plan = self.pair_plan
        body = BODY_CODES[plan["body"]]
        if kernel == DQ:
            self._call(DQ, (dq,), (body,))
        else:
            self._call(DKV, (dk, dvo), (body, plan["slices"]))

    def pair_grads(self, dq, dk, dvo, patch=None):
        """(dQ, dK, dV) in the input dtype from the pair's outputs: no
        cast where the kernels wrote the input dtype, whose dQ takes the
        sink ``patch`` after its rounding, as JAX's pair does."""
        return self._kv_grads(dq, dk, dvo, patch)


def _launch(q4, k4, v4, o4, lse4, do4, *, sinks=None, **kw):
    """The fused kernel, or the dQ and dK/dV pair under
    `_FORCE_TWO_KERNEL`, on 4-D CUDA operands; with ``sinks`` the
    kernels take the window band and `sink_patch` the sink pairs."""
    staged = _Staged(q4, k4, v4, o4, lse4, do4, **kw)
    patch = None if sinks is None else _sink_rows(
        q4, k4, v4, o4, lse4, do4, scale=kw["scale"], window=kw["window"],
        sinks=sinks, softcap=kw["softcap"], q_offset=kw["q_offset"],
        kv_valid=kw["kv_valid"], delta=staged.delta)
    if not _FORCE_TWO_KERNEL:
        out = staged.fused_buffers()
        staged.fused(**out)
        return staged.fused_grads(**out, patch=patch)
    out = staged.pair_buffers()
    staged.pair(DQ, dq=out["dq"])
    staged.pair(DKV, dk=out["dk"], dvo=out["dvo"])
    return staged.pair_grads(**out, patch=patch)


def bwd_launch_plan(q, k, v, out, lse, dout, *, scale=None, causal=False,
                    q_offset=None, kv_offset=None, kv_valid=None,
                    window=None) -> dict:
    """How the kernels run a call on these inputs (CUDA tensors, as
    `flash_backward` takes them): the fused kernel's body
    (`flash_bwd_body`) and, for "wgmma", its `bwd_work_plan` (slices,
    items, grid, heaviest, mean); under ``"pair"`` the dQ and dK/dV
    kernels' body and, for "wgmma", the slices of the dK/dV kernel (the
    fused plan's), its items and grid, and the dQ kernel's items and
    grid; under a ``window`` the items' loads are their bands."""
    tensors, _ = _four_d(q, k, v, out, lse[..., None], dout)
    tensors[4] = tensors[4][..., 0]
    staged = _Staged(
        *tensors, scale=q.shape[-1] ** -0.5 if scale is None else scale,
        causal=causal, softcap=None, window=window,
        **_offsets(k.shape[-2], q_offset, kv_offset, kv_valid))
    return dict(staged.plan, pair=dict(staged.pair_plan))


def check_backward_band(causal, window, sinks, kv_offset,
                        segmented) -> None:
    """JAX's refusals of a band in the backward (attention_tpu/ops/
    flash_bwd.py:797-812), as `ValueError`: sinks with a ``kv_offset``
    (sink positions are absolute), then `ops.flash.check_window`'s
    (a window needs causal masking, sinks a window, and sinks do not
    compose with segment ids)."""
    if sinks is not None and kv_offset is not None:
        raise ValueError(
            "sinks do not compose with kv_offset (sink positions are "
            "absolute positions of this call's key rows); q_offset and "
            "kv_valid are fine")
    check_window(causal, window, sinks, segmented)


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
    grad_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of flash attention from the saved forward.

    q (..., h, m, d), k (..., hkv, n, d), v (..., hkv, n, dv), out and
    dout (..., h, m, dv), lse (..., h, m) in the natural-log domain (-inf
    for a row that saw no key); 3-D or 4-D, hkv dividing h (GQA).
    ``scale``, ``causal``, ``softcap``, ``q_offset``/``kv_offset``,
    ``kv_valid``, ``window``, ``sinks`` and the segment ids must be the
    forward's.
    Gradients come back in the inputs' dtypes.  CUDA tensors run the
    fused Hopper kernel (or the dQ and dK/dV pair under
    `_FORCE_TWO_KERNEL`), float32 or bfloat16, head dims up to 256; CPU
    tensors run `flash_backward_plain`.  Under a ``window`` the kernels
    walk only its band, with a window-only mask, and ``sinks`` add the
    sink pairs outside the band by `sink_patch`, as the JAX backward
    does.  ``q_segment_ids`` (m,) and ``kv_segment_ids`` (n,) (3-D
    inputs) mask the pairs of different packed sequences in every
    kernel.  Its refusals are JAX's, as `ValueError`: a window without
    ``causal``, sinks without a window, sinks with ``kv_offset`` (their
    positions are absolute) or with segment ids, unpaired ids, ids with
    4-D inputs or of the wrong length.  ``block_sizes`` is not ported
    and raises `NotImplementedError`.  ``grad_dtype=torch.float32``
    returns the gradients in float32 without their last rounding where
    the kernels sum in float32 (the fused kernel's dQ; dK and dV, for
    which the wgmma body then cuts each GQA group into at least two
    slices, whose float32 partials the wrapper sums): the sharded
    backward paths add per-shard gradients and round the sum once."""
    q_ids, kv_ids = check_segments(q, k, q_segment_ids, kv_segment_ids)
    check_backward_band(causal, window, sinks, kv_offset,
                        q_ids is not None)
    _unsupported(block_sizes=block_sizes)
    check_softcap(softcap)
    offsets = _offsets(k.shape[-2], q_offset, kv_offset, kv_valid)
    band = dict(window=window, sinks=sinks)
    if q.device.type == "cpu":
        grads = flash_backward_plain(
            q, k, v, out, lse, dout, scale=scale, causal=causal,
            softcap=softcap, q_segment_ids=q_ids, kv_segment_ids=kv_ids,
            **offsets, **band)
        return tuple(t.to(grad_dtype or t.dtype) for t in grads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on cuda or cpu, not "
                         f"{q.device.type}")
    tensors, lead = _four_d(q, k, v, out, lse[..., None], dout)
    tensors[4] = tensors[4][..., 0]
    return tuple(t[lead] for t in _launch(
        *tensors, scale=scale, causal=causal, softcap=softcap, q_ids=q_ids,
        kv_ids=kv_ids, grad_dtype=grad_dtype, **offsets, **band))
