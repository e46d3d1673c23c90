"""Ragged paged attention: one kernel call for a mixed decode/prefill
step — the port of `attention_tpu.ops.ragged_paged`.

Every real token of a serving step sits consecutively on one packed
axis of width ``T``: ``cu_q_lens`` (S+1,) delimits each request slot's
token span, ``kv_lens`` (S,) holds each slot's KV length and
``distribution`` (2,) = (num_decode, num_active) the decode/prefill
split (decode slots first).  Each slot reads KV through its own
page-table row, causal within the request, and under a sliding
``window`` only the last ``window`` positions plus the first ``sinks``.

`ragged_paged_append` writes the step's new K/V rows into the pools
(in place: the pools are the engine's, and a copy per layer per step
would double the cache traffic) with the JAX version's drop and sticky
``-1`` poison rules, as a masked ``index_put_``.
`ragged_paged_attention` runs the Hopper kernel ``csrc/ragged_paged.cu``
(which replaces the TPU kernel `_ragged_kernel`) for CUDA tensors and
`ragged_paged_attention_plain` for CPU tensors.

On the card the kernel tells the slots apart itself, from their spans:
a slot of at most ``DECODE_ROWS // group`` tokens (a decode slot) splits
its keys across CTAs as the decode kernels do (`decode.split_plan`, the
partials merged in split order), any longer one (a prefill slot) runs
the body `ragged_body` names.  `ragged_launch_plan` gives a call's
launches from what the host knows, never the lengths or spans; the
CTAs' work is mirrored in PyTorch by `split_partials` (the decode
slots' partials, merged by `decode.merge_splits`) and `prefill_items`
(the wgmma body's work items), which the tests hold against the JAX
package and against brute-force masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from attention_tpu_torch.ops import _native, decode
from attention_tpu_torch.ops._native import (
    DTYPE_CODES,
    MAX_HEAD_DIM,
    F,
    I,
    L,
    P,
)
from attention_tpu_torch.ops.decode import check_band
from attention_tpu_torch.ops.flash import plan_tiles
from attention_tpu_torch.ops.reference import (
    check_softcap,
    ragged_paged_reference,
)

KERNEL = "ragged_paged"
_ARGTYPES = [P] * 9 + [I] * 11 + [L] * 4 + [F, F] + [I] * 8 + [P]
#: query rows of a decode slot's CTA (the four warps' one 16-row tile): a
#: slot of at most DECODE_ROWS // group tokens is a decode slot
DECODE_ROWS = 16
#: query rows of a work item of the wgmma body, and keys of its tiles
ROW_BLOCK = 128
KEY_TILE = 128
#: the C entry's body codes
BODIES = {"fma": 0, "mma": 1, "wgmma": 2}
#: CTAs per SM the decode slots' key split aims at (`decode.split_plan`).
#: The grid covers every slot, decode or not (10 at the served engine's
#: 8 + 2), and 6 cut its splits to 2 key tiles where 4, the dense and
#: paged kernels' aim, cut them to 3: measured fastest of 2, 4, 6 and 8
#: on an H100 (PERF.md section 6)
CTAS_PER_SM = 6


class RaggedPagedStep(NamedTuple):
    """One packed engine step over the shared page pool.

    ``k_pool``/``v_pool``: (P, Hkv, page_size, d).  ``page_table``:
    (S, max_pages) int32, one row per request slot (inactive slots all
    -1).  ``kv_lens``: (S,) int32 valid cache tokens per slot —
    pre-append when handed to `ragged_paged_append`, post-append after
    it (-1 = poisoned).  ``cu_q_lens``: (S+1,) int32 cumulative token
    spans.  ``distribution``: (2,) int32 (num_decode_slots,
    num_active_slots).  ``token_pos``: (T,) int32 absolute cache
    position of each packed token (drives RoPE and the append).
    ``token_slot``: (T,) int32 owning slot per token, -1 for pad tokens.
    ``q_tile``: the span length the kernel's grid is sized for
    (``q_tile * group`` rows per slot in parallel); the engine makes it
    cover the step's longest span, and a longer one is still computed
    in full, only with less parallelism."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    page_table: torch.Tensor
    kv_lens: torch.Tensor
    cu_q_lens: torch.Tensor
    distribution: torch.Tensor
    token_pos: torch.Tensor
    token_slot: torch.Tensor
    q_tile: int

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[2]


def packed_bucket(n_tokens: int, *, minimum: int = 8) -> int:
    """Packed-axis width for ``n_tokens`` real tokens: the next power
    of two, refined down to the 3·2^k midpoint (8, 16, 24, 32, 48, 64,
    96, ...) when that still covers ``n_tokens`` and stays 8-aligned.
    Idempotent; the same widths as the JAX package, so pad accounting
    agrees."""
    if n_tokens < 0:
        raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
    w = max(minimum, 1)
    while w < n_tokens:
        w *= 2
    mid = 3 * w // 4
    if w >= 4 and mid >= n_tokens and mid >= max(minimum, 1) \
            and mid % 8 == 0:
        w = mid
    return w


def tile_tokens(max_q_len: int, group: int) -> int:
    """Smallest query tile (in tokens) covering ``max_q_len`` whose row
    count ``tile * group`` is a multiple of 8."""
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    t = max(int(max_q_len), 1)
    while (t * group) % 8:
        t += 1
    return t


def recommended_q_tile(max_q_len: int, group: int) -> int:
    """Query-tile width (tokens) for a step whose longest span is
    ``max_q_len``: bucketed like `packed_bucket`, 8-row aligned."""
    return tile_tokens(packed_bucket(max_q_len, minimum=1), group)


def _validate(q: torch.Tensor, cache: RaggedPagedStep) -> None:
    if q.dim() != 4 or q.shape[0] != 1:
        raise ValueError(f"packed q must be (1, Hq, T, d), got "
                         f"{tuple(q.shape)}")
    h, d = q.shape[1], q.shape[3]
    p_, hkv, page, dk = cache.k_pool.shape
    s_slots = cache.page_table.shape[0]
    if dk != d or tuple(cache.v_pool.shape[:3]) != (p_, hkv, page):
        raise ValueError(
            f"ragged cache shapes inconsistent: Q{tuple(q.shape)} "
            f"K{tuple(cache.k_pool.shape)} V{tuple(cache.v_pool.shape)}")
    if tuple(cache.cu_q_lens.shape) != (s_slots + 1,):
        raise ValueError(
            f"cu_q_lens {tuple(cache.cu_q_lens.shape)} must be "
            f"({s_slots + 1},) for a {s_slots}-slot table")
    if h % hkv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")


def ragged_paged_attention_plain(q: torch.Tensor, cache: RaggedPagedStep,
                                 *, scale: float | None = None,
                                 softcap: float | None = None,
                                 window: int | None = None,
                                 sinks: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of `ragged_paged_attention`."""
    _validate(q, cache)
    check_band(window, sinks)
    return ragged_paged_reference(
        q, cache.k_pool, cache.v_pool, cache.page_table, cache.kv_lens,
        cache.cu_q_lens, cache.distribution, scale=scale, softcap=softcap,
        window=window, sinks=sinks)


def decode_tokens(group: int) -> int:
    """The most tokens of a decode slot at GQA group ``group``: its rows,
    tokens x group, fit one `DECODE_ROWS`-row tile (0: no slot is one)."""
    return DECODE_ROWS // group


def ragged_body(dtype, dk: int, dv: int, group: int, page: int, strides,
                ptrs, variant: str = "online") -> str:
    """The body the prefill slots of a call run: "wgmma" for bfloat16 at
    head dims 64 or 128 whose (head, token) ``strides`` (in elements, of
    q and the output) are positive multiples of 8, whose base pointers
    ``ptrs`` (q and the pools; the wrapper allocates the output aligned)
    are 16-byte aligned, whose GQA ``group``
    divides 128 and whose ``page`` the TMA boxes can take (a multiple of
    128 rows, or 8 to 64 rows dividing 128); "mma" (`mma.sync`, 64-row
    blocks) for the other bfloat16 calls at head dims 64/128 with such
    strides and pointers; "fma" (fp32 FMA on the CUDA cores) for the
    rest.  The decode slots run the tensor-core split (four warps on one
    16-row tile) wherever this is not "fma".  The ``variant``s other than
    "online" ("flashd", "amla") have tensor-core instances at dk == dv
    only, and run "fma" elsewhere."""
    if (dtype != torch.bfloat16 or dk not in (64, 128) or dv not in (64, 128)
            or not all(x > 0 and x % 8 == 0 for x in strides)
            or not all(p % 16 == 0 for p in ptrs)
            or (variant != "online" and dk != dv)):
        return "fma"
    if ROW_BLOCK % group == 0 and (
            page % KEY_TILE == 0 or (page >= 8 and KEY_TILE % page == 0)):
        return "wgmma"
    return "mma"


def ragged_launch_plan(q: torch.Tensor, step: "RaggedPagedStep", *,
                       sms: int, window: int | None = None,
                       variant: str = "online") -> dict:
    """The launches of a `ragged_paged_attention` call on the card, from
    sizes the host knows (slots, heads, widths, the table's capacity,
    the page, the head dims, ``sms``), never the lengths or spans:

    ``body`` of the prefill slots (`ragged_body` under ``variant``);
    ``smax``, the most
    tokens of a decode slot; the decode slots' key split (``splits``,
    ``chunk``: `decode.split_plan` over the capacity ``max_pages *
    page``, or under a ``window`` its band, at `CTAS_PER_SM`), its key
    groups ``kg`` and ``decode_grid``
    (row blocks, slots x kv heads, splits; none when ``smax`` is 0);
    ``prefill_grid`` (the
    wgmma body's persistent grid, at most one CTA an SM over the most
    work items the width allows, or the other bodies' (row blocks of
    ``q_tile``, slots x kv heads)); ``finish_grid`` (tokens, heads in
    eights: a warp a token's head)."""
    _, hq, t_pad, dk = q.shape
    hkv, page = step.k_pool.shape[1], step.k_pool.shape[2]
    dv = step.v_pool.shape[-1]
    slots, max_pages = step.page_table.shape
    group = hq // hkv
    smax = decode_tokens(group)
    out_strides = (dv, hq * dv)  # the wrapper's (1, T, Hq, dv) storage
    body = ragged_body(q.dtype, dk, dv, group, page,
                       (q.stride(1), q.stride(2), *out_strides),
                       (q.data_ptr(), step.k_pool.data_ptr(),
                        step.v_pool.data_ptr()), variant)
    plan = dict(body=body, smax=smax, splits=1,
                chunk=max_pages * page, kg=1, decode_grid=None)
    if smax:
        splits, chunk = decode.split_plan(
            slots, hkv, smax * group, max_pages * page, smax, window,
            sms=sms, ctas_per_sm=CTAS_PER_SM)
        plan.update(splits=splits, chunk=chunk,
                    kg=1 if body == "fma" else 4,
                    decode_grid=[1, slots * hkv, splits])
    if body == "wgmma":
        items = hkv * (-(-t_pad * group // ROW_BLOCK) + slots)
        plan["prefill_grid"] = [min(sms, items)]
    else:
        plan["prefill_grid"] = [-(-int(step.q_tile) * group // 64),
                                slots * hkv]
    plan["finish_grid"] = [t_pad, -(-hq // 8)]
    return plan


def _dense(pool, table_row, kv_len):
    """(Hkv, rows, d): a slot's pages gathered in order, a -1 entry as
    page 0 (as the kernels read it), cut to ``kv_len`` rows."""
    pages = table_row.long().clamp(min=0)
    hkv, d = pool.shape[1], pool.shape[-1]
    return pool[pages].transpose(0, 1).reshape(hkv, -1, d)[:, :kv_len]


def split_partials(q, step: "RaggedPagedStep", *, scale, softcap=None,
                   window=None, sinks=None, splits: int, chunk: int):
    """The decode slots' per-split partials, as the kernel's split CTAs
    write them: float32 (unnormalized output (1, Hq, T, splits, dv), row
    max in natural log and row sum (1, Hq, T, splits)), split i owning
    cache rows [i·chunk, (i+1)·chunk) and the last split the rest
    (`decode.split_owner`).  Tokens of no decode slot get max -inf and
    sum 0 (zero rows once merged); a poisoned decode slot NaN sums (NaN
    rows, as the kernel's merge writes them).  `decode.merge_splits`
    merges them into the decode slots' rows."""
    _, hq, t_pad, _ = q.shape
    hkv, dv = step.k_pool.shape[1], step.v_pool.shape[-1]
    smax = decode_tokens(hq // hkv)
    acc = torch.zeros((1, hq, t_pad, splits, dv), dtype=torch.float32,
                      device=q.device)
    m = torch.full((1, hq, t_pad, splits), float("-inf"),
                   dtype=torch.float32, device=q.device)
    l_ = torch.zeros_like(m)
    cu, lens = step.cu_q_lens.tolist(), step.kv_lens.tolist()
    for s in range(min(int(step.distribution[1]), len(lens))):
        lo, hi = cu[s], cu[s + 1]
        if not 1 <= hi - lo <= smax:
            continue
        if lens[s] < 0:
            m[..., lo:hi, :] = 0.0
            l_[..., lo:hi, :] = float("nan")
            continue
        n = step.page_table.shape[1] * step.page_size
        keys = _dense(step.k_pool, step.page_table[s], n)[None]
        vals = _dense(step.v_pool, step.page_table[s], n)[None]
        part = decode.split_partials(
            q[:, :, lo:hi], keys, vals,
            torch.tensor([lens[s]], device=q.device), scale=scale,
            softcap=softcap, window=window, sinks=sinks, splits=splits,
            chunk=chunk)
        acc[..., lo:hi, :, :], m[..., lo:hi, :], l_[..., lo:hi, :] = part
    return acc, m, l_


def prefill_items(step: "RaggedPagedStep", group: int,
                  window: int | None = None,
                  sinks: int | None = None) -> list[dict]:
    """The wgmma body's work items on this step's data, in the kernel's
    order (`RaggedSched` in csrc/ragged_paged.cu): for each live slot of
    more than `decode_tokens` tokens, its q_len·group rows (row = token·
    group + head of the group) in 128-row blocks from the last, each
    for every kv head (fastest); each item's `flash.TilePlan` fields:
    its visits [0, ``end``) (tiles [0, ``end``) without a band),
    ``mask``, the first tile that can hold a key past a row's causal
    end, and under a ``window`` the sink tiles, the band's first tile
    ``base`` and ``mask_lo`` (the tiles in [mask_lo, mask) skip the
    test).  A poisoned slot's items have no tiles (their rows are
    written NaN)."""
    hkv = step.k_pool.shape[1]
    n_cap = step.page_table.shape[1] * step.page_size
    smax = decode_tokens(group)
    cu, lens = step.cu_q_lens.tolist(), step.kv_lens.tolist()
    items = []
    for s in range(max(min(int(step.distribution[1]), len(lens)), 0)):
        q_len, raw = cu[s + 1] - cu[s], lens[s]
        if q_len <= smax:
            continue
        rows = q_len * group
        length = min(raw, n_cap)
        for blk in reversed(range(-(-rows // ROW_BLOCK))):
            m0 = blk * ROW_BLOCK
            t_lo = m0 // group
            t_hi = (min(m0 + ROW_BLOCK, rows) - 1) // group
            p_lo, p_hi = raw - q_len + t_lo, raw - q_len + t_hi
            n_end = 0 if raw < 0 else max(0, min(length, p_hi + 1))
            mask = max(0, min(length // KEY_TILE, (p_lo + 1) // KEY_TILE))
            band = window is not None
            plan = plan_tiles(
                n_end, mask, max(0, p_lo - window + 1) if band else 0,
                max(0, p_hi - window + 1) if band else 0,
                (sinks or 0) if band else 0)
            items += [dict(slot=s, kv_head=h, m0=m0, **plan._asdict())
                      for h in range(hkv)]
    return items


def _launch(q, cache, *, scale, softcap, window, sinks,
            variant="online") -> torch.Tensor:
    dtype = cache.v_pool.dtype
    if (dtype not in DTYPE_CODES or q.dtype != dtype
            or cache.k_pool.dtype != dtype):
        raise TypeError(
            f"ragged kernel takes float32 or bfloat16 q/pools of one "
            f"dtype, got {q.dtype}/{cache.k_pool.dtype}/{dtype}")
    ints = (cache.page_table, cache.kv_lens, cache.cu_q_lens,
            cache.distribution)
    tensors = (q, cache.k_pool, cache.v_pool, *ints)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, the pools and the step's index arrays must "
                         "be on one device")
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in ints):
        raise TypeError("page_table, kv_lens, cu_q_lens and distribution "
                        "must be contiguous int32")
    if not (cache.k_pool.is_contiguous() and cache.v_pool.is_contiguous()):
        raise ValueError("the K/V pools must be contiguous")
    _, hq, t_pad, dk = q.shape
    pages, hkv, page = cache.k_pool.shape[:3]
    dv = cache.v_pool.shape[-1]
    s_slots, max_pages = cache.page_table.shape
    if max(dk, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {dk}/{dv} exceed {MAX_HEAD_DIM}")
    if q.stride(-1) != 1:
        q = q.contiguous()
    idx = q.device.index
    plan = ragged_launch_plan(q, cache, sms=_native.sm_count(idx),
                              window=window, variant=variant)
    # (1, T, Hq, dv) storage makes the attention layer's head merge a
    # view; the kernel writes every row, pad rows as zeros
    out = torch.empty((1, t_pad, hq, dv), dtype=dtype,
                      device=q.device).transpose(1, 2)
    part = None
    if plan["splits"] > 1:
        part = torch.empty(s_slots * hq * plan["smax"] * plan["splits"]
                           * (dv + 2), dtype=torch.float32, device=q.device)
    fn = _native.function(KERNEL, "ragged_paged_fwd", _ARGTYPES)
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(idx).cuda_stream
        err = fn(q.data_ptr(), cache.k_pool.data_ptr(),
                 cache.v_pool.data_ptr(), cache.page_table.data_ptr(),
                 cache.kv_lens.data_ptr(), cache.cu_q_lens.data_ptr(),
                 cache.distribution.data_ptr(), out.data_ptr(),
                 0 if part is None else part.data_ptr(), DTYPE_CODES[dtype],
                 hq, hkv, s_slots, t_pad, pages, max_pages, page, dk, dv,
                 int(cache.q_tile), q.stride(1), q.stride(2), out.stride(1),
                 out.stride(2), float(scale), float(softcap or 0.0),
                 window or 0, sinks or 0,
                 BODIES[plan["body"]], plan["smax"], plan["splits"],
                 plan["chunk"], plan["prefill_grid"][0],
                 decode.VARIANT_CODES[variant], stream)
    _native.check(KERNEL, err)
    _native.count_launch(KERNEL, variant)
    return out


def ragged_paged_attention(q: torch.Tensor, cache: RaggedPagedStep, *,
                           scale: float | None = None,
                           softcap: float | None = None,
                           window: int | None = None,
                           sinks: int | None = None,
                           max_mode: str = "online") -> torch.Tensor:
    """softmax(q Kᵀ · scale) V for every packed token of ``q``
    (1, Hq, T, d) through its slot's page table, causal within each
    request — (1, Hq, T, dv).  ``kv_lens`` must be post-append (run
    `ragged_paged_append` first); pad tokens return zeros, poisoned
    slots NaN.  ``window``/``sinks``: the decode kernels' per-request
    band (a token at position p keeps the positions after p - window
    and the first ``sinks``), which the kernel's walks start at.
    ``max_mode`` as `ops.decode.flash_decode`: "online", "flashd" or
    "amla" (the same output, one plain version), "bound" `ValueError`
    (forward-only), "auto" `NotImplementedError`.  CUDA tensors run the
    Hopper kernel, CPU tensors `ragged_paged_attention_plain`."""
    check_band(window, sinks)
    decode.check_max_mode(max_mode, decode.DECODE_MAX_MODES)
    check_softcap(softcap)
    _validate(q, cache)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, cache, scale=scale,
                                            softcap=softcap, window=window,
                                            sinks=sinks)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu, "
                         f"not {q.device.type}")
    return _launch(q, cache, scale=scale, softcap=softcap, window=window,
                   sinks=sinks, variant=max_mode)


def ragged_paged_append(cache: RaggedPagedStep, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> RaggedPagedStep:
    """Write every packed token's K/V row (k/v (1, Hkv, T, d)) at its
    slot's next positions, in place in the pools; returns the step with
    post-append lengths.

    The JAX version's poison contract: a token targeting an unclaimed
    (-1) table entry or past the table's capacity writes nothing and
    marks its whole slot's length -1 (sticky; the attention then emits
    NaN for that slot).  Pad tokens (slot -1) always drop, silently."""
    page = cache.page_size
    t = k_new.shape[2]
    if (k_new.dim() != 4 or v_new.dim() != 4
            or k_new.shape[:3] != v_new.shape[:3]
            or k_new.shape[0] != 1
            or t != cache.token_slot.shape[0]):
        raise ValueError(
            f"expected (1, Hkv, {cache.token_slot.shape[0]}, d) packed "
            f"rows: K{tuple(k_new.shape)} V{tuple(v_new.shape)}")
    s_slots, max_pages = cache.page_table.shape
    slot = cache.token_slot.long()
    pos = cache.token_pos.long()
    safe_slot = slot.clamp(min=0)
    logical = torch.div(pos, page, rounding_mode="floor")
    phys = cache.page_table[safe_slot,
                            logical.clamp(max=max_pages - 1)].long()
    bad = ((phys < 0) | (logical >= max_pages)
           | (cache.kv_lens[safe_slot] < 0))
    keep = ~(bad | (slot < 0))
    pages, rows = phys[keep], (pos % page)[keep]
    for pool, new in ((cache.k_pool, k_new), (cache.v_pool, v_new)):
        vals = new[0].transpose(0, 1).to(pool.dtype)    # (T, Hkv, d)
        pool[pages, :, rows] = vals[keep]
    # per-slot sticky poison: any bad real token condemns its slot (pad
    # tokens count into a spare last bin)
    hits = torch.zeros(s_slots + 1, dtype=torch.int32,
                       device=cache.kv_lens.device)
    hits.index_add_(0, torch.where(slot < 0, s_slots, slot),
                    bad.to(torch.int32))
    q_lens = cache.cu_q_lens[1:] - cache.cu_q_lens[:-1]
    new_lens = torch.where((hits[:s_slots] > 0) | (cache.kv_lens < 0),
                           torch.full_like(cache.kv_lens, -1),
                           cache.kv_lens + q_lens)
    return cache._replace(kv_lens=new_lens.to(torch.int32))
