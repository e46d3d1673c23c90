"""Ragged paged attention: one kernel launch for a mixed decode/prefill
step — the port of `attention_tpu.ops.ragged_paged`.

Every real token of a serving step sits consecutively on one packed
axis of width ``T``: ``cu_q_lens`` (S+1,) delimits each request slot's
token span, ``kv_lens`` (S,) holds each slot's KV length and
``distribution`` (2,) = (num_decode, num_active) the decode/prefill
split (decode slots first).  Each slot reads KV through its own
page-table row, causal within the request.

`ragged_paged_append` writes the step's new K/V rows into the pools
(in place: the pools are the engine's, and a copy per layer per step
would double the cache traffic) with the JAX version's drop and sticky
``-1`` poison semantics, as a masked ``index_put_``.
`ragged_paged_attention` launches the Hopper
kernel ``csrc/ragged_paged.cu`` (which replaces the TPU kernel
`_ragged_kernel`) for CUDA tensors and runs
`ragged_paged_attention_plain` for CPU tensors.
"""

from __future__ import annotations

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
from attention_tpu_torch.ops.reference import (
    check_softcap,
    ragged_paged_reference,
)

KERNEL = "ragged_paged"
_ARGTYPES = [P] * 8 + [I] * 9 + [L] * 4 + [F, F, P]


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
                                 softcap: float | None = None
                                 ) -> torch.Tensor:
    """The plain PyTorch version of `ragged_paged_attention`."""
    _validate(q, cache)
    return ragged_paged_reference(
        q, cache.k_pool, cache.v_pool, cache.page_table, cache.kv_lens,
        cache.cu_q_lens, cache.distribution, scale=scale, softcap=softcap)


def _launch(q, cache, *, scale, softcap) -> torch.Tensor:
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
    hkv, page = cache.k_pool.shape[1], cache.k_pool.shape[2]
    dv = cache.v_pool.shape[-1]
    s_slots, max_pages = cache.page_table.shape
    if max(dk, dv) > MAX_HEAD_DIM:
        raise ValueError(f"head dims {dk}/{dv} exceed {MAX_HEAD_DIM}")
    if q.stride(-1) != 1:
        q = q.contiguous()
    # pad tokens and unwritten slots stay zero; (1, T, Hq, dv) storage
    # makes the attention layer's head merge a view
    out = torch.zeros((1, t_pad, hq, dv), dtype=dtype,
                      device=q.device).transpose(1, 2)
    fn = _native.function(KERNEL, "ragged_paged_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), cache.k_pool.data_ptr(),
                 cache.v_pool.data_ptr(), cache.page_table.data_ptr(),
                 cache.kv_lens.data_ptr(), cache.cu_q_lens.data_ptr(),
                 cache.distribution.data_ptr(), out.data_ptr(),
                 DTYPE_CODES[dtype], hq, hkv, s_slots, max_pages, page, dk, dv,
                 int(cache.q_tile), q.stride(1), q.stride(2), out.stride(1),
                 out.stride(2), float(scale), float(softcap or 0.0),
                 stream)
    _native.check(KERNEL, err)
    _native.count_launch(KERNEL)
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
    slots NaN.  CUDA tensors run the Hopper kernel, CPU tensors
    `ragged_paged_attention_plain`."""
    if window is not None or sinks is not None:
        raise NotImplementedError(
            "ragged_paged_attention window/sinks are not ported yet")
    if max_mode != "online":
        raise NotImplementedError(
            f"max_mode={max_mode!r} is not ported yet; only 'online'")
    check_softcap(softcap)
    _validate(q, cache)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, cache, scale=scale,
                                            softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu, "
                         f"not {q.device.type}")
    return _launch(q, cache, scale=scale, softcap=softcap)


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
