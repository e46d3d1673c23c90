"""The dQ and dK/dV pair's plans, bindings and arithmetic, on the CPU.

`dq_work_item` mirrors the dQ wgmma body's deal of work items (the flash
forward's `FlashSched::item` with one split): every (batch, q head,
128-row block) once, heaviest first.  The body walks the flash forward's
key tiles, `ops.flash.tile_plan`: every kept pair of an item lies in its
tiles, the tiles below ``mask`` keep every pair (under
`reference.attention_mask`), and a plan moved by one tile is caught.
The dK/dV kernel's plan is the fused kernel's, the pair's body is named
as the fused one's, and the C entry points' argument types are read
from their sources.  `dq_by_items`, the dQ body's arithmetic item by
item (P against the staged lse2, masks only from ``mask`` on, dS rounded,
dQ summed a tile at a time), is held against the JAX package's
`_dq_kernel` in Pallas interpret mode: float32 within 1e-5 (the same
arithmetic in another order), bfloat16 within `reference.grad_mismatch`.
"""

import ctypes
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.ops import flash_bwd as jax_bwd
from attention_tpu.ops.flash_vjp import _flash_fwd_impl as jax_fwd_impl
from attention_tpu_torch.ops import _native, flash_bwd
from attention_tpu_torch.ops.flash import KEY_TILE, tile_plan
from attention_tpu_torch.ops.flash_bwd import (
    DKV,
    DQ,
    DQ_ROWS,
    FUSED,
    LOG2E,
    _delta,
    _four_d,
    _lse2,
    _round,
    _scaled_q,
)
from attention_tpu_torch.ops.reference import attention_mask, grad_mismatch

F32_TOL = 1e-5


# ------------------------------------------------- the dQ body in PyTorch


def dq_work_item(w: int, batch: int, heads: int, m: int,
                 causal: bool) -> tuple[int, int, int]:
    """(batch, q head, first row) of the dQ wgmma body's work item ``w``:
    the flash forward's schedule with one split (`FlashSched::item` in
    csrc/flash_fwd_sm90.cuh), the row block varying slowest, under causal
    masking from the last (the heaviest) down, then batch and head."""
    blocks = -(-m // DQ_ROWS)
    mi, bh = divmod(w, batch * heads)
    b, h = divmod(bh, heads)
    return b, h, (blocks - 1 - mi if causal else mi) * DQ_ROWS


def dq_by_items(q, k, v, out, lse, dout, *, scale, causal=False,
                softcap=None, q_offset=0, kv_offset=0, kv_valid=None):
    """dQ as the dQ wgmma body computes it: each work item
    (`dq_work_item`) walks its key tiles (`tile_plan`), takes P =
    exp2(S - lse2) against the staged lse2 (+inf for a row that saw no
    key), masks only the tiles from ``mask`` on, forms dS = (P·(1 -
    tanh²))·(dP - delta) in the kernel's order, rounds dS to the input
    dtype and sums dS·K over the tiles in fp32; dQ·scale in the input
    dtype.  Same inputs and keywords as `flash_backward`; slow (a loop
    per tile)."""
    (q4, k4, v4, o4, l4, do4), lead = _four_d(q, k, v, out, lse[..., None],
                                              dout)
    dtype = q4.dtype
    b, h, m, d = q4.shape
    hkv, n = k4.shape[1:3]
    valid = n if kv_valid is None else kv_valid
    qs = _scaled_q(q4, scale).float()
    do = do4.to(dtype).float()
    kf, vf = k4.float(), v4.float()
    lse2, delta = _lse2(l4[..., 0], m), _delta(do4, o4)
    cap2 = softcap * LOG2E if softcap else None
    dq = torch.zeros((b, h, m, d), dtype=torch.float32)
    for w in range(b * h * -(-m // DQ_ROWS)):
        bi, hi, m0 = dq_work_item(w, b, h, m, causal)
        begin, end, mask = tile_plan(m0, m, valid, causal, q_offset,
                                     kv_offset)[:3]
        rows = slice(m0, min(m0 + DQ_ROWS, m))
        row = torch.arange(rows.start, rows.stop)
        lim = (torch.clamp(row + q_offset - kv_offset + 1, max=valid)
               if causal else torch.full_like(row, valid))
        hk = hi // (h // hkv)
        for t in range(begin, end):
            keys = slice(t * KEY_TILE, min((t + 1) * KEY_TILE, n))
            s = qs[bi, hi, rows] @ kf[bi, hk, keys].T
            dcap = None
            if cap2 is not None:
                th = torch.tanh(s / cap2)
                s, dcap = cap2 * th, 1.0 - th * th
            p = torch.exp2(s - lse2[bi, hi, rows, None])
            if t >= mask:
                col = torch.arange(keys.start, keys.stop)
                p = torch.where(col[None, :] < lim[:, None], p, 0.0)
            if dcap is not None:
                p = p * dcap
            ds = p * (do[bi, hi, rows] @ vf[bi, hk, keys].T
                      - delta[bi, hi, rows, None])
            dq[bi, hi, rows] += _round(ds, dtype) @ kf[bi, hk, keys]
    return (dq * scale).to(dtype)[lead]


# ------------------------------------------------------------ work items


@pytest.mark.parametrize("batch,heads,m", [(1, 32, 4096), (2, 3, 300),
                                           (3, 1, 1), (1, 2, 129)])
@pytest.mark.parametrize("causal", [False, True])
def test_dq_items_cover_every_row_block_once_heaviest_first(batch, heads, m,
                                                            causal):
    """Every (batch, head, row block) in exactly one item; under causal
    masking the items' key tiles never grow along the deal (the last row
    block first), and without it every item sees the same tiles."""
    blocks = -(-m // DQ_ROWS)
    items = [dq_work_item(w, batch, heads, m, causal)
             for w in range(batch * heads * blocks)]
    assert sorted(items) == [(b, h, i * DQ_ROWS) for b in range(batch)
                             for h in range(heads) for i in range(blocks)]
    tiles = [tile_plan(m0, m, m, causal, 0, 0)[1] for _, _, m0 in items]
    if causal:
        assert tiles == sorted(tiles, reverse=True)
        assert items[0][2] == (blocks - 1) * DQ_ROWS
    else:
        assert len(set(tiles)) == 1


# ------------------------------------------------------------ key tiles


def _plan_holds(plan, block, width) -> bool:
    """``block`` (an item's real rows x keys, padded with masked keys to
    whole tiles) against a plan: no kept pair past tile ``end``, every
    pair of the tiles below ``mask`` kept."""
    _, end, mask = plan
    return (not block[:, end * width:].any()
            and bool(block[:, :mask * width].all()))


@pytest.mark.parametrize("m", [1, 100, 300])
@pytest.mark.parametrize("kv_offset", [0, 11])
@pytest.mark.parametrize("q_offset", [-150, -37, 0, 5, 127])
@pytest.mark.parametrize("causal", [False, True])
def test_dq_tile_plan_masks_every_tile_that_needs_it(causal, q_offset,
                                                     kv_offset, m):
    """Per item of m rows, over n of 129 and 400 keys and kv_valid from 0
    to n (rows that see no key where q_offset is negative): the plan
    holds, begins at tile 0, and one moved a tile (the mask a tile later,
    the end a tile earlier) fails."""
    for n in (129, 400):
        for kv_valid in (0, 1, 128, n - 1, n):
            keep = attention_mask(m, n, causal=causal, q_offset=q_offset,
                                  kv_offset=kv_offset, kv_valid=kv_valid)
            tiles = -(-n // KEY_TILE)
            keep = torch.cat(
                [keep, keep.new_zeros(m, tiles * KEY_TILE - n)], 1)
            for m0 in range(0, m, DQ_ROWS):
                block = keep[m0:m0 + DQ_ROWS]
                plan = tile_plan(m0, m, kv_valid, causal, q_offset,
                                 kv_offset)[:3]
                begin, end, mask = plan
                assert begin == 0 and end <= tiles and mask >= 0
                assert _plan_holds(plan, block, KEY_TILE), (m, n, m0)
                if mask < end:
                    assert not _plan_holds((0, end, mask + 1), block,
                                           KEY_TILE)
                if end > 0:
                    assert not _plan_holds((0, end - 1, min(mask, end - 1)),
                                           block, KEY_TILE)


def test_dq_tile_plan_of_a_causal_diagonal():
    """Aligned causal items over 4096 rows: item i walks 128-key tiles
    0..i, the diagonal one masked; kv_valid 0 gives no tiles."""
    assert KEY_TILE == DQ_ROWS == 128
    for i in (0, 1, 31):
        assert tile_plan(i * 128, 4096, 4096, True, 0, 0)[:3] == (
            0, i + 1, i)
    assert tile_plan(0, 300, 0, False, 0, 0)[:2] == (0, 0)


# ------------------------------------------------------ plans and routes


def _staged(monkeypatch, dtype=torch.bfloat16, d=128, b=1, h=8, hkv=2,
            m=100, n=300, causal=True, offset=0):
    """A `_Staged` of a CPU call, with the card's SM count stood in;
    ``offset`` > 0 makes every operand a view that many elements into
    rows of d + offset."""
    monkeypatch.setattr(_native, "sm_count", lambda index: 132)
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        x = torch.randn((*shape[:-1], shape[-1] + offset), generator=gen)
        return x.to(dtype)[..., offset:]

    q, do, o = rand(b, h, m, d), rand(b, h, m, d), rand(b, h, m, d)
    k, v = rand(b, hkv, n, d), rand(b, hkv, n, d)
    lse = torch.randn((b, h, m), generator=gen)
    return flash_bwd._Staged(q, k, v, o, lse, do, scale=d ** -0.5,
                             causal=causal, softcap=None, q_offset=0,
                             kv_offset=0, kv_valid=n)


@pytest.mark.parametrize("b,h,hkv,m,n", [
    (1, 32, 4, 4096, 4096), (4, 32, 4, 2048, 2048), (2, 8, 2, 1000, 1003)],
    ids=["serving", "train_layer", "edge"])
def test_dkv_plan_is_the_fused_plan(monkeypatch, b, h, hkv, m, n):
    """The dK/dV kernel's slices, items and grid are the fused kernel's
    work plan (meta tensors: no data); the dQ kernel's items are the
    (batch, head, 128-row block)s, at most one CTA an SM."""
    monkeypatch.setattr(_native, "sm_count", lambda index: 132)
    meta = dict(device="meta", dtype=torch.bfloat16)
    staged = flash_bwd._Staged(
        torch.empty(b, h, m, 128, **meta), torch.empty(b, hkv, n, 128, **meta),
        torch.empty(b, hkv, n, 128, **meta), torch.empty(b, h, m, 128, **meta),
        torch.empty(b, h, m, device="meta"), torch.empty(b, h, m, 128, **meta),
        scale=0.1, causal=True, softcap=None, q_offset=0, kv_offset=0,
        kv_valid=n)
    fused, pair = staged.plan, staged.pair_plan
    assert fused["body"] == pair["body"] == "wgmma"
    assert (pair["slices"], pair["dkv_items"], pair["dkv_grid"]) == (
        fused["slices"], fused["items"], fused["grid"])
    items = b * h * -(-m // DQ_ROWS)
    assert (pair["dq_items"], pair["dq_grid"]) == (items, min(items, 132))
    assert staged.ls % DQ_ROWS == 0 and staged.ls >= m


@pytest.mark.parametrize("dtype,d,offset,body", [
    (torch.bfloat16, 128, 0, "wgmma"), (torch.bfloat16, 64, 0, "wgmma"),
    (torch.float32, 128, 0, "fma"), (torch.bfloat16, 32, 0, "fma"),
    (torch.bfloat16, 64, 1, "fma")],
    ids=["bf16_d128", "bf16_d64", "f32", "d32", "misaligned"])
def test_pair_body_routes_as_the_fused_body(monkeypatch, dtype, d, offset,
                                            body):
    """The pair runs the body the fused kernel runs: "wgmma" on bf16 at
    d 64 or 128 with aligned rows, "fma" on f32, other head dims and rows
    that are not 16-byte aligned (a view one element in)."""
    staged = _staged(monkeypatch, dtype=dtype, d=d, offset=offset)
    assert staged.plan["body"] == staged.pair_plan["body"] == body
    if body == "fma":
        assert staged.pair_plan == dict(body="fma", slices=1)


def test_pair_outputs_follow_the_plan(monkeypatch):
    """One slice: dK and dV in the input dtype, returned as written (no
    sum, no cast); more slices: fp32 partials summed in order, cast once;
    "fma": fp32 (b, hkv, n, d), cast once."""
    staged = _staged(monkeypatch, b=8, n=4096, causal=False)
    assert staged.pair_plan["slices"] == 1
    out = staged.pair_buffers()
    assert out["dq"].shape == (8, 8, 100, 128)
    assert out["dk"].shape == (8, 2, 4096, 128)
    assert out["dk"].dtype == out["dq"].dtype == torch.bfloat16
    dq, dk, dv = staged.pair_grads(**out)
    assert dq is out["dq"] and dk is out["dk"] and dv is out["dvo"]

    staged = _staged(monkeypatch)
    slices = staged.pair_plan["slices"]
    assert slices == 4
    out = staged.pair_buffers()
    assert out["dk"].shape == (1, 2, slices, 300, 128)
    out["dk"].normal_(generator=torch.Generator().manual_seed(1))
    out["dvo"].normal_(generator=torch.Generator().manual_seed(2))
    _, dk, dv = staged.pair_grads(**out)
    assert torch.equal(dk, out["dk"].sum(2).bfloat16())
    assert torch.equal(dv, out["dvo"].sum(2).bfloat16())

    staged = _staged(monkeypatch, dtype=torch.float32)
    out = staged.pair_buffers()
    assert out["dk"].shape == (1, 2, 300, 128)
    assert out["dk"].dtype == torch.float32


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_int64,
           "float": ctypes.c_float}


@pytest.mark.parametrize("kernel", [FUSED, DQ, DKV])
def test_argtypes_match_the_c_entry_points(kernel):
    """Each kernel's ctypes argument types are its C entry point's
    parameters, read from the source: a pointer passed as an int, or an
    argument missing, would launch on garbage."""
    path = os.path.join(_native.CSRC, _native.KERNELS[kernel])
    with open(path) as f:
        src = f.read()
    params = re.search(r'extern "C" int ' + kernel + r"\((.*?)\)\s*\{",
                       src, re.S).group(1)
    want = []
    for param in params.split(","):
        ctype = " ".join(param.split()[:-1]).replace(" *", "*")
        want.append(_CTYPES[ctype])
    assert flash_bwd.ARGTYPES[kernel] == want


# ------------------------------------------------- the dQ body's arithmetic


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (q, k, v) shapes and keywords: several items and key tiles, causal with
# offsets (rows that see no key), kv_valid inside a tile and softcap; a
# non-causal GQA call with n not a multiple of the tile; causal on whole
# items and tiles (the diagonal tile the only masked one); more keys than
# rows, kv_valid past a tile's end, under softcap
CASES = {
    "causal_offsets_softcap": (((2, 300, 16), (1, 260, 16), (1, 260, 16)),
                               dict(causal=True, q_offset=-20, kv_offset=8,
                                    kv_valid=230, softcap=5.0)),
    "noncausal_gqa": (((4, 150, 8), (2, 200, 8), (2, 200, 8)), {}),
    "causal_aligned": (((2, 256, 16), (1, 256, 16), (1, 256, 16)),
                       dict(causal=True)),
    "kv_valid_softcap": (((3, 130, 8), (3, 300, 8), (3, 300, 8)),
                         dict(kv_valid=257, softcap=20.0)),
}


@functools.cache
def _jax_case(name, dtype):
    shapes, kw = CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = (_rand(rng, *s) for s in shapes)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    out, lse = jax_fwd_impl(jq, jk, jv, scale, kw.get("causal", False), None,
                            softcap=kw.get("softcap"),
                            q_off=kw.get("q_offset"),
                            kv_off=kw.get("kv_offset"),
                            kv_val=kw.get("kv_valid"))
    dout = jnp.asarray(_rand(rng, *out.shape), jdt)
    arrays = (jq, jk, jv, out, lse, dout)
    old = jax_bwd._FORCE_TWO_KERNEL
    jax_bwd._FORCE_TWO_KERNEL = True
    try:
        dq = jax_bwd.flash_backward(*arrays, scale=scale, interpret=True,
                                    **kw)[0]
    finally:
        jax_bwd._FORCE_TWO_KERNEL = old
    return arrays, scale, kw, dq


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dq_items_match_jax_dq_kernel(name, dtype):
    """The dQ body's items in PyTorch against JAX's `_dq_kernel`
    (interpret mode, the two-kernel path) on the same out, lse and dout."""
    arrays, scale, kw, want = _jax_case(name, dtype)
    got = dq_by_items(*(_torch(x, dtype) for x in arrays[:4]),
                      _torch(arrays[4]), _torch(arrays[5], dtype),
                      scale=scale, **kw)
    want = _torch(want, dtype)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype is torch.float32:
        assert (got - want).abs().max().item() <= F32_TOL
    else:
        assert grad_mismatch(got, want)[1] <= 1
