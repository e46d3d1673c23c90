"""The flash kernel's plan, on the CPU: what the wgmma body computes on
the host and in each CTA before it touches a score.

`ops.flash.tile_plan` mirrors the kernel's tile range and mask start
(`tile_plan` in csrc/flash_fwd_sm90.cuh): the tiles a row block visits
must hold every key its rows see, and the tiles it runs without the
per-element mask test must hold no masked key, under the plain mask of
`reference.attention_mask`.  `flash_split_partials` is the kernel's key
split in PyTorch: its partials merged by `decode.merge_splits` (the
two-phase merge the kernel's `flash_merge` does) equal the unsplit plain
version in f32 within 1e-5 (`reference.F32_ATOL`; the merge adds the
splits in another order), the partials relative to max(1, |value|) as
the decode tests hold them, and JAX's `flash_attention` in Pallas
interpret mode on one edge case.  `flash_body` names the body a call
runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.ops.flash import flash_attention as jax_flash
from attention_tpu_torch.ops import decode
from attention_tpu_torch.ops.flash import (
    KEY_TILE,
    ROW_BLOCK,
    _strides,
    flash_attention_partials_plain,
    flash_attention_plain,
    flash_body,
    flash_split_partials,
    flash_split_plan,
    tile_plan,
)
from attention_tpu_torch.ops.reference import F32_ATOL, attention_mask

M, N = 300, 400  # three row blocks, four key tiles (the last one partial)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want: torch.Tensor, *, relative=False):
    assert torch.equal(got.isneginf(), want.isneginf())
    fin = want.isfinite()
    scale = want[fin].abs().clamp(min=1.0) if relative else 1.0
    assert ((got[fin] - want[fin]).abs() / scale <= F32_ATOL).all()


# ------------------------------------------------ tile range, mask start


@pytest.mark.parametrize("kv_valid", [0, 1, N - 1, N])
@pytest.mark.parametrize("kv_offset", [0, 11])
@pytest.mark.parametrize("q_offset", [-37, 0, 5, 126, N + 3])
@pytest.mark.parametrize("causal", [False, True])
def test_tile_plan_masks_every_tile_that_needs_it(causal, q_offset,
                                                  kv_offset, kv_valid):
    """Per row block: every key a row keeps lies in [begin, end), every
    tile below ``mask`` is kept whole by every row (the classic bug is to
    skip the test on a tile that needs it), the tile at ``mask`` is not
    (no tile is tested for nothing), and the splits of a plan cover the
    range once.  q_offset 126 puts the diagonal on a tile's last key."""
    keep = attention_mask(M, N, causal=causal, q_offset=q_offset,
                          kv_offset=kv_offset, kv_valid=kv_valid)
    # the keys past n that fill the last tile (TMA reads them as zeros)
    # are masked too
    tiles = -(-N // KEY_TILE)
    keep = torch.cat([keep, keep.new_zeros(M, tiles * KEY_TILE - N)], 1)
    for m0 in range(0, M, ROW_BLOCK):
        rows = keep[m0:m0 + ROW_BLOCK]
        begin, end, mask = tile_plan(m0, M, kv_valid, causal, q_offset,
                                     kv_offset)[:3]
        assert begin == 0 and 0 <= end <= tiles
        assert not rows[:, end * KEY_TILE:].any()
        for t in range(min(mask, end)):
            assert rows[:, t * KEY_TILE:(t + 1) * KEY_TILE].all()
        if mask < end:
            assert not rows[:, mask * KEY_TILE:(mask + 1) * KEY_TILE].all()
        seen = []
        for split in range(3):
            lo, hi, _ = tile_plan(m0, M, kv_valid, causal, q_offset,
                                  kv_offset, split, split_tiles=2)[:3]
            seen += range(lo, hi)
        assert seen == list(range(end))


def test_tile_plan_of_a_causal_diagonal():
    """Aligned causal blocks: block i visits tiles 0 .. i and masks the
    diagonal tile only; a cached prefill at offset 200 masks from the
    tile holding its first row's last key."""
    for i in range(3):
        assert tile_plan(i * ROW_BLOCK, 3 * ROW_BLOCK, 3 * ROW_BLOCK, True,
                         0, 0)[:3] == (0, i + 1, i)
    assert tile_plan(0, 300, 500, True, 200, 0)[:3] == (0, 3, 1)


# --------------------------------------------------------------- split


SPLIT_CASES = {
    "plain": dict(),
    "causal_gqa": dict(causal=True),
    "cached_prefill": dict(causal=True, q_offset=200, kv_valid=390,
                           softcap=20.0),
    "negative_offset": dict(causal=True, q_offset=-37, kv_offset=11),
    "kv_valid_1": dict(kv_valid=1),
    "kv_valid_0": dict(kv_valid=0),
}


def _split_case(name, rng):
    q = torch.from_numpy(_rand(rng, 1, 4, 200, 16))
    k, v = (torch.from_numpy(_rand(rng, 1, 2, 700, 16)) for _ in range(2))
    kw = SPLIT_CASES[name]
    splits, split_tiles = flash_split_plan(1, 4, 200,
                                           kw.get("kv_valid", 700), sms=132)
    return q, k, v, kw, splits, split_tiles


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_partials_merged_match_plain(name):
    q, k, v, kw, splits, split_tiles = _split_case(
        name, np.random.default_rng(5))
    acc, mx, sm = flash_split_partials(q, k, v, splits=splits,
                                       split_tiles=split_tiles, **kw)
    assert acc.shape == (1, 4, 200, splits, 16)
    assert mx.shape == sm.shape == (1, 4, 200, splits)
    _close(decode.merge_splits(acc, mx, sm, dtype=torch.float32),
           flash_attention_plain(q, k, v, **kw))
    for mine, plain in zip(decode.merge_splits(acc, mx, sm),
                           flash_attention_partials_plain(q, k, v, **kw)):
        _close(mine, plain, relative=True)


def test_split_partials_merged_match_jax():
    """The edge case: causal with an offset, ``kv_valid`` inside the last
    split's first tile, against JAX's Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(6)
    q, k, v = (_rand(rng, *s) for s in ((2, 4, 40, 16), (2, 2, 520, 16),
                                        (2, 2, 520, 16)))
    kw = dict(causal=True, q_offset=450, kv_valid=470)
    splits, split_tiles = flash_split_plan(2, 4, 40, 470, sms=132)
    assert (splits, split_tiles) == (4, 1)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), **kw)
    parts = flash_split_partials(*map(torch.from_numpy, (q, k, v)),
                                 splits=splits, split_tiles=split_tiles,
                                 **kw)
    _close(decode.merge_splits(*parts, dtype=torch.float32),
           torch.from_numpy(np.array(want, np.float32)))


def test_split_plan_sizes_the_grid():
    """Splits where the row blocks leave SMs idle, a whole number of key
    tiles each, at most one per tile and 16; none where the blocks fill
    the card (the 32-head serving forward, training's layer call)."""
    assert flash_split_plan(1, 1, 8192, 8192, sms=132) == (2, 32)
    assert flash_split_plan(1, 32, 4096, 4096, sms=132) == (1, 32)
    assert flash_split_plan(4, 32, 2048, 2048, sms=132) == (1, 16)
    assert flash_split_plan(8, 32, 512, 512, sms=132) == (1, 4)
    assert flash_split_plan(1, 1, 128, 8192, sms=132) == (16, 4)
    assert flash_split_plan(1, 2, 300, 0, sms=132) == (1, 1)


# ---------------------------------------------------------------- body


@pytest.mark.parametrize("dk,dv", [(64, 64), (64, 128), (128, 64),
                                   (128, 128)])
def test_flash_body_takes_bf16_64_128_pairs(dk, dv):
    q = torch.zeros(2, 4, 100, dk, dtype=torch.bfloat16)
    v = torch.zeros(2, 4, 100, dv, dtype=torch.bfloat16)
    strides = [*_strides(q), *_strides(q), *_strides(v), 100 * 4 * dv, dv,
               4 * dv]
    assert flash_body(torch.bfloat16, dk, dv, strides, [0, 16, 4096]) \
        == "wgmma"


@pytest.mark.parametrize("case", ["f32", "d96", "odd_stride",
                                  "misaligned_base"])
def test_flash_body_leaves_the_rest_to_fma(case):
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    d = 96 if case == "d96" else 128
    strides = [4 * 100 * d, 100 * d, d] * 4
    if case == "odd_stride":
        strides[2] = d + 4  # rows 8 bytes apart from a 16-byte grid
    ptrs = [0, 16, 8 if case == "misaligned_base" else 32]
    assert flash_body(dtype, d, d, strides, ptrs) == "fma"


def test_strides_of_unit_dims_are_valid():
    """A 2-D input seen as (1, 1, m, d), and a one-row call: the dims of
    extent 1 get the contiguous stride, whatever view made them."""
    x = torch.zeros(37, 64, dtype=torch.bfloat16)
    assert _strides(x[None, None]) == [37 * 64, 37 * 64, 64]
    y = torch.zeros(3, 1, 2, 64)[:, :, :1].expand(3, 1, 1, 64)
    assert _strides(y) == [128, 64, 64]
