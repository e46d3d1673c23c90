"""The fused backward's plan and staging, on the CPU: what the wgmma body
and its wrapper compute before the kernel touches a score.

`ops.flash_bwd.bwd_tile_plan` mirrors the body's query-tile range and
mask range (`tile_plan` in csrc/flash_bwd_sm90.cuh): every pair a key
block's rows keep lies in its tiles, the tiles past the mask range keep
every pair of the block (under `reference.attention_mask`), the first
masked tile does not, and a plan moved by one tile is caught.
`bwd_work_plan` cuts a call into work items (`bwd_work_item` mirrors the
kernel's decode): each (batch, q head, key block) once, the GQA group in
fixed contiguous slices, the snake deal balanced at the smoke's two
geometries.  The staging cuts (`_scaled_q`, `_delta`, `_lse2`) give the
bits of the formulas they replace, and the fused outputs are the plan's
(no per-Q-head partials on the wgmma body).  `flash_bwd_body` names the
body a call runs.
"""

import pytest
import torch

from attention_tpu_torch.ops import _native, flash_bwd
from attention_tpu_torch.ops.flash_bwd import (
    BALANCE,
    KEY_BLOCK,
    LOG2E,
    QUERY_TILE,
    bwd_tile_plan,
    bwd_work_item,
    bwd_work_plan,
    flash_bwd_body,
    snake_loads,
)
from attention_tpu_torch.ops.reference import attention_mask

NEG_INF = float("-inf")


def _rand(*shape, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


# ---------------------------------------------------- query-tile ranges


def _plan_holds(plan, block, m) -> bool:
    """``block`` (m rows x 128 keys, keys past n masked) against a plan:
    no kept pair outside [begin, end), every real row of a tile in
    [mask_end, end) keeps every key, the tile at begin (when masked) does
    not."""
    begin, end, mask_end, _ = plan
    if block[:begin * QUERY_TILE].any() or block[end * QUERY_TILE:].any():
        return False
    if not block[mask_end * QUERY_TILE:end * QUERY_TILE].all():
        return False
    return mask_end == begin or not block[
        begin * QUERY_TILE:(begin + 1) * QUERY_TILE].all()


@pytest.mark.parametrize("kv_offset", [0, 11])
@pytest.mark.parametrize("q_offset", [-37, 0, 5, 127, 403])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_tile_plan_masks_every_tile_that_needs_it(causal, q_offset,
                                                      kv_offset):
    """Per key block, over m of 1, 100 and 300 rows, n of 129 and 400
    keys and kv_valid from 0 to n: the plan holds, and one moved a tile
    (the mask range ending a tile early, the first tile skipped) fails.
    q_offset 127 puts the diagonal on a block's last key."""
    for m in (1, 100, 300):
        for n in (129, 400):
            for kv_valid in (0, 1, 128, n - 1, n):
                keep = attention_mask(m, n, causal=causal, q_offset=q_offset,
                                      kv_offset=kv_offset, kv_valid=kv_valid)
                blocks = -(-n // KEY_BLOCK)
                keep = torch.cat(
                    [keep, keep.new_zeros(m, blocks * KEY_BLOCK - n)], 1)
                for key0 in range(0, n, KEY_BLOCK):
                    block = keep[:, key0:key0 + KEY_BLOCK]
                    plan = bwd_tile_plan(key0, m, kv_valid, causal, q_offset,
                                         kv_offset)
                    begin, end, mask_end, edge = plan
                    assert 0 <= begin <= mask_end <= end <= -(-m // 64)
                    assert edge == end
                    assert _plan_holds(plan, block, m), (m, n, kv_valid, key0)
                    if key0 >= kv_valid:
                        assert begin == end
                    if mask_end > begin:
                        assert not _plan_holds(
                            plan._replace(mask_end=mask_end - 1), block, m)
                    if block[begin * QUERY_TILE:(begin + 1)
                             * QUERY_TILE].any():
                        assert not _plan_holds(plan._replace(begin=begin + 1),
                                               block, m)


def test_bwd_tile_plan_of_a_causal_diagonal():
    """Aligned causal blocks over 4096 rows: block i starts at tile 2i
    and masks the two tiles of its diagonal; a block past kv_valid has no
    tiles; the ragged key edge masks every tile."""
    for i in (0, 1, 31):
        assert bwd_tile_plan(i * 128, 4096, 4096, True, 0, 0) == (
            2 * i, 64, 2 * i + 2, 64)
    assert bwd_tile_plan(512, 4096, 500, True, 0, 0) == (0, 0, 0, 0)
    assert bwd_tile_plan(384, 1000, 500, True, 0, 0) == (6, 16, 16, 16)
    assert bwd_tile_plan(0, 300, 400, False, 0, 0) == (0, 5, 0, 5)


# ------------------------------------------------------------ work items


@pytest.mark.parametrize("shape", [
    (1, 4, 8, 4096, 4096, 4096, True, 0, 0),
    (4, 4, 8, 2048, 2048, 2048, True, 0, 0),
    (2, 2, 3, 40, 56, 50, True, 3, 8),
    (3, 1, 4, 300, 1000, 900, False, 0, 0),
    (1, 2, 6, 100, 700, 0, True, 0, 0),
], ids=["serving", "train_layer", "offsets", "noncausal", "kv_valid_0"])
def test_bwd_work_items_cover_every_head_and_block_once(shape):
    """Every (batch, q head, key block) lies in exactly one work item, at
    every slicing of the group, and the group's slices are contiguous,
    in order, of equal size, and the same on a second plan."""
    batch, kv_heads, group, m, n = shape[:5]
    plan = bwd_work_plan(*shape, sms=132)
    assert plan == bwd_work_plan(*shape, sms=132)
    blocks = -(-n // KEY_BLOCK)
    for slices in (s for s in range(1, group + 1) if group % s == 0):
        seen = []
        for w in range(blocks * batch * kv_heads * slices):
            b, hk, kb, heads = bwd_work_item(w, batch, kv_heads, group,
                                             slices)
            assert len(heads) == group // slices
            assert heads.start % len(heads) == 0
            assert heads.start // group == hk
            seen += [(b, h, kb) for h in heads]
        assert sorted(seen) == [(b, h, kb) for b in range(batch)
                                for h in range(kv_heads * group)
                                for kb in range(blocks)]
    assert plan.items == blocks * batch * kv_heads * plan.slices
    assert plan.grid == min(plan.items, 132)


def _loads(shape, slices):
    """Each work item's query tiles at this slicing, in launch order."""
    batch, kv_heads, group, m, n, kv_valid, causal, qo, ko = shape
    out = []
    for w in range(-(-n // KEY_BLOCK) * batch * kv_heads * slices):
        kb = bwd_work_item(w, batch, kv_heads, group, slices)[2]
        begin, end = bwd_tile_plan(kb * KEY_BLOCK, m, kv_valid, causal,
                                   qo, ko)[:2]
        out.append(group // slices * (end - begin))
    return out


@pytest.mark.parametrize("shape,slices", [
    ((1, 4, 8, 4096, 4096, 4096, True, 0, 0), 2),
    ((4, 4, 8, 2048, 2048, 2048, True, 0, 0), 1),
], ids=["serving", "train_layer"])
def test_bwd_work_plan_balances_the_smoke_geometries(shape, slices):
    """At the smoke's serving call (b = 1, 32/4 heads, 4096 rows) one
    slice leaves the CTA of key block 0 twice the mean, so the plan
    takes two; the training layer (b = 4, 2048 rows) balances with one.
    The snake deal's heaviest CTA lies within one item of the mean."""
    plan = bwd_work_plan(*shape, sms=132)
    assert plan.slices == slices
    assert plan.heaviest <= BALANCE * plan.mean
    loads = _loads(shape, slices)
    ctas = snake_loads(loads, plan.grid)
    assert max(ctas) == plan.heaviest
    assert sum(ctas) == sum(loads) == round(plan.mean * 132)
    assert plan.heaviest <= plan.mean + max(loads)
    if slices > 1:
        one = _loads(shape, 1)
        assert max(snake_loads(one, min(len(one), 132))) > \
            BALANCE * plan.mean


def test_snake_deal_order():
    """Round 0 left to right, round 1 right to left."""
    assert snake_loads([8, 7, 6, 5, 4, 3, 2], 3) == [8 + 3 + 2, 7 + 4,
                                                     6 + 5]


# ------------------------------------------------------------- staging


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_staging_cuts_keep_the_old_bits(dtype):
    """Qs in one op, delta from the inputs as they are, lse2 padded:
    the bits of the formulas they replace (the layer's strided views
    too), lse2's -inf turned +inf and its padding +inf."""
    q = _rand(2, 77, 4, 64, dtype=dtype).transpose(1, 2)
    do, o = (_rand(2, 4, 77, 64, dtype=dtype, seed=s) for s in (1, 2))
    scale = 64 ** -0.5
    old_qs = (q.float() * (scale * LOG2E)).to(dtype)
    assert torch.equal(_bits(flash_bwd._scaled_q(q, scale)), _bits(old_qs))
    old_delta = (do.float() * o.float()).sum(-1)
    assert torch.equal(_bits(flash_bwd._delta(do, o)), _bits(old_delta))
    lse = _rand(2, 4, 77, dtype=torch.float32, seed=3)
    lse[0, 1, :5] = NEG_INF
    lse2 = flash_bwd._lse2(lse, 128)
    assert lse2.shape == (2, 4, 128) and lse2.dtype == torch.float32
    live = lse != NEG_INF
    assert torch.equal(_bits(lse2[..., :77][live]),
                       _bits((lse.float() * LOG2E)[live]))
    assert (lse2[..., :77][~live] == float("inf")).all()
    assert (lse2[..., 77:] == float("inf")).all()


def _staged(monkeypatch, dtype, hkv=2, b=1, m=100, n=300, causal=True):
    """A `_Staged` of a CPU call, with the card's SM count stood in."""
    monkeypatch.setattr(_native, "sm_count", lambda index: 132)
    h, d = 8, 128
    q, do, o = (_rand(b, h, m, d, dtype=dtype, seed=s) for s in range(3))
    k, v = (_rand(b, hkv, n, d, dtype=dtype, seed=s) for s in (3, 4))
    lse = _rand(b, h, m, dtype=torch.float32, seed=5)
    return flash_bwd._Staged(q, k, v, o, lse, do, scale=d ** -0.5,
                             causal=causal, softcap=None, q_offset=0,
                             kv_offset=0, kv_valid=n)


@pytest.mark.parametrize("hkv,b,n,causal,slices", [
    (2, 1, 300, True, 4), (2, 8, 4096, False, 1)])
def test_wgmma_outputs_hold_no_per_head_partials(monkeypatch, hkv, b, n,
                                                 causal, slices):
    """The wgmma body's dK and dV are bf16 (one slice) or fp32 slice
    partials (b, hkv, slices, n, d), never per-Q-head partials; the
    wrapper sums the slices in order and casts once."""
    staged = _staged(monkeypatch, torch.bfloat16, hkv=hkv, b=b, n=n,
                     causal=causal)
    assert staged.plan["body"] == "wgmma"
    assert staged.plan["slices"] == slices
    assert staged.ls == 128
    out = staged.fused_buffers()
    assert out["dq32"].shape == (b, 8, 100, 128) and not out["dq32"].any()
    if slices == 1:
        assert out["dk"].shape == (b, hkv, n, 128)
        assert out["dk"].dtype == torch.bfloat16
        return
    assert out["dk"].shape == (b, hkv, slices, n, 128)
    out["dk"].copy_(_rand(*out["dk"].shape, dtype=torch.float32))
    out["dvo"].copy_(_rand(*out["dvo"].shape, dtype=torch.float32, seed=1))
    dq, dk, dv = staged.fused_grads(**out)
    assert dk.dtype == dv.dtype == dq.dtype == torch.bfloat16
    assert torch.equal(_bits(dk), _bits(out["dk"].sum(2).bfloat16()))
    assert torch.equal(_bits(dv), _bits(out["dvo"].sum(2).bfloat16()))


def test_fma_outputs_are_per_head_partials(monkeypatch):
    staged = _staged(monkeypatch, torch.float32)
    assert staged.plan == {"body": "fma", "slices": 1}
    out = staged.fused_buffers()
    assert out["dk"].shape == (1, 8, 300, 128)
    out["dk"].copy_(_rand(1, 8, 300, 128, dtype=torch.float32))
    dk = staged.fused_grads(**out)[1]
    assert torch.equal(dk, out["dk"].view(1, 2, 4, 300, 128).sum(2))


# ---------------------------------------------------------------- body


@pytest.mark.parametrize("dtype,d,dv,strides,ptrs,body", [
    (torch.bfloat16, 128, 128, [8] * 12, [0, 16, 32, 48], "wgmma"),
    (torch.bfloat16, 64, 64, [64, 4096, 8] * 4, [256] * 4, "wgmma"),
    (torch.float32, 128, 128, [8] * 12, [0] * 4, "fma"),
    (torch.bfloat16, 32, 32, [8] * 12, [0] * 4, "fma"),
    (torch.bfloat16, 64, 128, [8] * 12, [0] * 4, "fma"),
    (torch.bfloat16, 128, 128, [8] * 11 + [12], [0] * 4, "fma"),
    (torch.bfloat16, 128, 128, [8] * 11 + [0], [0] * 4, "fma"),
    (torch.bfloat16, 128, 128, [8] * 12, [0, 0, 8, 0], "fma"),
], ids=["bf16_d128", "bf16_d64", "f32", "d32", "dk_ne_dv", "stride_12",
        "stride_0", "misaligned"])
def test_flash_bwd_body_routes(dtype, d, dv, strides, ptrs, body):
    assert flash_bwd_body(dtype, d, dv, strides, ptrs) == body
