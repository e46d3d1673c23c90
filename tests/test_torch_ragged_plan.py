"""The ragged kernel's launch plan and its CTAs' work, on the CPU.

On the card `ragged_paged_attention` tells decode slots (at most
``DECODE_ROWS // group`` tokens) from prefill slots on the device: the
decode slots split their keys across CTAs and a finishing kernel merges
the partials; the prefill slots run the body `ragged_body` names, the
wgmma one over `prefill_items`.  Here `split_partials` (what each split's
CTA computes) merged by `decode.merge_splits` is held against the JAX
package's `ragged_paged_attention` (its Pallas kernel in interpret mode)
on the split's edges; `prefill_items` against brute-force causal masks;
and `ragged_launch_plan` on the serving geometry and its edges, on steps
whose lengths and spans it must never read (they live on the meta
device, where any read raises).

Tolerances: f32 1e-5 max abs (both sides in full f32; only the order of
the sums and the merge differ); bf16 `reference.mismatch`'s limit (the
JAX kernel rounds q·scale to bf16 where the port keeps it in f32, and
both round P and the output to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.ops import ragged_paged as jax_rp
from attention_tpu_torch.ops import decode
from attention_tpu_torch.ops import ragged_paged as rp
from attention_tpu_torch.ops.reference import mismatch

SMS = 132
PAGE = 128
F32_ATOL = 1e-5

# (tokens, length after the append) per active slot, then the active
# count: at 4/2 heads a decode slot has at most 8 tokens
CASES = {
    # one token each: an empty cache, one key, a page edge, the last
    # split's edge, the capacity
    "one_token_edges": ([(1, 1), (1, 64), (1, 128), (1, 321), (1, 384)], 5),
    # chunks of 3 and 8 tokens (still decode slots) beside a 9-token
    # prefill slot, with softcap
    "chunks_and_prefill": ([(3, 3), (8, 200), (9, 260), (1, 70)], 4),
    # a poisoned decode slot, an empty one, one past distribution[1]
    "poisoned_empty_dead": ([(1, -1), (0, 0), (1, 150), (1, 90)], 3),
}
SOFTCAP = {"chunks_and_prefill": 2.5}


def _step(spans, active, *, hq=4, hkv=2, d=16, slots=5, max_pages=3,
          seed=0):
    """numpy (pools, table, lens, cu, dist, q, q_tile) of one packed step:
    each slot its own pages, random pools and q."""
    rng = np.random.default_rng(seed)
    group = hq // hkv
    table = np.full((slots, max_pages), -1, np.int32)
    table[:len(spans)] = np.arange(len(spans) * max_pages).reshape(
        len(spans), max_pages)
    cu = np.zeros(slots + 1, np.int32)
    cu[1:len(spans) + 1] = np.cumsum([n for n, _ in spans])
    cu[len(spans) + 1:] = cu[len(spans)]
    lens = np.zeros(slots, np.int32)
    lens[:len(spans)] = [kv for _, kv in spans]
    width = rp.packed_bucket(int(cu[-1]))
    pools = [rng.standard_normal((len(spans) * max_pages, hkv, PAGE, d))
             .astype(np.float32) for _ in range(2)]
    q = rng.standard_normal((1, hq, width, d)).astype(np.float32)
    longest = max(n for n, _ in spans)
    q_tile = rp.tile_tokens(rp.packed_bucket(longest, minimum=1), group)
    return pools, table, lens, cu, np.array([1, active], np.int32), q, \
        q_tile


def _both(args, dtype):
    pools, table, lens, cu, dist, q, q_tile = args
    width = q.shape[2]
    zeros = np.zeros(width, np.int32)
    jstep = jax_rp.RaggedPagedStep(
        *(jnp.asarray(a, jdt) for a, jdt in (
            (pools[0], dtype), (pools[1], dtype), (table, None),
            (lens, None), (cu, None), (dist, None), (zeros, None),
            (zeros, None))), np.zeros((q_tile,), np.int32))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tstep = rp.RaggedPagedStep(
        torch.from_numpy(pools[0]).to(tdt), torch.from_numpy(pools[1]).to(tdt),
        *(torch.from_numpy(a) for a in (table, lens, cu, dist, zeros,
                                        zeros)), q_tile)
    return jstep, tstep, torch.from_numpy(q).to(tdt)


def _decode_tokens(cu, lens, active, smax):
    """(tokens of live decode slots, tokens of poisoned ones)."""
    live, poisoned = [], []
    for s in range(active):
        n = cu[s + 1] - cu[s]
        if 1 <= n <= smax:
            (poisoned if lens[s] < 0 else live).extend(range(cu[s],
                                                             cu[s + 1]))
    return live, poisoned


@pytest.mark.parametrize("case,dtype", [
    *((c, "f32") for c in CASES), ("chunks_and_prefill", "bf16")])
def test_split_partials_merged_match_jax(case, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    args = _step(*CASES[case])
    jstep, tstep, q = _both(args, jdt)
    softcap = SOFTCAP.get(case)
    want = jax_rp.ragged_paged_attention(jnp.asarray(args[5], jdt), jstep,
                                         softcap=softcap)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    plan = rp.ragged_launch_plan(q, tstep, sms=SMS)
    assert plan["splits"] == 6 and plan["chunk"] == 64  # a split a tile
    parts = rp.split_partials(q, tstep, scale=16 ** -0.5, softcap=softcap,
                              splits=plan["splits"], chunk=plan["chunk"])
    got = decode.merge_splits(*parts, dtype=q.dtype).float()
    _, _, lens, cu, dist, _, _ = args
    live, poisoned = _decode_tokens(cu, lens, int(dist[1]), plan["smax"])
    assert live
    if dtype == "f32":
        assert (got[:, :, live] - want[:, :, live]).abs().max() <= F32_ATOL
    else:
        assert mismatch(got[:, :, live].to(torch.bfloat16),
                        want[:, :, live].to(torch.bfloat16))[1] <= 1
    assert got[:, :, poisoned].isnan().all()
    assert want[:, :, poisoned].isnan().all()
    others = sorted(set(range(q.shape[2])) - set(live) - set(poisoned))
    assert (got[:, :, others] == 0).all()


@pytest.mark.parametrize("group,spans", [
    (8, [(1, 500), (192, 959), (256, 300), (37, 37)]),
    (4, [(1, 10), (5, 700), (33, 129), (100, 1000)]),
    (1, [(17, 17), (200, 1024), (128, 128), (129, 640)]),
    (2, [(9, 100), (64, 64), (65, -1), (300, 301)]),
], ids=["group8", "group4", "group1", "group2_poisoned"])
def test_prefill_items_cover_the_causal_rows(group, spans):
    """Every row of every prefill slot is in exactly one item of each kv
    head; an item's tiles [0, end) hold every key its rows see and its
    last tile holds one; the tiles below mask hold only keys all its
    rows see."""
    hkv, slots, max_pages = 2, 6, 8
    cu = np.concatenate([[0], np.cumsum([n for n, _ in spans])])
    cu = np.concatenate([cu, [cu[-1]] * (slots + 1 - len(cu))])
    lens = np.array([kv for _, kv in spans] + [0] * (slots - len(spans)))
    step = rp.RaggedPagedStep(
        torch.zeros(1, hkv, PAGE, 8), torch.zeros(1, hkv, PAGE, 8),
        torch.zeros(slots, max_pages, dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32),
        torch.tensor(cu, dtype=torch.int32),
        torch.tensor([1, len(spans)], dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
        8)
    items = rp.prefill_items(step, group)
    smax = rp.decode_tokens(group)
    seen = set()
    for it in items:
        s, m0 = it["slot"], it["m0"]
        q_len, kv = cu[s + 1] - cu[s], lens[s]
        rows = range(m0, min(m0 + rp.ROW_BLOCK, q_len * group))
        for row in rows:
            key = (s, it["kv_head"], row)
            assert key not in seen
            seen.add(key)
        if kv < 0:
            assert it["end"] == 0
            continue
        last = [kv - q_len + row // group for row in rows]  # last key seen
        assert it["end"] * rp.KEY_TILE > max(last)
        assert (it["end"] - 1) * rp.KEY_TILE <= max(last)
        assert it["mask"] * rp.KEY_TILE <= min(last) + 1
        assert it["mask"] * rp.KEY_TILE <= kv
    want = {(s, h, row) for s in range(len(spans))
            if cu[s + 1] - cu[s] > smax
            for h in range(hkv) for row in range((cu[s + 1] - cu[s]) * group)}
    assert seen == want
    # each slot's last (heaviest) block first
    order = [(it["slot"], it["m0"]) for it in items if it["kv_head"] == 0]
    for (sa, a), (sb, b) in zip(order, order[1:]):
        assert sa != sb or a > b


def _serving_step(spans, *, q_tile, dtype=torch.bfloat16, d=128, dv=None,
                  page=PAGE, hq=32, hkv=4, slots=10, capacity=2048):
    """A step at the serving geometry whose lengths, spans and
    distribution live on the meta device: reading any of them raises."""
    real = sum(n for n, _ in spans)
    width = rp.packed_bucket(max(real, q_tile))
    max_pages = capacity // page
    meta = {"dtype": torch.int32, "device": "meta"}
    step = rp.RaggedPagedStep(
        torch.zeros(4, hkv, page, d, dtype=dtype),
        torch.zeros(4, hkv, page, dv or d, dtype=dtype),
        torch.zeros(slots, max_pages, dtype=torch.int32),
        torch.empty(slots, **meta), torch.empty(slots + 1, **meta),
        torch.empty(2, **meta), torch.empty(width, **meta),
        torch.empty(width, **meta), q_tile)
    q = torch.zeros(1, width, hq, d, dtype=dtype).transpose(1, 2)
    return q, step


DECODE_ONLY = [(1, n) for n in (907, 926, 637, 733, 754, 269, 923, 672)]
MIXED = [(1, 553), (191, 959), (256, 256)]
PREFILL_ONLY = [(256, 512), (256, 1024)]


@pytest.mark.parametrize("spans,q_tile,width", [
    (DECODE_ONLY, 1, 8), (MIXED, 256, 512), (PREFILL_ONLY, 256, 512)],
    ids=["decode_only", "mixed", "prefill_only"])
def test_launch_plan_at_the_serving_geometry(spans, q_tile, width):
    q, step = _serving_step(spans, q_tile=q_tile)
    plan = rp.ragged_launch_plan(q, step, sms=SMS)
    assert plan["body"] == "wgmma" and plan["kg"] == 4
    # one-token decode at group 8; up to 2 tokens fit the 16-row tile
    assert plan["smax"] == 2
    # 40 (slot, kv head) blocks on 132 SMs: split for 6 CTAs an SM, a
    # whole number of 64-key tiles each, over the 2048-row capacity
    assert plan["splits"] == 16 and plan["chunk"] == 128
    assert plan["decode_grid"] == [1, 40, 16]
    assert plan["decode_grid"][1] * plan["splits"] > SMS
    assert plan["finish_grid"] == [width, 4]
    # the most (128-row block, kv head) items the width allows
    assert plan["prefill_grid"] == [min(SMS, 4 * (-(-width * 8 // 128) + 10))]


def test_launch_plan_reads_no_span_and_ignores_q_tile():
    """A span longer than q_tile, poisoned or empty slots: the plan is
    the same, since it reads none of them; only the 64-row bodies'
    grid follows q_tile."""
    q, step = _serving_step(MIXED, q_tile=256)
    plan = rp.ragged_launch_plan(q, step, sms=SMS)
    assert rp.ragged_launch_plan(q, step._replace(q_tile=8),
                                 sms=SMS) == plan
    q32 = q.float()
    step32 = step._replace(k_pool=step.k_pool.float(),
                           v_pool=step.v_pool.float())
    fma = rp.ragged_launch_plan(q32, step32, sms=SMS)
    assert fma["body"] == "fma" and fma["kg"] == 1
    assert fma["prefill_grid"] == [32, 40]
    assert rp.ragged_launch_plan(q32, step32._replace(q_tile=8),
                                 sms=SMS)["prefill_grid"] == [1, 40]


@pytest.mark.parametrize("kw,body", [
    ({"page": 64}, "wgmma"), ({"page": 16}, "wgmma"), ({"page": 256}, "wgmma"),
    ({"page": 48}, "mma"), ({"page": 4}, "mma"),
    ({"d": 64}, "wgmma"), ({"d": 64, "dv": 128}, "wgmma"),
    ({"d": 96}, "fma"), ({"dtype": torch.float32}, "fma"),
    ({"hq": 24, "hkv": 8}, "mma"), ({"hq": 32, "hkv": 1}, "wgmma")],
    ids=["page64", "page16", "page256", "page48", "page4", "d64",
         "dk64_dv128", "d96", "f32", "group3", "group32"])
def test_launch_plan_bodies_on_the_edges(kw, body):
    q, step = _serving_step(DECODE_ONLY, q_tile=1, **kw)
    plan = rp.ragged_launch_plan(q, step, sms=SMS)
    assert plan["body"] == body
    group = q.shape[1] // step.k_pool.shape[1]
    assert plan["smax"] == 16 // group
    if group > 16:
        # no slot is a decode slot: no split launch
        assert plan["decode_grid"] is None and plan["splits"] == 1
    else:
        assert plan["kg"] == (1 if body == "fma" else 4)
        assert plan["decode_grid"] == [1, 10 * step.k_pool.shape[1],
                                       plan["splits"]]


def test_ragged_body_takes_no_misaligned_operand():
    args = (torch.bfloat16, 128, 128, 8, PAGE)
    assert rp.ragged_body(*args, (128, 4096, 128, 4096), (0, 16, 32)) \
        == "wgmma"
    assert rp.ragged_body(*args, (128, 4100, 128, 4096), (0, 16, 32)) \
        == "fma"
    assert rp.ragged_body(*args, (128, 4096, 128, 4096), (8, 16, 32)) \
        == "fma"
