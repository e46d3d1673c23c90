"""The sliding-window + attention-sink model family in the port, against
the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages: the JAX side
runs its Pallas kernels in interpret mode, the port's wrappers run their
plain PyTorch versions because the tensors lie on the CPU.  Tolerances:

* f32: 1e-5 max abs (`reference.F32_ATOL`).  Both sides compute in full
  f32 and differ only in summation order and exp vs exp2.  Partials'
  unnormalized sums grow with the row, so they are held to 1e-5 of
  max(1, |value|).
* bf16: `reference.mismatch` (the two sides round P and the output to
  bf16 at different points).
* the small model's logits: 1e-4 max abs (f32 layers and a vocab head
  over the kernels' 1e-5).
* greedy token streams, and the int8 sink rows of `sink_read_rotation`,
  must be equal; its requantized scales within 2^-21 relative, four
  float32 ulps (the two libraries' sin rounds one ulp apart at some
  angles, which moved a rotated row's absmax by up to two ulps, never
  its int8 values here).

`ops.flash.tile_plan` and `ops.ragged_paged.prefill_items`, the tiles
the kernels' wgmma bodies walk, are held against brute-force masks: a
block visits exactly the tiles that hold a key one of its rows keeps,
and skips the per-element test only on tiles every row keeps whole.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu import engine as jax_engine
from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import decode as jax_gen
from attention_tpu.models.attention_layer import \
    RollingKVCache as JaxRolling
from attention_tpu.ops import flash as jax_flash
from attention_tpu.ops import quant as jax_quant
from attention_tpu.ops import ragged_paged as jax_rp
from attention_tpu_torch.engine import (
    EngineConfig,
    ServingEngine,
    replay,
    synthetic_trace,
)
from attention_tpu_torch.models import (
    GQASelfAttention,
    RollingKVCache,
    TinyDecoder,
    params_from_jax,
    quant_cache_from_jax,
    rolling_cache_from_jax,
)
from attention_tpu_torch.models import decode as gen
from attention_tpu_torch.ops import _native, decode, flash
from attention_tpu_torch.ops import quant as quant_ops
from attention_tpu_torch.ops import ragged_paged as rp
from attention_tpu_torch.ops.flash_vjp import flash_attention_diff
from attention_tpu_torch.ops.reference import (
    F32_ATOL,
    attention_mask,
    mismatch,
)

LOGITS_ATOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, *, relative=False,
           atol=F32_ATOL) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    scale = np.maximum(np.abs(want[fin]), 1.0) if relative else 1.0
    assert (np.abs(got[fin] - want[fin]) / scale).max(initial=0.0) <= atol


# ------------------------------------------------------------ tile plans

M, N = 300, 520


@pytest.mark.parametrize("window,sinks", [
    (1, None), (7, None), (64, 5), (128, 1), (130, 128), (200, 200),
    (1000, 5), (100, 130)])
@pytest.mark.parametrize("q_offset,kv_offset,kv_valid", [
    (0, 0, N), (220, 0, M + 220), (37, 11, N - 50), (0, 140, 200)])
def test_tile_plan_visits_exactly_the_kept_tiles(window, sinks, q_offset,
                                                 kv_offset, kv_valid):
    """Per row block, under a band: the visited tiles are exactly those
    holding a key some row keeps, each once, sink tiles first; every
    visited tile in [mask_lo, mask) is kept whole by every row (the rest
    are tested per element); the splits of a plan cover the visits
    once."""
    kv_valid = min(kv_valid, N)
    keep = attention_mask(M, N, causal=True, q_offset=q_offset,
                          kv_offset=kv_offset, kv_valid=kv_valid,
                          window=window, sinks=sinks)
    tiles = -(-N // flash.KEY_TILE)
    keep = torch.cat([keep, keep.new_zeros(M, tiles * flash.KEY_TILE - N)],
                     1).view(M, tiles, flash.KEY_TILE)
    for m0 in range(0, M, flash.ROW_BLOCK):
        rows = keep[m0:m0 + flash.ROW_BLOCK]
        plan = flash.tile_plan(m0, M, kv_valid, True, q_offset, kv_offset,
                               window=window, sinks=sinks)
        visited = plan.tiles()
        assert plan.begin == 0 and len(set(visited)) == len(visited)
        assert sorted(visited) == rows.any(-1).any(0).nonzero().flatten(
        ).tolist()
        assert visited[:plan.sink] == list(range(plan.sink))
        for t in visited:
            if plan.mask_lo <= t < plan.mask:
                assert rows[:, t].all(), (m0, t, plan)
        seen = []
        for split in range(-(-len(visited) // 2) + 1):
            seen += flash.tile_plan(m0, M, kv_valid, True, q_offset,
                                    kv_offset, split, 2, window=window,
                                    sinks=sinks).tiles()
        assert seen == visited


@pytest.mark.parametrize("window", [None, 1, 100])
def test_tile_plan_mask_interval_is_tight(window):
    """The tiles just outside [mask_lo, mask) of an aligned causal band
    need the test: no tile is tested for nothing on either edge, and a
    band shrinks the walk to its tiles (window 100 at 128-row blocks:
    at most two)."""
    m = 4 * flash.ROW_BLOCK
    keep = attention_mask(m, m, causal=True, window=window).view(
        m, 4, flash.KEY_TILE)
    for m0 in range(0, m, flash.ROW_BLOCK):
        rows = keep[m0:m0 + flash.ROW_BLOCK]
        plan = flash.tile_plan(m0, m, m, True, 0, 0, window=window)
        if plan.mask_lo > 0:
            assert not rows[:, plan.mask_lo - 1].all()
        if plan.mask < 4:
            assert not rows[:, plan.mask].all()
        if window == 100:
            assert len(plan.tiles()) <= 2


@pytest.mark.parametrize("window,sinks", [(24, 4), (100, None), (300, 130)])
@pytest.mark.parametrize("group,spans", [
    (8, [(1, 500), (192, 959), (256, 300), (37, 37)]),
    (2, [(9, 100), (64, 64), (65, -1), (300, 301)]),
], ids=["group8", "group2_poisoned"])
def test_prefill_items_visit_exactly_the_band(group, spans, window, sinks):
    """The ragged wgmma body's items under a band: each visits exactly
    the tiles holding a key one of its rows keeps, and tests per element
    every tile outside [mask_lo, mask)."""
    hkv, slots, max_pages, page = 2, 6, 8, 128
    cu = np.concatenate([[0], np.cumsum([n for n, _ in spans])])
    cu = np.concatenate([cu, [cu[-1]] * (slots + 1 - len(cu))])
    lens = np.array([kv for _, kv in spans] + [0] * (slots - len(spans)))
    step = rp.RaggedPagedStep(
        torch.zeros(1, hkv, page, 8), torch.zeros(1, hkv, page, 8),
        torch.zeros(slots, max_pages, dtype=torch.int32),
        torch.tensor(lens, dtype=torch.int32),
        torch.tensor(cu, dtype=torch.int32),
        torch.tensor([1, len(spans)], dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
        8)
    items = rp.prefill_items(step, group, window, sinks)
    assert items
    col = torch.arange(max_pages * page)
    for it in items:
        s, m0 = it["slot"], it["m0"]
        plan = flash.TilePlan(*(it[f] for f in flash.TilePlan._fields))
        if lens[s] < 0:
            assert plan.tiles() == []
            continue
        q_len = cu[s + 1] - cu[s]
        rows = torch.arange(m0, min(m0 + rp.ROW_BLOCK, q_len * group))
        pos = lens[s] - q_len + rows // group
        keep = (col <= pos[:, None]) & (col > pos[:, None] - window)
        if sinks:
            keep |= (col < sinks) & (col <= pos[:, None])
        keep = keep.view(len(rows), max_pages, page)
        assert sorted(plan.tiles()) == keep.any(-1).any(0).nonzero(
        ).flatten().tolist()
        for t in plan.tiles():
            if plan.mask_lo <= t < plan.mask:
                assert keep[:, t].all()


def test_split_plans_count_the_band():
    """A band cuts the tiles a thin grid splits: the flash split counts
    the band's and the sinks' tiles, not kv_valid's; the ragged decode
    slots split the band (window + tokens + a tile), not the table."""
    assert flash.flash_split_plan(1, 1, 1024, 8192, sms=132) == (16, 4)
    # 1023 + 128 rows of band: 10 tiles, and one of sinks
    assert flash.flash_split_plan(1, 1, 1024, 8192, sms=132,
                                  window=1024, sinks=4) == (11, 1)
    q = torch.zeros(1, 32, 16, 128, dtype=torch.bfloat16)
    step = rp.RaggedPagedStep(
        torch.zeros(4, 4, 128, 128, dtype=torch.bfloat16),
        torch.zeros(4, 4, 128, 128, dtype=torch.bfloat16),
        torch.zeros(10, 16, dtype=torch.int32), *(torch.zeros(
            n, dtype=torch.int32) for n in (10, 11, 2, 16, 16)), 16)
    full = rp.ragged_launch_plan(q, step, sms=132)
    band = rp.ragged_launch_plan(q, step, sms=132, window=256)
    assert full["splits"] * full["chunk"] >= 2048
    assert band["splits"] * band["chunk"] < 2048
    assert band["chunk"] % decode.KEY_TILE == 0


_CTYPES = {"const void*": "P", "void*": "P", "float*": "P", "int": "I",
           "long long": "L", "float": "F"}


@pytest.mark.parametrize("kernel,symbol,argtypes", [
    ("flash_fwd", "flash_fwd", flash._ARGTYPES),
    ("ragged_paged", "ragged_paged_fwd", rp._ARGTYPES)])
def test_argtypes_match_the_c_entry_points(kernel, symbol, argtypes):
    """The two entry points that took the band: their ctypes argument
    types are the C parameters, read from the source (a missing int
    would shift every pointer after it)."""
    with open(os.path.join(_native.CSRC, _native.KERNELS[kernel])) as f:
        src = f.read()
    params = re.search(r'extern "C" int ' + symbol + r"\((.*?)\)\s*\{",
                       src, re.S).group(1)
    names = {v: k for k, v in vars(_native).items() if k in "PILF"}
    got = [names[a] for a in argtypes]
    want = [_CTYPES[" ".join(p.split()[:-1]).replace(" *", "*")]
            for p in params.split(",")]
    assert got == want


# ------------------------------------------------------------------ flash

H, HKV, DK, DV = 4, 2, 16, 24
FLASH_CASES = {
    # (m, n, kw): a cached prefill and a fresh causal call
    "cached": (40, 160, dict(q_offset=100, kv_valid=140)),
    "fresh": (150, 150, {}),
}


@pytest.mark.parametrize("sinks", [None, 1, 5])
@pytest.mark.parametrize("window", [1, 7, 64, 10_000])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_window_matches_jax(case, window, sinks):
    """flash_attention and its partials with the band, dk != dv, GQA;
    the partials' unnormalized sums relative."""
    m, n, kw = FLASH_CASES[case]
    rng = np.random.default_rng(window + (sinks or 0))
    q, k, v = _rand(rng, 1, H, m, DK), _rand(rng, 1, HKV, n, DK), \
        _rand(rng, 1, HKV, n, DV)
    band = dict(causal=True, window=window, sinks=sinks, **kw)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _close(flash.flash_attention(tq, tk, tv, **band),
           jax_flash.flash_attention(jq, jk, jv, **band))
    want = jax_flash.flash_attention_partials(jq, jk, jv, **band)
    for mine, theirs in zip(flash.flash_attention_partials(tq, tk, tv,
                                                           **band), want):
        _close(mine, theirs, relative=True)


def test_flash_window_bf16_and_nothing_seen_match_jax():
    """bf16 under `mismatch`; a cached prefill whose kv_valid lies below
    every row's band sees only its sinks, and without sinks nothing:
    output 0, row max -inf, sum 0."""
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 1, H, 40, 64), _rand(rng, 1, HKV, 300, 64), \
        _rand(rng, 1, HKV, 300, 64)
    kw = dict(causal=True, window=32, sinks=4, q_offset=200, kv_valid=250)
    want = jax_flash.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), **kw)
    got = flash.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), **kw)
    assert mismatch(got, torch.tensor(np.asarray(want, np.float32)).to(
        torch.bfloat16))[1] <= 1
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    blind = dict(causal=True, window=8, q_offset=200, kv_valid=100)
    out, mx, sm = flash.flash_attention_partials(tq, tk, tv, **blind)
    assert (out == 0).all() and (mx == float("-inf")).all() \
        and (sm == 0).all()
    assert (flash.flash_attention(tq, tk, tv, **blind) == 0).all()
    jout = jax_flash.flash_attention(*map(jnp.asarray, (q, k, v)), **blind)
    _close(flash.flash_attention(tq, tk, tv, **blind), jout)
    only_sinks = flash.flash_attention(tq, tk, tv, sinks=3, **blind)
    _close(only_sinks, jax_flash.flash_attention(
        *map(jnp.asarray, (q, k, v)), sinks=3, **blind))
    assert not (only_sinks == 0).all()


def test_window_larger_than_the_sequence_is_causal_bit_for_bit():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 100, 32)) for _ in range(3))
    assert torch.equal(flash.flash_attention(q, k, v, causal=True,
                                             window=10_000),
                       flash.flash_attention(q, k, v, causal=True))


# ----------------------------------------------------------------- ragged

_PAGE, _HQ, _HKV, _D = 128, 4, 2, 16
_SLOTS, _MAX_PAGES = 4, 3


def _ragged_case(specs, seed=0):
    """The JAX package's windowed ragged case (tests/test_ragged_engine.py
    `_kernel_case`): per active slot, decode first, (pre-append kv_len,
    q_len); pools, table, spans and the appended rows from a seed.
    Returns the post-append (JAX step, port step, q)."""
    r = np.random.default_rng(seed)
    num_pool = _SLOTS * _MAX_PAGES + 2
    pools = [_rand(r, num_pool, _HKV, _PAGE, _D) for _ in range(2)]
    table = np.full((_SLOTS, _MAX_PAGES), -1, np.int32)
    kv_lens = np.zeros((_SLOTS,), np.int32)
    total = sum(q for _, q in specs)
    num_decode = sum(1 for _, q in specs if q == 1)
    q_tile = rp.tile_tokens(
        rp.packed_bucket(max(q for _, q in specs), minimum=1),
        _HQ // _HKV)
    width = rp.packed_bucket(max(total, q_tile))
    cu = np.zeros((_SLOTS + 1,), np.int32)
    pos = np.zeros((width,), np.int32)
    slot = np.full((width,), -1, np.int32)
    off = nxt = 0
    for s, (kv_pre, q_len) in enumerate(specs):
        npages = -(-(kv_pre + q_len) // _PAGE)
        table[s, :npages] = np.arange(nxt, nxt + npages)
        nxt += npages
        kv_lens[s] = kv_pre
        pos[off:off + q_len] = np.arange(kv_pre, kv_pre + q_len)
        slot[off:off + q_len] = s
        off += q_len
        cu[s + 1] = off
    cu[len(specs) + 1:] = off
    dist = np.array([num_decode, len(specs)], np.int32)
    q = _rand(r, 1, _HQ, width, _D)
    new = [_rand(r, 1, _HKV, width, _D) for _ in range(2)]
    jstep = jax_rp.ragged_paged_append(jax_rp.RaggedPagedStep(
        *map(jnp.asarray, (*pools, table, kv_lens, cu, dist, pos, slot)),
        np.zeros((q_tile,), np.int32)), *map(jnp.asarray, new))
    tstep = rp.ragged_paged_append(rp.RaggedPagedStep(
        *(torch.from_numpy(x.copy()) for x in (*pools, table, kv_lens, cu,
                                               dist, pos, slot)), q_tile),
        *map(torch.from_numpy, new))
    return jstep, tstep, q


@pytest.mark.parametrize("kw", [
    {"window": 24, "sinks": 4}, {"window": 24, "sinks": 4, "softcap": 2.5},
    {"window": 100}], ids=["window24_sinks4", "softcap", "window100"])
def test_ragged_window_matches_jax(kw):
    """The JAX package's windowed ragged case: a decode slot at 200 rows
    and a fresh 8-token prefill; the pools and lengths after the append
    equal, the attention within f32 1e-5, pad rows 0."""
    jstep, tstep, q = _ragged_case([(200, 1), (0, 8)])
    assert tstep.kv_lens.tolist() == np.asarray(jstep.kv_lens).tolist()
    want = jax_rp.ragged_paged_attention(jnp.asarray(q), jstep, **kw)
    got = rp.ragged_paged_attention(torch.from_numpy(q), tstep, **kw)
    _close(got, want)
    assert (got[:, :, 9:] == 0).all()


def test_ragged_window_decode_split_matches_jax():
    """The decode slots' key split over the band (`split_partials`,
    merged in split order) against the JAX kernel, at a plan with more
    than one split."""
    jstep, tstep, q = _ragged_case([(200, 1), (300, 1), (0, 8)], seed=2)
    kw = dict(window=60, sinks=4)
    plan = rp.ragged_launch_plan(torch.from_numpy(q), tstep, sms=132,
                                 window=kw["window"])
    assert plan["splits"] > 1
    want = np.asarray(jax_rp.ragged_paged_attention(jnp.asarray(q), jstep,
                                                    **kw))
    parts = rp.split_partials(torch.from_numpy(q), tstep, scale=_D ** -0.5,
                              splits=plan["splits"], chunk=plan["chunk"],
                              **kw)
    got = decode.merge_splits(*parts, dtype=torch.float32)
    _close(got[:, :, :2], want[:, :, :2])


# ---------------------------------------------------------- sink rotation


@pytest.mark.parametrize("total", [10, 200, [10, 150]])
def test_sink_read_rotation_matches_jax(total):
    """The int8 sink rows rotated by one delta or by one a sequence (a
    delta of 0 below window + sinks), against JAX's; the other rows
    untouched."""
    rng = np.random.default_rng(5)
    k, v = _rand(rng, 2, HKV, 256, 32), _rand(rng, 2, HKV, 256, 32)
    jkv = jax_quant.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    tkv = quant_cache_from_jax(jax.device_get(jkv))
    args = (16, 4, 500.0)
    want = jax_quant.sink_read_rotation(jkv, jnp.asarray(total), *args)
    got = quant_ops.sink_read_rotation(tkv, torch.tensor(total), *args)
    want = quant_cache_from_jax(jax.device_get(want))
    for mine, theirs in zip(got, want):
        if mine.dtype == torch.int8:
            assert torch.equal(mine, theirs)
        else:
            # the two libraries' sin rounds one f32 ulp apart at some
            # angles, which moves a rotated row's absmax, and so its
            # scale, by up to two ulps (measured); four is the limit
            rel = ((mine - theirs).abs() / theirs.abs()).max().item()
            assert rel <= 2.0 ** -21
    assert torch.equal(got.k_q[:, :, 4:], tkv.k_q[:, :, 4:])
    assert torch.equal(got.k_scale[:, :, 4:], tkv.k_scale[:, :, 4:])


# -------------------------------------------------------------- the model

SMALL = dict(vocab=43, dim=32, depth=2, num_q_heads=4, num_kv_heads=2,
             rope=True, softcap=20.0)
BANDS = {"window8_sinks2": (8, 2), "window12": (12, 0)}


@pytest.fixture(scope="module", params=list(BANDS))
def pair(request):
    window, sinks = BANDS[request.param]
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, window=window,
                        attn_sinks=sinks, **SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    model = TinyDecoder(dtype=torch.float32, device="cpu", window=window,
                        attn_sinks=sinks, **SMALL)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


PROMPT = np.random.default_rng(6).integers(0, 43, (2, 21)).astype(np.int32)
PROMPT_LENS = np.array([21, 9], np.int32)
STEPS = 6


def _jax_step(jmodel, params, tokens, caches):
    logits, caches = jmodel.apply({"params": params}, jnp.asarray(tokens),
                                  caches)
    return np.asarray(logits), caches


def test_windowed_forward_matches_jax(pair):
    jmodel, params, model = pair
    want = jmodel.apply({"params": params}, jnp.asarray(PROMPT))
    with torch.no_grad():
        got = model(torch.from_numpy(PROMPT).long())
    _close(got, want, atol=LOGITS_ATOL)


@pytest.mark.parametrize("rolling", [False, True], ids=["dense", "rolling"])
def test_windowed_decode_matches_jax(pair, rolling):
    """A 21-token prefill, then teacher-forced one-token steps past the
    window (and the ring's wrap): logits each step, and after the
    prefill the same cache (for the ring: the same slots)."""
    jmodel, params, model = pair
    b = PROMPT.shape[0]
    if rolling:
        jc = jmodel.init_caches(b, 0, rolling=True)
        tc = model.init_caches(b, 0, rolling=True)
        assert all(isinstance(c, JaxRolling) for c in jc)
    else:
        jc = jmodel.init_caches(b, 128)
        tc = model.init_caches(b, 128)
    want, jc = _jax_step(jmodel, params, PROMPT[:, :12], jc)
    with torch.no_grad():
        got, tc = model(torch.from_numpy(PROMPT[:, :12]).long(), tc)
        _close(got, want, atol=LOGITS_ATOL)
        if rolling:
            ring = rolling_cache_from_jax(jax.device_get(jc[0]))
            assert ring.length == tc[0].length == 12
            _close(tc[0].k, np.asarray(ring.k))
        for t in range(12, 21):
            want, jc = _jax_step(jmodel, params, PROMPT[:, t:t + 1], jc)
            got, tc = model(torch.from_numpy(PROMPT[:, t:t + 1]).long(), tc)
            _close(got, want, atol=LOGITS_ATOL)


def test_rolling_generate_tokens_equal_jax_and_full_cache(pair):
    jmodel, params, model = pair
    want = np.asarray(jax_gen.generate(jmodel, params, jnp.asarray(PROMPT),
                                       steps=STEPS, rolling_cache=True))
    got = gen.generate(model, PROMPT, steps=STEPS, rolling_cache=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, gen.generate(model, PROMPT, steps=STEPS))


def test_windowed_generate_ragged_paged_int8_equal_jax(pair):
    """generate_ragged and generate_paged (rope + sinks through
    `paged_sink_decode`) on ragged prompts, and generate(int8_cache=True)
    (rope + sinks through `sink_read_rotation`), token for token."""
    jmodel, params, model = pair
    prompt, lens = jnp.asarray(PROMPT), jnp.asarray(PROMPT_LENS)
    want = np.asarray(jax_gen.generate_ragged(jmodel, params, prompt, lens,
                                              steps=STEPS))
    np.testing.assert_array_equal(
        gen.generate_ragged(model, PROMPT, PROMPT_LENS, steps=STEPS).numpy(),
        want)
    want = np.asarray(jax_gen.generate_paged(jmodel, params, prompt, lens,
                                             steps=STEPS)[0])
    np.testing.assert_array_equal(
        gen.generate_paged(model, PROMPT, PROMPT_LENS,
                           steps=STEPS)[0].numpy(), want)
    want = np.asarray(jax_gen.generate(jmodel, params, prompt, steps=STEPS,
                                       int8_cache=True))
    np.testing.assert_array_equal(
        gen.generate(model, PROMPT, steps=STEPS, int8_cache=True).numpy(),
        want)


def test_windowed_engine_streams_equal_jax(pair):
    """Greedy streams of the serving engine: ragged mode where the packed
    step can serve the model (no rope + sinks), two-call mode always."""
    jmodel, params, model = pair
    cfg = dict(num_pages=24, page_size=128, max_seq_len=256,
               max_decode_batch=4, max_prefill_rows=2, prefill_chunk=16,
               token_budget=48, step_mode="two_call")
    trace = synthetic_trace(5, vocab=43, seed=5, max_tokens=5,
                            prompt_len_min=4, prompt_len_max=40,
                            arrival_every=3)
    modes = ["two_call"] + ([] if model.attn_sinks else ["ragged"])
    for mode in modes:
        cfg["step_mode"] = mode
        _, want = jax_engine.replay(jax_engine.ServingEngine(
            jmodel, params, jax_engine.EngineConfig(**cfg)), trace)
        eng = ServingEngine(model, EngineConfig(**cfg))
        _, got = replay(eng, trace)
        assert got == want, mode
        assert eng.nonfinite_events == 0


# --------------------------------------------------------------- refusals


def _raises_like_jax(jax_call, port_call):
    """Both sides refuse, with the same exception type."""
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(want.type):
        port_call()


@pytest.mark.parametrize("kw", [
    {"window": 4}, {"causal": True, "window": 0},
    {"causal": True, "sinks": 2}, {"causal": True, "window": 4, "sinks": 0},
    {"causal": True, "window": 4, "sinks": 2,
     "q_segment_ids": np.zeros(16, np.int32),
     "kv_segment_ids": np.zeros(16, np.int32)}],
    ids=["no_causal", "window0", "sinks_alone", "sinks0", "sinks_segments"])
def test_flash_band_refusals_match_jax(kw):
    q = np.zeros((16, 32), np.float32)

    def args(conv):
        return {k: conv(x) if isinstance(x, np.ndarray) else x
                for k, x in kw.items()}

    for fn in ("flash_attention", "flash_attention_partials"):
        _raises_like_jax(
            lambda: getattr(jax_flash, fn)(*[jnp.asarray(q)] * 3,
                                           **args(jnp.asarray)),
            lambda: getattr(flash, fn)(*[torch.from_numpy(q)] * 3,
                                       **args(torch.from_numpy)))


def test_ragged_band_refusals_match_jax():
    jstep, tstep, q = _ragged_case([(200, 1), (0, 8)])
    for kw in ({"sinks": 4}, {"window": 0}, {"window": 8, "sinks": 0}):
        _raises_like_jax(
            lambda: jax_rp.ragged_paged_attention(jnp.asarray(q), jstep,
                                                  **kw),
            lambda: rp.ragged_paged_attention(torch.from_numpy(q), tstep,
                                              **kw))


def test_model_refusals_match_jax():
    x = np.zeros((1, 8), np.int32)

    def jax_model(**kw):
        m = JaxDecoder(impl="flash", dtype=jnp.float32, **dict(SMALL, **kw))
        return m, jax.jit(m.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    for kw in ({"window": 0}, {"attn_sinks": 2}, {"window": 8,
                                                  "attn_sinks": -1}):
        _raises_like_jax(lambda: jax_model(**kw),
                         lambda: TinyDecoder(dtype=torch.float32,
                                             device="cpu", **SMALL, **kw))
    with pytest.raises(ValueError, match="causal"):
        GQASelfAttention(32, 4, 2, 8, causal=False, window=4, device="cpu")
    plain_j, plain_p = jax_model()
    plain = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL)
    _raises_like_jax(lambda: jax_gen.generate(
        plain_j, plain_p, jnp.asarray(x), steps=2, rolling_cache=True),
        lambda: gen.generate(plain, x, steps=2, rolling_cache=True))
    _raises_like_jax(lambda: plain_j.init_caches(1, 0, rolling=True),
                     lambda: plain.init_caches(1, 0, rolling=True))
    win_j, win_p = jax_model(window=8, attn_sinks=2)
    win = TinyDecoder(dtype=torch.float32, device="cpu", window=8,
                      attn_sinks=2, **SMALL)
    _raises_like_jax(lambda: jax_gen.generate(
        win_j, win_p, jnp.asarray(x), steps=2, rolling_cache=True,
        int8_cache=True),
        lambda: gen.generate(win, x, steps=2, rolling_cache=True,
                             int8_cache=True))
    # a ring of another window's capacity
    _raises_like_jax(
        lambda: win_j.apply({"params": win_p}, jnp.asarray(x), tuple(
            JaxRolling.create(1, 2, 200, 8) for _ in range(2))),
        lambda: win(torch.from_numpy(x).long(), tuple(
            RollingKVCache.create(1, 2, 200, 8, torch.float32, "cpu")
            for _ in range(2))))
    # rope + sinks on the packed serving step
    cfg = dict(num_pages=8, page_size=128, max_seq_len=128,
               step_mode="ragged")
    trace = synthetic_trace(1, vocab=43, seed=1, max_tokens=2)
    _raises_like_jax(
        lambda: jax_engine.replay(jax_engine.ServingEngine(
            win_j, win_p, jax_engine.EngineConfig(**cfg)), trace),
        lambda: replay(ServingEngine(win, EngineConfig(**cfg)), trace))


def test_rolling_prefill_into_a_used_ring_is_nan():
    model = TinyDecoder(dtype=torch.float32, device="cpu", window=8,
                        attn_sinks=2, **SMALL)
    caches = model.init_caches(1, 0, rolling=True)
    with torch.no_grad():
        _, caches = model(torch.zeros(1, 5, dtype=torch.long), caches)
        out, _ = model(torch.zeros(1, 3, dtype=torch.long), caches)
    assert out.isnan().all()
    assert RollingKVCache.capacity_for(8, 2) == 128
    assert RollingKVCache.capacity_for(128, 4) == 256


def test_windowed_training_raises_naming_the_queue_item():
    """The band's backward is ported (ROADMAP Queue 2 item 2 is done), so
    nothing raises any more: `flash_attention_diff` with a window and
    sinks, and a windowed small model's ``backward()`` over a sequence
    longer than its window, give finite gradients, every parameter's."""
    q = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    for kw in ({"window": 4}, {"window": 4, "sinks": 2}):
        q.grad = None
        flash_attention_diff(q, q, q, causal=True, **kw).sum().backward()
        assert bool(q.grad.isfinite().all()) and q.grad.abs().max() > 0
    model = TinyDecoder(dtype=torch.float32, device="cpu", window=8,
                        attn_sinks=2, **SMALL)
    tokens = torch.arange(24).remainder(SMALL["vocab"])[None]
    model(tokens).sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.isfinite().all()), name
