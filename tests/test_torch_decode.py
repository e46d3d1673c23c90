"""The port's decode path against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages: the JAX side
runs its Pallas kernels in interpret mode, the port's wrappers run their
plain PyTorch versions because the tensors lie on the CPU.  Tolerances:

* f32: 1e-5 max abs (`reference.F32_ATOL`).  Both sides compute in full
  f32 and differ only in summation order and exp vs exp2.  The paged
  kernel's unnormalized partials (``return_stats``) grow with the row
  sum, so they are held to 1e-5 of max(1, |value|).
* bf16: `reference.mismatch`, 1.6e-2 of the value plus 2^-6 of its
  row's rms, capped at 2e-2 (the two sides round P and the output to
  bf16 at different points).

Greedy token streams, page tables, lengths and pools must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu import engine as jax_engine
from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import decode as jax_gen
from attention_tpu.ops import decode as jax_decode
from attention_tpu.ops import paged as jax_paged
from attention_tpu.ops.flash import flash_attention as jax_flash
from attention_tpu_torch.engine import (
    EngineConfig,
    ServingEngine,
    replay,
    synthetic_trace,
)
from attention_tpu_torch.models import TinyDecoder, params_from_jax
from attention_tpu_torch.models import decode as gen
from attention_tpu_torch.ops import decode, paged
from attention_tpu_torch.ops.flash import flash_attention
from attention_tpu_torch.ops.reference import F32_ATOL, mismatch

B, H, HKV, N, D = 3, 4, 2, 256, 16
LENS = np.array([1, 130, 256], np.int32)
BANDS = {"softcap": {"softcap": 2.0},
         "window_sinks": {"window": 32, "sinks": 4}}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got: torch.Tensor, want, *, relative=False) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    scale = np.maximum(np.abs(want[fin]), 1.0) if relative else 1.0
    assert (np.abs(got[fin] - want[fin]) / scale).max() <= F32_ATOL


# ----------------------------------------------------------- dense decode


@pytest.mark.parametrize("chunk,band,dtype", [
    (0, "softcap", "f32"), (0, "window_sinks", "f32"),
    (4, "softcap", "f32"), (4, "window_sinks", "f32"),
    (0, "softcap", "bf16")])
def test_flash_decode_matches_jax(chunk, band, dtype):
    rng = np.random.default_rng(chunk)
    q = _rand(rng, B, H, *([chunk] if chunk else []), D)
    k, v = _rand(rng, B, HKV, N, D), _rand(rng, B, HKV, N, D)
    jfn = jax_decode.flash_decode_chunk if chunk else jax_decode.flash_decode
    fn = decode.flash_decode_chunk if chunk else decode.flash_decode
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = jfn(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(LENS),
               **BANDS[band])
    got = fn(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
             torch.from_numpy(LENS), **BANDS[band])
    assert got.dtype == tdt and got.shape == want.shape
    assert mismatch(got, torch.tensor(np.asarray(want, np.float32)).to(
        tdt))[1] <= 1


# ------------------------------------------------------------------ paged


def _paged_inputs(lengths, seed=0):
    """Pools of 8 pages of 128 rows; sequence b owns pages 2b, 2b+1 (the
    rest of its table row is -1)."""
    rng = np.random.default_rng(seed)
    pools = [_rand(rng, 8, HKV, 128, D) for _ in range(2)]
    table = np.full((B, 3), -1, np.int32)
    table[:, :2] = np.arange(2 * B).reshape(B, 2)
    return pools, table, np.asarray(lengths, np.int32), rng


def _both(pools, table, lengths):
    return (jax_paged.PagedKV(*map(jnp.asarray, (*pools, table, lengths))),
            paged.PagedKV(*(torch.from_numpy(x.copy())
                            for x in (*pools, table, lengths))))


@pytest.mark.parametrize("mode", ["decode", "chunk", "stats", "window"])
def test_paged_flash_decode_matches_jax(mode):
    """A poisoned (-1 length) sequence comes out NaN; -1 table entries
    past each prefix are never followed."""
    lengths = [0, 200, 255] if mode == "stats" else [5, 200, -1]
    pools, table, lengths, rng = _paged_inputs(lengths)
    q = _rand(rng, B, H, *([4] if mode == "chunk" else []), D)
    jcache, tcache = _both(pools, table, lengths)
    kw = {"window": 32, "sinks": 4} if mode == "window" else {
        "softcap": 3.0}
    want = jax_paged.paged_flash_decode(jnp.asarray(q), jcache,
                                        return_stats=mode == "stats", **kw)
    got = paged.paged_flash_decode(torch.from_numpy(q), tcache,
                                   return_stats=mode == "stats", **kw)
    if mode != "stats":
        want, got = (want,), (got,)
        assert torch.isnan(got[0][2]).all()
    for mine, theirs in zip(got, want):
        _close(mine, theirs, relative=mode == "stats")


def test_paged_appends_and_from_dense_match_jax():
    """from_dense, a one-row append, then a 4-row chunk whose third row
    crosses into an unclaimed page: the rows before it land, it and the
    row after it do not, and the sequence's length turns -1."""
    rng = np.random.default_rng(1)
    k, v = _rand(rng, 2, HKV, 256, D), _rand(rng, 2, HKV, 256, D)
    lens = np.array([126, 200], np.int32)
    rows = [_rand(rng, 2, HKV, s, D) for s in (1, 1, 4, 4)]
    jcache = jax_paged.paged_from_dense(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jax_paged.PagePool(6), num_pages=6)
    tcache = paged.paged_from_dense(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(lens),
        paged.PagePool(6), num_pages=6)
    jcache = jax_paged.paged_append(jcache, *map(jnp.asarray, rows[:2]))
    tcache = paged.paged_append(tcache, *map(torch.from_numpy, rows[:2]))
    jcache = jax_paged.paged_append_chunk(jcache,
                                          *map(jnp.asarray, rows[2:]))
    tcache = paged.paged_append_chunk(tcache, *map(torch.from_numpy, rows[2:]))
    assert tcache.lengths.tolist() == [-1, 205]
    assert tcache.page_table.tolist() == [[0, -1], [1, 2]]
    for mine, theirs in zip(tcache, jcache):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_paged_sink_decode_matches_jax():
    pools, table, lengths, rng = _paged_inputs([5, 200, 255], seed=2)
    q = _rand(rng, B, H, D)
    jcache, tcache = _both(pools, table, lengths)
    kw = dict(window=32, sinks=4, theta=500.0, softcap=5.0)
    want = jax_paged.paged_sink_decode(jnp.asarray(q), jcache, **kw)
    _close(paged.paged_sink_decode(torch.from_numpy(q), tcache, **kw), want)


# ------------------------------------------------------- the key split
#
# On the card each sequence's keys are split across CTAs and merged by a
# second kernel; `decode.split_partials` and `decode.merge_splits` are that
# partition and merge in PyTorch.  Per-split partials merged must equal the
# JAX kernels (interpret mode) within f32 1e-5, on the edges of the split.
# The plan runs at an H100's 132 SMs, which at these shapes gives one split
# per key tile (64 columns).

SPLIT_CASES = {
    "length_0": dict(lens=[0, 64, 200]),
    "length_at_chunk_boundary": dict(lens=[64, 128, 192]),
    "full_capacity": dict(lens=[256, 256, 1]),
    "window_straddles_split": dict(lens=[100, 150, 256], window=40),
    "sinks_in_split_0_band_later": dict(lens=[200, 256, 130], window=100,
                                        sinks=4),
    "chunk_of_4": dict(lens=[4, 130, 256], s_new=4, softcap=2.0),
    "capacity_not_tile_multiple": dict(lens=[0, 77, 200], n=200),
    "return_stats": dict(lens=[0, 200, 255], stats=True),
}


def _split_plan(case):
    n, s_new = case.get("n", N), case.get("s_new", 1)
    return decode.split_plan(B, HKV, H // HKV * s_new, n, s_new,
                             case.get("window"), sms=132)


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_partials_merged_match_jax(name):
    case = SPLIT_CASES[name]
    n, s_new = case.get("n", N), case.get("s_new", 1)
    kw = {k: case[k] for k in ("window", "sinks", "softcap") if k in case}
    rng = np.random.default_rng(7)
    q = _rand(rng, B, H, *([s_new] if s_new > 1 else []), D)
    k, v = _rand(rng, B, HKV, n, D), _rand(rng, B, HKV, n, D)
    lens = np.asarray(case["lens"], np.int32)
    splits, chunk = _split_plan(case)
    assert splits > 1 and chunk % decode.KEY_TILE == 0
    if case.get("stats"):
        # the paged kernel's partials, through a table of whole pages
        table = np.arange(B * 2, dtype=np.int32).reshape(B, 2)
        pools = [x.reshape(B, HKV, 2, 128, D).transpose(0, 2, 1, 3, 4)
                 .reshape(B * 2, HKV, 128, D) for x in (k, v)]
        want = jax_paged.paged_flash_decode(
            jnp.asarray(q), jax_paged.PagedKV(*map(jnp.asarray, (
                *pools, table, lens))), return_stats=True)
    else:
        # JAX's caches hold a multiple of 128 rows: the rows past n it
        # gets are zeros past every length
        pad = ((0, 0), (0, 0), (0, -n % 128), (0, 0))
        jfn = jax_decode.flash_decode_chunk if s_new > 1 \
            else jax_decode.flash_decode
        want = jfn(*map(jnp.asarray, (q, np.pad(k, pad), np.pad(v, pad),
                                      lens)), **kw)
    tq, tk, tv, tl = map(torch.from_numpy, (q, k, v, lens))
    q4 = tq if s_new > 1 else tq[:, :, None]
    acc, m, l_ = decode.split_partials(q4, tk, tv, tl, scale=D ** -0.5,
                                       splits=splits, chunk=chunk, **kw)
    assert acc.shape == (B, H, s_new, splits, D)
    if case.get("stats"):
        for mine, theirs in zip(decode.merge_splits(acc, m, l_), want):
            _close(mine[:, :, 0], theirs, relative=True)
        return
    got = decode.merge_splits(acc, m, l_, dtype=torch.float32)
    _close(got if s_new > 1 else got[:, :, 0], want)


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_owner_partitions_the_visible_keys(name):
    """Every column a row sees has one owner split, which owns at most
    ``chunk`` columns from the band's tile on (split 0 also those below
    it), and no split past the plan is used."""
    case = SPLIT_CASES[name]
    n, s_new = case.get("n", N), case.get("s_new", 1)
    splits, chunk = _split_plan(case)
    lens = torch.tensor(case["lens"])
    owner = decode.split_owner(lens, n, s_new, case.get("window"), splits,
                               chunk)
    assert owner.shape == (B, n)
    assert int(owner.min()) >= 0 and int(owner.max()) < splits
    for b, length in enumerate(case["lens"]):
        first = 0 if "window" not in case else max(
            length - s_new - case["window"] + 1, 0) // 64 * 64
        for i in range(1, splits):
            cols = (owner[b] == i).nonzero().flatten()
            if len(cols):
                assert int(cols.min()) == first + i * chunk
                assert i == splits - 1 or len(cols) == chunk
        # the plan covers every column any row of the sequence sees
        assert length <= first + splits * chunk


def test_split_plan_sizes_the_grid():
    """Enough splits for four CTAs per SM, a whole number of key tiles
    each, none beyond the span; no split where the row blocks fill the
    SMs; a window bounds the span."""
    assert decode.split_plan(8, 4, 8, 4096, 1, None, sms=132) == (16, 256)
    assert decode.split_plan(8, 4, 8, 544, 1, None, sms=132) == (9, 64)
    assert decode.split_plan(8, 4, 8, 4096, 1, 512, sms=132) == (9, 64)
    assert decode.split_plan(2, 4, 2048, 4096, 256, None,
                             sms=132) == (1, 4096)
    assert decode.split_plan(1, 1, 8, 100, 1, None, sms=132) == (2, 64)


# ------------------------------------------------------------------ flash


@pytest.mark.parametrize("kw", [
    {"q_offset": 100, "kv_valid": 140},
    {"q_offset": 30, "kv_offset": 20, "kv_valid": 200}])
def test_flash_offsets_match_jax(kw):
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, *s) for s in ((2, 4, 40, D), (2, 2, 256, D),
                                        (2, 2, 256, D)))
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=True, **kw)
    _close(flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                           **kw), want)


# ------------------------------------------------------- generate, engine

SMALL = dict(vocab=43, dim=32, depth=2, num_q_heads=4, num_kv_heads=2,
             rope=True, softcap=20.0)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    model = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


PROMPT = np.random.default_rng(4).integers(0, 43, (2, 9)).astype(np.int32)
PROMPT_LENS = np.array([9, 4], np.int32)


def test_generate_greedy_tokens_equal_jax(pair):
    jmodel, params, model = pair
    want = np.asarray(jax_gen.generate(jmodel, params, jnp.asarray(PROMPT),
                                       steps=5))
    got = gen.generate(model, torch.from_numpy(PROMPT), steps=5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_ragged_and_paged_tokens_equal_jax(pair):
    jmodel, params, model = pair
    want = np.asarray(jax_gen.generate_ragged(
        jmodel, params, jnp.asarray(PROMPT), jnp.asarray(PROMPT_LENS),
        steps=5))
    got = gen.generate_ragged(model, PROMPT, PROMPT_LENS, steps=5)
    np.testing.assert_array_equal(got.numpy(), want)
    toks, caches, pools = gen.generate_paged(model, PROMPT, PROMPT_LENS,
                                             steps=5)
    np.testing.assert_array_equal(toks.numpy(), want)
    assert caches[0].lengths.tolist() == [14, 9]
    assert [p.used_pages for p in pools] == [2, 2]


def test_two_call_engine_streams_equal_jax_and_ragged(pair):
    jmodel, params, model = pair
    cfg = dict(num_pages=24, page_size=128, max_seq_len=256,
               max_decode_batch=4, max_prefill_rows=2, prefill_chunk=32,
               token_budget=80, step_mode="two_call")
    trace = synthetic_trace(5, vocab=43, seed=5, max_tokens=5,
                            prompt_len_min=4, prompt_len_max=40,
                            arrival_every=3)
    _, want = jax_engine.replay(jax_engine.ServingEngine(
        jmodel, params, jax_engine.EngineConfig(**cfg)), trace)
    eng = ServingEngine(model, EngineConfig(**cfg))
    _, got = replay(eng, trace)
    cfg["step_mode"] = "ragged"
    _, ragged = replay(ServingEngine(model, EngineConfig(**cfg)), trace)
    assert got == want == ragged
    assert all(len(got[e["id"]]) == 5 for e in trace)
    assert eng.nonfinite_events == 0


def test_generate_sampling_is_seeded(pair):
    model = pair[2]

    def sample(seed):
        return gen.generate(model, PROMPT, steps=6, temperature=0.9,
                            top_k=20, generator=torch.Generator().manual_seed(
                                seed))

    assert torch.equal(sample(7), sample(7))
    assert not torch.equal(sample(7), sample(8))
    with pytest.raises(ValueError):
        gen.generate(model, PROMPT, steps=2, temperature=0.5)
    with pytest.raises(ValueError, match="windowed"):
        gen.generate(model, PROMPT, steps=2, rolling_cache=True)
