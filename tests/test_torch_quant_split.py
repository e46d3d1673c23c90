"""The quantized decode kernels' key split against the JAX package, on the
CPU.

On the card each sequence's keys are split across CTAs and the splits'
partials merged by a second kernel, for the int8, the feature-dim int4
and the token-paired int4 caches alike.  `quant.split_partials` is what
each split's CTA computes (the plain version cut to the columns
`decode.split_owner` gives it) and `decode.merge_splits` the merge; merged,
they must give the JAX package's output (its Pallas kernels in interpret
mode) on the edges of the split.  The plan runs at an H100's 132 SMs,
which at these shapes gives one split per 64-token key tile.

Tolerance: `reference.mismatch`'s bf16 limit, as tests/test_torch_quant.py
holds the unsplit outputs: both sides round q, P and the output to bf16 at
the same points and differ in summation order and exp2, so one output ulp
apart at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.ops import quant as jq
from attention_tpu_torch.models import quant_cache_from_jax
from attention_tpu_torch.ops import decode, quant
from attention_tpu_torch.ops.reference import mismatch

B, H, HKV, N, D = 3, 4, 2, 256, 16
SMS = 132
ENTRIES = {
    "int8": (jq.quantize_kv, jq.flash_decode_quantized),
    "int8_chunk": (jq.quantize_kv, jq.flash_decode_quantized_chunk),
    "int4": (jq.quantize_kv_int4, jq.flash_decode_int4),
    "int4_tok": (jq.quantize_kv_int4_tok, jq.flash_decode_int4_tok),
}
# the split's edges, one token per sequence
ONE_TOKEN = {
    "length_0": dict(lens=[0, 64, 200]),
    "window_straddles_split": dict(lens=[100, 150, 256], window=40),
    "sinks_in_split_0_band_later": dict(lens=[200, 256, 130], window=100,
                                        sinks=4),
    "split_sees_nothing": dict(lens=[1, 5, 70], softcap=2.0),
}
# a chunk of 4 tokens per sequence: sequence 0's first rows see nothing
CHUNK = {
    "chunk_of_4": dict(lens=[4, 130, 256], softcap=2.0),
    "chunk_window_straddles_split": dict(lens=[3, 150, 256], window=40,
                                         sinks=4),
    "chunk_split_sees_nothing": dict(lens=[2, 7, 66]),
}
CASES = [(e, c) for e in ("int8", "int4", "int4_tok") for c in ONE_TOKEN] \
    + [("int8_chunk", c) for c in CHUNK]


def _inputs(entry, case, seed):
    """(JAX cache, port cache, q, lens, kwargs, S) for one case."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B, HKV, N, D)).astype(np.float32)
            for _ in range(2))
    s_new = 4 if entry == "int8_chunk" else 1
    q = rng.standard_normal((B, H, *([s_new] if s_new > 1 else []),
                             D)).astype(np.float32)
    jcache = ENTRIES[entry][0](jnp.asarray(k), jnp.asarray(v))
    spec = (CHUNK if s_new > 1 else ONE_TOKEN)[case]
    kw = {k_: spec[k_] for k_ in ("window", "sinks", "softcap")
          if k_ in spec}
    return (jcache, quant_cache_from_jax(jax.device_get(jcache)), q,
            np.asarray(spec["lens"], np.int32), kw, s_new)


@pytest.mark.parametrize("entry,case", CASES,
                         ids=[f"{e}-{c}" for e, c in CASES])
def test_split_partials_merged_match_jax(entry, case):
    jcache, cache, q, lens, kw, s_new = _inputs(entry, case, 11)
    want = ENTRIES[entry][1](jnp.asarray(q), jcache, jnp.asarray(lens),
                             **kw)
    tq, tl = torch.from_numpy(q), torch.from_numpy(lens)
    plan = quant.launch_plan(tq, cache, kw.get("window"), sms=SMS)
    assert plan["splits"] > 1 and plan["chunk"] % decode.KEY_TILE == 0
    q4 = tq if s_new > 1 else tq[:, :, None]
    acc, m, l_ = quant.split_partials(q4, cache, tl, scale=D ** -0.5,
                                      splits=plan["splits"],
                                      chunk=plan["chunk"], **kw)
    assert acc.shape == (B, H, s_new, plan["splits"], D)
    if "sees_nothing" in case:
        # some split of some row is empty: max -inf, sum 0, no output
        empty = m == float("-inf")
        assert empty.any() and (l_[empty] == 0).all()
        assert (acc[empty] == 0).all()
    got = decode.merge_splits(acc, m, l_, dtype=torch.bfloat16)
    got = got if s_new > 1 else got[:, :, 0]
    want = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert got.shape == want.shape
    assert mismatch(got, want)[1] <= 1
    # merged, the partials are the plain version's output as well
    plain = quant.quant_decode_plain(tq, cache, tl, **kw)
    assert mismatch(got, plain)[1] <= 1
    if lens[0] == 0:
        assert (got[0] == 0).all()


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_launch_plan_partitions_the_visible_tokens(entry):
    """The quantized launch's (splits, chunk) cover every column a row can
    see, each owned by one split that owns at most ``chunk`` columns from
    the band's tile on; the token-paired capacity counts tokens (two a
    packed row), not packed rows; KG = 4 where a kv head's rows fit one
    16-row tile."""
    for case in ONE_TOKEN if entry != "int8_chunk" else CHUNK:
        _, cache, q, lens, kw, s_new = _inputs(entry, case, 12)
        tq = torch.from_numpy(q)
        plan = quant.launch_plan(tq, cache, kw.get("window"), sms=SMS)
        assert cache.capacity == N
        if entry == "int4_tok":
            assert cache.k_q.shape[2] == N // 2
        assert (plan["splits"], plan["chunk"]) == decode.split_plan(
            B, HKV, H // HKV * s_new, N, s_new, kw.get("window"), sms=SMS)
        rows = H // HKV * s_new
        assert plan["kg"] == (4 if rows <= 16 else 1)
        assert plan["grid"] == [1, B * HKV, plan["splits"]]
        owner = decode.split_owner(torch.from_numpy(lens), N, s_new,
                                   kw.get("window"), plan["splits"],
                                   plan["chunk"])
        assert owner.shape == (B, N) and int(owner.max()) < plan["splits"]
        for b, length in enumerate(lens.tolist()):
            first = 0 if "window" not in kw else max(
                length - s_new - kw["window"] + 1, 0) // 64 * 64
            assert length <= first + plan["splits"] * plan["chunk"]
            for i in range(1, plan["splits"]):
                cols = (owner[b] == i).nonzero().flatten()
                if len(cols):
                    assert int(cols.min()) == first + i * plan["chunk"]
                    assert len(cols) == plan["chunk"] or \
                        i == plan["splits"] - 1


def test_launch_plan_key_groups_follow_the_rows():
    """One-token decode at group 8 takes KG = 4 (16-row CTAs); a chunk of
    4 at group 8 (32 rows) keeps 64-row blocks."""
    cache = quant.quantize_kv(*(torch.zeros(8, 4, 4096, 128),) * 2)
    one = quant.launch_plan(torch.zeros(8, 32, 128), cache, sms=SMS)
    assert one == dict(splits=16, chunk=256, kg=4, grid=[1, 32, 16])
    chunk = quant.launch_plan(torch.zeros(8, 32, 4, 128), cache, sms=SMS)
    assert chunk["kg"] == 1 and chunk["grid"][0] == 1
    tok = quant.quantize_kv_int4_tok(*(torch.zeros(8, 4, 4096, 128),) * 2)
    assert quant.launch_plan(torch.zeros(8, 32, 128), tok, sms=SMS) == one
