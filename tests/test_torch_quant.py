"""The port's quantized KV caches against the JAX package, on the CPU.

Inputs come from numpy seeds (unit-normal, so that both signs of every
nibble occur) and go through both packages: the JAX side runs its
Pallas kernels in interpret mode, the port's wrappers their plain
PyTorch versions because the tensors lie on the CPU.  Tolerances:

* quantized values: bit-equal; scales equal once
  `quant_cache_from_jax` has taken them across (the same f32 division);
* decode outputs (bf16 on both sides): `reference.mismatch`, 1.6e-2 of
  the value plus 2^-6 of its row's rms, capped at 2e-2.  Both sides
  round q, P and the output to bf16 at the same points and differ only
  in summation order and exp2, so one output ulp apart at most;
* f32 model logits against JAX's, and the chunk-verify logits against
  three one-token steps: 1e-4, the JAX package's own limit for the
  latter (tests/test_quant.py:146).  The attention output is bf16 on
  both sides, rounded at the same points, so the logits differ by f32
  summation order unless a sum lands on a bf16 rounding boundary; on
  these seeded inputs none does (about 1e-6 apart, logits of magnitude
  2.6).  Greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import decode as jax_gen
from attention_tpu.ops import quant as jq
from attention_tpu_torch.models import TinyDecoder, params_from_jax, \
    quant_cache_from_jax
from attention_tpu_torch.models import decode as gen
from attention_tpu_torch.ops import quant
from attention_tpu_torch.ops.reference import mismatch

B, H, HKV, N, D = 3, 4, 2, 256, 16
LOGITS_ATOL = 1e-4
FORMATS = {
    "int8": (jq.quantize_kv, quant.quantize_kv),
    "int4": (jq.quantize_kv_int4, quant.quantize_kv_int4),
    "int4_tok": (jq.quantize_kv_int4_tok, quant.quantize_kv_int4_tok),
}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _caches(fmt, seed, dtype=jnp.float32):
    """The same K/V quantized by both packages: (JAX cache, port cache
    taken across, port cache quantized by the port)."""
    rng = np.random.default_rng(seed)
    k, v = _rand(rng, B, HKV, N, D), _rand(rng, B, HKV, N, D)
    jfn, tfn = FORMATS[fmt]
    jcache = jfn(jnp.asarray(k, dtype), jnp.asarray(v, dtype))
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    mine = tfn(*(torch.from_numpy(x).to(tdt) for x in (k, v)))
    return jcache, quant_cache_from_jax(jax.device_get(jcache)), mine, rng


def _held(got: torch.Tensor, want) -> None:
    want = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert mismatch(got, want)[1] <= 1


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_quantize_bit_equal_jax(fmt, dtype):
    _, theirs, mine, _ = _caches(fmt, 0, dtype)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("index", [100, 254], ids=["in_range", "overflow"])
def test_update_quantized_kv_matches_jax(index):
    """Three rows at ``index``: past the capacity they land clamped at
    the end, with NaN scales."""
    jcache, _, mine, rng = _caches("int8", 1)
    k_new, v_new = _rand(rng, B, HKV, 3, D), _rand(rng, B, HKV, 3, D)
    want = quant_cache_from_jax(jax.device_get(jq.update_quantized_kv(
        jcache, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(index))))
    got = quant.update_quantized_kv(mine, torch.from_numpy(k_new),
                                    torch.from_numpy(v_new), index)
    for a, b in zip(got, want):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert got.k_scale[:, :, -3:].isnan().all() == (index == 254)
    # the poisoned rows make every output that reads them NaN
    q = _rand(rng, B, H, D)
    out = quant.flash_decode_quantized(torch.from_numpy(q), got, index + 1)
    assert out.isnan().all() == (index == 254)


DECODE_CASES = {"plain": {}, "softcap": {"softcap": 2.0},
                "window_sinks": {"window": 32, "sinks": 4}}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_flash_decode_quantized_matches_jax(case):
    jcache, tcache, _, rng = _caches("int8", 2)
    q = _rand(rng, B, H, D)
    lens = np.array([0, 130, 256], np.int32)
    kw = DECODE_CASES[case]
    want = jq.flash_decode_quantized(jnp.asarray(q), jcache,
                                     jnp.asarray(lens), **kw)
    got = quant.flash_decode_quantized(torch.from_numpy(q), tcache,
                                       torch.from_numpy(lens), **kw)
    _held(got, want)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("case", ["softcap", "window_sinks"])
def test_flash_decode_quantized_chunk_matches_jax(case):
    """S = 4; sequence 0 holds 3 rows, so its first row sees nothing."""
    jcache, tcache, _, rng = _caches("int8", 3)
    q = _rand(rng, B, H, 4, D)
    lens = np.array([3, 130, 256], np.int32)
    kw = DECODE_CASES[case]
    want = jq.flash_decode_quantized_chunk(jnp.asarray(q), jcache,
                                           jnp.asarray(lens), **kw)
    got = quant.flash_decode_quantized_chunk(torch.from_numpy(q), tcache,
                                             torch.from_numpy(lens), **kw)
    _held(got, want)
    assert (got[0, :, 0] == 0).all()


@pytest.mark.parametrize("case", ["softcap", "window_sinks"])
@pytest.mark.parametrize("fmt", ["int4", "int4_tok"])
def test_flash_decode_int4_matches_jax(fmt, case):
    """An empty sequence and an odd length (for the token-paired layout
    a low nibble whose partner is masked)."""
    jcache, tcache, _, rng = _caches(fmt, 4)
    q = _rand(rng, B, H, D)
    lens = np.array([0, 117, 256], np.int32)
    kw = DECODE_CASES[case]
    jfn, fn = {"int4": (jq.flash_decode_int4, quant.flash_decode_int4),
               "int4_tok": (jq.flash_decode_int4_tok,
                            quant.flash_decode_int4_tok)}[fmt]
    want = jfn(jnp.asarray(q), jcache, jnp.asarray(lens), **kw)
    got = fn(torch.from_numpy(q), tcache, torch.from_numpy(lens), **kw)
    _held(got, want)
    assert (got[0] == 0).all()


def test_quant_ops_reject_what_they_do_not_take():
    _, cache, _, rng = _caches("int8", 5)
    q = torch.from_numpy(_rand(rng, B, H, D))
    with pytest.raises(ValueError, match="inconsistent"):
        quant.flash_decode_quantized(q[..., :8], cache, 10)
    with pytest.raises(ValueError, match="B,H,S,d"):
        quant.flash_decode_quantized_chunk(q, cache, 10)
    with pytest.raises(TypeError):
        quant.flash_decode_int4(q, cache, 10)
    with pytest.raises(ValueError, match="sinks"):
        quant.flash_decode_quantized(q, cache, 10, sinks=4)
    with pytest.raises(ValueError, match="256"):
        quant.quantize_kv_int4_tok(*(torch.zeros(1, 1, 384, D),) * 2)
    with pytest.raises(ValueError, match="even"):
        quant.quantize_kv_int4(*(torch.zeros(1, 1, 128, 15),) * 2)


# ------------------------------------------------------------------ model

SMALL = dict(vocab=43, dim=32, depth=2, num_q_heads=4, num_kv_heads=2,
             rope=True, softcap=20.0)
TOKENS = np.random.default_rng(6).integers(0, 43, (2, 9)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    model = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


def _prefilled(pair, n):
    """Both models prefilled on the first ``n`` tokens, the caches then
    quantized: (JAX caches, port caches)."""
    jmodel, params, model = pair
    jc = jmodel.init_caches(batch=2, capacity=128)
    _, jc = jmodel.apply({"params": params}, jnp.asarray(TOKENS[:, :n]), jc)
    with torch.no_grad():
        _, tc = model(torch.from_numpy(TOKENS[:, :n]).long(),
                      model.init_caches(2, 128))
    return (tuple(c.quantize() for c in jc),
            tuple(c.quantize() for c in tc))


def _step(pair, toks, jc, tc):
    jmodel, params, model = pair
    jl, jc = jmodel.apply({"params": params}, jnp.asarray(toks), jc)
    with torch.no_grad():
        tl, tc = model(torch.from_numpy(toks).long(), tc)
    return np.asarray(jl), tl, jc, tc


def test_int8_cache_teacher_forced_logits_match_jax(pair):
    jc, tc = _prefilled(pair, 5)
    for t in range(5, 9):
        want, got, jc, tc = _step(pair, TOKENS[:, t:t + 1], jc, tc)
        assert np.abs(got.numpy() - want).max() <= LOGITS_ATOL
    assert tc[0].length == 9 and int(jc[0].length) == 9


def test_int8_cache_chunk_verify_matches_jax_and_steps(pair):
    jc, tc = _prefilled(pair, 2)
    want, chunk, _, _ = _step(pair, TOKENS[:, 2:5], jc, tc)
    assert chunk.shape == (2, 3, 43)
    assert np.abs(chunk.numpy() - want).max() <= LOGITS_ATOL
    _, tc = _prefilled(pair, 2)
    for i in range(3):
        _, step, _, tc = _step(pair, TOKENS[:, 2 + i:3 + i], jc, tc)
        assert (step[:, 0] - chunk[:, i]).abs().max() <= LOGITS_ATOL


def test_generate_int8_cache_tokens_equal_jax(pair):
    jmodel, params, model = pair
    want = np.asarray(jax_gen.generate(jmodel, params, jnp.asarray(TOKENS),
                                       steps=6, int8_cache=True))
    got = gen.generate(model, TOKENS, steps=6, int8_cache=True)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="exclusive"):
        gen.generate(model, TOKENS, steps=2, int8_cache=True,
                     rolling_cache=True)
