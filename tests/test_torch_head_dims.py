"""Head dims past 128 and off the powers of two, the port against the JAX
package on the CPU: the flash backward, the three quantized decode
layouts and a small model with Gemma 2's head dim of 256.

Inputs come from numpy seeds and reach both sides as the same arrays: the
JAX side runs its Pallas kernels in interpret mode, the port's wrappers
their plain PyTorch versions because the tensors lie on the CPU (the
kernels behind them on the card take every head dim up to 256,
`tests/test_torch_cuda.py -k head_dim`).  Tolerances, with their reasons:

* float32 gradients of `flash_attention_diff` (JAX's `jax.grad` through
  its own): all three within 1e-5 max abs, test_torch_train.py's f32
  bar, and dV = Pᵀ·dO also within `reference.grad_mismatch`'s f32 limit
  (2^-16 of the value and of the row's rms, plus 2^-20 of the tensor's
  rms: the same arithmetic in another order).  dQ and dK are not held to
  that limit: a query row that sees one key (the first row of a causal
  call, a one-row document) has dS = P·(dP - delta) cancelling to a
  gradient near 0, and both sides keep float32 residues of about 1e-6
  there (measured against a float64 witness: the port 0.8e-6 to 1.5e-6,
  JAX 0.5e-6 to 1.5e-6, at d 16 as at 256), above the limit's 2^-20 of
  the tensor's rms (2e-7) but far under 1e-5.
* bfloat16 gradients of `flash_backward` on JAX's own forward:
  `grad_mismatch`'s bf16 limit (one output ulp, a P or dS value rounded
  apart, the cancelled rows).
* quantized values bit-equal; decode outputs (bf16 on both sides)
  within `reference.mismatch`; each within the JAX package's own budget
  of the dense decode on the unquantized caches, int8 0.02
  (tests/test_quant.py:51) and int4 0.15 (:331), on sequences of 100
  rows or more.
* the f32 model: logits 1e-4 (test_torch_quant.py's bar), one train
  step's loss 1e-5 and gradients within `grad_mismatch`'s f32 limit
  (both sides on the CPU; the card's float32 products part from the
  CPU's past that limit at this width, so `chip_smoke.py` phase 8 holds
  the card's gradients to float64 ones), the greedy
  `generate(int8_cache=True)` stream equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import decode as jax_gen
from attention_tpu.models import train as jax_train
from attention_tpu.ops import decode as jax_decode
from attention_tpu.ops import flash_bwd as jax_bwd
from attention_tpu.ops import quant as jq
from attention_tpu.ops.flash_vjp import _flash_fwd_impl as jax_fwd_impl
from attention_tpu.ops.flash_vjp import flash_attention_diff as jax_diff
from attention_tpu_torch.models import TinyDecoder, params_from_jax, \
    quant_cache_from_jax
from attention_tpu_torch.models import decode as gen
from attention_tpu_torch.models.train import loss_fn
from attention_tpu_torch.ops import flash_bwd, quant
from attention_tpu_torch.ops.flash_vjp import flash_attention_diff
from attention_tpu_torch.ops.reference import grad_mismatch, mismatch

F32_TOL = 1e-5
LOGITS_ATOL = 1e-4
LOSS_ATOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------- backward

BWD_DIMS = (96, 160, 256)
SEGMENTS = np.repeat(np.arange(3, dtype=np.int32), [50, 1, 77])
BWD_CASES = {
    "softcap50": dict(causal=True, softcap=50.0),
    "window32_sinks2": dict(causal=True, window=32, sinks=2),
    "segments": dict(causal=True, q_segment_ids=SEGMENTS,
                     kv_segment_ids=SEGMENTS),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
@pytest.mark.parametrize("d", BWD_DIMS)
def test_diff_gradients_match_jax_grad(d, name):
    """Gradients of sum(out·w) through both `flash_attention_diff`s, f32,
    2 q / 1 kv heads, m = n = 128, causal: with softcap 50, under a
    window of 32 with 2 sinks, and over segment ids of documents of 50,
    1 and 77 rows."""
    rng = np.random.default_rng(d)
    q, w = _rand(rng, 2, 128, d), _rand(rng, 2, 128, d)
    k, v = _rand(rng, 1, 128, d), _rand(rng, 1, 128, d)
    kw = BWD_CASES[name]

    def loss(q, k, v):
        return jnp.sum(jax_diff(q, k, v, **kw) * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    tkw = {key: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
           for key, x in kw.items()}
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (flash_attention_diff(*qkv, **tkw) * torch.from_numpy(w)).sum(
    ).backward()
    for t, theirs in zip(qkv, want):
        assert (t.grad - _torch(theirs)).abs().max().item() <= F32_TOL
    assert grad_mismatch(qkv[2].grad, _torch(want[2]))[1] <= 1


@pytest.mark.parametrize("path", ["fused", "two_kernel"])
def test_bf16_backward_matches_jax_at_head_dim_256(monkeypatch, path):
    """`flash_backward` in bf16 at d 256 (2 q / 1 kv heads, m = n = 128,
    causal, softcap 50) on JAX's forward, against JAX's fused kernel and
    its dQ + dK/dV pair in interpret mode."""
    monkeypatch.setattr(jax_bwd, "_FORCE_TWO_KERNEL", path == "two_kernel")
    rng = np.random.default_rng(256)
    q, k, v = (jnp.asarray(_rand(rng, h, 128, 256), jnp.bfloat16)
               for h in (2, 1, 1))
    scale = 256 ** -0.5
    out, lse = jax_fwd_impl(q, k, v, scale, True, None, softcap=50.0)
    dout = jnp.asarray(_rand(rng, *out.shape), jnp.bfloat16)
    want = jax.jit(functools.partial(
        jax_bwd.flash_backward, scale=scale, causal=True, softcap=50.0,
        interpret=True))(q, k, v, out, lse, dout)
    bf = torch.bfloat16
    got = flash_bwd.flash_backward(
        *(_torch(x, bf) for x in (q, k, v, out)), _torch(lse),
        _torch(dout, bf), scale=scale, causal=True, softcap=50.0)
    for mine, theirs in zip(got, want):
        theirs = _torch(theirs, bf)
        assert mine.dtype == bf and mine.shape == theirs.shape
        assert grad_mismatch(mine, theirs)[1] <= 1


def test_backward_plans_at_wide_head_dims():
    """The body a CUDA call would take, from the shapes: "fma" at every
    head dim but bf16 at 128, whatever the dtype; the cap at 256."""
    for d in (96, 128, 160, 256):
        strides = [2 * 128 * d, 128 * d, d] * 4
        for dtype in (torch.bfloat16, torch.float32):
            assert flash_bwd.flash_bwd_body(dtype, d, d, strides, [0] * 4) == (
                "wgmma" if d == 128 and dtype == torch.bfloat16 else "fma")
    assert flash_bwd.MAX_HEAD_DIM == 256


# --------------------------------------------------------------- quantized

QUANT_DIMS = (16, 40, 96, 256)
FORMATS = {
    "int8": (jq.quantize_kv, quant.quantize_kv, jq.flash_decode_quantized,
             quant.flash_decode_quantized, 0.02),
    "int4": (jq.quantize_kv_int4, quant.quantize_kv_int4,
             jq.flash_decode_int4, quant.flash_decode_int4, 0.15),
    "int4_tok": (jq.quantize_kv_int4_tok, quant.quantize_kv_int4_tok,
                 jq.flash_decode_int4_tok, quant.flash_decode_int4_tok,
                 0.15),
}
LENS = np.array([117, 256], np.int32)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("d", QUANT_DIMS)
def test_quantized_decode_matches_jax(d, fmt):
    """2 sequences of 117 (an odd length: the token-paired layout's last
    low nibble has its partner masked) and 256 rows, 4 q / 2 kv heads,
    softcap 30: the port quantizes the JAX package's bits, its decode on
    JAX's cache taken across matches JAX's, and both lie within JAX's
    budget of the dense decode on the unquantized caches."""
    jquant, tquant, jdecode, tdecode, budget = FORMATS[fmt]
    rng = np.random.default_rng(d)
    k, v = _rand(rng, 2, 2, 256, d), _rand(rng, 2, 2, 256, d)
    q = _rand(rng, 2, 4, d)
    jcache = jquant(jnp.asarray(k), jnp.asarray(v))
    theirs = quant_cache_from_jax(jax.device_get(jcache))
    for a, b in zip(tquant(torch.from_numpy(k), torch.from_numpy(v)),
                    theirs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert theirs.head_dim == d
    want = jdecode(jnp.asarray(q), jcache, jnp.asarray(LENS), softcap=30.0)
    got = tdecode(torch.from_numpy(q), theirs, torch.from_numpy(LENS),
                  softcap=30.0)
    want = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert mismatch(got, want)[1] <= 1
    dense = np.asarray(jax_decode.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENS),
        softcap=30.0), np.float32)
    assert np.abs(got.float().numpy() - dense).max() < budget


def test_quantized_plans_at_wide_and_odd_head_dims():
    """The launch a call makes: at d 256, at head dims whose rows are
    not whole 16-byte units (int8 d 40 and 42, int4 d 80 and 16) the key
    split and groups as at d 128; an odd int4 head dim and one past 256
    refused."""
    for d, fmt in ((256, "int8"), (256, "int4"), (256, "int4_tok"),
                   (40, "int8"), (80, "int4"), (42, "int8"), (16, "int4")):
        cache = FORMATS[fmt][1](*(torch.zeros(8, 4, 4096, d),) * 2)
        assert cache.head_dim == d
        plan = quant.launch_plan(torch.zeros(8, 32, d), cache, sms=132)
        assert plan == dict(splits=16, chunk=256, kg=4, grid=[1, 32, 16])
    wide = quant.quantize_kv(*(torch.zeros(1, 1, 64, 257),) * 2)
    with pytest.raises(ValueError, match="up to 256"):
        quant.launch_plan(torch.zeros(1, 2, 257), wide, sms=132)
    odd = quant.Int4TokKV(torch.zeros(1, 1, 64, 33, dtype=torch.int8),
                          torch.ones(1, 1, 128),
                          torch.zeros(1, 1, 64, 33, dtype=torch.int8),
                          torch.ones(1, 1, 128))
    with pytest.raises(ValueError, match="even"):
        quant.flash_decode_int4_tok(torch.zeros(1, 2, 33), odd, 10)


# ------------------------------------------------------------------- model

# Gemma 2's head dim (256) at a CPU test's width: 2 q / 1 kv heads of 256
D256_SMALL = dict(vocab=256, dim=512, depth=2, num_q_heads=2,
                  num_kv_heads=1, rope=True, softcap=50.0)
TOKENS = np.random.default_rng(25).integers(0, 256, (2, 17)).astype(
    np.int32)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX package's model, its params, logits on TOKENS, loss and
    gradients on them, and its greedy int8-cache stream."""
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **D256_SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    batch = jnp.asarray(TOKENS)
    logits = jax.jit(jmodel.apply)({"params": params}, batch)
    loss, grads = jax.jit(jax.value_and_grad(jax_train.loss_fn),
                          static_argnums=1)(params, jmodel, batch)
    stream = jax_gen.generate(jmodel, params, batch[:, :9], steps=6,
                              int8_cache=True)
    return dict(params=params_from_jax(jax.device_get(params)),
                logits=np.asarray(logits), loss=float(loss),
                grads=params_from_jax(jax.device_get(grads)),
                stream=np.asarray(stream))


@pytest.fixture(scope="module")
def model(jax_model):
    model = TinyDecoder(dtype=torch.float32, device="cpu", **D256_SMALL)
    model.load_state_dict(jax_model["params"])
    assert model.head_dim == 256
    return model


def test_head_dim_256_model_logits_match_jax(model, jax_model):
    with torch.no_grad():
        got = model(torch.from_numpy(TOKENS).long())
    assert np.abs(got.numpy() - jax_model["logits"]).max() <= LOGITS_ATOL


def test_head_dim_256_train_step_matches_jax(model, jax_model):
    model.zero_grad()
    loss = loss_fn(model, torch.from_numpy(TOKENS).long())
    loss.backward()
    assert abs(loss.item() - jax_model["loss"]) <= LOSS_ATOL
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(jax_model["grads"])
    for name, want in jax_model["grads"].items():
        assert grad_mismatch(grads[name].grad, want)[1] <= 1, name
    model.zero_grad()


def test_head_dim_256_int8_generate_equals_jax(model, jax_model):
    got = gen.generate(model, TOKENS[:, :9], steps=6, int8_cache=True)
    np.testing.assert_array_equal(got.numpy(), jax_model["stream"])
