"""The port's model and serving engine against the JAX package, on the
CPU, with the JAX package's flax params converted by
`models.convert.params_from_jax`.

Tolerance for logits: 2e-4 max abs in f32.  The two frameworks sum the
projections and the attention in different orders, and the error grows
through two blocks and a 256-wide head; greedy serving must give equal
token streams, which the engine test checks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu import engine as jax_engine
from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu_torch import api, cli
from attention_tpu_torch.device import NoCudaDeviceError
from attention_tpu_torch.engine import (
    EngineConfig,
    ServingEngine,
    replay,
    synthetic_trace,
)
from attention_tpu_torch.models import TinyDecoder, params_from_jax

# the __graft_entry__.entry() model, in f32
ENTRY = dict(vocab=256, dim=256, depth=2, num_q_heads=8, num_kv_heads=2,
             rope=True, softcap=50.0)
SMALL = dict(vocab=43, dim=32, depth=2, num_q_heads=4, num_kv_heads=2,
             rope=True, softcap=20.0)
ENGINE = dict(num_pages=24, page_size=128, max_seq_len=256,
              max_decode_batch=4, max_prefill_rows=2, prefill_chunk=32,
              token_budget=80, watermark_pages=1)


def _pair(cfg, seq=8):
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **cfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, seq), jnp.int32))["params"]
    model = TinyDecoder(dtype=torch.float32, device="cpu", **cfg)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


def test_tiny_decoder_logits_match_jax():
    jmodel, params, model = _pair(ENTRY, seq=64)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 64))
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(tokens, jnp.int32)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape == (2, 64, 256)
    assert np.abs(got - want).max() <= 2e-4


@pytest.fixture(scope="module")
def small_pair():
    return _pair(SMALL)


def test_engine_greedy_tokens_equal_jax(small_pair):
    jmodel, params, model = small_pair
    trace = synthetic_trace(6, vocab=43, seed=3, max_tokens=6,
                            prompt_len_min=4, prompt_len_max=40,
                            shared_prefix_len=129, shared_count=3,
                            arrival_every=4)
    _, want = jax_engine.replay(jax_engine.ServingEngine(
        jmodel, params, jax_engine.EngineConfig(**ENGINE)), trace)
    eng = ServingEngine(model, EngineConfig(**ENGINE))
    summary, got = replay(eng, trace)
    assert got == want
    assert all(len(got[e["id"]]) == 6 for e in trace)
    assert eng.model_calls == sum(
        1 for s in eng.metrics.steps if s.decode_tokens or s.prefill_tokens)
    assert summary["prefix_cached_tokens"] > 0 and eng.nonfinite_events == 0


def test_engine_sampled_streams_are_deterministic(small_pair):
    model = small_pair[2]
    trace = synthetic_trace(5, vocab=43, seed=4, max_tokens=5,
                            temperature=0.8)
    runs = [replay(ServingEngine(model, EngineConfig(**ENGINE)), trace)[1]
            for _ in range(2)]
    assert runs[0] == runs[1]
    greedy = replay(ServingEngine(model, EngineConfig(**ENGINE)),
                    [dict(e, temperature=0.0) for e in trace])[1]
    assert runs[0] != greedy


def test_unported_engine_modes_raise(small_pair):
    model = small_pair[2]
    with pytest.raises(NotImplementedError):
        ServingEngine(model, EngineConfig(**ENGINE, mesh_shards=2))
    with pytest.raises(NotImplementedError):
        TinyDecoder(device="cpu", cp_axis="cp")


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 16), np.float32)
    with pytest.raises(NoCudaDeviceError):
        api.attention(x, x, x)
    with pytest.raises(NoCudaDeviceError):
        TinyDecoder(**SMALL)
    assert cli.main(["generate", str(tmp_path / "t.bin"), "--m", "8",
                     "--n", "8", "--dk", "8", "--dv", "8"]) == 0
    with pytest.raises(NoCudaDeviceError):
        cli.main(["run", str(tmp_path / "t.bin")])
    with pytest.raises(NoCudaDeviceError):
        cli.main(["serve-sim", "--num-requests", "1"])


def test_xla_impl_matches_jax_and_refuses_kernel_caches(small_pair):
    """``impl="xla"``: the uncached logits (windowed too) and greedy
    `generate` on the dense cache against JAX's "xla" model on the same
    params; every cache that runs only the kernels (rolling, ragged,
    paged, int8, the packed step) refuses with JAX's message."""
    from attention_tpu.models import generate as jax_generate
    from attention_tpu_torch.models import decode as gen
    from attention_tpu_torch.ops.paged import PagePool, paged_from_dense

    _, params, flash = small_pair
    tokens = np.random.default_rng(5).integers(0, 43, (2, 40))
    for band in ({}, dict(window=8, attn_sinks=2)):
        jxla = JaxDecoder(impl="xla", dtype=jnp.float32, **SMALL, **band)
        xla = TinyDecoder(impl="xla", dtype=torch.float32, device="cpu",
                          **SMALL, **band)
        xla.load_state_dict(flash.state_dict())
        want = np.asarray(jxla.apply({"params": params},
                                     jnp.asarray(tokens, jnp.int32)))
        with torch.no_grad():
            got = xla(torch.from_numpy(tokens)).numpy()
        assert np.abs(got - want).max() <= 2e-4
        np.testing.assert_array_equal(
            gen.generate(xla, tokens[:, :12], steps=6).numpy(),
            np.asarray(jax_generate(jxla, params,
                                    jnp.asarray(tokens[:, :12], jnp.int32),
                                    steps=6)))
    prompt = torch.from_numpy(tokens[:, :12])
    with torch.no_grad():
        _, dense = gen.prefill(xla, prompt, 128)
        step = prompt[:, :1]
        for kind, caches in (
                ("rolling-cache", xla.init_caches(2, 0, rolling=True)),
                ("ragged-cache", tuple(gen.RaggedKVCache.from_prefill(
                    c, torch.full((2,), 12)) for c in dense)),
                ("quantized-cache", tuple(c.quantize() for c in dense)),
                ("paged-cache", tuple(paged_from_dense(
                    c.k, c.v, [12, 12], PagePool(2), num_pages=2)
                    for c in dense))):
            with pytest.raises(ValueError, match=f"impl 'xla' has no "
                                                 f"{kind} path"):
                xla(step, caches)
    with pytest.raises(ValueError, match="int8_cache requires impl='flash'"):
        gen.generate(xla, prompt, steps=2, int8_cache=True)
    with pytest.raises(ValueError, match="impl"):
        TinyDecoder(impl="mosaic", device="cpu")
