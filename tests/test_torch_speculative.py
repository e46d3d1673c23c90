"""The port's speculative decoding against the JAX package, on the CPU.

The same flax params (converted by `params_from_jax`) and numpy prompts
go through `attention_tpu.models.speculative.generate_speculative`
(Pallas in interpret mode) and the port's (the plain versions).  Greedy
streams must be equal to JAX's on every cache type, with a useless
draft and a perfect one, and equal to greedy `generate`.  Sampling draws
from a `torch.Generator`, so its streams are not JAX's: at a temperature
near 0 it must give the greedy stream, and its emitted tokens must be
distributed as target-only sampling (a chi-square test on a vocabulary
of 11, deterministic seeds, at a significance of 0.1%).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import generate as jax_generate
from attention_tpu.models.speculative import \
    generate_speculative as jax_speculative
from attention_tpu_torch.models import TinyDecoder, generate, \
    generate_speculative, params_from_jax
from attention_tpu_torch.models.speculative import CACHE_TYPES


@functools.lru_cache(maxsize=4)
def _models(vocab=41, seed=0, **kw):
    """(jax target, params, jax draft, params, target, draft, prompt):
    JAX's test geometry, the target at dim 64 over 2 layers, the draft
    at dim 32 over 1, float32."""
    kw = dict(kw)
    target_kw = dict(vocab=vocab, dim=64, depth=2, num_q_heads=4,
                     num_kv_heads=2, **kw)
    draft_kw = dict(vocab=vocab, dim=32, depth=1, num_q_heads=2,
                    num_kv_heads=2, **kw)
    prompt = np.random.default_rng(seed).integers(0, vocab, (1, 7)) \
        .astype(np.int32)
    out = []
    for i, mkw in enumerate((target_kw, draft_kw)):
        jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **mkw)
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed + i),
                             jnp.asarray(prompt))["params"]
        model = TinyDecoder(dtype=torch.float32, device="cpu", **mkw)
        model.load_state_dict(params_from_jax(jax.device_get(params)))
        out.append((jmodel, params, model))
    (jt, tp, t), (jd, dp, d) = out
    return jt, tp, jd, dp, t, d, prompt


def _frozen(**kw):
    return _models(**{k: v for k, v in sorted(kw.items())})


@pytest.mark.parametrize("cache_type", CACHE_TYPES)
def test_greedy_streams_equal_jax(cache_type):
    """A useless draft (its tokens almost never accepted) on each cache
    type: the stream equals JAX's and greedy `generate` (int8: with
    ``int8_cache``), and each iteration synced once."""
    jt, tp, jd, dp, t, d, prompt = _frozen()
    want = np.asarray(jax_speculative(
        jt, tp, jd, dp, jnp.asarray(prompt), steps=10, gamma=3,
        cache_type=cache_type))
    got, st = generate_speculative(t, d, prompt, steps=10, gamma=3,
                                   cache_type=cache_type, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = generate(t, prompt, steps=10, int8_cache=cache_type == "int8")
    torch.testing.assert_close(got, greedy, rtol=0, atol=0)
    assert 1 <= st.iterations <= 9
    assert 1 + st.accepted + st.iterations >= 10


@pytest.mark.parametrize("gamma", [1, 5])
def test_greedy_any_gamma_and_a_perfect_draft(gamma):
    """gamma 1 and 5 with the useless draft, and the target as its own
    draft (every draft token accepted): the greedy stream each time."""
    jt, tp, _, _, t, d, prompt = _frozen()
    want = np.asarray(jax_generate(jt, tp, jnp.asarray(prompt), steps=12))
    for draft in (d, t):
        got, st = generate_speculative(t, draft, prompt, steps=12,
                                       gamma=gamma, return_stats=True)
        np.testing.assert_array_equal(got.numpy(), want)
    assert st.accepted == gamma * st.iterations


@pytest.mark.parametrize("cache_type", ["ragged", "paged"])
def test_greedy_windowed(cache_type):
    """The windowed model (window 8, 2 sinks) through the chunk kernels'
    per-row bands, against JAX's stream."""
    jt, tp, jd, dp, t, d, prompt = _frozen(window=8, attn_sinks=2)
    want = np.asarray(jax_speculative(
        jt, tp, jd, dp, jnp.asarray(prompt), steps=8, gamma=3,
        cache_type=cache_type))
    got = generate_speculative(t, d, prompt, steps=8, gamma=3,
                               cache_type=cache_type)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_low_temperature_is_greedy():
    """At T -> 0 both warped distributions sit on their argmax and the
    rejection rule is the greedy one."""
    _, _, _, _, t, d, prompt = _frozen()
    want = generate(t, prompt, steps=10)
    for cache_type in ("dense", "ragged"):
        got = generate_speculative(
            t, d, prompt, steps=10, gamma=3, temperature=1e-6,
            generator=torch.Generator().manual_seed(3),
            cache_type=cache_type)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sampling_is_seeded_and_in_the_vocabulary():
    _, _, _, _, t, d, prompt = _frozen()
    runs = [generate_speculative(
        t, d, prompt, steps=8, gamma=3, temperature=0.8, top_k=7,
        generator=torch.Generator().manual_seed(9), cache_type="paged")
        for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert runs[0].shape == (1, 8)
    assert ((runs[0] >= 0) & (runs[0] < 41)).all()


def test_sampling_matches_target_distribution():
    """The rejection scheme's exactness: the emitted tokens' histogram,
    each position and pooled, against target-only sampling's, by a
    two-sample chi-square test at 0.1% (250 runs, vocabulary 11, fixed
    seeds, so the outcome is the same every run)."""
    _, _, _, _, t, d, prompt = _frozen(vocab=11)
    steps, runs, vocab = 3, 250, 11
    gen = torch.Generator().manual_seed(1000)
    spec = torch.cat([generate_speculative(
        t, d, prompt, steps=steps, gamma=2, temperature=1.0, generator=gen)
        for _ in range(runs)])
    alone = generate(t, np.repeat(prompt, runs, axis=0), steps=steps,
                     temperature=1.0,
                     generator=torch.Generator().manual_seed(5000))
    for a, b in [(spec[:, i], alone[:, i]) for i in range(steps)] + [
            (spec.ravel(), alone.ravel())]:
        table = np.stack([np.bincount(x.numpy(), minlength=vocab)
                          for x in (a, b)])
        table = table[:, table.sum(0) > 0]
        assert stats.chi2_contingency(table)[1] > 1e-3, table


def test_refusals():
    jt, tp, jd, dp, t, d, prompt = _frozen()
    with pytest.raises(ValueError, match="batch 1"):
        generate_speculative(t, d, np.zeros((2, 4), np.int64), steps=4)
    with pytest.raises(ValueError, match="gamma"):
        generate_speculative(t, d, prompt, steps=4, gamma=0)
    other = TinyDecoder(vocab=99, dim=32, depth=1, num_q_heads=2,
                        num_kv_heads=2, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        generate_speculative(t, other, prompt, steps=4)
    with pytest.raises(ValueError, match="cache_type"):
        generate_speculative(t, d, prompt, steps=4, cache_type="fp7")
    xla = TinyDecoder(vocab=41, dim=64, depth=2, num_q_heads=4,
                      num_kv_heads=2, impl="xla", dtype=torch.float32,
                      device="cpu")
    xla.load_state_dict(t.state_dict())
    with pytest.raises(ValueError, match="impl='flash'"):
        generate_speculative(xla, d, prompt, steps=4, cache_type="ragged")
    # the xla target verifies on the dense cache as flash does
    torch.testing.assert_close(
        generate_speculative(xla, d, prompt, steps=6, gamma=2),
        generate(t, prompt, steps=6), rtol=0, atol=0)
    sinks = TinyDecoder(vocab=41, dim=64, depth=2, num_q_heads=4,
                        num_kv_heads=2, rope=True, window=8, attn_sinks=2,
                        dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="sink"):
        generate_speculative(sinks, d, prompt, steps=4)
    with pytest.raises(ValueError, match="Generator"):
        generate_speculative(t, d, prompt, steps=4, temperature=1.0)
    with pytest.raises(ValueError, match="capacity"):
        generate_speculative(t, d, prompt, steps=4, capacity=130)
