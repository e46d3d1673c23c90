"""The port's beam search against the JAX package, on the CPU.

The same flax params (converted by `params_from_jax`) and the same numpy
prompts go through `attention_tpu.models.generate_beam` (Pallas in
interpret mode) and the port's `generate_beam` (the plain versions).
Tokens must be equal; scores agree within 1e-4 (float32 sums of six
log-probabilities, each side's logits within 1e-5 of the other's, and
the reason `tests/test_beam.py` holds its re-score to the same 1e-4).
What beam search adds to greedy decoding is the gather of every cache
along the beams; beams = 1 must be greedy decoding, and the score the
search accumulated must be the teacher-forced re-score of its tokens.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import generate_beam as jax_beam
from attention_tpu_torch.models import TinyDecoder, generate, \
    generate_beam, params_from_jax

KW = dict(vocab=29, dim=64, depth=2, num_q_heads=4, num_kv_heads=2,
          rope=True)
SCORE_TOL = 1e-4


@functools.lru_cache(maxsize=1)
def _models():
    prompt = np.random.default_rng(1234).integers(0, 29, (2, 6)) \
        .astype(np.int32)
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **KW)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(prompt))[
        "params"]
    model = TinyDecoder(dtype=torch.float32, device="cpu", **KW)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model, prompt


def _rescore(model, prompt, cont):
    """Teacher-forced total log-probability of ``cont`` after
    ``prompt``."""
    full = torch.cat([prompt, cont], dim=1)
    with torch.no_grad():
        logp = torch.log_softmax(model(full).float(), dim=-1)
    s = prompt.shape[1]
    return logp[:, s - 1:-1].gather(-1, cont[..., None])[..., 0].sum(-1)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_beam_matches_jax(int8):
    """Beams 3 and 4, with scores, on dense and int8 caches (the int8
    values and per-token scales reorder alike)."""
    jmodel, params, model, prompt = _models()
    for beams, steps in ((3, 6), (4, 7)):
        jt, js = jax_beam(jmodel, params, jnp.asarray(prompt), steps=steps,
                          beams=beams, int8_cache=int8, return_scores=True)
        toks, scores = generate_beam(model, torch.from_numpy(prompt),
                                     steps=steps, beams=beams,
                                     int8_cache=int8, return_scores=True)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
        np.testing.assert_allclose(scores.numpy(), np.asarray(js),
                                   atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["dense", "int8"])
def test_beam_one_is_greedy(int8):
    _, _, model, prompt = _models()
    prompt = torch.from_numpy(prompt)
    want = generate(model, prompt, steps=7, int8_cache=int8)
    got = generate_beam(model, prompt, steps=7, beams=1, int8_cache=int8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_beam_score_is_the_rescore_of_its_tokens():
    """The score accumulated through the reordered caches equals the
    teacher-forced re-score of the returned tokens: a wrong gather parts
    the two; and on this configuration beam 4 scores no lower than
    greedy decoding."""
    _, _, model, prompt = _models()
    prompt = torch.from_numpy(prompt).long()
    toks, scores = generate_beam(model, prompt, steps=6, beams=3,
                                 return_scores=True)
    torch.testing.assert_close(scores, _rescore(model, prompt, toks),
                               atol=SCORE_TOL, rtol=0)
    greedy = _rescore(model, prompt, generate(model, prompt, steps=7))
    beam = _rescore(model, prompt, generate_beam(model, prompt, steps=7))
    assert (beam >= greedy - SCORE_TOL).all()


def test_beam_gather_gives_fresh_storage():
    """The gather copies (`_cache_rows`): the gathered dense and int8
    caches lie in storage of their own, each row its parent's values, so
    the in-place writes of two beams with one parent land in rows of
    their own and never in the parent's."""
    from attention_tpu_torch.models.decode import _cache_rows, prefill

    _, _, model, prompt = _models()
    with torch.no_grad():
        _, caches = prefill(model, torch.from_numpy(prompt).long(), 128)
    rows = torch.tensor([0, 0, 1, 1])
    for c in (caches[0], caches[0].quantize()):
        (out,) = _cache_rows((c,), rows)
        tensors = (out.k, out.v) if hasattr(out, "k") else tuple(out.kv)
        olds = (c.k, c.v) if hasattr(c, "k") else tuple(c.kv)
        for new, old in zip(tensors, olds):
            assert new.untyped_storage().data_ptr() != \
                old.untyped_storage().data_ptr()
            torch.testing.assert_close(new, old[rows], rtol=0, atol=0)
        assert out.length == c.length


def test_beam_refusals():
    _, _, model, prompt = _models()
    with pytest.raises(ValueError, match="beams must be >= 1"):
        generate_beam(model, prompt, steps=3, beams=0)
    with pytest.raises(ValueError, match="> vocab"):
        generate_beam(model, prompt, steps=3, beams=30)
    xla = TinyDecoder(impl="xla", dtype=torch.float32, device="cpu", **KW)
    with pytest.raises(ValueError, match="int8_cache requires impl='flash'"):
        generate_beam(xla, prompt, steps=3, beams=2, int8_cache=True)
