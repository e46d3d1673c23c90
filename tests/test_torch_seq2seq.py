"""The port's cross-attention and encoder-decoder family against the JAX
package, on the CPU.

The same flax params (converted by `params_from_jax`'s projection
mapping, `seq2seq_params_from_jax` for the whole model) and the same
numpy inputs go through `attention_tpu.models` (its flash path in Pallas
interpret mode) and the port (the plain versions), in float32.
Tolerances are the JAX tests' own (`tests/test_cross_attention.py`,
`tests/test_seq2seq.py`): outputs and logits 2e-4 absolute with 1e-3
relative (both sides in f32, only the summation order and exp2 against
exp differ), the loss 1e-5 relative, gradients 3e-5 absolute, greedy
streams equal.  The JAX gradients are those of its "xla" path, which
its own test holds to its flash path within the same 3e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.models import GQACrossAttention as JaxCross
from attention_tpu.models import TinySeq2Seq as JaxSeq2Seq
from attention_tpu.models import generate_seq2seq as jax_generate
from attention_tpu.models import seq2seq_loss as jax_loss
from attention_tpu_torch.models import GQACrossAttention, TinySeq2Seq, \
    generate_seq2seq, init_params, seq2seq_loss, seq2seq_params_from_jax
from attention_tpu_torch.models.convert import _attention_from_jax

ATOL, RTOL = 2e-4, 1e-3
GRAD_ATOL = 3e-5
KW = dict(vocab=37, dim=64, enc_depth=2, dec_depth=2, num_q_heads=4,
          num_kv_heads=2)


def _cross(impl="flash", softcap=None, memory_dim=None):
    return GQACrossAttention(64, 4, 2, 16, memory_dim=memory_dim, impl=impl,
                             softcap=softcap, dtype=torch.float32,
                             device="cpu")


def _jax_cross(impl, softcap=None):
    return JaxCross(num_q_heads=4, num_kv_heads=2, head_dim=16, impl=impl,
                    dtype=jnp.float32, softcap=softcap)


def _module_sd(tree):
    """A flax GQACrossAttention tree (params or gradients) as the port's
    module's ``state_dict``."""
    return {k[2:]: v for k, v in _attention_from_jax(
        jax.device_get(tree), "m").items()}


def _cross_pair(rng, x_shape, mem_shape, softcap=None):
    """Inputs and flax params (from the "xla" module's init, the same
    tree as the flash one's) with the port's modules loaded from them:
    (x, mem, params, {impl: module})."""
    x = rng.standard_normal(x_shape).astype(np.float32)
    mem = rng.standard_normal(mem_shape).astype(np.float32)
    params = _jax_cross("xla", softcap).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mem))["params"]
    sd = _module_sd(params)
    mods = {}
    for impl in ("flash", "xla"):
        mods[impl] = _cross(impl, softcap, memory_dim=mem_shape[-1])
        mods[impl].load_state_dict(sd)
    return x, mem, params, mods


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_cross_attention_matches_jax(rng, impl):
    """m = 10 queries over a memory of 23 rows of another width (48):
    each impl against JAX's same impl and JAX's "xla"."""
    x, mem, params, mods = _cross_pair(rng, (2, 10, 64), (2, 23, 48))
    with torch.no_grad():
        got = mods[impl](torch.from_numpy(x), torch.from_numpy(mem))
    assert got.shape == (2, 10, 64)
    for jimpl in {impl, "xla"}:
        want = _jax_cross(jimpl).apply({"params": params}, jnp.asarray(x),
                                       jnp.asarray(mem))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


def test_cross_attention_precomputed_kv(rng):
    """`project_kv` once and ``kv=`` equals projecting the memory in the
    call (1e-5, as JAX's test), and equals JAX's `project_kv`."""
    x, mem, params, mods = _cross_pair(rng, (2, 5, 64), (2, 33, 64))
    mod = mods["flash"]
    with torch.no_grad():
        direct = mod(torch.from_numpy(x), torch.from_numpy(mem))
        kv = mod.project_kv(torch.from_numpy(mem))
        reused = mod(torch.from_numpy(x), kv=kv)
    assert kv[0].shape == (2, 2, 33, 16)
    torch.testing.assert_close(reused, direct, atol=1e-5, rtol=1e-5)
    for got, want in zip(kv, _jax_cross("flash").project_kv(
            params, jnp.asarray(mem))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_cross_attention_softcap_and_refusals(rng):
    x, mem, params, mods = _cross_pair(rng, (1, 6, 64), (1, 14, 64),
                                       softcap=5.0)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mem)
    with torch.no_grad():
        a, b = (mods[i](xt, mt) for i in ("flash", "xla"))
        plain = _cross()
        plain.load_state_dict(mods["flash"].state_dict())
        c = plain(xt, mt)
    torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)
    want = _jax_cross("xla", 5.0).apply({"params": params}, jnp.asarray(x),
                                        jnp.asarray(mem))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert not torch.allclose(a, c, atol=1e-4)
    with pytest.raises(ValueError, match="exactly one"):
        plain(xt)
    with pytest.raises(ValueError, match="exactly one"):
        plain(xt, mt, kv=plain.project_kv(mt))
    with pytest.raises(ValueError, match="impl"):
        _cross("pallas")


def test_cross_attention_gradients_match_jax(rng):
    """The loss sum(out²): the port's flash path (its backward the
    plain version of the backward kernels, non-causal, m = 6 over n =
    12) against JAX's gradients of the same loss."""
    x, mem, params, mods = _cross_pair(rng, (1, 6, 64), (1, 12, 64))
    mod = mods["flash"]
    xt = torch.from_numpy(x).requires_grad_()
    (mod(xt, torch.from_numpy(mem)) ** 2).sum().backward()

    def loss(p, x, mem):
        return jnp.sum(_jax_cross("xla").apply({"params": p}, x, mem) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x),
                                           jnp.asarray(mem))
    want = _module_sd(gp)
    for name, p in mod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=GRAD_ATOL, rtol=0)


@functools.lru_cache(maxsize=1)
def _seq2seq():
    """(flax params, src, tgt, {impl: port model}), the JAX test's
    shapes: 2 sources of 11 tokens, targets of 9."""
    rng = np.random.default_rng(1234)
    src = rng.integers(2, 37, (2, 11)).astype(np.int32)
    tgt = rng.integers(2, 37, (2, 9)).astype(np.int32)
    params = JaxSeq2Seq(impl="xla", dtype=jnp.float32, **KW).init(
        jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(tgt))["params"]
    sd = seq2seq_params_from_jax(jax.device_get(params))
    models = {}
    for impl in ("flash", "xla"):
        models[impl] = TinySeq2Seq(impl=impl, dtype=torch.float32,
                                   device="cpu", **KW)
        models[impl].load_state_dict(sd)
    return params, src, tgt, models


def _jax(impl):
    return JaxSeq2Seq(impl=impl, dtype=jnp.float32, **KW)


def test_seq2seq_logits_match_jax():
    params, src, tgt, models = _seq2seq()
    want = _jax("flash").apply({"params": params}, jnp.asarray(src),
                               jnp.asarray(tgt))
    for model in models.values():
        with torch.no_grad():
            got = model(torch.from_numpy(src).long(),
                        torch.from_numpy(tgt).long())
        assert got.dtype == torch.float32 and got.shape == (2, 9, 37)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


def test_seq2seq_loss_and_gradients_match_jax():
    """The teacher-forced loss and every gradient, both impls of the port
    (flash: the encoder's and the cross-attention's non-causal backward,
    the decoder's causal one) against JAX's."""
    params, src, tgt, models = _seq2seq()
    jl, jg = jax.value_and_grad(jax_loss)(params, _jax("xla"),
                                          jnp.asarray(src), jnp.asarray(tgt))
    want = seq2seq_params_from_jax(jax.device_get(jg))
    for model in models.values():
        model.zero_grad(set_to_none=True)
        loss = seq2seq_loss(model, torch.from_numpy(src).long(),
                            torch.from_numpy(tgt).long())
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        assert set(want) == {n for n, _ in model.named_parameters()}
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                       atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_generate_seq2seq_matches_jax_and_the_rollout():
    """Greedy generation (encode once, cross K/V once, cached steps)
    equals JAX's and the argmax rollout of full teacher-forced
    forwards."""
    params, src, _, models = _seq2seq()
    want = np.asarray(jax_generate(_jax("flash"), params, jnp.asarray(src),
                                   steps=7, bos=1))
    for model in models.values():
        got = generate_seq2seq(model, src, steps=7, bos=1)
        np.testing.assert_array_equal(got.numpy(), want)
    model, seq = models["flash"], torch.ones((2, 1), dtype=torch.long)
    srct = torch.from_numpy(src).long()
    with torch.no_grad():
        for _ in range(7):
            nxt = model(srct, seq)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    np.testing.assert_array_equal(seq[:, 1:].numpy(), want)
    with pytest.raises(ValueError, match="128-multiple"):
        generate_seq2seq(model, src, steps=7, capacity=100)


def test_seq2seq_is_sensitive_to_source_order():
    """Rope in the encoder is what gives the model the source's order:
    reversing the source must change the logits."""
    _, src, tgt, models = _seq2seq()
    s, t = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    with torch.no_grad():
        a, b = models["flash"](s, t), models["flash"](s.flip(1), t)
    assert not torch.allclose(a, b, atol=1e-5)


def test_seq2seq_trains_with_master_adamw():
    """Five steps of `MasterAdamW` on seeded weights (`init_params` covers
    the model) lower the loss; the decoder without memory refuses."""
    from attention_tpu_torch.models import MasterAdamW

    _, src, tgt, _ = _seq2seq()
    model = TinySeq2Seq(dtype=torch.bfloat16, device="cpu", **KW)
    params = init_params(model, 0, dtype=torch.float32)
    model.load_state_dict(params)
    opt = MasterAdamW(model, params, lr=1e-3)
    s, t = torch.from_numpy(src).long(), torch.from_numpy(tgt).long()
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = seq2seq_loss(model, s, t)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="exactly one"):
        model.decode(t)
