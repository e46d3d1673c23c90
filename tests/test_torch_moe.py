"""The port's mixture of experts against the JAX package, on the CPU:
`MoEMLP` alone (outputs, aux loss, gradients, routing ties, refusals;
its router a ``Linear`` holding JAX's (d, E) kernel transposed),
and the MoE `TinyDecoder` (logits, loss, gradients, AdamW steps,
accumulation, cached decode, greedy streams of the three generate
functions, of int8 and rolling caches, and of the engine in both step
modes).  Inputs come from
numpy seeds and reach both sides as the same arrays; the JAX side runs
its flash kernels in Pallas interpret mode.

Tolerances, float32, with their reasons:

* `MoEMLP` outputs and gradients, 1e-5 max abs: both sides compute in
  full f32; a dispatched row is an exact copy on both, and a combined
  row sums the same k products in another order (the JAX one-hot
  product adds zeros too, which is exact).
* the aux loss, 1e-6 relative: a mean of the same probabilities.
* the model: logits 2e-4 max abs (as the dense model's, through two
  blocks and the head); loss and gradients 1e-6, three AdamW steps'
  losses 2e-5 and parameters 2e-6, as the dense model's training
  parity (tests/test_torch_train.py gives the reasons).

Routing is discontinuous: a top-k choice that flipped between the two
sides would move one token's output by O(1), far past these limits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attention_tpu import engine as jax_engine
from attention_tpu.models import MoEMLP as JaxMoE
from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import decode as jax_gen
from attention_tpu.models import train as jax_train
from attention_tpu_torch.engine import (
    EngineConfig,
    ServingEngine,
    replay,
    synthetic_trace,
)
from attention_tpu_torch.models import (
    MoEMLP,
    TinyDecoder,
    init_params,
    init_train,
    make_train_step,
    moe_from_jax,
    params_from_jax,
)
from attention_tpu_torch.models import decode as gen
from attention_tpu_torch.models.moe import capacity, route
from attention_tpu_torch.models.train import loss_fn
from attention_tpu_torch.parallel.mesh import default_mesh
from test_moe import _reference_moe

F32_TOL = 1e-5
SMALL = dict(vocab=43, dim=32, depth=2, num_q_heads=4, num_kv_heads=2,
             rope=True, softcap=20.0, moe_experts=4)

# name: (experts, top_k, capacity_factor, x shape); cf 8 drops nothing,
# 1.25 and 0.5 drop pairs, 1e-9 leaves one slot an expert
CASES = {
    "top2_cf8": (4, 2, 8.0, (2, 8, 32)),
    "top2_cf1.25": (4, 2, 1.25, (2, 8, 32)),
    "top2_cf0.5": (4, 2, 0.5, (2, 8, 32)),
    "top1_cf8": (4, 1, 8.0, (1, 12, 16)),
    "top1_cf1.25": (8, 1, 1.25, (2, 10, 16)),
    "top2_capacity1": (4, 2, 1e-9, (1, 8, 16)),
    "top2_tie_cf1.25": (4, 2, 1.25, (2, 8, 32)),
}


@functools.cache
def _case(name):
    e, k, cf, shape = CASES[name]
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(
        np.float32)
    if "tie" in name:
        # a zero row: every router logit 0, every probability 1/E, so
        # that the first experts by index must win
        x[0, 3] = 0.0
    jmod = JaxMoE(num_experts=e, top_k=k, capacity_factor=cf,
                  dtype=jnp.float32)
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x))["params"])
    mod = MoEMLP(shape[-1], e, top_k=k, capacity_factor=cf,
                 dtype=torch.float32, device="cpu")
    mod.load_state_dict(moe_from_jax(params))
    return jmod, params, mod, x


def _jax_loss(jmod, w):
    def loss(params, x):
        y, mods = jmod.apply({"params": params}, x, mutable=["losses"])
        aux = sum(jax.tree_util.tree_leaves(mods["losses"]), 0.0)
        return jnp.sum(y * w) + aux, (y, aux)
    return loss


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_mlp_matches_jax(name):
    """Outputs, the aux loss, and the gradients of sum(y·w) + aux with
    respect to x, the router and both expert tensors."""
    jmod, params, mod, x = _case(name)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    (_, (want, want_aux)), grads = jax.jit(jax.value_and_grad(
        _jax_loss(jmod, jnp.asarray(w)), argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got, aux = mod(tx)
    ((got * torch.from_numpy(w)).sum() + aux).backward()
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= F32_TOL
    assert abs(aux.item() - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    assert np.abs(tx.grad.numpy() - np.asarray(grads[1])).max() <= F32_TOL
    want_grads = moe_from_jax(jax.device_get(grads[0]))
    for pname, p in mod.named_parameters():
        assert (p.grad - want_grads[pname]).abs().max() <= F32_TOL, pname
    e, k, cf, shape = CASES[name]
    cap = capacity(x.size // shape[-1], e, k, cf)
    dropped = np.all(np.asarray(want) == 0.0, axis=-1).sum()
    if cf >= 8.0:
        assert dropped == 0
    elif cap == 1:
        assert dropped >= x.size // shape[-1] - e * k


def test_route_breaks_ties_like_lax_top_k():
    """Equal probabilities go to the lower expert index first, as
    ``lax.top_k`` orders them."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.2, 0.2, 0.5, 0.1]], np.float32)
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = route(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_mlp_matches_the_per_token_reference():
    """At cf 8 nothing is dropped: the float64 per-token loop of the
    JAX package's tests, at their tolerance."""
    _, params, mod, x = _case("top2_cf8")
    with torch.no_grad():
        got = mod(torch.from_numpy(x))[0].numpy()
    want = _reference_moe(params, x.astype(np.float64).reshape(16, 32), 4, 2)
    np.testing.assert_allclose(got, want.reshape(x.shape), atol=2e-3,
                               rtol=1e-2)


def test_moe_refusals_match_jax():
    x = jnp.zeros((1, 4, 16), jnp.float32)
    with pytest.raises(ValueError, match="top_k"):
        JaxMoE(num_experts=2, top_k=3, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="top_k"):
        MoEMLP(16, 2, top_k=3, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        TinyDecoder(dtype=torch.float32, device="cpu",
                    **dict(SMALL, moe_top_k=5))
    # expert parallelism is ported: JAX's refusal of an ep_axis that the
    # mesh lacks (without a mesh the axis is no constraint, as in JAX)
    with pytest.raises(ValueError, match="not in the current mesh"):
        MoEMLP(16, 8, ep_axis="exp", mesh=default_mesh("ep"),
               dtype=torch.float32, device="cpu")
    MoEMLP(16, 4, ep_axis="ep", dtype=torch.float32, device="cpu")


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    model = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


def test_moe_decoder_logits_match_jax(pair):
    jmodel, params, model = pair
    tokens = np.random.default_rng(0).integers(0, 43, (2, 40))
    want = np.asarray(jmodel.apply({"params": params},
                                   jnp.asarray(tokens, jnp.int32)))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tokens), return_aux=True)
    assert got.shape == want.shape == (2, 40, 43)
    assert np.abs(got.numpy() - want).max() <= 2e-4
    assert aux.item() > 0


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's MoE model on a 1-device mesh: its initial
    params, loss and gradients on one batch, three train steps, and one
    step over two microbatches."""
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **SMALL)
    mesh = jax_train.make_mesh_3d(1)
    params, _, opt_state = jax_train.init_sharded(jmodel, mesh, batch=2,
                                                  seq=17, seed=0, lr=1e-3)
    tokens = np.random.default_rng(7).integers(0, SMALL["vocab"], (2, 17))
    batch = jnp.asarray(tokens, jnp.int32)
    init = jax.device_get(params)
    loss, grads = jax.jit(jax.value_and_grad(jax_train.loss_fn),
                          static_argnums=1)(params, jmodel, batch)
    grad_fn = jax.jit(jax.grad(jax_train.loss_fn), static_argnums=1)
    micro = [params_from_jax(jax.device_get(grad_fn(
        params, jmodel, batch[i:i + 1]))) for i in range(2)]
    accum = jax_train.make_train_step(jmodel, optax.adamw(1e-3), mesh,
                                      accum_steps=2)
    accum_params, _, accum_loss = accum(params, opt_state, batch)
    accum_params = params_from_jax(jax.device_get(accum_params))
    step = jax_train.make_train_step(jmodel, optax.adamw(1e-3), mesh)
    losses = []
    params, _, opt_state = jax_train.init_sharded(jmodel, mesh, batch=2,
                                                  seq=17, seed=0, lr=1e-3)
    for _ in range(3):
        params, opt_state, step_loss = step(params, opt_state, batch)
        losses.append(float(step_loss))
    return dict(init=init, tokens=torch.from_numpy(tokens), loss=float(loss),
                grads=params_from_jax(jax.device_get(grads)), losses=losses,
                final=params_from_jax(jax.device_get(params)),
                accum_loss=float(accum_loss), accum_final=accum_params,
                accum_grads={k: (micro[0][k] + micro[1][k]) / 2
                             for k in micro[0]})


def _trained(jax_run):
    model = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL)
    optimizer = init_train(model, lr=1e-3,
                           params=params_from_jax(jax_run["init"]))
    return model, optimizer


def test_moe_decoder_loss_and_gradients_match_jax(jax_run):
    """The loss is the cross entropy plus both blocks' aux losses."""
    model, _ = _trained(jax_run)
    loss = loss_fn(model, jax_run["tokens"])
    loss.backward()
    assert abs(loss.item() - jax_run["loss"]) <= 1e-6
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(jax_run["grads"])
    assert any("router" in name for name in grads)
    for name, want in jax_run["grads"].items():
        assert (grads[name].grad - want).abs().max().item() <= 1e-6, name


def test_moe_decoder_adamw_steps_match_jax(jax_run):
    model, optimizer = _trained(jax_run)
    step = make_train_step(model, optimizer)
    losses = [step(jax_run["tokens"]).item() for _ in range(3)]
    np.testing.assert_allclose(losses, jax_run["losses"], atol=2e-5, rtol=0)
    assert losses[2] < losses[0]
    for name, p in model.named_parameters():
        assert (p.detach() - jax_run["final"][name]).abs().max() <= 2e-6, \
            name


def test_moe_decoder_accumulated_step_matches_jax(jax_run):
    """One step over two microbatches, each with its own aux loss, as
    JAX's step computes it: the loss, the float32 mean gradient the
    optimizer took (1e-6, as the one-batch gradients), and the
    parameters within 2e-6 wherever that gradient is 1e-5 or more.
    Adam's first update is lr·g/(|g| + 1e-8), whose slope in g is
    lr·1e-8/(|g| + 1e-8)^2: at most 1e-1 there, but 2.5e4 near |g| =
    1e-8, where an MoE expert's gradient can lie (a GELU far below 0
    feeds experts_down almost nothing); measured, gradients 5.0e-8 and
    5.3e-8 one step apart by 8.4e-6."""
    model, optimizer = _trained(jax_run)
    loss = make_train_step(model, optimizer, accum_steps=2)(
        jax_run["tokens"]).item()
    assert abs(loss - jax_run["accum_loss"]) <= 1e-6
    for name, p in model.named_parameters():
        want = jax_run["accum_grads"][name]
        assert p.grad.dtype == torch.float32
        assert (p.grad - want).abs().max() <= 1e-6, name
        live = want.abs() >= 1e-5
        assert (p.detach() - jax_run["accum_final"][name])[live].abs() \
            .max() <= 2e-6, name


def test_moe_cached_decode_equals_the_full_forward():
    """At cf 8 nothing is dropped, so one token at a time through the
    cache gives the full forward's logits (the JAX package's test, at
    its tolerance)."""
    model = TinyDecoder(dtype=torch.float32, device="cpu",
                        **dict(SMALL, moe_capacity_factor=8.0))
    model.load_state_dict(init_params(model, 1))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 43,
                                                                (2, 9)))
    with torch.no_grad():
        full = model(tokens)
        caches = model.init_caches(2, 128)
        steps = []
        for t in range(tokens.shape[1]):
            logits, caches = model(tokens[:, t:t + 1], caches)
            steps.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               atol=2e-4, rtol=1e-3)


PROMPT = np.random.default_rng(4).integers(0, 43, (2, 9)).astype(np.int32)
PROMPT_LENS = np.array([9, 4], np.int32)


def test_moe_generate_tokens_equal_jax(pair):
    """Greedy `generate`, `generate_ragged` and `generate_paged`: each
    decode call routes its B tokens with their own capacity, as JAX's."""
    jmodel, params, model = pair
    prompt, lens = jnp.asarray(PROMPT), jnp.asarray(PROMPT_LENS)
    want = np.asarray(jax_gen.generate(jmodel, params, prompt, steps=5))
    np.testing.assert_array_equal(
        gen.generate(model, torch.from_numpy(PROMPT), steps=5).numpy(), want)
    want = np.asarray(jax_gen.generate_ragged(jmodel, params, prompt, lens,
                                              steps=5))
    np.testing.assert_array_equal(
        gen.generate_ragged(model, PROMPT, PROMPT_LENS, steps=5).numpy(),
        want)
    np.testing.assert_array_equal(
        gen.generate_paged(model, PROMPT, PROMPT_LENS, steps=5)[0].numpy(),
        want)


def test_moe_int8_and_rolling_generate_equal_jax(pair):
    """`generate(int8_cache=True)` on the MoE model, and
    `generate(rolling_cache=True)` on a windowed one (window 16, 2
    sinks: the ring wraps during the 12 steps), token for token."""
    jmodel, params, model = pair
    prompt = jnp.asarray(PROMPT)
    want = np.asarray(jax_gen.generate(jmodel, params, prompt, steps=5,
                                       int8_cache=True))
    np.testing.assert_array_equal(
        gen.generate(model, PROMPT, steps=5, int8_cache=True).numpy(), want)
    band = dict(SMALL, window=16, attn_sinks=2)
    jwin = JaxDecoder(impl="flash", dtype=jnp.float32, **band)
    wparams = jax.jit(jwin.init)(jax.random.PRNGKey(2),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    win = TinyDecoder(dtype=torch.float32, device="cpu", **band)
    win.load_state_dict(params_from_jax(jax.device_get(wparams)))
    want = np.asarray(jax_gen.generate(jwin, wparams, prompt, steps=12,
                                       rolling_cache=True))
    np.testing.assert_array_equal(
        gen.generate(win, PROMPT, steps=12, rolling_cache=True).numpy(),
        want)


ENGINE = dict(num_pages=24, page_size=128, max_seq_len=256,
              prefill_chunk=32, token_budget=80)


def _engines(pair, mode, decode_rows, prefill_rows):
    """The JAX engine's and the port's replay of one trace."""
    jmodel, params, model = pair
    cfg = dict(ENGINE, step_mode=mode, max_decode_batch=decode_rows,
               max_prefill_rows=prefill_rows)
    trace = synthetic_trace(5, vocab=43, seed=5, max_tokens=5,
                            prompt_len_min=4, prompt_len_max=40,
                            arrival_every=3)
    jeng = jax_engine.ServingEngine(jmodel, params,
                                    jax_engine.EngineConfig(**cfg))
    eng = ServingEngine(model, EngineConfig(**cfg))
    return trace, (jeng, jax_engine.replay(jeng, trace)[1]), \
        (eng, replay(eng, trace)[1])


@pytest.mark.parametrize("mode,rows", [("ragged", (4, 2)),
                                       ("two_call", (1, 1))])
def test_moe_engine_streams_equal_jax(pair, mode, rows):
    """The packed step routes its pad rows too, as JAX's does: the same
    capacity, the same drops, the same greedy streams.  The two-call
    step runs one decode and one prefill row, so that it has no inactive
    row (see the next test)."""
    trace, (_, want), (eng, got) = _engines(pair, mode, *rows)
    assert got == want
    assert all(len(got[e["id"]]) == 5 for e in trace)
    assert eng.nonfinite_events == 0


def test_moe_two_call_inactive_rows_spoil_only_themselves(pair):
    """The two-call step's inactive rows (length -1) come out of the
    paged attention NaN on both sides.  JAX's one-hot dispatch multiplies
    them by zero into every expert slot (0·NaN = NaN), so every row of
    the call turns NaN and the JAX engine meets non-finite logits; the
    port's gather leaves the NaN in the rows that carry it, and every
    request finishes on finite logits."""
    trace, (jeng, _), (eng, got) = _engines(pair, "two_call", 4, 2)
    assert jeng.nonfinite_events > 0
    assert eng.nonfinite_events == 0
    assert all(len(got[e["id"]]) == 5 for e in trace)
    # at cf 8 (no pair dropped) the finite rows' outputs are those of
    # the same rows beside finite pads on the JAX side
    jmod, params, mod, x = _case("top2_cf8")
    nan_x, zero_x = x.copy(), x.copy()
    nan_x[1, 5:], zero_x[1, 5:] = np.nan, 0.0
    assert np.isnan(np.asarray(jmod.apply({"params": params},
                                          jnp.asarray(nan_x)))).all()
    with torch.no_grad():
        got = mod(torch.from_numpy(nan_x))[0].numpy()
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(zero_x)))
    assert np.isnan(got[1, 5:]).all() and np.isfinite(got[0]).all()
    assert np.abs(got[0] - want[0]).max() <= F32_TOL
    assert np.abs(got[1, :5] - want[1, :5]).max() <= F32_TOL
