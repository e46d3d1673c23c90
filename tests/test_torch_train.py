"""The port's training path against the JAX package, on the CPU: flash
partials, the flash backward (JAX's fused kernel and its dQ + dK/dV pair,
in Pallas interpret mode), `flash_attention_diff` gradients, the small
model's loss and gradients, and AdamW steps.  Inputs come from numpy
seeds and reach both sides as the same arrays.

Tolerances, with their reasons:

* float32, 1e-5 max abs on outputs, partials and gradients of
  attention: both sides compute in full f32 and differ only in
  summation order (values are O(1); sums run over at most 70 keys).
* bfloat16 gradients, `reference.grad_mismatch`'s bf16 limit: both
  sides round Q·scale·log2 e, P and dS to bf16 at the same points, but
  an exp2 or a product that lands next to a rounding boundary can round
  one ulp (2^-8) apart, and the gradients are themselves rounded to
  bf16; the limit allows one output ulp plus a share of the row's and
  of the tensor's rms.
* model loss and gradients, 1e-6 and 1e-6 max abs: f32 on both sides,
  through two blocks, gradients O(0.1) (measured apart by about 3e-7).
* three AdamW steps, losses 2e-5 and parameters 2e-6 max abs: Adam's
  update is g/(|g| + 1e-8)·lr on the first step, so a gradient
  difference of 1e-7 moves a parameter by well under 1e-6 unless |g| is
  near 1e-8; measured: losses 5e-6, parameters 3e-7 apart.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import train as jax_train
from attention_tpu.ops import flash as jax_flash
from attention_tpu.ops import flash_bwd as jax_bwd
from attention_tpu.ops.flash_vjp import _flash_fwd_impl as jax_fwd_impl
from attention_tpu.ops.flash_vjp import flash_attention_diff as jax_diff
from attention_tpu_torch.models import (
    TinyDecoder,
    init_params,
    init_train,
    make_train_step,
    params_from_jax,
)
from attention_tpu_torch.models.train import ADAMW, loss_fn
from attention_tpu_torch.ops import flash_bwd
from attention_tpu_torch.ops.flash import flash_attention_partials
from attention_tpu_torch.ops.flash_vjp import flash_attention_diff
from attention_tpu_torch.ops.reference import grad_mismatch

F32_TOL = 1e-5
SMALL = dict(vocab=43, dim=32, depth=2, num_q_heads=4, num_kv_heads=2,
             rope=True, softcap=20.0)

# (q, k, v) shapes and keywords: GQA 6 q / 2 kv heads, causal with the
# keys shifted past the first rows (rows 0-4 see no key: lse -inf),
# ``kv_valid`` and softcap; and a plain non-causal call with dk != dv
CASES = {
    "gqa_causal_offsets_softcap": (
        ((6, 40, 16), (2, 56, 16), (2, 56, 16)),
        dict(causal=True, q_offset=3, kv_offset=8, kv_valid=50,
             softcap=5.0)),
    "noncausal_dk_ne_dv": (((2, 33, 8), (2, 70, 8), (2, 70, 24)), {}),
}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.cache
def _case(name, dtype):
    shapes, kw = CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = (_rand(rng, *s) for s in shapes)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    out, lse = jax_fwd_impl(jq, jk, jv, scale, kw.get("causal", False),
                            None, softcap=kw.get("softcap"),
                            q_off=kw.get("q_offset"),
                            kv_off=kw.get("kv_offset"),
                            kv_val=kw.get("kv_valid"))
    dout = jnp.asarray(_rand(rng, *out.shape), jdt)
    return (jq, jk, jv, out, lse, dout), scale, kw


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
    return t if dtype is None else t.to(dtype)


def test_partials_match_jax():
    (q, k, v, _, _, _), scale, kw = _case("gqa_causal_offsets_softcap",
                                          torch.float32)
    want = jax_flash.flash_attention_partials(q, k, v, scale=scale, **kw)
    got = flash_attention_partials(*(_torch(x) for x in (q, k, v)),
                                   scale=scale, **kw)
    mx_want = np.asarray(want[1])
    assert np.isneginf(mx_want[:, :5]).all() and np.isfinite(
        mx_want[:, 5:]).all()
    np.testing.assert_array_equal(np.isneginf(got[1].numpy()),
                                  np.isneginf(mx_want))
    live = np.isfinite(mx_want)
    for mine, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        assert mine.shape == theirs.shape and mine.dtype == torch.float32
        assert np.abs(mine.numpy()[live] - theirs[live]).max() <= F32_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("path", ["fused", "two_kernel"])
def test_backward_matches_jax(monkeypatch, path, name, dtype):
    """`flash_backward` on CPU tensors (its plain version) against the
    JAX kernels run in interpret mode, on the same out, lse and dout."""
    monkeypatch.setattr(jax_bwd, "_FORCE_TWO_KERNEL", path == "two_kernel")
    arrays, scale, kw = _case(name, dtype)
    offsets = ("q_offset", "kv_offset", "kv_valid")
    want = jax.jit(functools.partial(
        jax_bwd.flash_backward, scale=scale, interpret=True,
        **{k: x for k, x in kw.items() if k not in offsets}))(
            *arrays, **{k: x for k, x in kw.items() if k in offsets})
    got = flash_bwd.flash_backward(
        *(_torch(x, dtype) for x in arrays[:4]), _torch(arrays[4]),
        _torch(arrays[5], dtype), scale=scale, **kw)
    for mine, theirs in zip(got, want):
        theirs = _torch(theirs, dtype)
        assert mine.dtype == dtype and mine.shape == theirs.shape
        if dtype is torch.float32:
            assert (mine - theirs).abs().max().item() <= F32_TOL
        else:
            assert grad_mismatch(mine, theirs)[1] <= 1


@pytest.mark.parametrize("rank,bwd", [
    (2, {}), (3, {}), (4, {}), (4, dict(bwd_impl="xla", bwd_chunk=8))],
    ids=["2", "3", "4", "4-xla"])
def test_diff_gradients_match_jax_grad(rank, bwd):
    """Gradients of sum(out·w) through both `flash_attention_diff`s, f32,
    causal with GQA where the rank has heads; ``bwd_impl="xla"`` runs the
    plain blocked recompute on both sides, 24 query rows in blocks of 8."""
    rng = np.random.default_rng(rank)
    lead = {2: (), 3: (4,), 4: (2, 4)}[rank]
    kv_lead = {2: (), 3: (2,), 4: (2, 2)}[rank]
    q = _rand(rng, *lead, 24, 8)
    k, v = (_rand(rng, *kv_lead, 40, 8) for _ in range(2))
    w = _rand(rng, *lead, 24, 8)
    kw = dict(causal=True, softcap=4.0, kv_valid=30, **bwd)

    def loss(q, k, v):
        return jnp.sum(jax_diff(q, k, v, **kw) * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (flash_attention_diff(*qkv, **kw) * torch.from_numpy(w)).sum().backward()
    for t, theirs in zip(qkv, want):
        assert np.abs(t.grad.numpy() - np.asarray(theirs)).max() <= F32_TOL


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's small model on a 1-device mesh: its initial
    params, loss and gradients on one batch, and three train steps."""
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **SMALL)
    mesh = jax_train.make_mesh_3d(1)
    params, _, opt_state = jax_train.init_sharded(jmodel, mesh, batch=2,
                                                  seq=17, seed=0, lr=1e-3)
    tokens = np.random.default_rng(7).integers(0, SMALL["vocab"], (2, 17))
    batch = jnp.asarray(tokens, jnp.int32)
    init = jax.device_get(params)
    loss, grads = jax.jit(jax.value_and_grad(jax_train.loss_fn),
                          static_argnums=1)(params, jmodel, batch)
    step = jax_train.make_train_step(jmodel, optax.adamw(1e-3), mesh)
    losses = []
    for _ in range(3):
        params, opt_state, step_loss = step(params, opt_state, batch)
        losses.append(float(step_loss))
    return dict(init=init, tokens=torch.from_numpy(tokens), loss=float(loss),
                grads=params_from_jax(jax.device_get(grads)), losses=losses,
                final=params_from_jax(jax.device_get(params)))


def _model(jax_run):
    model = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL)
    optimizer = init_train(model, seed=0, lr=1e-3)
    model.load_state_dict(params_from_jax(jax_run["init"]))
    return model, optimizer


def test_model_loss_and_gradients_match_jax(jax_run):
    model, _ = _model(jax_run)
    loss = loss_fn(model, jax_run["tokens"])
    loss.backward()
    assert abs(loss.item() - jax_run["loss"]) <= 1e-6
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(jax_run["grads"])
    for name, want in jax_run["grads"].items():
        assert (grads[name].grad - want).abs().max().item() <= 1e-6, name


def test_three_adamw_steps_match_jax(jax_run):
    model, optimizer = _model(jax_run)
    assert optimizer.defaults["weight_decay"] == ADAMW["weight_decay"]
    step = make_train_step(model, optimizer)
    losses = [step(jax_run["tokens"]).item() for _ in range(3)]
    np.testing.assert_allclose(losses, jax_run["losses"], atol=2e-5,
                               rtol=0)
    assert losses[2] < losses[0]
    for name, p in model.named_parameters():
        assert (p.detach() - jax_run["final"][name]).abs().max() <= 2e-6


def test_accumulated_step_equals_one_step(jax_run):
    """Two equal microbatches give the one-batch update: the loss within
    f32 rounding of the mean, parameters within 2e-6 (Adam's first
    update divides by |g|, so gradients 1e-7 apart stay 1e-6 apart)."""
    runs = []
    for accum in (1, 2):
        model, optimizer = _model(jax_run)
        loss = make_train_step(model, optimizer, accum_steps=accum)(
            jax_run["tokens"])
        runs.append((loss.item(), dict(model.named_parameters())))
    assert abs(runs[0][0] - runs[1][0]) <= 1e-6
    for name, p in runs[0][1].items():
        assert (p - runs[1][1][name]).abs().max().item() <= 2e-6, name


def test_cpu_tensors_never_reach_a_backward_kernel(monkeypatch):
    """On the CPU the training path runs the plain versions only: a
    forward and backward through `flash_attention_diff`, fused and pair,
    launch nothing and never load a kernel library."""
    from attention_tpu_torch.ops import _native

    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(_native, "function", no_kernel)
    before = _native.launch_counts()
    q = torch.randn(2, 4, 24, 8, requires_grad=True)
    for two in (False, True):
        monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", two)
        flash_attention_diff(q, q, q, causal=True).sum().backward()
    assert _native.launch_counts() == before
    assert q.grad is not None and bool(q.grad.isfinite().all())


def test_unported_training_features_raise():
    q = torch.zeros(8, 16, requires_grad=True)
    for kw in ({"block_sizes": (8, 8)},
               {"q_segment_ids": torch.zeros(8, dtype=torch.int32),
                "kv_segment_ids": torch.zeros(8, dtype=torch.int32)},
               {"max_mode": "flashd"}):
        with pytest.raises(NotImplementedError):
            flash_attention_diff(q, q, q, causal=True, **kw)
    with pytest.raises(NotImplementedError):
        flash_bwd.flash_backward(q, q, q, q, torch.zeros(8), q, scale=1.0,
                                 causal=True, block_sizes=(8, 8))
    with pytest.raises(ValueError):
        flash_attention_diff(q, q, q, bwd_impl="mosaic")
    with pytest.raises(NotImplementedError):
        TinyDecoder(device="cpu", tp_axis="tp", **SMALL)
    with pytest.raises(ValueError):
        make_train_step(TinyDecoder(device="cpu", **SMALL), None,
                        accum_steps=0)


# the masters test's model: bf16, one block; a batch whose inputs hold
# every token id, so that every weight, the embedding's rows included,
# gets a gradient
MASTERS = dict(vocab=64, dim=64, depth=1, num_q_heads=4, num_kv_heads=2,
               rope=True, softcap=20.0)
MASTERS_LR = 1e-5
# relative L2 of the port's three-step master update against JAX's, per
# parameter.  Both compute in bf16, but round at other points (their
# first losses part by 3e-4 of the loss), so a bf16 gradient element can
# come out a few ulps apart; Adam's update, lr·m/(sqrt(v) + eps), is
# near lr·sign(g) for these three steps and moves by up to 2 lr where a
# small g differs.  Measured 8.6e-4 (the final norm) to 0.214 (a
# block's 64-element norm scale; the weights 0.048-0.080); twice the
# largest reading.  Updating the bf16 weights themselves, with bf16
# moments, leaves 95-98% of them in place: measured 0.98-0.99 on each
# bf16 weight
MASTERS_REL_TOL = 0.5


def test_bf16_model_trains_float32_masters_as_jax():
    """A bf16 model against JAX's `TinyDecoder(dtype=bfloat16)` (float32
    params, bf16 compute) at lr 1e-5 for three AdamW steps: the masters
    and the moments are float32, every master element moves (a bf16
    weight of ~0.1 cannot take a step of 1e-5), the update is JAX's
    within `MASTERS_REL_TOL`, and the model's weights are the masters
    rounded."""
    jmodel = JaxDecoder(impl="flash", dtype=jnp.bfloat16, **MASTERS)
    mesh = jax_train.make_mesh_3d(1)
    params, _, opt_state = jax_train.init_sharded(
        jmodel, mesh, batch=2, seq=64, seed=0, lr=MASTERS_LR)
    rng = np.random.default_rng(11)
    tokens = np.stack([np.append(rng.permutation(MASTERS["vocab"]), 0)
                       for _ in range(2)])
    init = params_from_jax(jax.device_get(params))
    step = jax_train.make_train_step(jmodel, optax.adamw(MASTERS_LR), mesh)
    for _ in range(3):
        params, opt_state, _ = step(params, opt_state,
                                    jnp.asarray(tokens, jnp.int32))
    final = params_from_jax(jax.device_get(params))

    model = TinyDecoder(dtype=torch.bfloat16, device="cpu", **MASTERS)
    optimizer = init_train(model, lr=MASTERS_LR, params=init)
    train_step = make_train_step(model, optimizer)
    for _ in range(3):
        train_step(torch.from_numpy(tokens))
    for name, p in model.named_parameters():
        master = optimizer.masters[name]
        assert master.dtype == torch.float32, name
        assert all(s.dtype == torch.float32 for k, s in
                   optimizer.state[master].items() if k != "step"), name
        moved, want = master - init[name], final[name] - init[name]
        assert bool((moved != 0).all()), name
        assert ((moved - want).norm() / want.norm()).item() \
            <= MASTERS_REL_TOL, name
        assert torch.equal(p.detach(), master.to(p.dtype)), name


@pytest.mark.parametrize("moe", [None, 4], ids=["dense", "moe"])
def test_remat_gives_the_same_bits(monkeypatch, moe):
    """``remat=True`` recomputes each block in the backward pass (each
    block runs twice) and gives the same loss, aux loss included once,
    and gradients, bit for bit; a cached call ignores it."""
    models, calls = [], []
    for remat in (False, True):
        model = TinyDecoder(dtype=torch.float32, device="cpu", remat=remat,
                            moe_experts=moe, **SMALL)
        model.load_state_dict(init_params(model, 0))
        for block in model.blocks:
            block.register_forward_pre_hook(
                lambda *args, remat=remat: calls.append(remat))
        models.append(model)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, SMALL["vocab"], (2, 33)))
    losses = []
    for model in models:
        loss = loss_fn(model, tokens)
        loss.backward()
        losses.append(loss)
    assert calls.count(False) == SMALL["depth"]
    assert calls.count(True) == 2 * SMALL["depth"]
    assert torch.equal(losses[0], losses[1])
    for (name, a), (_, b) in zip(*(m.named_parameters() for m in models)):
        assert torch.equal(a.grad, b.grad), name

    from attention_tpu_torch.models import transformer

    def refuse(*args, **kwargs):
        raise AssertionError("a cached call took the remat path")

    monkeypatch.setattr(transformer, "checkpoint", refuse)
    with torch.no_grad():
        outs = [m(tokens, m.init_caches(2, 64))[0] for m in models]
    assert torch.equal(*outs)
