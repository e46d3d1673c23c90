"""GPipe pipeline parallelism in the port against the JAX package, on the
CPU: `parallel.pipeline_apply`, and `models.pipeline`'s
`stack_block_params`, `pipelined_forward` and the pipelined train step
(`init_pipelined_train`, `make_pipelined_train_step`).

The port's side runs in one gloo world of 4 CPU processes
(`torch.multiprocessing.spawn`), every rank running every case and
saving its outputs; the spawned ranks import this module, so it imports
JAX only inside the functions that run in the test process, which
computes the JAX side on the conftest's virtual CPU devices while the
world runs.

* `pipeline_apply` of tests/test_pipeline.py's toy stage (tanh(x @ w +
  b), d 16, batch 8) on 4 stages with 2, 4 and 8 microbatches, and on 2
  stages of a ("dp", "pp") (2, 2) grid (each dp line its own pipeline),
  against JAX's `pipeline_apply` on a mesh of the same shape and the
  sequential chain: the output atol and rtol 1e-6; the gradients of
  sum(out²) with respect to the whole stage parameters and the input,
  whole on every rank, atol 1e-5 and rtol 1e-4 (tests/test_pipeline.py's).
* `pipelined_forward` over JAX's feature matrix (tests/test_pipeline.py:
  rope on 2 and 4 stages, window 8, MoE at capacity factor 8.0, remat;
  vocab 31, dim 32, 4 / 2 heads, f32, 4 x 12 tokens, 2 microbatches)
  with JAX's flax weights through `params_from_jax`, against JAX's
  `pipelined_forward` and the port's own ``model(tokens)``, atol 2e-4
  and rtol 1e-3 (tests/test_pipeline.py's).
* One pipelined step (vocab 64, dim 32, depth 4 on 4 stages, 4 x 17
  tokens, 2 microbatches): its loss against ``jax.value_and_grad`` of
  JAX's pipelined loss, rtol 1e-5, and every parameter's gradient,
  taken from the rank that holds it, within 1e-5 of the largest of
  JAX's; each rank's masters and moments hold only its stage's block and
  the embedding, norm and head; five steps lower the loss, and the
  replicated tensors are the same bits on every rank after each.
* The refusals with JAX's words ("not divisible", "leading axis",
  "divisible", "ep_axis"), a tp or cp model, and `make_train_step` on a
  "pp" mesh naming `make_pipelined_train_step`.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from attention_tpu_torch.models import (
    TinyDecoder,
    init_pipelined_train,
    init_train,
    make_pipelined_train_step,
    make_train_step,
    pipelined_forward,
    pipelined_loss,
    stack_block_params,
)
from attention_tpu_torch.parallel import pipeline_apply
from attention_tpu_torch.parallel.mesh import Mesh, grid_mesh

WORLD = 4
OUT_TOL, GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5, 1e-4
FWD_ATOL, FWD_RTOL = 2e-4, 1e-3
STEP_RTOL = 1e-5
# the toy pipelines: (mesh axes, sizes, microbatches)
TOY = dict(d=16, batch=8)
PIPES = {
    "stages4_micro2": (("pp",), (4,), 2),
    "stages4_micro4": (("pp",), (4,), 4),
    "stages4_micro8": (("pp",), (4,), 8),
    "dp2_stages2": (("dp", "pp"), (2, 2), None),
}
# tests/test_pipeline.py's feature matrix: (stages, depth, model keywords)
SMALL = dict(vocab=31, dim=32, num_q_heads=4, num_kv_heads=2)
FORWARD = {
    "stages2_depth4_rope": (2, 4, dict(rope=True)),
    "stages4_depth4_rope": (4, 4, dict(rope=True)),
    "stages2_window8": (2, 2, dict(window=8)),
    "stages2_moe": (2, 2, dict(moe_experts=4, moe_capacity_factor=8.0)),
    "stages2_remat": (2, 2, dict(rope=True, remat=True)),
}
FWD_TOKENS, FWD_MICRO = (4, 12), 2
# the train step: tests/test_pipeline.py's model on 4 stages
TRAIN = dict(vocab=64, dim=32, depth=4, num_q_heads=4, num_kv_heads=2)
TRAIN_TOKENS, TRAIN_MICRO, TRAIN_STEPS = (4, 17), 2, 5
REPLICATED = ("embed.weight", "norm.scale", "head.weight")


def _toy_inputs(stages):
    rng = np.random.default_rng(stages)
    d, b = TOY["d"], TOY["batch"]
    params = {"w": rng.standard_normal((stages, d, d)) * 0.5,
              "b": rng.standard_normal((stages, d)) * 0.1}
    x = rng.standard_normal((b, d))
    return ({k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


def _toy_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _sequential(params, x):
    for s in range(params["w"].shape[0]):
        x = _toy_stage({k: v[s] for k, v in params.items()}, x)
    return x


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _model(**kw):
    return TinyDecoder(dtype=torch.float32, device="cpu", **kw)


def _pp_mesh(stages):
    """4 stages on the world's 4 ranks, or 2 on each dp line of 2."""
    if stages == WORLD:
        return grid_mesh(("pp",), (WORLD,))
    return grid_mesh(("dp", "pp"), (WORLD // stages, stages))


def _port_pipes():
    out = {}
    for name, (axes, sizes, n_micro) in PIPES.items():
        mesh = grid_mesh(axes, sizes)
        params, x = _toy_inputs(sizes[-1])
        params = {k: torch.from_numpy(v).requires_grad_()
                  for k, v in params.items()}
        x = torch.from_numpy(x).requires_grad_()
        y = pipeline_apply(_toy_stage, params, x, mesh=mesh,
                           n_micro=n_micro)
        (y ** 2).sum().backward()
        out[name] = dict(out=y.detach().numpy(), x=x.grad.numpy(),
                         **{k: v.grad.numpy() for k, v in params.items()})
    return out


def _port_forward(params):
    out = {}
    for name, (stages, depth, kw) in FORWARD.items():
        model = _model(**SMALL, depth=depth, **kw)
        model.load_state_dict(params[name])
        tokens = torch.from_numpy(_tokens(FWD_TOKENS, SMALL["vocab"], 7))
        with torch.no_grad():
            got = pipelined_forward(model, tokens, mesh=_pp_mesh(stages),
                                    n_micro=FWD_MICRO)
            out[name] = (got.numpy(), model(tokens).numpy())
    return out


def _digest(t: torch.Tensor) -> bytes:
    return t.detach().numpy().tobytes()


def _port_train(params):
    """The pipelined step from JAX's weights: step 1's loss and this
    rank's gradients by name, the names of its masters and moments, then
    `TRAIN_STEPS` losses and after each step the replicated tensors'
    bytes."""
    mesh = _pp_mesh(WORLD)
    model = _model(**TRAIN)
    optimizer = init_pipelined_train(model, mesh, params=params["train"])
    step = make_pipelined_train_step(model, optimizer, mesh,
                                     n_micro=TRAIN_MICRO)
    batch = torch.from_numpy(_tokens(TRAIN_TOKENS, TRAIN["vocab"], 9))
    losses, replicated = [], []
    for i in range(TRAIN_STEPS):
        losses.append(step(batch).item())
        if i == 0:
            grads = {n: optimizer.masters[n].grad.numpy().copy()
                     for n, _ in optimizer.named}
        params_now = dict(model.named_parameters())
        replicated.append({n: _digest(params_now[n]) for n in REPLICATED})
    state = {n: sorted(k for k in optimizer.state[m] if k != "step")
             for n, m in optimizer.masters.items()}
    return dict(losses=losses, grads=grads, state=state,
                replicated=replicated)


def _worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        outs = {"pipes": _port_pipes()}
        params_file = os.path.join(out_dir, "params.pt")
        while not os.path.exists(params_file):  # the test process writes it
            time.sleep(0.1)
        params = torch.load(params_file)
        outs["forward"] = _port_forward(params)
        outs["train"] = _port_train(params)
        torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the JAX side


def _jax_mesh(axes, sizes):
    import jax
    from jax.sharding import Mesh as JaxMesh

    n = int(np.prod(sizes))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(sizes), axes)


def _jax_model(**kw):
    import jax.numpy as jnp

    from attention_tpu.models import TinyDecoder as JaxDecoder

    return JaxDecoder(impl="xla", dtype=jnp.float32, **kw)


def _jax_params():
    """{case: flax params} of every model the world runs."""
    import jax
    import jax.numpy as jnp

    out = {}
    models = {name: dict(SMALL, depth=depth, **kw)
              for name, (_, depth, kw) in FORWARD.items()}
    models["train"] = TRAIN
    for name, kw in models.items():
        out[name] = jax.device_get(jax.jit(_jax_model(**kw).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    return out


def _jax_reference(params):
    """JAX's `pipeline_apply` (output and gradients), `pipelined_forward`
    and the pipelined loss and gradients of its train step."""
    import jax
    import jax.numpy as jnp

    from attention_tpu.models.pipeline import pipelined_forward as jax_fwd
    from attention_tpu.parallel.pipeline import pipeline_apply as jax_pipe
    from attention_tpu_torch.models import params_from_jax

    def toy_stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    pipes = {}
    for name, (axes, sizes, n_micro) in PIPES.items():
        mesh = _jax_mesh(axes, sizes)
        params_np, x = _toy_inputs(sizes[-1])

        def loss(p, x, mesh=mesh, n_micro=n_micro):
            y = jax_pipe(toy_stage, p, x, mesh=mesh, n_micro=n_micro)
            return jnp.sum(y ** 2), y

        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params_np, jnp.asarray(x))
        pipes[name] = dict(out=np.asarray(y), x=np.asarray(gx),
                           **{k: np.asarray(v) for k, v in gp.items()})
    forward = {}
    tokens = jnp.asarray(_tokens(FWD_TOKENS, SMALL["vocab"], 7), jnp.int32)
    for name, (stages, depth, kw) in FORWARD.items():
        jmodel = _jax_model(**SMALL, depth=depth, **kw)
        forward[name] = np.asarray(jax.jit(
            lambda p, t, m=jmodel, s=stages: jax_fwd(
                m, p, t, mesh=_jax_mesh(("pp",), (s,)),
                n_micro=FWD_MICRO))(params[name], tokens))
    jmodel = _jax_model(**TRAIN)
    mesh = _jax_mesh(("pp",), (WORLD,))

    def train_loss(p, batch):  # JAX's make_pipelined_train_step loss
        logits = jax_fwd(jmodel, p, batch[:, :-1], mesh=mesh,
                         n_micro=TRAIN_MICRO)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(logp, batch[:, 1:, None], axis=-1)[..., 0]
        return -jnp.mean(ll)

    batch = jnp.asarray(_tokens(TRAIN_TOKENS, TRAIN["vocab"], 9), jnp.int32)
    loss, grads = jax.jit(jax.value_and_grad(train_loss))(params["train"],
                                                          batch)
    grads = {n: g.numpy() for n, g in
             params_from_jax(jax.device_get(grads)).items()}
    return dict(pipes=pipes, forward=forward, loss=float(loss), grads=grads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's outputs, the JAX side): the world of 4 spawned once,
    the JAX side computed while it runs."""
    from attention_tpu_torch.models import params_from_jax

    out = tmp_path_factory.mktemp("pipeline_world")
    ctx = mp.spawn(_worker, nprocs=WORLD, join=False,
                   args=(WORLD, str(out / "init"), str(out)))
    try:
        params = _jax_params()
        torch.save({k: params_from_jax(p) for k, p in params.items()},
                   out / "params.tmp")
        os.replace(out / "params.tmp", out / "params.pt")
        jax_side = _jax_reference(params)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("gloo world of 4 hung")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_side


# -------------------------------------------------------- pipeline_apply


@pytest.mark.parametrize("name", sorted(PIPES))
def test_pipeline_apply_matches_jax_and_sequential(world, name):
    """The output on every rank against JAX's `pipeline_apply` on a mesh
    of the same shape and against the sequential chain."""
    ranks, jax_side = world
    params, x = _toy_inputs(PIPES[name][1][-1])
    want = _sequential({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x)).numpy()
    for outs in ranks:
        got = outs["pipes"][name]["out"]
        np.testing.assert_allclose(got, jax_side["pipes"][name]["out"],
                                   atol=OUT_TOL, rtol=OUT_TOL)
        np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)


@pytest.mark.parametrize("name", sorted(PIPES))
def test_pipeline_apply_gradients_match_jax(world, name):
    """The gradients of sum(out²) with respect to the whole stage
    parameters and the input, whole and the same bits on every rank,
    against JAX's and the sequential chain's."""
    ranks, jax_side = world
    params, x = _toy_inputs(PIPES[name][1][-1])
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in params.items()}
    x = torch.from_numpy(x).requires_grad_()
    (_sequential(params, x) ** 2).sum().backward()
    seq = {"x": x.grad.numpy(), **{k: v.grad.numpy()
                                   for k, v in params.items()}}
    for key in ("w", "b", "x"):
        got = ranks[0]["pipes"][name][key]
        for outs in ranks[1:]:
            assert np.array_equal(outs["pipes"][name][key], got), key
        for want in (jax_side["pipes"][name][key], seq[key]):
            np.testing.assert_allclose(got, want, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=key)


# ---------------------------------------------------- the decoder stack


def test_stack_block_params_matches_jax():
    """`stack_block_params` of a converted flax tree holds JAX's stacked
    blocks (the port's layout of each), stage-major; stages that do not
    divide the depth raise JAX's words."""
    import jax
    import jax.numpy as jnp

    from attention_tpu.models.pipeline import stack_block_params as jax_stack
    from attention_tpu_torch.models import params_from_jax

    kw = dict(SMALL, depth=4)
    params = jax.device_get(jax.jit(_jax_model(**kw).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port = params_from_jax(params)
    stacked = stack_block_params(port, 4, 2)
    want = jax_stack(params, 4, 2)
    assert stacked["attn.q_proj.weight"].shape[:2] == (2, 2)
    assert jax.tree_util.tree_leaves(want)[0].shape[:2] == (2, 2)
    for s in range(2):
        for j in range(2):
            # JAX's stage s, block j as the tree's first block, converted
            tree = dict(params, TransformerBlock_0=jax.tree_util.tree_map(
                lambda a, s=s, j=j: a[s, j], want))
            block = params_from_jax(tree)
            for n, t in stacked.items():
                assert torch.equal(t[s, j], block[f"blocks.0.{n}"]), n
    with pytest.raises(ValueError, match="divisible"):
        stack_block_params(port, 4, 3)


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_pipelined_forward_matches_jax_and_plain_forward(world, name):
    """`pipelined_forward` on every rank against JAX's `pipelined_forward`
    and the port's own ``model(tokens)`` on the same weights."""
    ranks, jax_side = world
    for outs in ranks:
        got, plain = outs["forward"][name]
        np.testing.assert_allclose(got, jax_side["forward"][name],
                                   atol=FWD_ATOL, rtol=FWD_RTOL)
        np.testing.assert_allclose(got, plain, atol=FWD_ATOL, rtol=FWD_RTOL)


def test_pipelined_step_loss_and_grads_match_jax(world):
    """Step 1's loss against ``jax.value_and_grad`` of JAX's pipelined
    loss, rtol 1e-5, and every parameter's gradient, from the rank whose
    stage holds it (the replicated ones the same bits on every rank),
    within 1e-5 of the largest magnitude of JAX's."""
    ranks, jax_side = world
    for outs in ranks:
        loss = outs["train"]["losses"][0]
        assert abs(loss - jax_side["loss"]) <= STEP_RTOL * jax_side["loss"]
    got = {}
    for outs in ranks:
        for n, g in outs["train"]["grads"].items():
            if n in got:
                assert np.array_equal(got[n], g), n
            got[n] = g
    want = jax_side["grads"]
    assert sorted(got) == sorted(want)
    for n, g in got.items():
        scale = np.abs(want[n]).max()
        assert np.abs(g - want[n]).max() <= STEP_RTOL * scale, n


def test_each_rank_holds_its_stage_and_the_replicated_tensors(world):
    """A rank's masters and moments are its stage's block (depth 4 on 4
    stages) and the embedding, norm and head, nothing else."""
    ranks, _ = world
    for p, outs in enumerate(ranks):
        state = outs["train"]["state"]
        blocks = {n.split(".")[1] for n in state if n.startswith("blocks.")}
        assert blocks == {str(p)}, p
        assert set(REPLICATED) <= set(state)
        assert all(v == ["exp_avg", "exp_avg_sq"] for v in state.values())


def test_pipelined_steps_lower_the_loss_and_keep_replicas_equal(world):
    """Five steps lower the loss, the losses are the same on every rank,
    and after each step the embedding, norm and head are the same bits on
    every rank."""
    ranks, _ = world
    losses = ranks[0]["train"]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for outs in ranks[1:]:
        assert outs["train"]["losses"] == losses
        assert outs["train"]["replicated"] == ranks[0]["train"]["replicated"]


# ------------------------------------------------------------ refusals


def _stand_in(axes, sizes):
    """A one-rank stand-in for a mesh of these sizes: the refusals read
    only its shape."""
    return Mesh(axes, sizes, (0,) * len(axes), [[0] * s for s in sizes],
                (None,) * len(axes))


def _toy_refusal(stages, batch):
    params, _ = _toy_inputs(4)
    params = {k: torch.from_numpy(v[:stages]) for k, v in params.items()}
    pipeline_apply(_toy_stage, params, torch.zeros(batch, TOY["d"]),
                   mesh=_stand_in(("pp",), (4,)), n_micro=4)


def _model_refusal(depth=2, stages=2, **kw):
    mesh = _stand_in(("pp", "tp", "sp"), (stages, 2, 2))
    model = _model(**SMALL, depth=depth, **kw)
    pipelined_forward(model, torch.zeros(4, 8, dtype=torch.long), mesh=mesh)


REFUSED = {
    "batch": ("not divisible", lambda: _toy_refusal(4, 6)),
    "stages": ("leading axis", lambda: _toy_refusal(3, 8)),
    "depth": ("divisible", lambda: _model_refusal(depth=4, stages=3)),
    "ep_axis": ("ep_axis", lambda: _model_refusal(
        moe_experts=4, ep_axis="ep")),
    "tp_model": ("tp_axis", lambda: _model_refusal(
        tp_axis="tp", mesh=_stand_in(("tp",), (2,)))),
    "cp_model": ("cp_axis", lambda: _model_refusal(
        cp_axis="sp", mesh=_stand_in(("sp",), (2,)))),
    "train_step_on_pp": ("make_pipelined_train_step", lambda: make_train_step(
        _model(**SMALL, depth=2), None, _stand_in(("pp",), (2,)))),
    "init_train_on_pp": ("make_pipelined_train_step", lambda: init_train(
        _model(**SMALL, depth=2), mesh=_stand_in(("pp",), (2,)))),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(case):
    """JAX's refusals (batch, stage count, depth, ep_axis), a model whose
    blocks shard over tp or cp (JAX's `_block_module` builds them without
    those axes), and the dp x sp x tp trainer on a "pp" mesh, each a
    `ValueError` with these words, before any collective."""
    words, call = REFUSED[case]
    with pytest.raises(ValueError, match=words):
        call()


def test_pipelined_loss_on_one_stage_is_the_plain_loss():
    """On a one-rank mesh the pipelined loss is the plain model's cross
    entropy (no aux loss) to f32 rounding, and its gradients reach every
    parameter."""
    model = _model(**TRAIN)
    init_train(model, seed=3)
    batch = torch.from_numpy(_tokens(TRAIN_TOKENS, TRAIN["vocab"], 9))
    loss = pipelined_loss(model, batch, mesh=_stand_in(("pp",), (1,)),
                          n_micro=2)
    logits = model(batch[:, :-1])
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), batch[:, 1:].reshape(-1))
    assert abs(loss.item() - want.item()) <= STEP_RTOL * want.item()
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
