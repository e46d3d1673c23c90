"""The mesh trainer's parameter layouts in the port against the JAX
package, on the CPU: `param_spec` / `legal_spec` / `fsdp_spec` and
`shard_params`, Megatron's tp split of `TinyDecoder`, FSDP, MoE experts
over tp with JAX's global capacity, slots and aux loss, experts over the
tokens' axes by all-to-alls, `MoEMLP(ep_axis=)`, the checkpoint on a
mesh and `train_with_recovery(model, mesh, ...)`.

The port's side runs in gloo worlds of 4 CPU processes
(`torch.multiprocessing.spawn`): one for the module, every rank running
every case and saving its outputs, and three small ones for the resume
test (uninterrupted, crashed, resumed).  The spawned ranks import this
module, so it imports JAX only inside the functions that run in the test
process, which computes the JAX side while the world runs.

* Layout: every parameter's spec, in JAX's axis order, equals JAX's
  ``_legal_spec(_param_spec(...))`` (and ``_fsdp_spec`` of it with
  ``fsdp``) on JAX meshes of the same shapes, dense and MoE, and with a
  vocab of 61 on tp 2 (the embedding and head replicated); 2 kv heads on
  tp 4 replicate k and v.
* Loss and gradients: `value_and_grad` of the small model (vocab 64, dim
  64, depth 1, 4 / 2 heads, f32) with JAX's flax weights through
  `params_from_jax`, on (dp, sp, tp) = (1, 1, 4), (2, 1, 2) with FSDP,
  (1, 2, 2) with ``cp_axis="sp"`` ring (129 positions, padded), and the
  MoE model (4 experts, top 2, capacity factor 1.25, so that pairs drop)
  on (2, 1, 2) with ``ep_axis="tp"`` (with and without FSDP), on
  (1, 2, 2) ring, on (4, 1, 1) with ``ep_axis="dp"`` and on (1, 4, 1)
  ring with ``ep_axis="sp"`` (the experts over the tokens' axis: a
  quarter a rank, the tokens moved by all-to-alls), and head counts tp
  does not divide (6 / 3 heads on tp 4, 12 / 3 on tp 2): the whole
  gradients gathered from the blocks against
  ``jax.value_and_grad(loss_fn)`` of JAX's single-device ``impl="xla"``
  model, loss rtol 1e-5, gradients 3e-5 max abs (tests/test_cp.py's);
  the two expert-parallel cases also against the same model with its
  experts replicated on the same mesh.
* Three steps against JAX's own `init_sharded` (its flax init jitted) +
  `make_train_step` on a JAX mesh of the same shape, loss rtol 1e-5: on (2, 1, 2) dense with
  and without FSDP and the MoE model (experts over tp) with it, the MoE
  model with ``ep_axis="dp"`` on (4, 1, 1) and with ``ep_axis="sp"`` on
  (1, 4, 1) (the port's attention by the ring, JAX's by XLA over the
  sequence); each rank of those two holds E / 4 experts and a quarter of
  their float32 state; the FSDP
  run's losses and masters the bits of the replicated run's; a 2-D
  parameter split over dp; each rank's masters and moments 1 / (dp·tp)
  of the whole; replicated parameters (and blocks) the same bits on
  every rank that holds them.
* `MoEMLP(ep_axis="ep")` on a 4-rank "ep" mesh against the unsharded
  layer and JAX's, 1e-5 (tests/test_moe.py's); the trainer refuses an
  ``ep_axis`` that sits beside a "tp" splitting the experts.
* A checkpoint written on (2, 1, 2) with FSDP restores on (1, 1, 4) to
  the same whole tensors; a single-device model's checkpoint is written
  on every rank of the world; `train_with_recovery` on (2, 1, 2) with FSDP,
  every rank dying at step 3 of 6, resumes in a new world to the
  uninterrupted run's losses and masters, bit for bit
  (tests/test_resilient.py's contract).
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from attention_tpu_torch.models import (
    MoEMLP,
    TinyDecoder,
    init_train,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    train_with_recovery,
    value_and_grad,
)
from attention_tpu_torch.models.train import ParamLayout
from attention_tpu_torch.parallel.mesh import Mesh, default_mesh, grid_mesh

WORLD = 4
AXES = ("dp", "sp", "tp")
LOSS_RTOL, GRAD_ATOL = 1e-5, 3e-5
MOE_ATOL = 1e-5
MODEL = dict(vocab=64, dim=64, depth=1, num_q_heads=4, num_kv_heads=2)
MOE = dict(moe_experts=4, moe_capacity_factor=1.25)
TOKENS = {"short": (4, 33), "long": (4, 130), "sp4": (4, 132)}
# the models beside MODEL: MoE, and head counts that tp does not divide
KINDS = {"dense": {}, "moe": MOE,
         # 6 q heads on tp 4: every head on every rank, o_proj gathered
         "heads6": dict(dim=96, num_q_heads=6, num_kv_heads=3),
         # 12 q / 3 kv heads on tp 2: a rank's 6 q heads read kv heads
         # 0, 0, 0, 0, 1, 1 (rank 0), one kv head a q head
         "heads12": dict(dim=96, num_q_heads=12, num_kv_heads=3)}
# name: (mesh sizes, model keywords, fsdp, tokens, JAX model)
GRADS = {
    "tp4": ((1, 1, 4), {}, False, "short", "dense"),
    "dp2_tp2_fsdp": ((2, 1, 2), {}, True, "short", "dense"),
    "sp2_tp2_ring": ((1, 2, 2), dict(cp_axis="sp", cp_impl="ring"), False,
                     "long", "dense"),
    "moe_dp2_tp2": ((2, 1, 2), dict(MOE, ep_axis="tp"), False, "short",
                    "moe"),
    "moe_dp2_tp2_fsdp": ((2, 1, 2), dict(MOE, ep_axis="tp"), True, "short",
                         "moe"),
    "moe_sp2_tp2_ring": ((1, 2, 2), dict(MOE, cp_axis="sp", cp_impl="ring"),
                         False, "long", "moe"),
    "tp4_heads6": ((1, 1, 4), KINDS["heads6"], False, "short", "heads6"),
    "dp2_tp2_heads12": ((2, 1, 2), KINDS["heads12"], False, "short",
                        "heads12"),
    # experts over the axes that split the tokens: an all-to-all each way
    "moe_dp4_ep": ((4, 1, 1), dict(MOE, ep_axis="dp"), False, "short",
                   "moe"),
    "moe_sp4_ring_ep": ((1, 4, 1), dict(MOE, ep_axis="sp", cp_axis="sp",
                                        cp_impl="ring"), False, "long",
                        "moe"),
}
# the expert-parallel cases of GRADS, each also run with its experts
# replicated (no ep_axis) on the same mesh
EP_CASES = ("moe_dp4_ep", "moe_sp4_ring_ep")
STEP_MESH = (2, 1, 2)
STEPS = 3
# the three-step runs: (mesh sizes, the port's model keywords, fsdp,
# tokens, kind); JAX's sharded step runs the kind's model with the same
# ep_axis, its attention by XLA over the sequence where the port's runs
# the ring
STEP_RUNS = {
    "dense": (STEP_MESH, {}, False, "short", "dense"),
    "dense_fsdp": (STEP_MESH, {}, True, "short", "dense"),
    "moe_fsdp": (STEP_MESH, dict(MOE, ep_axis="tp"), True, "short", "moe"),
    "moe_dp4_ep": ((4, 1, 1), dict(MOE, ep_axis="dp"), False, "short",
                   "moe"),
    "moe_sp4_ep": ((1, 4, 1), dict(MOE, ep_axis="sp", cp_axis="sp",
                                   cp_impl="ring"), False, "sp4", "moe"),
}
# the layout cases: (mesh sizes, model keywords)
LAYOUTS = {f"{'x'.join(map(str, sizes))}_{kind}": (sizes, kw)
           for sizes in ((1, 1, 4), (2, 1, 2), (1, 2, 2))
           for kind, kw in (("dense", {}), ("moe", MOE))}
LAYOUTS["2x1x2_vocab61"] = ((2, 1, 2), dict(vocab=61))
# the ep case: tests/test_moe.py's layer (dim 32, 8 experts, top 2)
EP = dict(dim=32, experts=8, shape=(2, 16, 32))
# the resume test: steps, checkpoint period, the step every rank dies
# after, on the (2, 1, 2) mesh with FSDP
RESUME = dict(steps=6, every=2, crash=3)


def _tokens(kind):
    return np.random.default_rng(11).integers(0, MODEL["vocab"],
                                              TOKENS[kind])


def _stand_in(sizes):
    """A one-rank stand-in for a mesh of these (dp, sp, tp) sizes: its
    shape is all the layout table reads."""
    return Mesh(AXES, sizes, (0, 0, 0), [[0] * s for s in sizes],
                (None, None, None))


def _model(mesh=None, **kw):
    return TinyDecoder(dtype=torch.float32, device="cpu", mesh=mesh,
                       **{**MODEL, **kw})


def _whole(model, tensors):
    """{name: whole numpy} of one block per trained parameter."""
    names = [n for n, _ in model.named_parameters()]
    return {n: model.layout.whole(n, t.detach()).numpy()
            for n, t in zip(names, tensors)}


def _port_grads(name, params, replicated=False):
    """`value_and_grad` of a `GRADS` case: the loss and whole gradients;
    with ``replicated``, of its model without ``ep_axis``."""
    sizes, kw, fsdp, tokens, kind = GRADS[name]
    if replicated:
        kw = {k: v for k, v in kw.items() if k != "ep_axis"}
    mesh = grid_mesh(AXES, sizes)
    model = _model(mesh, **kw)
    init_train(model, params=params[kind], mesh=mesh, fsdp=fsdp)
    loss, grads = value_and_grad(model, torch.from_numpy(_tokens(tokens)),
                                 mesh)
    return loss.item(), _whole(model, grads)


def _port_steps(params, run):
    """`STEPS` steps of a `STEP_RUNS` run from JAX's weights: the losses,
    the whole masters, this rank's blocks and its specs, the numbers of
    elements of this rank's masters + moments and of the whole model's,
    and of its experts' alone."""
    sizes, kw, fsdp, tokens, kind = STEP_RUNS[run]
    mesh = grid_mesh(AXES, sizes)
    model = _model(mesh, **kw)
    optimizer = init_train(model, params=params[kind], mesh=mesh,
                           fsdp=fsdp)
    step = make_train_step(model, optimizer, mesh)
    tokens = torch.from_numpy(_tokens(tokens))
    losses = [step(tokens).item() for _ in range(STEPS)]
    masters = _whole(model, [m for _, m in optimizer.pairs()])
    def state(keep):
        return sum(m.numel() + sum(t.numel() for k, t in
                                   optimizer.state[m].items() if k != "step")
                   for (n, _), (_, m) in zip(optimizer.named,
                                             optimizer.pairs()) if keep(n))

    local = state(lambda n: True)
    whole = 3 * sum(p.size for p in masters.values())
    blocks = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    coords = {n: tuple(mesh.index(a) if a is not None else None
                       for a in spec)
              for n, spec in model.layout.specs.items()}
    expert_whole = 3 * sum(p.size for n, p in masters.items()
                           if "experts" in n)
    return dict(losses=losses, masters=masters, blocks=blocks,
                coords=coords, specs=dict(model.layout.specs),
                state_fraction=local / whole,
                expert_fraction=state(lambda n: "experts" in n)
                / max(expert_whole, 1))


def _port_ep():
    """`MoEMLP(ep_axis="ep")` on the world's "ep" mesh and unsharded, on
    the same weights and input."""
    torch.manual_seed(0)
    whole = MoEMLP(EP["dim"], EP["experts"], dtype=torch.float32,
                   device="cpu")
    for p in whole.parameters():
        torch.nn.init.normal_(p, std=EP["dim"] ** -0.5)
    sharded = MoEMLP(EP["dim"], EP["experts"], ep_axis="ep",
                     mesh=default_mesh("ep"), dtype=torch.float32,
                     device="cpu")
    sharded.load_state_dict(whole.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        EP["shape"]).astype(np.float32))
    with torch.no_grad():
        return ({k: v.numpy() for k, v in whole.state_dict().items()},
                x.numpy(), whole(x)[0].numpy(), sharded(x)[0].numpy())


def _port_checkpoint(params, ckpt_dir):
    """One FSDP step on (2, 1, 2), a checkpoint, and its restore on
    (1, 1, 4): the whole masters and moments on both meshes."""
    states = []
    for sizes, fsdp in (((2, 1, 2), True), ((1, 1, 4), False)):
        mesh = grid_mesh(AXES, sizes)
        model = _model()
        optimizer = init_train(model, params=params["dense"], mesh=mesh,
                               fsdp=fsdp)
        if fsdp:
            make_train_step(model, optimizer, mesh)(
                torch.from_numpy(_tokens("short")))
            save_checkpoint(ckpt_dir, 1, model, optimizer)
        else:
            assert restore_checkpoint(ckpt_dir, model, optimizer) == 1
        names = [n for n, _ in optimizer.named]
        states.append({
            "masters": _whole(model, [m for _, m in optimizer.pairs()]),
            **{key: {n: model.layout.whole(n, optimizer.state[m][key])
                     .numpy() for n, (_, m) in zip(names, optimizer.pairs())}
               for key in ("exp_avg", "exp_avg_sq")}})
    return states


def _port_single_checkpoint(params, ckpt_dir):
    """A single-device model's checkpoint, saved on this rank of the
    world: the step found on disk."""
    model = _model()
    optimizer = init_train(model, params=params["dense"])
    save_checkpoint(ckpt_dir, 1, model, optimizer)
    return latest_step(ckpt_dir)


def _worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        outs = {"ep": _port_ep()}
        params_file = os.path.join(out_dir, "params.pt")
        while not os.path.exists(params_file):  # the test process writes it
            time.sleep(0.1)
        params = torch.load(params_file)
        outs["grads"] = {n: _port_grads(n, params) for n in GRADS}
        outs["ep_replicated"] = {n: _port_grads(n, params, replicated=True)
                                 for n in EP_CASES}
        outs["steps"] = {run: _port_steps(params, run) for run in STEP_RUNS}
        outs["ckpt"] = _port_checkpoint(params,
                                        os.path.join(out_dir, "ckpt"))
        outs["single_ckpt"] = _port_single_checkpoint(
            params, os.path.join(out_dir, f"single{rank}"))
        torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the JAX side


def _jax_params(**kw):
    import jax
    import jax.numpy as jnp

    from attention_tpu.models import TinyDecoder as JaxDecoder

    jmodel = JaxDecoder(impl="xla", dtype=jnp.float32, **{**MODEL, **kw})
    return jmodel, jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _jax_mesh(sizes):
    import jax
    from jax.sharding import Mesh as JaxMesh

    return JaxMesh(np.asarray(jax.devices()[:WORLD]).reshape(sizes), AXES)


def _jax_init_sharded(jmodel, mesh, fsdp):
    """JAX's `init_sharded(jmodel, mesh, seed=0, lr=1e-3, fsdp=fsdp)`
    with its flax init under ``jax.jit`` (the eager init's bits; eager,
    an MoE model's sharding constraints take seconds op by op): the
    params placed by JAX's `shard_params`, adamw's state of them, its
    scalars replicated."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from attention_tpu.models import train as jax_train

    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((4, 32), jnp.int32))["params"]
    params = jax_train.shard_params(params, mesh, fsdp=fsdp)
    replicated = NamedSharding(mesh, PartitionSpec())
    state = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, replicated)
        if getattr(x, "ndim", None) == 0 else x,
        optax.adamw(1e-3).init(params))
    return params, state


def _jax_reference(models):
    """JAX's loss and gradients of each (model, tokens) of `GRADS` on
    one device, and its sharded 3 steps of each `STEP_RUNS` run."""
    import jax
    import jax.numpy as jnp
    import optax

    from attention_tpu.models import train as jax_train
    from attention_tpu.parallel.mesh import mesh_context
    from attention_tpu_torch.models import params_from_jax

    grads = {}
    for kind, tokens in {(c[4], c[3]) for c in GRADS.values()}:
        jmodel, params = models[kind]
        loss, g = jax.jit(jax.value_and_grad(jax_train.loss_fn),
                          static_argnums=1)(
            params, jmodel, jnp.asarray(_tokens(tokens), jnp.int32))
        grads[kind, tokens] = (float(loss), {
            n: t.numpy() for n, t in
            params_from_jax(jax.device_get(g)).items()})
    steps = {}
    for run, (sizes, kw, fsdp, tokens, kind) in STEP_RUNS.items():
        if run == "dense_fsdp":  # FSDP's trajectory is the replicated one's
            continue
        mesh = _jax_mesh(sizes)
        batch = jnp.asarray(_tokens(tokens), jnp.int32)
        jmodel = models[kind][0]
        if "ep_axis" in kw:
            jmodel = jmodel.clone(ep_axis=kw["ep_axis"])
        with mesh_context(mesh):
            params, state = _jax_init_sharded(jmodel, mesh, fsdp)
            step = jax_train.make_train_step(jmodel, optax.adamw(1e-3), mesh)
            losses = []
            for _ in range(STEPS):
                params, state, loss = step(params, state, batch)
                losses.append(float(loss))
        steps[run] = losses
    return dict(grads=grads, steps=steps)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's outputs, the JAX side): the world of 4 spawned once,
    the JAX side computed while it runs."""
    from attention_tpu_torch.models import params_from_jax

    out = tmp_path_factory.mktemp("mesh_train_world")
    ctx = mp.spawn(_worker, nprocs=WORLD, join=False,
                   args=(WORLD, str(out / "init"), str(out)))
    try:
        models = {kind: _jax_params(**kw) for kind, kw in KINDS.items()}
        torch.save({k: params_from_jax(p) for k, (_, p) in models.items()},
                   out / "params.tmp")
        os.replace(out / "params.tmp", out / "params.pt")
        jax_side = _jax_reference(models)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    _join(ctx, 240)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    jax_side["dir"] = str(out)
    return ranks, jax_side


def _join(ctx, seconds):
    deadline = time.monotonic() + seconds
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("gloo world of 4 hung")


def _same_on_every_rank(ranks, *keys):
    def get(outs):
        for key in keys:
            outs = outs[key]
        return outs

    want = get(ranks[0])
    for r, outs in enumerate(ranks[1:], 1):
        got = get(outs)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for n in want:
                assert np.array_equal(got[n], want[n]), (r, n)
        else:
            assert got == want, r
    return want


# ------------------------------------------------------------ the layout


def _port_path(path) -> str:
    """The port's parameter name of a JAX param path."""
    keys = [str(getattr(k, "key", k)) for k in path]
    top = {"Embed_0": "embed.weight", "RMSNorm_0": "norm.scale",
           "Dense_0": "head.weight"}
    if keys[0] in top:
        return top[keys[0]]
    pre = f"blocks.{keys[0].split('_')[-1]}."
    part = {"RMSNorm_0": "norm1.scale", "RMSNorm_1": "norm2.scale"}
    if keys[1] in part:
        return pre + part[keys[1]]
    if keys[1] == "GQASelfAttention_0":
        return f"{pre}attn.{keys[2]}.weight"
    if keys[1] == "MLP_0":
        return pre + {"Dense_0": "mlp.up.weight",
                      "Dense_1": "mlp.down.weight"}[keys[2]]
    return pre + {"router": "mlp.router.weight", "experts_up":
                  "mlp.experts_up", "experts_down": "mlp.experts_down"}[keys[2]]


@pytest.mark.parametrize("fsdp", (False, True))
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_table_matches_jax(name, fsdp):
    """Every parameter's spec, in JAX's axis order, and its JAX shape
    equal JAX's ``_legal_spec(_param_spec(...))`` (``_fsdp_spec`` of it
    with ``fsdp``) on a JAX mesh of the same shape."""
    import jax

    from attention_tpu.models import train as jax_train

    sizes, kw = LAYOUTS[name]
    _, params = _jax_params(**kw)
    mesh = _jax_mesh(sizes)
    want = {}
    for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
        spec = jax_train._legal_spec(jax_train._param_spec(path, x), x.shape,
                                     mesh)
        if fsdp:
            spec = jax_train._fsdp_spec(spec, x.shape, mesh)
        want[_port_path(path)] = (tuple(spec) + (None,) * (
            x.ndim - len(spec)), x.shape)
    layout = ParamLayout(_model(**kw), _stand_in(sizes), fsdp=fsdp)
    got = {n: (layout.specs[n], layout.shapes[n]) for n in layout.specs}
    assert got == want
    if sizes[2] == 4:  # 2 kv heads on tp 4: k and v replicated over tp
        assert "tp" not in layout.specs["blocks.0.attn.k_proj.weight"]
    if kw.get("vocab") == 61:
        assert "tp" not in layout.specs["embed.weight"] + \
            layout.specs["head.weight"]


def test_block_and_whole_round_trip():
    """`ParamLayout.block` cuts JAX's blocks out of the port's layout: a
    q projection split over heads (tp) and its model dim (dp) holds the
    JAX kernel's block, and every block together tiles the whole."""
    model = _model()
    layout = ParamLayout(model, _stand_in((2, 1, 2)), fsdp=True)
    name = "blocks.0.attn.q_proj.weight"
    assert layout.specs[name] == ("dp", "tp", None)
    w = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    kernel = w.T.reshape(64, 4, 16)  # JAX's (dim, heads, head_dim)
    seen = torch.zeros_like(w)
    for dp in range(2):
        for tp in range(2):
            layout.mesh._coords = dict(dp=dp, sp=0, tp=tp)
            block = layout.block(name, w)
            want = kernel[dp * 32:(dp + 1) * 32, tp * 2:(tp + 1) * 2]
            assert torch.equal(block, want.permute(1, 2, 0).reshape(32, 32))
            seen += torch.isin(w, block)
    assert torch.equal(seen, torch.ones_like(w))


# ------------------------------------------------- loss, gradients, steps


@pytest.mark.parametrize("name", sorted(GRADS))
def test_loss_and_grads_match_jax_single_device(world, name):
    """The whole gradients, gathered from every rank's blocks, and the
    global loss against JAX's single-device ``impl="xla"`` model; the
    same on every rank."""
    ranks, jax_side = world
    loss, grads = ranks[0]["grads"][name]
    _same_on_every_rank(ranks, "grads", name, 1)
    assert all(r["grads"][name][0] == loss for r in ranks)
    _, _, _, tokens, kind = GRADS[name]
    want_loss, want = jax_side["grads"][kind, tokens]
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert np.abs(g - want[n]).max() <= GRAD_ATOL, n


@pytest.mark.parametrize("run", sorted(STEP_RUNS))
def test_three_steps_match_jax_sharded_step(world, run):
    """Three steps from JAX's weights against JAX's own `init_sharded` +
    `make_train_step` on a JAX mesh of the same shape: on (2, 1, 2) the
    dense model with and without FSDP and the MoE model (experts over
    tp, pairs dropped) with FSDP, whose blocks a misplaced expert or
    FSDP block would carry into the second and third losses; the MoE
    model with its experts over the tokens' axis, "dp" on (4, 1, 1) and
    the ring's "sp" on (1, 4, 1), where the tokens reach their experts
    by all-to-alls (JAX's: by XLA's)."""
    ranks, jax_side = world
    losses = ranks[0]["steps"][run]["losses"]
    assert all(r["steps"][run]["losses"] == losses for r in ranks)
    want = jax_side["steps"]["dense" if run == "dense_fsdp" else run]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]


def test_fsdp_equals_replicated(world):
    """FSDP's trajectory is the replicated one's, bit for bit (the dp
    gradient is reduce-scattered by the replicated all-reduce's route):
    the losses and every whole master after 3 steps; a 2-D parameter is
    split over dp, and each rank's masters and moments are 1 / (dp·tp)
    of the whole (the replicated layout's 1 / tp and more)."""
    ranks, _ = world
    rep, fs = ranks[0]["steps"]["dense"], ranks[0]["steps"]["dense_fsdp"]
    assert fs["losses"] == rep["losses"]
    for n, m in rep["masters"].items():
        assert np.array_equal(fs["masters"][n], m), n
    assert any("dp" in s and len(s) == 2 for s in fs["specs"].values())
    dp, _, tp = STEP_MESH
    for r in ranks:
        assert r["steps"]["dense_fsdp"]["state_fraction"] == pytest.approx(
            1 / (dp * tp), rel=0.02)
        assert r["steps"]["dense"]["state_fraction"] > 1.5 / (dp * tp)


@pytest.mark.parametrize("fsdp", (False, True))
def test_step_leaves_same_bits_on_every_rank_that_holds_a_block(world,
                                                                 fsdp):
    """After 3 steps, ranks that hold the same block of a parameter (the
    same index along each axis that splits it; every rank for a
    replicated one) hold the same bits: the norms, the replicated k and
    v of (1, 1, 4) aside, every tp-replicated tensor included."""
    ranks, _ = world
    key = "dense_fsdp" if fsdp else "dense"
    names = ranks[0]["steps"][key]["blocks"]
    shared = replicated = 0
    for n in names:
        by_block = {}
        for r in ranks:
            run = r["steps"][key]
            by_block.setdefault(run["coords"][n], []).append(
                run["blocks"][n])
        for blocks in by_block.values():
            for b in blocks[1:]:
                assert np.array_equal(b, blocks[0]), n
            shared += len(blocks) > 1
        replicated += len(by_block) == 1
    assert shared and replicated >= (0 if fsdp else 3)


# ----------------------------------------------------------------- MoE


def test_moe_ep_sharded_matches_unsharded_and_jax(world):
    """`MoEMLP(ep_axis="ep")` on the 4-rank "ep" mesh (2 of the 8
    experts a rank, the outputs summed) against the unsharded layer and
    JAX's on the same weights, 1e-5 (tests/test_moe.py's)."""
    import jax.numpy as jnp

    from attention_tpu.models import MoEMLP as JaxMoE

    ranks, _ = world
    state, x, whole, _ = ranks[0]["ep"]
    for r in ranks:
        np.testing.assert_allclose(r["ep"][3], whole, atol=MOE_ATOL,
                                   rtol=MOE_ATOL)
    jmod = JaxMoE(num_experts=EP["experts"], top_k=2, dtype=jnp.float32)
    params = {"router": state["router.weight"].T,
              "experts_up": state["experts_up"],
              "experts_down": state["experts_down"]}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(whole, want, atol=MOE_ATOL, rtol=MOE_ATOL)


@pytest.mark.parametrize("name", EP_CASES)
def test_ep_over_the_tokens_matches_replicated_experts(world, name):
    """The MoE model with its experts over "dp" on (4, 1, 1), or over the
    ring's "sp" on (1, 4, 1), whose tokens reach their experts by
    all-to-alls, against the same model with its experts replicated on
    the same mesh: the loss rtol 1e-5, the whole gradients 3e-5 max abs
    (the routing, capacity and slots are the same global ones)."""
    ranks, _ = world
    loss, grads = ranks[0]["grads"][name]
    want_loss, want = ranks[0]["ep_replicated"][name]
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert np.abs(g - want[n]).max() <= GRAD_ATOL, n


@pytest.mark.parametrize("run", ("moe_dp4_ep", "moe_sp4_ep"))
def test_ep_rank_holds_a_quarter_of_the_experts(world, run):
    """Each of the 4 ranks of the tokens' axis holds its own E / 4
    experts, of both weights, and their masters and moments: a quarter
    of the experts' float32 state."""
    ranks, _ = world
    axis = STEP_RUNS[run][1]["ep_axis"]
    held = set()
    for r in ranks:
        steps = r["steps"][run]
        for n in ("blocks.0.mlp.experts_up", "blocks.0.mlp.experts_down"):
            assert steps["specs"][n] == (axis, None, None), n
            assert steps["blocks"][n].shape[0] == MOE["moe_experts"] // 4
        held.add(steps["coords"]["blocks.0.mlp.experts_up"])
        assert steps["expert_fraction"] == pytest.approx(1 / 4, rel=1e-12)
    assert len(held) == WORLD


# the ep_axis the trainer refuses: (mesh axes, sizes, model keywords,
# the refusal's words)
BESIDE_TP = "beside a 'tp'"
EP_REFUSED = {
    "dp_tp2": (AXES, (2, 1, 2), dict(MOE, ep_axis="dp"), BESIDE_TP),
    "beside_tp": (AXES + ("ep",), (1, 1, 2, 2), dict(MOE, ep_axis="ep"),
                  BESIDE_TP),
}


@pytest.mark.parametrize("case", sorted(EP_REFUSED))
def test_trainer_refuses_an_ep_axis_it_cannot_split(case):
    """An ``ep_axis`` of more than one rank other than "tp" that sits
    beside a "tp" splitting the experts (JAX's table) raises
    `ValueError` in `init_train`, `value_and_grad` and `make_train_step`
    (the cases "dp" and "cp_axis", which the trainer now trains with
    all-to-alls, went with their refusal)."""
    axes, sizes, kw, words = EP_REFUSED[case]
    mesh = Mesh(axes, sizes, (0,) * len(axes), [[0] * s for s in sizes],
                (None,) * len(axes))
    model = _model(mesh, **kw)
    tokens = torch.from_numpy(_tokens("short"))
    with pytest.raises(ValueError, match=words):
        init_train(model, mesh=mesh)
    with pytest.raises(ValueError, match=words):
        value_and_grad(model, tokens, mesh)
    with pytest.raises(ValueError, match=words):
        make_train_step(model, init_train(model), mesh)


# ---------------------------------------------------------- checkpoints


def test_checkpoint_on_a_mesh_restores_on_another(world):
    """A checkpoint written on (2, 1, 2) with FSDP (rank 0 writes the
    whole float32 state) restores on (1, 1, 4) without FSDP to the same
    whole masters and moments, which are the file's."""
    ranks, jax_side = world
    written, restored = ranks[0]["ckpt"]
    for key in written:
        _same_on_every_rank(ranks, "ckpt", 1, key)
    state = torch.load(os.path.join(jax_side["dir"], "ckpt", "1",
                                    "state.pt"), weights_only=True)
    for key in written:
        for n, t in written[key].items():
            assert np.array_equal(restored[key][n], t), (key, n)
    for n, t in written["masters"].items():
        assert np.array_equal(state["masters"][n].numpy(), t), n


def test_single_device_checkpoint_is_written_on_every_rank(world):
    """A model without a layout, saved on any rank of an initialised
    world, writes its own checkpoint (only a laid-out model leaves the
    write to rank 0)."""
    ranks, jax_side = world
    for r, outs in enumerate(ranks):
        assert outs["single_ckpt"] == 1, r
        assert os.path.isfile(os.path.join(jax_side["dir"], f"single{r}",
                                           "1", "state.pt")), r


def _resume_worker(rank, world, init_file, ckpt_dir, crash, out_file):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    executed = [0]

    def on_step(step, loss):
        executed[0] += 1
        if crash and executed[0] >= crash:
            dist.barrier()
            os._exit(17)  # every rank at the same step: no cleanup

    try:
        mesh = grid_mesh(AXES, STEP_MESH)
        model = _model()
        tokens = _tokens("short")
        optimizer, losses = train_with_recovery(
            model, mesh, lambda s: torch.from_numpy(np.roll(tokens, s, 1)),
            steps=RESUME["steps"], ckpt_dir=ckpt_dir,
            ckpt_every=RESUME["every"], seed=5, fsdp=True, on_step=on_step)
        masters = _whole(model, [m for _, m in optimizer.pairs()])
        if rank == 0:
            torch.save(dict(losses=losses, masters=masters), out_file)
    finally:
        dist.destroy_process_group()


def _resume_world(tmp, name, ckpt_dir, crash):
    """Spawn one resume world; returns the ranks' exit codes."""
    ctx = mp.spawn(_resume_worker, nprocs=WORLD, join=False,
                   args=(WORLD, str(tmp / f"{name}.init"), str(ckpt_dir),
                         crash, str(tmp / f"{name}.pt")))
    deadline = time.monotonic() + 120
    while any(p.exitcode is None for p in ctx.processes):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"gloo world {name} hung")
        time.sleep(0.2)
    return [p.exitcode for p in ctx.processes]


def test_crash_midway_then_resume_matches_uninterrupted(tmp_path):
    """`train_with_recovery(model, mesh, ..., fsdp=True)` on (2, 1, 2):
    every rank dies after step 3 of 6 (checkpoints every 2), a new
    world resumes from step 2, and its losses and whole masters are the
    uninterrupted run's bits."""
    assert _resume_world(tmp_path, "ref", tmp_path / "ref_ckpt", 0) \
        == [0] * WORLD
    assert _resume_world(tmp_path, "crash", tmp_path / "ckpt",
                         RESUME["crash"]) == [17] * WORLD
    assert latest_step(tmp_path / "ckpt") == 2
    assert _resume_world(tmp_path, "resumed", tmp_path / "ckpt", 0) \
        == [0] * WORLD
    want = torch.load(tmp_path / "ref.pt", weights_only=False)
    got = torch.load(tmp_path / "resumed.pt", weights_only=False)
    assert got["losses"] == want["losses"][2:]
    for n, m in want["masters"].items():
        assert np.array_equal(got["masters"][n], m), n
