"""The mesh trainer's parameter layouts in the port against the JAX
package, on the CPU: `param_spec` / `legal_spec` / `fsdp_spec` and
`shard_params`, Megatron's tp split of `TinyDecoder`, FSDP, MoE experts
over tp with JAX's global capacity, slots and aux loss, `MoEMLP(
ep_axis=)`, the checkpoint on a mesh and `train_with_recovery(model,
mesh, ...)`.

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
  on (2, 1, 2) with ``ep_axis="tp"`` (with and without FSDP) and on
  (1, 2, 2) ring, and head counts tp does not divide (6 / 3 heads on tp
  4, 12 / 3 on tp 2): the whole gradients gathered from the blocks against
  ``jax.value_and_grad(loss_fn)`` of JAX's single-device ``impl="xla"``
  model, loss rtol 1e-5, gradients 3e-5 max abs (tests/test_cp.py's).
* Three steps on (2, 1, 2) against JAX's own `init_sharded` +
  `make_train_step` on a (2, 1, 2) JAX mesh, loss rtol 1e-5, dense with
  and without FSDP and the MoE model (experts over tp) with it; the FSDP
  run's losses and masters the bits of the replicated run's; a 2-D
  parameter split over dp; each rank's masters and moments 1 / (dp·tp)
  of the whole; replicated parameters (and blocks) the same bits on
  every rank that holds them.
* `MoEMLP(ep_axis="ep")` on a 4-rank "ep" mesh against the unsharded
  layer and JAX's, 1e-5 (tests/test_moe.py's); the trainer refuses an
  ``ep_axis`` whose ranks hold different tokens or that sits beside a
  "tp" splitting the experts.
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
TOKENS = {"short": (4, 33), "long": (4, 130)}
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
}
STEP_MESH = (2, 1, 2)
STEPS = 3
# the port's models of the three-step runs (JAX's sharded step runs the
# MoE model with ep_axis="tp" too)
STEP_MODELS = {"dense": {}, "moe": dict(MOE, ep_axis="tp")}
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


def _port_grads(name, params):
    sizes, kw, fsdp, tokens, kind = GRADS[name]
    mesh = grid_mesh(AXES, sizes)
    model = _model(mesh, **kw)
    init_train(model, params=params[kind], mesh=mesh, fsdp=fsdp)
    loss, grads = value_and_grad(model, torch.from_numpy(_tokens(tokens)),
                                 mesh)
    return loss.item(), _whole(model, grads)


def _port_steps(params, mesh, fsdp, kind="dense"):
    """`STEPS` steps from JAX's weights: the losses, the whole masters,
    this rank's blocks and its specs, and the numbers of elements of
    this rank's masters + moments and of the whole model's."""
    model = _model(mesh, **STEP_MODELS[kind])
    optimizer = init_train(model, params=params[kind], mesh=mesh,
                           fsdp=fsdp)
    step = make_train_step(model, optimizer, mesh)
    tokens = torch.from_numpy(_tokens("short"))
    losses = [step(tokens).item() for _ in range(STEPS)]
    masters = _whole(model, [m for _, m in optimizer.pairs()])
    local = sum(m.numel() + sum(t.numel() for k, t in
                                optimizer.state[m].items() if k != "step")
                for _, m in optimizer.pairs())
    whole = 3 * sum(p.size for p in masters.values())
    blocks = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    coords = {n: tuple(mesh.index(a) if a is not None else None
                       for a in spec)
              for n, spec in model.layout.specs.items()}
    return dict(losses=losses, masters=masters, blocks=blocks,
                coords=coords, specs=dict(model.layout.specs),
                state_fraction=local / whole)


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
        mesh = grid_mesh(AXES, STEP_MESH)
        outs["steps"] = {fsdp: _port_steps(params, mesh, fsdp)
                         for fsdp in (False, True)}
        outs["moe_steps"] = _port_steps(params, mesh, True, "moe")
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


def _jax_reference(models):
    """JAX's loss and gradients of each (model, tokens) of `GRADS` on
    one device, and its sharded 3 steps on (2, 1, 2)."""
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
    mesh = _jax_mesh(STEP_MESH)
    batch = jnp.asarray(_tokens("short"), jnp.int32)
    steps = {}
    for kind, fsdp in (("dense", False), ("moe", True)):
        jmodel = models[kind][0]
        if kind == "moe":
            jmodel = jmodel.clone(ep_axis="tp")
        with mesh_context(mesh):
            params, _, state = jax_train.init_sharded(
                jmodel, mesh, batch=4, seq=32, seed=0, lr=1e-3, fsdp=fsdp)
            step = jax_train.make_train_step(jmodel, optax.adamw(1e-3), mesh)
            losses = []
            for _ in range(STEPS):
                params, state, loss = step(params, state, batch)
                losses.append(float(loss))
        steps[kind] = losses
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


@pytest.mark.parametrize("run", ("dense", "dense_fsdp", "moe_fsdp"))
def test_three_steps_match_jax_sharded_step(world, run):
    """Three steps on (2, 1, 2) from JAX's weights against JAX's own
    `init_sharded` + `make_train_step` on a (2, 1, 2) JAX mesh: the
    dense model with and without FSDP, and the MoE model (experts over
    tp, pairs dropped) with FSDP, whose blocks a misplaced expert or
    FSDP block would carry into the second and third losses."""
    ranks, jax_side = world
    kind = run.split("_")[0]

    def runs(outs):
        return outs["moe_steps"] if kind == "moe" else \
            outs["steps"][run.endswith("fsdp")]

    losses = runs(ranks[0])["losses"]
    assert all(runs(r)["losses"] == losses for r in ranks)
    np.testing.assert_allclose(losses, jax_side["steps"][kind],
                               rtol=LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]


def test_fsdp_equals_replicated(world):
    """FSDP's trajectory is the replicated one's, bit for bit (the dp
    gradient is reduce-scattered by the replicated all-reduce's route):
    the losses and every whole master after 3 steps; a 2-D parameter is
    split over dp, and each rank's masters and moments are 1 / (dp·tp)
    of the whole (the replicated layout's 1 / tp and more)."""
    ranks, _ = world
    rep, fs = ranks[0]["steps"][False], ranks[0]["steps"][True]
    assert fs["losses"] == rep["losses"]
    for n, m in rep["masters"].items():
        assert np.array_equal(fs["masters"][n], m), n
    assert any("dp" in s and len(s) == 2 for s in fs["specs"].values())
    dp, _, tp = STEP_MESH
    for r in ranks:
        assert r["steps"][True]["state_fraction"] == pytest.approx(
            1 / (dp * tp), rel=0.02)
        assert r["steps"][False]["state_fraction"] > 1.5 / (dp * tp)


@pytest.mark.parametrize("fsdp", (False, True))
def test_step_leaves_same_bits_on_every_rank_that_holds_a_block(world,
                                                                 fsdp):
    """After 3 steps, ranks that hold the same block of a parameter (the
    same index along each axis that splits it; every rank for a
    replicated one) hold the same bits: the norms, the replicated k and
    v of (1, 1, 4) aside, every tp-replicated tensor included."""
    ranks, _ = world
    names = ranks[0]["steps"][fsdp]["blocks"]
    shared = replicated = 0
    for n in names:
        by_block = {}
        for r in ranks:
            run = r["steps"][fsdp]
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


# the ep_axis the trainer refuses: (mesh axes, sizes, model keywords,
# the refusal's words)
TOKEN_SPLIT, BESIDE_TP = "splits the tokens", "beside a 'tp'"
EP_REFUSED = {
    "dp": (AXES, (4, 1, 1), dict(MOE, ep_axis="dp"), TOKEN_SPLIT),
    "dp_tp2": (AXES, (2, 1, 2), dict(MOE, ep_axis="dp"), TOKEN_SPLIT),
    "cp_axis": (AXES, (1, 4, 1), dict(MOE, ep_axis="sp", cp_axis="sp",
                                      cp_impl="ring"), TOKEN_SPLIT),
    "beside_tp": (AXES + ("ep",), (1, 1, 2, 2), dict(MOE, ep_axis="ep"),
                  BESIDE_TP),
}


@pytest.mark.parametrize("case", sorted(EP_REFUSED))
def test_trainer_refuses_an_ep_axis_it_cannot_split(case):
    """An ``ep_axis`` of more than one rank whose ranks hold different
    tokens (dp, the cp axis), or that sits beside a "tp" splitting the
    experts, raises `ValueError` in `init_train`, `value_and_grad` and
    `make_train_step` rather than summing other tokens' expert outputs."""
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
