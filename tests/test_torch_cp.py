"""Context-parallel training in the port against the JAX package, on the
CPU: the differentiable sharded paths (`cp_flash_attention`,
`ring_attention_diff` in both schedules, `ulysses_attention`), the
model's ``cp_axis``/``cp_impl`` and the step under a mesh.

The port's side runs in one gloo world of 4 CPU processes
(`torch.multiprocessing.spawn`), started once for the module: every rank
runs every case and saves its outputs, and the parametrised tests then
hold them case by case.  The spawned ranks import this module, so it
imports JAX only inside the functions that run in the test process,
which computes the JAX side while the world runs.

* Op cases: the value and the gradients of ``sum(sin(out))`` against
  JAX's single-device `flash_attention_diff` (its Pallas kernels in
  interpret mode) on the same numpy inputs, 5e-5 max abs, JAX's own
  tolerance for these paths (tests/test_cp.py); one case per path also
  against JAX's own `cp_flash_attention`, `ring_attention_diff` and
  `ulysses_attention` on 4 devices of its CPU mesh.  Every rank returns
  the whole output and gradients: the same bits on each.
* Model cases: `TinyDecoder(cp_axis="sp", cp_impl=...)` (vocab 64, dim
  64, depth 1, 4 / 2 heads, f32) with JAX's flax weights through
  `params_from_jax`, the loss and every parameter's gradient of one
  (4, 130) batch (129 positions: padded on every mesh) from
  `models.train.value_and_grad` against ``jax.value_and_grad(loss_fn)``
  of JAX's ``impl="xla"`` model, loss rtol 1e-5 and gradients 3e-5 max
  abs (tests/test_cp.py's), on the flat sp mesh and on
  `make_mesh_3d(4)` (dp 2 x sp 2), and with window 24, 2 sinks and rope
  on the flat mesh.
* remat under CP trains 2 steps, and one step leaves the same weight
  bits on every rank.
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
    init_params,
    init_train,
    make_mesh_3d,
    make_train_step,
    value_and_grad,
)
from attention_tpu_torch.parallel import (
    cp_flash_attention,
    kv_sharded_attention,
    q_sharded_attention,
    ring_attention,
    ring_attention_diff,
    ulysses_attention,
)
from attention_tpu_torch.parallel.mesh import Mesh, default_mesh

WORLD = 4
ATOL_OP = 5e-5
MODEL_RTOL, MODEL_ATOL = 1e-5, 3e-5
CP_IMPLS = ("allgather", "ring", "zigzag", "ulysses")
MODEL = dict(vocab=64, dim=64, depth=1, num_q_heads=4, num_kv_heads=2)
BAND = dict(window=24, attn_sinks=2, rope=True)
TOKENS = (4, 130)

# the inputs' (q, k, v) shapes: GQA 4-D, 8 q / 2 kv heads (Ulysses'
# repeat to the mesh size), a length that divides neither the mesh nor
# the zigzag's 8 chunks, 5 rows (the last ring shard all padding, three
# zigzag chunks all padding), and a small one for JAX's 4-device runs
INPUTS = {
    "gqa": ((2, 4, 128, 16), (2, 2, 128, 16), (2, 2, 128, 16)),
    "heads8": ((8, 128, 16), (2, 128, 16), (2, 128, 16)),
    "odd": ((2, 118, 16),) * 3,
    "tiny": ((2, 5, 16),) * 3,
    "mesh": ((4, 64, 16), (2, 64, 16), (2, 64, 16)),
}
KW = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window24": dict(causal=True, window=24),
    "window24_sinks4": dict(causal=True, window=24, sinks=4),
    "ids": dict(causal=True, packed=True),
}
# name: (path, inputs, keywords, mesh)
OPS = {}
for _path, _cases in (
        ("cp", [("gqa", "causal"), ("gqa", "noncausal"),
                ("gqa", "window24"), ("gqa", "window24_sinks4"),
                ("heads8", "ids"), ("odd", "causal")]),
        ("ring", [("gqa", "causal"), ("gqa", "noncausal"),
                  ("gqa", "window24"), ("heads8", "window24_sinks4"),
                  ("heads8", "ids"), ("odd", "causal"), ("tiny", "causal")]),
        ("zigzag", [("gqa", "causal"), ("gqa", "window24"),
                    ("heads8", "window24_sinks4"), ("heads8", "ids"),
                    ("odd", "causal"), ("tiny", "causal")]),
        ("ulysses", [("heads8", "causal"), ("heads8", "window24_sinks4")])):
    for _inp, _kw in _cases:
        OPS[f"{_path}_{_inp}_{_kw}"] = (_path, _inp, _kw, "flat")
# the (dp 2, sp 2, tp 1) mesh: the batch cut over dp too
for _path in ("cp", "ring", "ulysses"):
    OPS[f"{_path}_gqa_causal_mesh3d"] = (_path, "gqa", "causal", "mesh3d")
# one case per path against JAX's own function on 4 devices
JAX_MESH = {f"{p}_mesh_causal": (p, "mesh", "causal", "flat")
            for p in ("cp", "ring", "zigzag", "ulysses")}
OPS.update(JAX_MESH)
# name: (cp_impl, mesh, band)
MODELS = {f"{impl}_{mesh}{'_band' if band else ''}": (impl, mesh, band)
          for impl in CP_IMPLS
          for mesh, band in (("flat", False), ("mesh3d", False),
                             ("flat", True))}


def _inputs(name):
    rng = np.random.default_rng(sorted(INPUTS).index(name))
    return [rng.standard_normal(s).astype(np.float32) for s in INPUTS[name]]


def _keywords(kw_name, rows, convert):
    """The keywords, "packed" turned into 3 segments of ``rows`` (cut at
    50 and 90, tests/test_cp.py's) by ``convert``."""
    kw = dict(KW[kw_name])
    if kw.pop("packed", False):
        ids = np.zeros(rows, np.int32)
        ids[50:90] = 1
        ids[90:] = 2
        kw.update(q_segment_ids=convert(ids), kv_segment_ids=convert(ids))
    return kw


def _tokens():
    return np.random.default_rng(11).integers(0, MODEL["vocab"], TOKENS)


def _port_op(name, meshes):
    path, inp, kw_name, mesh_name = OPS[name]
    xs = [torch.from_numpy(x).requires_grad_() for x in _inputs(inp)]
    kw = _keywords(kw_name, xs[0].shape[-2], torch.from_numpy)
    fn = {"cp": cp_flash_attention, "ring": ring_attention_diff,
          "zigzag": ring_attention_diff, "ulysses": ulysses_attention}[path]
    if path == "zigzag":
        kw["schedule"] = "zigzag"
    out = fn(*xs, mesh=meshes[mesh_name], **kw)
    torch.sin(out).sum().backward()
    return [t.detach().numpy() for t in (out, *(x.grad for x in xs))]


def _port_model(name, meshes, params, tokens):
    impl, mesh_name, band = MODELS[name]
    model = TinyDecoder(dtype=torch.float32, device="cpu", cp_axis="sp",
                        cp_impl=impl, mesh=meshes[mesh_name], **MODEL,
                        **(BAND if band else {}))
    model.load_state_dict(params)
    loss, grads = value_and_grad(model, tokens, meshes[mesh_name])
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return loss.item(), {n: g.numpy() for n, g in zip(names, grads)}


def _train(impl, mesh, tokens, *, remat, steps):
    """``steps`` steps of `make_train_step` from the seeded start: the
    losses and every weight after them."""
    model = TinyDecoder(dtype=torch.float32, device="cpu", cp_axis="sp",
                        cp_impl=impl, mesh=mesh, remat=remat, **MODEL)
    step = make_train_step(model, init_train(model, seed=0, mesh=mesh),
                           mesh)
    losses = [step(tokens).item() for _ in range(steps)]
    return losses, {n: p.detach().numpy().copy()
                    for n, p in model.state_dict().items()}


def _worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        meshes = {"flat": default_mesh("sp"), "mesh3d": make_mesh_3d(4)}
        outs = {"ops": {n: _port_op(n, meshes) for n in OPS}}
        params_file = os.path.join(out_dir, "params.pt")
        while not os.path.exists(params_file):  # the test process writes it
            time.sleep(0.1)
        params = torch.load(params_file)
        tokens = torch.from_numpy(_tokens())
        outs["models"] = {n: _port_model(n, meshes, params, tokens)
                          for n in MODELS}
        outs["remat"] = {}
        for impl in CP_IMPLS:
            plain = TinyDecoder(dtype=torch.float32, device="cpu",
                                cp_axis="sp", cp_impl=impl,
                                mesh=meshes["flat"], **MODEL)
            plain.load_state_dict(init_params(plain, 0, torch.float32))
            first = value_and_grad(plain, tokens, meshes["flat"])[0].item()
            losses, _ = _train(impl, meshes["flat"], tokens, remat=True,
                               steps=2)
            outs["remat"][impl] = (first, losses)
        outs["weights"] = {impl: _train(impl, meshes["mesh3d"], tokens,
                                        remat=False, steps=1)[1]
                           for impl in CP_IMPLS}
        torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_params():
    """JAX's flax weights of the small model (float32 numpy tree)."""
    import jax
    import jax.numpy as jnp

    from attention_tpu.models import TinyDecoder as JaxDecoder

    jmodel = JaxDecoder(impl="xla", dtype=jnp.float32, **MODEL)
    return jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _jax_reference():
    """The JAX side: per (inputs, keywords) the single-device
    `flash_attention_diff`'s value and gradients of sum(sin(out)); per
    `JAX_MESH` case JAX's own CP function on 4 devices; per model
    variant the loss and gradients of JAX's ``impl="xla"`` model."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from attention_tpu.models import TinyDecoder as JaxDecoder
    from attention_tpu.models.train import loss_fn
    from attention_tpu.ops.flash_vjp import flash_attention_diff
    from attention_tpu.parallel.cp import cp_flash_attention as jax_cp
    from attention_tpu.parallel.ring import ring_attention_diff as jax_ring
    from attention_tpu.parallel.ulysses import ulysses_attention as jax_uly
    from attention_tpu_torch.models import params_from_jax

    def value_and_grads(fn, inp, kw_name):
        xs = tuple(jnp.asarray(x) for x in _inputs(inp))
        kw = _keywords(kw_name, xs[0].shape[-2], jnp.asarray)

        @jax.jit
        def run(*xs):
            out, vjp = jax.vjp(lambda *a: fn(*a, **kw), *xs)
            return (out, *vjp(jnp.cos(out)))

        return [np.asarray(t) for t in run(*xs)]

    single = {}
    for name, (path, inp, kw_name, _) in OPS.items():
        if name not in JAX_MESH and (inp, kw_name) not in single:
            single[inp, kw_name] = value_and_grads(flash_attention_diff, inp,
                                                   kw_name)
    mesh = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("sp",))
    fns = {"cp": jax_cp, "ring": jax_ring,
           "zigzag": lambda *a, **kw: jax_ring(*a, schedule="zigzag", **kw),
           "ulysses": jax_uly}
    own = {name: value_and_grads(
        lambda *a, path=path, **kw: fns[path](*a, mesh=mesh, **kw), inp, kw)
        for name, (path, inp, kw, _) in JAX_MESH.items()}
    params = _jax_params()
    tokens = jnp.asarray(_tokens(), jnp.int32)
    models = {}
    for band in (False, True):
        jmodel = JaxDecoder(impl="xla", dtype=jnp.float32, **MODEL,
                            **(BAND if band else {}))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn), static_argnums=1)(
            params, jmodel, tokens)
        models[band] = (float(loss), {
            n: g.numpy() for n, g in
            params_from_jax(jax.device_get(grads)).items()})
    return dict(single=single, own=own, models=models)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's outputs, the JAX side): the world of 4 spawned once,
    the JAX side computed while it runs."""
    from attention_tpu_torch.models import params_from_jax

    out = tmp_path_factory.mktemp("cp_world")
    ctx = mp.spawn(_worker, nprocs=WORLD, join=False,
                   args=(WORLD, str(out / "init"), str(out)))
    try:
        torch.save(params_from_jax(_jax_params()), out / "params.tmp")
        os.replace(out / "params.tmp", out / "params.pt")
        jax_side = _jax_reference()
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("gloo world of 4 hung")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_side


def _same_on_every_rank(ranks, *keys):
    """The value under ``keys`` on rank 0, after asserting that every
    rank holds the same bits."""

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
        elif isinstance(want, (list, tuple)):
            for a, b in zip(got, want):
                assert np.array_equal(a, b), r
        else:
            assert got == want, r
    return want


@pytest.mark.parametrize("name", sorted(set(OPS) - set(JAX_MESH)))
def test_op_matches_jax_single_device(world, name):
    """Value and dq, dk, dv of sum(sin(out)) through the sharded path
    equal JAX's single-device `flash_attention_diff` (5e-5), the same
    bits on every rank."""
    ranks, jax_side = world
    got = _same_on_every_rank(ranks, "ops", name)
    _, inp, kw_name, _ = OPS[name]
    want = jax_side["single"][inp, kw_name]
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, what
        assert np.isfinite(a).all(), what
        assert np.abs(a - b).max() <= ATOL_OP, what


@pytest.mark.parametrize("name", sorted(JAX_MESH))
def test_op_matches_jax_mesh_function(world, name):
    """Each path against JAX's own CP function of it on 4 devices."""
    ranks, jax_side = world
    got = _same_on_every_rank(ranks, "ops", name)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got,
                          jax_side["own"][name]):
        assert np.abs(a - b).max() <= ATOL_OP, what


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_loss_and_grads_match_jax(world, name):
    """The CP model's loss and every parameter's gradient, summed over
    the mesh, against JAX's dense ``impl="xla"`` model."""
    ranks, jax_side = world
    loss, grads = ranks[0]["models"][name]
    _same_on_every_rank(ranks, "models", name, 1)
    assert all(r["models"][name][0] == loss for r in ranks)
    want_loss, want = jax_side["models"][MODELS[name][2]]
    assert abs(loss - want_loss) <= MODEL_RTOL * abs(want_loss)
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert np.abs(g - want[n]).max() <= MODEL_ATOL, n


@pytest.mark.parametrize("impl", CP_IMPLS)
def test_remat_trains_under_cp(world, impl):
    """remat (torch.utils.checkpoint, whose recomputed forward meets the
    collectives again inside the backward) trains 2 steps: finite
    losses, the first equal to the model's loss without remat, the same
    on every rank."""
    ranks, _ = world
    first, losses = ranks[0]["remat"][impl]
    assert all(r["remat"][impl] == (first, losses) for r in ranks)
    assert np.isfinite(losses).all()
    assert abs(losses[0] - first) <= 1e-6 * abs(first)


@pytest.mark.parametrize("impl", CP_IMPLS)
def test_step_leaves_same_weights_on_every_rank(world, impl):
    """One step on the (dp 2, sp 2) mesh: every rank's weights are the
    same bits, and moved from the seeded start."""
    ranks, _ = world
    weights = _same_on_every_rank(ranks, "weights", impl)
    model = TinyDecoder(dtype=torch.float32, device="cpu", **MODEL)
    start = init_params(model, 0, torch.float32)
    assert any(not np.array_equal(weights[n], start[n].numpy())
               for n in weights)


def _small_model(**kw):
    return TinyDecoder(dtype=torch.float32, device="cpu", **MODEL, **kw)


def _mesh(sizes):
    """A one-rank stand-in for a mesh of these (dp, sp, tp) sizes: its
    shape is all the refusals read."""
    return Mesh(("dp", "sp", "tp"), sizes, (0, 0, 0),
                [[0] * s for s in sizes], (None, None, None))


def _x(*shape, grad=False):
    return torch.zeros(shape, requires_grad=grad)


REFUSALS = {
    # JAX's ValueErrors
    "cp_no_axis": (ValueError, "no axis", lambda: cp_flash_attention(
        _x(2, 16, 8), _x(2, 16, 8), _x(2, 16, 8), mesh=default_mesh("sp"),
        axis_name="nope")),
    "cp_2d": (ValueError, "3D/4D", lambda: cp_flash_attention(
        _x(16, 8), _x(16, 8), _x(16, 8))),
    "cp_unpaired_ids": (ValueError, "go together", lambda: cp_flash_attention(
        _x(2, 16, 8), _x(2, 16, 8), _x(2, 16, 8),
        q_segment_ids=torch.zeros(16, dtype=torch.int32))),
    "cp_ids_4d": (ValueError, "3D inputs", lambda: cp_flash_attention(
        _x(1, 2, 16, 8), _x(1, 2, 16, 8), _x(1, 2, 16, 8),
        q_segment_ids=torch.zeros(16, dtype=torch.int32),
        kv_segment_ids=torch.zeros(16, dtype=torch.int32))),
    "ring_zigzag_noncausal": (ValueError, "causal", lambda:
                              ring_attention_diff(
                                  _x(2, 16, 8), _x(2, 16, 8), _x(2, 16, 8),
                                  schedule="zigzag")),
    "ring_unknown_schedule": (ValueError, "schedule", lambda:
                              ring_attention_diff(
                                  _x(2, 16, 8), _x(2, 16, 8), _x(2, 16, 8),
                                  schedule="spiral")),
    "ring_sinks_without_window": (ValueError, "window", lambda:
                                  ring_attention_diff(
                                      _x(2, 16, 8), _x(2, 16, 8),
                                      _x(2, 16, 8), causal=True, sinks=2)),
    "ring_sinks_with_ids": (ValueError, "segment", lambda:
                            ring_attention_diff(
                                _x(2, 16, 8), _x(2, 16, 8), _x(2, 16, 8),
                                causal=True, window=4, sinks=2,
                                q_segment_ids=torch.zeros(
                                    16, dtype=torch.int32),
                                kv_segment_ids=torch.zeros(
                                    16, dtype=torch.int32))),
    "ring_sinks_past_shard": (ValueError, "one KV shard", lambda:
                              ring_attention_diff(
                                  _x(2, 16, 8), _x(2, 16, 8), _x(2, 16, 8),
                                  causal=True, window=4, sinks=17)),
    "zigzag_sinks_past_chunk": (ValueError, "zigzag chunk", lambda:
                                ring_attention_diff(
                                    _x(2, 16, 8), _x(2, 16, 8),
                                    _x(2, 16, 8), causal=True, window=4,
                                    sinks=9, schedule="zigzag")),
    "model_cp_xla": (ValueError, "cp_axis", lambda: _small_model(
        impl="xla", cp_axis="sp", mesh=default_mesh("sp"))),
    "model_cp_without_mesh": (ValueError, "mesh=", lambda: _small_model(
        cp_axis="sp")),
    "model_unknown_cp_impl": (ValueError, "cp_impl", lambda: _small_model(
        cp_axis="sp", cp_impl="tree", mesh=default_mesh("sp"))),
    # forward-only paths, as in JAX
    "grad_kv_sharded": (NotImplementedError, "forward-only", lambda:
                        kv_sharded_attention(_x(8, 8, grad=True),
                                             _x(8, 8), _x(8, 8))),
    "grad_q_sharded": (NotImplementedError, "forward-only", lambda:
                       q_sharded_attention(_x(8, 8, grad=True), _x(8, 8),
                                           _x(8, 8))),
    "grad_ring_attention": (NotImplementedError, "forward-only", lambda:
                            ring_attention(_x(8, 8, grad=True), _x(8, 8),
                                           _x(8, 8))),
    # the tensor-parallel layout, FSDP and expert parallelism are ported
    # (tests/test_torch_mesh_train.py): what stays refused around them,
    # JAX's ValueErrors, and pipeline parallelism, not ported yet
    "train_tp2": (ValueError, "accum_steps", lambda: make_train_step(
        _small_model(), None, _mesh((1, 1, 2)), accum_steps=0)),
    "init_tp2": (NotImplementedError, "Queue 1 item 2", lambda: init_train(
        _small_model(), mesh=Mesh(("pp", "tp"), (2, 2), (0, 0),
                                  [[0, 0], [0, 0]], (None, None)))),
    "init_fsdp": (ValueError, "mesh=", lambda: init_train(
        _small_model(), fsdp=True)),
    "model_cp_moe": (ValueError, "not in the current mesh", lambda:
                     _small_model(cp_axis="sp", mesh=default_mesh("sp"),
                                  moe_experts=4, ep_axis="ep")),
    # tensor-parallel serving is ported: JAX's refusal without a mesh
    "model_tp_axis": (ValueError, "tp_axis requires mesh=", lambda:
                      _small_model(tp_axis="tp")),
    "model_ep_axis": (ValueError, "not in the current mesh", lambda:
                      _small_model(ep_axis="ep", moe_experts=4,
                                   mesh=default_mesh("sp"))),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(name):
    """JAX's `ValueError`s, and `NotImplementedError` for what is not
    ported, each naming what brings it."""
    exc, match, call = REFUSALS[name]
    with pytest.raises(exc, match=match):
        call()


def test_backward_float32_gradients():
    """`flash_backward(grad_dtype=torch.float32)`, which the sharded
    backwards sum across shards: on the CPU the plain version's
    gradients as float32; the wgmma plan then cuts every GQA group of
    two or more heads into at least two slices (float32 partials), and
    a group of one stays whole."""
    from attention_tpu_torch.ops.flash_bwd import (
        bwd_work_plan,
        flash_backward,
    )
    from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl

    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16)
        for s in ((4, 40, 16), (2, 40, 16), (2, 40, 16), (4, 40, 16)))
    kw = dict(scale=0.25, causal=True, q_offset=8, kv_valid=36)
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    want = flash_backward(q, k, v, out, lse, do, **kw)
    got = flash_backward(q, k, v, out, lse, do, grad_dtype=torch.float32,
                         **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g.to(w.dtype), w)
    for group, least in ((8, 2), (2, 2), (1, 1)):
        plan = bwd_work_plan(1, 4, group, 2048, 2048, 2048, True, 0, 0,
                             sms=132, min_slices=2)
        assert plan.slices >= least and group % plan.slices == 0
