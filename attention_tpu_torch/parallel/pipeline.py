"""GPipe pipeline parallelism over one mesh axis: the port of
`attention_tpu.parallel.pipeline`.

Each rank along the axis runs one stage.  The batch is cut into
microbatches that march through the stages: at tick t the rank of index
p runs microbatch t - p (GPipe's diagonal) and hands its output to rank
p + 1 by `Mesh.ppermute` over the open chain ``[(j, j + 1)]`` (no wrap
edge: stage 0 reads the input).  JAX computes the fill and drain ticks
on zeros, a rule of static shapes; here a rank that has no microbatch at
a tick computes nothing and the chain's pairs are those that carry one.
The last stage's outputs are summed over the axis with zeros from the
others (JAX's masked ``psum``), so every rank gets the whole output.

The backward is written out rather than left to autograd, whose order
of nodes across the ranks' different graphs promises nothing to gloo's
point-to-point calls, which must meet in the same order on every rank.
The forward keeps each microbatch's stage input and output (built under
autograd inside `_Pipeline.forward`); the backward runs the ticks in
reverse: the last stage takes its part of the output's gradient (once,
not once a rank: every rank computes the same loss of the whole output),
each stage takes the gradient of its input and of its parameters by
``torch.autograd.grad`` and sends the first to rank p - 1.  The
parameters' gradients are summed over the microbatches in float32 and
rounded once.  Stage 0's input gradients are summed over the axis (the
other ranks add zeros), so an input that every rank holds alike, such as
an embedding's output, gets the same gradient on every rank.

`pipeline_apply` takes JAX's arguments, whole on every rank as the
port's sharded functions take them: each tensor of ``stage_params`` has
the stages on its leading axis, rank p uses slice p, and every rank
gets the whole gradients (the slices' all-gathered, `shard_whole`).
`pipeline_local` takes this rank's stage parameters alone and gives
only their gradients: the trainer's path (`models.pipeline`), where a
rank holds only its own stage.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from attention_tpu_torch.parallel.mesh import Mesh, default_mesh, shard_whole


class _Plan(NamedTuple):
    mesh: Mesh
    axis: str
    stage_fn: object
    names: tuple
    n_micro: int


def _chain(stages: int, n_micro: int, tick: int, step: int) -> list:
    """The pairs of the open chain that carry a microbatch at ``tick``:
    (j, j + step) for each stage j that runs one then (step 1 forward,
    -1 backward)."""
    return [(j, j + step) for j in range(stages)
            if 0 <= j + step < stages and 0 <= tick - j < n_micro]


def _forward(plan: _Plan, x: torch.Tensor, params, build: bool,
             x_grad: bool = False):
    """The forward ticks: (the whole output, on every rank; this rank's
    (input, output) of each microbatch it ran, kept for the backward
    where ``build``, stage 0's inputs taking a gradient where
    ``x_grad``)."""
    mesh, axis, n_micro = plan.mesh, plan.axis, plan.n_micro
    stages, p = mesh.shape[axis], mesh.index(axis)
    last = stages - 1
    xm = x.reshape(n_micro, -1, *x.shape[1:])
    kept, outs, recv = [], [], None
    with torch.set_grad_enabled(build):
        for t in range(n_micro + stages - 1):
            m = t - p
            send = xm[0]  # a template of the shape a rank receives
            if 0 <= m < n_micro:
                inp = xm[m] if p == 0 else recv
                if build:
                    inp = inp.detach().requires_grad_(p > 0 or x_grad)
                out = plan.stage_fn(dict(zip(plan.names, params)), inp)
                if out.shape != inp.shape or out.dtype != x.dtype:
                    raise ValueError(
                        f"stage_fn gave {tuple(out.shape)} {out.dtype} for a "
                        f"microbatch of {tuple(inp.shape)} {x.dtype}: a stage "
                        "keeps its input's shape and dtype")
                if build:
                    kept.append((inp, out))
                if p == last:
                    outs.append(out.detach())
                send = out.detach()
            if t < n_micro + stages - 2:
                recv = mesh.ppermute([send], axis,
                                     _chain(stages, n_micro, t, 1)).wait()[0]
    whole = (torch.cat(outs) if p == last else torch.zeros_like(x))
    return _sum(whole, mesh, axis), kept


def _sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of a tensor that one rank holds and the
    others hold as zeros: that rank's bits on every rank."""
    return mesh.all_reduce(x.float(), axis, "sum").to(x.dtype)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, x, *params):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(params, ctx.needs_input_grad[2:])]
        x_grad = ctx.needs_input_grad[1]
        whole, kept = _forward(plan, x, leaves, build=True, x_grad=x_grad)
        ctx.plan, ctx.kept, ctx.leaves = plan, kept, leaves
        ctx.x_meta = (x.shape, x.dtype, x.device, x_grad)
        return whole

    @staticmethod
    def backward(ctx, g):
        plan, kept, leaves = ctx.plan, ctx.kept, ctx.leaves
        mesh, axis, n_micro = plan.mesh, plan.axis, plan.n_micro
        stages, p = mesh.shape[axis], mesh.index(axis)
        shape, dtype, device, x_grad = ctx.x_meta
        gm = g.reshape(n_micro, -1, *shape[1:])
        wanted = [i for i, t in enumerate(leaves) if t.requires_grad]
        sums = [None] * len(leaves)
        dx = [None] * n_micro
        recv = None
        for t in range(n_micro + stages - 2, -1, -1):
            m = t - p
            send = gm[0]  # a template of the shape a rank receives
            if 0 <= m < n_micro:
                inp, out = kept[m]
                up = gm[m].to(dtype) if p == stages - 1 else recv
                inputs = [leaves[i] for i in wanted]
                if inp.requires_grad:
                    inputs.append(inp)
                got = torch.autograd.grad(out, inputs, up, allow_unused=True)
                for i, gi in zip(wanted, got):
                    if gi is not None:
                        gi = gi.float()
                        sums[i] = gi if sums[i] is None else sums[i].add_(gi)
                if inp.requires_grad:
                    send = got[-1] if got[-1] is not None \
                        else torch.zeros_like(inp)
                    if p == 0:
                        dx[m] = send
                kept[m] = None
            if t > 0:
                recv = mesh.ppermute([send.to(dtype)], axis,
                                     _chain(stages, n_micro, t, -1)).wait()[0]
        ctx.kept = None
        grad_x = None
        if x_grad:
            grad_x = (torch.cat(dx).reshape(shape) if p == 0
                      else torch.zeros(shape, dtype=dtype, device=device))
            grad_x = _sum(grad_x, mesh, axis)
        # a wanted parameter the stage did not use gets zeros, so that
        # every rank's graph above it (a `shard_whole`'s all-gather) runs
        grads = [None if i not in wanted
                 else torch.zeros_like(t) if sums[i] is None
                 else sums[i].to(t.dtype) for i, t in enumerate(leaves)]
        return (None, grad_x, *grads)


def _check(x: torch.Tensor, mesh: Mesh, axis_name: str,
           n_micro: int | None) -> int:
    """``n_micro`` (default: the number of stages), after JAX's refusal
    of a batch it does not divide."""
    if n_micro is None:
        n_micro = mesh.shape[axis_name]
    b = x.shape[0]
    if n_micro < 1 or b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    return n_micro


def pipeline_local(stage_fn, params: dict, x: torch.Tensor, *, mesh: Mesh,
                   axis_name: str = "pp", n_micro: int | None = None
                   ) -> torch.Tensor:
    """``x`` (B, ...), alike on every rank of ``axis_name``, through every
    stage of the pipeline; this rank runs ``stage_fn(params, x_mb) ->
    y_mb`` (shape- and dtype-preserving) with its own stage's
    ``params`` ({name: tensor}).  Returns the last stage's (B, ...) on
    every rank; the gradients reach ``params`` (this stage's) and ``x``
    (the same on every rank)."""
    n_micro = _check(x, mesh, axis_name, n_micro)
    names = tuple(params)
    plan = _Plan(mesh, axis_name, stage_fn, names, n_micro)
    tensors = [params[n] for n in names]
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in tensors)):
        return _Pipeline.apply(plan, x, *tensors)
    return _forward(plan, x, tensors, build=False)[0]


def pipeline_apply(stage_fn, stage_params: dict, x: torch.Tensor, *,
                   mesh: Mesh | None = None, axis_name: str = "pp",
                   n_micro: int | None = None) -> torch.Tensor:
    """Run ``x`` through all pipeline stages; returns the final output.

    ``stage_fn(params_slice, x_mb) -> y_mb`` applies one stage to one
    microbatch (shape- and dtype-preserving).  ``stage_params`` is a
    dict of tensors whose leading axis is the number of stages (the
    mesh's size on ``axis_name``; `default_mesh` when ``mesh`` is None),
    whole on every rank; rank p uses slice p.  ``x`` (B, ...), alike on
    every rank, is split into ``n_micro`` microbatches along axis 0
    (default: one per stage).  The output (B, ...) is whole on every
    rank of the axis; the ranks of the mesh's other axes each run their
    own line of stages.  Gradients reach ``x`` and ``stage_params``,
    whole on every rank."""
    if mesh is None:
        mesh = default_mesh(axis_name)
    stages = mesh.shape[axis_name]
    n_micro = _check(x, mesh, axis_name, n_micro)
    for name, t in stage_params.items():
        if t.shape[0] != stages:
            raise ValueError(
                f"stage_params leading axis {t.shape[0]} != pipeline size "
                f"{stages} on {axis_name!r} ({name})")
    local = {n: shard_whole(t, mesh, axis_name, 0)[0]
             for n, t in stage_params.items()}
    return pipeline_local(stage_fn, local, x, mesh=mesh,
                          axis_name=axis_name, n_micro=n_micro)
