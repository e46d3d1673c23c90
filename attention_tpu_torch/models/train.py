"""Single-device training: the port of `attention_tpu.models.train`.

`loss_fn` is the next-token cross entropy of the JAX package, on the
model's float32 logits head, plus the MoE blocks' load-balancing losses;
`init_train` loads seeded weights and builds the optimizer the JAX
package's `init_sharded` builds, ``optax.adamw(lr)`` with optax's
defaults, over float32 master weights (`MasterAdamW`); `make_train_step`
returns a step that takes the gradient of the loss (through
`flash_attention_diff`, whose backward runs the backward kernels on the
card) and applies one update, optionally over equal microbatches.

Flax keeps every parameter in float32 and casts it to the model dtype
where it computes, so the JAX trainer updates float32 parameters with
float32 moments.  The port's model holds its weights in the model dtype
(bf16 serves with no cast); `MasterAdamW` keeps the float32 masters of
those weights, takes each bf16 gradient as its master's float32 gradient
(what the cast's cotangent is in JAX), updates the masters and copies
them into the model rounded to nearest.  A float32 parameter (a float32
model's, the norms', the router's, the head's) is its own master.

Under a mesh (`make_mesh_3d`: dp x sp x tp over the ranks of a
``torch.distributed`` world, or any `parallel.mesh.Mesh` with a "dp"
and the model's ``cp_axis``) the parameters are replicated, the same
seeded weights on every rank, and every rank passes the whole (B, S + 1)
batch, as JAX passes a global array.  The step takes this rank's block:
rows by its dp index, positions by its index along the model's
``cp_axis`` (the sequence padded to a multiple of that axis, twice it for
"zigzag", the padding left out of the loss).  The model runs
context-parallel on the block; the loss is the global mean (each rank's
sum of cross entropy over the global token count, all-reduced), the
gradients are summed over dp x sp in float32 (flax's gradients are
float32; a bf16 sum over ranks would round at every add), and every
rank applies the same update, so that its weights stay the same bits.
The tensor-parallel parameter layout (`shard_params`, tp > 1) and FSDP
are not ported.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from attention_tpu_torch.models.transformer import TinyDecoder, init_params
from attention_tpu_torch.parallel.mesh import Mesh, _world, grid_mesh

#: optax.adamw's defaults (torch's AdamW defaults weight decay to 1e-2)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def loss_fn(model: TinyDecoder, batch: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over (B, S) int tokens (the logits
    of ``batch[:, :-1]`` against ``batch[:, 1:]``), plus the sum of the
    blocks' MoE aux losses."""
    logits, aux = model(batch[:, :-1], return_aux=True)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         batch[:, 1:].reshape(-1))
    return ce + aux


def make_mesh_3d(n: int | None = None) -> Mesh:
    """The world's ranks as a (dp, sp, tp) mesh, factored as JAX's
    `make_mesh_3d` factors its devices: the prime factors of ``n``,
    largest first, dealt round-robin to the three axes, the sizes sorted
    largest first (4 ranks: (2, 2, 1); 8: (2, 2, 2)).  ``n`` defaults to
    the world size and must equal it; without a process group the mesh
    is (1, 1, 1).  One process group per axis line (`grid_mesh`); every
    rank must call it."""
    size, _ = _world()
    n = size if n is None else n
    if n != size:
        raise ValueError(f"make_mesh_3d({n}) on a world of {size} ranks")
    factors, rem, f = [], n, 2
    while f * f <= rem:
        while rem % f == 0:
            factors.append(f)
            rem //= f
        f += 1
    if rem > 1:
        factors.append(rem)
    dims = [1, 1, 1]
    for i, f in enumerate(sorted(factors, reverse=True)):
        dims[i % 3] *= f
    return grid_mesh(("dp", "sp", "tp"), sorted(dims, reverse=True))


def _check_mesh(model: TinyDecoder, mesh: Mesh | None, *,
                fsdp: bool = False) -> tuple[str, ...]:
    """The mesh axes a step sums its gradients over (dp and the model's
    ``cp_axis``, those of more than one rank), after the refusals: tp >
    1 and FSDP (`NotImplementedError`: the tensor-parallel layout comes
    with `shard_params`), a mixture of experts on more than one rank
    (its router statistics would be per shard), a sequence axis that is
    not the model's ``cp_axis``."""
    if fsdp:
        raise NotImplementedError(
            "fsdp: fully sharded parameters come with the tensor-parallel "
            "layout (shard_params), ROADMAP.md Queue 1 item 5")
    if mesh is None:
        return ()
    if mesh.shape.get("tp", 1) > 1:
        raise NotImplementedError(
            "tp > 1: the tensor-parallel parameter layout (shard_params) "
            "is not ported; it comes with ROADMAP.md Queue 1 item 5")
    axes = tuple(a for a in ("dp", model.cp_axis)
                 if a is not None and mesh.shape.get(a, 1) > 1)
    if model.moe_experts and axes:
        raise NotImplementedError(
            "a mixture of experts on a mesh comes with expert "
            "parallelism, ROADMAP.md Queue 1 item 5")
    for axis in mesh.axis_names:
        if axis not in ("dp", "tp", model.cp_axis) and mesh.shape[axis] > 1:
            raise ValueError(
                f"mesh axis {axis!r} ({mesh.shape[axis]} ranks) is neither "
                f"'dp' nor the model's cp_axis ({model.cp_axis!r})")
    return axes


def local_block(model: TinyDecoder, batch: torch.Tensor, mesh: Mesh):
    """This rank's (inputs, targets) of a whole (B, S + 1) token batch:
    rows by its "dp" index, positions by its index along the model's
    ``cp_axis``, the S positions padded to a multiple of that axis (of
    twice it for "zigzag"), the padded targets -100 (no loss)."""
    inputs, targets = batch[:, :-1], batch[:, 1:]
    dp = mesh.shape.get("dp", 1)
    if inputs.shape[0] % dp:
        raise ValueError(f"batch {inputs.shape[0]} not divisible by dp {dp}")
    rows = inputs.shape[0] // dp
    lo = mesh.index("dp") * rows if dp > 1 else 0
    inputs, targets = inputs[lo:lo + rows], targets[lo:lo + rows]
    axis = model.cp_axis
    sp = mesh.shape.get(axis, 1) if axis is not None else 1
    if sp == 1:
        return inputs, targets
    mult = sp * (2 if model.cp_impl == "zigzag" else 1)
    pad = -inputs.shape[1] % mult
    inputs = F.pad(inputs, (0, pad))
    targets = F.pad(targets, (0, pad), value=-100)
    per = inputs.shape[1] // sp
    lo = mesh.index(axis) * per
    return inputs[:, lo:lo + per], targets[:, lo:lo + per]


def mesh_loss(model: TinyDecoder, batch: torch.Tensor,
              mesh: Mesh) -> torch.Tensor:
    """This rank's share of the global mean next-token cross entropy of
    the whole batch: its block's sum (`local_block`) over the batch's
    B·S tokens.  The shares of the ranks sum to the loss."""
    inputs, targets = local_block(model, batch, mesh)
    logits = model(inputs)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         targets.reshape(-1), ignore_index=-100,
                         reduction="sum")
    return ce / (batch.shape[0] * (batch.shape[1] - 1))


def _all_reduce(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    for axis in axes:
        x = mesh.all_reduce(x, axis, "sum")
    return x


class MasterAdamW(torch.optim.AdamW):
    """``optax.adamw`` over float32 masters of ``model``'s parameters.

    ``params`` ({name: tensor}, any dtype and device) seeds the masters
    unrounded; a float32 parameter is its own master and is left as it
    is.  `step` takes a parameter's gradient as its master's (cast to
    float32) unless the master already has one, updates the masters,
    and copies each into its parameter, rounded to the model dtype.
    ``masters`` maps each parameter's name to its master."""

    def __init__(self, model: TinyDecoder, params: dict[str, torch.Tensor],
                 *, lr: float):
        self.named = [(n, p) for n, p in model.named_parameters()
                      if p.requires_grad]
        self.masters = {
            n: p if p.dtype == torch.float32 else params[n].detach().to(
                p.device, torch.float32, copy=True)
            for n, p in self.named}
        super().__init__(list(self.masters.values()), lr=lr, **ADAMW)

    def pairs(self):
        """(parameter, master) for every trained parameter."""
        return [(p, self.masters[n]) for n, p in self.named]

    @torch.no_grad()
    def step(self, closure=None):
        for p, m in self.pairs():
            if m is not p and m.grad is None and p.grad is not None:
                m.grad = p.grad.float()
                p.grad = None
        loss = super().step(closure)
        self.sync()
        return loss

    @torch.no_grad()
    def sync(self) -> None:
        """Copy the masters into the model, rounded to its dtype."""
        for p, m in self.pairs():
            if m is not p:
                p.copy_(m)

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none)
        for p, _ in self.pairs():
            p.grad = None


def init_train(model: TinyDecoder, *, seed: int = 0, lr: float = 1e-3,
               params: dict[str, torch.Tensor] | None = None,
               mesh: Mesh | None = None, fsdp: bool = False
               ) -> MasterAdamW:
    """Load ``params`` (default: `init_params(model, seed)` drawn in
    float32) into ``model``, rounded to its dtype, and return a
    `MasterAdamW` with optax.adamw's settings whose masters are
    ``params`` unrounded (weights from `params_from_jax` keep their
    float32 bits there).  Under a ``mesh`` (JAX's `init_sharded`) the
    parameters are replicated: every rank draws the same seeded weights;
    tp > 1 and ``fsdp`` raise `NotImplementedError`."""
    _check_mesh(model, mesh, fsdp=fsdp)
    if params is None:
        params = init_params(model, seed, dtype=torch.float32)
    model.load_state_dict(params)
    return MasterAdamW(model, params, lr=lr)


def value_and_grad(model: TinyDecoder, batch: torch.Tensor,
                   mesh: Mesh | None = None, *, accum_steps: int = 1):
    """(loss, float32 gradients) of the (B, S + 1) token batch, as
    ``jax.value_and_grad(loss_fn)`` gives them: the loss a 0-d float32
    tensor, the gradients one per trained parameter of the model, in
    order, ``.grad`` left None.  Under a ``mesh`` every rank passes the
    whole batch and gets the global loss and the gradients summed over
    dp x sp (`mesh_loss`), the same on every rank.  ``accum_steps``
    equal microbatches (of rows) are summed in float32 and their mean
    taken, the loss too."""
    axes = _check_mesh(model, mesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if batch.shape[0] % accum_steps:
        raise ValueError(f"batch {batch.shape[0]} not divisible by "
                         f"accum_steps {accum_steps}")
    params = [p for p in model.parameters() if p.requires_grad]
    grads = [None] * len(params)
    loss = torch.zeros((), dtype=torch.float32, device=batch.device)
    for micro in batch.chunk(accum_steps):
        part = (loss_fn(model, micro) if mesh is None
                else mesh_loss(model, micro, mesh))
        part.backward()
        loss = loss + part.detach()
        for i, p in enumerate(params):
            # a float32 .grad is taken as it is, then added to in place
            g = p.grad.float()
            grads[i] = g if grads[i] is None else grads[i].add_(g)
            p.grad = None
    loss = _all_reduce(loss, mesh, axes) / accum_steps
    for i, g in enumerate(grads):
        grads[i] = _all_reduce(g, mesh, axes)
        if accum_steps > 1:
            grads[i].div_(accum_steps)
    return loss, grads


def make_train_step(model: TinyDecoder, optimizer: torch.optim.Optimizer,
                    mesh: Mesh | None = None, *, accum_steps: int = 1):
    """The step ``batch -> loss``: the gradient of `loss_fn` on the (B, S)
    token batch, then one optimizer update of ``model`` in place.  With
    ``accum_steps > 1`` the batch is split into that many equal
    microbatches whose gradients are summed in float32 and divided by
    ``accum_steps`` before the one update, as the JAX step does: a
    `MasterAdamW` takes the float32 mean, another optimizer the mean
    cast to each parameter's dtype.  The loss returned is the
    microbatches' mean, each with its own MoE aux loss.  Under a
    ``mesh`` (JAX's sharded step) every rank passes the whole batch and
    the step is `value_and_grad`'s: this rank's block through the
    context-parallel model, the global loss, the float32 gradients
    summed over dp x sp, then the same update on every rank.  Returns
    the loss as a 0-d float32 tensor."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _check_mesh(model, mesh)
    if isinstance(optimizer, MasterAdamW):
        pairs = optimizer.pairs()
    else:
        pairs = [(p, p) for p in model.parameters() if p.requires_grad]

    def train_step(batch: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss, grads = value_and_grad(model, batch, mesh,
                                     accum_steps=accum_steps)
        for g, (_, m) in zip(grads, pairs):
            m.grad = g.to(m.dtype)
        optimizer.step()
        return loss

    return train_step
