"""Training: the port of `attention_tpu.models.train`.

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
``torch.distributed`` world, or any `parallel.mesh.Mesh` with a "dp", a
"tp" and the model's ``cp_axis``) the parameters are laid out as JAX's
`shard_params` lays them out: `param_spec` is JAX's tp table (stated in
JAX's axis order, keyed on the port's names), `legal_spec` replicates a
dim whose axis the mesh lacks or does not divide, and ``fsdp=True``
(`fsdp_spec`) also splits each parameter's largest free dim over dp.
Each rank holds its block (`ParamLayout`), and `MasterAdamW` its block's
masters and moments.  Every rank passes the whole (B, S + 1) batch, as
JAX passes a global array.  The step takes this rank's block: rows by
its dp index, positions by its index along the model's ``cp_axis`` (the
sequence padded to a multiple of that axis, twice it for "zigzag", the
padding left out of the loss); the tp ranks hold the same tokens.  The
model runs Megatron's split over tp and context-parallel over the
sequence axis on its block; FSDP's parameters are gathered over dp once
a step, kept for the forward and the backward, then freed.  The loss is
the global mean (each rank's sum of cross entropy over the global token
count, the head's vocab split over tp taken in two phases, max then
sum, and all-reduced over dp x sp), plus the MoE layers' shares of
their global aux losses.  The float32 gradients are summed over dp x sp
(flax's gradients are float32; a bf16 sum over ranks would round at
every add), an FSDP gradient reduce-scattered over dp, and every rank
applies the same update to its block, so that a replicated parameter
stays the same bits on every rank.  An MoE model's ``ep_axis`` over the
tokens' axes ("dp" or the ``cp_axis``) holds each rank's block of the
experts there (`param_spec`), their gradients whole over that axis by
`MoEMLP`'s all-to-alls; a "pp" axis is `models.pipeline`'s.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch.nn import functional as F

from attention_tpu_torch.models.moe import MoEMLP, TokenShards
from attention_tpu_torch.models.transformer import TinyDecoder, init_params
from attention_tpu_torch.parallel.mesh import (
    Mesh,
    _world,
    grid_mesh,
    tp_copy,
    tp_reduce,
)

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


def _check_mesh(model: TinyDecoder, mesh: Mesh | None) -> tuple[str, ...]:
    """The mesh axes a step sums its gradients over (dp and the model's
    ``cp_axis``, those of more than one rank), after the refusals: a
    pipeline axis (`models.pipeline.make_pipelined_train_step` trains
    on one), an axis of more than one rank that is neither "dp", "tp",
    the model's ``cp_axis`` nor its ``ep_axis``, and an MoE ``ep_axis``
    of more than one rank other than "tp" beside a "tp" that splits the
    experts (JAX's table)."""
    if mesh is None:
        return ()
    if mesh.shape.get("pp", 1) > 1:
        raise ValueError(
            "a 'pp' mesh axis pipelines the blocks, which this step does "
            "not (nor does JAX's make_train_step); train it with "
            "models.pipeline.make_pipelined_train_step")
    for axis in mesh.axis_names:
        if axis not in ("dp", "tp", model.cp_axis, model.ep_axis) \
                and mesh.shape[axis] > 1:
            raise ValueError(
                f"mesh axis {axis!r} ({mesh.shape[axis]} ranks) is neither "
                f"'dp', 'tp' nor the model's cp_axis ({model.cp_axis!r})")
    tokens = ("dp", model.cp_axis)
    ep = model.ep_axis if model.moe_experts else None
    if ep is not None and ep != "tp" and mesh.shape.get(ep, 1) > 1:
        tp = mesh.shape.get("tp", 1)
        if tp > 1 and model.moe_experts % tp == 0:
            raise ValueError(
                f"ep_axis {ep!r} beside a 'tp' of {tp} ranks, which splits "
                "the experts (JAX's table); pass ep_axis='tp'")
    return tuple(a for a in tokens
                 if a is not None and mesh.shape.get(a, 1) > 1)


# ------------------------------------------------- the parameter layout


def param_spec(name: str, ndim: int, ep_axis: str = "tp") -> tuple:
    """The tp layout table (JAX's ``_param_spec``) by the port's
    parameter name: one mesh axis or None per dim, in JAX's axis order
    (`jax_shape`).  Norms and every 1-D tensor replicated; the embedding
    (vocab, dim) and the lm head (dim, vocab) on the vocab; q, k, v
    (dim, heads, head_dim) on the heads; ``o_proj`` (heads·head_dim,
    dim) on the head-derived dim; the MLP's up (dim, hidden) and down
    (hidden, dim) on the hidden dim; MoE experts (E, ...) on E over
    ``ep_axis`` (JAX's table: "tp"; a model's ``ep_axis`` over the
    tokens' axes holds them there, where `MoEMLP` moves the tokens to
    them); the router replicated."""
    if ndim == 1:
        spec = (None,)
    elif name == "embed.weight":
        spec = ("tp", None)
    elif name.endswith(_HEAD_PROJECTIONS):
        spec = (None, "tp", None)
    elif name.endswith(("o_proj.weight", "mlp.down.weight")):
        spec = ("tp", None)
    elif name.endswith(("experts_up", "experts_down")):
        spec = (ep_axis, None, None)
    elif name.endswith("router.weight"):
        spec = (None, None)
    else:  # the MLP's up, the lm head and anything else 2-D
        spec = (None, "tp")
    return spec + (None,) * (ndim - len(spec))


def legal_spec(spec: tuple, shape: tuple, mesh_shape: dict) -> tuple:
    """``spec`` with every dim replicated whose axis the mesh lacks or
    does not divide it (JAX's ``_legal_spec``): 2 kv heads on tp 4, a
    vocab of 61 on tp 2."""
    return tuple(None if axis is not None and (
        axis not in mesh_shape or dim % mesh_shape[axis]) else axis
        for dim, axis in zip(shape, spec))


def fsdp_spec(spec: tuple, shape: tuple, mesh_shape: dict) -> tuple:
    """``spec`` with its largest free dim that dp divides also split over
    "dp" (JAX's ``_fsdp_spec``: the larger index on a tie)."""
    if "dp" in spec or "dp" not in mesh_shape:
        return spec
    cands = [(shape[i], i) for i, axis in enumerate(spec)
             if axis is None and shape[i] % mesh_shape["dp"] == 0]
    if not cands:
        return spec
    _, i = max(cands)
    return spec[:i] + ("dp",) + spec[i + 1:]


_HEAD_PROJECTIONS = ("q_proj.weight", "k_proj.weight", "v_proj.weight")


class _View(NamedTuple):
    """A parameter's JAX layout as a view of the port's: the port tensor
    reshaped to ``merge + 2`` dims (its first dim unflattened) and
    permuted by ``perm`` is JAX's array."""

    merge: int
    perm: tuple

    def to_jax(self, t: torch.Tensor, jax_shape: tuple) -> torch.Tensor:
        split = [jax_shape[self.perm.index(i)] for i in range(len(self.perm))]
        return t.reshape(split).permute(self.perm)

    def from_jax(self, t: torch.Tensor) -> torch.Tensor:
        y = t.permute([self.perm.index(i) for i in range(len(self.perm))])
        return y.flatten(0, self.merge) if self.merge else y


def _view(name: str, ndim: int) -> _View:
    """q, k, v: JAX's (dim, heads, head_dim) kernel is the port's (heads ·
    head_dim, dim) weight; other ``Linear`` weights are JAX's kernels
    transposed; the embedding, the norms and the experts are JAX's."""
    if name.endswith(_HEAD_PROJECTIONS):
        return _View(1, (2, 0, 1))
    if name.endswith(".weight") and name != "embed.weight":
        return _View(0, (1, 0))
    return _View(0, tuple(range(ndim)))


def jax_shape(model: TinyDecoder, name: str, shape) -> tuple:
    """The JAX package's shape of the port's parameter ``name`` of
    ``shape`` (whole): what `param_spec` speaks of."""
    if name.endswith(_HEAD_PROJECTIONS):
        return (shape[1], shape[0] // model.head_dim, model.head_dim)
    if _view(name, len(shape)).perm == (1, 0):
        return (shape[1], shape[0])
    return tuple(shape)


class ParamLayout:
    """Each trained parameter's spec on ``mesh`` (JAX's order), and the
    moves between whole tensors and this rank's blocks.  ``specs`` and
    ``shapes`` (whole, JAX's order) by name; ``fsdp`` the names that
    FSDP split over "dp" (the MoE experts of an ``ep_axis="dp"`` model
    ride "dp" by the table, not by FSDP)."""

    def __init__(self, model: TinyDecoder, mesh: Mesh, *, fsdp: bool):
        self.mesh = mesh
        self.specs, self.shapes, self.views = {}, {}, {}
        self.fsdp = set()
        # the experts ride the model's ep_axis where its layers split
        # them over it (`MoEMLP`: with a mesh), else JAX's "tp"
        ep = (model.ep_axis if model.moe_experts and model.ep_axis
              and model.mesh is not None else "tp")
        for name, p in model.named_parameters():
            shape = jax_shape(model, name, p.shape)
            spec = legal_spec(param_spec(name, len(shape), ep), shape,
                              mesh.shape)
            if fsdp:
                cut = fsdp_spec(spec, shape, mesh.shape)
                if cut != spec:
                    self.fsdp.add(name)
                spec = cut
            self.specs[name], self.shapes[name] = spec, shape
            self.views[name] = _view(name, len(p.shape))

    def split(self, name: str, axis: str) -> bool:
        """Whether ``axis`` (of more than one rank) splits ``name``."""
        return axis in self.specs[name] and self.mesh.shape[axis] > 1

    def gathered(self, name: str) -> bool:
        """Whether FSDP splits ``name`` over a "dp" of more than one rank:
        gathered at use, its gradient reduce-scattered."""
        return name in self.fsdp and self.split(name, "dp")

    def _shape(self, name: str, axes) -> tuple:
        return tuple(d // self.mesh.shape[a] if a is not None and a in axes
                     else d
                     for d, a in zip(self.shapes[name], self.specs[name]))

    def block(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``name``."""
        t = self.views[name].to_jax(whole, self.shapes[name])
        for dim, axis in enumerate(self.specs[name]):
            if axis is not None:
                n = t.shape[dim] // self.mesh.shape[axis]
                t = t.narrow(dim, self.mesh.index(axis) * n, n)
        return self.views[name].from_jax(t).contiguous()

    def _gather(self, name: str, t: torch.Tensor, axes) -> torch.Tensor:
        spec = self.specs[name]
        t = self.views[name].to_jax(t, self._shape(name, spec))
        for dim, axis in enumerate(spec):
            if axis in axes:
                t = self.mesh.all_gather(t, axis, dim)
        return self.views[name].from_jax(t).contiguous()

    def whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor ``name`` from every rank's block (a
        collective: every rank calls it, in the same order)."""
        return self._gather(name, local, set(self.specs[name]) - {None})

    def gather_dp(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """FSDP at use: this rank's tp block of ``name`` from the dp
        blocks of its dp line."""
        return self._gather(name, local, {"dp"})

    def scatter_dp(self, name: str, grad: torch.Tensor) -> torch.Tensor:
        """FSDP's gradient: this rank's dp block of the sum over dp of
        the tp-block gradients ``grad``."""
        dim = self.specs[name].index("dp")
        shape = self._shape(name, [a for a in self.specs[name]
                                   if a != "dp"])
        g = self.views[name].to_jax(grad, shape)
        g = self.mesh.reduce_scatter(g, "dp", dim)
        return self.views[name].from_jax(g).contiguous()


def shard_params(model: TinyDecoder, mesh: Mesh, *,
                 fsdp: bool = False) -> ParamLayout:
    """Lay ``model``'s whole parameters out on ``mesh`` as JAX's
    `shard_params` does (`param_spec`, `legal_spec`, with ``fsdp``
    `fsdp_spec`): each parameter cut in place to this rank's block, and
    the modules told which of their weights tp splits (their
    ``tp_split``), so that the uncached forward runs Megatron's split.
    Returns the layout, also kept as ``model.layout``."""
    layout = ParamLayout(model, mesh, fsdp=fsdp)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = layout.block(name, p.data)
    for prefix, module in model.named_modules():
        if hasattr(module, "tp_split"):
            pre = f"{prefix}." if prefix else ""
            module.tp_mesh = mesh
            module.tp_split = frozenset(
                n for n, _ in module.named_parameters()
                if layout.split(pre + n, "tp"))
    model.layout = layout
    return layout


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
    """This rank's share of the global loss of the whole batch: its
    block's sum of cross entropy (`local_block`) over the batch's B·S
    tokens, plus its MoE layers' shares of their aux losses (the whole
    aux loss where the tokens are not split).  The shares of the dp x sp
    ranks sum to the loss; the tp ranks' are the same."""
    inputs, targets = local_block(model, batch, mesh)
    h, _, aux = model.features(inputs)
    if "head.weight" in model.tp_split:
        ce = _vocab_parallel_ce(h, model.head.weight, targets, mesh)
    else:
        logits = model.head(h)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1), ignore_index=-100,
                             reduction="sum")
    return ce / (batch.shape[0] * (batch.shape[1] - 1)) + aux


def _vocab_parallel_ce(h: torch.Tensor, weight: torch.Tensor,
                       targets: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of cross entropy of float32 features ``h`` (B, S, D)
    through the head's vocab block ``weight`` (V / tp, D) against
    ``targets`` (-100: no loss), in two phases over tp as
    `merge_partials` merges: the row max, then the sum of exponentials;
    the target's logit from the rank that holds it.  No rank builds the
    whole (B, S, V) logits."""
    logits = F.linear(tp_copy(h, mesh, "tp"), weight)
    rows = weight.shape[0]
    m = mesh.all_reduce(logits.detach().amax(-1), "tp", "max")
    total = tp_reduce(torch.exp(logits - m[..., None]).sum(-1), mesh, "tp")
    local = targets - mesh.index("tp") * rows
    inside = (local >= 0) & (local < rows)
    picked = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    target = tp_reduce(torch.where(inside, picked, 0.0), mesh, "tp")
    ce = torch.log(total) + m - target
    return torch.where(targets == -100, 0.0, ce).sum()


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
    float32 bits there).  Under a ``mesh`` (JAX's `init_sharded`) every
    rank draws the same whole seeded weights, and `shard_params` (with
    ``fsdp``) keeps this rank's blocks, whose masters and moments the
    optimizer holds."""
    _check_mesh(model, mesh)
    if fsdp and mesh is None:
        raise ValueError("fsdp=True shards over a mesh's dp axis; pass mesh=")
    if params is None:
        params = init_params(model, seed, dtype=torch.float32)
    model.load_state_dict(params)
    if mesh is not None:
        layout = shard_params(model, mesh, fsdp=fsdp)
        params = {n: layout.block(n, params[n]) for n in layout.specs}
    return MasterAdamW(model, params, lr=lr)


def _layout(model: TinyDecoder, mesh: Mesh | None):
    """The model's `ParamLayout`, which must be on ``mesh``."""
    layout = getattr(model, "layout", None)
    if layout is not None and layout.mesh is not mesh:
        raise ValueError("the model's parameters are laid out on another "
                         "mesh (shard_params); pass that mesh")
    return layout


@contextlib.contextmanager
def _step_context(model: TinyDecoder, mesh: Mesh | None, seq_len: int):
    """For one step's forwards and backwards: each FSDP parameter
    gathered over dp and put in its module's place (the tensors the
    gradients land on are yielded, one per trained parameter, in
    order); on a mesh that splits the tokens, each MoE layer told how
    (`TokenShards`)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    layout = _layout(model, mesh)
    used, swapped = [], []
    for name, p in named:
        if layout is not None and layout.gathered(name):
            full = layout.gather_dp(name, p.detach()).requires_grad_()
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner)
            swapped.append((module, leaf, p))
            module._parameters[leaf] = full
            used.append(full)
        else:
            used.append(p)
    moes = []
    if mesh is not None and model.moe_experts:
        axis = model.cp_axis
        shards = TokenShards(
            mesh, "dp" if mesh.shape.get("dp", 1) > 1 else None,
            axis if axis is not None and mesh.shape[axis] > 1 else None,
            seq_len)
        if shards.batch_axis or shards.seq_axis:
            moes = [m for m in model.modules() if isinstance(m, MoEMLP)]
            for m in moes:
                m.token_shards = shards
    try:
        yield used
    finally:
        for module, leaf, p in swapped:
            module._parameters[leaf] = p
        for m in moes:
            m.token_shards = None


def value_and_grad(model: TinyDecoder, batch: torch.Tensor,
                   mesh: Mesh | None = None, *, accum_steps: int = 1):
    """(loss, float32 gradients) of the (B, S + 1) token batch, as
    ``jax.value_and_grad(loss_fn)`` gives them: the loss a 0-d float32
    tensor, the gradients one per trained parameter of the model, in
    order, ``.grad`` left None.  Under a ``mesh`` every rank passes the
    whole batch and gets the global loss and the gradients of its
    blocks (`shard_params`; whole parameters where the model has no
    layout), summed over dp x sp (`mesh_loss`), an FSDP block's
    reduce-scattered over dp.  ``accum_steps`` equal microbatches (of
    rows) are summed in float32 and their mean taken, the loss too."""
    axes = _check_mesh(model, mesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if batch.shape[0] % accum_steps:
        raise ValueError(f"batch {batch.shape[0]} not divisible by "
                         f"accum_steps {accum_steps}")
    layout = _layout(model, mesh)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = [None] * len(names)
    loss = torch.zeros((), dtype=torch.float32, device=batch.device)
    with _step_context(model, mesh, batch.shape[1] - 1) as used:
        for micro in batch.chunk(accum_steps):
            part = (loss_fn(model, micro) if mesh is None
                    else mesh_loss(model, micro, mesh))
            part.backward()
            loss = loss + part.detach()
            for i, t in enumerate(used):
                # a float32 .grad is taken as it is, then added to in place
                g = t.grad.float()
                grads[i] = g if grads[i] is None else grads[i].add_(g)
                t.grad = None
    loss = _all_reduce(loss, mesh, axes) / accum_steps
    for i, (name, g) in enumerate(zip(names, grads)):
        if layout is not None and layout.gathered(name):
            g = layout.scatter_dp(name, g)
        # a block split over a token axis (FSDP's over dp, the experts
        # over an ep_axis there) already holds that axis's whole sum
        g = _all_reduce(g, mesh, [a for a in axes if layout is None
                                  or not layout.split(name, a)])
        if accum_steps > 1:
            g.div_(accum_steps)
        grads[i] = g
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
    model's Megatron and context-parallel split, the global loss, the
    float32 gradients of its parameter blocks, then the same update of
    every block.  Returns the loss as a 0-d float32 tensor."""
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
