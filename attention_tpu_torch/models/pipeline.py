"""Pipeline-parallel forward and training of the `TinyDecoder` stack:
the port of `attention_tpu.models.pipeline`.

The decoder's depth is cut into contiguous stages over a "pp" mesh axis
and driven by `parallel.pipeline.pipeline_local`: rank p runs blocks
[p·depth/n, (p+1)·depth/n) on every microbatch.  The embedding, the
final norm and the float32 head run outside the pipeline on every rank
alike, on the whole batch (the GPipe cut JAX makes).  The gradients of
those replicated tensors come out the same bits on every rank: the
pipeline gives every rank the same output and the same input gradient.

JAX's limits hold: the stages divide the depth; MoE blocks run on each
microbatch's own tokens (the capacity is the microbatch's) and their aux
losses are dropped; ``ep_axis`` is refused, and so are ``tp_axis`` and
``cp_axis``, since JAX's `_block_module` builds the stage's blocks
without them; ``model.remat`` recomputes each block in the backward.

For training, `init_pipelined_train` leaves on this rank only its own
stage's blocks (the others' parameters emptied, so that a forward
outside the pipeline fails rather than reads stale weights) and a
`MasterAdamW` whose float32 masters and moments hold those blocks and
the embedding, norm and head: the memory that a "pp" axis saves.
`make_pipelined_train_step` is JAX's: the mean token cross entropy of
`pipelined_forward`, no aux loss, one optimizer update.
"""

from __future__ import annotations

import torch
from torch.func import functional_call
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from attention_tpu_torch.models.train import MasterAdamW
from attention_tpu_torch.models.transformer import TinyDecoder, init_params
from attention_tpu_torch.parallel.mesh import Mesh
from attention_tpu_torch.parallel.pipeline import pipeline_local


def stack_block_params(params: dict, depth: int, n_stages: int) -> dict:
    """The blocks' ``blocks.{i}.<name>`` tensors of a port state dict
    stacked into {name: (n_stages, depth // n_stages, ...)}: stage s
    holds blocks s·depth/n_stages onward, in order."""
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    names = [n[len("blocks.0."):] for n in params
             if n.startswith("blocks.0.")]
    per = depth // n_stages
    return {n: torch.stack([params[f"blocks.{i}.{n}"] for i in range(depth)])
            .reshape(n_stages, per, *params[f"blocks.0.{n}"].shape)
            for n in names}


def _stage(model: TinyDecoder, mesh: Mesh, axis_name: str) -> range:
    """The blocks of this rank's stage, after JAX's refusals: a model
    whose blocks shard over another axis, and stages that do not divide
    the depth."""
    if model.ep_axis is not None:
        raise ValueError(
            f"pipelined_forward cannot honor ep_axis {model.ep_axis!r}: an "
            f"expert axis cannot live inside the {axis_name!r} pipeline; "
            "use a model without ep_axis (experts run replicated per "
            "stage)")
    for kw in ("tp_axis", "cp_axis"):
        if getattr(model, kw) is not None:
            raise ValueError(
                f"pipelined_forward builds its blocks without {kw} (JAX's "
                f"_block_module); use a model without {kw}")
    n = mesh.shape[axis_name]
    if model.depth % n:
        raise ValueError(f"depth {model.depth} not divisible by {n} stages")
    per = model.depth // n
    first = mesh.index(axis_name) * per
    return range(first, first + per)


def pipelined_forward(model: TinyDecoder, tokens: torch.Tensor, *,
                      mesh: Mesh, axis_name: str = "pp",
                      n_micro: int | None = None) -> torch.Tensor:
    """The float32 logits (B, S, vocab) of (B, S) tokens with the block
    stack pipelined over ``axis_name`` (``n_micro`` microbatches of the
    batch; default: one per stage): ``model(tokens)``'s, up to the
    rounding of the microbatches' products.  Every rank passes the same
    tokens and gets the same logits; a rank reads only its own stage's
    blocks."""
    blocks = [model.blocks[i] for i in _stage(model, mesh, axis_name)]
    # (the pipeline's name, the block's name) of each block's parameters
    keys = [[(f"{j}.{n}", n) for n, _ in block.named_parameters()]
            for j, block in enumerate(blocks)]
    params = {k: p for block, names in zip(blocks, keys)
              for (k, _), p in zip(names, block.parameters())}

    def run(block, own, h):
        return functional_call(block, own, (h,))[0]

    def stage_fn(params, h):
        for block, names in zip(blocks, keys):
            own = {n: params[k] for k, n in names}
            if model.remat:
                h = checkpoint(run, block, own, h, use_reentrant=False)
            else:
                h = run(block, own, h)
        return h

    x = pipeline_local(stage_fn, params, model.embed(tokens), mesh=mesh,
                       axis_name=axis_name, n_micro=n_micro)
    return model.head(model.norm(x).float())


def pipelined_loss(model: TinyDecoder, batch: torch.Tensor, *, mesh: Mesh,
                   axis_name: str = "pp",
                   n_micro: int | None = None) -> torch.Tensor:
    """JAX's pipelined loss: the mean next-token cross entropy of
    `pipelined_forward` on ``batch[:, :-1]`` against ``batch[:, 1:]``,
    without the MoE aux losses."""
    logits = pipelined_forward(model, batch[:, :-1], mesh=mesh,
                               axis_name=axis_name, n_micro=n_micro)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch[:, 1:].reshape(-1))


def init_pipelined_train(model: TinyDecoder, mesh: Mesh, *,
                         axis_name: str = "pp", seed: int = 0,
                         lr: float = 1e-3,
                         params: dict[str, torch.Tensor] | None = None
                         ) -> MasterAdamW:
    """Load ``params`` (default: `init_params(model, seed)` in float32,
    the same on every rank) into ``model``, empty the parameters of the
    blocks of the other stages, and return a `MasterAdamW` (optax.adamw's
    settings) over what is left: this stage's blocks and the embedding,
    norm and head, with float32 masters and moments of those alone."""
    own = _stage(model, mesh, axis_name)
    if params is None:
        params = init_params(model, seed, dtype=torch.float32)
    model.load_state_dict(params)
    for i, block in enumerate(model.blocks):
        if i not in own:
            for p in block.parameters():
                p.requires_grad_(False)
                p.data = p.data.new_empty(0)
    return MasterAdamW(model, params, lr=lr)


def make_pipelined_train_step(model: TinyDecoder,
                              optimizer: torch.optim.Optimizer, mesh: Mesh,
                              *, axis_name: str = "pp",
                              n_micro: int | None = None):
    """The step ``batch -> loss``: the gradient of `pipelined_loss` on the
    (B, S + 1) token batch (the same on every rank), whose forward and
    backward run the pipeline's schedule, then one update of
    ``optimizer`` (`init_pipelined_train`'s, or any over the model's
    parameters).  Returns the loss as a 0-d float32 tensor."""
    _stage(model, mesh, axis_name)

    def train_step(batch: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = pipelined_loss(model, batch, mesh=mesh, axis_name=axis_name,
                              n_micro=n_micro)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
