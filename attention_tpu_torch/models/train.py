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
model's, the norms', the router's, the head's) is its own master.  The
JAX package's dp/sp/tp mesh (`make_mesh_3d`, `shard_params`, FSDP) is
not ported: this trainer runs on one device.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from attention_tpu_torch.models.transformer import TinyDecoder, init_params

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
               params: dict[str, torch.Tensor] | None = None
               ) -> MasterAdamW:
    """Load ``params`` (default: `init_params(model, seed)` drawn in
    float32) into ``model``, rounded to its dtype, and return a
    `MasterAdamW` with optax.adamw's settings whose masters are
    ``params`` unrounded (weights from `params_from_jax` keep their
    float32 bits there)."""
    if params is None:
        params = init_params(model, seed, dtype=torch.float32)
    model.load_state_dict(params)
    return MasterAdamW(model, params, lr=lr)


def make_train_step(model: TinyDecoder, optimizer: torch.optim.Optimizer,
                    *, accum_steps: int = 1):
    """The step ``batch -> loss``: the gradient of `loss_fn` on the (B, S)
    token batch, then one optimizer update of ``model`` in place.  With
    ``accum_steps > 1`` the batch is split into that many equal
    microbatches whose gradients are summed in float32 and divided by
    ``accum_steps`` before the one update, as the JAX step does: a
    `MasterAdamW` takes the float32 mean, another optimizer the mean
    cast to each parameter's dtype.  The loss returned is the
    microbatches' mean, each with its own MoE aux loss.  Returns the
    loss as a 0-d float32 tensor."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if isinstance(optimizer, MasterAdamW):
        pairs = optimizer.pairs()
    else:
        pairs = [(p, p) for p in model.parameters() if p.requires_grad]

    def train_step(batch: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = loss_fn(model, batch)
            loss.backward()
        else:
            if batch.shape[0] % accum_steps:
                raise ValueError(f"batch {batch.shape[0]} not divisible by "
                                 f"accum_steps {accum_steps}")
            sums = [torch.zeros_like(p, dtype=torch.float32)
                    for p, _ in pairs]
            loss = torch.zeros((), dtype=torch.float32, device=batch.device)
            for micro in batch.chunk(accum_steps):
                part = loss_fn(model, micro)
                part.backward()
                loss = loss + part.detach()
                for acc, (p, _) in zip(sums, pairs):
                    acc += p.grad
                    p.grad = None
            loss = loss / accum_steps
            for acc, (_, m) in zip(sums, pairs):
                m.grad = (acc / accum_steps).to(m.dtype)
        optimizer.step()
        return loss.detach()

    return train_step
