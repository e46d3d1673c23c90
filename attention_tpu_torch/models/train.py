"""Single-device training: the port of `attention_tpu.models.train`.

`loss_fn` is the next-token cross entropy of the JAX package, on the
model's float32 logits head; `init_train` loads seeded weights and builds
the optimizer the JAX package's `init_sharded` builds, ``optax.adamw(lr)``
with optax's defaults; `make_train_step` returns a step that takes the
gradient of the loss (through `flash_attention_diff`, whose backward runs
the backward kernels on the card) and applies one update, optionally
over equal microbatches.  Parameters and optimizer state are updated in
place; the AdamW moments keep each parameter's dtype, as optax's do with
``mu_dtype=None``.  The JAX package's dp/sp/tp mesh (`make_mesh_3d`,
`shard_params`, FSDP) is not ported: this trainer runs on one device.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from attention_tpu_torch.models.transformer import TinyDecoder, init_params

#: optax.adamw's defaults (torch's AdamW defaults weight decay to 1e-2)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def loss_fn(model: TinyDecoder, batch: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy over (B, S) int tokens: the logits
    of ``batch[:, :-1]`` against ``batch[:, 1:]``."""
    logits = model(batch[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           batch[:, 1:].reshape(-1))


def init_train(model: TinyDecoder, *, seed: int = 0,
               lr: float = 1e-3) -> torch.optim.AdamW:
    """Load `init_params(model, seed)` into ``model`` and return an AdamW
    optimizer over its parameters with optax.adamw's settings."""
    model.load_state_dict(init_params(model, seed))
    return torch.optim.AdamW(model.parameters(), lr=lr, **ADAMW)


def make_train_step(model: TinyDecoder, optimizer: torch.optim.Optimizer,
                    *, accum_steps: int = 1):
    """The step ``batch -> loss``: the gradient of `loss_fn` on the (B, S)
    token batch, then one optimizer update of ``model`` in place.  With
    ``accum_steps > 1`` the batch is split into that many equal
    microbatches whose gradients are summed in float32 and divided by
    ``accum_steps`` (cast back to each parameter's dtype) before the one
    update, as the JAX step does; the loss returned is the microbatches'
    mean.  Returns the loss as a 0-d float32 tensor."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = loss_fn(model, batch)
            loss.backward()
        else:
            if batch.shape[0] % accum_steps:
                raise ValueError(f"batch {batch.shape[0]} not divisible by "
                                 f"accum_steps {accum_steps}")
            sums = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=batch.device)
            for micro in batch.chunk(accum_steps):
                part = loss_fn(model, micro)
                part.backward()
                loss = loss + part.detach()
                for acc, p in zip(sums, params):
                    acc += p.grad
                    p.grad = None
            loss = loss / accum_steps
            for acc, p in zip(sums, params):
                p.grad = (acc / accum_steps).to(p.dtype)
        optimizer.step()
        return loss.detach()

    return train_step
