"""Resumable training: the port of `attention_tpu.models.resilient`.

Train from the latest complete checkpoint (or from the seeded start),
checkpoint every ``ckpt_every`` steps, and after any process death
simply call again: the loop finds the newest checkpoint and continues
where it left off.  Data is a pure function of the global step
(``batch_fn(step)``), so an interrupted and resumed run reproduces the
uninterrupted one bit for bit on the same device, wherever its backward
gives the same bits every call.  On a ``mesh`` (JAX's signature) every
rank calls the loop with the same arguments and passes the whole batch;
the parameters are laid out by `init_train(mesh=, fsdp=)` and the
checkpoints hold the whole state (`models.checkpoint`), so a run may
resume on another mesh or ``fsdp`` setting.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from attention_tpu_torch.models.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from attention_tpu_torch.models.train import init_train, make_train_step
from attention_tpu_torch.models.transformer import TinyDecoder
from attention_tpu_torch.parallel.mesh import Mesh


def train_with_recovery(
    model: TinyDecoder,
    mesh: Mesh | None,
    batch_fn: Callable[[int], torch.Tensor],  # step -> (B, S+1) tokens
    *,
    steps: int,
    ckpt_dir: str | os.PathLike,
    ckpt_every: int = 10,
    seed: int = 0,
    lr: float = 1e-3,
    accum_steps: int = 1,
    fsdp: bool = False,
    on_step: Callable[[int, float], None] | None = None,
):
    """Run (or resume) training of ``model`` to ``steps``; returns
    ``(optimizer, losses)``, the model trained in place, where
    ``losses`` covers only the steps run by THIS call.

    ``on_step(step, loss)`` fires after each optimizer update and after
    the checkpoint it may write (fault injection in tests, logging in
    real use).  A crash anywhere, between a checkpoint and the next
    included, then another call, replays from the last checkpoint.
    ``mesh`` None trains on one device; on a mesh (with ``fsdp``) the
    model's parameters are laid out on it as `init_train` lays them."""
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    optimizer = init_train(model, seed=seed, lr=lr, mesh=mesh, fsdp=fsdp)
    start = 0
    last = latest_step(ckpt_dir)
    if last is not None:
        start = restore_checkpoint(ckpt_dir, model, optimizer, step=last)
    step_fn = make_train_step(model, optimizer, mesh,
                              accum_steps=accum_steps)
    losses = []
    for step in range(start, steps):
        loss = step_fn(batch_fn(step).to(model.device)).item()
        losses.append(loss)
        done = step + 1
        if done % ckpt_every == 0 or done == steps:
            save_checkpoint(ckpt_dir, done, model, optimizer)
        if on_step is not None:
            on_step(step, loss)
    return optimizer, losses
