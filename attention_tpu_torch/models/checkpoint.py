"""Checkpoint and resume of training state: the port of
`attention_tpu.models.checkpoint`, on ``torch.save``.

A checkpoint of step ``s`` is the directory ``<ckpt_dir>/<s>`` holding
``state.pt`` (the step, the float32 master of every trained parameter
by name, and the optimizer's state) and the completion marker
``COMPLETE``.  `save_checkpoint` writes both into a temporary directory,
fsyncs them, and only then renames it to ``<s>``, so a process that dies
mid-save leaves no directory of that name at all.  A digit-named
directory without the marker (a torn write, or a foreign one) is not a
checkpoint: `complete_steps` and `latest_step` skip it, and
`restore_checkpoint` walks the complete steps newest first past any that
fails to load.

A model laid out on a mesh (`models.train.shard_params`, ``model.layout``)
checkpoints in the same format: every rank all-gathers the whole float32
masters and moments (a collective), rank 0 writes them by the same
protocol, and a barrier follows, so that no rank reads or dies before the
step is durable.  Restore loads the whole tensors on every rank and cuts
each rank's block for the mesh and ``fsdp`` it runs now, as JAX's orbax
restore lays global arrays out on the caller's template: a checkpoint
written on one mesh restores on any other, or on one device.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from attention_tpu_torch.models.train import MasterAdamW
from attention_tpu_torch.parallel.mesh import _world

_logger = logging.getLogger(__name__)

STATE = "state.pt"
#: written, and fsynced, after the state: a step directory without it is
#: torn
COMPLETE = "COMPLETE"


def _masters(model, optimizer: MasterAdamW) -> dict[str, torch.Tensor]:
    """``optimizer``'s masters, which must be those of ``model``'s
    trained parameters."""
    names = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    if sorted(optimizer.masters) != names:
        raise ValueError("the optimizer's masters are not those of the "
                         "model's parameters")
    return optimizer.masters


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _whole_state(model, optimizer: MasterAdamW) -> dict:
    """The masters and the optimizer's state as whole tensors on the
    host: gathered from every rank's block under a layout (every rank
    calls this, in the same order)."""
    layout = getattr(model, "layout", None)

    def whole(name, t):
        t = t.detach()
        return (t if layout is None else layout.whole(name, t)).cpu()

    masters = {n: whole(n, m) for n, m in _masters(model, optimizer).items()}
    opt = optimizer.state_dict()
    names = [n for n, _ in optimizer.named]
    # the packed state's dicts are the optimizer's own: copies are changed
    opt["state"] = {i: {**st, **{key: whole(names[i], st[key])
                                 for key in ("exp_avg", "exp_avg_sq")}}
                    for i, st in opt["state"].items()}
    return {"masters": masters, "optimizer": opt}


def save_checkpoint(ckpt_dir: str | os.PathLike, step: int, model,
                    optimizer: MasterAdamW) -> str:
    """Write an atomic checkpoint of ``step`` of ``model`` trained by
    ``optimizer`` (`init_train`'s; an existing checkpoint of that step
    is replaced); returns its path.  Collective under a layout: every
    rank calls it, rank 0 writes, and a barrier follows; without one the
    caller writes, whatever its rank."""
    ckpt_dir = os.path.abspath(os.fspath(ckpt_dir))
    path = os.path.join(ckpt_dir, str(step))
    state = {"step": step, **_whole_state(model, optimizer)}
    laid_out = getattr(model, "layout", None) is not None
    if not laid_out or _world()[1] == 0:
        _write(ckpt_dir, path, step, state)
    if laid_out and dist.is_initialized():
        dist.barrier()
    return path


def _write(ckpt_dir: str, path: str, step: int, state: dict) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=ckpt_dir)
    try:
        torch.save(state, os.path.join(tmp, STATE))
        with open(os.path.join(tmp, COMPLETE), "w") as f:
            f.write(f"{step}\n")
        for name in (STATE, COMPLETE):
            _fsync(os.path.join(tmp, name))
        _fsync(tmp)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync(ckpt_dir)


def _is_complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, COMPLETE))


def complete_steps(ckpt_dir: str | os.PathLike) -> list[int]:
    """All complete step numbers under ``ckpt_dir``, ascending.
    Digit-named directories without the completion marker are
    excluded."""
    ckpt_dir = os.fspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d) for d in os.listdir(ckpt_dir)
        if d.isdigit() and _is_complete(os.path.join(ckpt_dir, d)))


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    """The newest COMPLETE step (None when there is none): a torn newest
    directory must not shadow the last durable checkpoint."""
    steps = complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def _restore(path: str, model, optimizer: MasterAdamW) -> int:
    state = torch.load(os.path.join(path, STATE), map_location="cpu",
                       weights_only=True)
    masters = _masters(model, optimizer)
    if sorted(state["masters"]) != sorted(masters):
        raise ValueError(f"{path}: parameters {sorted(state['masters'])} "
                         f"do not match the model's {sorted(masters)}")
    layout = getattr(model, "layout", None)

    def block(name, whole):
        return whole if layout is None else layout.block(name, whole)

    with torch.no_grad():
        for name, m in masters.items():
            m.copy_(block(name, state["masters"][name]))
    opt = state["optimizer"]
    names = [n for n, _ in optimizer.named]
    for i, st in opt["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            st[key] = block(names[i], st[key])
    optimizer.load_state_dict(opt)
    optimizer.sync()
    return int(state["step"])


def restore_checkpoint(ckpt_dir: str | os.PathLike, model,
                       optimizer: MasterAdamW, *,
                       step: int | None = None) -> int:
    """Load a checkpoint into ``model`` and ``optimizer`` in place (the
    masters, the optimizer's state, and the model's weights as the
    masters rounded to its dtype); returns the step restored.

    With ``step=None``, tries the complete steps newest to oldest: a
    step that has its marker but still fails to load is skipped with a
    warning, and `FileNotFoundError` is raised when none loads.  An
    explicit ``step`` is restored as asked: its failure propagates."""
    ckpt_dir = os.path.abspath(os.fspath(ckpt_dir))
    if step is not None:
        return _restore(os.path.join(ckpt_dir, str(step)), model, optimizer)
    candidates = complete_steps(ckpt_dir)
    if not candidates:
        raise FileNotFoundError(f"no complete checkpoints under {ckpt_dir}")
    last_error: Exception | None = None
    for cand in reversed(candidates):
        try:
            return _restore(os.path.join(ckpt_dir, str(cand)), model,
                            optimizer)
        except Exception as e:  # noqa: BLE001 - torch.load raises assorted types
            last_error = e
            _logger.warning("checkpoint step %d unrestorable (%s); "
                            "falling back", cand, e)
    raise FileNotFoundError(
        f"no restorable checkpoint under {ckpt_dir} "
        f"(last error: {last_error})")
