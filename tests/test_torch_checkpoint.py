"""Checkpoints and crash-resume of the port's trainer, on the CPU: the
contract of `attention_tpu.models.checkpoint` and `.resilient`
(tests/test_checkpoint.py and tests/test_resilient.py) on the port's
`save_checkpoint`, `restore_checkpoint`, `latest_step`, `complete_steps`
and `train_with_recovery`.  The model is a bf16 mixture of experts, so
that the float32 masters, the optimizer's moments and the aux loss all
cross a checkpoint; on the CPU every step gives the same bits every
call, so a resumed run must equal the uninterrupted one exactly.

Run as a script, this file is the crash test's child process:

    python tests/test_torch_checkpoint.py CKPT_DIR STEPS EVERY CRASH_AFTER OUT_NPZ

trains with `train_with_recovery` and, when CRASH_AFTER > 0, dies by
``os._exit(17)`` (no cleanup, no final checkpoint) after that many steps
of this invocation.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from attention_tpu_torch.models import (
    TinyDecoder,
    complete_steps,
    init_train,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    train_with_recovery,
)

MODEL = dict(vocab=64, dim=32, depth=1, num_q_heads=4, num_kv_heads=2,
             rope=True, moe_experts=4)


def _model(dtype=torch.bfloat16):
    return TinyDecoder(dtype=dtype, device="cpu", **MODEL)


def _batch(step: int) -> torch.Tensor:
    """The tokens of global step ``step``: a pure function of it."""
    rng = np.random.default_rng(1000 + step)
    return torch.from_numpy(rng.integers(0, MODEL["vocab"], (4, 33)))


def _state(model, optimizer):
    """Every tensor of the training state: the model's weights, the
    masters, the optimizer's moments and step counts."""
    out = {f"model.{k}": v for k, v in model.state_dict().items()}
    out.update({f"master.{k}": m for k, m in optimizer.masters.items()})
    for i, state in optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in state.items()})
    return out


def _assert_same_bits(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k, x in a.items():
        assert x.dtype == b[k].dtype and torch.equal(x, b[k]), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_checkpoint_roundtrip_resumes_training(tmp_path, dtype):
    model = _model(dtype)
    optimizer = init_train(model, seed=0)
    step_fn = make_train_step(model, optimizer)
    step_fn(_batch(0))
    step_fn(_batch(1))
    ckpt = tmp_path / "ckpts"
    path = save_checkpoint(ckpt, 2, model, optimizer)
    assert os.path.isfile(os.path.join(path, "COMPLETE"))
    assert latest_step(ckpt) == 2 and complete_steps(ckpt) == [2]

    fresh = _model(dtype)
    fresh_opt = init_train(fresh, seed=1)
    assert restore_checkpoint(ckpt, fresh, fresh_opt) == 2
    _assert_same_bits(_state(fresh, fresh_opt), _state(model, optimizer))
    for name, p in fresh.named_parameters():
        assert torch.equal(p.detach(), fresh_opt.masters[name].to(p.dtype))

    resumed = make_train_step(fresh, fresh_opt)(_batch(2))
    straight = step_fn(_batch(2))
    assert torch.equal(resumed, straight)
    _assert_same_bits(_state(fresh, fresh_opt), _state(model, optimizer))


def test_latest_step_empty(tmp_path):
    assert latest_step(tmp_path / "nope") is None
    assert complete_steps(tmp_path / "nope") == []


def test_interrupted_save_falls_back_to_complete_step(tmp_path):
    """A digit-named step directory without the completion marker (a
    torn write) must not shadow the last durable checkpoint."""
    model = _model()
    optimizer = init_train(model, seed=0)
    make_train_step(model, optimizer)(_batch(0))
    ckpt = tmp_path / "ckpts"
    save_checkpoint(ckpt, 3, model, optimizer)
    torn = ckpt / "7"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"\x00" * 64)

    assert latest_step(ckpt) == 3 and complete_steps(ckpt) == [3]
    fresh = _model()
    fresh_opt = init_train(fresh, seed=1)
    assert restore_checkpoint(ckpt, fresh, fresh_opt) == 3
    _assert_same_bits(_state(fresh, fresh_opt), _state(model, optimizer))


def test_unloadable_complete_step_is_skipped_unless_asked_for(tmp_path,
                                                              caplog):
    """A step whose marker landed but whose state does not load is
    passed over with a warning; asked for by number, its failure
    propagates; with no step that loads, `FileNotFoundError`."""
    model = _model()
    optimizer = init_train(model, seed=0)
    ckpt = tmp_path / "ckpts"
    save_checkpoint(ckpt, 3, model, optimizer)
    bad = ckpt / "9"
    bad.mkdir()
    (bad / "state.pt").write_bytes(b"not a checkpoint")
    (bad / "COMPLETE").write_text("9\n")
    assert latest_step(ckpt) == 9
    with caplog.at_level(logging.WARNING):
        assert restore_checkpoint(ckpt, model, optimizer) == 3
    assert "step 9 unrestorable" in caplog.text
    with pytest.raises(Exception):
        restore_checkpoint(ckpt, model, optimizer, step=9)
    (ckpt / "3" / "state.pt").write_bytes(b"torn")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(ckpt, model, optimizer)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty", model, optimizer)


def test_restore_refuses_another_models_checkpoint(tmp_path):
    model = _model()
    optimizer = init_train(model, seed=0)
    save_checkpoint(tmp_path, 1, model, optimizer)
    other = TinyDecoder(dtype=torch.bfloat16, device="cpu",
                        **dict(MODEL, moe_experts=None))
    with pytest.raises(ValueError, match="do not match"):
        restore_checkpoint(tmp_path, other, init_train(other), step=1)


def _run(ckpt_dir, steps, every, crash_after, out_npz):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(ckpt_dir),
         str(steps), str(every), str(crash_after), str(out_npz)],
        capture_output=True, text=True, timeout=300, env=env, cwd=repo)


def test_crash_midway_then_resume_matches_uninterrupted(tmp_path):
    """A real process death (``os._exit``) after 3 of 6 steps, with
    checkpoints every 2, then a fresh call: it resumes from step 2 and
    ends with the uninterrupted run's losses and state, bit for bit."""
    steps, every = 6, 2
    ref = _run(tmp_path / "ref_ckpt", steps, every, 0, tmp_path / "ref.npz")
    assert ref.returncode == 0, ref.stdout + ref.stderr

    crashed = _run(tmp_path / "ckpt", steps, every, 3, tmp_path / "x.npz")
    assert crashed.returncode == 17, crashed.stdout + crashed.stderr
    assert not (tmp_path / "x.npz").exists()
    assert complete_steps(tmp_path / "ckpt") == [2]

    resumed = _run(tmp_path / "ckpt", steps, every, 0, tmp_path / "r.npz")
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    want, got = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "r.npz")
    assert len(got["losses"]) == steps - 2
    np.testing.assert_array_equal(got["losses"], want["losses"][2:])
    np.testing.assert_array_equal(got["state"], want["state"])
    assert complete_steps(tmp_path / "ckpt") == [2, 4, 6]


def main(argv) -> int:
    ckpt_dir, steps, every, crash_after, out_npz = argv
    crash_after = int(crash_after)
    executed = [0]

    def on_step(step: int, loss: float) -> None:
        executed[0] += 1
        if crash_after > 0 and executed[0] >= crash_after:
            os._exit(17)  # a hard crash: no cleanup, no checkpoint

    model = _model()
    optimizer, losses = train_with_recovery(
        model, None, _batch, steps=int(steps), ckpt_dir=ckpt_dir,
        ckpt_every=int(every), seed=5, on_step=on_step)
    state = np.concatenate([t.detach().float().reshape(-1).numpy() for t in
                            _state(model, optimizer).values()])
    np.savez(out_npz, losses=np.asarray(losses), state=state)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
