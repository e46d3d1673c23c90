"""Typed serving errors of the port's engine (the subset of
`attention_tpu.engine.errors` a single engine raises)."""

from __future__ import annotations


class DeadlineExceededError(RuntimeError):
    """A request's deadline expired before admission.

    Raised by `ServingEngine.add_request` when the deadline step is not
    after the current step; mid-flight expiry instead moves the request
    to the terminal TIMED_OUT state."""


class StepLimitExceededError(RuntimeError):
    """`ServingEngine.run(max_steps=...)` hit its cap before the queue
    drained."""


class SnapshotError(RuntimeError):
    """Base class for serving-state durability failures.

    `recover_engine` catches this class: any subclass means "warm
    recovery unavailable, take the cold path", never a crash."""


class SnapshotCorruptError(SnapshotError):
    """A snapshot or journal file failed validation.

    Bad magic, unsupported version, truncated section, per-section CRC
    mismatch, or a model fingerprint that does not match the engine
    being restored.  Raised by `engine.snapshot.restore` (and by
    `recover_engine` when no candidate validates); a torn journal tail
    is tolerated instead: the valid prefix is used."""
