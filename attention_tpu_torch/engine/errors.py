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
