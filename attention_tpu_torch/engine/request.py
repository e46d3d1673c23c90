"""Request objects and lifecycle for the continuous-batching engine —
the port's copy of `attention_tpu.engine.request` (pure Python).

A request is the unit of serving work: a prompt, per-request sampling
parameters, and the bookkeeping the scheduler/allocator need (owned
pages, how many tokens have committed KV, the not-yet-fed pending
token).  The lifecycle is a small explicit state machine —

    WAITING -> PREFILLING -> DECODING -> FINISHED
       ^           |            |
       |        PREEMPTED <-----+
       +-----------+   (requeued; recompute on readmission)

plus three terminal exits reachable from every non-terminal state:
CANCELLED (client gone), TIMED_OUT (deadline expired — the resilient
front end's TTL enforcement, checked at every engine step), and the
front-end-only SHED (admission control refused the request before it
ever touched an engine).

— and every transition goes through :meth:`Request.transition`, which
rejects illegal edges loudly (a request decoding before its prefill
finished is exactly the kind of bug that otherwise surfaces three
layers down as a poisoned page append).
"""

from __future__ import annotations

import dataclasses
import enum


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    PREEMPTED = "preempted"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    SHED = "shed"


#: the states a request can never leave — exactly the set the
#: resilience invariant pins: every admitted request ends in ONE of
#: FINISHED / CANCELLED / TIMED_OUT / SHED
TERMINAL_STATES = frozenset({
    RequestState.FINISHED, RequestState.CANCELLED,
    RequestState.TIMED_OUT, RequestState.SHED,
})

# legal lifecycle edges; PREFILLING -> FINISHED covers max_tokens == 1
# (the first token is sampled at prefill completion and already ends
# the request).  CANCELLED is reachable from every non-terminal state
# (`ServingEngine.cancel` — a client abandoning the request), and
# TIMED_OUT likewise (the engine's per-step deadline sweep); both are
# terminal like FINISHED.  SHED is the front end's admission refusal,
# so it is only reachable from WAITING — a request that has touched an
# engine is past the shedding gate.
_TRANSITIONS: dict[RequestState, frozenset[RequestState]] = {
    RequestState.WAITING: frozenset(
        {RequestState.PREFILLING, RequestState.CANCELLED,
         RequestState.TIMED_OUT, RequestState.SHED}
    ),
    RequestState.PREFILLING: frozenset(
        {RequestState.DECODING, RequestState.FINISHED,
         RequestState.PREEMPTED, RequestState.CANCELLED,
         RequestState.TIMED_OUT}
    ),
    RequestState.DECODING: frozenset(
        {RequestState.FINISHED, RequestState.PREEMPTED,
         RequestState.CANCELLED, RequestState.TIMED_OUT}
    ),
    RequestState.PREEMPTED: frozenset(
        {RequestState.PREFILLING, RequestState.CANCELLED,
         RequestState.TIMED_OUT}
    ),
    RequestState.FINISHED: frozenset(),
    RequestState.CANCELLED: frozenset(),
    RequestState.TIMED_OUT: frozenset(),
    RequestState.SHED: frozenset(),
}


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs — the same contract as
    `models.decode.generate` (temperature 0 = greedy argmax; top-k /
    top-p require temperature > 0), plus the serving-side stop
    conditions (``max_tokens``, optional ``stop_token``).  ``seed``
    keys the request's own PRNG chain, so a request's sampled stream
    is reproducible regardless of what else is in the batch."""

    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int = 0
    stop_token: int | None = None

    def validate(self, vocab: int) -> None:
        if self.max_tokens < 1:
            raise ValueError(
                f"max_tokens must be >= 1, got {self.max_tokens}"
            )
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}"
            )
        if self.temperature == 0.0 and (
            self.top_k is not None or self.top_p is not None
        ):
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature == 0 "
                "is greedy argmax)"
            )
        if self.top_p is not None and not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k is not None and not (1 <= self.top_k <= vocab):
            raise ValueError(
                f"top_k must be in [1, vocab={vocab}], got {self.top_k}"
            )


@dataclasses.dataclass
class Request:
    """One serving request plus its engine-side bookkeeping.

    ``tokens`` is the KV-bearing token sequence: the prompt, extended by
    each generated token *as it is fed back* into the model.  The last
    emitted token waits in ``pending_token`` until its decode step feeds
    it (and is never fed at all if it ends the request) — mirroring
    `generate_paged`, which emits ``steps`` tokens but appends only
    ``steps - 1`` of them.  ``computed_tokens`` counts how many of
    ``tokens`` have KV committed to pages; preemption-by-recompute
    resets it to 0 while keeping ``tokens``/``pending_token``, so the
    resumed request re-prefills its whole sequence and continues
    WITHOUT resampling anything already streamed out.
    """

    request_id: str
    prompt: tuple[int, ...]
    sampling: SamplingParams
    arrival: int = 0  # engine step at which the request becomes visible
    seq: int = 0      # admission tiebreak: FCFS is (arrival, seq)
    # engine step at which the request expires (None = no deadline):
    # the deadline sweep at the top of every `ServingEngine.step` times
    # out any request whose deadline_step <= the current step
    deadline_step: int | None = None

    state: RequestState = RequestState.WAITING
    tokens: list[int] = dataclasses.field(default_factory=list)
    output_tokens: list[int] = dataclasses.field(default_factory=list)
    pending_token: int | None = None
    computed_tokens: int = 0
    pages: list[int] = dataclasses.field(default_factory=list)
    prefix_cached_tokens: int = 0
    preemptions: int = 0

    # metrics timestamps (engine steps; -1 = not yet)
    first_scheduled_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1

    def __post_init__(self):
        if not self.prompt:
            raise ValueError(f"request {self.request_id}: empty prompt")
        if not self.tokens:
            self.tokens = list(self.prompt)

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt)

    @property
    def num_output_tokens(self) -> int:
        return len(self.output_tokens)

    @property
    def is_finished(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def is_terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def transition(self, new: RequestState) -> None:
        if new not in _TRANSITIONS[self.state]:
            raise ValueError(
                f"request {self.request_id}: illegal lifecycle "
                f"transition {self.state.name} -> {new.name}"
            )
        self.state = new

    def emit(self, token: int) -> bool:
        """Record one generated token; returns True if it ends the
        request (stop token or max_tokens reached).  A finishing token
        is never fed back, so it leaves ``tokens`` untouched."""
        self.output_tokens.append(int(token))
        done = (
            len(self.output_tokens) >= self.sampling.max_tokens
            or (self.sampling.stop_token is not None
                and int(token) == self.sampling.stop_token)
        )
        self.pending_token = None if done else int(token)
        return done

    def feed_pending(self) -> int:
        """Move the pending token into the KV-bearing sequence (the
        decode step is about to append its KV row)."""
        if self.pending_token is None:
            raise ValueError(
                f"request {self.request_id}: no pending token to feed"
            )
        tok = self.pending_token
        self.tokens.append(tok)
        self.pending_token = None
        return tok
