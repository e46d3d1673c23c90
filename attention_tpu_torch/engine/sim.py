"""Synthetic request traces + deterministic trace replay — the port of
`attention_tpu.engine.sim`: the plain, bursty and diurnal traces (the
disaggregated trace comes with the fleet in a later slice).

A trace is a plain-JSON list of requests (arrival step, prompt token
ids, sampling params), so a workload is a file: `synthetic_trace`
fabricates one from a seed (numpy, the same traces as the JAX package)
and `replay` feeds one through an engine and collects every request's
output stream.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from attention_tpu_torch.engine.engine import ServingEngine
from attention_tpu_torch.engine.request import SamplingParams

_SAMPLING_KEYS = ("max_tokens", "temperature", "top_k", "top_p", "seed",
                  "stop_token")


def synthetic_trace(
    num_requests: int,
    *,
    vocab: int,
    seed: int = 0,
    prompt_len_min: int = 4,
    prompt_len_max: int = 24,
    max_tokens: int = 8,
    arrival_every: int = 1,
    shared_prefix_len: int = 0,
    shared_count: int = 0,
    temperature: float = 0.0,
) -> list[dict[str, Any]]:
    """A seeded synthetic request trace.

    The first ``shared_count`` requests start with one common
    ``shared_prefix_len``-token prefix (generate-once-reuse-many: make
    it at least ``page_size + 1`` for the prefix cache to engage).
    Arrivals are staggered ``arrival_every`` steps apart (0 = all at
    step 0).  Token 0 is reserved as the engine's pad token and never
    generated into prompts.
    """
    if num_requests < 1:
        raise ValueError(f"num_requests must be >= 1, got {num_requests}")
    if not (1 <= prompt_len_min <= prompt_len_max):
        raise ValueError(
            f"bad prompt length range [{prompt_len_min}, {prompt_len_max}]"
        )
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, shared_prefix_len).tolist() \
        if shared_prefix_len else []
    trace = []
    for i in range(num_requests):
        n = int(rng.integers(prompt_len_min, prompt_len_max + 1))
        body = rng.integers(1, vocab, n).tolist()
        prompt = (shared + body) if i < shared_count else body
        trace.append({
            "id": f"req-{i}",
            "arrival": i * arrival_every,
            "prompt": [int(t) for t in prompt],
            "max_tokens": int(max_tokens),
            "temperature": float(temperature),
            "seed": int(seed + i),
        })
    return trace


def bursty_trace(
    num_requests: int,
    *,
    vocab: int,
    seed: int = 0,
    tenants: int = 2,
    burst_every: int = 6,
    burst_size: int = 3,
    shared_prefix_len: int = 0,
    prompt_len_min: int = 4,
    prompt_len_max: int = 24,
    max_tokens: int = 8,
    temperature: float = 0.0,
    deadline_ticks: int | None = None,
    priorities: tuple[int, ...] = (0, 1, 1, 2),
) -> list[dict[str, Any]]:
    """A seeded multi-tenant bursty trace (the JAX package's, entry for
    entry).

    Requests arrive in BURSTS of ``burst_size`` every ``burst_every``
    ticks, tagged with fields a single engine ignores (`replay` reads
    neither) and a multi-replica front end would consume:

    * ``session``: ``tenant-<k>`` — requests of one tenant share a
      session (sticky routing) and, when ``shared_prefix_len`` > 0,
      a per-tenant common prompt prefix (make it >= page_size + 1 for
      the prefix cache to engage);
    * ``priority``: drawn from ``priorities`` (0 = highest; class 2 is
      the sheddable tail);
    * ``deadline_ticks``: per-request TTL relative to arrival
      (None = no deadline).

    Token 0 stays reserved as the engine's pad token.
    """
    if num_requests < 1:
        raise ValueError(f"num_requests must be >= 1, got {num_requests}")
    if tenants < 1 or burst_every < 1 or burst_size < 1:
        raise ValueError(
            "tenants, burst_every, and burst_size must all be >= 1"
        )
    if not (1 <= prompt_len_min <= prompt_len_max):
        raise ValueError(
            f"bad prompt length range [{prompt_len_min}, {prompt_len_max}]"
        )
    rng = np.random.default_rng(seed)
    prefixes = [
        rng.integers(1, vocab, shared_prefix_len).tolist()
        if shared_prefix_len else []
        for _ in range(tenants)
    ]
    trace = []
    for i in range(num_requests):
        burst = i // burst_size
        tenant = int(rng.integers(tenants))
        n = int(rng.integers(prompt_len_min, prompt_len_max + 1))
        body = rng.integers(1, vocab, n).tolist()
        entry = {
            "id": f"req-{i}",
            "arrival": burst * burst_every,
            "prompt": [int(t) for t in prefixes[tenant] + body],
            "max_tokens": int(max_tokens),
            "temperature": float(temperature),
            "seed": int(seed + i),
            "session": f"tenant-{tenant}",
            "priority": int(priorities[int(rng.integers(
                len(priorities)))]),
        }
        if deadline_ticks is not None:
            entry["deadline_ticks"] = int(deadline_ticks)
        trace.append(entry)
    return trace


def diurnal_trace(
    num_requests: int,
    *,
    vocab: int,
    seed: int = 0,
    period: int = 48,
    base_rate: float = 1.0,
    peak_rate: float = 4.0,
    tenants: int = 3,
    rag_every: int = 7,
    rag_prefill_len: int = 64,
    prompt_len_min: int = 4,
    prompt_len_max: int = 24,
    max_tokens: int = 8,
    temperature: float = 0.0,
    deadline_ticks: int | None = None,
    priorities: tuple[int, ...] = (0, 1, 1, 2),
) -> list[dict[str, Any]]:
    """A seeded diurnal trace (the JAX package's, entry for entry).

    Arrival rate follows one sinusoidal "day" of ``period`` ticks,
    swinging between ``base_rate`` (trough) and ``peak_rate`` (peak)
    requests/tick — the shape a production fleet sees from
    millions of users across time zones, scaled down to sim ticks.
    Arrivals are generated by deterministic rate integration (advance
    virtual time by ``1/rate(t)`` per request), so the SAME seed and
    knobs give the same arrival ticks on every platform.

    The tenant mix is the `bursty_trace` schema (``session``,
    ``priority``, optional ``deadline_ticks``); every ``rag_every``-th
    request is a long-prefill RAG burst — its tenant's shared
    ``rag_prefill_len``-token retrieval header (make it >= page_size +
    1 for the prefix cache to engage) glued before the body, the
    workload that makes prefill pressure seasonal too.  Token 0 stays
    reserved as the engine's pad token.
    """
    if num_requests < 1:
        raise ValueError(f"num_requests must be >= 1, got {num_requests}")
    if period < 2:
        raise ValueError(f"period must be >= 2 ticks, got {period}")
    if not (0.0 < base_rate <= peak_rate):
        raise ValueError(
            f"need 0 < base_rate <= peak_rate, got "
            f"{base_rate}/{peak_rate}"
        )
    if tenants < 1 or rag_every < 1:
        raise ValueError("tenants and rag_every must both be >= 1")
    if not (1 <= prompt_len_min <= prompt_len_max):
        raise ValueError(
            f"bad prompt length range [{prompt_len_min}, {prompt_len_max}]"
        )
    rng = np.random.default_rng(seed)
    rag_prefixes = [
        rng.integers(1, vocab, rag_prefill_len).tolist()
        if rag_prefill_len else []
        for _ in range(tenants)
    ]
    trace = []
    clock = 0.0
    mid = (peak_rate + base_rate) / 2.0
    amp = (peak_rate - base_rate) / 2.0
    for i in range(num_requests):
        # rate at the current virtual time; trough at t=0 so a run
        # starts quiet, peaks mid-period
        rate = mid - amp * float(np.cos(2.0 * np.pi * clock / period))
        clock += 1.0 / rate
        tenant = int(rng.integers(tenants))
        n = int(rng.integers(prompt_len_min, prompt_len_max + 1))
        body = rng.integers(1, vocab, n).tolist()
        is_rag = rag_prefill_len > 0 and (i + 1) % rag_every == 0
        prompt = (rag_prefixes[tenant] + body) if is_rag else body
        entry = {
            "id": f"req-{i}",
            "arrival": int(clock),
            "prompt": [int(t) for t in prompt],
            "max_tokens": int(max_tokens),
            "temperature": float(temperature),
            "seed": int(seed + i),
            "session": f"tenant-{tenant}",
            "priority": int(priorities[int(rng.integers(
                len(priorities)))]),
        }
        if deadline_ticks is not None:
            entry["deadline_ticks"] = int(deadline_ticks)
        trace.append(entry)
    return trace


def save_trace(path: str, trace: list[dict[str, Any]]) -> None:
    """Persist a trace as JSON (the JAX package's file layout)."""
    doc: dict[str, Any] = {"requests": trace}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def load_trace(path: str) -> list[dict[str, Any]]:
    with open(path) as f:
        data = json.load(f)
    reqs = data["requests"] if isinstance(data, dict) else data
    if not isinstance(reqs, list) or not reqs:
        raise ValueError(f"{path}: trace holds no requests")
    for r in reqs:
        if "prompt" not in r or not r["prompt"]:
            raise ValueError(f"{path}: request {r.get('id')} has no prompt")
    return reqs


def sampling_of(entry: dict[str, Any]) -> SamplingParams:
    """`SamplingParams` from one trace entry."""
    kw = {k: entry[k] for k in _SAMPLING_KEYS if entry.get(k) is not None}
    return SamplingParams(**kw)


def replay(engine: ServingEngine, trace: list[dict[str, Any]], *,
           max_steps: int | None = None):
    """Feed a trace through ``engine`` and run it dry.  Returns
    ``(summary, outputs)`` with ``outputs[request_id]`` the generated
    token list, in trace order."""
    outputs: dict[str, list[int]] = {}

    def _collect(req, token):
        outputs.setdefault(req.request_id, []).append(int(token))

    prev = engine.on_token

    def _chained(req, token):
        _collect(req, token)
        if prev is not None:
            prev(req, token)

    engine.on_token = _chained
    try:
        for entry in trace:
            engine.add_request(
                entry["prompt"], sampling_of(entry),
                request_id=entry.get("id"),
                arrival=int(entry.get("arrival", 0)),
            )
        summary = engine.run(max_steps=max_steps)
    finally:
        engine.on_token = prev
    return summary, outputs
