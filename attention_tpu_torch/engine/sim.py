"""Synthetic request traces + deterministic trace replay — the port of
`attention_tpu.engine.sim` (the plain trace; the multi-replica traces
come with the front end in a later slice).

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
