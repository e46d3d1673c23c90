"""Serving metrics: per-step rows and per-request latency records — the
port of `attention_tpu.engine.metrics` without the telemetry registry.

Step-denominated latencies are exact and deterministic (the unit of
serving time is the engine step); wall-clock figures ride along for
throughput.  Wall times are host clock around work that ends in the
step's device sync, so they are real step times on the card.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import numpy as np


@dataclasses.dataclass
class StepMetrics:
    """One scheduler/engine step."""

    step: int
    wall_s: float = 0.0
    num_decode_reqs: int = 0
    num_prefill_reqs: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0          # real prompt tokens (pads excluded)
    queue_depth: int = 0             # waiting (incl. preempted) after step
    running: int = 0
    admitted: int = 0
    preempted: int = 0
    finished: int = 0
    timed_out: int = 0               # deadline-sweep expiries this step
    free_pages: int = 0
    used_pages: int = 0
    page_utilization: float = 0.0
    prefix_hit_tokens_total: int = 0  # cumulative
    preemptions_total: int = 0        # cumulative
    pad_tokens: int = 0              # packed width minus real tokens
    ragged_occupancy: float = 0.0    # real / dispatched width
    host_overhead_s: float = 0.0     # wall minus the logits device sync

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


@dataclasses.dataclass
class RequestMetrics:
    """One finished request."""

    request_id: str
    arrival_step: int
    first_scheduled_step: int
    first_token_step: int
    finish_step: int
    prompt_tokens: int
    output_tokens: int
    prefix_cached_tokens: int
    preemptions: int
    ttft_s: float
    finish_s: float

    @property
    def ttft_steps(self) -> int:
        return self.first_token_step - self.arrival_step

    @property
    def tpot_steps(self) -> float:
        """Mean steps per output token after the first."""
        if self.output_tokens <= 1:
            return 0.0
        return (self.finish_step - self.first_token_step) \
            / (self.output_tokens - 1)


class EngineMetrics:
    """Collects step and request rows over an engine's lifetime."""

    def __init__(self):
        self.steps: list[StepMetrics] = []
        self.requests: list[RequestMetrics] = []
        self._t0 = time.perf_counter()

    def record_step(self, m: StepMetrics) -> None:
        self.steps.append(m)

    def record_request(self, m: RequestMetrics) -> None:
        self.requests.append(m)

    def summary(self) -> dict[str, Any]:
        wall = time.perf_counter() - self._t0
        out_tokens = sum(r.output_tokens for r in self.requests)
        prompt_tokens = sum(r.prompt_tokens for r in self.requests)
        cached = sum(r.prefix_cached_tokens for r in self.requests)
        ttfts = [r.ttft_steps for r in self.requests]
        tpots = [r.tpot_steps for r in self.requests if r.output_tokens > 1]
        busy = [s for s in self.steps if s.decode_tokens or s.prefill_tokens]
        mixed = [s for s in busy if s.decode_tokens and s.prefill_tokens]
        step_ms = [s.wall_s * 1e3 for s in busy]
        return {
            "num_requests": len(self.requests),
            "num_steps": len(self.steps),
            "wall_s": wall,
            "prompt_tokens": prompt_tokens,
            "output_tokens": out_tokens,
            "tokens_per_s": out_tokens / wall if wall else 0.0,
            "prefix_cached_tokens": cached,
            "mean_ttft_steps": float(np.mean(ttfts)) if ttfts else 0.0,
            "max_ttft_steps": max(ttfts) if ttfts else 0,
            "mean_tpot_steps": float(np.mean(tpots)) if tpots else 0.0,
            "mixed_batch_steps": len(mixed),
            "median_step_ms": float(np.median(step_ms)) if step_ms else 0.0,
            "peak_page_utilization": max(
                (s.page_utilization for s in self.steps), default=0.0),
            "preemptions": self.steps[-1].preemptions_total
            if self.steps else 0,
            "pad_tokens_total": sum(s.pad_tokens for s in self.steps),
            "mean_ragged_occupancy": float(np.mean(
                [s.ragged_occupancy for s in busy])) if busy else 0.0,
            "mean_host_overhead_ms": float(np.mean(
                [s.host_overhead_s for s in busy])) * 1e3 if busy else 0.0,
        }
