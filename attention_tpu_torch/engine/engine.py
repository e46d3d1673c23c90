"""The continuous-batching serving engine: the port of
`attention_tpu.engine.engine`, single device.

``step_mode="ragged"`` (the default): every step packs decode tokens and
prefill chunks onto one token axis (`ScheduledStep.pack`) and makes ONE
model call over per-layer `RaggedPagedStep` caches: each layer appends
its K/V rows through the page tables and runs one ragged kernel launch.
``step_mode="two_call"``: the JAX engine's fixed-shape pair, kept as the
ragged step's parity oracle: a ``(max_decode_batch, 1)`` decode call and
a ``(max_prefill_rows, prefill_chunk)`` prefill call over per-layer
`PagedKV` caches (the paged decode kernel), padded with inactive rows
(an all ``-1`` table and length ``-1``: they append nothing, read
nothing and come out NaN, and the engine never reads them).  Both modes
hand their logits rows to the same `_post_decode`/`_post_prefill`, so
their token streams agree by construction.

Memory is one page-id space across all layers (one
`PagePool`/`BlockAllocator`, one table row per request); the per-layer
pools live on the model's device and are updated in place.  A model
call's only device sync is `_fetch_logits`, which copies just the logits
rows that sampling needs.

The JAX engine's ``async_steps``, mesh sharding, journal, prefix store
and chaos hooks are not ported: asking for them raises
`NotImplementedError`.  Sampling with temperature > 0 draws from
a per-request `torch.Generator` seeded from ``SamplingParams.seed``, so
sampled streams are deterministic (but differ from the JAX engine's).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from attention_tpu_torch.engine.allocator import BlockAllocator
from attention_tpu_torch.engine.errors import (
    DeadlineExceededError,
    StepLimitExceededError,
)
from attention_tpu_torch.engine.metrics import (
    EngineMetrics,
    RequestMetrics,
    StepMetrics,
)
from attention_tpu_torch.engine.request import (
    Request,
    RequestState,
    SamplingParams,
)
from attention_tpu_torch.engine.scheduler import (
    PackedBatch,
    ScheduledStep,
    Scheduler,
)
from attention_tpu_torch.models.decode import warp_logits
from attention_tpu_torch.ops.paged import OutOfPagesError, PagedKV, PagePool
from attention_tpu_torch.ops.ragged_paged import (
    RaggedPagedStep,
    packed_bucket,
    recommended_q_tile,
)

#: consecutive non-finite-logits steps a request is held back before the
#: finite guard gives up and samples anyway (the JAX engine's limit)
_NONFINITE_SKIP_LIMIT = 8


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-engine knobs (the JAX engine's, same defaults)."""

    num_pages: int = 64
    page_size: int = 128
    max_seq_len: int = 1024        # per-request prompt + generated cap
    max_decode_batch: int = 8      # decode slots per step
    max_prefill_rows: int = 2      # prefill slots per step
    prefill_chunk: int = 64        # tokens per prefill slice
    token_budget: int = 128        # real tokens scheduled per step
    watermark_pages: int = 1       # admission must leave this reserve
    cache_dtype: Any = None        # None -> model dtype
    step_mode: str = "ragged"
    async_steps: bool = False
    mesh_shards: int = 0

    def validate(self) -> None:
        if self.step_mode not in ("ragged", "two_call"):
            raise ValueError(
                f"unknown step_mode {self.step_mode!r}; one of "
                "['ragged', 'two_call']")
        if self.async_steps:
            raise NotImplementedError("async_steps is not ported yet")
        if self.mesh_shards:
            raise NotImplementedError(
                "mesh_shards is not ported yet (single device only)")
        if min(self.num_pages, self.page_size, self.max_seq_len,
               self.max_decode_batch, self.max_prefill_rows,
               self.prefill_chunk, self.token_budget) < 1:
            raise ValueError("engine config fields must all be >= 1")
        if not (0 <= self.watermark_pages < self.num_pages):
            raise ValueError(
                f"watermark_pages {self.watermark_pages} outside "
                f"[0, num_pages={self.num_pages})")

    @property
    def table_width(self) -> int:
        """Page-table row width: covers max_seq_len plus one prefill
        chunk, so a final partial chunk's page claim always fits."""
        return -(-(self.max_seq_len + self.prefill_chunk)
                 // self.page_size)


class ServingEngine:
    """Deterministic continuous-batching engine over a `TinyDecoder`
    (its weights and device included); one model call per busy step
    (``ragged``), or one per non-empty half of it (``two_call``)."""

    def __init__(self, model, config: EngineConfig, *,
                 on_token: Callable[[Request, int], None] | None = None,
                 on_finish: Callable[[Request], None] | None = None,
                 on_timeout: Callable[[Request], None] | None = None,
                 **unported):
        if unported:
            raise NotImplementedError(
                f"ServingEngine options not ported yet: {sorted(unported)}")
        config.validate()
        if model.impl != "flash":
            raise ValueError(
                f"ServingEngine requires impl='flash' (got {model.impl!r})")
        self.model = model
        self.config = config
        self.device = model.device
        self.on_token = on_token
        self.on_finish = on_finish
        self.on_timeout = on_timeout

        dtype = config.cache_dtype or model.dtype
        pool_shape = (config.num_pages, model.num_kv_heads,
                      config.page_size, model.head_dim)
        self._k_pools = [torch.zeros(pool_shape, dtype=dtype,
                                     device=self.device)
                         for _ in range(model.depth)]
        self._v_pools = [torch.zeros(pool_shape, dtype=dtype,
                                     device=self.device)
                         for _ in range(model.depth)]
        self.pool = PagePool(config.num_pages)
        self.allocator = BlockAllocator(
            self.pool, config.page_size,
            watermark_pages=config.watermark_pages)
        self.scheduler = Scheduler(
            self.allocator,
            max_decode_batch=config.max_decode_batch,
            max_prefill_rows=config.max_prefill_rows,
            prefill_chunk=config.prefill_chunk,
            token_budget=config.token_budget)
        self.metrics = EngineMetrics()
        #: model calls dispatched by the step loop (one per busy step)
        self.model_calls = 0
        self._step = 0
        self._next_seq = 0
        self._finished_in_step = 0
        self._generators: dict[str, torch.Generator] = {}
        self._wall: dict[str, dict[str, float]] = {}
        #: logits rows the finite guard held back from sampling
        self.nonfinite_events = 0
        self._nonfinite_skips: dict[str, int] = {}
        self._last_fetch_s = 0.0

    # -- request intake ---------------------------------------------------

    @property
    def current_step(self) -> int:
        return self._step

    def add_request(self, prompt, sampling: SamplingParams | None = None,
                    *, request_id: str | None = None,
                    arrival: int | None = None,
                    deadline_step: int | None = None) -> Request:
        """Enqueue one request.  ``arrival`` (engine step) defaults to
        now; ``deadline_step`` (exclusive) arms the deadline sweep, and
        an already-expired one raises `DeadlineExceededError`."""
        sampling = sampling or SamplingParams()
        sampling.validate(self.model.vocab)
        prompt = tuple(int(t) for t in prompt)
        if any(not (0 <= t < self.model.vocab) for t in prompt):
            raise ValueError(
                f"prompt tokens must be in the vocab [0, "
                f"{self.model.vocab})")
        total = len(prompt) + sampling.max_tokens - 1
        if total > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens "
                f"({sampling.max_tokens}) - 1 = {total} exceeds "
                f"max_seq_len {self.config.max_seq_len}")
        if deadline_step is not None and deadline_step <= self._step:
            raise DeadlineExceededError(
                f"deadline step {deadline_step} is not after the current "
                f"step {self._step}: expired before admission")
        seq = self._next_seq
        self._next_seq += 1
        req = Request(
            request_id=request_id or f"req-{seq}",
            prompt=prompt,
            sampling=sampling,
            arrival=self._step if arrival is None else arrival,
            seq=seq,
            deadline_step=deadline_step,
        )
        self._wall[req.request_id] = {"added": time.perf_counter()}
        self.scheduler.add(req)
        return req

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or running request between steps: free its
        pages, drop its generator, move it to CANCELLED.  False when no
        live request has that id."""
        for queue in (self.scheduler.waiting, self.scheduler.running):
            for req in queue:
                if req.request_id != request_id:
                    continue
                queue.remove(req)
                if req.pages:
                    self.allocator.free(req.pages)
                req.pages = []
                req.transition(RequestState.CANCELLED)
                self._generators.pop(req.request_id, None)
                self._wall.pop(req.request_id, None)
                return True
        return False

    def _expire_deadlines(self) -> int:
        """Time out every queued or running request whose deadline step
        has arrived, before the step schedules."""
        expired = [
            r for r in (*self.scheduler.waiting, *self.scheduler.running)
            if r.deadline_step is not None and r.deadline_step <= self._step
        ]
        for req in expired:
            for queue in (self.scheduler.waiting, self.scheduler.running):
                if req in queue:
                    queue.remove(req)
            if req.pages:
                self.allocator.free(req.pages)
            req.pages = []
            req.transition(RequestState.TIMED_OUT)
            req.finish_step = self._step
            self._generators.pop(req.request_id, None)
            self._wall.pop(req.request_id, None)
            if self.on_timeout is not None:
                self.on_timeout(req)
        return len(expired)

    # -- step loop --------------------------------------------------------

    def step(self) -> StepMetrics:
        """One scheduler iteration: compose a batch, run it as one
        packed model call, stream out the sampled tokens."""
        t0 = time.perf_counter()
        self._finished_in_step = 0
        self._last_fetch_s = 0.0
        pad_tokens = 0
        occupancy = 0.0
        timed_out = self._expire_deadlines()
        sched = self.scheduler.schedule(self._step)
        total = sched.num_decode_tokens + sched.num_prefill_tokens
        if self.config.step_mode == "ragged":
            if not sched.is_empty:
                width = self._run_ragged(sched)
                pad_tokens = width - total
                occupancy = total / width
        else:
            if sched.decode:
                self._run_decode(sched.decode)
            if sched.prefill:
                self._run_prefill(sched.prefill)
            pad_tokens = self._baseline_pad(sched)
            if total:
                occupancy = total / (total + pad_tokens)
        wall_s = time.perf_counter() - t0
        m = StepMetrics(
            step=self._step,
            wall_s=wall_s,
            num_decode_reqs=len(sched.decode),
            num_prefill_reqs=len(sched.prefill),
            decode_tokens=sched.num_decode_tokens,
            prefill_tokens=sched.num_prefill_tokens,
            queue_depth=len(self.scheduler.waiting),
            running=len(self.scheduler.running),
            admitted=len(sched.admitted),
            preempted=len(sched.preempted),
            finished=self._finished_in_step,
            timed_out=timed_out,
            free_pages=self.pool.free_pages,
            used_pages=self.pool.used_pages,
            page_utilization=self.pool.used_pages / self.pool.num_pages,
            prefix_hit_tokens_total=self.allocator.prefix_hit_tokens,
            preemptions_total=self.scheduler.num_preemptions,
            pad_tokens=pad_tokens,
            ragged_occupancy=occupancy,
            host_overhead_s=max(0.0, wall_s - self._last_fetch_s),
        )
        self.metrics.record_step(m)
        self._step += 1
        return m

    def run(self, *, max_steps: int | None = None) -> dict[str, Any]:
        """Step until every request finishes; returns the metrics
        summary.  A permanently unschedulable queue raises
        `OutOfPagesError` instead of spinning."""
        stalls = 0
        while self.scheduler.has_work():
            if max_steps is not None and self._step >= max_steps:
                raise StepLimitExceededError(
                    f"engine exceeded max_steps={max_steps} with "
                    f"{len(self.scheduler.waiting)} waiting / "
                    f"{len(self.scheduler.running)} running")
            m = self.step()
            due = (self.scheduler.waiting
                   and self.scheduler.waiting[0].arrival < self._step)
            idle = (m.decode_tokens == 0 and m.prefill_tokens == 0
                    and not self.scheduler.running)
            stalls = stalls + 1 if (idle and due) else 0
            if stalls > 2:
                head = self.scheduler.waiting[0]
                raise OutOfPagesError(
                    f"request {head.request_id} cannot be admitted "
                    "(needs more pages than the pool can ever free)")
        return self.metrics.summary()

    # -- batch lowering ---------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _fetch_logits(self, rows: torch.Tensor) -> np.ndarray:
        """The step's only device sync: copy the needed logits rows to
        the host."""
        t0 = time.perf_counter()
        out = rows.float().cpu().numpy()
        self._last_fetch_s += time.perf_counter() - t0
        return out

    def pack_step(self, sched: ScheduledStep
                  ) -> tuple[torch.Tensor, tuple[RaggedPagedStep, ...],
                             PackedBatch]:
        """Lower a scheduled step onto the packed token axis: the
        (1, width) token tensor and one `RaggedPagedStep` per layer
        (over that layer's pools), on the model's device, plus the
        host-side `PackedBatch`.  The query tile covers the longest
        prefill chunk and the width every real token, both bucketed as
        in the JAX engine, so the pad accounting agrees.  Consumes the
        decode requests' pending tokens: call once per step."""
        cfg = self.config
        model = self.model
        slots = cfg.max_decode_batch + cfg.max_prefill_rows
        group = model.num_q_heads // model.num_kv_heads
        max_q = max((n for _, n in sched.prefill), default=1)
        q_tile = recommended_q_tile(max_q, group)
        total = sched.num_decode_tokens + sched.num_prefill_tokens
        width = packed_bucket(max(total, q_tile))
        batch = sched.pack(width=width, slots=slots,
                           table_width=cfg.table_width)
        tables, kv_lens, cu, dist, pos, slot = (
            self._dev(a) for a in (batch.tables, batch.kv_lens,
                                   batch.cu_q_lens, batch.distribution,
                                   batch.token_pos, batch.token_slot))
        caches = tuple(
            RaggedPagedStep(self._k_pools[layer], self._v_pools[layer],
                            tables, kv_lens, cu, dist, pos, slot, q_tile)
            for layer in range(model.depth))
        return self._dev(batch.tokens).long(), caches, batch

    def _run_ragged(self, sched: ScheduledStep) -> int:
        """Run the whole step as one packed model call; returns the
        packed width."""
        tokens, caches, batch = self.pack_step(sched)
        cu_h = batch.cu_q_lens
        num_decode = len(sched.decode)
        rows = [int(cu_h[i]) for i in range(num_decode)]
        rows += [int(cu_h[num_decode + s]) + real - 1
                 for s, (_, real) in enumerate(sched.prefill)]
        with torch.no_grad():
            logits, _ = self.model(tokens, caches)
            picked = logits[0, torch.tensor(rows, device=self.device)]
        self.model_calls += 1
        picked = self._fetch_logits(picked)
        for i, req in enumerate(sched.decode):
            self._post_decode(req, picked[i])
        for s, (req, real) in enumerate(sched.prefill):
            self._post_prefill(req, real, picked[num_decode + s])
        return batch.width

    def _baseline_pad(self, sched: ScheduledStep) -> int:
        """Pad tokens the two-call lowering dispatches for this step."""
        pad = 0
        if sched.decode:
            pad += self.config.max_decode_batch - len(sched.decode)
        if sched.prefill:
            pad += (self.config.max_prefill_rows * self.config.prefill_chunk
                    - sched.num_prefill_tokens)
        return pad

    def _apply(self, tokens: np.ndarray, tables: np.ndarray,
               lens: np.ndarray, rows: list[int]) -> np.ndarray:
        """One two-call model call over per-layer `PagedKV` caches;
        returns, for each request ``i``, the logits at its token
        ``rows[i]``."""
        tables, lens = self._dev(tables), self._dev(lens)
        caches = tuple(
            PagedKV(self._k_pools[layer], self._v_pools[layer], tables, lens)
            for layer in range(self.model.depth))
        with torch.no_grad():
            logits, _ = self.model(self._dev(tokens).long(), caches)
            picked = logits[torch.arange(len(rows), device=self.device),
                            torch.tensor(rows, device=self.device)]
        self.model_calls += 1
        return self._fetch_logits(picked)

    def _run_decode(self, reqs: list[Request]) -> None:
        d = self.config.max_decode_batch
        tokens = np.zeros((d, 1), np.int32)
        tables = np.full((d, self.config.table_width), -1, np.int32)
        lens = np.full((d,), -1, np.int32)  # -1 = inactive pad row
        for i, req in enumerate(reqs):
            lens[i] = req.computed_tokens
            tokens[i, 0] = req.feed_pending()
            tables[i, :len(req.pages)] = req.pages
        logits = self._apply(tokens, tables, lens, [0] * len(reqs))
        for i, req in enumerate(reqs):
            self._post_decode(req, logits[i])

    def _run_prefill(self, items: list[tuple[Request, int]]) -> None:
        # the pad tokens past `real` are appended too; the scheduler
        # claimed pages up to the chunk's padded end for them
        p, s = self.config.max_prefill_rows, self.config.prefill_chunk
        tokens = np.zeros((p, s), np.int32)
        tables = np.full((p, self.config.table_width), -1, np.int32)
        lens = np.full((p,), -1, np.int32)
        for i, (req, real) in enumerate(items):
            c = req.computed_tokens
            tokens[i, :real] = req.tokens[c:c + real]
            tables[i, :len(req.pages)] = req.pages
            lens[i] = c
        logits = self._apply(tokens, tables, lens,
                             [real - 1 for _, real in items])
        for i, (req, real) in enumerate(items):
            self._post_prefill(req, real, logits[i])

    def _post_decode(self, req: Request, logits_row: np.ndarray) -> None:
        """Consume one decode request's logits row (both step modes)."""
        if not np.isfinite(logits_row).all():
            # non-finite logits never reach sampling: un-feed the pending
            # token so the request retries (bounded, then falls through)
            self.nonfinite_events += 1
            skips = self._nonfinite_skips.get(req.request_id, 0) + 1
            self._nonfinite_skips[req.request_id] = skips
            if skips <= _NONFINITE_SKIP_LIMIT:
                req.pending_token = req.tokens.pop()
                return
        else:
            self._nonfinite_skips.pop(req.request_id, None)
        req.computed_tokens = len(req.tokens)
        self._emit(req, self._sample(req, logits_row))

    def _post_prefill(self, req: Request, real: int,
                      last_row: np.ndarray) -> None:
        """Consume one prefill chunk's last logits row (both step
        modes)."""
        if (req.computed_tokens + real >= len(req.tokens)
                and not req.output_tokens
                and not np.isfinite(last_row).all()):
            self.nonfinite_events += 1
            skips = self._nonfinite_skips.get(req.request_id, 0) + 1
            self._nonfinite_skips[req.request_id] = skips
            if skips <= _NONFINITE_SKIP_LIMIT:
                return
        req.computed_tokens += real
        if req.computed_tokens < len(req.tokens):
            return  # more chunks to go
        full = req.num_prompt_tokens // self.config.page_size
        if full:
            self.allocator.commit_prefix(req.prompt, req.pages[:full],
                                         now=self._step)
        req.transition(RequestState.DECODING)
        if req.output_tokens:
            # resumed after preemption: the pending token was already
            # sampled and streamed — never resample it
            return
        self._emit(req, self._sample(req, last_row))

    # -- token emission ---------------------------------------------------

    def _sample(self, req: Request, logits_row: np.ndarray) -> int:
        if req.sampling.temperature == 0.0:
            return int(np.argmax(logits_row))
        gen = self._generators.get(req.request_id)
        if gen is None:
            gen = torch.Generator().manual_seed(req.sampling.seed)
            self._generators[req.request_id] = gen
        warped = warp_logits(
            torch.from_numpy(logits_row)[None],
            temperature=req.sampling.temperature,
            top_k=req.sampling.top_k, top_p=req.sampling.top_p)
        probs = torch.softmax(warped, dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen)[0, 0])

    def _emit(self, req: Request, token: int) -> None:
        done = req.emit(token)
        if req.first_token_step < 0:
            req.first_token_step = self._step
            self._wall[req.request_id]["first_token"] = time.perf_counter()
        if self.on_token is not None:
            self.on_token(req, token)
        if done:
            self._finish(req)

    def _finish(self, req: Request) -> None:
        req.transition(RequestState.FINISHED)
        req.finish_step = self._step
        self._nonfinite_skips.pop(req.request_id, None)
        if req.pages:
            self.allocator.free(req.pages)
        req.pages = []
        self.scheduler.remove_finished(req)
        self._generators.pop(req.request_id, None)
        self._finished_in_step += 1
        wall = self._wall.pop(req.request_id, {})
        now = time.perf_counter()
        added = wall.get("added", now)
        self.metrics.record_request(RequestMetrics(
            request_id=req.request_id,
            arrival_step=req.arrival,
            first_scheduled_step=req.first_scheduled_step,
            first_token_step=req.first_token_step,
            finish_step=req.finish_step,
            prompt_tokens=req.num_prompt_tokens,
            output_tokens=req.num_output_tokens,
            prefix_cached_tokens=req.prefix_cached_tokens,
            preemptions=req.preemptions,
            ttft_s=wall.get("first_token", now) - added,
            finish_s=now - added,
        ))
        if self.on_finish is not None:
            self.on_finish(req)
