"""Iteration-level (continuous-batching) scheduler — the port of
`attention_tpu.engine.scheduler` (same policy, no telemetry).

Each engine step the scheduler composes ONE batch out of whatever work
exists right now — decode tokens for running requests interleaved with
chunked-prefill slices of admitted requests (Orca-style iteration-level
scheduling: requests join and leave the batch between *tokens*, never
waiting for a whole batch to drain).  Policy, deterministically:

  * FCFS by ``(arrival, seq)`` everywhere: decode order, prefill
    continuation, admission, and the requeue point after preemption.
  * Token budget: a step schedules at most ``token_budget`` real
    tokens (decode = 1 each, prefill = chunk length), so one giant
    prompt cannot starve decode latency.
  * Decode first, then prefill: decode rows are cheap and latency-
    critical; leftover budget admits/advances prefills.
  * Page pressure: decode appends that cannot get a page trigger
    preemption-by-recompute of the YOUNGEST running request (its pages
    are freed, its computed-token count resets, it re-queues at its
    original FCFS position and re-prefills on readmission — generated
    tokens are kept and never resampled).  Admissions that would
    breach the allocator watermark simply wait.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from attention_tpu_torch.engine.allocator import (
    BlockAllocator,
    pages_for_tokens,
)
from attention_tpu_torch.engine.request import Request, RequestState
from attention_tpu_torch.ops.paged import OutOfPagesError


@dataclasses.dataclass
class PackedBatch:
    """One step's work flattened onto a single padded token axis — the
    host-side image of `ops.ragged_paged.RaggedPagedStep`.

    ``tokens`` (1, width) int32 feeds the model in one launch;
    ``token_slot``/``token_pos`` (width,) map each packed token to its
    owning request slot (-1 = pad) and absolute cache position;
    ``kv_lens`` (slots,) / ``cu_q_lens`` (slots+1,) / ``tables``
    (slots, table_width) / ``distribution`` (2,) are the kernel's
    scalar-prefetch operands.  Decode slots come first (the
    ``distribution`` contract); ``num_real`` real tokens occupy the
    packed prefix, the remaining ``width - num_real`` are pad."""

    tokens: np.ndarray
    token_slot: np.ndarray
    token_pos: np.ndarray
    kv_lens: np.ndarray
    cu_q_lens: np.ndarray
    tables: np.ndarray
    distribution: np.ndarray
    width: int
    num_real: int


@dataclasses.dataclass
class ScheduledStep:
    """One step's batch composition (what the engine will lower onto
    kernel calls) plus the events the metrics layer records."""

    step: int
    decode: list[Request] = dataclasses.field(default_factory=list)
    # (request, real tokens of this chunk) — the two-call engine pads
    # every chunk to the configured prefill_chunk for shape stability;
    # the ragged engine packs the real tokens via `pack`
    prefill: list[tuple[Request, int]] = dataclasses.field(
        default_factory=list
    )
    preempted: list[Request] = dataclasses.field(default_factory=list)
    admitted: list[Request] = dataclasses.field(default_factory=list)

    @property
    def num_decode_tokens(self) -> int:
        return len(self.decode)

    @property
    def num_prefill_tokens(self) -> int:
        return sum(n for _, n in self.prefill)

    @property
    def is_empty(self) -> bool:
        return not self.decode and not self.prefill

    def pack(self, *, width: int, slots: int, table_width: int,
             staged_rows: dict | None = None) -> PackedBatch:
        """Flatten this step onto one padded token axis, decode slots
        first then prefill chunks, each request's tokens contiguous.

        CONSUMES pending decode tokens (`Request.feed_pending`) — call
        at most once per step, from the engine's dispatch path.

        ``staged_rows`` (optional ``{request_id: (num_pages, row)}``)
        reuses page-table rows staged by the async loop while the
        previous step ran on device; a row is taken only when the
        request's page count is unchanged, so the packed operands are
        bit-identical to a cold rebuild."""
        items = [(r, 1) for r in self.decode] + list(self.prefill)
        total = self.num_decode_tokens + self.num_prefill_tokens
        if len(items) > slots:
            raise ValueError(
                f"step has {len(items)} requests but only {slots} slots"
            )
        if total > width:
            raise ValueError(
                f"step has {total} tokens but packed width is {width}"
            )
        tokens = np.zeros((1, width), np.int32)
        token_slot = np.full((width,), -1, np.int32)
        token_pos = np.zeros((width,), np.int32)
        kv_lens = np.zeros((slots,), np.int32)
        cu = np.zeros((slots + 1,), np.int32)
        tables = np.full((slots, table_width), -1, np.int32)
        num_decode = len(self.decode)
        off = 0
        for s, (req, n) in enumerate(items):
            c = req.computed_tokens
            if s < num_decode:
                tokens[0, off] = req.feed_pending()
            else:
                tokens[0, off:off + n] = req.tokens[c:c + n]
            token_slot[off:off + n] = s
            token_pos[off:off + n] = np.arange(c, c + n)
            kv_lens[s] = c
            staged = (staged_rows or {}).get(req.request_id)
            if staged is not None and staged[0] == len(req.pages):
                tables[s] = staged[1]
            else:
                tables[s, :len(req.pages)] = req.pages
            off += n
            cu[s + 1] = off
        cu[len(items) + 1:] = off
        return PackedBatch(
            tokens=tokens, token_slot=token_slot, token_pos=token_pos,
            kv_lens=kv_lens, cu_q_lens=cu, tables=tables,
            distribution=np.asarray([num_decode, len(items)], np.int32),
            width=width, num_real=total,
        )


class Scheduler:
    def __init__(self, allocator: BlockAllocator, *,
                 max_decode_batch: int, max_prefill_rows: int,
                 prefill_chunk: int, token_budget: int):
        if min(max_decode_batch, max_prefill_rows, prefill_chunk,
               token_budget) < 1:
            raise ValueError("scheduler limits must all be >= 1")
        self.allocator = allocator
        self.max_decode_batch = max_decode_batch
        self.max_prefill_rows = max_prefill_rows
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget
        self.waiting: list[Request] = []   # kept FCFS-sorted
        self.running: list[Request] = []   # admission order (== FCFS)
        self.num_preemptions = 0
        # degradation-ladder hook: False turns admission-path prefix-
        # cache lookups off (committed pages stay resident for later
        # recovery, but new admissions recompute instead of increffing
        # shared pages — cheaper page churn under sustained pressure)
        self.prefix_admission = True

    # -- queue plumbing ---------------------------------------------------

    def _fcfs(self, req: Request):
        return (req.arrival, req.seq)

    def add(self, req: Request) -> None:
        self.waiting.append(req)
        self.waiting.sort(key=self._fcfs)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def remove_finished(self, req: Request) -> None:
        self.running.remove(req)

    def _preempt(self, victim: Request, sched: ScheduledStep) -> None:
        """Preemption-by-recompute: release every page, forget computed
        KV, requeue at the victim's original FCFS position.  Emitted
        tokens and the pending token survive — readmission re-prefills
        ``victim.tokens`` and resumes decoding without resampling."""
        self.running.remove(victim)
        if victim in sched.decode:
            sched.decode.remove(victim)
        sched.prefill = [(r, n) for r, n in sched.prefill if r is not victim]
        if victim.pages:
            self.allocator.free(victim.pages)
        victim.pages = []
        victim.computed_tokens = 0
        victim.prefix_cached_tokens = 0
        victim.preemptions += 1
        victim.transition(RequestState.PREEMPTED)
        self.num_preemptions += 1
        sched.preempted.append(victim)
        self.waiting.append(victim)
        self.waiting.sort(key=self._fcfs)

    def _preempt_for(self, req: Request, sched: ScheduledStep) -> bool:
        """Free pages for ``req``'s decode append by preempting the
        youngest running request.  Returns True if ``req`` itself was
        the victim (caller skips it this step)."""
        victim = max(self.running, key=self._fcfs)
        if victim is req and len(self.running) == 1:
            # preempting the sole running request to serve itself can
            # never converge — the pool is simply too small for it
            raise OutOfPagesError(
                f"request {req.request_id} needs a page but is the only "
                "running request and nothing is evictable: the pool "
                "cannot hold it"
            )
        self._preempt(victim, sched)
        return victim is req

    # -- step composition -------------------------------------------------

    def _ensure_pages(self, req: Request, cover_tokens: int, *,
                      for_decode: bool) -> None:
        need = pages_for_tokens(cover_tokens, self.allocator.page_size) \
            - len(req.pages)
        if need > 0:
            req.pages.extend(
                self.allocator.allocate(need, for_decode=for_decode)
            )

    def schedule(self, step: int) -> ScheduledStep:
        sched = ScheduledStep(step=step)
        budget = self.token_budget

        # 1) decode: every DECODING request in FCFS order, up to the
        # batch width; each needs page coverage for one appended row
        for req in sorted(
            [r for r in self.running
             if r.state is RequestState.DECODING], key=self._fcfs
        ):
            if len(sched.decode) >= self.max_decode_batch or budget < 1:
                break
            if req.state is not RequestState.DECODING:
                continue  # preempted by an earlier candidate this step
            while True:
                try:
                    self._ensure_pages(req, len(req.tokens) + 1,
                                       for_decode=True)
                    break
                except OutOfPagesError:
                    if self._preempt_for(req, sched):
                        break  # req preempted itself; skip this step
            if req.state is not RequestState.DECODING:
                continue
            sched.decode.append(req)
            budget -= 1

        # 2) prefill continuation: requests already mid-prompt advance
        # before anyone new is admitted (FCFS).  A running request's
        # chunk may drain the watermark reserve and, failing that,
        # preempt the youngest runner — it already holds pages and
        # queue position; stalling it wastes both.
        for req in sorted(
            [r for r in self.running
             if r.state is RequestState.PREFILLING], key=self._fcfs
        ):
            if len(sched.prefill) >= self.max_prefill_rows or budget < 1:
                break
            if req.state is not RequestState.PREFILLING:
                continue  # preempted by an earlier candidate this step
            padded_end = req.computed_tokens + self.prefill_chunk
            while True:
                try:
                    self._ensure_pages(req, padded_end, for_decode=True)
                    break
                except OutOfPagesError:
                    if self._preempt_for(req, sched):
                        break
            if req.state is not RequestState.PREFILLING:
                continue
            self._schedule_chunk(req, sched, budget)
            if sched.prefill and sched.prefill[-1][0] is req:
                budget -= sched.prefill[-1][1]

        # 3) admission: FCFS over due arrivals, watermark-guarded
        while (self.waiting
               and self.waiting[0].arrival <= step
               and len(sched.prefill) < self.max_prefill_rows
               and budget >= 1):
            req = self.waiting[0]
            if req.pages:  # defensive: queued requests hold nothing
                self.allocator.free(req.pages)
                req.pages = []
            pages = (self.allocator.lookup_prefix(req.tokens,
                                                  now=step)
                     if self.prefix_admission else [])
            try:
                req.pages = pages
                req.computed_tokens = (
                    len(pages) * self.allocator.page_size)
                req.prefix_cached_tokens = req.computed_tokens
                before = len(sched.prefill)
                self._schedule_chunk(req, sched, budget)
                if len(sched.prefill) == before:
                    raise OutOfPagesError(
                        "admission chunk not scheduled")
            except OutOfPagesError:
                # watermark refusal: return the prefix references
                # and wait — running requests drain the queue
                # eventually
                if pages:
                    self.allocator.free(pages)
                    self.allocator.prefix_hits -= 1
                    self.allocator.prefix_hit_tokens -= (
                        len(pages) * self.allocator.page_size
                    )
                req.pages = []
                req.computed_tokens = 0
                req.prefix_cached_tokens = 0
                break
            self.waiting.pop(0)
            self.running.append(req)
            req.transition(RequestState.PREFILLING)
            if req.first_scheduled_step < 0:
                req.first_scheduled_step = step
            sched.admitted.append(req)
            budget -= sched.prefill[-1][1]

        return sched

    def _schedule_chunk(self, req: Request, sched: ScheduledStep,
                        budget: int) -> None:
        """Add one prefill chunk for ``req`` if pages allow.  The chunk
        is padded to ``prefill_chunk`` rows in the kernel call, so page
        coverage must span the padded end (a pad row crossing into an
        unclaimed page would NaN-poison the whole row, real tokens
        included)."""
        remaining = len(req.tokens) - req.computed_tokens
        real = min(self.prefill_chunk, remaining, budget)
        if real < 1:
            return
        padded_end = req.computed_tokens + self.prefill_chunk
        self._ensure_pages(req, padded_end, for_decode=False)
        sched.prefill.append((req, real))
