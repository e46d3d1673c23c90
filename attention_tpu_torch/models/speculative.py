"""Speculative decoding: the port of `attention_tpu.models.speculative`.

A small draft model proposes ``gamma`` tokens one step at a time; the
target model scores all of them in one (gamma + 1)-row chunk; the
longest prefix that agrees with the target is accepted, plus one token
of the target's own (Leviathan et al. 2023; Chen et al. 2023).  Greedy
speculative decoding emits exactly the target's greedy tokens.

Each iteration runs gamma + 1 draft steps on the draft's dense cache
(the last one only fills its cache row, so the draft keeps step with a
fully accepted window) and one target chunk, whose rows the chunk modes
of the decode, int8 and paged kernels score over the target's cache
(``cache_type``).  Rollback is a length rewind: rejected rows stay in
the caches and the next chunk writes over them, and every kernel masks
by length.  Where the JAX package runs the loop as one
``lax.while_loop`` on the device, the port's loop is Python: it reads
the acceptance count and the emitted tokens back once an iteration (one
host sync), which ``return_stats`` counts.

Target and draft may both be tensor-parallel models (``tp_axis``) on
one mesh: every rank runs the loop alike on its own kv heads.

Sampling draws from the caller's `torch.Generator`, so sampled streams
are not the JAX package's (greedy streams are equal).  Batch 1 only: a
per-sequence acceptance count would rag the dense caches' one length.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from attention_tpu_torch.models.attention_layer import RaggedKVCache
from attention_tpu_torch.models.decode import (
    _prompt,
    _select_token,
    _validate_sampling,
    warp_logits,
)
from attention_tpu_torch.ops.paged import PagedKV, PagePool, paged_from_dense

CACHE_TYPES = ("dense", "ragged", "int8", "paged")


class SpeculativeStats(NamedTuple):
    """What one `generate_speculative` call did: draft/verify iterations
    and the draft tokens the target accepted in all.  Each iteration is
    one target chunk and the loop's one host sync; a call that runs no
    iteration reads the prefill's token in one sync of its own."""

    iterations: int
    accepted: int


def _set_len(caches, length: int) -> tuple:
    """Every cache with its length set to ``length``, the rollback: a
    Python int for the dense and int8 caches, a new (B,) tensor for the
    ragged and paged ones."""
    out = []
    for c in caches:
        if isinstance(c, (RaggedKVCache, PagedKV)):
            out.append(c._replace(lengths=torch.full_like(c.lengths,
                                                          length)))
        else:
            out.append(c._replace(length=length))
    return tuple(out)


def _validate(target, draft, prompt, gamma, cache_type) -> None:
    """`generate_speculative`'s refusals, the JAX package's."""
    if prompt.shape[0] != 1:
        raise ValueError(
            f"speculative decoding is per-sequence (batch 1), got batch "
            f"{prompt.shape[0]}")
    if target.vocab != draft.vocab:
        raise ValueError(
            f"vocab mismatch: target {target.vocab} != draft {draft.vocab}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if cache_type not in CACHE_TYPES:
        raise ValueError(f"cache_type {cache_type!r} not in {CACHE_TYPES}")
    if cache_type != "dense" and target.impl != "flash":
        raise ValueError(
            f"cache_type {cache_type!r} requires the target's "
            f"impl='flash' (got {target.impl!r})")


def _target_caches(target, caches, cache_type: str, s: int,
                   capacity: int, page_size: int) -> tuple:
    """The target's dense prefill caches in the representation under
    test.  Paged caches claim their full capacity up front, one pool a
    layer, so that a rollback never has pages to give back."""
    if cache_type == "ragged":
        lens = torch.full((1,), s, dtype=torch.int32, device=target.device)
        return tuple(RaggedKVCache.from_prefill(c, lens) for c in caches)
    if cache_type == "int8":
        return tuple(c.quantize() for c in caches)
    if cache_type == "paged":
        if capacity % page_size:
            raise ValueError(f"capacity {capacity} not a multiple of "
                             f"page_size {page_size}")
        num_pages = capacity // page_size
        return tuple(
            paged_from_dense(c.k, c.v, [s], PagePool(num_pages),
                             num_pages=num_pages, page_size=page_size,
                             total_pages_per_seq=num_pages)
            for c in caches)
    return caches


@torch.no_grad()
def generate_speculative(target, draft, prompt, *, steps: int,
                         gamma: int = 4, capacity: int | None = None,
                         cache_type: str = "dense", page_size: int = 128,
                         temperature: float = 0.0,
                         top_k: int | None = None,
                         top_p: float | None = None,
                         generator: torch.Generator | None = None,
                         return_stats: bool = False):
    """Speculative generation: (1, S) prompt -> (1, steps) tokens.

    ``temperature == 0`` (default) is greedy and equals greedy
    ``generate(target, ...)`` on every ``cache_type`` (``"int8"``:
    `generate` with ``int8_cache=True``).  ``temperature > 0`` samples
    from ``generator`` by the rejection scheme over the warped
    distributions: draft token x with draft probability p_d(x) is
    accepted when u·p_d(x) < p_t(x) for a uniform u; the first rejection
    draws from max(p_t - p_d, 0), and a fully accepted window draws one
    more token from p_t.  The emitted tokens are distributed as
    target-only sampling with the same temperature, top-k and top-p, for
    any draft.  The draft drafts on a dense cache; the target verifies
    on ``cache_type``.  ``capacity`` is a 128-multiple of at least S +
    steps + gamma + 1 (the default the least).  ``return_stats`` also
    returns the loop's `SpeculativeStats`."""
    prompt = _prompt(target, prompt)
    _validate(target, draft, prompt, gamma, cache_type)
    generator = _validate_sampling(target, temperature, top_k, top_p,
                                   generator)
    if target.rope and target.attn_sinks and target.window is not None:
        # a chunk keeps the sinks' absolute rotations, a one-token step
        # re-rotates them, so the verify logits would part from step
        # decoding and greedy exactness would break
        raise ValueError(
            "speculative decoding does not compose with rope + window + "
            "attn_sinks targets: chunked verify keeps absolute sink "
            "rotations, single-token decode re-rotates them, so emitted "
            "tokens would diverge from target-greedy")
    s = prompt.shape[1]
    need = s + steps + gamma + 1
    if capacity is None:
        capacity = -(-need // 128) * 128
    if capacity < need or capacity % 128:
        raise ValueError(
            f"capacity {capacity} must be a 128-multiple >= {need}")
    t_logits, t_caches = target(prompt, target.init_caches(1, capacity))
    _, d_caches = draft(prompt, draft.init_caches(1, capacity))
    t_caches = _target_caches(target, t_caches, cache_type, s, capacity,
                              page_size)
    knobs = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    t_next = _select_token(t_logits[:, -1], generator, **knobs)
    tokens, stats = _speculative_loop(
        target, draft, t_next, t_caches, d_caches, ctx=s, steps=steps,
        gamma=gamma, generator=generator, **knobs)
    tokens = torch.tensor(tokens[:steps], dtype=torch.long,
                          device=target.device)[None]
    return (tokens, stats) if return_stats else tokens


def _speculative_loop(target, draft, t_next, t_caches, d_caches, *,
                      ctx: int, steps: int, gamma: int, generator,
                      temperature, top_k, top_p):
    """Draft, verify, accept, until ``steps`` tokens are out.  ``t_next``
    (1,) is the token the prefill chose; both caches hold the ``ctx``
    prompt rows.  Returns (the emitted tokens, at least ``steps``, as a
    list, `SpeculativeStats`)."""
    sampling = generator is not None
    dev = target.device
    idx = torch.arange(gamma + 1, device=dev)

    def warp(logits):
        return warp_logits(logits, temperature=temperature, top_k=top_k,
                           top_p=top_p)

    first, out = t_next, []         # the prefill's token, then the rest
    iterations = accepted_total = 0
    while 1 + len(out) < steps:
        # gamma + 1 draft steps (the last only fills the draft's cache row)
        d_caches = _set_len(d_caches, ctx)
        tok, drafts, pds = t_next, [], []
        for _ in range(gamma + 1):
            logits, d_caches = draft(tok[:, None], d_caches)
            if sampling:
                probs = torch.softmax(warp(logits[:, -1]), dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
                pds.append(probs[0])
            else:
                tok = logits[:, -1].argmax(dim=-1)
            drafts.append(tok)
        drafts = torch.cat(drafts)                  # (gamma + 1,)

        # one target chunk over [t_next, d_1 .. d_gamma]
        t_caches = _set_len(t_caches, ctx)
        chunk = torch.cat([t_next, drafts[:gamma]])[None]
        logits, t_caches = target(chunk, t_caches)
        if sampling:
            pt = torch.softmax(warp(logits[0]), dim=-1)   # (gamma + 1, V)
            pd = torch.stack(pds)
            at = drafts[:gamma, None]
            p_d = pd[:gamma].gather(1, at)[:, 0]
            p_t = pt[:gamma].gather(1, at)[:, 0]
            u = torch.rand(gamma, generator=generator, device=dev)
            agree = u * p_d < p_t        # u < min(1, p_t / p_d), no divide
        else:
            preds = logits[0].argmax(dim=-1)
            agree = preds[:gamma] == drafts[:gamma]
        # the first disagreement is the number of agreements
        accepted = torch.cat([agree, agree.new_zeros(1)]).int().argmin()
        if sampling:
            pt_row = pt[accepted]
            row = torch.where(accepted < gamma,
                              (pt_row - pd[accepted]).clamp(min=0.0),
                              pt_row)
            # a residual of 0 (p_t == p_d): rejection was impossible
            # there, and any draw from p_t is right
            row = torch.where(row.sum() > 0.0, row, pt_row)
            corr = torch.multinomial(row, 1, generator=generator)
        else:
            corr = preds[accepted][None]
        emit = torch.where(idx < accepted, drafts, corr)
        # the loop's one host sync: the count and the emitted tokens
        # (and the prefill's token, one more element)
        got = torch.cat([accepted[None], emit, first]).tolist()
        a = got[0]
        out.extend(got[1:a + 2])
        ctx += a + 1
        iterations += 1
        accepted_total += a
        t_next = corr
    head = got[-1] if iterations else int(first)
    return [head] + out, SpeculativeStats(iterations, accepted_total)
