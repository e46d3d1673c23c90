"""Autoregressive generation: the port of `attention_tpu.models.decode`.

Prefill runs the prompt once through the model over fresh caches (the
flash kernel with ``q_offset``/``kv_valid``), then a Python token loop
makes one decode step per token (the decode kernel on dense caches, the
paged decode kernel on paged ones, the int8 decode kernel on the caches
``int8_cache=True`` quantizes once after the prefill), where the JAX
package ran a ``lax.scan`` under one jit.  Each loop runs ``steps``
decode steps, as the scan does, so the returned caches hold prompt +
``steps`` rows.

Sampling (temperature > 0) draws from the caller's `torch.Generator`, on
the model's device, where the JAX package split a key: seeded streams
are deterministic, but not the JAX package's.  A windowed model may
generate on ring-buffer caches (``rolling_cache=True``), whose memory is
bounded by its window.  `generate_beam` runs beam search over the dense
or int8 caches, gathering their rows after every step to follow the
surviving hypotheses.

On a tensor-parallel model (``tp_axis``) every function runs as it is on
every rank of the mesh: the caches hold the rank's block of kv heads
(`TinyDecoder.init_caches`), `generate_paged`'s `PagePool`s are host
state that every rank keeps alike, so page ids agree, beam search
gathers each rank's caches by the same rows, and every rank samples
from the same gathered logits: every rank returns the same tokens.
"""

from __future__ import annotations

import torch

from attention_tpu_torch.models.attention_layer import (
    KVCache,
    QuantKVCache,
    RaggedKVCache,
)
from attention_tpu_torch.ops.paged import PagePool, paged_from_dense


def prefill(model, tokens: torch.Tensor, capacity: int,
            cache_dtype: torch.dtype | None = None):
    """Run the (B, S) prompt through the model once, filling fresh dense
    caches of ``capacity`` rows.  Returns ``(last_logits (B, vocab),
    caches)``."""
    caches = model.init_caches(tokens.shape[0], capacity, cache_dtype)
    logits, caches = model(tokens, caches)
    return logits[:, -1], caches


def decode_step(model, token: torch.Tensor, caches):
    """One decode step: token (B,) -> (logits (B, vocab), caches)."""
    logits, caches = model(token[:, None], caches)
    return logits[:, -1], caches


def warp_logits(logits: torch.Tensor, *, temperature: float,
                top_k: int | None, top_p: float | None) -> torch.Tensor:
    """Apply the sampling warp to (B, V) logits: temperature scaling,
    then top-k and nucleus top-p support truncation (removed entries
    become -inf).  Float32 throughout."""
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with mass >= top_p (always >= 1 token)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _select_token(logits: torch.Tensor, generator, *, temperature, top_k,
                  top_p) -> torch.Tensor:
    """(B, V) logits -> (B,) next tokens: greedy argmax when
    ``generator`` is None, else a draw from the warped distribution."""
    if generator is None:
        return logits.argmax(dim=-1)
    probs = torch.softmax(warp_logits(logits, temperature=temperature,
                                      top_k=top_k, top_p=top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _validate_sampling(model, temperature, top_k, top_p, generator):
    """The sampling knobs' contract, shared by the generate functions.
    Returns the generator, or None for greedy decoding."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and not (1 <= top_k <= model.vocab):
        raise ValueError(
            f"top_k must be in [1, vocab={model.vocab}], got {top_k}")
    if temperature == 0.0:
        if top_k is not None or top_p is not None:
            # would otherwise be silently ignored — fail loudly instead
            raise ValueError(
                "top_k/top_p require temperature > 0 (temperature == 0 "
                "is greedy argmax)")
        return None
    return generator


def _require_flash_for_int8(model) -> None:
    """The int8 decode path runs the kernels only: the precondition of
    `generate` and `generate_beam`."""
    if model.impl != "flash":
        raise ValueError(
            f"int8_cache requires impl='flash' (model has {model.impl!r})")


def _resolve_capacity(s: int, steps: int, capacity: int | None) -> int:
    """The dense-cache capacity contract: default to the smallest
    128-multiple holding prompt + steps; reject a caller value that is
    short (the cache would overflow and NaN-poison) or off the 128-row
    granule."""
    if capacity is None:
        return -(-(s + steps) // 128) * 128
    if capacity < s + steps or capacity % 128:
        raise ValueError(
            f"capacity {capacity} must be a 128-multiple >= {s + steps}")
    return capacity


def _validate_lengths(prompt_lengths, s_max: int) -> torch.Tensor:
    """(B,) int32 prompt lengths on the host, each in [1, s_max]."""
    lengths = torch.as_tensor(prompt_lengths).to("cpu", torch.int32)
    if bool(((lengths < 1) | (lengths > s_max)).any()):
        raise ValueError(
            f"prompt_lengths must be in [1, {s_max}], got "
            f"{lengths.tolist()}")
    return lengths


def _token_loop(model, last_logits, caches, steps: int, generator,
                **knobs):
    """Pick the first token from the prefill's logits, then ``steps``
    decode steps, each feeding the token picked last.  Returns
    ((B, steps) tokens, final caches)."""
    tok = _select_token(last_logits, generator, **knobs)
    out = []
    for _ in range(steps):
        out.append(tok)
        logits, caches = decode_step(model, tok, caches)
        tok = _select_token(logits, generator, **knobs)
    return torch.stack(out, dim=1), caches


def _prompt(model, prompt) -> torch.Tensor:
    return torch.as_tensor(prompt).to(model.device, torch.long)


def _padded_prefill(model, prompt, lengths, capacity):
    """One causal prefill of right-padded prompts over dense caches (pad
    keys sit past every valid query); returns each sequence's logits at
    its last valid token, and the caches."""
    caches = model.init_caches(prompt.shape[0], capacity)
    logits, caches = model(prompt, caches)
    lens = lengths.to(model.device)
    last = logits[torch.arange(prompt.shape[0], device=model.device),
                  lens.long() - 1]
    return last, caches, lens


@torch.no_grad()
def generate(model, prompt, *, steps: int, capacity: int | None = None,
             int8_cache: bool = False, rolling_cache: bool = False,
             temperature: float = 0.0, top_k: int | None = None,
             top_p: float | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Autoregressive generation: (B, S) prompt -> (B, steps)
    continuation.  Prefill, then ``steps`` decode steps on dense caches;
    ``int8_cache=True`` quantizes them once after the prefill and runs
    the steps against the int8 caches; ``rolling_cache=True`` (windowed
    models) runs prefill and steps on `RollingKVCache` ring buffers
    instead, and ``capacity`` does not apply.  ``temperature == 0``
    (default) is greedy; ``temperature > 0`` samples from ``generator``,
    optionally truncated by ``top_k`` and/or nucleus ``top_p``."""
    generator = _validate_sampling(model, temperature, top_k, top_p,
                                   generator)
    prompt = _prompt(model, prompt)
    if rolling_cache:
        if int8_cache:
            raise ValueError("rolling_cache and int8_cache are exclusive")
        if model.window is None:
            raise ValueError("rolling_cache requires a windowed model")
        caches = model.init_caches(prompt.shape[0], 0, rolling=True)
        logits, caches = model(prompt, caches)
        last = logits[:, -1]
    else:
        capacity = _resolve_capacity(prompt.shape[1], steps, capacity)
        if int8_cache:
            _require_flash_for_int8(model)
        last, caches = prefill(model, prompt, capacity)
        if int8_cache:
            caches = tuple(c.quantize() for c in caches)
    return _token_loop(model, last, caches, steps, generator,
                       temperature=temperature, top_k=top_k, top_p=top_p)[0]


@torch.no_grad()
def generate_ragged(model, prompt, prompt_lengths, *, steps: int,
                    capacity: int | None = None, temperature: float = 0.0,
                    top_k: int | None = None, top_p: float | None = None,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """Batched generation over prompts of different lengths: (B, S_max)
    right-padded prompts and their (B,) true lengths -> (B, steps);
    sequence b's continuation starts right after its
    ``prompt_lengths[b]``-th token.  One padded prefill, then decode
    steps on a `RaggedKVCache`, each sequence at its own position.
    Greedy output per sequence equals `generate` on the trimmed
    prompt."""
    generator = _validate_sampling(model, temperature, top_k, top_p,
                                   generator)
    prompt = _prompt(model, prompt)
    b, s_max = prompt.shape
    lengths = _validate_lengths(prompt_lengths, s_max)
    capacity = _resolve_capacity(s_max, steps, capacity)
    last, caches, lens = _padded_prefill(model, prompt, lengths, capacity)
    caches = tuple(RaggedKVCache.from_prefill(c, lens) for c in caches)
    return _token_loop(model, last, caches, steps, generator,
                       temperature=temperature, top_k=top_k, top_p=top_p)[0]


@torch.no_grad()
def generate_paged(model, prompt, prompt_lengths, *, steps: int,
                   num_pages: int | None = None, page_size: int = 128,
                   temperature: float = 0.0, top_k: int | None = None,
                   top_p: float | None = None,
                   generator: torch.Generator | None = None):
    """Ragged batched generation on paged KV caches: (B, S_max) padded
    prompts -> ((B, steps) tokens, the final per-layer `PagedKV` caches,
    the per-layer `PagePool`s).

    Prefill runs on dense caches, which are then scattered into one page
    pool per layer (`paged_from_dense`), each sequence claiming the pages
    for prompt + steps up front; the decode steps append through the
    page table.  Greedy output equals `generate_ragged`.  When sequence b
    completes, free its pages with
    ``pools[l].free([p for p in caches[l].page_table[b].tolist() if p >=
    0])``."""
    generator = _validate_sampling(model, temperature, top_k, top_p,
                                   generator)
    prompt = _prompt(model, prompt)
    b, s_max = prompt.shape
    lengths = _validate_lengths(prompt_lengths, s_max)
    capacity = -(-(s_max + steps) // page_size) * page_size
    if capacity % 128:
        raise ValueError(f"page_size {page_size} must be a 128-multiple")
    pages_per_seq = capacity // page_size
    if num_pages is None:
        num_pages = b * pages_per_seq
    last, caches, lens = _padded_prefill(model, prompt, lengths, capacity)
    pools = [PagePool(num_pages) for _ in caches]
    paged = tuple(
        paged_from_dense(c.k, c.v, lens, pool, num_pages=num_pages,
                         page_size=page_size,
                         total_pages_per_seq=pages_per_seq)
        for c, pool in zip(caches, pools))
    del caches  # frees the dense copies before the token loop
    toks, final = _token_loop(model, last, paged, steps, generator,
                              temperature=temperature, top_k=top_k,
                              top_p=top_p)
    return toks, final, pools


def _cache_rows(caches, rows: torch.Tensor) -> tuple:
    """Each layer's dense or int8 cache with its batch rows gathered by
    ``rows`` (beam-major replication, or the surviving hypotheses'
    parents).  Indexing copies, so every cache gets fresh storage: the
    caches are written in place, and rows that share a parent must not
    share storage.  Lengths are the batch's and stay as they are."""
    out = []
    for c in caches:
        if isinstance(c, KVCache):
            out.append(KVCache(c.k[rows], c.v[rows], c.length))
        elif isinstance(c, QuantKVCache):
            out.append(QuantKVCache(type(c.kv)(*(t[rows] for t in c.kv)),
                                    c.length))
        else:
            raise TypeError(f"beam search reorders dense and int8 caches, "
                            f"not {type(c).__name__}")
    return tuple(out)


@torch.no_grad()
def generate_beam(model, prompt, *, steps: int, beams: int = 4,
                  capacity: int | None = None, int8_cache: bool = False,
                  return_scores: bool = False):
    """Beam search: (B, S) prompt -> (B, steps), the continuation of
    highest total log-probability found over ``beams`` beams.

    One prefill at batch B; its caches are replicated to B·beams rows
    (beam j of sequence b at row b·beams + j) and the first expansion
    takes the prefill's top ``beams`` tokens.  Each of the ``steps`` - 1
    decode steps scores beams x vocab candidates per sequence, keeps the
    top ``beams``, and gathers every cache's rows to follow the
    surviving hypotheses (`_cache_rows`).  Fixed horizon, no EOS, so the
    scores are plain sums of log-probabilities.  ``beams=1`` is greedy
    decoding.  ``int8_cache=True`` quantizes the caches once after the
    prefill; their int8 values and per-token scales reorder alike.
    ``return_scores`` also returns each sequence's (B,) total
    log-probability of the returned tokens."""
    if beams < 1:
        raise ValueError(f"beams must be >= 1, got {beams}")
    if beams > model.vocab:
        raise ValueError(f"beams {beams} > vocab {model.vocab}")
    prompt = _prompt(model, prompt)
    b, s = prompt.shape
    w, vocab = beams, model.vocab
    capacity = _resolve_capacity(s, steps, capacity)
    if int8_cache:
        _require_flash_for_int8(model)
    last, caches = prefill(model, prompt, capacity)
    if int8_cache:
        caches = tuple(c.quantize() for c in caches)
    dev = model.device
    caches = _cache_rows(caches, torch.arange(b, device=dev)
                         .repeat_interleave(w))
    logp = torch.log_softmax(last.float(), dim=-1)
    scores, tok = torch.topk(logp, w, dim=-1)           # (B, w)
    seqs = torch.zeros((b, w, steps), dtype=torch.long, device=dev)
    seqs[:, :, 0] = tok
    base = torch.arange(b, device=dev)[:, None] * w
    for t in range(1, steps):
        logits, caches = decode_step(model, tok.reshape(b * w), caches)
        logp = torch.log_softmax(logits.float(), dim=-1)
        cand = scores[:, :, None] + logp.reshape(b, w, vocab)
        scores, flat = torch.topk(cand.reshape(b, w * vocab), w, dim=-1)
        parent = torch.div(flat, vocab, rounding_mode="floor")
        tok = flat % vocab
        caches = _cache_rows(caches, (base + parent).reshape(-1))
        seqs = torch.gather(seqs, 1, parent[:, :, None].expand(-1, -1, steps))
        seqs[:, :, t] = tok
    best = scores.argmax(dim=-1)                         # (B,)
    rows = torch.arange(b, device=dev)
    toks = seqs[rows, best]
    return (toks, scores[rows, best]) if return_scores else toks
