"""Packed-sequence segment ids in the port, against the JAX package, on
the CPU.

Segment ids ((m,) for the query rows and (n,) for the key rows, shared
across heads) keep a pair only where they are equal, on top of every
other mask: packed documents attend within themselves.  The port's
forward, partials, backward and `flash_attention_diff` (both
``bwd_impl``s) take them; on the CPU each runs its plain version, which
is what the kernels are held against on the card.  The JAX side runs its
Pallas kernels in interpret mode, as tests/test_segments.py runs them.
Inputs come from numpy seeds and reach both sides as the same arrays; 4
q / 2 kv heads (GQA) unless a case says otherwise, d 32, 40 to 170 rows,
no sequence a multiple of 64.

Tolerances: float32 1e-5 max abs (`reference.F32_ATOL`): both sides
compute in full f32 and differ only in summation order (and exp against
exp2); values are O(1) and sums run over at most 170 keys.  The
partials' unnormalized output and row sum are not O(1) but sums of up
to 100 terms exp(s - max) <= 1 (values near 20 here, where one f32 ulp
is 2e-6): they are held to 1e-5 times their row's sum (at least 1e-5),
the same relative accuracy the normalized output has.  All-equal ids
against no ids: the same bits (the same mask).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.ops.flash import flash_attention as jax_flash
from attention_tpu.ops.flash import \
    flash_attention_partials as jax_partials
from attention_tpu.ops.flash_vjp import flash_attention_diff as jax_diff
from attention_tpu_torch.ops import _native, flash_bwd
from attention_tpu_torch.ops.flash import (
    KEY_TILE,
    ROW_BLOCK,
    flash_attention,
    flash_attention_partials,
    flash_attention_plain,
    tile_plan,
)
from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl, \
    flash_attention_diff
from attention_tpu_torch.ops.reference import F32_ATOL, attention_mask


def _docs(*lengths):
    """Sorted ids of packed documents of these lengths."""
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)


# name: (q shape, k/v shape, q ids, kv ids, keywords)
CASES = {
    "packed": ((4, 120, 32), (2, 120, 32), _docs(50, 7, 63),
               _docs(50, 7, 63), {}),
    "interleaved": ((4, 100, 32), (2, 100, 32),
                    (np.arange(100) % 3).astype(np.int32),
                    (np.arange(100) % 3).astype(np.int32), {}),
    # rows 10-19 hold an id no key holds: they see nothing
    "query_id_with_no_key": (
        (4, 90, 32), (2, 90, 32),
        np.where((np.arange(90) >= 10) & (np.arange(90) < 20), 7,
                 _docs(30, 60)).astype(np.int32),
        _docs(30, 60), dict(causal=True)),
    "causal": ((4, 150, 32), (2, 150, 32), _docs(41, 1, 70, 38),
               _docs(41, 1, 70, 38), dict(causal=True)),
    "window": ((4, 150, 32), (2, 150, 32), _docs(80, 70), _docs(80, 70),
               dict(causal=True, window=40)),
    "softcap": ((4, 110, 32), (2, 110, 32), _docs(55, 55), _docs(55, 55),
                dict(causal=True, softcap=5.0)),
    "kv_valid": ((4, 100, 32), (2, 130, 32), _docs(50, 50),
                 _docs(60, 70), dict(kv_valid=90)),
    "offsets": ((4, 70, 32), (2, 170, 32), _docs(30, 40) + 1,
                _docs(60, 50, 60), dict(causal=True, q_offset=100,
                                        kv_offset=3)),
    # m != n and ids that only partly meet: rows of id 0 see nothing
    "m_ne_n": ((4, 70, 32), (2, 170, 32), _docs(20, 50),
               _docs(40, 60, 70) + 1, {}),
    "gqa_4_to_1": ((4, 100, 32), (1, 100, 32), _docs(33, 67),
                   _docs(33, 67), dict(causal=True)),
    "two_d": ((100, 32), (100, 32), _docs(45, 55), _docs(45, 55),
              dict(causal=True)),
}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.cache
def _case(name):
    """(q, k, v, w, q ids, kv ids, keywords) as numpy, w the weights of
    the loss sum(out·w) whose gradients the backward tests take."""
    qs, ks, q_ids, kv_ids, kw = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q, k, v, w = (_rand(rng, *s) for s in (qs, ks, ks, qs))
    return q, k, v, w, q_ids, kv_ids, kw


def _ids(name, lib):
    q_ids, kv_ids = _case(name)[4:6]
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return dict(q_segment_ids=conv(q_ids), kv_segment_ids=conv(kv_ids))


@functools.cache
def _jax_results(name):
    """JAX's output, partials and gradients of sum(out·w) (its
    ``bwd_impl="pallas"``: the Pallas backward kernels) on the case."""
    q, k, v, w, _, _, kw = _case(name)
    ids = _ids(name, "jax")
    out = jax_flash(q, k, v, **ids, **kw)
    parts = jax_partials(q, k, v, **ids, **kw)

    def loss(q, k, v):
        return jnp.sum(jax_diff(q, k, v, **ids, **kw) * w)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return (np.asarray(out), tuple(np.asarray(x) for x in parts),
            tuple(np.asarray(g) for g in grads))


def _close(mine, theirs):
    theirs = torch.from_numpy(np.array(theirs))
    assert mine.shape == theirs.shape
    assert torch.equal(mine.isfinite(), theirs.isfinite())
    live = theirs.isfinite()
    assert (mine[live] - theirs[live]).abs().max().item() <= F32_ATOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name):
    q, k, v, _, _, _, kw = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                            else x for x in _case(name))
    got = flash_attention(q, k, v, **_ids(name, "torch"), **kw)
    assert got.dtype == torch.float32 and bool(got.isfinite().all())
    _close(got, _jax_results(name)[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_partials_match_jax(name):
    """Unnormalized output, row max and row sum; a row that sees no key
    has max -inf and sum 0 on both sides."""
    q, k, v = (torch.from_numpy(x) for x in _case(name)[:3])
    kw = _case(name)[6]
    got = flash_attention_partials(q, k, v, **_ids(name, "torch"), **kw)
    want = [torch.from_numpy(np.array(x)) for x in _jax_results(name)[1]]
    _close(got[1], want[1])
    scale = want[2].clamp(min=1.0)
    for mine, theirs, lim in ((got[0], want[0], scale[..., None]),
                              (got[2], want[2], scale)):
        assert mine.shape == theirs.shape
        assert bool(((mine - theirs).abs() <= F32_ATOL * lim).all())
    if name == "query_id_with_no_key":
        assert bool((got[1][..., 10:20] == float("-inf")).all())
        assert bool((got[2][..., 10:20] == 0).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_backward_matches_jax_grad(name):
    """`flash_backward` (3-D) on the port's own forward out and lse with
    dout = w, against `jax.grad` of JAX's `flash_attention_diff`: the
    same gradients.  Rows that see no key give dQ 0, never NaN."""
    q, k, v, w = (torch.from_numpy(x) for x in _case(name)[:4])
    kw = _case(name)[6]
    ids = _ids(name, "torch")
    lead = 3 - q.dim()
    q3, k3, v3, w3 = (t[(None,) * lead] for t in (q, k, v, w))
    scale = q.shape[-1] ** -0.5
    out, lse = _flash_fwd_impl(q3, k3, v3, scale=scale, **ids, **kw)
    got = flash_bwd.flash_backward(q3, k3, v3, out, lse, w3, scale=scale,
                                   **ids, **kw)
    for mine, theirs in zip(got, _jax_results(name)[2]):
        mine = mine[(0,) * lead]
        assert bool(mine.isfinite().all())
        _close(mine, theirs)
    if name == "query_id_with_no_key":
        assert bool((lse[:, 10:20] == float("-inf")).all())
        assert bool((got[0][:, 10:20] == 0).all())


@pytest.mark.parametrize("bwd_impl", ["pallas", "xla"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_diff_gradients_match_jax(name, bwd_impl):
    q, k, v, w = (torch.from_numpy(x) for x in _case(name)[:4])
    kw = _case(name)[6]
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_diff(*qkv, bwd_impl=bwd_impl,
                               **_ids(name, "torch"), **kw)
    _close(out.detach(), _jax_results(name)[0])
    (out * w).sum().backward()
    for t, theirs in zip(qkv, _jax_results(name)[2]):
        _close(t.grad, theirs)


def _all_equal(name):
    q, k, v, w = (torch.from_numpy(x) for x in _case(name)[:4])
    zeros = dict(q_segment_ids=torch.zeros(q.shape[-2], dtype=torch.int32),
                 kv_segment_ids=torch.zeros(k.shape[-2], dtype=torch.int32))
    return q, k, v, w, zeros, _case(name)[6]


@pytest.mark.parametrize("entry", ["flash_attention", "partials",
                                   "flash_backward", "diff_xla"])
def test_all_equal_ids_give_the_bits_of_no_ids(entry):
    """One segment for every row is no mask: the same bits as the call
    without ids, on each entry point (the plain versions here; the card
    tests and the smoke hold the kernels to the same)."""
    q, k, v, w, zeros, kw = _all_equal("window")
    if entry == "flash_attention":
        pair = [flash_attention(q, k, v, **ids, **kw) for ids in ({}, zeros)]
    elif entry == "partials":
        pair = [torch.cat([t.reshape(-1) for t in flash_attention_partials(
            q, k, v, **ids, **kw)]) for ids in ({}, zeros)]
    elif entry == "flash_backward":
        out, lse = _flash_fwd_impl(q, k, v, scale=0.25, **kw)
        pair = [torch.cat([g.reshape(-1) for g in flash_bwd.flash_backward(
            q, k, v, out, lse, w, scale=0.25, **ids, **kw)])
            for ids in ({}, zeros)]
    else:
        pair = []
        for ids in ({}, zeros):
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            (flash_attention_diff(*qkv, bwd_impl="xla", **ids, **kw)
             * w).sum().backward()
            pair.append(torch.cat([t.grad.reshape(-1) for t in qkv]))
    assert torch.equal(pair[0], pair[1])


def _refusal_calls(q, k, v, **kw):
    """The four entry points on the same inputs and keywords."""
    lse = torch.zeros(q.shape[:-1])
    return {
        "flash_attention": lambda: flash_attention(q, k, v, **kw),
        "partials": lambda: flash_attention_partials(q, k, v, **kw),
        "flash_backward": lambda: flash_bwd.flash_backward(
            q, k, v, q, lse, q, scale=1.0, **kw),
        "diff": lambda: flash_attention_diff(q, k, v, **kw),
    }


_IDS16 = torch.zeros(16, dtype=torch.int32)


@pytest.mark.parametrize("shape,kw,match", [
    ((2, 16, 8), dict(q_segment_ids=_IDS16), "go together"),
    ((2, 16, 8), dict(kv_segment_ids=_IDS16), "go together"),
    ((1, 2, 16, 8), dict(q_segment_ids=_IDS16, kv_segment_ids=_IDS16),
     "2D/3D"),
    ((2, 16, 8), dict(q_segment_ids=_IDS16[:15], kv_segment_ids=_IDS16),
     "shapes"),
    ((2, 16, 8), dict(q_segment_ids=_IDS16, kv_segment_ids=_IDS16[:-1]),
     "shapes"),
    ((2, 16, 8), dict(q_segment_ids=_IDS16[None],
                      kv_segment_ids=_IDS16[None]), "shapes"),
    ((2, 16, 8), dict(q_segment_ids=_IDS16, kv_segment_ids=_IDS16,
                      causal=True, window=8, sinks=2), "sinks"),
], ids=["q_ids_alone", "kv_ids_alone", "four_d", "q_ids_short",
        "kv_ids_short", "ids_two_d", "sinks_with_ids"])
@pytest.mark.parametrize("entry", ["flash_attention", "partials",
                                   "flash_backward", "diff"])
def test_jax_refusals_raise_value_error(entry, shape, kw, match):
    """JAX's refusals of segment ids (attention_tpu/ops/flash.py:885-909,
    :1222-1240, :1354-1358), as `ValueError`, in every entry point,
    before any work."""
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        _refusal_calls(q, q, q, **kw)[entry]()


@pytest.mark.parametrize("name", ["packed", "interleaved", "window",
                                  "offsets", "kv_valid"])
def test_ids_mask_within_the_walk(name):
    """Ids only remove pairs: every pair the plain mask keeps with ids
    lies in a key tile that the wgmma body's plan (`tile_plan`, which
    takes no ids) visits for its row block, so a SEG instance that walks
    that plan and tests every element of each tile sees them all."""
    qs, ks, q_ids, kv_ids, kw = CASES[name]
    m, n = qs[-2], ks[-2]
    keep = attention_mask(
        m, n, causal=kw.get("causal", False), q_offset=kw.get("q_offset", 0),
        kv_offset=kw.get("kv_offset", 0), kv_valid=kw.get("kv_valid"),
        window=kw.get("window"), q_segment_ids=torch.from_numpy(q_ids),
        kv_segment_ids=torch.from_numpy(kv_ids))
    for m0 in range(0, m, ROW_BLOCK):
        plan = tile_plan(m0, m, kw.get("kv_valid", n),
                         kw.get("causal", False), kw.get("q_offset", 0),
                         kw.get("kv_offset", 0), window=kw.get("window"))
        cols = keep[m0:m0 + ROW_BLOCK].any(0).nonzero().flatten()
        assert set((cols // KEY_TILE).tolist()) <= set(plan.tiles())


def test_staged_ids_pad_to_whole_items_and_key_blocks(monkeypatch):
    """The backward kernels read ids by bulk copies of whole query tiles
    and key blocks: `_Staged` pads the query ids to the lse2 row stride
    with -1 and the key ids to whole 128-key blocks with -2 (ids no real
    row holds), int32 and contiguous."""
    monkeypatch.setattr(_native, "sm_count", lambda index: 132)
    gen = torch.Generator().manual_seed(0)
    q, o, do = (torch.randn((1, 4, 100, 64), generator=gen)
                .to(torch.bfloat16) for _ in range(3))
    k, v = (torch.randn((1, 2, 300, 64), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    q_ids = torch.arange(100, dtype=torch.int32) // 30
    kv_ids = torch.arange(300, dtype=torch.int32) // 90
    staged = flash_bwd._Staged(
        q, k, v, o, torch.zeros(1, 4, 100), do, scale=0.125, causal=True,
        softcap=None, q_offset=0, kv_offset=0, kv_valid=300, q_ids=q_ids,
        kv_ids=kv_ids)
    sq, skv = staged.ids
    assert sq.shape == (staged.ls,) and skv.shape == (384,)
    assert sq.dtype == skv.dtype == torch.int32
    assert sq.is_contiguous() and skv.is_contiguous()
    assert torch.equal(sq[:100], q_ids) and bool((sq[100:] == -1).all())
    assert torch.equal(skv[:300], kv_ids) and bool((skv[300:] == -2).all())


def test_cpu_calls_with_ids_reach_no_kernel(monkeypatch):
    """A CPU tensor with ids runs the plain versions: no kernel is
    built, loaded or launched on the CPU."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(_native, "function", no_kernel)
    before = _native.launch_counts()
    q, k, v, w, _, _, kw = (torch.from_numpy(x) if isinstance(x, np.ndarray)
                            else x for x in _case("causal"))
    ids = _ids("causal", "torch")
    q = q.clone().requires_grad_()
    (flash_attention_diff(q, k, v, **ids, **kw) * w).sum().backward()
    flash_attention_plain(q.detach(), k, v, **ids, **kw)
    assert _native.launch_counts() == before
    assert q.grad is not None and bool(q.grad.isfinite().all())
