"""The port's `paged_fork`, `PagePool.table_row` and
`recommended_page_size` against the JAX package, on the CPU.

The same dense caches (numpy seeds) are scattered into page pools by
both packages and forked: page tables, lengths, refcounts and free
lists must be equal, the copied tails bit-equal to the source's, and
the forks' decode outputs (JAX's kernel in interpret mode, the port's
plain version) within 2e-5 (`tests/test_paged.py`'s limit for the same
decode: float32 on both sides, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.ops import paged as jax_paged
from attention_tpu_torch.ops import paged

HKV, D, PAGE, N = 2, 32, 128, 512
ATOL = 2e-5


def _pools(length, num_pages, seed=0):
    """The same (1, Hkv, N, d) caches scattered by both packages into
    pools of ``num_pages``: (jax cache, jax pool, port cache, port pool,
    k, v)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((1, HKV, N, D)).astype(np.float32)
            for _ in "kv")
    jpool, tpool = jax_paged.PagePool(num_pages), paged.PagePool(num_pages)
    jbase = jax_paged.paged_from_dense(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray([length], jnp.int32),
        jpool, num_pages=num_pages)
    tbase = paged.paged_from_dense(torch.from_numpy(k), torch.from_numpy(v),
                                   [length], tpool, num_pages=num_pages)
    return jbase, jpool, tbase, tpool, k, v


def _same_pools(jpool, tpool):
    assert tpool.free_pages == jpool.free_pages
    assert tpool._free == jpool._free
    assert [tpool.refcount(p) for p in range(tpool.num_pages)] == \
        [jpool.refcount(p) for p in range(jpool.num_pages)]


@pytest.mark.parametrize("length,copies,reserve", [
    (300, 3, 1),    # 2 full pages and a 44-row tail
    (293, 2, 0),    # 2 full pages and a 37-row tail
    (256, 2, 1),    # full pages only: nothing to copy
    (5, 4, 2),      # a tail alone
])
def test_fork_matches_jax(length, copies, reserve):
    """Tables, lengths, refcounts and free lists equal to JAX's; the
    forks' tails bit-equal to the source's; each fork's decode (one
    token and a chunk of 3 after an append) equal to JAX's on the same
    queries, and the shared pages bit-equal after the appends."""
    jbase, jpool, tbase, tpool, _, _ = _pools(length, 16)
    jfork = jax_paged.paged_fork(jbase, jpool, 0, copies,
                                 reserve_pages=reserve)
    tfork = paged.paged_fork(tbase, tpool, 0, copies, reserve_pages=reserve)
    np.testing.assert_array_equal(tfork.page_table.numpy(),
                                  np.asarray(jfork.page_table))
    np.testing.assert_array_equal(tfork.lengths.numpy(),
                                  np.asarray(jfork.lengths))
    _same_pools(jpool, tpool)
    src_row = tbase.page_table[0].tolist()
    full = length // PAGE
    if length % PAGE:
        for tail in tfork.page_table[:, full].tolist():
            assert tail != src_row[full]
            assert torch.equal(tfork.k_pool[tail], tbase.k_pool[src_row[full]])
            assert torch.equal(tfork.v_pool[tail], tbase.v_pool[src_row[full]])
    shared = torch.tensor(src_row[:full], dtype=torch.long)
    before = tfork.k_pool[shared].clone()

    rng = np.random.default_rng(1)
    q = rng.standard_normal((copies, 4, D)).astype(np.float32)
    want = jax_paged.paged_flash_decode(jnp.asarray(q), jfork)
    got = paged.paged_flash_decode(torch.from_numpy(q), tfork)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    kv = rng.standard_normal((copies, HKV, 3, D)).astype(np.float32)
    qc = rng.standard_normal((copies, 4, 3, D)).astype(np.float32)
    jfork = jax_paged.paged_append_chunk(jfork, jnp.asarray(kv),
                                         jnp.asarray(kv))
    tfork = paged.paged_append_chunk(tfork, torch.from_numpy(kv),
                                     torch.from_numpy(kv))
    want = jax_paged.paged_flash_decode(jnp.asarray(qc), jfork)
    got = paged.paged_flash_decode(torch.from_numpy(qc), tfork)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert torch.equal(tfork.k_pool[shared], before)
    assert (tfork.lengths >= 0).all()


def test_fork_decodes_as_the_unforked_context():
    """A fork's decode equals the dense decode of the same context (the
    source's 300 rows), and the source row still decodes as before."""
    from attention_tpu_torch.ops.decode import flash_decode

    _, _, tbase, tpool, k, v = _pools(300, 16)
    fork = paged.paged_fork(tbase, tpool, 0, 3, reserve_pages=1)
    q = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 4, D)).astype(np.float32))
    dense = flash_decode(q, torch.from_numpy(k).expand(3, -1, -1, -1),
                         torch.from_numpy(v).expand(3, -1, -1, -1),
                         torch.full((3,), 300))
    torch.testing.assert_close(paged.paged_flash_decode(q, fork), dense,
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(paged.paged_flash_decode(q[:1], tbase),
                               dense[:1], atol=ATOL, rtol=0)


def test_fork_rolls_back_when_the_pool_runs_out():
    """The pool runs out at the third fork: every reference and page
    claimed so far goes back, on both sides alike, and the error is the
    typed one."""
    jbase, jpool, tbase, tpool, _, _ = _pools(300, 8)
    refs = [tpool.refcount(p) for p in range(8)]
    free = list(tpool._free)
    with pytest.raises(jax_paged.OutOfPagesError):
        jax_paged.paged_fork(jbase, jpool, 0, 3, reserve_pages=1)
    with pytest.raises(paged.OutOfPagesError, match="exhausted"):
        paged.paged_fork(tbase, tpool, 0, 3, reserve_pages=1)
    assert [tpool.refcount(p) for p in range(8)] == refs
    assert sorted(tpool._free) == sorted(free)
    _same_pools(jpool, tpool)


def test_fork_refusals():
    _, _, tbase, tpool, _, _ = _pools(300, 16)
    with pytest.raises(ValueError, match="n_copies"):
        paged.paged_fork(tbase, tpool, 0, 0)
    with pytest.raises(ValueError, match="src_row"):
        paged.paged_fork(tbase, tpool, 1, 2)
    with pytest.raises(ValueError, match="overflows the table"):
        paged.paged_fork(tbase, tpool, 0, 2, reserve_pages=2)
    poisoned = tbase._replace(lengths=torch.tensor([-1], dtype=torch.int32))
    with pytest.raises(ValueError, match="poisoned"):
        paged.paged_fork(poisoned, tpool, 0, 2)
    assert tpool.free_pages == 13


@pytest.mark.parametrize("pages,width", [([3, 0, 7], 5), ([], 2), ([4], 1)])
def test_table_row_matches_jax(pages, width):
    row = paged.PagePool(8).table_row(pages, width)
    assert row.dtype == torch.int32
    np.testing.assert_array_equal(
        row.numpy(), np.asarray(jax_paged.PagePool(8).table_row(pages,
                                                                 width)))
    with pytest.raises(ValueError, match="max_pages"):
        paged.PagePool(8).table_row([1, 2, 3], 2)


@pytest.mark.parametrize("cache_len", [128, 384, 512, 1536, 2048, 4096,
                                       6144, 640, 33024])
def test_recommended_page_size_matches_jax_heuristic(cache_len):
    """The measured heuristic, on an empty tuning table on the JAX side
    (the tests' hermetic cache): the largest power-of-two page up to
    2048 that divides the capacity."""
    assert paged.recommended_page_size(cache_len) == \
        jax_paged.recommended_page_size(cache_len, batch=8, heads=32,
                                        kv_heads=4)
