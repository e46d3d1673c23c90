"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so every test here carries the
``cuda`` marker and skips where torch sees no card.  This file imports
no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those of `reference.mismatch`: f32 1e-5 max abs (both
sides in full f32, no TF32; only the summation order differs), bf16
1.6e-2 of the value plus 2^-6 of its row's rms, capped at 2e-2 (the
sides round P and the output to bf16 at different points).  The
quantized decode kernels are held to the same bf16 limits against
`quant.quant_decode_plain`.  The backward kernels' gradients are held to
`reference.grad_mismatch` (bf16: one output ulp, 2^-7 of the value, plus
2^-6 of the row's rms for a P or dS value the two sides round apart, plus
2^-10 of the tensor's rms; f32: 2^-16 of the value and of the row's rms,
plus 2^-20 of the tensor's).
"""

import pytest
import torch

from attention_tpu_torch.ops import demotion_count, launch_counts, \
    reset_launch_counts
from attention_tpu_torch.ops import flash as flash_ops
from attention_tpu_torch.ops._native import KernelLaunchError
from attention_tpu_torch.ops.decode import flash_decode, \
    flash_decode_chunk, flash_decode_plain, split_plan
from attention_tpu_torch.ops.flash import flash_attention, \
    flash_attention_plain, flash_launch_plan
from attention_tpu_torch.ops.paged import PagedKV, paged_flash_decode, \
    paged_flash_decode_plain
from attention_tpu_torch.ops import quant
from attention_tpu_torch.ops.ragged_paged import (
    RaggedPagedStep,
    packed_bucket,
    ragged_launch_plan,
    ragged_paged_append,
    ragged_paged_attention,
    ragged_paged_attention_plain,
    recommended_q_tile,
)
from attention_tpu_torch.ops import flash_bwd
from attention_tpu_torch.ops.flash import _offsets, \
    flash_attention_partials, flash_attention_partials_plain
from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl, \
    flash_attention_diff
from attention_tpu_torch.ops.reference import grad_mismatch, mismatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _share_of_limit(got, want):
    torch.cuda.synchronize()
    return mismatch(got, want)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,kw", [
    (((200, 64), (333, 64), (333, 96)), {}),
    (((8, 130, 128), (2, 257, 128), (2, 257, 128)), {"softcap": 5.0}),
    (((2, 8, 300, 64), (2, 2, 300, 64), (2, 2, 300, 64)),
     {"causal": True}),
], ids=["2d_dk_ne_dv", "3d_gqa_softcap", "4d_causal"])
def test_flash_kernel_matches_plain(gen, shapes, kw, dtype):
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in shapes)
    before = launch_counts()["flash_fwd"]
    got = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_fwd"] == before + 1
    assert got.dtype == dtype and got.device.type == "cuda"
    assert _share_of_limit(got, flash_attention_plain(q, k, v, **kw)) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_offsets_match_plain(gen, dtype):
    """Cached prefill: 300 new rows at offset 200 of a 1152-row cache."""
    q = torch.randn(2, 8, 300, 128, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(2, 2, 1152, 128, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    kw = dict(causal=True, q_offset=200, kv_valid=500, softcap=20.0)
    got = flash_attention(q, k, v, **kw)
    assert _share_of_limit(got, flash_attention_plain(q, k, v, **kw)) <= 1


def _decode_case(gen, dtype, s_new):
    """B = 5 sequences of lengths 0 .. the full capacity, 8 q / 2 kv
    heads, d 128, 1024 rows; q (B, H, S, d) for S > 0, else (B, H, d)."""
    b, h, hkv, n, d = 5, 8, 2, 1024, 128
    q = torch.randn(b, h, *([s_new] if s_new else []), d, generator=gen,
                    device="cuda").to(dtype)
    k, v = (torch.randn(b, hkv, n, d, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    lens = torch.tensor([0, 1, 300, 777, n], dtype=torch.int32,
                        device="cuda")
    return q, k, v, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_new,kw", [
    (0, {}), (0, {"softcap": 30.0}), (0, {"window": 100, "sinks": 4}),
    (4, {"softcap": 30.0}), (40, {"window": 64, "sinks": 4})],
    ids=["decode", "softcap", "window_sinks", "chunk4", "chunk40_window"])
def test_decode_kernel_matches_plain(gen, dtype, s_new, kw):
    q, k, v, lens = _decode_case(gen, dtype, s_new)
    fn = flash_decode_chunk if s_new else flash_decode
    before = launch_counts()["decode"]
    got = fn(q, k, v, lens, **kw)
    assert launch_counts()["decode"] == before + 1
    assert _share_of_limit(got, flash_decode_plain(q, k, v, lens, **kw)) <= 1
    assert (got[0] == 0).all()      # length 0: a zero row


def _paged(k, v, lens, page=128):
    """The dense (B, Hkv, N, d) caches behind a shuffled page table."""
    b, hkv, n, d = k.shape
    per = n // page
    perm = torch.randperm(b * per, device="cuda")
    table = perm.view(b, per).to(torch.int32).contiguous()

    def pool(x):
        out = torch.empty(b * per, hkv, page, d, dtype=x.dtype,
                          device="cuda")
        out[perm] = x.view(b, hkv, per, page, d).transpose(1, 2).reshape(
            b * per, hkv, page, d)
        return out

    return PagedKV(pool(k), pool(v), table, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_new,kw", [
    (0, {"softcap": 30.0}), (0, {"window": 100, "sinks": 4}),
    (0, {"return_stats": True}), (256, {"softcap": 30.0})],
    ids=["decode", "window_sinks", "stats", "chunk256"])
def test_paged_kernel_matches_plain(gen, dtype, s_new, kw):
    q, k, v, lens = _decode_case(gen, dtype, s_new)
    cache = _paged(k, v, lens)
    if s_new:   # sequence 1 too short for the chunk: poison it
        cache = cache._replace(lengths=torch.tensor(
            [0, -1, 300, 777, 1024], dtype=torch.int32, device="cuda"))
    before = launch_counts()["paged_decode"]
    got = paged_flash_decode(q, cache, **kw)
    assert launch_counts()["paged_decode"] == before + 1
    want = paged_flash_decode_plain(q, cache, **kw)
    if kw.get("return_stats"):
        (o, m, l_), (wo, wm, wl) = got, want
        # normalized, the partials meet the kernels' usual limits
        norm = (o / l_.clamp(min=1e-30)[..., None]).to(dtype)
        wnorm = (wo / wl.clamp(min=1e-30)[..., None]).to(dtype)
        assert _share_of_limit(norm, wnorm) <= 1
        assert torch.equal(m.isneginf(), wm.isneginf())
        fin = wm.isfinite()
        assert ((m - wm)[fin].abs() <= 1e-5 * wm[fin].abs().clamp(min=1)
                ).all()
        assert ((l_ - wl).abs() <= 1e-5 * wl.clamp(min=1)).all()
        return
    assert _share_of_limit(got, want) <= 1
    if s_new:
        assert got[1].isnan().all() and not got[2:].isnan().any()
    else:
        assert (got[0] == 0).all()


# the edges of the key split (tests/test_torch_decode.py holds the same
# cases' plain partition against JAX): 3 sequences, 8 q / 2 kv heads, d 128
SPLIT_CASES = {
    "length_0": dict(lens=[0, 64, 200]),
    "length_at_chunk_boundary": dict(lens=[64, 128, 192]),
    "full_capacity": dict(lens=[256, 256, 1]),
    "window_straddles_split": dict(lens=[100, 150, 256], window=40),
    "sinks_in_split_0_band_later": dict(lens=[200, 256, 130], window=100,
                                        sinks=4),
    "chunk_of_4": dict(lens=[4, 130, 256], s_new=4, softcap=2.0),
    "capacity_not_tile_multiple": dict(lens=[0, 77, 200], n=200),
    "return_stats": dict(lens=[0, 200, 255], stats=True),
}


def _held_twice(run, plain, dtype):
    """The kernel's output the same bits on a second call, and within
    the limits of its plain version's (partials: normalized in
    ``dtype``, and the row max and sum within f32 1e-5 of max(1,
    |value|))."""
    got, again = run(), run()
    want = plain()
    if isinstance(got, tuple):
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        (o, m, l_), (wo, wm, wl) = got, want
        assert _share_of_limit(
            (o / l_.clamp(min=1e-30)[..., None]).to(dtype),
            (wo / wl.clamp(min=1e-30)[..., None]).to(dtype)) <= 1
        assert torch.equal(m.isneginf(), wm.isneginf())
        fin = wm.isfinite()
        assert ((m - wm)[fin].abs() <= 1e-5 * wm[fin].abs().clamp(min=1)
                ).all()
        assert ((l_ - wl).abs() <= 1e-5 * wl.clamp(min=1)).all()
        return got
    assert torch.equal(got.isnan(), again.isnan())
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    assert _share_of_limit(got, want) <= 1
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_kernels_match_plain(gen, name, dtype):
    """Both decode kernels on the split's edges: more than one split,
    launched once per call, the same bits twice, within the plain
    version's limits; paged through pages of 8 rows where the capacity
    is not a multiple of 128, so key tiles cross pages."""
    case = SPLIT_CASES[name]
    b, h, hkv, d = 3, 8, 2, 128
    n, s_new = case.get("n", 256), case.get("s_new", 1)
    kw = {k: case[k] for k in ("window", "sinks", "softcap") if k in case}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, _ = split_plan(b, hkv, h // hkv * s_new, n, s_new,
                           case.get("window"), sms=sms)
    assert splits > 1
    q = torch.randn(b, h, *([s_new] if s_new > 1 else []), d,
                    generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, hkv, n, d, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    lens = torch.tensor(case["lens"], dtype=torch.int32, device="cuda")
    if not case.get("stats"):
        fn = flash_decode_chunk if s_new > 1 else flash_decode
        before = launch_counts()["decode"]
        got = _held_twice(lambda: fn(q, k, v, lens, **kw),
                          lambda: flash_decode_plain(q, k, v, lens, **kw),
                          dtype)
        assert launch_counts()["decode"] == before + 2
        if case["lens"][0] == 0:
            assert (got[0] == 0).all()
    cache = _paged(k, v, lens, page=8 if n % 128 else 128)
    pkw = dict(kw, return_stats=True) if case.get("stats") else kw
    before = launch_counts()["paged_decode"]
    _held_twice(lambda: paged_flash_decode(q, cache, **pkw),
                lambda: paged_flash_decode_plain(q, cache, **pkw), dtype)
    assert launch_counts()["paged_decode"] == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid", ["one_split", "many_splits"])
def test_split_extremes_empty_and_poisoned_rows(gen, grid, dtype):
    """A launch whose row blocks fill the SMs (no split, no merge) and
    one with a split per key tile (128 of them): an empty sequence gives
    a zero row, a poisoned one (paged, length -1) NaN rows, the others
    match the plain version, the same bits twice."""
    if grid == "one_split":
        b, h, hkv, n = 17, 64, 8, 256
    else:
        b, h, hkv, n = 3, 8, 1, 8192
    d = 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, _ = split_plan(b, hkv, h // hkv, n, 1, None, sms=sms)
    assert (splits == 1) == (grid == "one_split")
    assert grid == "one_split" or splits >= 64
    q = torch.randn(b, h, d, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, hkv, n, d, generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    lens = torch.randint(1, n + 1, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens[0] = 0
    got = _held_twice(lambda: flash_decode(q, k, v, lens),
                      lambda: flash_decode_plain(q, k, v, lens), dtype)
    assert (got[0] == 0).all()
    cache = _paged(k, v, lens)
    cache = cache._replace(lengths=torch.where(
        torch.arange(b, device="cuda") == 1, -1, lens).to(torch.int32))
    got = _held_twice(lambda: paged_flash_decode(q, cache, softcap=30.0),
                      lambda: paged_flash_decode_plain(q, cache,
                                                       softcap=30.0), dtype)
    assert (got[0] == 0).all() and got[1].isnan().all()
    assert not got[2:].isnan().any()


def test_flash_wrapper_raises_instead_of_falling_back(gen):
    q = torch.randn(16, 32, generator=gen, device="cuda",
                    dtype=torch.float64)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)


# The wgmma body (bf16, head dims 64/128): ragged edges (m, n not
# multiples of 128), both signs of q_offset, kv_valid 0, 1 and inside a
# tile, the mixed head dims, 4-D GQA with softcap, a thin grid that takes
# the key split, and one query row (a decode-like call).  Each case must run that body, launch once a call
# and give the same bits twice.
WGMMA_CASES = {
    "ragged_1000x1003": (((1, 4, 1000, 128), (1, 4, 1003, 128),
                          (1, 4, 1003, 128)), {}),
    "ragged_causal": (((1, 4, 1000, 128), (1, 4, 1003, 128),
                       (1, 4, 1003, 128)), dict(causal=True)),
    "negative_q_offset": (((1, 4, 1000, 128), (1, 4, 1003, 128),
                           (1, 4, 1003, 128)),
                          dict(causal=True, q_offset=-37, kv_valid=500)),
    "positive_q_offset": (((2, 8, 300, 128), (2, 2, 1152, 128),
                           (2, 2, 1152, 128)),
                          dict(causal=True, q_offset=200, kv_valid=500)),
    "kv_valid_0": (((1, 4, 300, 128), (1, 4, 300, 128), (1, 4, 300, 128)),
                   dict(kv_valid=0)),
    "kv_valid_1": (((1, 4, 300, 128), (1, 4, 300, 128), (1, 4, 300, 128)),
                   dict(kv_valid=1, causal=True, q_offset=5)),
    "d64_causal_gqa": (((2, 8, 300, 64), (2, 2, 300, 64), (2, 2, 300, 64)),
                       dict(causal=True)),
    "dk64_dv128": (((1, 4, 500, 64), (1, 4, 700, 64), (1, 4, 700, 128)),
                   dict(causal=True)),
    "dk128_dv64": (((1, 4, 500, 128), (1, 4, 700, 128), (1, 4, 700, 64)),
                   dict(softcap=30.0)),
    "4d_gqa_softcap": (((2, 8, 777, 128), (2, 2, 777, 128),
                        (2, 2, 777, 128)), dict(causal=True, softcap=50.0)),
    "thin_grid_split": (((8192, 128), (8192, 128), (8192, 128)), {}),
    "one_query_row": (((2, 8, 1, 128), (2, 2, 777, 128), (2, 2, 777, 128)),
                      dict(causal=True, q_offset=776)),
}


@pytest.mark.parametrize("name", list(WGMMA_CASES))
def test_flash_wgmma_body_matches_plain(gen, name):
    shapes, kw = WGMMA_CASES[name]
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               .to(torch.bfloat16) for s in shapes)
    plan = flash_launch_plan(q, k, v, kv_valid=kw.get("kv_valid"))
    assert plan["body"] == "wgmma"
    if name == "thin_grid_split":
        assert plan["splits"] > 1
    before = launch_counts()["flash_fwd"]
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_fwd"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    assert _share_of_limit(got, flash_attention_plain(q, k, v, **kw)) <= 1


@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_flash_wgmma_partials_match_plain(gen, split):
    """The partials epilogue of the wgmma body, unsplit (4-D causal GQA
    with a negative offset and softcap, 384 row blocks) and through the
    split's merge (one head, 8192 rows): row stats within 1e-5 of max(1,
    |value|), -inf where the plain version has it, the normalized output
    within `mismatch`."""
    shapes = (((8192, 128),) * 3 if split else
              ((4, 32, 300, 128), (4, 4, 1152, 128), (4, 4, 1152, 128)))
    kw = {} if split else dict(causal=True, q_offset=-37, kv_valid=500,
                               softcap=20.0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               .to(torch.bfloat16) for s in shapes)
    assert (flash_launch_plan(q, k, v, kv_valid=kw.get("kv_valid"))
            ["splits"] > 1) == split
    got = flash_attention_partials(q, k, v, **kw)
    again = flash_attention_partials(q, k, v, **kw)
    want = flash_attention_partials_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert torch.equal(got[1].isinf(), want[1].isinf())
    live = want[1].isfinite()
    for g, w in zip(got[1:], want[1:]):
        assert ((g - w)[live].abs() <= 1e-5 * w[live].abs().clamp(
            min=1)).all()
    norm = [(o / l_.clamp(min=1e-30)[..., None]).to(torch.bfloat16)
            for o, _, l_ in (got, want)]
    assert mismatch(*norm)[1] <= 1


def test_flash_wgmma_takes_the_layers_strided_operands(gen):
    """The training layer's call: (b, s, heads, d) storage viewed as
    (b, heads, s, d), b = 4, m = n = 2048, 32 q / 4 kv heads, causal,
    softcap 50; the partials it saves and the output."""
    b, s, h, hkv, d = 4, 2048, 32, 4, 128
    q, k, v = (torch.randn(b, s, heads, d, generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2)
               for heads in (h, hkv, hkv))
    kw = dict(causal=True, softcap=50.0)
    assert flash_launch_plan(q, k, v)["body"] == "wgmma"
    got = flash_attention_partials(q, k, v, **kw)
    want = flash_attention_partials_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[1:], want[1:]):
        assert ((g - w).abs() <= 1e-5 * w.abs().clamp(min=1)).all()
    norm = [(o / l_[..., None]).to(torch.bfloat16) for o, _, l_ in
            (got, want)]
    assert mismatch(*norm)[1] <= 1
    out = flash_attention(q, k, v, **kw)
    assert _share_of_limit(out, flash_attention_plain(q, k, v, **kw)) <= 1


def test_flash_wgmma_body_refuses_what_it_cannot_take(gen, monkeypatch):
    """The C side refuses a call the named body cannot take: f32 named
    "wgmma" raises, nothing launches and nothing falls back."""
    monkeypatch.setattr(flash_ops, "flash_body", lambda *a: "wgmma")
    q = torch.randn(2, 256, 128, generator=gen, device="cuda")
    before = launch_counts()["flash_fwd"]
    with pytest.raises(KernelLaunchError):
        flash_attention(q, q, q)
    assert launch_counts()["flash_fwd"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_matches_plain(gen, dtype):
    """Three decode slots, a 37-token prefill chunk, a prefill slot
    whose second page is unclaimed (poisoned by the append), pad."""
    hq, hkv, d, page, slots = 8, 2, 128, 128, 6
    specs = [(130, 1), (5, 1), (700, 1), (263, 37), (120, 20)]
    table = torch.full((slots, 8), -1, dtype=torch.int32)
    nxt = 0
    for s, (pre, n) in enumerate(specs):
        npages = -(-(pre + n) // page)
        table[s, :npages] = torch.arange(nxt, nxt + npages)
        nxt += npages
    table[4, 1] = -1
    width = packed_bucket(sum(n for _, n in specs))
    cu, pos, slot = [0], [], []
    for s, (pre, n) in enumerate(specs):
        cu.append(cu[-1] + n)
        pos += range(pre, pre + n)
        slot += [s] * n
    cu += [cu[-1]] * (slots + 1 - len(cu))
    pad = width - len(pos)

    def dev(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    step = RaggedPagedStep(
        rnd(nxt, hkv, page, d), rnd(nxt, hkv, page, d), table.cuda(),
        dev([pre for pre, _ in specs] + [0]), dev(cu), dev([3, 5]),
        dev(pos + [0] * pad), dev(slot + [-1] * pad), 40)
    step = ragged_paged_append(step, rnd(1, hkv, width, d),
                               rnd(1, hkv, width, d))
    assert step.kv_lens.tolist() == [131, 6, 701, 300, -1, 0]
    q = rnd(1, hq, width, d)
    before = launch_counts()["ragged_paged"]
    got = ragged_paged_attention(q, step, softcap=30.0)
    assert launch_counts()["ragged_paged"] == before + 1
    want = ragged_paged_attention_plain(q, step, softcap=30.0)
    assert _share_of_limit(got, want) <= 1
    assert got[:, :, cu[4]:cu[5]].isnan().all()
    assert (got[:, :, cu[5]:] == 0).all()
    # a grid sized for shorter spans strides over the same row blocks
    short = ragged_paged_attention(q, step._replace(q_tile=8), softcap=30.0)
    assert torch.equal(short.isnan(), got.isnan())
    assert torch.equal(short.nan_to_num(), got.nan_to_num())


# Steps at the serving geometry (32 q / 4 kv heads): (tokens, length after
# the append) per active slot, decode slots first, each slot its own
# pages, random pools; softcap 50 as the served model
RAGGED_STEPS = {
    "decode_only": ([(1, n) for n in (907, 926, 637, 733, 754, 269, 923,
                                      1024)], {}),
    "prefill_only": ([(256, 512), (256, 1024)], {}),
    "mixed_page64": ([(1, 553), (1, 64), (191, 959), (256, 300)],
                     {"page": 64}),
    "mixed_d64": ([(1, 100), (2, 700), (129, 1000)], {"d": 64}),
}


def _ragged_step(gen, spans, dtype, *, page=128, d=128, hq=32, hkv=4,
                 slots=10, capacity=2048):
    """(q as the attention layer passes it, the step) on the card."""
    max_pages = capacity // page
    table = torch.full((slots, max_pages), -1, dtype=torch.int32)
    cu, lens, nxt = [0], [], 0
    for s, (n, kv_len) in enumerate(spans):
        used = -(-kv_len // page)
        table[s, :used] = torch.arange(nxt, nxt + used)
        nxt += used
        cu.append(cu[-1] + n)
        lens.append(kv_len)
    cu += [cu[-1]] * (slots + 1 - len(cu))
    lens += [0] * (slots - len(lens))
    num_decode = sum(1 for n, _ in spans if n <= 2)
    longest = max(n for n, _ in spans[num_decode:]) if spans[num_decode:] \
        else 1
    q_tile = recommended_q_tile(longest, hq // hkv)
    width = packed_bucket(max(cu[-1], q_tile))

    def dev(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    step = RaggedPagedStep(
        rnd(nxt, hkv, page, d), rnd(nxt, hkv, page, d), table.cuda(),
        dev(lens), dev(cu), dev([num_decode, len(spans)]),
        dev([0] * width), dev([-1] * width), q_tile)
    return rnd(1, width, hq, d).transpose(1, 2), step


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(RAGGED_STEPS))
def test_ragged_kernel_serving_steps(gen, name, dtype):
    """Decode-only, prefill-only and mixed steps at the serving geometry,
    at page 64 and head dim 64: within the limit of the plain version,
    the same bits twice, one launch counted, pad rows zero; a dropped
    last key tile of the longest slot and a 2% scale error fail the
    check.  bf16 at head dim 128 runs the wgmma body."""
    spans, kw = RAGGED_STEPS[name]
    q, step = _ragged_step(gen, spans, dtype, **kw)
    plan = ragged_launch_plan(q, step, sms=torch.cuda.get_device_properties(
        0).multi_processor_count)
    print(name, dtype, plan)
    if dtype is torch.bfloat16:
        assert plan["body"] == "wgmma" and plan["kg"] == 4
        assert plan["splits"] > 1
    before = launch_counts()["ragged_paged"]
    got = ragged_paged_attention(q, step, softcap=50.0)
    assert launch_counts()["ragged_paged"] == before + 1
    again = ragged_paged_attention(q, step, softcap=50.0)
    assert torch.equal(got.view(torch.int16 if dtype is torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype is torch.bfloat16
                                  else torch.int32))
    want = ragged_paged_attention_plain(q, step, softcap=50.0)
    assert _share_of_limit(got, want) <= 1
    real = sum(n for n, _ in spans)
    assert (got[:, :, real:] == 0).all()
    lens = step.kv_lens.tolist()
    longest = max(range(len(spans)), key=lambda s: lens[s])
    cut = list(lens)
    cut[longest] -= (lens[longest] - 1) % 64 + 1
    planted = (
        ragged_paged_attention_plain(
            q, step._replace(kv_lens=torch.tensor(cut, dtype=torch.int32,
                                                  device="cuda")),
            softcap=50.0),
        ragged_paged_attention_plain(q, step, softcap=50.0,
                                     scale=1.02 * q.shape[-1] ** -0.5))
    for fault in planted:
        assert mismatch(fault, want)[1] > 1


def test_ragged_wrapper_raises_instead_of_falling_back(gen, monkeypatch):
    """A body the C entry cannot take is refused: no launch counted, no
    other body run."""
    q, step = _ragged_step(gen, RAGGED_STEPS["decode_only"][0],
                           torch.float32)
    monkeypatch.setattr(
        "attention_tpu_torch.ops.ragged_paged.ragged_body",
        lambda *args: "wgmma")
    before = launch_counts()["ragged_paged"]
    with pytest.raises(KernelLaunchError):
        ragged_paged_attention(q, step)
    assert launch_counts()["ragged_paged"] == before


# Flash calls with the sliding-window band: (dtype, shapes, kw).  The
# wgmma body takes bf16 at head dims 64/128, the FMA body the rest.
FLASH_WINDOW_CASES = {
    "wgmma_window_not_a_tile_multiple": (
        torch.bfloat16, ((1, 8, 1000, 128), (1, 2, 1000, 128),
                         (1, 2, 1000, 128)), dict(window=300)),
    "wgmma_sinks_overlap_the_band": (
        torch.bfloat16, ((2, 8, 777, 128), (2, 2, 777, 128),
                         (2, 2, 777, 128)),
        dict(window=100, sinks=130, softcap=50.0)),
    "wgmma_kv_valid_below_the_band": (
        torch.bfloat16, ((1, 8, 300, 128), (1, 2, 1152, 128),
                         (1, 2, 1152, 128)),
        dict(window=64, sinks=4, q_offset=800, kv_valid=500)),
    "wgmma_cached_prefill_d64": (
        torch.bfloat16, ((2, 8, 300, 64), (2, 2, 1152, 64),
                         (2, 2, 1152, 64)),
        dict(window=257, sinks=5, q_offset=600, kv_valid=900)),
    "wgmma_thin_grid_split": (
        torch.bfloat16, ((8192, 128),) * 3, dict(window=1024, sinks=4)),
    "fma_f32_dk_ne_dv": (
        torch.float32, ((4, 200, 64), (2, 333, 64), (2, 333, 96)),
        dict(window=100, sinks=5, q_offset=133)),
    "fma_bf16_d96": (
        torch.bfloat16, ((2, 4, 300, 96), (2, 2, 300, 96),
                         (2, 2, 300, 96)), dict(window=33, sinks=1)),
}


@pytest.mark.parametrize("name", list(FLASH_WINDOW_CASES))
def test_flash_window_matches_plain(gen, name):
    """The band on both bodies: within the plain version's limit, the
    same bits twice, one launch a call; a dropped sink tile and a band
    one key tile longer fail the check (where a row sees the band)."""
    dtype, shapes, kw = FLASH_WINDOW_CASES[name]
    kw = dict(kw, causal=True)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in shapes)
    plan = flash_launch_plan(q, k, v, kv_valid=kw.get("kv_valid"),
                             window=kw["window"], sinks=kw.get("sinks"))
    assert plan["body"] == name.split("_")[0]
    if name == "wgmma_thin_grid_split":
        assert plan["splits"] > 1
    before = launch_counts()["flash_fwd"]
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_fwd"] == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = flash_attention_plain(q, k, v, **kw)
    assert _share_of_limit(got, want) <= 1
    faults = [] if name.endswith("below_the_band") else [
        flash_attention_plain(q, k, v, **dict(kw, window=kw["window"] + 64))]
    if kw.get("sinks"):
        faults.append(flash_attention_plain(q, k, v, **dict(kw,
                                                            sinks=None)))
    for fault in faults:
        assert mismatch(fault, want)[1] > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_window_wider_than_the_sequence_is_causal_bits(gen, dtype):
    """A window past the sequence visits every causal tile and masks as
    causal alone: the same bits as the call without a window."""
    q, k, v = (torch.randn(2, 8, 500, 128, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    got = flash_attention(q, k, v, causal=True, window=100_000, sinks=3)
    torch.cuda.synchronize()
    assert torch.equal(got, flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_flash_window_partials_of_a_shard_that_sees_nothing(gen, dtype,
                                                            split):
    """Rows whose band lies past kv_valid, with no sinks, see nothing:
    output 0, row max -inf, sum 0; with sinks they see those alone."""
    # one head of 8192 rows leaves SMs idle (a key split); 48 heads of
    # 300 rows are 144 row blocks, more than the card's SMs (no split)
    heads, m, n = (1, 8192, 8192) if split else (48, 300, 1152)
    q, k, v = (torch.randn(heads, rows, 128, generator=gen, device="cuda")
               .to(dtype) for rows in (m, n, n))
    kw = dict(causal=True, window=64, q_offset=n, kv_valid=n // 2)
    if dtype is torch.bfloat16:
        assert (flash_launch_plan(q, k, v, kv_valid=n // 2, window=64)
                ["splits"] > 1) == split
    out, mx, sm = flash_attention_partials(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (out == 0).all() and (sm == 0).all()
    assert (mx == float("-inf")).all()
    assert (flash_attention(q, k, v, **kw) == 0).all()
    got = flash_attention_partials(q, k, v, sinks=3, **kw)
    want = flash_attention_partials_plain(q, k, v, sinks=3, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[1:], want[1:]):
        assert ((g - w).abs() <= 1e-5 * w.abs().clamp(min=1)).all()


RAGGED_WINDOW_STEPS = {
    "decode_only": (RAGGED_STEPS["decode_only"], dict(window=256, sinks=4)),
    "prefill_only": (RAGGED_STEPS["prefill_only"], dict(window=100)),
    "mixed_page64": (RAGGED_STEPS["mixed_page64"], dict(window=256,
                                                        sinks=4)),
    "mixed_d64": (RAGGED_STEPS["mixed_d64"], dict(window=300, sinks=130)),
    "mixed_mma_page48": (([(1, 553), (1, 64), (191, 959)], {"page": 48}),
                         dict(window=200, sinks=4)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(RAGGED_WINDOW_STEPS))
def test_ragged_window_matches_plain(gen, name, dtype):
    """The band in every body of the ragged kernel (decode slots' split,
    the wgmma prefill body, the mma body at page 48, FMA in f32): within
    the plain version's limit, the same bits twice, pad rows 0; a
    dropped sink tile and a band one key tile longer fail the check."""
    (spans, kw), band = RAGGED_WINDOW_STEPS[name]
    q, step = _ragged_step(gen, spans, dtype, **kw)
    plan = ragged_launch_plan(q, step, window=band["window"],
                              sms=torch.cuda.get_device_properties(
                                  0).multi_processor_count)
    if dtype is torch.bfloat16:
        assert plan["body"] == ("mma" if "mma" in name else "wgmma")
    got = ragged_paged_attention(q, step, softcap=50.0, **band)
    again = ragged_paged_attention(q, step, softcap=50.0, **band)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ragged_paged_attention_plain(q, step, softcap=50.0, **band)
    assert _share_of_limit(got, want) <= 1
    assert (got[:, :, sum(n for n, _ in spans):] == 0).all()
    faults = [ragged_paged_attention_plain(q, step, softcap=50.0, **dict(
        band, window=band["window"] + 64))]
    if band.get("sinks"):
        faults.append(ragged_paged_attention_plain(
            q, step, softcap=50.0, window=band["window"]))
    for fault in faults:
        assert mismatch(fault, want)[1] > 1


QUANTIZE = {"int8": quant.quantize_kv, "int4": quant.quantize_kv_int4,
            "int4_tok": quant.quantize_kv_int4_tok}
QUANT_OPS = {("int8", False): quant.flash_decode_quantized,
             ("int8", True): quant.flash_decode_quantized_chunk,
             ("int4", False): quant.flash_decode_int4,
             ("int4_tok", False): quant.flash_decode_int4_tok}


@pytest.mark.parametrize("fmt,s_new,kw", [
    ("int8", 0, {}), ("int8", 0, {"softcap": 30.0}),
    ("int8", 0, {"window": 100, "sinks": 4}), ("int8", 4, {"softcap": 30.0}),
    ("int8", 40, {"window": 64, "sinks": 4}), ("int4", 0, {"softcap": 30.0}),
    ("int4", 0, {"window": 100, "sinks": 4}),
    ("int4_tok", 0, {"softcap": 30.0}),
    ("int4_tok", 0, {"window": 100, "sinks": 4})],
    ids=["int8", "int8_softcap", "int8_window_sinks", "int8_chunk4",
         "int8_chunk40_window", "int4_softcap", "int4_window_sinks",
         "tok4_softcap", "tok4_window_sinks"])
def test_quant_kernels_match_plain(gen, fmt, s_new, kw):
    """Lengths 0, 1, 300, 777 and 1024: the odd ones end on a low nibble
    of the token-paired layout, whose partner is masked."""
    q, k, v, lens = _decode_case(gen, torch.bfloat16, s_new)
    cache = QUANTIZE[fmt](k, v)
    kernel = "quant_tok4" if fmt == "int4_tok" else "quant_decode"
    before = launch_counts()[kernel]
    got = QUANT_OPS[fmt, bool(s_new)](q, cache, lens, **kw)
    assert launch_counts()[kernel] == before + 1
    want = quant.quant_decode_plain(q, cache, lens, **kw)
    assert _share_of_limit(got, want) <= 1
    assert (got[0] == 0).all()      # length 0: a zero row


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quant_kernels_other_head_dims(gen, fmt, d):
    q = torch.randn(3, 8, d, generator=gen, device="cuda")
    k, v = (torch.randn(3, 2, 256, d, generator=gen, device="cuda")
            for _ in range(2))
    lens = torch.tensor([5, 129, 256], dtype=torch.int32, device="cuda")
    cache = QUANTIZE[fmt](k, v)
    got = QUANT_OPS[fmt, False](q, cache, lens, softcap=30.0)
    want = quant.quant_decode_plain(q, cache, lens, softcap=30.0)
    assert _share_of_limit(got, want) <= 1


@pytest.mark.parametrize("s_new", [1, 4])
def test_quant_overflow_comes_out_nan(gen, s_new):
    """An append past the capacity lands at the end with NaN scales: the
    kernel's row maxima (fmaxf) pass over a NaN score, so the NaN has to
    come through P and the row sum."""
    q, k, v, _ = _decode_case(gen, torch.bfloat16, s_new if s_new > 1 else 0)
    cache = quant.quantize_kv(k, v)
    n = cache.capacity
    k_new, v_new = (torch.randn(5, 2, s_new, 128, generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    quant.update_quantized_kv(cache, k_new, v_new, n - s_new + 1)
    assert cache.k_scale[:, :, -s_new:].isnan().all()
    got = QUANT_OPS["int8", s_new > 1](q, cache, n + 1)
    assert got.isnan().all()
    assert quant.quant_decode_plain(q, cache, n + 1).isnan().all()


# the key split of the quantized kernels: 3 sequences, 16 q / 2 kv heads
# (group 8), d 128, 1024 rows, so that one token takes KG = 4 (16-row
# CTAs) and the chunk of 4 (32 rows) 64-row blocks, both split
QUANT_SPLIT_CASES = {
    "int8": ("int8", 0, {}), "int8_softcap": ("int8", 0, {"softcap": 30.0}),
    "int8_window_sinks": ("int8", 0, {"window": 100, "sinks": 4}),
    "int8_chunk4": ("int8", 4, {"softcap": 30.0}),
    "int8_chunk4_window": ("int8", 4, {"window": 70, "sinks": 4}),
    "int4": ("int4", 0, {}), "int4_window_sinks": (
        "int4", 0, {"window": 100, "sinks": 4}),
    "tok4": ("int4_tok", 0, {}), "tok4_window_sinks": (
        "int4_tok", 0, {"window": 100, "sinks": 4}),
}


def _quant_split_case(gen, fmt, s_new, dtype=torch.bfloat16):
    b, h, hkv, n, d = 3, 16, 2, 1024, 128
    q = torch.randn(b, h, *([s_new] if s_new else []), d, generator=gen,
                    device="cuda").to(dtype)
    k, v = (torch.randn(b, hkv, n, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([0, 301, n], dtype=torch.int32, device="cuda")
    return q, QUANTIZE[fmt](k, v), lens


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("name", list(QUANT_SPLIT_CASES))
def test_quant_split_kernels_match_plain(gen, name):
    """Each format, one token (KG = 4) and the chunk of 4 (KG = 1), with
    more than one split: one launch per call, the same bits twice, within
    the plain version's limits, a zero row for length 0."""
    fmt, s_new, kw = QUANT_SPLIT_CASES[name]
    q, cache, lens = _quant_split_case(gen, fmt, s_new)
    plan = quant.launch_plan(q, cache, kw.get("window"), sms=_sms())
    assert plan["splits"] > 1
    assert plan["kg"] == (1 if s_new else 4)
    fn = QUANT_OPS[fmt, bool(s_new)]
    kernel = "quant_tok4" if fmt == "int4_tok" else "quant_decode"
    before = launch_counts()[kernel]
    got = _held_twice(lambda: fn(q, cache, lens, **kw),
                      lambda: quant.quant_decode_plain(q, cache, lens, **kw),
                      torch.bfloat16)
    assert launch_counts()[kernel] == before + 2
    assert (got[0] == 0).all()


@pytest.mark.parametrize("fmt", ["int8", "int4", "int4_tok"])
def test_quant_kernel_scales_q_as_the_wrapper_did(gen, fmt):
    """The kernel rounds q · fp32(scale·log2 e) to bf16 itself: the same
    bits as a q pre-scaled and rounded so (the wrapper's former work),
    launched with a scale whose factor is 1, for fp32 and bf16 q."""
    for dtype in (torch.float32, torch.bfloat16):
        q, cache, lens = _quant_split_case(gen, fmt, 0, dtype)
        fn = QUANT_OPS[fmt, False]
        scale = 0.7 * 128 ** -0.5
        pre = (q.float() * (scale * quant.LOG2E)).to(torch.bfloat16)
        got = fn(q, cache, lens, scale=scale, softcap=30.0)
        want = fn(pre, cache, lens, scale=1 / quant.LOG2E, softcap=30.0)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("scales", ["both", "keys"])
@pytest.mark.parametrize("fmt,s_new", [("int8", 1), ("int8", 4),
                                       ("int4", 1), ("int4_tok", 1)])
def test_quant_nan_window_comes_out_nan(gen, fmt, s_new, scales):
    """NaN scales on the last rows (an overflowing int8 append lands at the
    end and writes them for keys and values; "keys" poisons the key scales
    alone) and a window of 2 that leaves each row only those columns (one
    token: column n - 1 alone).  The key group and the split that see them
    (max -inf, sum NaN) must make every row NaN, as the plain version's
    amax does, where the other groups and splits saw nothing."""
    q, cache, _ = _quant_split_case(gen, fmt, s_new if s_new > 1 else 0)
    n = cache.capacity
    if fmt == "int8" and scales == "both":
        k_new, v_new = (torch.randn(3, 2, s_new, 128, generator=gen,
                                    device="cuda").to(torch.bfloat16)
                        for _ in range(2))
        quant.update_quantized_kv(cache, k_new, v_new, n - s_new + 1)
    else:
        cache.k_scale[:, :, -s_new:] = float("nan")
        if scales == "both":
            cache.v_scale[:, :, -s_new:] = float("nan")
    want = quant.quant_decode_plain(q, cache, n + 1, window=2)
    assert want.isnan().all()
    got = QUANT_OPS[fmt, s_new > 1](q, cache, n + 1, window=2)
    torch.cuda.synchronize()
    assert got.isnan().all()
    plan = quant.launch_plan(q, cache, 2, sms=_sms())
    assert plan["splits"] > 1 and plan["kg"] == (1 if s_new > 1 else 4)


def test_quant_wrapper_raises_instead_of_falling_back(gen):
    """A head dim past the kernels' 256, an odd int4 head dim and a q
    dtype they do not take raise on the card; no kernel launches and
    nothing falls back to the plain version."""
    before = launch_counts()
    q = torch.randn(2, 4, 257, generator=gen, device="cuda")
    k = torch.randn(2, 2, 128, 257, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dims up to 256"):
        quant.flash_decode_quantized(q, quant.quantize_kv(k, k), 10)
    odd = quant.Int4TokKV(
        *(torch.zeros(2, 2, 64, 33, dtype=torch.int8, device="cuda"),
          torch.ones(2, 2, 128, device="cuda")) * 2)
    with pytest.raises(ValueError, match="even"):
        quant.flash_decode_int4_tok(q[..., :33], odd, 10)
    cache = quant.quantize_kv(*(torch.randn(2, 2, 128, 64, generator=gen,
                                            device="cuda"),) * 2)
    with pytest.raises(TypeError):
        quant.flash_decode_quantized(
            torch.zeros(2, 4, 64, device="cuda", dtype=torch.float16),
            cache, 10)
    assert launch_counts() == before


# ------------------------------------------------------------- backward

BWD_CASES = {
    # 3-D GQA 6 q / 2 kv, causal with keys shifted past the first rows
    # (rows that see no key), kv_valid and softcap: tensor-core path
    "3d_gqa_offsets_softcap": (((6, 40, 64), (2, 56, 64), (2, 56, 64)),
                               dict(causal=True, q_offset=3, kv_offset=8,
                                    kv_valid=50, softcap=5.0)),
    # 4-D, two batches, non-causal, ragged edges, d 128
    "4d_noncausal_d128": (((2, 4, 130, 128), (2, 2, 200, 128),
                           (2, 2, 200, 128)), {}),
    # head dim 32 (the FMA loop in bf16 too), causal GQA
    "4d_causal_d32": (((2, 8, 100, 32), (2, 2, 100, 32), (2, 2, 100, 32)),
                      dict(causal=True)),
    # dk != dv
    "3d_dk64_dv128_softcap": (((4, 77, 64), (2, 91, 64), (2, 91, 128)),
                              dict(causal=True, softcap=20.0)),
}


def _bwd_case(gen, name, dtype):
    shapes, kw = BWD_CASES[name]
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in shapes)
    kw = dict(kw, scale=q.shape[-1] ** -0.5)
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return (q, k, v, out, lse, dout), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(BWD_CASES))
@pytest.mark.parametrize("path", ["fused", "pair"])
def test_backward_kernels_match_plain(gen, monkeypatch, path, name, dtype):
    args, kw = _bwd_case(gen, name, dtype)
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    before = launch_counts()
    got = flash_bwd.flash_backward(*args, **kw)
    after = launch_counts()
    want_launches = ({flash_bwd.FUSED: 1} if path == "fused"
                     else {flash_bwd.DQ: 1, flash_bwd.DKV: 1})
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == want_launches
    offsets = [kw.pop(name, None)
               for name in ("q_offset", "kv_offset", "kv_valid")]
    want = flash_bwd.flash_backward_plain(
        *args, **kw, **_offsets(args[1].shape[-2], *offsets))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.device.type == "cuda"
        assert grad_mismatch(g, w)[1] <= 1


@pytest.mark.parametrize("path", ["fused", "pair"])
def test_backward_kernels_take_the_layers_strided_operands(gen, monkeypatch,
                                                           path):
    """bf16 q/k/v/dO as the attention layer hands them over, (b, s,
    heads, d) viewed as (b, heads, s, d), with b = 2, causal GQA and
    softcap: the tensor-core kernels against the plain version."""
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    b, s, d = 2, 100, 64
    q, k, v, dout = (torch.randn((b, s, n, d), generator=gen, device="cuda")
                     .to(torch.bfloat16).transpose(1, 2) for n in (8, 2, 2, 8))
    kw = dict(scale=d ** -0.5, causal=True, softcap=30.0)
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    before = launch_counts()
    got = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
    assert sum(launch_counts().values()) - sum(before.values()) == (
        1 if path == "fused" else 2)
    want = flash_bwd.flash_backward_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert grad_mismatch(g, w)[1] <= 1


# The fused kernel's wgmma body (bf16, dk = dv = 64 or 128): head dims 64
# and 128, groups of 1, 4 and 8, causal or not, with and without softcap,
# m or n of 1, 127, 129 and 1000, kv_valid inside a block and 0, offsets
# of both signs and rows the forward fully masked (lse = -inf).  Each
# case must run that body, launch once a call and give dK and dV the same
# bits twice.
WGMMA_BWD_CASES = {
    "d128_group8_causal": (((1, 8, 300, 128), (1, 1, 300, 128)),
                           dict(causal=True)),
    "d64_group4_causal_softcap": (((2, 8, 257, 64), (2, 2, 257, 64)),
                                  dict(causal=True, softcap=30.0)),
    "d128_group1_m129_n127": (((2, 4, 129, 128), (2, 4, 127, 128)), {}),
    "d64_m1000_n129_softcap": (((1, 4, 1000, 64), (1, 1, 129, 64)),
                               dict(softcap=20.0)),
    "m1_causal": (((2, 8, 1, 128), (2, 2, 1000, 128)),
                  dict(causal=True, q_offset=999)),
    "n1": (((1, 8, 127, 128), (1, 2, 1, 128)), {}),
    "kv_valid_offsets_masked_rows": (((1, 8, 1000, 128), (1, 2, 1003, 128)),
                                     dict(causal=True, q_offset=3,
                                          kv_offset=40, kv_valid=900)),
    "negative_q_offset_softcap": (((1, 4, 500, 128), (1, 4, 600, 128)),
                                  dict(causal=True, q_offset=-37,
                                       softcap=50.0)),
    "kv_valid_0": (((1, 4, 100, 64), (1, 2, 200, 64)), dict(kv_valid=0)),
}


def _check_wgmma_backward(q, k, v, dout, kw):
    """The fused call on the wgmma body, once a call, within
    `grad_mismatch` of the plain version, dK and dV the same bits on a
    second call.  Where every row sees one key (n = 1), dS = P·(dP -
    delta) cancels: dQ and dK are 0 in exact arithmetic and each side
    keeps its own float32 residues (about 1e-6 against dV's 20), so they
    are held within 1e-4 absolute."""
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    offsets = {x: kw[x] for x in ("q_offset", "kv_offset", "kv_valid")
               if x in kw}
    plan = flash_bwd.bwd_launch_plan(q, k, v, out, lse, dout,
                                     causal=kw.get("causal", False),
                                     **offsets)
    assert plan["body"] == "wgmma"
    before = launch_counts()
    got = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
    again = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
    after = launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {flash_bwd.FUSED: 2}
    want = flash_bwd.flash_backward_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got[1:], again[1:]):
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))
    one_key = k.shape[-2] == 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        if one_key and i < 2:
            assert (g.float() - w.float()).abs().max().item() <= 1e-4
        else:
            assert grad_mismatch(g, w)[1] <= 1


@pytest.mark.parametrize("name", list(WGMMA_BWD_CASES))
def test_wgmma_backward_matches_plain(gen, name):
    (qshape, kshape), kw = WGMMA_BWD_CASES[name]
    q, dout = (torch.randn(qshape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in "qo")
    k, v = (torch.randn(kshape, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in "kv")
    _check_wgmma_backward(q, k, v, dout, dict(kw, scale=qshape[-1] ** -0.5))


def test_wgmma_backward_takes_the_layers_strided_operands(gen):
    """(b, s, heads, d) storage viewed as (b, heads, s, d) at d 128, 8 q /
    2 kv heads, causal, softcap 50."""
    q, k, v, dout = (torch.randn((2, 300, n, 128), generator=gen,
                                 device="cuda")
                     .to(torch.bfloat16).transpose(1, 2) for n in (8, 2, 2, 8))
    _check_wgmma_backward(q, k, v, dout, dict(scale=128 ** -0.5, causal=True,
                                              softcap=50.0))


def test_fp32_and_unaligned_backward_take_the_fma_body(gen):
    """fp32, and bf16 whose rows are not 16-byte aligned, run the fused
    kernel's FMA body, within `grad_mismatch` of the plain version."""
    x = torch.randn((4, 90, 64), generator=gen, device="cuda")
    kv = torch.randn((2, 90, 64), generator=gen, device="cuda")
    odd = torch.randn((4, 90, 65), generator=gen, device="cuda").to(
        torch.bfloat16)[..., 1:]
    for q, k, dout in ((x, kv, x), (odd, odd[:2], odd)):
        kw = dict(scale=0.125, causal=True)
        out, lse = _flash_fwd_impl(q, k, k, **kw)
        assert flash_bwd.bwd_launch_plan(q, k, k, out, lse, dout,
                                         causal=True)["body"] == "fma"
        got = flash_bwd.flash_backward(q, k, k, out, lse, dout, **kw)
        want = flash_bwd.flash_backward_plain(q, k, k, out, lse, dout, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert grad_mismatch(g, w)[1] <= 1


def test_wgmma_backward_refuses_what_it_cannot_take(gen, monkeypatch):
    """The C side refuses a call the named body cannot take: f32 named
    "wgmma" raises, nothing launches and nothing falls back."""
    monkeypatch.setattr(flash_bwd, "flash_bwd_body", lambda *a: "wgmma")
    monkeypatch.setattr(flash_bwd, "bwd_work_plan",
                        lambda *a, **k: flash_bwd.WorkPlan(1, 1, 1, 1, 1.0))
    q = torch.randn((2, 128, 64), generator=gen, device="cuda")
    out, lse = _flash_fwd_impl(q, q, q, scale=0.125)
    before = launch_counts()
    with pytest.raises(KernelLaunchError):
        flash_bwd.flash_backward(q, q, q, out, lse, q, scale=0.125)
    assert launch_counts() == before


# The dQ and dK/dV pair on its wgmma bodies: the fused cases above and the
# layer's strided views, run as a user runs them (`_FORCE_TWO_KERNEL`).
def _check_wgmma_pair(monkeypatch, q, k, v, dout, kw):
    """The pair on the wgmma bodies, each kernel once a call, dQ, dK and
    dV within `grad_mismatch` of the plain version (1e-4 absolute for the
    cancelled dQ and dK of one-key rows, as above) and the same bits on a
    second call; a dropped last key tile in dK and a 2% scale error in dQ
    fail the same check."""
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", True)
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    offsets = {x: kw[x] for x in ("q_offset", "kv_offset", "kv_valid")
               if x in kw}
    plan = flash_bwd.bwd_launch_plan(q, k, v, out, lse, dout,
                                     causal=kw.get("causal", False),
                                     **offsets)["pair"]
    assert plan["body"] == "wgmma"
    assert plan["slices"] == flash_bwd.bwd_launch_plan(
        q, k, v, out, lse, dout, causal=kw.get("causal", False),
        **offsets)["slices"]
    before = launch_counts()
    got = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
    again = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
    after = launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {flash_bwd.DQ: 2, flash_bwd.DKV: 2}
    want = flash_bwd.flash_backward_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))
    one_key = k.shape[-2] == 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        if one_key and i < 2:
            assert (g.float() - w.float()).abs().max().item() <= 1e-4
        else:
            assert grad_mismatch(g, w)[1] <= 1
    # the faults: the last 64 keys that any row sees dropped from dK, and
    # dQ's scale 2% off
    seen = kw.get("kv_valid", k.shape[-2])
    if kw.get("causal"):
        seen = min(seen, q.shape[-2] + kw.get("q_offset", 0)
                   - kw.get("kv_offset", 0))
    if not one_key and seen > 64:
        dropped = flash_bwd.flash_backward_plain(
            q, k, v, out, lse, dout, **dict(kw, kv_valid=seen - 64))[1]
        off = flash_bwd.flash_backward_plain(
            q, k, v, out, lse, dout, **dict(kw, scale=1.02 * kw["scale"]))[0]
        assert grad_mismatch(dropped, want[1])[1] > 1
        assert grad_mismatch(off, want[0])[1] > 1


@pytest.mark.parametrize("name", list(WGMMA_BWD_CASES))
def test_wgmma_pair_matches_plain(gen, monkeypatch, name):
    (qshape, kshape), kw = WGMMA_BWD_CASES[name]
    q, dout = (torch.randn(qshape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in "qo")
    k, v = (torch.randn(kshape, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in "kv")
    _check_wgmma_pair(monkeypatch, q, k, v, dout,
                      dict(kw, scale=qshape[-1] ** -0.5))


@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_pair_takes_the_layers_strided_operands(gen, monkeypatch, d):
    """(b, s, heads, d) storage viewed as (b, heads, s, d), 8 q / 2 kv
    heads, causal, softcap 50."""
    q, k, v, dout = (torch.randn((2, 300, n, d), generator=gen,
                                 device="cuda")
                     .to(torch.bfloat16).transpose(1, 2) for n in (8, 2, 2, 8))
    _check_wgmma_pair(monkeypatch, q, k, v, dout,
                      dict(scale=d ** -0.5, causal=True, softcap=50.0))


@pytest.mark.parametrize("slices", [1, 2])
def test_wgmma_pair_variants_and_slices(gen, monkeypatch, slices):
    """Both output variants of the dK/dV body, one slice (dK and dV
    written in bf16, no sum) and two (fp32 partials the wrapper sums):
    within `grad_mismatch` of the plain version, the same bits twice,
    causal with offsets, kv_valid, softcap."""
    plan_of = flash_bwd.bwd_work_plan

    def forced(*args, **kw):
        plan = plan_of(*args, **kw)
        return plan._replace(slices=slices,
                             items=plan.items // plan.slices * slices)

    monkeypatch.setattr(flash_bwd, "bwd_work_plan", forced)
    q, dout = (torch.randn((2, 8, 700, 128), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in "qo")
    k, v = (torch.randn((2, 2, 650, 128), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in "kv")
    kw = dict(scale=128 ** -0.5, causal=True, q_offset=40, kv_offset=3,
              kv_valid=600, softcap=30.0)
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    staged = flash_bwd._Staged(q, k, v, out, lse, dout, **kw)
    assert staged.pair_plan["slices"] == slices
    bufs = staged.pair_buffers()
    assert bufs["dk"].dtype == (torch.bfloat16 if slices == 1
                                else torch.float32)
    assert bufs["dk"].dim() == (4 if slices == 1 else 5)
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", True)
    got = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
    again = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
    want = flash_bwd.flash_backward_plain(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))
        assert grad_mismatch(g, w)[1] <= 1


def test_fp32_and_unaligned_pair_take_the_fma_bodies(gen, monkeypatch):
    """fp32, and bf16 whose rows are not 16-byte aligned, run the pair's
    FMA bodies, within `grad_mismatch` of the plain version."""
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", True)
    x = torch.randn((4, 90, 64), generator=gen, device="cuda")
    kv = torch.randn((2, 90, 64), generator=gen, device="cuda")
    odd = torch.randn((4, 90, 65), generator=gen, device="cuda").to(
        torch.bfloat16)[..., 1:]
    for q, k, dout in ((x, kv, x), (odd, odd[:2], odd)):
        kw = dict(scale=0.125, causal=True)
        out, lse = _flash_fwd_impl(q, k, k, **kw)
        assert flash_bwd.bwd_launch_plan(q, k, k, out, lse, dout,
                                         causal=True)["pair"] == dict(
            body="fma", slices=1)
        got = flash_bwd.flash_backward(q, k, k, out, lse, dout, **kw)
        want = flash_bwd.flash_backward_plain(q, k, k, out, lse, dout, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert grad_mismatch(g, w)[1] <= 1


def test_wgmma_pair_refuses_what_it_cannot_take(gen, monkeypatch):
    """Each pair entry refuses a call its named body cannot take: f32
    named "wgmma" raises at the dQ kernel, nothing launches and nothing
    falls back; dK/dV slices that do not divide the GQA group raise
    too."""
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", True)
    monkeypatch.setattr(flash_bwd, "flash_bwd_body", lambda *a: "wgmma")
    monkeypatch.setattr(flash_bwd, "bwd_work_plan",
                        lambda *a, **k: flash_bwd.WorkPlan(1, 1, 1, 1, 1.0))
    q = torch.randn((2, 128, 64), generator=gen, device="cuda")
    out, lse = _flash_fwd_impl(q, q, q, scale=0.125)
    before = launch_counts()
    with pytest.raises(KernelLaunchError):
        flash_bwd.flash_backward(q, q, q, out, lse, q, scale=0.125)
    assert launch_counts() == before
    monkeypatch.undo()
    b16 = q.to(torch.bfloat16)
    out, lse = _flash_fwd_impl(b16, b16, b16, scale=0.125)
    staged = flash_bwd._Staged(b16[None], b16[None], b16[None], out[None],
                               lse[None], b16[None], scale=0.125,
                               causal=False, softcap=None, q_offset=0,
                               kv_offset=0, kv_valid=128)
    assert staged.pair_plan["body"] == "wgmma"
    staged.pair_plan["slices"] = 2  # a group of one q head
    with pytest.raises(KernelLaunchError):
        staged.pair(flash_bwd.DKV, **{k: t for k, t in
                                      staged.pair_buffers().items()
                                      if k != "dq"})


def test_bwd_impl_xla_runs_the_plain_backward_on_the_card(gen):
    """``bwd_impl="xla"`` selects the plain blocked recompute on any
    device: on the card it launches no backward kernel, and its gradients
    agree with the default path's (the kernels)."""
    q, k, v = (torch.randn(s, generator=gen, device="cuda")
               .to(torch.bfloat16) for s in ((4, 90, 64), (2, 90, 64),
                                             (2, 90, 64)))
    w = torch.randn((4, 90, 64), generator=gen, device="cuda")
    grads = []
    for impl in ("pallas", "xla"):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        before = launch_counts()
        out = flash_attention_diff(*qkv, causal=True, softcap=20.0,
                                   bwd_impl=impl, bwd_chunk=32)
        (out.float() * w).sum().backward()
        launched = {n: c - before[n] for n, c in launch_counts().items()
                    if c != before[n]}
        assert launched == ({"flash_fwd": 1, flash_bwd.FUSED: 1}
                            if impl == "pallas" else {"flash_fwd": 1})
        grads.append([t.grad for t in qkv])
    torch.cuda.synchronize()
    for mine, kernel in zip(grads[1], grads[0]):
        assert grad_mismatch(kernel, mine)[1] <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partials_kernel_matches_plain(gen, dtype):
    (q, k, v, _, _, _), kw = _bwd_case(gen, "3d_gqa_offsets_softcap", dtype)
    before = launch_counts()["flash_fwd"]
    got = flash_attention_partials(q, k, v, **kw)
    assert launch_counts()["flash_fwd"] == before + 1
    want = flash_attention_partials_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[1].isinf(), want[1].isinf())
    live = want[1].isfinite()
    for g, w in zip(got[1:], want[1:]):
        assert ((g - w)[live].abs() <= 1e-5 * w[live].abs().clamp(
            min=1)).all()
    norm = [(o / l_.clamp(min=1e-30)[..., None]).to(dtype)
            for o, _, l_ in (got, want)]
    assert mismatch(*norm)[1] <= 1


def test_backward_wrapper_raises_instead_of_falling_back(gen):
    """A dtype or head dim the kernels do not take raises on the card; no
    kernel launches and nothing falls back to the plain version."""
    before = launch_counts()
    x16 = torch.zeros(2, 8, 16, device="cuda", dtype=torch.float16)
    lse = torch.zeros(2, 8, device="cuda")
    with pytest.raises(TypeError):
        flash_bwd.flash_backward(x16, x16, x16, x16, lse, x16, scale=0.25)
    big = torch.zeros(2, 8, 257, device="cuda")
    with pytest.raises(ValueError, match="head dims 257/257 exceed 256"):
        flash_bwd.flash_backward(big, big, big, big, lse, big, scale=0.1)
    assert launch_counts() == before


# The backward kernels over a sliding-window band (`-k window_bwd`): the
# fused kernel and the pair, held to `flash_backward_plain` over the whole
# band-and-sink mask, the kernels taking the band and `sink_patch` the
# sinks.  bf16 at d 128 and 64 on the wgmma bodies (a window wider than a
# key block, one under a query tile, GQA 4, softcap); the edges (m 1000, n
# 1003, kv_valid 900, window 200 and 3 sinks, q_offset 37, so the band
# leaves the sinks behind after row 166); f32 and an odd head dim on the
# FMA bodies.  Each: the expected launches, the same dK and dV bits on a
# second call (the pair's dQ too), the wgmma body where bf16 d 64/128.
WINDOW_BWD_CASES = {
    "bf16_d128_window300_sinks4": (
        torch.bfloat16, ((2, 8, 700, 128), (2, 2, 700, 128)),
        dict(window=300, sinks=4)),
    "bf16_d64_window50_softcap": (
        torch.bfloat16, ((1, 8, 500, 64), (1, 2, 500, 64)),
        dict(window=50, softcap=30.0)),
    "bf16_edges_window200_sinks3": (
        torch.bfloat16, ((2, 8, 1000, 128), (2, 2, 1003, 128)),
        dict(window=200, sinks=3, q_offset=37, kv_valid=900,
             softcap=50.0)),
    "f32_fma_window100_sinks5": (
        torch.float32, ((3, 150, 40), (1, 190, 40)),
        dict(window=100, sinks=5, q_offset=20)),
}


def _window_bwd_case(gen, name):
    dtype, (qshape, kshape), kw = WINDOW_BWD_CASES[name]
    q, dout = (torch.randn(qshape, generator=gen, device="cuda").to(dtype)
               for _ in "qo")
    k, v = (torch.randn(kshape, generator=gen, device="cuda").to(dtype)
            for _ in "kv")
    kw = dict(kw, causal=True, scale=qshape[-1] ** -0.5)
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    return (q, k, v, out, lse, dout), kw


@pytest.mark.parametrize("name", list(WINDOW_BWD_CASES))
@pytest.mark.parametrize("path", ["fused", "pair"])
def test_window_bwd_kernels_match_plain(gen, monkeypatch, path, name):
    args, kw = _window_bwd_case(gen, name)
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    q, k = args[:2]
    plan = flash_bwd.bwd_launch_plan(
        *args, causal=True, window=kw["window"],
        **{x: kw[x] for x in ("q_offset", "kv_valid") if x in kw})
    wgmma = q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128)
    assert plan["body"] == plan["pair"]["body"] == (
        "wgmma" if wgmma else "fma")
    before = launch_counts()
    got = flash_bwd.flash_backward(*args, **kw)
    again = flash_bwd.flash_backward(*args, **kw)
    after = launch_counts()
    want_launches = ({flash_bwd.FUSED: 2} if path == "fused"
                     else {flash_bwd.DQ: 2, flash_bwd.DKV: 2})
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == want_launches
    want = flash_bwd.flash_backward_plain(*args, **kw)
    torch.cuda.synchronize()
    ints = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
    for g, a in list(zip(got, again))[path == "fused":]:
        assert torch.equal(g.view(ints), a.view(ints))
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and g.shape == w.shape
        assert grad_mismatch(g, w)[1] <= 1
    # the band one key tile longer, and the sinks left out, fail the check
    longer = flash_bwd.flash_backward_plain(
        *args, **dict(kw, window=kw["window"] + 64))
    assert max(grad_mismatch(g, w)[1] for g, w in zip(longer, want)) > 1
    if "sinks" in kw:
        no_sinks = flash_bwd.flash_backward_plain(
            *args, **dict(kw, sinks=None))
        assert max(grad_mismatch(g, w)[1]
                   for g, w in zip(no_sinks, want)) > 1


@pytest.mark.parametrize("path", ["fused", "pair"])
def test_window_bwd_wider_than_the_sequence_is_causal_bits(gen, monkeypatch,
                                                            path):
    """A window that covers every row's keys walks the causal call's tiles
    and masks the same pairs: dK and dV (the pair's dQ too) are the
    causal call's bits."""
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    args, kw = _window_bwd_case(gen, "bf16_d128_window300_sinks4")
    kw = {x: kw[x] for x in ("causal", "scale")}
    causal = flash_bwd.flash_backward(*args, **kw)
    wide = flash_bwd.flash_backward(*args, window=args[0].shape[-2], **kw)
    torch.cuda.synchronize()
    for c, w in list(zip(causal, wide))[path == "fused":]:
        assert torch.equal(c.view(torch.int16), w.view(torch.int16))


def test_window_bwd_training_step_matches_cpu():
    """One step of `make_train_step` on a small f32 windowed model with
    sinks on the card (the FMA kernels and the sink patch) and on the CPU
    from the same weights: the same loss to 1e-5 and every gradient
    within grad_mismatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from attention_tpu_torch.models import TinyDecoder, init_params, \
        make_train_step
    from attention_tpu_torch.models.train import ADAMW

    cfg = dict(vocab=64, dim=128, depth=2, num_q_heads=4, num_kv_heads=2,
               rope=True, softcap=30.0, dtype=torch.float32, window=24,
               attn_sinks=4)
    cpu = TinyDecoder(device="cpu", **cfg)
    cpu.load_state_dict(init_params(cpu, 0))
    card = TinyDecoder(device="cuda", **cfg)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, 64, (2, 97), generator=torch.Generator()
                           .manual_seed(0))
    losses, grads = [], []
    for m in (cpu, card):
        step = make_train_step(m, torch.optim.AdamW(m.parameters(), lr=1e-3,
                                                    **ADAMW))
        losses.append(step(tokens.to(m.device)).item())
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
    assert abs(losses[0] - losses[1]) <= 1e-5
    for k, g in grads[0].items():
        assert grad_mismatch(grads[1][k], g)[1] <= 1, k


def test_tiny_train_step_matches_cpu():
    """One step of `make_train_step` on a small f32 model (head dim 32:
    the FMA kernels) on the card and on the CPU from the same weights:
    the same loss to 1e-5 and every gradient within grad_mismatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from attention_tpu_torch.models import TinyDecoder, init_params, \
        make_train_step
    from attention_tpu_torch.models.train import ADAMW

    cfg = dict(vocab=64, dim=128, depth=2, num_q_heads=4, num_kv_heads=2,
               rope=True, softcap=30.0, dtype=torch.float32)
    cpu = TinyDecoder(device="cpu", **cfg)
    cpu.load_state_dict(init_params(cpu, 0))
    card = TinyDecoder(device="cuda", **cfg)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, 64, (2, 97), generator=torch.Generator()
                           .manual_seed(0))
    losses, grads = [], []
    for m in (cpu, card):
        step = make_train_step(m, torch.optim.AdamW(m.parameters(), lr=1e-3,
                                                    **ADAMW))
        losses.append(step(tokens.to(m.device)).item())
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
    assert abs(losses[0] - losses[1]) <= 1e-5
    for k, g in grads[0].items():
        assert grad_mismatch(grads[1][k], g)[1] <= 1, k


def test_moe_train_step_and_generate_match_cpu():
    """A small f32 MoE model (4 experts, top 2, capacity factor 1.25, so
    that pairs are dropped) on the card and on the CPU from the same
    weights: greedy `generate` streams equal, and one step of
    `make_train_step` with the same loss to 1e-5 and every gradient,
    the router's included, within grad_mismatch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from attention_tpu_torch.models import TinyDecoder, init_params, \
        make_train_step
    from attention_tpu_torch.models import decode as gen
    from attention_tpu_torch.models.train import ADAMW

    cfg = dict(vocab=64, dim=128, depth=2, num_q_heads=4, num_kv_heads=2,
               rope=True, softcap=30.0, dtype=torch.float32, moe_experts=4)
    cpu = TinyDecoder(device="cpu", **cfg)
    cpu.load_state_dict(init_params(cpu, 0))
    card = TinyDecoder(device="cuda", **cfg)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, 64, (2, 97), generator=torch.Generator()
                           .manual_seed(0))
    streams = [gen.generate(m, tokens[:, :40].to(m.device), steps=8).cpu()
               for m in (cpu, card)]
    assert torch.equal(*streams)
    losses, grads = [], []
    for m in (cpu, card):
        step = make_train_step(m, torch.optim.AdamW(m.parameters(), lr=1e-3,
                                                    **ADAMW))
        losses.append(step(tokens.to(m.device)).item())
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
    assert abs(losses[0] - losses[1]) <= 1e-5
    assert any("router" in k for k in grads[0])
    for k, g in grads[0].items():
        assert grad_mismatch(grads[1][k], g)[1] <= 1, k


def test_checkpoint_round_trip_on_the_card(tmp_path, monkeypatch):
    """A bf16 MoE model trained on the card with float32 masters (head
    dim 64: the wgmma kernels) on the dQ + dK/dV pair, whose gradients
    are the same bits every call: two steps, a checkpoint, a fresh
    model and optimizer restored from it, and the third step give the
    straight run's third loss and state, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from attention_tpu_torch.models import TinyDecoder, init_train, \
        make_train_step, restore_checkpoint, save_checkpoint

    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", True)
    cfg = dict(vocab=64, dim=128, depth=2, num_q_heads=2, num_kv_heads=1,
               rope=True, dtype=torch.bfloat16, device="cuda",
               moe_experts=4)
    tokens = torch.randint(0, 64, (2, 129), generator=torch.Generator()
                           .manual_seed(1)).cuda()
    model = TinyDecoder(**cfg)
    optimizer = init_train(model, seed=0)
    step = make_train_step(model, optimizer)
    straight = [step(tokens).item() for _ in range(3)]
    want = {k: m.clone() for k, m in optimizer.masters.items()}

    model = TinyDecoder(**cfg)
    optimizer = init_train(model, seed=0)
    step = make_train_step(model, optimizer)
    first = [step(tokens).item() for _ in range(2)]
    save_checkpoint(tmp_path, 2, model, optimizer)
    fresh = TinyDecoder(**cfg)
    fresh_opt = init_train(fresh, seed=1)
    assert restore_checkpoint(tmp_path, fresh, fresh_opt) == 2
    third = make_train_step(fresh, fresh_opt)(tokens).item()
    assert first + [third] == straight
    for k, m in fresh_opt.masters.items():
        assert torch.equal(m, want[k]), k
    for k, p in fresh.named_parameters():
        assert torch.equal(p.detach(), want[k].to(p.dtype)), k


# --------------------------------------- the distributed backends (gloo)

GLOO_CASES = {
    # name: (dtype, keywords, flash launches a call on each rank)
    "kv_bf16_causal": (torch.bfloat16, dict(causal=True), 1),
    "kv_f32": (torch.float32, {}, 1),
    "ring_bf16_causal": (torch.bfloat16, dict(causal=True), 2),
    "ring_zigzag_bf16": (torch.bfloat16,
                         dict(causal=True, schedule="zigzag"), 6),
}


def _gloo_card_rank(rank, world, init_file, out_dir):
    """One rank of a gloo world on cuda:0: each case against one
    `flash_attention` call on the same inputs, with its launch count."""
    import torch.distributed as dist

    from attention_tpu_torch.parallel import kv_sharded_attention, \
        ring_attention

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        out = {}
        for name, (dtype, kw, _) in GLOO_CASES.items():
            gen = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn((1, heads, 1000, 128), generator=gen,
                                   device="cuda").to(dtype)
                       for heads in (8, 2, 2))
            fn = kv_sharded_attention if name.startswith("kv") \
                else ring_attention
            before = launch_counts()["flash_fwd"]
            got = fn(q, k, v, **kw)
            launches = launch_counts()["flash_fwd"] - before
            want = flash_attention(q, k, v, causal=kw.get("causal", False))
            out[name] = dict(out=got.cpu(), launches=launches,
                             share=_share_of_limit(got, want))
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_card_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.multiprocessing as mp

    from attention_tpu_torch.ops import build

    build(["flash_fwd"])
    out = tmp_path_factory.mktemp("gloo_card")
    mp.spawn(_gloo_card_rank, nprocs=2,
             args=(2, str(out / "init"), str(out)))
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", list(GLOO_CASES))
def test_gloo_world_on_one_card_matches_flash(gloo_card_world, name):
    """kv-sharded and ring on a 2-rank gloo world on cuda:0: within
    `mismatch` of one flash call, the same bits on both ranks, the
    kernel launched as many times a call as the backend's table says
    (1 partials; R; 3R for zigzag)."""
    ranks = [r[name] for r in gloo_card_world]
    assert all(r["launches"] == GLOO_CASES[name][2] for r in ranks)
    assert all(r["share"] <= 1 for r in ranks)
    assert torch.equal(ranks[0]["out"], ranks[1]["out"])


@pytest.mark.parametrize("path", ["fused", "pair"])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_seq2seq_noncausal_backward_matches_plain(gen, monkeypatch, path,
                                                 softcap):
    """The encoder-decoder's cross-attention backward: non-causal, m =
    113 queries (the last 64-row query tile partly padding) over n = 512
    keys, 32 q / 4 kv heads, d 128, bf16, as the layer hands q, k, v and
    dO over, b = 2: the wgmma bodies against the plain version, and the
    encoder's m = n = 512 beside it."""
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    for m, n in ((113, 512), (512, 512)):
        q, dout = (torch.randn((2, m, 32, 128), generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for _ in "qo")
        k, v = (torch.randn((2, n, 4, 128), generator=gen, device="cuda")
                .to(torch.bfloat16).transpose(1, 2) for _ in "kv")
        kw = dict(scale=128 ** -0.5, causal=False, softcap=softcap)
        out, lse = _flash_fwd_impl(q, k, v, **kw)
        plan = flash_bwd.bwd_launch_plan(q, k, v, out, lse, dout)
        assert plan["body"] == plan["pair"]["body"] == "wgmma"
        got = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
        want = flash_bwd.flash_backward_plain(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert grad_mismatch(g, w)[1] <= 1, (m, n)


def test_seq2seq_cross_step_one_query_row_matches_plain(gen):
    """The cross-attention's decode step: one query row (m = 1) over 512
    memory rows, non-causal, softcap 50, b = 8, 32 q / 4 kv heads: the
    flash kernel's "wgmma" body, once, against the plain version and
    the decode kernel on the same inputs."""
    q = torch.randn((8, 32, 1, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((8, 4, 512, 128), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in "kv")
    assert flash_launch_plan(q, k, v)["body"] == "wgmma"
    before = launch_counts()["flash_fwd"]
    got = flash_attention(q, k, v, softcap=50.0)
    assert launch_counts()["flash_fwd"] == before + 1
    assert _share_of_limit(got, flash_attention_plain(q, k, v,
                                                      softcap=50.0)) <= 1
    assert _share_of_limit(got[:, :, 0], flash_decode(
        q[:, :, 0], k, v, 512, softcap=50.0)) <= 1


@pytest.mark.parametrize("kind", ["ragged", "int8", "paged"])
def test_speculative_verify_after_a_rewind_masks_stale_rows(gen, kind):
    """Speculative verify's rollback: a chunk of 5 written at length 100
    (rejected), the length rewound to 97 and a new chunk of 5 written
    there, so that rows 102-104 past the new length still hold the
    rejected chunk.  Poisoned with NaN (int8: NaN scales), they must not
    reach the output: the chunk kernel masks by length, finite and
    within `mismatch` of the plain version on the same cache with those
    rows zeroed (the plain version multiplies them by a P of 0)."""
    from attention_tpu_torch.ops.paged import PagePool, \
        paged_append_chunk, paged_from_dense

    b, h, hkv, n, d, s = 1, 32, 4, 256, 128, 5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    k, v = randn(b, hkv, n, d), randn(b, hkv, n, d)
    stale, fresh = ((randn(b, hkv, s, d), randn(b, hkv, s, d))
                    for _ in range(2))
    q = randn(b, h, s, d)
    if kind == "int8":
        cache = quant.update_quantized_kv(quant.quantize_kv(k, v), *stale,
                                          100)
        cache = quant.update_quantized_kv(cache, *fresh, 97)
        stale_rows = [t[:, :, 102:105] for t in (cache.k_scale,
                                                  cache.v_scale)]
    elif kind == "ragged":
        k[:, :, 100:105], v[:, :, 100:105] = stale
        k[:, :, 97:102], v[:, :, 97:102] = fresh
        cache = (k, v)
        stale_rows = [t[:, :, 102:105] for t in cache]
    else:
        cache = paged_from_dense(k, v, [100], PagePool(2), num_pages=2,
                                 total_pages_per_seq=2)
        cache = paged_append_chunk(cache, *stale)
        cache = paged_append_chunk(cache._replace(
            lengths=torch.full_like(cache.lengths, 97)), *fresh)
        assert cache.lengths.tolist() == [102]
        page = int(cache.page_table[0, 0])
        stale_rows = [t[page, :, 102:105] for t in (cache.k_pool,
                                                     cache.v_pool)]

    def run(kernel):
        if kind == "int8":
            fn = quant.flash_decode_quantized_chunk if kernel else \
                quant.quant_decode_plain
            return fn(q, cache, 102)
        if kind == "ragged":
            fn = flash_decode_chunk if kernel else flash_decode_plain
            return fn(q, *cache, torch.full((b,), 102, device="cuda"))
        fn = paged_flash_decode if kernel else paged_flash_decode_plain
        return fn(q, cache)

    for t in stale_rows:
        t.zero_()
    want = run(kernel=False)
    for t in stale_rows:
        t.fill_(float("nan"))
    got = run(kernel=True)
    torch.cuda.synchronize()
    assert got.isfinite().all()
    assert _share_of_limit(got, want) <= 1


def test_beam_and_fork_match_cpu():
    """A small f32 model on the card and on the CPU from the same
    weights: `generate_beam` (beams 3, dense and int8 caches) gives the
    same tokens and scores within 2·steps times the logits' limits (1e-4;
    int8 caches 1e-2), and three `paged_fork` forks of a 150-token
    context in pages of 128 (the one full page shared, the 22-row tail
    copied, one page reserved each) decode on the card (the paged
    kernel) as on the CPU (the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from attention_tpu_torch.models import TinyDecoder, generate_beam, \
        init_params
    from attention_tpu_torch.models.decode import prefill
    from attention_tpu_torch.ops.paged import PagePool, paged_fork, \
        paged_from_dense

    cfg = dict(vocab=64, dim=128, depth=2, num_q_heads=4, num_kv_heads=2,
               rope=True, softcap=30.0, dtype=torch.float32)
    cpu = TinyDecoder(device="cpu", **cfg)
    cpu.load_state_dict(init_params(cpu, 0))
    card = TinyDecoder(device="cuda", **cfg)
    card.load_state_dict(cpu.state_dict())
    prompt = torch.randint(0, 64, (2, 150), generator=torch.Generator()
                           .manual_seed(0))
    for int8, tol in ((False, 1e-4), (True, 1e-2)):
        (t0, s0), (t1, s1) = (generate_beam(m, prompt, steps=10, beams=3,
                                            int8_cache=int8,
                                            return_scores=True)
                              for m in (cpu, card))
        assert torch.equal(t0, t1.cpu())
        assert (s0 - s1.cpu()).abs().max() <= 2 * 10 * tol
    outs = []
    for m in (cpu, card):
        with torch.no_grad():
            _, caches = prefill(m, prompt[:1].to(m.device), 512)
        pool = PagePool(8)
        cache = paged_from_dense(caches[0].k, caches[0].v, [150], pool,
                                 num_pages=8)
        fork = paged_fork(cache, pool, 0, 3, reserve_pages=1)
        assert pool.used_pages == 2 + 3 * 2
        q = torch.randn((3, 4, 32), generator=torch.Generator()
                        .manual_seed(1)).to(m.device)
        outs.append(paged_flash_decode(q, fork).cpu())
    assert outs[1].isfinite().all()
    assert mismatch(outs[1], outs[0])[1] <= 1


def _card_engine_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from attention_tpu_torch.models import TinyDecoder, init_params

    model = TinyDecoder(vocab=64, dim=512, depth=2, num_q_heads=4,
                        num_kv_heads=2, rope=True, softcap=30.0,
                        dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(init_params(model, 0))
    return model


_CARD_ENGINE = dict(num_pages=32, max_seq_len=512, prefill_chunk=64)


def test_engine_snapshot_round_trip_on_the_card(tmp_path):
    """A bf16 engine on the card cut after 5 steps: the restored pools
    hold the same bits, the fingerprints are equal, and both engines
    finish with the same streams (the same bytes into the same
    kernel)."""
    from attention_tpu_torch.engine import EngineConfig, ServingEngine, \
        sampling_of, state_fingerprint, synthetic_trace
    from attention_tpu_torch.engine.snapshot import restore, save

    model = _card_engine_model()
    trace = synthetic_trace(5, vocab=64, seed=3, prompt_len_min=4,
                            prompt_len_max=200, max_tokens=10)
    outs = [{}, {}]
    eng = ServingEngine(model, EngineConfig(**_CARD_ENGINE),
                        on_finish=lambda r: outs[0].__setitem__(
                            r.request_id, list(r.output_tokens)))
    for e in trace:
        eng.add_request(e["prompt"], sampling_of(e), request_id=e["id"])
    for _ in range(5):
        eng.step()
    path = str(tmp_path / "card.atpsnap")
    save(eng, path)
    eng2 = restore(path, model, on_finish=lambda r: outs[1].__setitem__(
        r.request_id, list(r.output_tokens)))
    for a, b in zip((*eng._k_pools, *eng._v_pools),
                    (*eng2._k_pools, *eng2._v_pools)):
        assert b.device.type == "cuda" and b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert state_fingerprint(eng2) == state_fingerprint(eng)
    eng.drain(max_steps=200)
    eng2.drain(max_steps=200)
    assert outs[1] and all(outs[0][rid] == toks
                           for rid, toks in outs[1].items())


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_async_steps_equal_sync_on_the_card(temperature):
    from attention_tpu_torch.engine import EngineConfig, ServingEngine, \
        replay, synthetic_trace

    model = _card_engine_model()
    trace = synthetic_trace(6, vocab=64, seed=4, prompt_len_min=4,
                            prompt_len_max=200, max_tokens=10,
                            temperature=temperature)
    sync, asyn = (replay(ServingEngine(model, EngineConfig(
        **_CARD_ENGINE, async_steps=a)), trace)[1] for a in (False, True))
    assert asyn == sync
    assert all(len(sync[e["id"]]) == 10 for e in trace)


# ------------------------------------------------------- packed sequences

def _docs_ids(*lengths):
    """int32 segment ids of packed documents of these lengths, on the
    card."""
    return torch.repeat_interleave(
        torch.arange(len(lengths), dtype=torch.int32),
        torch.tensor(lengths)).cuda()


# name: (dtype, (q shape, k shape), (q docs, kv docs) or "interleaved",
# keywords): both bodies ("wgmma" for bf16 at d 64/128, "fma" for f32 and
# d 40), causal and not, a window, softcap, offsets and kv_valid, m != n,
# rows whose id no key holds (the q docs' last id, 9, no key has)
SEGMENT_CASES = {
    "bf16_d128_packed_causal": (
        torch.bfloat16, ((8, 700, 128), (2, 700, 128)),
        ((300, 1, 99, 300), (300, 1, 99, 300)), dict(causal=True)),
    "bf16_d64_interleaved": (
        torch.bfloat16, ((4, 333, 64), (2, 333, 64)), "interleaved", {}),
    "bf16_d128_window_softcap": (
        torch.bfloat16, ((8, 600, 128), (2, 600, 128)),
        ((250, 350), (250, 350)), dict(causal=True, window=130,
                                       softcap=30.0)),
    "bf16_d128_m_ne_n_offsets": (
        torch.bfloat16, ((8, 300, 128), (2, 520, 128)),
        ((100, 200), (200, 150, 170)),
        dict(causal=True, q_offset=220, kv_valid=500)),
    "f32_fma_m_ne_n": (
        torch.float32, ((4, 150, 40), (2, 230, 40)),
        ((40, 60, 50), (90, 140)), dict(causal=True, q_offset=80)),
}


def _segment_case(gen, name):
    dtype, (qshape, kshape), docs, kw = SEGMENT_CASES[name]
    q, dout = (torch.randn(qshape, generator=gen, device="cuda").to(dtype)
               for _ in "qo")
    k, v = (torch.randn(kshape, generator=gen, device="cuda").to(dtype)
            for _ in "kv")
    if docs == "interleaved":
        q_ids = (torch.arange(qshape[-2], device="cuda") % 3).int()
        kv_ids = (torch.arange(kshape[-2], device="cuda") % 3).int()
    else:
        q_ids, kv_ids = _docs_ids(*docs[0]), _docs_ids(*docs[1])
        q_ids[-10:] = 9
    ids = dict(q_segment_ids=q_ids, kv_segment_ids=kv_ids)
    return q, k, v, dout, ids, dict(kw, scale=qshape[-1] ** -0.5)


def _shifted(ids):
    return torch.cat([ids[:1], ids[:-1]])


@pytest.mark.parametrize("name", list(SEGMENT_CASES))
def test_flash_segments_match_plain(gen, name):
    """The forward and its partials with segment ids against the plain
    versions, on the body the case names; the same bits on a second call;
    the kernel with the key ids shifted by one key fails the check."""
    q, k, v, _, ids, kw = _segment_case(gen, name)
    wgmma = q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128)
    assert flash_launch_plan(q, k, v)["body"] == ("wgmma" if wgmma
                                                  else "fma")
    got = flash_attention(q, k, v, **ids, **kw)
    again = flash_attention(q, k, v, **ids, **kw)
    want = flash_attention_plain(q, k, v, **ids, **kw)
    ints = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
    torch.cuda.synchronize()
    assert torch.equal(got.view(ints), again.view(ints))
    assert _share_of_limit(got, want) <= 1
    fault = flash_attention(q, k, v, **dict(
        ids, kv_segment_ids=_shifted(ids["kv_segment_ids"])), **kw)
    assert _share_of_limit(fault, want) > 1
    part = flash_attention_partials(q, k, v, **ids, **kw)
    plain = flash_attention_partials_plain(q, k, v, **ids, **kw)
    torch.cuda.synchronize()
    assert torch.equal(part[1].isfinite(), plain[1].isfinite())
    assert bool((part[2][..., -10:] == 0).all()) or name.endswith("leaved")
    norm = [(o / s.clamp(min=1e-30)[..., None]).to(q.dtype)
            for o, _, s in (part, plain)]
    assert _share_of_limit(*norm) <= 1


@pytest.mark.parametrize("name", list(SEGMENT_CASES))
@pytest.mark.parametrize("path", ["fused", "pair"])
def test_bwd_segments_match_plain(gen, monkeypatch, path, name):
    """The three backward kernels with segment ids against the plain
    backward: no NaN (rows that see no key give dQ 0), the same bits on
    a second call (the fused dQ within the limit), the kernels with
    shifted key ids failing the check."""
    q, k, v, dout, ids, kw = _segment_case(gen, name)
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    out, lse = _flash_fwd_impl(q, k, v, **ids, **kw)
    args = (q, k, v, out, lse, dout)
    got = flash_bwd.flash_backward(*args, **ids, **kw)
    again = flash_bwd.flash_backward(*args, **ids, **kw)
    want = flash_bwd.flash_backward_plain(*args, **ids, **kw)
    torch.cuda.synchronize()
    ints = torch.int16 if q.dtype == torch.bfloat16 else torch.int32
    for g, a in list(zip(got, again))[path == "fused":]:
        assert torch.equal(g.view(ints), a.view(ints))
    for g, w in zip(got, want):
        assert bool(g.isfinite().all())
        assert grad_mismatch(g, w)[1] <= 1
    if not name.endswith("leaved"):
        assert bool((got[0][:, -10:] == 0).all())
    fault = flash_bwd.flash_backward(*args, **dict(
        ids, kv_segment_ids=_shifted(ids["kv_segment_ids"])), **kw)
    assert max(grad_mismatch(g, w)[1] for g, w in zip(fault, want)) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["fused", "pair"])
def test_all_equal_segment_ids_give_the_bits_of_no_ids(gen, monkeypatch,
                                                       path, dtype):
    """One segment for every row: the forward and the backward kernels
    (both bodies) give the bits of the call without ids; the fused dQ,
    whose tiles add in no fixed order, within its limit."""
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    q, dout = (torch.randn((8, 500, 128), generator=gen, device="cuda")
               .to(dtype) for _ in "qo")
    k, v = (torch.randn((2, 500, 128), generator=gen, device="cuda")
            .to(dtype) for _ in "kv")
    zeros = torch.zeros(500, dtype=torch.int32, device="cuda")
    ids = dict(q_segment_ids=zeros, kv_segment_ids=zeros)
    kw = dict(causal=True, scale=128 ** -0.5)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    a = flash_attention(q, k, v, **kw)
    b = flash_attention(q, k, v, **kw, **ids)
    torch.cuda.synchronize()
    assert torch.equal(a.view(ints), b.view(ints))
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    none = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
    equal = flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw, **ids)
    torch.cuda.synchronize()
    for x, y in list(zip(none, equal))[path == "fused":]:
        assert torch.equal(x.view(ints), y.view(ints))
    assert grad_mismatch(equal[0], none[0])[1] <= 1


def test_segment_diff_launches_the_kernels(gen):
    """A packed `flash_attention_diff` forward and backward on the card:
    one flash forward and one fused backward launch, gradients within
    the plain backward's limit."""
    q, k, v, dout, ids, kw = _segment_case(gen, "bf16_d128_packed_causal")
    out, lse = _flash_fwd_impl(q, k, v, **ids, **kw)
    want = flash_bwd.flash_backward_plain(q, k, v, out, lse, dout, **ids,
                                          **kw)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    before = launch_counts()
    flash_attention_diff(*qkv, causal=True, **ids).backward(dout)
    torch.cuda.synchronize()
    after = launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"flash_fwd": 1,
                                          flash_bwd.FUSED: 1}
    for t, w in zip(qkv, want):
        assert grad_mismatch(t.grad, w)[1] <= 1


# ------------------------------------- tensor-parallel serving (gloo)

TP_CASES = ("decode", "decode_int8", "decode_paged", "prefill",
            "cache_sharded")


def _tp_card_rank(rank, world, init_file, out_dir):
    """One rank of a 2-rank gloo world on cuda:0: each sharded serving
    function (bf16, 8 q / 2 kv heads, d 128) with the launches of its
    call and its single-device call's output; the tp small f32 model's
    greedy tokens and the mesh engine's streams."""
    import torch.distributed as dist

    from attention_tpu_torch.engine import EngineConfig, ServingEngine, \
        replay, synthetic_trace
    from attention_tpu_torch.models import TinyDecoder, generate, \
        init_params
    from attention_tpu_torch.parallel import serving
    from attention_tpu_torch.parallel.mesh import default_mesh

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    torch.manual_seed(0)  # `_paged`'s page order, the same on each rank
    try:
        tp, sp = default_mesh("tp"), default_mesh("sp")
        gen = torch.Generator(device="cuda").manual_seed(0)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)

        lens = torch.tensor([0, 1, 300, 1024], dtype=torch.int32,
                            device="cuda")
        q, k, v = randn(4, 8, 128), randn(4, 2, 1024, 128), \
            randn(4, 2, 1024, 128)
        int8 = quant.quantize_kv(k, v)
        paged = _paged(k, v, lens)
        pq, pk, pv = randn(1, 8, 700, 128), randn(1, 2, 700, 128), \
            randn(1, 2, 700, 128)
        calls = {
            "decode": (lambda: serving.head_sharded_decode(
                q, k, v, lens, mesh=tp), lambda: flash_decode(q, k, v, lens)),
            "decode_int8": (lambda: serving.head_sharded_decode_quantized(
                q, int8, lens, mesh=tp),
                lambda: quant.flash_decode_quantized(q, int8, lens)),
            "decode_paged": (lambda: serving.head_sharded_decode_paged(
                q, paged, mesh=tp), lambda: paged_flash_decode(q, paged)),
            "prefill": (lambda: serving.head_sharded_prefill(
                pq, pk, pv, mesh=tp, causal=True),
                lambda: flash_attention(pq, pk, pv, causal=True)),
            "cache_sharded": (lambda: serving.cache_sharded_decode(
                q, k, v, 700, mesh=sp), lambda: flash_decode(q, k, v, 700)),
        }
        out = {}
        for name, (sharded, single) in calls.items():
            before = launch_counts()
            got = sharded()
            torch.cuda.synchronize()
            after = launch_counts()
            out[name] = dict(out=got.cpu(), single=single().cpu(),
                             launches={n: after[n] - before[n]
                                       for n in after
                                       if after[n] != before[n]})
        small = dict(vocab=64, dim=64, depth=2, num_q_heads=4,
                     num_kv_heads=2, rope=True)
        model = TinyDecoder(dtype=torch.float32, device="cuda", **small)
        model.load_state_dict(init_params(model, 0))
        prompt = torch.randint(1, 64, (2, 40), generator=gen,
                               device="cuda")
        out["tokens"] = [generate(m, prompt, steps=8).cpu()
                         for m in (model.clone(tp_axis="tp", mesh=tp),
                                   model)]
        trace = synthetic_trace(5, vocab=64, seed=3, prompt_len_min=4,
                                prompt_len_max=200, max_tokens=8)
        out["streams"] = [replay(ServingEngine(model, EngineConfig(
            **_CARD_ENGINE, mesh_shards=s)), trace)[1] for s in (2, 0)]
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tp_card_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("tp_card")
    mp.spawn(_tp_card_rank, nprocs=2, args=(2, str(out / "init"), str(out)))
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", TP_CASES)
def test_tp_serving_functions_on_the_card(tp_card_world, name):
    """Each sharded serving function on a 2-rank gloo world on cuda:0:
    its kernel launched once a call, within `mismatch` of the
    single-device call (the kernels' key splits depend on the head
    count), the same bits on both ranks."""
    kernel = {"decode_int8": "quant_decode", "decode_paged": "paged_decode",
              "decode": "decode"}.get(name, "flash_fwd")
    ranks = [r[name] for r in tp_card_world]
    assert all(r["launches"] == {kernel: 1} for r in ranks)
    assert all(mismatch(r["out"], r["single"])[1] <= 1 for r in ranks)
    assert torch.equal(ranks[0]["out"], ranks[1]["out"])


def test_tp_model_and_mesh_engine_on_the_card(tp_card_world):
    """The small f32 model tp over 2 ranks on cuda:0: greedy tokens and
    the mesh engine's streams equal the single device's, on both
    ranks."""
    for r in tp_card_world:
        tp_tokens, single = r["tokens"]
        assert torch.equal(tp_tokens, single)
        mesh, one = r["streams"]
        assert mesh == one and all(len(t) == 8 for t in one.values())


# the trainer's layouts on the card: a small bf16 model whose head dim
# (64) runs the wgmma bodies, 2 steps on a 2-rank gloo world on cuda:0
MESH_MODEL = dict(vocab=256, dim=512, depth=2, num_q_heads=8,
                  num_kv_heads=2, rope=True, softcap=50.0)
MESH_CASES = {"tp2": ((1, 1, 2), False), "dp2_fsdp": ((2, 1, 1), True)}


def _mesh_train_card_rank(rank, world, init_file, out_dir):
    """One rank of a 2-rank gloo world on cuda:0: each `MESH_CASES` mesh
    trains the small bf16 model 2 steps from the seeded start, beside
    the single-device model; the losses and each run's launches."""
    import torch.distributed as dist

    from attention_tpu_torch.models import TinyDecoder, init_train, \
        make_train_step
    from attention_tpu_torch.parallel.mesh import grid_mesh

    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        batch = torch.randint(
            0, MESH_MODEL["vocab"], (2, 257), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        out = {}
        for name, (sizes, fsdp) in (("single", (None, False)),
                                    *MESH_CASES.items()):
            mesh = None if sizes is None else grid_mesh(("dp", "sp", "tp"),
                                                        sizes)
            model = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                                **MESH_MODEL)
            step = make_train_step(model, init_train(
                model, seed=0, mesh=mesh, fsdp=fsdp), mesh)
            reset_launch_counts()
            losses = [step(batch).item() for _ in range(2)]
            torch.cuda.synchronize()
            out[name] = dict(losses=losses, launches={
                n: c for n, c in launch_counts().items() if c})
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_train_card_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("mesh_train_card")
    mp.spawn(_mesh_train_card_rank, nprocs=2,
             args=(2, str(out / "init"), str(out)))
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_train_step_matches_single_device_on_the_card(
        mesh_train_card_world, name):
    """A tp 2 step (Megatron's split, 4 q heads and one kv head a rank)
    and a dp 2 FSDP step on cuda:0: the single device's loss within
    1e-4 relative at step 1 and 5e-4 at step 2 (after the update; phase
    3c's tolerances), the same losses on both ranks."""
    ranks = [r[name]["losses"] for r in mesh_train_card_world]
    want = mesh_train_card_world[0]["single"]["losses"]
    assert ranks[0] == ranks[1]
    assert abs(ranks[0][0] - want[0]) <= 1e-4 * abs(want[0])
    assert abs(ranks[0][1] - want[1]) <= 5e-4 * abs(want[1])


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_train_launches_on_the_card(mesh_train_card_world, name):
    """One flash forward and one fused backward per layer per step on
    each rank, nothing else."""
    per = MESH_MODEL["depth"] * 2
    for r in mesh_train_card_world:
        assert r[name]["launches"] == {"flash_fwd": per,
                                       "flash_bwd_fused": per}


# ------------------------------------------------------------- max modes

_MODES = ("online", "bound", "flashd", "amla")


@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("dtype,shapes,kw", [
    (torch.bfloat16, ((1, 8, 1024, 128), (1, 2, 1024, 128),
                      (1, 2, 1024, 128)), {"causal": True, "softcap": 30.0}),
    (torch.bfloat16, ((8, 700, 64), (2, 900, 64), (2, 900, 64)),
     {"causal": True, "q_offset": 250, "kv_valid": 880}),
    (torch.float32, ((4, 200, 64), (2, 333, 64), (2, 333, 96)), {}),
], ids=["bf16_wgmma_softcap", "bf16_wgmma_offsets", "f32_fma"])
def test_max_mode_kernels_match_plain(gen, monkeypatch, dtype, shapes, kw,
                                      mode):
    """Each variant's kernel (the threshold pinned to 0 so that "bound"
    runs at these sizes): the normalized output within `mismatch` of the
    plain version, the partials' stats those of
    `variant_partials_plain` (the lse within 1e-5 relative, "flashd"'s
    sums 1, "bound"'s row max the row bound, also on rows that see no
    key), launched once a call and counted under its variant."""
    monkeypatch.setattr(flash_ops, "_BOUND_MIN_SCORE_ELEMS", 0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in shapes)
    before = flash_ops._native.variant_counts().get("flash_fwd", {})
    got = flash_attention(q, k, v, max_mode=mode, **kw)
    after = flash_ops._native.variant_counts()["flash_fwd"]
    assert after[mode] == before.get(mode, 0) + 1
    parts = flash_attention_partials(q, k, v, max_mode=mode, **kw)
    want = flash_ops.variant_partials_plain(q, k, v, mode, **kw)
    print(mode, "share against flash_attention_plain",
          _share_of_limit(got, flash_attention_plain(q, k, v, **kw)))
    # the variant's own plain stats, normalized: P rounded against the
    # value the variant subtracts (exactly for "bound" and "amla", whose
    # rescales are powers of two or none)
    assert _share_of_limit(got, (want[0] / want[2].clamp(min=1e-30)[
        ..., None]).to(dtype)) <= 1
    torch.cuda.synchronize()
    seen = want[2] != 0
    assert torch.equal(parts[2] != 0, seen)
    lse, wlse = (mx[seen] + torch.log(sm[seen]) for _, mx, sm in (parts,
                                                                 want))
    assert (lse - wlse).abs().max() <= 1e-5 * wlse.abs().max()
    if mode == "flashd":
        assert torch.equal(parts[2], seen.float())
    if mode == "bound":
        assert (parts[1] - want[1]).abs().max() <= 1e-5 * want[1].abs().max()
        assert torch.isfinite(parts[1]).all()
    norm = [(o / s.clamp(min=1e-30)[..., None]).to(dtype) for o, _, s in
            (parts, want)]
    assert _share_of_limit(*norm) <= 1


def test_bound_guard_demotes_on_the_card(gen, monkeypatch):
    """A key row of norm 4000: the guard's verdict on the device demotes
    the call, whose output is the online body's bits; a call the guard
    passes runs the bound body, with no host sync either way."""
    monkeypatch.setattr(flash_ops, "_BOUND_MIN_SCORE_ELEMS", 0)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
               for s in ((1, 8, 512, 128), (1, 2, 512, 128),
                         (1, 2, 512, 128)))
    reset_launch_counts()
    outs, verdicts = [], []
    for outlier in (False, True):
        if outlier:
            k[0, 0, 300] *= 4000.0 / k[0, 0, 300].float().norm()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(flash_attention(q, k, v, causal=True,
                                        max_mode="bound"))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        verdicts.append(demotion_count())
    safe, demoted = outs
    assert verdicts == [0, 1]
    assert torch.equal(demoted, flash_attention(q, k, v, causal=True))
    assert demoted.isfinite().all() and safe.isfinite().all()


@pytest.mark.parametrize("mode", ["flashd", "amla"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_and_ragged_variants_match_plain(gen, dtype, mode):
    """flash_decode, flash_decode_chunk (window and sinks) and the ragged
    kernel under "flashd" and "amla" against the plain versions; "bound"
    is refused (forward-only, as in JAX)."""
    lens = torch.tensor([0, 5, 700, 1024], dtype=torch.int32, device="cuda")
    q = torch.randn(4, 16, 128, generator=gen, device="cuda").to(dtype)
    kc, vc = (torch.randn(4, 2, 1024, 128, generator=gen,
                          device="cuda").to(dtype) for _ in "kv")
    for qq, fn, kw in ((q, flash_decode, {}),
                       (q[:, :, None].repeat(1, 1, 3, 1), flash_decode_chunk,
                        {"window": 200, "sinks": 3})):
        got = fn(qq, kc, vc, lens, max_mode=mode, **kw)
        assert _share_of_limit(got, flash_decode_plain(qq, kc, vc, lens,
                                                       **kw)) <= 1
    with pytest.raises(ValueError, match="forward-only"):
        flash_decode(q, kc, vc, lens, max_mode="bound")
    hq, hkv, d, page = 8, 2, 128, 128
    pools = [torch.randn(6, hkv, page, d, generator=gen,
                         device="cuda").to(dtype) for _ in "kv"]
    table = torch.tensor([[0, 1], [2, 3], [4, 5]], dtype=torch.int32,
                         device="cuda")
    spans = [(1, 200), (1, 130), (90, 250)]  # (tokens, length after)
    cu = [0]
    for n, _ in spans:
        cu.append(cu[-1] + n)
    width = packed_bucket(cu[-1])
    step = RaggedPagedStep(
        *pools, table,
        torch.tensor([ln for _, ln in spans], dtype=torch.int32,
                     device="cuda"),
        torch.tensor(cu, dtype=torch.int32, device="cuda"),
        torch.tensor([2, 3], dtype=torch.int32, device="cuda"),
        torch.zeros(width, dtype=torch.int32, device="cuda"),
        torch.full((width,), -1, dtype=torch.int32, device="cuda"),
        recommended_q_tile(90, hq // hkv))
    qr = torch.randn(1, hq, width, d, generator=gen, device="cuda").to(dtype)
    got = ragged_paged_attention(qr, step, max_mode=mode)
    assert _share_of_limit(got, ragged_paged_attention_plain(qr, step)) <= 1


# Head dims past the wgmma bodies' and up to 256 (`-k head_dim`).  The
# backward kernels above head dim 128 run the FMA bodies at 32 rows a CTA
# (`flash_bwd.fma_resources`' "rows"); the quantized kernels run the
# instance of the least of 32, 64, 128 and 256 at or above d
# (`quant.kernel_resources`' "head_dim"), their stored rows staged in 16-,
# 4- or 1-byte copies as the rows allow (int8 d 40 and int4 d 80 are
# 40-byte rows: 4-byte copies; int8 d 42 and int4 d 82 rows of 42 and 41
# bytes, d 2 rows of 2 and 1 bytes: byte copies).  Each case against its
# plain version, the same bits on a second call (the fused dQ, added by
# atomics in no fixed order, within the limit of the first).
HEAD_DIM_BWD = (80, 96, 160, 192, 256)
HEAD_DIM_BWD_CASES = {
    # GQA 4 q / 2 kv, 2 batches, ragged edges past a 32-row CTA, causal
    # with the keys 20 rows past the queries (the first rows see no key),
    # kv_valid and softcap
    "causal_offsets_softcap": (((2, 4, 150, 0), (2, 2, 170, 0)),
                               dict(causal=True, q_offset=20, kv_valid=160,
                                    softcap=30.0)),
    # a window of 40 with 3 sinks (the kernels take the band, `sink_patch`
    # the sinks)
    "window40_sinks3": (((1, 4, 200, 0), (1, 2, 200, 0)),
                        dict(causal=True, window=40, sinks=3)),
}


def _head_dim_bwd_case(gen, name, d, dtype):
    shapes, kw = HEAD_DIM_BWD_CASES[name]
    q, k, v = (torch.randn(s[:-1] + (d,), generator=gen,
                           device="cuda").to(dtype)
               for s in (shapes[0], shapes[1], shapes[1]))
    kw = dict(kw, scale=d ** -0.5)
    out, lse = _flash_fwd_impl(q, k, v, **kw)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    return (q, k, v, out, lse, dout), kw


def _plain_bwd(args, kw):
    """`flash_backward_plain` on a kernel call's arguments."""
    plain_kw = dict(kw)
    offsets = [plain_kw.pop(name, None)
               for name in ("q_offset", "kv_offset", "kv_valid")]
    return flash_bwd.flash_backward_plain(
        *args, **plain_kw, **_offsets(args[1].shape[-2], *offsets))


def _bwd_held_twice(args, kw, path):
    """The kernels' gradients (one launch a kernel a call) within
    `grad_mismatch` of the plain version's, the same bits on a second
    call except the fused dQ (within the limit)."""
    before = launch_counts()
    got, again = (flash_bwd.flash_backward(*args, **kw) for _ in range(2))
    after = launch_counts()
    want_launches = ({flash_bwd.FUSED: 2} if path == "fused"
                     else {flash_bwd.DQ: 2, flash_bwd.DKV: 2})
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == want_launches
    want = _plain_bwd(args, kw)
    torch.cuda.synchronize()
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        assert g.dtype == w.dtype and g.device.type == "cuda"
        assert grad_mismatch(g, w)[1] <= 1
        if i == 0 and path == "fused":
            assert grad_mismatch(a, g)[1] <= 1
        else:
            assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", HEAD_DIM_BWD)
@pytest.mark.parametrize("name", list(HEAD_DIM_BWD_CASES))
@pytest.mark.parametrize("path", ["fused", "pair"])
def test_head_dim_backward_kernels_match_plain(gen, monkeypatch, path, name,
                                               d, dtype):
    args, kw = _head_dim_bwd_case(gen, name, d, dtype)
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    plan = flash_bwd.bwd_launch_plan(*args, causal=True,
                                     window=kw.get("window"))
    assert plan["body"] == "fma"
    kernel = flash_bwd.DQ if path == "pair" else flash_bwd.FUSED
    assert flash_bwd.fma_resources(kernel, dtype, d, d)["rows"] == (
        64 if d <= 128 else 32)
    _bwd_held_twice(args, kw, path)


@pytest.mark.parametrize("path", ["fused", "pair"])
def test_head_dim_256_backward_takes_segment_ids(gen, monkeypatch, path):
    """bf16 at d 256, 3-D, 4 q / 2 kv heads over 200 rows packed from
    documents of 90, 1 and 109 rows, causal, softcap 30."""
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    q, k, v = (torch.randn((h, 200, 256), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (4, 2, 2))
    ids = torch.repeat_interleave(
        torch.arange(3, device="cuda"),
        torch.tensor([90, 1, 109], device="cuda")).to(torch.int32)
    kw = dict(scale=256 ** -0.5, causal=True, softcap=30.0)
    out, lse = _flash_fwd_impl(q, k, v, q_segment_ids=ids,
                               kv_segment_ids=ids, **kw)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    _bwd_held_twice((q, k, v, out, lse, dout),
                    dict(kw, q_segment_ids=ids, kv_segment_ids=ids), path)


@pytest.mark.parametrize("path", ["fused", "pair"])
def test_head_dim_256_backward_float32_grads(gen, monkeypatch, path):
    """``grad_dtype=torch.float32`` (the sharded backward paths' call) on
    bf16 at d 256: float32 gradients, unrounded, whose bf16 rounding lies
    within `grad_mismatch` of the plain version's."""
    args, kw = _head_dim_bwd_case(gen, "causal_offsets_softcap", 256,
                                  torch.bfloat16)
    monkeypatch.setattr(flash_bwd, "_FORCE_TWO_KERNEL", path == "pair")
    got = flash_bwd.flash_backward(*args, **kw, grad_dtype=torch.float32)
    want = _plain_bwd(args, kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert grad_mismatch(g.to(torch.bfloat16), w)[1] <= 1


@pytest.mark.parametrize("d", [160, 256])
def test_head_dim_diff_trains_on_the_fma_bodies(gen, d):
    """`flash_attention_diff` at d 160 and 256, bf16, causal GQA: one
    flash forward and one fused backward a step, gradients within
    `grad_mismatch` of the plain backward on the same forward."""
    q, k, v = (torch.randn((2, h, 130, d), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for h in (8, 2, 2))
    w = torch.randn((2, 8, 130, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    before = launch_counts()
    out = flash_attention_diff(q, k, v, causal=True, softcap=50.0)
    (out.float() * w.float()).sum().backward()
    after = launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"flash_fwd": 1,
                                          flash_bwd.FUSED: 1}
    kw = dict(scale=d ** -0.5, causal=True, softcap=50.0)
    o, lse = _flash_fwd_impl(q.detach(), k.detach(), v.detach(), **kw)
    want = flash_bwd.flash_backward_plain(q.detach(), k.detach(), v.detach(),
                                          o, lse, w, **kw)
    torch.cuda.synchronize()
    for t, wg in zip((q, k, v), want):
        assert grad_mismatch(t.grad, wg)[1] <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["fused", "dq", "dkv"])
def test_head_dim_256_fma_instances_do_not_spill(gen, kernel, dtype):
    """The d > 128 instances of the three FMA bodies: no local memory,
    their shared bytes as `csrc/flash_bwd.cuh` sizes them (fp32 tiles of
    32 rows), at least one CTA an SM."""
    name = {"fused": flash_bwd.FUSED, "dq": flash_bwd.DQ,
            "dkv": flash_bwd.DKV}[kernel]
    res = flash_bwd.fma_resources(name, dtype, 256, 256)
    assert res["spill_bytes"] == 0 and res["ctas_per_sm"] >= 1
    assert res["rows"] == 32
    assert res["smem_bytes"] == (184_832 if kernel == "dq" else 222_208)


HEAD_DIM_QUANT = (16, 40, 96, 192, 256)


def _head_dim_quant_case(gen, fmt, s_new, d):
    b, h, hkv, n = 3, 8, 2, 512
    q = torch.randn(b, h, *([s_new] if s_new else []), d, generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, n, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([0, 301, n], dtype=torch.int32, device="cuda")
    return q, QUANTIZE[fmt](k, v), lens


@pytest.mark.parametrize("d", (2,) + HEAD_DIM_QUANT + (42, 82))
@pytest.mark.parametrize("fmt,s_new", [("int8", 0), ("int8", 4),
                                       ("int4", 0), ("int4_tok", 0)],
                         ids=["int8", "int8_chunk4", "int4", "tok4"])
def test_head_dim_quant_kernels_match_plain(gen, fmt, s_new, d):
    """Softcap 30, lengths 0, 301 and 512, one token (KG = 4) and a chunk
    of 4 (KG = 1): one launch a call, the same bits twice, within the
    plain version's limits, a zero row for length 0; the instance the
    least of 32, 64, 128 and 256 at or above the head dim."""
    q, cache, lens = _head_dim_quant_case(gen, fmt, s_new, d)
    inst = quant.kernel_resources(type(cache), d, 4)
    assert inst["head_dim"] == next(x for x in (32, 64, 128, 256) if d <= x)
    fn = QUANT_OPS[fmt, bool(s_new)]
    kernel = "quant_tok4" if fmt == "int4_tok" else "quant_decode"
    before = launch_counts()[kernel]
    got = _held_twice(
        lambda: fn(q, cache, lens, softcap=30.0),
        lambda: quant.quant_decode_plain(q, cache, lens, softcap=30.0),
        torch.bfloat16)
    assert launch_counts()[kernel] == before + 2
    assert (got[0] == 0).all()


def _padded_rows(t: torch.Tensor, extra: int) -> torch.Tensor:
    """``t`` viewed out of storage whose rows are ``extra`` bytes
    longer."""
    buf = torch.zeros(*t.shape[:-1], t.shape[-1] + extra, dtype=t.dtype,
                      device=t.device)
    buf[..., :t.shape[-1]] = t
    return buf[..., :t.shape[-1]]


@pytest.mark.parametrize("fmt", ["int8", "int4", "int4_tok"])
def test_head_dim_256_quant_window_fp32_q_and_strides(gen, fmt):
    """d 256 with a window of 100 and 4 sinks and q in fp32 (the kernel
    scales and rounds it); then the cache's rows viewed out of storage 8
    bytes (4-byte copies) and 3 bytes (byte copies) longer a row, which
    must give the bits of the contiguous cache."""
    q, cache, lens = _head_dim_quant_case(gen, fmt, 0, 256)
    fn = QUANT_OPS[fmt, False]
    kw = dict(window=100, sinks=4)
    _held_twice(lambda: fn(q.float(), cache, lens, **kw),
                lambda: quant.quant_decode_plain(q.float(), cache, lens,
                                                 **kw), torch.bfloat16)
    want = fn(q, cache, lens, softcap=30.0)
    for extra in (8, 3):
        view = cache._replace(k_q=_padded_rows(cache.k_q, extra),
                              v_q=_padded_rows(cache.v_q, extra))
        got = fn(q, view, lens, softcap=30.0)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", [quant.QuantizedKV, quant.Int4KV,
                                  quant.Int4TokKV],
                         ids=["int8", "int4", "tok4"])
@pytest.mark.parametrize("kg", [1, 4])
def test_head_dim_256_quant_instances_do_not_spill(gen, kind, kg):
    res = quant.kernel_resources(kind, 256, kg)
    assert res["spill_bytes"] == 0 and res["ctas_per_sm"] >= 1
    assert res["head_dim"] == 256
