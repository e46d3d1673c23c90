"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no CPU mode, so every test here carries the
``cuda`` marker and skips where torch sees no card.  This file imports
no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are those of `reference.mismatch`: f32 1e-5 max abs (both
sides in full f32, no TF32; only the summation order differs), bf16
1.6e-2 of the value plus 2^-6 of its row's rms, capped at 2e-2 (the
sides round P and the output to bf16 at different points).
"""

import pytest
import torch

from attention_tpu_torch.ops import launch_counts
from attention_tpu_torch.ops.flash import flash_attention, \
    flash_attention_plain
from attention_tpu_torch.ops.ragged_paged import (
    RaggedPagedStep,
    packed_bucket,
    ragged_paged_append,
    ragged_paged_attention,
    ragged_paged_attention_plain,
)
from attention_tpu_torch.ops.reference import mismatch

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


def test_flash_wrapper_raises_instead_of_falling_back(gen):
    q = torch.randn(16, 32, generator=gen, device="cuda",
                    dtype=torch.float64)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)


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
