"""The port's operators against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; JAX's Pallas
kernels run in interpret mode (`ops.flash._should_interpret`), the
port's wrappers run their plain PyTorch versions because the tensors
lie on the CPU.  Tolerances, on unit-normal inputs, are those of
`reference.mismatch`, which also holds the kernels to their plain
versions on the card:

* f32: 1e-5 max abs.  Both sides compute in full f32; they differ only
  in summation order and exp vs exp2.
* bf16: 1.6e-2 of the value plus 2^-6 of its row's rms, capped at 2e-2.
  Both round P to bf16 before the P·V product (the Pallas kernel
  unnormalized, the plain version normalized) and the output to bf16
  (one ulp is up to 2^-7 of the value).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu.core import testcase as jax_testcase
from attention_tpu.models.decode import warp_logits as jax_warp
from attention_tpu.ops import ragged_paged as jax_rp
from attention_tpu.ops.flash import flash_attention as jax_flash
from attention_tpu.ops.rope import apply_rope as jax_rope
from attention_tpu_torch import cli
from attention_tpu_torch.core import testcase
from attention_tpu_torch.models.decode import warp_logits
from attention_tpu_torch.ops import ragged_paged as rp
from attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_partials,
    flash_attention_plain,
)
from attention_tpu_torch.ops.reference import F32_ATOL, mismatch
from attention_tpu_torch.ops.rope import apply_rope

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ .bin format


def test_bin_round_trip_both_ways_byte_identical(tmp_path):
    port = testcase.generate_testcase(37, 53, 16, 24, seed=5)
    ref = jax_testcase.generate_testcase(37, 53, 16, 24, seed=5)
    testcase.write_testcase(tmp_path / "port.bin", port)
    jax_testcase.write_testcase(tmp_path / "ref.bin", ref)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "ref.bin").read_bytes()
    for reader, path in ((jax_testcase.read_testcase, "port.bin"),
                         (testcase.read_testcase, "ref.bin")):
        back = reader(tmp_path / path)
        for a, b in zip((back.q, back.k, back.v, back.expected),
                        (port.q, port.k, port.v, port.expected)):
            np.testing.assert_array_equal(a, b)


def test_cli_run_correct_then_wrong(tmp_path, capsys):
    path = tmp_path / "simple.bin"
    case = testcase.generate_testcase(*testcase.SUITE["simple"], seed=0)
    testcase.write_testcase(path, case)
    for dtype in ("f32", "bf16"):
        assert cli.main(["run", str(path), "--device", "cpu",
                         "--dtype", dtype]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0] == "Correct!" and out[1].startswith("Elapsed time: ")
    case.expected[3, 7] += 0.5
    testcase.write_testcase(path, case)
    assert cli.main(["run", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Expect result[3][7] to be ")
    assert out[1] == "Wrong!"


# ------------------------------------------------------------------ flash


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shapes,kw", [
    (((37, 16), (53, 16), (53, 24)), {}),                 # 2-D, dk != dv
    (((4, 37, 16), (2, 53, 16), (2, 53, 16)), {}),        # 3-D GQA
    (((2, 4, 40, 16), (2, 2, 40, 16), (2, 2, 40, 8)),
     {"causal": True}),                                   # 4-D causal
    (((4, 37, 16), (1, 53, 16), (1, 53, 16)),
     {"softcap": 2.0, "scale": 0.7}),
], ids=["2d", "3d_gqa", "4d_causal", "softcap"])
def test_flash_plain_matches_jax(shapes, kw, dtype):
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, *s) for s in shapes)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = np.asarray(jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                **kw), np.float32)
    got = flash_attention(*(torch.from_numpy(x).to(tdt)
                            for x in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == want.shape
    assert mismatch(got, torch.tensor(want).to(tdt))[1] <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mismatch_rejects_planted_faults(dtype):
    """The check that holds a kernel to its plain version fails an
    output with its last key tile dropped or its scale 2% off."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, 4, 96, 32)).to(dtype)
               for _ in range(3))
    want = flash_attention_plain(q, k, v, causal=True)
    assert mismatch(flash_attention_plain(q, k, v, causal=True), want) \
        == (0.0, 0.0)
    for planted in (
            flash_attention_plain(q, k[:, :-32], v[:, :-32], causal=True),
            flash_attention_plain(q, k, v, causal=True,
                                  scale=1.02 * 32 ** -0.5)):
        assert mismatch(planted, want)[1] > 1


def test_flash_unported_features_raise():
    """Forward features the port does not have yet raise, in both
    forward entry points (the training forward's partials included)."""
    q = torch.zeros(8, 16)
    seg = torch.zeros(8, dtype=torch.int32)
    for kw in ({"q_segment_ids": seg, "kv_segment_ids": seg},
               {"max_mode": "flashd"}):
        for fn in (flash_attention, flash_attention_partials):
            with pytest.raises(NotImplementedError):
                fn(q, q, q, causal=True, **kw)


# ----------------------------------------------------------------- ragged

_PAGE, _HQ, _HKV, _D = 128, 4, 2, 16


def _ragged_case(seed=0):
    """One packed step: two decode slots, a prefill chunk crossing a page
    boundary, a prefill slot whose second page is unclaimed (its append
    poisons it), and pad tokens; returns numpy operands."""
    r = np.random.default_rng(seed)
    specs = [(37, 1), (127, 1), (100, 40), (120, 12)]  # (kv_pre, q_len)
    slots, max_pages = 5, 3
    table = np.full((slots, max_pages), -1, np.int32)
    table[:4, :2] = np.arange(8).reshape(4, 2)
    table[3, 1] = -1                    # slot 3's tokens 128.. have no page
    cu = np.zeros(slots + 1, np.int32)
    cu[1:5] = np.cumsum([q for _, q in specs])
    cu[5] = cu[4]
    width = rp.packed_bucket(int(cu[-1]))
    pos = np.zeros(width, np.int32)
    slot = np.full(width, -1, np.int32)
    for s, (pre, n) in enumerate(specs):
        pos[cu[s]:cu[s + 1]] = np.arange(pre, pre + n)
        slot[cu[s]:cu[s + 1]] = s
    lens = np.array([pre for pre, _ in specs] + [0], np.int32)
    pools = [_rand(r, 9, _HKV, _PAGE, _D) for _ in range(2)]
    rows = [_rand(r, 1, _HKV, width, _D) for _ in range(2)]
    q = _rand(r, 1, _HQ, width, _D)
    return (pools, table, lens, cu, np.array([2, 4], np.int32), pos, slot,
            rows, q, rp.tile_tokens(rp.packed_bucket(40, minimum=1),
                                    _HQ // _HKV))


@pytest.mark.parametrize("softcap", [None, 3.0])
def test_ragged_append_and_attention_match_jax(softcap):
    pools, table, lens, cu, dist, pos, slot, rows, q, q_tile = _ragged_case()
    jstep = jax_rp.RaggedPagedStep(
        *(jnp.asarray(a) for a in (*pools, table, lens, cu, dist, pos,
                                   slot)),
        np.zeros((q_tile,), np.int32))
    jstep = jax_rp.ragged_paged_append(jstep, *map(jnp.asarray, rows))
    want = np.asarray(jax_rp.ragged_paged_attention(
        jnp.asarray(q), jstep, softcap=softcap))
    tstep = rp.RaggedPagedStep(
        *(torch.from_numpy(a.copy()) for a in (*pools, table, lens, cu,
                                               dist, pos, slot)), q_tile)
    tstep = rp.ragged_paged_append(tstep, *map(torch.from_numpy, rows))
    got = rp.ragged_paged_attention(torch.from_numpy(q), tstep,
                                    softcap=softcap).numpy()
    assert tstep.kv_lens.tolist() == [38, 128, 140, -1, 0]
    np.testing.assert_array_equal(tstep.kv_lens.numpy(),
                                  np.asarray(jstep.kv_lens))
    for mine, theirs in zip((tstep.k_pool, tstep.v_pool),
                            (jstep.k_pool, jstep.v_pool)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    poisoned = np.zeros(got.shape[2], bool)
    poisoned[cu[3]:cu[4]] = True
    assert np.isnan(got[:, :, poisoned]).all()
    assert np.isnan(want[:, :, poisoned]).all()
    assert (got[:, :, cu[4]:] == 0).all()           # pad rows stay zero
    live = ~poisoned
    assert np.abs(got[:, :, live] - want[:, :, live]).max() <= F32_ATOL


def test_ragged_append_with_nothing_kept_leaves_the_pools():
    """Pad tokens and tokens of a poisoned slot only: the append writes
    nothing."""
    pools, table, lens, cu, dist, pos, slot, rows, q, q_tile = _ragged_case()
    slot = np.where(slot == 3, 3, -1).astype(np.int32)
    table[3] = -1                       # every token of slot 3 is bad
    step = rp.RaggedPagedStep(
        *(torch.from_numpy(a.copy()) for a in (*pools, table, lens, cu,
                                               dist, pos, slot)), q_tile)
    step = rp.ragged_paged_append(step, *map(torch.from_numpy, rows))
    for mine, before in zip((step.k_pool, step.v_pool), pools):
        np.testing.assert_array_equal(mine.numpy(), before)
    assert step.kv_lens.tolist() == [38, 128, 140, -1, 0]


def test_bucketing_matches_jax():
    for n in range(0, 300, 7):
        assert rp.packed_bucket(n) == jax_rp.packed_bucket(n)
        for g in (1, 2, 4, 8):
            assert rp.tile_tokens(n, g) == jax_rp.tile_tokens(n, g)


# ---------------------------------------------------------- rope, sampling


def test_rope_and_warp_logits_match_jax():
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 4, 9, 16)
    pos = rng.integers(0, 4000, (2, 1, 9)).astype(np.int32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 500.0))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0)
    assert np.abs(got.numpy() - want).max() <= F32_ATOL
    logits = _rand(rng, 3, 50) * 3
    for kw in ({"temperature": 0.7, "top_k": None, "top_p": None},
               {"temperature": 1.3, "top_k": 5, "top_p": None},
               {"temperature": 0.9, "top_k": None, "top_p": 0.8},
               {"temperature": 1.0, "top_k": 10, "top_p": 0.5}):
        want = np.asarray(jax_warp(jnp.asarray(logits), **kw))
        got = warp_logits(torch.from_numpy(logits), **kw).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert np.abs(got[fin] - want[fin]).max() <= F32_ATOL


# ------------------------------------------------------- package boundary


def test_port_imports_no_jax():
    """The port (and its chip smoke script) imports with jax, flax,
    ml_dtypes and the JAX package blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'ml_dtypes',\n"
        "             'attention_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import attention_tpu_torch, attention_tpu_torch.cli\n"
        "import attention_tpu_torch.engine, attention_tpu_torch.models\n"
        "import attention_tpu_torch.engine.snapshot\n"
        "import attention_tpu_torch.engine.journal\n"
        "import attention_tpu_torch.models.convert, chip_smoke\n"
        "import attention_tpu_torch.models.decode\n"
        "import attention_tpu_torch.models.speculative\n"
        "import attention_tpu_torch.models.cross_attention\n"
        "import attention_tpu_torch.models.seq2seq\n"
        "import attention_tpu_torch.ops.decode, attention_tpu_torch.ops.paged\n"
        "import attention_tpu_torch.ops.quant\n"
        "import attention_tpu_torch.ops.flash_bwd\n"
        "import attention_tpu_torch.ops.flash_vjp\n"
        "import attention_tpu_torch.models.train\n"
        "import attention_tpu_torch.measure_decode\n"
        "import attention_tpu_torch.measure_flash\n"
        "import attention_tpu_torch.measure_ragged\n"
        "import attention_tpu_torch.measure_bwd\n"
        "import attention_tpu_torch.measure_quant\n"
        "import attention_tpu_torch.measure_train\n"
        "import attention_tpu_torch.parallel\n"
        "import attention_tpu_torch.parallel.mesh\n"
        "import attention_tpu_torch.parallel.kv_sharded\n"
        "import attention_tpu_torch.parallel.ring\n"
        "import attention_tpu_torch.parallel.ulysses\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'ml_dtypes', 'attention_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0, r.stderr
