"""Training the sliding-window + attention-sink model in the port, against
the JAX package, on the CPU.

The backward kernels take a window band: the key-major wgmma body's
query tiles (`ops.flash_bwd.bwd_tile_plan`) and the dQ body's key tiles
(the forward's `ops.flash.tile_plan` with the window and no sinks) are
held against brute-force masks, and a walk of both bodies in PyTorch
over those plans (masking only the tiles the plans mask) against the
plain backward over the window-only mask.  The sink pairs outside the
band are `sink_patch`, held against JAX's `_sink_patch`.  Then the
plain backward over the band and sinks, `flash_attention_diff`, and the
windowed `TinyDecoder`'s loss, gradients and three AdamW steps against
the JAX package (its Pallas kernels in interpret mode).  Inputs come
from numpy seeds and reach both sides as the same arrays; shapes stay at
most 320 rows and d 32, as the JAX package's own sink tests.

Tolerances, with their reasons:

* float32 gradients, 1e-5 max abs: both sides compute in full f32 and
  differ in summation order (and exp against exp2); values are O(1)
  and sums run over at most 320 rows.
* bfloat16 gradients, `reference.grad_mismatch`'s bf16 limit: both
  sides round Qs, P and dS to bf16 at the same points, but a value next
  to a rounding boundary can round one ulp apart, and the gradients are
  rounded to bf16 themselves.
* `sink_patch`, 1e-5 max abs: the same float32 einsums in PyTorch.
* the windowed model: loss 1e-6 and gradients 1e-6 max abs (f32 through
  one block, gradients O(0.1)); three AdamW steps' losses 2e-5 and
  parameters 2e-6 (Adam's first update divides by |g|), as the
  unwindowed model's in test_torch_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu.models import train as jax_train
from attention_tpu.ops import flash_bwd as jax_bwd
from attention_tpu.ops.flash_vjp import _flash_fwd_impl as jax_fwd_impl
from attention_tpu.ops.flash_vjp import flash_attention_diff as jax_diff
from attention_tpu_torch.models import (
    TinyDecoder,
    init_train,
    make_train_step,
    params_from_jax,
)
from attention_tpu_torch.models.train import loss_fn
from attention_tpu_torch.ops import flash_bwd
from attention_tpu_torch.ops.flash import KEY_TILE, ROW_BLOCK, tile_plan
from attention_tpu_torch.ops.flash_bwd import (
    KEY_BLOCK,
    QUERY_TILE,
    _lse2,
    _round,
    _scaled_q,
    bwd_tile_plan,
    bwd_work_plan,
    flash_backward_plain,
    sink_patch,
)
from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl, \
    flash_attention_diff
from attention_tpu_torch.ops.reference import (
    attention_mask,
    attention_reference,
    grad_mismatch,
)

F32_TOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------- the key-major body's band


def _padded_mask(m, n, **kw):
    """`attention_mask` with the keys padded to whole key blocks."""
    keep = attention_mask(m, n, causal=True, **kw)
    pad = -(-n // KEY_BLOCK) * KEY_BLOCK - n
    return torch.cat([keep, keep.new_zeros(m, pad)], 1)


@pytest.mark.parametrize("kv_offset", [0, 11])
@pytest.mark.parametrize("q_offset", [-37, 0, 5, 127])
@pytest.mark.parametrize("window", [1, 50, 64, 128, 191, 192, 193, 300])
def test_bwd_tile_plan_visits_exactly_the_band(window, q_offset,
                                               kv_offset):
    """Per key block, over m of 1, 100 and 300 rows, n of 129 and 400 and
    kv_valid from 0 to n, windows below and above 128 + 64 (a block and a
    tile): the visited tiles are exactly those holding a pair the
    window-only mask keeps, every real row of the no-test interval
    [mask_end, edge) keeps every key of the block, and the plan is tight:
    the last tile before mask_end, and the tile at edge where its rows
    are real, hold a dropped pair."""
    for m in (1, 100, 300):
        for n in (129, 400):
            for kv_valid in (0, 1, 128, n - 1, n):
                keep = _padded_mask(m, n, q_offset=q_offset,
                                    kv_offset=kv_offset, kv_valid=kv_valid,
                                    window=window)
                for key0 in range(0, n, KEY_BLOCK):
                    block = keep[:, key0:key0 + KEY_BLOCK]
                    plan = bwd_tile_plan(key0, m, kv_valid, True, q_offset,
                                         kv_offset, window)
                    where = (m, n, kv_valid, key0, plan)
                    assert (0 <= plan.begin <= plan.mask_end <= plan.edge
                            <= plan.end <= -(-m // QUERY_TILE)), where
                    tiles = [bool(block[t * QUERY_TILE:(t + 1)
                                        * QUERY_TILE].any())
                             for t in range(-(-m // QUERY_TILE))]
                    assert [t for t, x in enumerate(tiles) if x] == list(
                        range(plan.begin, plan.end)), where
                    whole = block[plan.mask_end * QUERY_TILE:
                                  plan.edge * QUERY_TILE]
                    assert bool(whole.all()), where
                    if plan.mask_end > plan.begin:
                        t = plan.mask_end - 1
                        assert not bool(block[t * QUERY_TILE:(t + 1)
                                              * QUERY_TILE].all()), where
                    if plan.edge < plan.end and (
                            (plan.edge + 1) * QUERY_TILE <= m):
                        t = plan.edge
                        assert not bool(block[t * QUERY_TILE:(t + 1)
                                              * QUERY_TILE].all()), where


def test_bwd_tile_plan_of_mistrals_band():
    """Window 4096 over 8192 aligned rows: key block i starts at tile 2i,
    masks its two diagonal tiles, runs without the test up to the band's
    lower edge at tile 2i + 64 and masks the two tiles there; a window
    wider than the sequence is the causal plan; a band's work plan loads
    its band's tiles only."""
    for i in (0, 5, 63):
        end = min(128, 2 * i + 66)
        assert bwd_tile_plan(i * 128, 8192, 8192, True, 0, 0, 4096) == (
            2 * i, end, 2 * i + 2, min(end, 2 * i + 64))
    assert bwd_tile_plan(640, 8192, 8192, True, 0, 0, 8192) == (
        bwd_tile_plan(640, 8192, 8192, True, 0, 0)[:3] + (128,))
    full = bwd_work_plan(1, 4, 8, 8192, 8192, 8192, True, 0, 0, sms=132)
    band = bwd_work_plan(1, 4, 8, 8192, 8192, 8192, True, 0, 0, 1024,
                         sms=132)
    assert band.mean < 0.3 * full.mean


# --------------------------------------------------- the dQ body's band


@pytest.mark.parametrize("kv_offset", [0, 11])
@pytest.mark.parametrize("q_offset", [-37, 0, 5, 300])
@pytest.mark.parametrize("window", [1, 100, 128, 129, 300])
def test_dq_plan_is_the_window_band_without_sinks(window, q_offset,
                                                  kv_offset):
    """The dQ body's item plan (the forward's `tile_plan` with the window
    and ``sinks=None``) per 128-row item, over m of 1, 200 and 320 and
    kv_valid from 0 to n = 390: its visits are exactly the key tiles
    holding a pair of the window-only mask, in order, and every real
    row of an item keeps every key of the tiles in [mask_lo, mask)."""
    n = 390
    for m in (1, 200, 320):
        for kv_valid in (0, 1, 129, n - 1, n):
            keep = attention_mask(m, n, causal=True, q_offset=q_offset,
                                  kv_offset=kv_offset, kv_valid=kv_valid,
                                  window=window)
            pad = -(-n // KEY_TILE) * KEY_TILE - n
            keep = torch.cat([keep, keep.new_zeros(m, pad)], 1)
            for m0 in range(0, m, ROW_BLOCK):
                rows = keep[m0:m0 + ROW_BLOCK]
                plan = tile_plan(m0, m, kv_valid, True, q_offset, kv_offset,
                                 window=window, sinks=None)
                kept = [t for t in range(-(-n // KEY_TILE))
                        if rows[:, t * KEY_TILE:(t + 1) * KEY_TILE].any()]
                assert plan.tiles() == kept, (m, kv_valid, m0, plan)
                for t in range(plan.mask_lo, plan.mask):
                    assert bool(rows[:, t * KEY_TILE:(t + 1)
                                     * KEY_TILE].all()), (m0, t, plan)


def _walks(q, k, v, out, lse, dout, *, scale, window, q_offset=0,
           kv_offset=0, kv_valid=None):
    """(dQ of the dQ body, dQ, dK and dV of the key-major body): each body
    walked in PyTorch over its plan's tiles, the pairs tested against the
    window-only mask only in the tiles its plan masks, P against the
    staged lse2 (+inf for a row that saw no key); (h, m, d) inputs.  A
    plan that skipped a kept tile, or that left a tile with a dropped
    pair untested, would show in the sums."""
    h, m, d = q.shape
    hkv, n = k.shape[:2]
    group = h // hkv
    valid = n if kv_valid is None else kv_valid
    dtype = q.dtype
    qs = _scaled_q(q, scale).float()
    kx, vx = (t.repeat_interleave(group, 0).float() for t in (k, v))
    do = dout.float()
    lse2 = _lse2(lse, m)[:, :m, None]
    delta = (do * out.float()).sum(-1, keepdim=True)
    keep = attention_mask(m, n, causal=True, q_offset=q_offset,
                          kv_offset=kv_offset, kv_valid=valid,
                          window=window)

    def pair(rows, keys, masked):
        p = torch.exp2(qs[:, rows] @ kx[:, keys].transpose(1, 2)
                       - lse2[:, rows])
        if masked:
            p = torch.where(keep[rows, keys], p, 0.0)
        ds = p * (do[:, rows] @ vx[:, keys].transpose(1, 2)
                  - delta[:, rows])
        return _round(p, dtype), _round(ds, dtype)

    dq_walk = torch.zeros(h, m, d)
    for m0 in range(0, m, ROW_BLOCK):
        plan = tile_plan(m0, m, valid, True, q_offset, kv_offset,
                         window=window)
        rows = slice(m0, min(m0 + ROW_BLOCK, m))
        for t in plan.tiles():
            keys = slice(t * KEY_TILE, min((t + 1) * KEY_TILE, n))
            ds = pair(rows, keys, not plan.mask_lo <= t < plan.mask)[1]
            dq_walk[:, rows] += ds @ kx[:, keys]
    dq, dk, dvx = (torch.zeros(h, x, d) for x in (m, n, n))
    for key0 in range(0, n, KEY_BLOCK):
        plan = bwd_tile_plan(key0, m, valid, True, q_offset, kv_offset,
                             window)
        keys = slice(key0, min(key0 + KEY_BLOCK, n))
        for t in range(plan.begin, plan.end):
            rows = slice(t * QUERY_TILE, min((t + 1) * QUERY_TILE, m))
            p, ds = pair(rows, keys,
                         not plan.mask_end <= t < plan.edge)
            dq[:, rows] += ds @ kx[:, keys]
            dk[:, keys] += ds.transpose(1, 2) @ qs[:, rows]
            dvx[:, keys] += p.transpose(1, 2) @ do[:, rows]
    dk = (dk * flash_bwd.LN2).view(hkv, group, n, d).sum(1)
    dvx = dvx.view(hkv, group, n, d).sum(1)
    return [(dq_walk * scale).to(dtype),
            *((x * scale).to(dtype) if x is dq else x.to(dtype)
              for x in (dq, dk, dvx))]


@pytest.mark.parametrize("kw", [
    dict(window=100),
    dict(window=30, q_offset=45, kv_valid=250),
    dict(window=200, kv_offset=17),
    dict(window=1),
], ids=["w100", "w30_offsets_kv_valid", "w200_kv_offset", "w1"])
def test_both_bodies_walks_equal_the_plain_band(kw):
    """Both bodies' walks over their band plans against
    `flash_backward_plain` over the window-only mask, f32, GQA 2, 280
    rows against 300 keys, within 1e-5."""
    rng = np.random.default_rng(11)
    q, dout = (torch.from_numpy(_rand(rng, 4, 280, 16)) for _ in "qo")
    k, v = (torch.from_numpy(_rand(rng, 2, 300, 16)) for _ in "kv")
    scale = 0.25
    opts = dict(causal=True, scale=scale, **kw)
    out, lse = _flash_fwd_impl(q, k, v, **opts)
    want = flash_backward_plain(q, k, v, out, lse, dout, **opts)
    got = _walks(q, k, v, out, lse, dout, scale=scale, **kw)
    for mine, theirs in zip(got, (want[0], *want)):
        assert (mine - theirs).abs().max().item() <= F32_TOL


# ------------------------------------------------ against the JAX package

# (q, k, v) shapes and keywords: GQA 4 q / 2 kv heads, window 48 with 5
# sinks, softcap, query rows shifted 40 positions past the keys' first
# and kv_valid inside a block; GQA with a window wider than a block, 3
# sinks, no softcap
CASES = {
    "gqa_window48_sinks5_softcap_offsets": (
        ((4, 320, 32), (2, 360, 32), (2, 360, 32)),
        dict(causal=True, window=48, sinks=5, softcap=12.0, q_offset=40,
             kv_valid=330)),
    "gqa_window200_sinks3": (
        ((4, 300, 32), (2, 300, 32), (2, 300, 32)),
        dict(causal=True, window=200, sinks=3)),
}


@functools.cache
def _case(name, dtype):
    shapes, kw = CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = (_rand(rng, *s) for s in shapes)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    out, lse = jax_fwd_impl(jq, jk, jv, scale, True, None,
                            window=kw.get("window"),
                            softcap=kw.get("softcap"),
                            sinks=kw.get("sinks"),
                            q_off=kw.get("q_offset"),
                            kv_val=kw.get("kv_valid"))
    dout = jnp.asarray(_rand(rng, *out.shape), jdt)
    return (jq, jk, jv, out, lse, dout), scale, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_banded_kernels(name, dtype):
    """`flash_backward_plain` over the band and sinks against JAX's
    `flash_backward` (its banded Pallas kernels in interpret mode and
    `_sink_patch`) on the same out, lse and dout."""
    arrays, scale, kw = _case(name, dtype)
    offsets = ("q_offset", "kv_valid")
    want = jax.jit(functools.partial(
        jax_bwd.flash_backward, scale=scale, interpret=True,
        **{x: y for x, y in kw.items() if x not in offsets}))(
            *arrays, **{x: y for x, y in kw.items() if x in offsets})
    got = flash_bwd.flash_backward(
        *(_torch(x, dtype) for x in arrays[:4]), _torch(arrays[4]),
        _torch(arrays[5], dtype), scale=scale, **kw)
    for mine, theirs in zip(got, want):
        theirs = _torch(theirs, dtype)
        assert mine.dtype == dtype and mine.shape == theirs.shape
        if dtype is torch.float32:
            assert (mine - theirs).abs().max().item() <= F32_TOL
        else:
            assert grad_mismatch(mine, theirs)[1] <= 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_sink_patch_matches_jax(name):
    arrays, scale, kw = _case(name, torch.float32)
    opts = dict(scale=scale, window=kw["window"], sinks=kw["sinks"],
                softcap=kw.get("softcap"))
    want = jax_bwd._sink_patch(*arrays, q_offset=kw.get("q_offset"),
                               kv_valid=kw.get("kv_valid"), **opts)
    got = sink_patch(*(_torch(x) for x in arrays),
                     q_offset=kw.get("q_offset", 0),
                     kv_valid=kw.get("kv_valid"), **opts)
    assert got[3] == want[3] == kw["sinks"]
    for mine, theirs in zip(got[:3], want[:3]):
        theirs = _torch(theirs)
        assert mine.shape == theirs.shape
        assert (mine - theirs).abs().max().item() <= F32_TOL
    assert got[0].abs().max() > 0 and got[1].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_band_plus_sink_rows_is_the_whole_mask(name, dtype):
    """What the card path adds up, on the CPU: the plain backward over the
    window-only band, in the input dtype as a kernel writes it, plus the
    sink pairs of the rows that keep one (`_sink_rows` with the staged
    delta, `_add_patch`: after the rounding, as on the paths that write
    the input dtype) against the plain backward over band and sinks:
    f32 within 1e-5, bf16 within `grad_mismatch`."""
    arrays, scale, kw = _case(name, dtype)
    q, k, v, out = (_torch(x, dtype) for x in arrays[:4])
    lse, dout = _torch(arrays[4]), _torch(arrays[5], dtype)
    band = {x: y for x, y in kw.items() if x != "sinks"}
    want = flash_backward_plain(q, k, v, out, lse, dout, scale=scale, **kw)
    got = [t[None].clone() for t in flash_backward_plain(
        q, k, v, out, lse, dout, scale=scale, **band)]
    patch = flash_bwd._sink_rows(
        *(t[None] for t in (q, k, v, out, lse, dout)), scale=scale,
        window=kw["window"], sinks=kw["sinks"], softcap=kw.get("softcap"),
        q_offset=kw.get("q_offset", 0), kv_valid=kw.get("kv_valid"),
        delta=flash_bwd._delta(dout[None], out[None]))
    assert patch[0] == max(0, kw["window"] - kw.get("q_offset", 0))
    flash_bwd._add_patch(got, patch)
    for mine, theirs in zip(got, want):
        if dtype is torch.float32:
            assert (mine[0] - theirs).abs().max().item() <= F32_TOL
        else:
            assert grad_mismatch(mine[0], theirs)[1] <= 1


@pytest.mark.parametrize("softcap", [None, 12.0])
def test_diff_gradients_match_jax_and_dense_autograd(softcap):
    """Gradients of sum(out·w) through both `flash_attention_diff`s with
    window 48 and 5 sinks (JAX's ``bwd_impl="pallas"``, interpret mode)
    and through dense autograd of `reference.attention_reference` over
    the same mask, f32, 4 q / 2 kv heads over 320 rows."""
    rng = np.random.default_rng(5)
    q, w = (_rand(rng, 4, 320, 32) for _ in "qw")
    k, v = (_rand(rng, 2, 320, 32) for _ in "kv")
    kw = dict(causal=True, window=48, sinks=5, softcap=softcap)

    def loss(q, k, v):
        return jnp.sum(jax_diff(q, k, v, **kw) * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    mine, dense = ([torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
                   for _ in "md")
    (flash_attention_diff(*mine, **kw) * torch.from_numpy(w)).sum() \
        .backward()
    (attention_reference(*dense, **kw) * torch.from_numpy(w)).sum() \
        .backward()
    for t, d_, theirs in zip(mine, dense, want):
        assert np.abs(t.grad.numpy() - np.asarray(theirs)).max() <= F32_TOL
        assert (t.grad - d_.grad).abs().max().item() <= F32_TOL


# the JAX package's windowed sink model (`test_sinks_model_trains_with_
# flash_impl`), with rope so that the sink keys rotate at their own
# positions, on two sequences of 200 tokens
WINDOWED = dict(vocab=31, dim=32, depth=1, num_q_heads=4, num_kv_heads=2,
                window=128, attn_sinks=4, rope=True)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX windowed model on a 1-device mesh: its initial params,
    loss and gradients on one batch, and three AdamW steps."""
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **WINDOWED)
    mesh = jax_train.make_mesh_3d(1)
    params, _, opt_state = jax_train.init_sharded(jmodel, mesh, batch=2,
                                                  seq=200, seed=0, lr=1e-3)
    tokens = np.random.default_rng(3).integers(0, WINDOWED["vocab"],
                                               (2, 200))
    batch = jnp.asarray(tokens, jnp.int32)
    init = jax.device_get(params)
    loss, grads = jax.jit(jax.value_and_grad(jax_train.loss_fn),
                          static_argnums=1)(params, jmodel, batch)
    step = jax_train.make_train_step(jmodel, optax.adamw(1e-3), mesh)
    losses = []
    for _ in range(3):
        params, opt_state, step_loss = step(params, opt_state, batch)
        losses.append(float(step_loss))
    return dict(init=init, tokens=torch.from_numpy(tokens), loss=float(loss),
                grads=params_from_jax(jax.device_get(grads)), losses=losses,
                final=params_from_jax(jax.device_get(params)))


def _model(jax_run):
    model = TinyDecoder(dtype=torch.float32, device="cpu", **WINDOWED)
    optimizer = init_train(model, seed=0, lr=1e-3)
    model.load_state_dict(params_from_jax(jax_run["init"]))
    return model, optimizer


def test_windowed_model_loss_and_gradients_match_jax(jax_run):
    model, _ = _model(jax_run)
    loss = loss_fn(model, jax_run["tokens"])
    loss.backward()
    assert abs(loss.item() - jax_run["loss"]) <= 1e-6
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(jax_run["grads"])
    for name, want in jax_run["grads"].items():
        assert (grads[name].grad - want).abs().max().item() <= 1e-6, name


def test_windowed_model_three_adamw_steps_match_jax(jax_run):
    model, optimizer = _model(jax_run)
    step = make_train_step(model, optimizer)
    losses = [step(jax_run["tokens"]).item() for _ in range(3)]
    np.testing.assert_allclose(losses, jax_run["losses"], atol=2e-5,
                               rtol=0)
    assert losses[2] < losses[0]
    for name, p in model.named_parameters():
        assert (p.detach() - jax_run["final"][name]).abs().max() <= 2e-6


# --------------------------------------------------------------- refusals


@pytest.mark.parametrize("kw,match", [
    (dict(causal=False, window=8), "requires causal"),
    (dict(causal=True, sinks=2), "sinks require window"),
    (dict(causal=True, window=8, sinks=2, kv_offset=0), "kv_offset"),
    (dict(causal=True, window=8, sinks=2,
          q_segment_ids=torch.zeros(16, dtype=torch.int32),
          kv_segment_ids=torch.zeros(16, dtype=torch.int32)),
     "segment_ids"),
], ids=["window_needs_causal", "sinks_need_window", "sinks_kv_offset",
        "sinks_segment_ids"])
def test_jax_band_refusals_raise_value_error(kw, match):
    """JAX's four refusals of `flash_backward` (attention_tpu/ops/
    flash_bwd.py:797-812) raise `ValueError` in the port's backward and
    in `flash_attention_diff`, before any work; ``block_sizes`` alone
    stays `NotImplementedError`.  Segment ids, ported since, run under
    the band: the backward's gradients equal dense autograd through the
    plain reference over the band and the segments' mask (f32)."""
    q = torch.zeros(16, 8, requires_grad=True)
    with pytest.raises(ValueError, match=match):
        flash_bwd.flash_backward(q, q, q, q, torch.zeros(16), q, scale=1.0,
                                 **kw)
    with pytest.raises(ValueError, match=match):
        flash_attention_diff(q, q, q, **kw)
    with pytest.raises(NotImplementedError):
        flash_bwd.flash_backward(q, q, q, q, torch.zeros(16), q, scale=1.0,
                                 causal=True, window=8, block_sizes=(8, 8))
    x = torch.from_numpy(_rand(np.random.default_rng(11), 2, 16, 8))
    ids = torch.tensor([0] * 6 + [1] * 10, dtype=torch.int32)
    band = dict(causal=True, window=8, q_segment_ids=ids, kv_segment_ids=ids)
    dense = x.clone().requires_grad_()
    dout = torch.from_numpy(_rand(np.random.default_rng(12), 2, 16, 8))
    attention_reference(dense, dense, dense, **band).backward(dout)
    out, lse = _flash_fwd_impl(x, x, x, scale=8 ** -0.5, **band)
    got = flash_bwd.flash_backward(x, x, x, out, lse, dout, scale=8 ** -0.5,
                                   **band)
    assert (sum(got) - dense.grad).abs().max().item() <= F32_TOL
