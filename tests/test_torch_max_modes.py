"""The max_mode variants of the port against the JAX package, on the CPU.

"online", "bound" (the row bound with its overshoot guard), "flashd"
(FLASH-D) and "amla" (AMLA) compute the same softmax; they differ in the
value each subtracts from a row's scores, which `flash_attention_partials`
returns as its row max.  The same numpy inputs from a seed go through
the JAX function (Pallas interpret mode) and through the port's (its
plain versions: the tensors lie on the CPU).  Bound resolves to online
below `_BOUND_MIN_SCORE_ELEMS` score elements in both packages; the
tests pin it to 0 on both sides (JAX's jit caches freeze it, so they are
cleared at both edges) and restore it after.

Tolerances, with their reasons:

* outputs, f32, 2e-5 max abs: both sides compute in full f32 and differ
  in summation order and where the scale is folded in; under bound the
  unnormalized output is scaled by 2^-(overshoot).
* row max, 1e-6 relative, and 1e-6 absolute below 1 (equal where it is
  -inf): the subtracted value itself, a norm product, a row's largest
  score or a whole number of log2 units, each one or two f32 roundings
  apart; a score is a dot product, whose rounding error is absolute (of
  the size of its terms), so a row max near 0 is held absolutely.
* row sum, 1e-5 relative: a sum of at most 128 terms in another order.
  FLASH-D's row sum is 1 for a row that saw a key; for a row that saw
  none the port gives 0 (its stats do not depend on the tiling), where
  JAX's kernel leaves 1 or 0 by whether its tile was computed; such a
  row's max is -inf on both sides, so it weighs nothing in a merge.
* gradients, f32, 1e-4 max abs: the backward recomputes P from the lse
  of each variant's forward; both sides in f32.

The sharded forwards run in a gloo world of 2 CPU ranks, which import
this module: it imports the JAX package only inside the functions that
run in the test process (`_jx`).
"""

import functools
import math
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from attention_tpu_torch.models import (
    TinyDecoder,
    init_train,
    make_train_step,
    params_from_jax,
)
from attention_tpu_torch.models.train import loss_fn
from attention_tpu_torch.ops import decode, flash
from attention_tpu_torch.ops import ragged_paged as rp
from attention_tpu_torch.ops.flash_vjp import flash_attention_diff
from attention_tpu_torch.parallel import (
    cp_flash_attention,
    kv_sharded_attention,
    ring_attention,
    ring_attention_diff,
    ulysses_attention,
)
MODES = ("online", "bound", "flashd", "amla")
OUT_TOL, MAX_RTOL, SUM_RTOL, GRAD_TOL = 2e-5, 1e-6, 1e-5, 1e-4
H, HKV, D = 4, 2, 32


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@functools.cache
def _jx():
    """The JAX package's modules, imported in the test process only."""
    import jax
    import jax.numpy as jnp

    from attention_tpu.models import TinyDecoder
    from attention_tpu.models import train
    from attention_tpu.ops import decode as dec
    from attention_tpu.ops import flash as fl
    from attention_tpu.ops import ragged_paged
    from attention_tpu.ops.flash_vjp import flash_attention_diff
    from tests.test_torch_ops import _ragged_case

    return SimpleNamespace(jax=jax, jnp=jnp, TinyDecoder=TinyDecoder,
                           train=train, decode=dec, flash=fl,
                           rp=ragged_paged, diff=flash_attention_diff,
                           ragged_case=_ragged_case)


_SEG = np.repeat(np.arange(3), [40, 30, 26]).astype(np.int32)
# name: (m, n, keywords).  Rows 0-4 of "causal_offsets" see no key.
CASES = {
    "noncausal_softcap": (96, 128, dict(softcap=10.0)),
    "causal_offsets": (64, 128, dict(causal=True, q_offset=3, kv_offset=8,
                                     kv_valid=100)),
    "causal_segments": (96, 96, dict(causal=True, q_segment_ids=_SEG,
                                     kv_segment_ids=_SEG)),
    "window_sinks": (128, 128, dict(causal=True, window=40, sinks=4)),
}


def _inputs(name, seed=0):
    m, n, kw = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    return (_rand(rng, H, m, D), _rand(rng, HKV, n, D),
            _rand(rng, HKV, n, D)), kw


def _t(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}


class _Pinned:
    """Both packages' bound threshold at 0 (JAX's caches cleared at both
    edges), or their own values."""

    def __enter__(self):
        j = _jx()
        self.old = j.flash._BOUND_MIN_SCORE_ELEMS, \
            flash._BOUND_MIN_SCORE_ELEMS
        j.jax.clear_caches()
        j.flash._BOUND_MIN_SCORE_ELEMS = flash._BOUND_MIN_SCORE_ELEMS = 0

    def __exit__(self, *exc):
        j = _jx()
        j.flash._BOUND_MIN_SCORE_ELEMS, flash._BOUND_MIN_SCORE_ELEMS = \
            self.old
        j.jax.clear_caches()


# the case and variant (the model's) whose flash output is JAX's
# `flash_attention` itself; the others hold it against JAX's partials
# normalized (out / row sum), which is the same function and costs no
# second interpret-mode run
NORMALIZED_CASE = ("causal_segments", "bound")


@pytest.fixture(scope="module")
def jax_flash_runs():
    """(case, mode) -> JAX's (flash output, partials), the threshold
    pinned."""
    j = _jx()
    runs = {}
    with _Pinned():
        for name in CASES:
            (q, k, v), kw = _inputs(name)
            for mode in MODES:
                args = (j.jnp.asarray(q), j.jnp.asarray(k), j.jnp.asarray(v))
                parts = tuple(np.asarray(x) for x in
                              j.flash.flash_attention_partials(
                                  *args, max_mode=mode, **kw))
                if (name, mode) == NORMALIZED_CASE:
                    out = np.asarray(j.flash.flash_attention(
                        *args, max_mode=mode, **kw))
                else:
                    out = parts[0] / np.where(parts[2] == 0, 1,
                                              parts[2])[..., None]
                runs[name, mode] = (out, parts)
    return runs


def _hold_stats(got, want, mode):
    """The port's (out, row max, row sum) against JAX's, as the module
    docstring says."""
    out, rmax, rsum = (x.numpy() for x in got)
    w_out, w_max, w_sum = want
    assert np.abs(out - w_out).max() <= OUT_TOL
    empty = np.isneginf(w_max)
    np.testing.assert_array_equal(np.isneginf(rmax), empty)
    seen = ~empty
    assert (np.abs(rmax[seen] - w_max[seen])
            <= MAX_RTOL * np.maximum(np.abs(w_max[seen]), 1.0)).all()
    assert (np.abs(rsum - w_sum)[seen]
            <= SUM_RTOL * np.abs(w_sum[seen])).all()
    assert (rsum[empty] == 0).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_and_partials_match_jax(monkeypatch, jax_flash_runs, name,
                                      mode):
    monkeypatch.setattr(flash, "_BOUND_MIN_SCORE_ELEMS", 0)
    (q, k, v), kw = _inputs(name)
    qkv = [torch.from_numpy(x) for x in (q, k, v)]
    w_out, w_parts = jax_flash_runs[name, mode]
    got = flash.flash_attention(*qkv, max_mode=mode, **_t(kw))
    assert np.abs(got.numpy() - w_out).max() <= OUT_TOL
    _hold_stats(flash.flash_attention_partials(*qkv, max_mode=mode,
                                               **_t(kw)), w_parts, mode)


def test_each_variant_subtracts_its_own_value(monkeypatch, jax_flash_runs):
    """The stats of one call under each variant: bound's row max is the
    row bound, at or above online's (and finite on rows that see no key,
    whose sum is 0), amla's online's ceiled to a whole number of log2
    units, flashd's the lse with sum 1; all four give one lse."""
    monkeypatch.setattr(flash, "_BOUND_MIN_SCORE_ELEMS", 0)
    (q, k, v), kw = _inputs("causal_offsets")
    qkv = [torch.from_numpy(x) for x in (q, k, v)]
    parts = {mode: flash.flash_attention_partials(*qkv, max_mode=mode,
                                                  **_t(kw))
             for mode in MODES}
    online_max = parts["online"][1]
    seen = torch.isfinite(online_max)
    assert not seen[:, :5].any() and seen[:, 5:].all()
    assert (parts["bound"][1][seen] >= online_max[seen]).all()
    assert torch.isfinite(parts["bound"][1]).all()
    assert (parts["bound"][2][~seen] == 0).all()
    assert torch.equal(parts["amla"][1][seen] / math.log(2),
                       torch.ceil(online_max[seen] / math.log(2)))
    assert torch.equal(parts["flashd"][2], seen.float())
    lse = [torch.where(seen, mx + torch.log(sm), -math.inf)
           for _, mx, sm in parts.values()]
    for other in lse[1:]:
        assert (other - lse[0])[seen].abs().max() <= 1e-5


def test_bound_resolution_matches_jax(jax_flash_runs):
    """A windowed call and a call below the threshold resolve "bound" to
    online on both sides: online's stats (the threshold left at its
    value; JAX's windowed bound call is the pinned run, a window resolves
    it whatever the threshold)."""
    j = _jx()
    for name in ("window_sinks", "noncausal_softcap"):
        (q, k, v), kw = _inputs(name)
        assert flash.resolve_max_mode(
            "bound", heads=H, m=q.shape[1], n=k.shape[1],
            causal=kw.get("causal", False),
            window=kw.get("window")) == "online"
        want_online = jax_flash_runs[name, "online"][1]
        if name == "window_sinks":
            want = jax_flash_runs[name, "bound"][1]
        else:
            want = [np.asarray(x) for x in j.flash.flash_attention_partials(
                *(j.jnp.asarray(x) for x in (q, k, v)), max_mode="bound",
                **kw)]
        for a, b in zip(want, want_online):
            np.testing.assert_array_equal(a, b)
        qkv = [torch.from_numpy(x) for x in (q, k, v)]
        got = flash.flash_attention_partials(*qkv, max_mode="bound",
                                             **_t(kw))
        for a, b in zip(got, flash.flash_attention_partials(
                *qkv, max_mode="online", **_t(kw))):
            assert torch.equal(a, b)
        _hold_stats(got, want, "online")
    assert flash.resolve_max_mode("bound", heads=32, m=8192, n=8192,
                                  causal=True) == "bound"


def _jax_estimate(q, k, kw, scale):
    j = _jx()
    hkv, n = k.shape[0], k.shape[1]
    k32 = j.jnp.asarray(k)
    knmax = j.jnp.repeat(j.jnp.max(j.jnp.sqrt(j.jnp.sum(k32 * k32, -1)), -1),
                       q.shape[0] // hkv)
    offsets = j.jnp.asarray([kw.get("q_offset", 0), kw.get("kv_offset", 0),
                           kw.get("kv_valid", n)], j.jnp.int32)
    softcap = kw.get("softcap")
    return float(j.flash._bound_overshoot_estimate(
        j.jnp.asarray(q * (scale * j.flash._LOG2E)), k32, knmax, offsets,
        m=q.shape[1], n=n, group=q.shape[0] // hkv,
        causal=kw.get("causal", False), window=kw.get("window"),
        sinks=kw.get("sinks"),
        softcap2=None if softcap is None else softcap * j.flash._LOG2E,
        q_segment_ids=kw.get("q_segment_ids"),
        kv_segment_ids=kw.get("kv_segment_ids")))


@pytest.mark.parametrize("name", sorted(CASES))
def test_overshoot_estimate_matches_jax(name):
    (q, k, v), kw = _inputs(name)
    scale = D ** -0.5
    q4, k4 = (torch.from_numpy(x)[None] for x in (q, k))
    tkw = _t({key: val for key, val in kw.items() if key != "softcap"})
    got = flash.bound_overshoot_estimate(
        q4, k4, flash.key_norm_max(k4), scale=scale,
        softcap=kw.get("softcap"), **tkw).item()
    want = _jax_estimate(q, k, kw, scale)
    assert 0 < want < flash.SAFE_OVERSHOOT_LOG2
    assert abs(got - want) <= 1e-5 * abs(want)


def test_planted_outlier_key_demotes_on_both_sides(monkeypatch):
    """A key row of norm 4000 (an outlier channel) puts the bound far past
    every row's scores: both sides' estimates exceed the limit, the call
    takes online's stats, and the output stays finite."""
    j = _jx()
    (q, k, v), kw = _inputs("causal_offsets")
    k = k.copy()
    k[1, 90] *= 4000.0 / np.linalg.norm(k[1, 90])
    assert _jax_estimate(q, k, kw, D ** -0.5) > flash.SAFE_OVERSHOOT_LOG2
    with _Pinned():
        want = [np.asarray(x) for x in j.flash.flash_attention_partials(
            *(j.jnp.asarray(x) for x in (q, k, v)), max_mode="bound", **kw)]
    monkeypatch.setattr(flash, "_BOUND_MIN_SCORE_ELEMS", 0)
    qkv = [torch.from_numpy(x) for x in (q, k, v)]
    got = flash.flash_attention_partials(*qkv, max_mode="bound", **kw)
    online = flash.flash_attention_partials(*qkv, max_mode="online", **kw)
    for a, b in zip(got, online):
        assert torch.equal(a, b)
    _hold_stats(got, want, "online")
    assert torch.isfinite(flash.flash_attention(
        *qkv, max_mode="bound", **kw)).all()


def test_demotion_count_sums_the_verdicts_until_reset():
    """The bound launches' guard verdicts add up on their device (no sync
    until the count is read), and `reset_launch_counts` clears them with
    the launch counts."""
    from attention_tpu_torch.ops import _native, demotion_count, \
        reset_launch_counts

    reset_launch_counts()
    assert demotion_count() == 0
    verdicts = [torch.tensor(x, dtype=torch.int32) for x in (0, 1, 1)]
    for verdict in verdicts:
        _native.count_demotion(verdict)
    assert demotion_count() == 2
    assert [int(x) for x in verdicts] == [0, 1, 1]
    reset_launch_counts()
    assert demotion_count() == 0


@pytest.fixture(scope="module")
def jax_diff_runs():
    """mode -> JAX's flash_attention_diff output and dq, dk, dv on the
    offsets case (softcap added), the threshold pinned."""
    j = _jx()
    (q, k, v), kw = _inputs("causal_offsets")
    kw = dict(kw, softcap=10.0)
    w = _rand(np.random.default_rng(5), H, q.shape[1], D)
    runs = {}
    with _Pinned():
        for mode in MODES:
            out, vjp = j.jax.vjp(
                lambda *a, mode=mode: j.diff(*a, max_mode=mode, **kw),
                *(j.jnp.asarray(x) for x in (q, k, v)))
            runs[mode] = (np.asarray(out),
                          [np.asarray(g) for g in vjp(j.jnp.asarray(w))])
    return (q, k, v), kw, w, runs


@pytest.mark.parametrize("mode", MODES)
def test_diff_gradients_match_jax(monkeypatch, jax_diff_runs, mode):
    monkeypatch.setattr(flash, "_BOUND_MIN_SCORE_ELEMS", 0)
    (q, k, v), kw, w, runs = jax_diff_runs
    want_out, want_grads = runs[mode]
    for bwd_impl in ("pallas", "xla"):
        qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = flash_attention_diff(*qkv, max_mode=mode, bwd_impl=bwd_impl,
                                   **kw)
        assert np.abs(out.detach().numpy() - want_out).max() <= GRAD_TOL
        (out * torch.from_numpy(w)).sum().backward()
        for t, theirs in zip(qkv, want_grads):
            assert np.abs(t.grad.numpy() - theirs).max() <= GRAD_TOL


# ----------------------------------------------------- decode and ragged

DECODE_MODES = ("flashd", "amla")


def _decode_inputs(chunk):
    rng = np.random.default_rng(11)
    b, n = 3, 256
    q = _rand(rng, b, H, 4, D) if chunk else _rand(rng, b, H, D)
    caches = _rand(rng, b, HKV, n, D), _rand(rng, b, HKV, n, D)
    return q, caches, np.array([1, 97, 230], np.int32)


@pytest.mark.parametrize("chunk,band", [(False, None), (True, (24, 3))],
                         ids=["decode", "chunk_window"])
@pytest.mark.parametrize("mode", DECODE_MODES)
def test_decode_variants_match_jax(mode, chunk, band):
    j = _jx()
    q, (kc, vc), lens = _decode_inputs(chunk)
    kw = {} if band is None else dict(window=band[0], sinks=band[1])
    jfn = j.decode.flash_decode_chunk if chunk else j.decode.flash_decode
    fn = decode.flash_decode_chunk if chunk else decode.flash_decode
    want = np.asarray(jfn(*(j.jnp.asarray(x) for x in (q, kc, vc, lens)),
                          max_mode=mode, softcap=8.0, **kw))
    got = fn(*(torch.from_numpy(x) for x in (q, kc, vc, lens)),
             max_mode=mode, softcap=8.0, **kw).numpy()
    assert np.abs(got - want).max() <= OUT_TOL


@pytest.mark.parametrize("mode,band", [("flashd", (48, 4)), ("amla", None)],
                         ids=["flashd_window", "amla"])
def test_ragged_variants_match_jax(mode, band):
    j = _jx()
    pools, table, lens, cu, dist_, pos, slot, rows, q, q_tile = \
        j.ragged_case()
    kw = {} if band is None else dict(window=band[0], sinks=band[1])
    jstep = j.rp.RaggedPagedStep(
        *(j.jnp.asarray(a) for a in (*pools, table, lens, cu, dist_, pos,
                                   slot)),
        np.zeros((q_tile,), np.int32))
    jstep = j.rp.ragged_paged_append(jstep, *map(j.jnp.asarray, rows))
    want = np.asarray(j.rp.ragged_paged_attention(
        j.jnp.asarray(q), jstep, max_mode=mode, **kw))
    tstep = rp.RaggedPagedStep(
        *(torch.from_numpy(a.copy()) for a in (*pools, table, lens, cu,
                                               dist_, pos, slot)), q_tile)
    tstep = rp.ragged_paged_append(tstep, *map(torch.from_numpy, rows))
    got = rp.ragged_paged_attention(torch.from_numpy(q), tstep,
                                    max_mode=mode, **kw).numpy()
    live = ~np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), ~live)
    assert np.abs(got[live] - want[live]).max() <= OUT_TOL


def test_decode_side_refusals():
    """"bound" is forward-only on the decode side (JAX's ValueError),
    "auto" not ported (NotImplementedError), on all three entries."""
    j = _jx()
    q, (kc, vc), lens = _decode_inputs(False)
    args = [torch.from_numpy(x) for x in (q, kc, vc, lens)]
    pools, table, lens_r, cu, dist_, pos, slot, rows, qr, q_tile = \
        j.ragged_case()
    step = rp.RaggedPagedStep(
        *(torch.from_numpy(a.copy()) for a in (*pools, table, lens_r, cu,
                                               dist_, pos, slot)), q_tile)
    calls = [lambda m: decode.flash_decode(*args, max_mode=m),
             lambda m: decode.flash_decode_chunk(
                 args[0][:, :, None], *args[1:], max_mode=m),
             lambda m: rp.ragged_paged_attention(torch.from_numpy(qr), step,
                                                 max_mode=m)]
    for call in calls:
        with pytest.raises(ValueError, match="forward-only"):
            call("bound")
        with pytest.raises(NotImplementedError):
            call("auto")
    with pytest.raises(ValueError, match="forward-only"):
        j.decode.flash_decode(*(j.jnp.asarray(x) for x in (q, kc, vc, lens)),
                                max_mode="bound")


# ------------------------------------------------------------ the model

SMALL = dict(vocab=43, dim=64, depth=2, num_q_heads=4, num_kv_heads=2,
             rope=True, softcap=20.0)


@pytest.fixture(scope="module")
def jax_model_run():
    """JAX's small flash model (its attention runs max_mode "bound") with
    the threshold pinned: initial params, and one train step on one batch:
    its loss (the forward) and the params it leaves."""
    import optax

    j = _jx()
    with _Pinned():
        jmodel = j.TinyDecoder(impl="flash", dtype=j.jnp.float32, **SMALL)
        mesh = j.train.make_mesh_3d(1)
        params, _, opt_state = j.train.init_sharded(
            jmodel, mesh, batch=2, seq=17, seed=0, lr=1e-3)
        tokens = np.random.default_rng(7).integers(0, SMALL["vocab"],
                                                   (2, 17))
        batch = j.jnp.asarray(tokens, j.jnp.int32)
        init = j.jax.device_get(params)
        step = j.train.make_train_step(jmodel, optax.adamw(1e-3), mesh)
        params, opt_state, step_loss = step(params, opt_state, batch)
    return dict(init=init, tokens=torch.from_numpy(tokens),
                step_loss=float(step_loss),
                final=params_from_jax(j.jax.device_get(params)))


def test_model_forward_and_train_step_match_jax(monkeypatch, jax_model_run):
    """`TinyDecoder(impl="flash")` with JAX's weights, its attention under
    "bound" on both sides (the threshold pinned): one AdamW step's loss
    (the forward) within 2e-5 and the parameters it leaves within 2e-6
    (tests/test_torch_train.py's tolerances) where the step's gradient is
    above 1e-5.  AdamW's first step moves a parameter by lr·g/(|g| +
    1e-8), so where |g| is near 1e-8 gradients 1e-7 apart move it by up
    to lr apart: there the parameters are held within 2·lr."""
    monkeypatch.setattr(flash, "_BOUND_MIN_SCORE_ELEMS", 0)
    run = jax_model_run
    model = TinyDecoder(dtype=torch.float32, device="cpu", impl="flash",
                        **SMALL)
    optimizer = init_train(model, seed=0, lr=1e-3)
    model.load_state_dict(params_from_jax(run["init"]))
    loss_fn(model, run["tokens"]).backward()
    steep = {name: p.grad.abs() > 1e-5 for name, p in
             model.named_parameters()}
    model.zero_grad()
    step = make_train_step(model, optimizer)
    assert abs(step(run["tokens"]).item() - run["step_loss"]) <= 2e-5
    for name, p in model.named_parameters():
        diff = (p.detach() - run["final"][name]).abs()
        assert diff[steep[name]].max() <= 2e-6, name
        assert diff.max() <= 2e-3, name


# ---------------------------------------------------- the sharded forwards

SHARD_MODES = ("bound", "flashd")


def _shard_inputs():
    rng = np.random.default_rng(21)
    return _rand(rng, H, 128, D), _rand(rng, HKV, 128, D), \
        _rand(rng, HKV, 128, D)


def _shard_worker(rank, world, init_file, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        flash._BOUND_MIN_SCORE_ELEMS = 0
        q, k, v = (torch.from_numpy(x) for x in _shard_inputs())
        outs = {}
        for mode in SHARD_MODES:
            kw = {} if mode == "bound" else dict(max_mode=mode)
            outs["kv", mode] = kv_sharded_attention(q, k, v, causal=True,
                                                    **kw)
            outs["ring", mode] = ring_attention(q, k, v, causal=True, **kw)
            outs["zigzag", mode] = ring_attention(
                q, k, v, causal=True, schedule="zigzag", **kw)
        torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def shard_outputs(tmp_path_factory):
    """Each rank's outputs of a gloo world of 2 CPU ranks, and JAX's
    single flash call by mode (computed while the world runs)."""
    j = _jx()
    out = tmp_path_factory.mktemp("max_mode_world")
    ctx = mp.spawn(_shard_worker, nprocs=2, join=False,
                   args=(2, str(out / "init"), str(out)))
    with _Pinned():
        want = {mode: np.asarray(j.flash.flash_attention(
            *(j.jnp.asarray(x) for x in _shard_inputs()), causal=True,
            max_mode=mode)) for mode in SHARD_MODES}
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("gloo world of 2 hung")
    return [torch.load(out / f"rank{r}.pt") for r in range(2)], want


@pytest.mark.parametrize("mode", SHARD_MODES)
@pytest.mark.parametrize("path", ["kv", "ring", "zigzag"])
def test_sharded_forwards_match_jax_single_call(shard_outputs, path, mode):
    """kv-sharded and ring (both schedules) on 2 ranks, under their
    default "bound" and under "flashd": each rank's output equals JAX's
    single flash call on the whole inputs within 2e-5, the same bits on
    both ranks."""
    ranks, want = shard_outputs
    outs = [o[path, mode] for o in ranks]
    assert torch.equal(outs[0], outs[1])
    assert np.abs(outs[0].numpy() - want[mode]).max() <= OUT_TOL


def test_merges_weigh_a_shard_by_its_row_sum():
    """Under "bound" a shard that saw no key has a finite row max (its
    bound): the kv-sharded merge and the ring's step merge weigh it by
    its sum of 0, even where its bound exceeds the other shard's max."""
    from attention_tpu_torch.parallel.kv_sharded import merge_partials
    from attention_tpu_torch.parallel.mesh import default_mesh
    from attention_tpu_torch.parallel.ring import _finalize, _merge_step

    out = torch.ones(2, 3)
    lmax, lsum = torch.tensor([1.0, 2.0]), torch.tensor([2.0, 4.0])
    empty = (torch.zeros(2, 3), torch.tensor([500.0, 900.0]), torch.zeros(2))
    state = (torch.zeros(2, 3), torch.full((2,), -math.inf), torch.zeros(2))
    for parts in ((out, lmax, lsum), empty):
        state = _merge_step(state, *parts)
    got, lse = _finalize(state, torch.float32)
    assert torch.allclose(got, out / lsum[:, None])
    assert torch.allclose(lse, lmax + torch.log(lsum))
    merged = merge_partials(*empty, "kv", mesh=default_mesh("kv"))
    assert torch.equal(merged, torch.zeros(2, 3))


def test_auto_is_not_ported_on_any_entry():
    """max_mode="auto" raises NotImplementedError on every entry that
    takes a max_mode (the tuning table is not ported)."""
    q = torch.zeros(4, 16, 8)
    kv = torch.zeros(2, 16, 8)
    calls = [
        lambda: flash.flash_attention(q, kv, kv, max_mode="auto"),
        lambda: flash.flash_attention_partials(q, kv, kv, max_mode="auto"),
        lambda: flash_attention_diff(q, kv, kv, max_mode="auto"),
        lambda: kv_sharded_attention(q, kv, kv, max_mode="auto"),
        lambda: ring_attention(q, kv, kv, max_mode="auto"),
        lambda: ring_attention_diff(q, kv, kv, max_mode="auto"),
        lambda: ulysses_attention(q, kv, kv, max_mode="auto"),
        lambda: cp_flash_attention(q, kv, kv, max_mode="auto"),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="tuning table"):
            call()
