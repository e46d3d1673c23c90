"""The port's distributed backends against the JAX package's, on the CPU.

The port's side runs in gloo worlds of R = 1 to 4 CPU processes
(`torch.multiprocessing.spawn`), each world started once for the module:
every rank runs every case of its world size and saves its outputs, and
the parametrised tests then hold them case by case.  The JAX side runs
the same numpy inputs on the first R devices of the package's 8-device
CPU mesh, its Pallas kernels in interpret mode.  The spawned ranks
import this module, so it imports JAX only inside the functions that run
in the test process.

The masking surface (`MASKED`: window 48, window 48 with 8 sinks,
window 32 with softcap 15, and packed ids of 3 uneven segments, as
tests/test_distributed_features.py pins JAX's) runs on kv-sharded, ring
(both schedules) and Ulysses in the world of 4, each also held against
the port's single-device `flash_attention` on the same inputs.

Tolerances: f32 1e-5 max abs (`reference.mismatch`'s f32 limit; both
sides compute in full f32 and differ only in summation order); bf16
`mismatch`'s bf16 limit against JAX's bf16 output and ±0.02 against the
fp64 oracle (the reference's contract); across ranks the same bits.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from attention_tpu_torch.api import attention
from attention_tpu_torch.core import testcase
from attention_tpu_torch.core.oracle import attention_oracle
from attention_tpu_torch.ops.flash import flash_attention
from attention_tpu_torch.ops.reference import F32_ATOL, mismatch
from attention_tpu_torch.parallel import (
    choose_kv_placement,
    kv_sharded_attention,
    q_sharded_attention,
    ring_attention,
    ulysses_attention,
)
from attention_tpu_torch.parallel.kv_sharded import merge_partials
from attention_tpu_torch.parallel.mesh import default_mesh, hybrid_mesh

WORLDS = (1, 2, 3, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _s(*shapes):
    return shapes if len(shapes) == 3 else shapes * 3


# name: (world sizes, (q, k, v) shapes, function, keywords).  The
# function names the port's entry point; "api:<backend>" goes through
# `api.attention`, "hybrid_*" runs on the (2, 2) `hybrid_mesh`.
CASES = {
    "kv_flash": (WORLDS, _s((64, 32), (256, 32), (256, 32)), "kv", {}),
    "kv_torch": (WORLDS, _s((64, 32), (256, 32), (256, 32)), "kv",
                 {"impl": "torch"}),
    "kv_causal_flash": (WORLDS, _s((128, 16)), "kv", {"causal": True}),
    "kv_causal_torch": ((2, 4), _s((128, 16)), "kv",
                        {"causal": True, "impl": "torch"}),
    "kv_causal_softcap": ((3,), _s((96, 16)), "kv",
                          {"causal": True, "softcap": 5.0}),
    "kv_indivisible": ((3, 4), _s((33, 16), (250, 16), (250, 24)), "kv",
                       {}),
    # n = 5 over 4 ranks: the last shard is all padding (kv_valid 0)
    "kv_all_padding": ((3, 4), _s((8, 16), (5, 16), (5, 16)), "kv", {}),
    "kv_gqa_3d": ((2, 4), _s((4, 32, 16), (2, 128, 16), (2, 128, 16)),
                  "kv", {}),
    "kv_gqa_3d_torch": ((3,), _s((4, 32, 16), (2, 128, 16), (2, 128, 16)),
                        "kv", {"impl": "torch"}),
    "q_sharded": (WORLDS, _s((100, 16), (64, 16), (64, 16)), "q", {}),
    "q_sharded_causal": ((2, 4), _s((128, 16)), "q", {"causal": True}),
    "ring": ((2, 4), _s((128, 32), (256, 32), (256, 32)), "ring", {}),
    "ring_indivisible": ((3, 4), _s((100, 16), (190, 16), (190, 16)),
                         "ring", {}),
    "ring_causal": (WORLDS, _s((128, 16)), "ring", {"causal": True}),
    "ring_zigzag": (WORLDS, _s((128, 16)), "ring",
                    {"causal": True, "schedule": "zigzag"}),
    "ring_zigzag_indivisible": ((3,), _s((100, 16)), "ring",
                                {"causal": True, "schedule": "zigzag"}),
    "ring_gqa_4d": ((2, 4), _s((2, 4, 64, 16), (2, 2, 64, 16),
                               (2, 2, 64, 16)), "ring", {}),
    "ulysses": ((1, 2, 4), _s((8, 64, 16)), "ulysses", {}),
    "ulysses_causal_4d": ((2,), _s((2, 4, 32, 8), (2, 2, 32, 8),
                                   (2, 2, 32, 8)), "ulysses",
                          {"causal": True}),
    # 2 kv heads on 4 ranks: repeated to the mesh size (2x), not 8x
    "ulysses_gqa_minimal": ((4,), _s((16, 32, 8), (2, 32, 8), (2, 32, 8)),
                            "ulysses", {}),
    # 3 kv heads on 4 ranks divide neither way: the full repeat
    "ulysses_gqa_full": ((4,), _s((12, 32, 8), (3, 32, 8), (3, 32, 8)),
                         "ulysses", {}),
    "ulysses_bad_heads": ((4,), _s((6, 32, 8)), "ulysses", {}),
    "api:kv-sharded": ((2, 4), _s((64, 16), (128, 16), (128, 16)),
                       "api:kv-sharded", {}),
    "api:q-sharded": ((2, 4), _s((64, 16), (128, 16), (128, 16)),
                      "api:q-sharded", {}),
    "api:ring": ((2, 4), _s((64, 16), (128, 16), (128, 16)), "api:ring",
                 {}),
    "api:ulysses": ((2, 4), _s((8, 64, 16)), "api:ulysses", {}),
    # tiny KV: the replicate arm (q-sharded); threshold 1: the shard arm
    "api:auto": ((2, 4), _s((256, 16), (128, 16), (128, 16)), "api:auto",
                 {}),
    "api:auto_shard": ((2, 4), _s((64, 16), (128, 16), (128, 16)),
                       "api:auto", {"threshold_bytes": 1, "causal": True}),
    "hybrid_kv": ((4,), _s((64, 16), (256, 16), (256, 16)), "hybrid_kv",
                  {}),
    "hybrid_ulysses_batch": ((4,), _s((2, 4, 32, 8), (2, 2, 32, 8),
                                      (2, 2, 32, 8)), "hybrid_ulysses",
                             {}),
    "kv_bf16": ((2, 4), _s((64, 64), (256, 64), (256, 64)), "kv_bf16", {}),
}
# the masking surface on every sharded path, world 4: the band crossing
# shard boundaries, the sink prefix, softcap under a band, and packed ids
# ("packed": 3 uneven segments, the same ids for queries and keys; 125
# rows where the path takes a length that does not divide the mesh)
_FEATURES = {"window": {"causal": True, "window": 48},
             "window_sinks": {"causal": True, "window": 48, "sinks": 8},
             "window_softcap": {"causal": True, "window": 32,
                                "softcap": 15.0},
             "packed": {"causal": True, "packed": True}}
MASKED = {}
for _path, _fn, _shape, _extra in (
        ("kv", "kv", (2, 125, 16), {}),
        ("ring", "ring", (2, 125, 16), {}),
        ("ring_zigzag", "ring", (2, 125, 16), {"schedule": "zigzag"}),
        ("ulysses", "ulysses", (4, 128, 16), {})):
    for _feat, _kw in _FEATURES.items():
        MASKED[f"{_path}_{_feat}"] = ((4,), _s(_shape), _fn,
                                      dict(_kw, **_extra))
CASES.update(MASKED)
MERGE_WORLDS = (2, 3, 4)


def _inputs(name):
    """The case's (q, k, v) as float32 numpy arrays from its own seed."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    return [rng.standard_normal(s).astype(np.float32)
            for s in CASES[name][1]]


def _keywords(name, convert):
    """The case's keywords, "packed" turned into segment ids (3 uneven
    segments from the case's own seed) by ``convert`` (a numpy array to
    the side's tensor)."""
    kw = dict(CASES[name][3])
    if kw.pop("packed", False):
        s = CASES[name][1][0][-2]
        rng = np.random.default_rng(1000 + sorted(CASES).index(name))
        cuts = sorted(rng.choice(np.arange(16, s - 16), size=2,
                                 replace=False))
        ids = np.zeros(s, np.int32)
        ids[cuts[0]:cuts[1]] = 1
        ids[cuts[1]:] = 2
        kw.update(q_segment_ids=convert(ids), kv_segment_ids=convert(ids))
    return kw


def _partials(rank, h=3, m=20, dv=8):
    """One rank's partials for the `merge_partials` case: rows that no
    rank sees (max -inf, sum 0 everywhere), rows that only some do."""
    rng = np.random.default_rng(100 + rank)
    out = rng.standard_normal((h, m, dv)).astype(np.float32)
    lmax = rng.standard_normal((h, m)).astype(np.float32)
    lsum = rng.uniform(0.5, 4.0, (h, m)).astype(np.float32)
    dead = np.zeros((h, m), bool)
    dead[:, 0] = True
    dead[:, 1 + rank % 3::3] = True
    lmax[dead], lsum[dead], out[dead] = -np.inf, 0.0, 0.0
    return out, lmax, lsum


def _port_call(name):
    """Run case ``name`` on this rank: the output tensor, or the name of
    the exception it raised."""
    _, _, fn, _ = CASES[name]
    kw = _keywords(name, torch.from_numpy)
    q, k, v = (torch.from_numpy(x) for x in _inputs(name))
    try:
        if fn.startswith("api:"):
            return attention(q, k, v, backend=fn[4:], device="cpu", **kw)
        if fn == "kv_bf16":
            return kv_sharded_attention(*(x.to(torch.bfloat16)
                                          for x in (q, k, v)))
        if fn == "hybrid_kv":
            return kv_sharded_attention(q, k, v, mesh=hybrid_mesh(outer=2),
                                        axis_name="kv")
        if fn == "hybrid_ulysses":
            return ulysses_attention(q, k, v, mesh=hybrid_mesh(outer=2),
                                     axis_name="kv", batch_axis="dp")
        return {"kv": kv_sharded_attention, "q": q_sharded_attention,
                "ring": ring_attention,
                "ulysses": ulysses_attention}[fn](q, k, v, **kw)
    except ValueError:
        return "ValueError"


def _worker(rank, world, init_file, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        outs = {name: _port_call(name) for name, case in CASES.items()
                if world in case[0]}
        if world in MERGE_WORLDS:
            parts = (torch.from_numpy(x) for x in _partials(rank))
            outs["merge_partials"] = merge_partials(
                *parts, "kv", mesh=default_mesh("kv"))
        torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world_outputs(tmp_path_factory):
    """world size -> [each rank's {case: output}], each world started
    once, when a test first asks for it."""
    runs = {}

    def get(world):
        if world not in runs:
            out = tmp_path_factory.mktemp(f"world{world}")
            ctx = mp.spawn(_worker, nprocs=world, join=False,
                           args=(world, str(out / "init"), str(out)))
            deadline = time.monotonic() + 300
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    raise TimeoutError(f"gloo world of {world} hung")
            runs[world] = [torch.load(out / f"rank{r}.pt")
                           for r in range(world)]
        return runs[world]

    return get


def _same_on_every_rank(outs, name):
    for r, o in enumerate(outs[1:], 1):
        if isinstance(o[name], str):
            assert o[name] == outs[0][name]
        else:
            assert torch.equal(o[name], outs[0][name]), f"rank {r}"
    return outs[0][name]


def _jax_mesh(world, axis):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:world]), (axis,))


def _jax_call(name, world):
    """The JAX package's function on the same inputs on R devices: its
    output as numpy, or the name of the exception it raised."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from attention_tpu import attention as jax_attention
    from attention_tpu.parallel import kv_sharded, ring, ulysses

    _, _, fn, _ = CASES[name]
    kw = _keywords(name, jnp.asarray)
    q, k, v = (jnp.asarray(x) for x in _inputs(name))
    if kw.get("impl") == "torch":
        kw = dict(kw, impl="xla")
    axis = "kv" if fn in ("kv", "q", "kv_bf16") or fn.startswith(
        "api:auto") or fn in ("api:kv-sharded", "api:q-sharded") else "sp"
    mesh = _jax_mesh(world, axis)
    try:
        if fn.startswith("api:"):
            out = jax_attention(q, k, v, backend=fn[4:], mesh=mesh, **kw)
        elif fn == "kv_bf16":
            out = kv_sharded.kv_sharded_attention(
                *(x.astype(jnp.bfloat16) for x in (q, k, v)), mesh=mesh)
            return np.asarray(out.astype(jnp.float32))
        elif fn.startswith("hybrid"):
            hm = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                      ("dp", "kv"))
            out = (kv_sharded.kv_sharded_attention(q, k, v, mesh=hm,
                                                   axis_name="kv")
                   if fn == "hybrid_kv" else
                   ulysses.ulysses_attention(q, k, v, mesh=hm,
                                             axis_name="kv",
                                             batch_axis="dp"))
        else:
            out = {"kv": kv_sharded.kv_sharded_attention,
                   "q": kv_sharded.q_sharded_attention,
                   "ring": ring.ring_attention,
                   "ulysses": ulysses.ulysses_attention}[fn](
                       q, k, v, mesh=mesh, **kw)
    except ValueError:
        return "ValueError"
    return np.asarray(out)


@pytest.mark.parametrize("name,world", [
    (name, w) for name, case in CASES.items() for w in case[0]
    if CASES[name][2] != "kv_bf16"])
def test_sharded_matches_jax(world_outputs, name, world):
    got = _same_on_every_rank(world_outputs(world), name)
    want = _jax_call(name, world)
    if isinstance(want, str):
        assert got == want
        return
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= F32_ATOL


@pytest.mark.parametrize("name", sorted(MASKED))
def test_masked_paths_match_single_device(world_outputs, name):
    """Each sharded path under a band, sinks, softcap or packed ids
    equals the port's single-device `flash_attention` on the same inputs
    and keywords (f32, 1e-5)."""
    got = _same_on_every_rank(world_outputs(4), name)
    q, k, v = (torch.from_numpy(x) for x in _inputs(name))
    kw = {x: y for x, y in _keywords(name, torch.from_numpy).items()
          if x != "schedule"}
    want = flash_attention(q, k, v, **kw)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= F32_ATOL


@pytest.mark.parametrize("world", CASES["kv_bf16"][0])
def test_bf16_kv_sharded_within_contract(world_outputs, world):
    got = _same_on_every_rank(world_outputs(world), "kv_bf16")
    assert got.dtype == torch.bfloat16
    want = torch.tensor(_jax_call("kv_bf16", world)).to(torch.bfloat16)
    assert mismatch(got, want)[1] <= 1.0
    q, k, v = (x.astype(np.float64) for x in _inputs("kv_bf16"))
    assert np.abs(got.double().numpy()
                  - attention_oracle(q, k, v)).max() < 0.02


@pytest.mark.parametrize("world", MERGE_WORLDS)
def test_merge_partials_matches_jax(world_outputs, world):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from attention_tpu.parallel.kv_sharded import merge_partials as jax_merge
    from attention_tpu.parallel.mesh import shard_map

    got = _same_on_every_rank(world_outputs(world), "merge_partials")
    stacked = [jnp.asarray(np.stack(x)) for x in
               zip(*(_partials(r) for r in range(world)))]
    run = shard_map(lambda o, mx, s: jax_merge(o[0], mx[0], s[0], "kv"),
                    mesh=_jax_mesh(world, "kv"), in_specs=(P("kv"),) * 3,
                    out_specs=P(), check_vma=False)
    want = np.asarray(run(*stacked))
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= F32_ATOL


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_choose_kv_placement_matches_jax(n_devices):
    from attention_tpu.parallel.mesh import choose_kv_placement as jax_choose

    for n in (512, 4096, 1 << 16, 1 << 20):
        for m in (None, 64, 8192, 1 << 20):
            for heads, d in ((1, 128), (8, 64)):
                kw = dict(itemsize=2, kv_heads=heads, m=m, q_heads=heads,
                          n_devices=n_devices)
                assert (choose_kv_placement(n, d, d, **kw)
                        == jax_choose(n, d, d, **kw)), (n, m, heads)


@pytest.mark.parametrize("world", CASES["api:auto"][0])
def test_auto_cases_take_both_arms(world):
    """The two `auto` cases above run one arm each: tiny KV replicates
    (q-sharded), ``threshold_bytes=1`` shards (kv-sharded)."""
    (m, _), (n, d), _ = CASES["api:auto"][1]
    shape = dict(itemsize=4, kv_heads=1)
    assert choose_kv_placement(n, d, d, m=m, q_heads=1, n_devices=world,
                               **shape) == "replicate"
    assert choose_kv_placement(n, d, d, threshold_bytes=1,
                               **shape) == "shard"


def test_torchrun_cli_prints_correct_once(tmp_path):
    case = testcase.generate_testcase(37, 53, 16, 24, seed=3)
    path = tmp_path / "case.bin"
    testcase.write_testcase(path, case)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "attention_tpu_torch.cli", "run",
         str(path), "--backend", "kv-sharded", "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines().count("Correct!") == 1, r.stdout
