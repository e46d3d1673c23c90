"""Tensor-parallel serving in the port against the JAX package, on the
CPU: `parallel.serving`, ``TinyDecoder(tp_axis=, mesh=)`` through every
cached path, ``EngineConfig(mesh_shards=N)`` and its per-shard snapshots.

The port's side runs in one gloo world of 4 CPU processes
(`torch.multiprocessing.spawn`), started once for the module: every rank
runs every case and saves its outputs, and the parametrised tests then
hold them case by case, each also holding every rank to rank 0's bits.
The spawned ranks import this module, so it imports JAX only inside the
functions that run in the test process, which computes the JAX side
(its 8-device virtual CPU mesh, Pallas in interpret mode) while the
world runs.  Inputs and weights come from numpy seeds and JAX's flax
init (`params_from_jax`).

* Ops: each ``head_sharded_*`` function and `cache_sharded_decode` on
  the world (4 ranks: one kv head each) against JAX's own function on 4
  devices and against the port's single-device kernel call, 2e-5 max abs
  (tests/test_serving.py's tolerance), window, sinks and softcap cases
  included; the ragged step's appended pool and lengths too.
* Models: `generate` (dense, int8, rolling with window 8 and 2 sinks,
  dense with the same band, paged, ragged), `generate_beam` (3 beams)
  and `generate_speculative` (every cache type; target and draft both tp
  on a mesh of 2 ranks, the world's two blocks serving alike) of the
  model of tests/test_tp_serving.py (vocab 61, dim 64, depth 2, 8 / 4
  heads, rope, f32): tokens equal to JAX's tp model's on 4 devices and
  to the port's single-device model's.  One case is held to JAX's
  single-device model instead (`JAX_TP_PARTS`): JAX's tp model on the
  dense cache with rope and sinks parts from JAX's own single-device
  model at the 7th token of the first sequence, where the single-device
  model's top logit leads by 0.82, so not at a near tie; the port's tp
  and single-device models equal JAX's single-device model and JAX's
  rolling cache there.
* `paged_fork` on the tp model's per-rank pools: the forks' greedy
  streams equal the single-device fork's.
* Engine: ``mesh_shards`` 2 and 4 (ragged greedy and sampled, two-call,
  async, preemption under page pressure) equal to the single-device
  engine's streams, tests/test_mesh_engine.py's contract.
* Snapshots: ``pools.0..3``, a mid-flight round trip (fingerprint and
  drained streams), one corrupt shard (a typed refusal naming it, and
  `recover_engine` falling back to the older snapshot), a geometry the
  world cannot hold (plain `SnapshotError`), crash recovery through the
  journal and cold `resume_request` on the mesh; a port mesh snapshot
  restored by JAX's `restore` on 4 devices and a JAX one by the port,
  each draining to JAX's uninterrupted streams.
* The int8 kernel's output is bf16: it is held against the port's
  single-device call and JAX's f32 output by `reference.mismatch` (at
  most one bf16 rounding apart), as tests/test_torch_quant.py holds the
  single-device call.
* Refusals: every `MeshConfigError` and `ValueError`, JAX's messages.
"""

import json
import os
import time
import zlib
from inspect import signature
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from attention_tpu_torch.engine import (
    EngineConfig,
    ServingEngine,
    SnapshotCorruptError,
    SnapshotError,
    SnapshotManager,
    recover_engine,
    replay,
    sampling_of,
    state_fingerprint,
    synthetic_trace,
)
from attention_tpu_torch.engine.snapshot import (
    inspect,
    list_snapshots,
    restore,
    save,
    verify,
)
from attention_tpu_torch.models import (
    TinyDecoder,
    generate,
    generate_beam,
    generate_paged,
    generate_ragged,
    generate_speculative,
)
from attention_tpu_torch.ops.decode import flash_decode, flash_decode_chunk
from attention_tpu_torch.ops.flash import flash_attention
from attention_tpu_torch.ops.paged import PagedKV, paged_flash_decode
from attention_tpu_torch.ops.quant import flash_decode_quantized, quantize_kv
from attention_tpu_torch.ops.reference import mismatch
from attention_tpu_torch.ops.ragged_paged import (
    RaggedPagedStep,
    ragged_paged_append,
    ragged_paged_attention,
)
from attention_tpu_torch.parallel import (
    MeshConfigError,
    cache_sharded_decode,
    head_sharded_decode,
    head_sharded_decode_paged,
    head_sharded_decode_quantized,
    head_sharded_prefill,
    head_sharded_ragged_step,
)
from attention_tpu_torch.parallel.mesh import Mesh, default_mesh
from attention_tpu_torch.parallel.serving import serving_mesh

WORLD = 4
ATOL = 2e-5
MODEL = dict(vocab=61, dim=64, depth=2, num_q_heads=8, num_kv_heads=4,
             rope=True)
BAND = dict(window=8, attn_sinks=2)
SPEC_TARGET = dict(vocab=41, dim=64, depth=2, num_q_heads=4, num_kv_heads=2)
SPEC_DRAFT = dict(vocab=41, dim=32, depth=1, num_q_heads=2, num_kv_heads=2)
SPEC_CACHES = ("dense", "ragged", "int8", "paged")
# model cases held to JAX's single-device model (see the docstring)
JAX_TP_PARTS = ("dense_band",)
# the engine's model: 4 kv heads, so that a mesh of 4 splits them too
ENGINE_MODEL = dict(vocab=43, dim=64, depth=1, num_q_heads=8,
                    num_kv_heads=4)
ENGINE = dict(num_pages=24, page_size=128, max_seq_len=256,
              max_decode_batch=4, max_prefill_rows=2, prefill_chunk=32,
              token_budget=80, watermark_pages=1)
TIGHT = dict(num_pages=3, watermark_pages=0)
SNAP_SHARDS = 4
# `paged_fork` on the tp model's per-rank pools: the prompt's length, and
# the first token fed to each fork
FORK_PROMPT = 300
FORK_FIRST = (3, 17, 42)

# name: (function, keywords)
OPS = {
    "decode": ("decode", {}),
    "decode_band": ("decode", dict(window=128, sinks=4, softcap=30.0)),
    "decode_chunk": ("decode_chunk", {}),
    "quantized": ("quantized", {}),
    "quantized_band": ("quantized", dict(window=128, sinks=4)),
    "paged": ("paged", {}),
    "paged_band": ("paged", dict(window=128, sinks=4, softcap=30.0)),
    "prefill": ("prefill", dict(causal=True, q_offset=128, kv_valid=256)),
    "prefill_band": ("prefill", dict(causal=True, q_offset=128,
                                     kv_valid=256, window=64, sinks=4,
                                     softcap=30.0)),
    "ragged_step": ("ragged", {}),
    **{f"cache_sharded_{n}": ("cache_sharded", dict(length=n))
       for n in (1024, 300, 100, 1)},
    "cache_sharded_softcap": ("cache_sharded", dict(length=700,
                                                    softcap=30.0)),
}
# name: (model extras, generate function, keywords)
MODELS = {
    "dense": ({}, "generate", dict(shape=(2, 12), steps=8)),
    "int8": ({}, "generate", dict(shape=(2, 10), steps=6, int8_cache=True)),
    "rolling_band": (BAND, "generate", dict(shape=(2, 6), steps=10,
                                            rolling_cache=True)),
    "dense_band": (BAND, "generate", dict(shape=(2, 6), steps=10)),
    "paged": (dict(rope=False), "generate_paged",
              dict(shape=(2, 9), lengths=(9, 5), steps=5)),
    "ragged": ({}, "generate_ragged", dict(shape=(2, 12), lengths=(12, 7),
                                           steps=6)),
    "beam": ({}, "generate_beam", dict(shape=(2, 6), steps=6, beams=3)),
}
# name: (mesh_shards, config overrides, trace keywords)
ENGINES = {
    f"{mode}_{shards}": (shards, cfg, tkw)
    for shards in (2, 4)
    for mode, cfg, tkw in (
        ("ragged_greedy", {}, {}),
        ("ragged_sampled", {}, dict(temperature=0.7)),
        ("two_call", dict(step_mode="two_call"), {}),
        ("async", dict(async_steps=True), dict(temperature=0.7)))
}
ENGINES["preemption_4"] = (4, TIGHT, "preemption")


def _trace(vocab=ENGINE_MODEL["vocab"], **kw):
    """tests/test_mesh_engine.py's trace: 8 requests, a shared prefix of
    129 tokens on 3 of them (the prefix cache engages)."""
    base = dict(vocab=vocab, seed=11, max_tokens=6, shared_prefix_len=129,
                shared_count=3)
    return synthetic_trace(8, **dict(base, **kw))


def _engine_trace(tkw):
    if tkw == "preemption":
        return synthetic_trace(3, vocab=ENGINE_MODEL["vocab"], seed=3,
                               prompt_len_min=120, prompt_len_max=120,
                               max_tokens=12)
    return _trace(**tkw)


def _op_inputs(name):
    """The numpy inputs of op case ``name``, from its own seed."""
    rng = np.random.default_rng(sorted(OPS).index(name) + 100)

    def x(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    fn, kw = OPS[name]
    if fn in ("decode", "quantized"):
        return dict(q=x(2, 8, 64), k=x(2, 4, 512, 64), v=x(2, 4, 512, 64),
                    lens=np.asarray([512, 77 if not kw else 300], np.int32))
    if fn == "decode_chunk":
        return dict(q=x(2, 8, 4, 64), k=x(2, 4, 512, 64),
                    v=x(2, 4, 512, 64), lens=np.asarray([512, 300],
                                                        np.int32))
    if fn == "paged":
        return dict(q=x(2, 8, 64), k=x(10, 4, 128, 64), v=x(10, 4, 128, 64),
                    table=np.asarray([[7, 2, 9, 0], [3, 8, 1, 5]], np.int32),
                    lens=np.asarray([512, 300], np.int32))
    if fn == "prefill":
        return dict(q=x(2, 8, 128, 64), k=x(2, 4, 256, 64),
                    v=x(2, 4, 256, 64))
    if fn == "ragged":
        # one decode slot (37 keys) and one fresh 4-token prefill slot,
        # tests/test_mesh_engine.py's step at 8 q / 4 kv heads
        return dict(q=x(1, 8, 8, 16), k=x(6, 4, 128, 16),
                    v=x(6, 4, 128, 16), k_new=x(1, 4, 8, 16),
                    v_new=x(1, 4, 8, 16),
                    table=np.asarray([[0, -1], [1, -1]], np.int32),
                    kv_lens=np.asarray([37, 0], np.int32),
                    cu=np.asarray([0, 1, 5], np.int32),
                    dist=np.asarray([1, 2], np.int32),
                    pos=np.asarray([37, 0, 1, 2, 3, 0, 0, 0], np.int32),
                    slot=np.asarray([0, 1, 1, 1, 1, -1, -1, -1], np.int32))
    return dict(q=x(2, 8, 64), k=x(2, 2, 1024, 64), v=x(2, 2, 1024, 64))


def _tokens(name, vocab):
    """The prompt of model case ``name``: right-padded with 0 past each
    length where the case has lengths."""
    _, _, kw = MODELS.get(name, (None, None, dict(shape=(1, 7))))
    rng = np.random.default_rng(sorted(MODELS).index(name) + 7
                                if name in MODELS else 7)
    prompt = rng.integers(1, vocab, kw["shape"]).astype(np.int32)
    for b, n in enumerate(kw.get("lengths", ())):
        prompt[b, n:] = 0
    return prompt


# ------------------------------------------------------------ the world


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_op(name, mesh):
    """(the world's output, the single-device call's, extras) of op case
    ``name`` on this rank."""
    fn, kw = OPS[name]
    a = {k: _t(v) for k, v in _op_inputs(name).items()}
    if fn in ("decode", "decode_chunk"):
        got = head_sharded_decode(a["q"], a["k"], a["v"], a["lens"],
                                  mesh=mesh, **kw)
        one = (flash_decode_chunk if fn == "decode_chunk"
               else flash_decode)(a["q"], a["k"], a["v"], a["lens"], **kw)
        return got, one, []
    if fn == "quantized":
        cache = quantize_kv(a["k"], a["v"])
        got = head_sharded_decode_quantized(a["q"], cache, a["lens"],
                                            mesh=mesh, **kw)
        return got, flash_decode_quantized(a["q"], cache, a["lens"],
                                           **kw), []
    if fn == "paged":
        cache = PagedKV(a["k"], a["v"], a["table"], a["lens"])
        return (head_sharded_decode_paged(a["q"], cache, mesh=mesh, **kw),
                paged_flash_decode(a["q"], cache, **kw), [])
    if fn == "prefill":
        return (head_sharded_prefill(a["q"], a["k"], a["v"], mesh=mesh,
                                     **kw),
                flash_attention(a["q"], a["k"], a["v"], **kw), [])
    if fn == "ragged":
        def step():
            return RaggedPagedStep(
                a["k"].clone(), a["v"].clone(), a["table"], a["kv_lens"],
                a["cu"], a["dist"], a["pos"], a["slot"], 4)

        got, cache = head_sharded_ragged_step(a["q"], step(), a["k_new"],
                                              a["v_new"], mesh=mesh)
        single = ragged_paged_append(step(), a["k_new"], a["v_new"])
        one = ragged_paged_attention(a["q"], single)
        return got, one, [cache.k_pool, cache.v_pool, cache.kv_lens,
                          single.k_pool, single.v_pool, single.kv_lens]
    length = kw["length"]
    rest = {k: v for k, v in kw.items() if k != "length"}
    got = cache_sharded_decode(a["q"], a["k"], a["v"], length, mesh=mesh,
                               **rest)
    return got, flash_decode(a["q"], a["k"], a["v"], length, **rest), []


def _model(params, *, mesh=None, **extra):
    cfg = {**MODEL, **extra}
    model = TinyDecoder(dtype=torch.float32, device="cpu",
                        **({} if mesh is None else dict(tp_axis="tp",
                                                        mesh=mesh)), **cfg)
    model.load_state_dict(params[("model", cfg.get("rope", True))])
    return model


def _port_generate(model, name):
    extras, fn, kw = MODELS[name]
    kw = dict(kw)
    prompt = _t(_tokens(name, MODEL["vocab"]))
    shape, lengths = kw.pop("shape"), kw.pop("lengths", None)
    assert prompt.shape == shape
    if fn == "generate":
        return generate(model, prompt, **kw).numpy()
    if fn == "generate_beam":
        return generate_beam(model, prompt, **kw).numpy()
    run = generate_paged if fn == "generate_paged" else generate_ragged
    out = run(model, prompt, torch.tensor(lengths), **kw)
    return (out[0] if fn == "generate_paged" else out).numpy()


def _port_fork(params, mesh=None):
    """Greedy streams of `paged_fork`'s forks of one prompt of
    `FORK_PROMPT` tokens (2 full pages of 128 and a 44-row tail), its
    caches scattered into one pool a layer (on a tp model each rank's
    pools hold its block of the kv heads), forked `FORK_COPIES` ways
    with a reserve page each, each fork fed its own first token; and the
    pages the pools use."""
    from attention_tpu_torch.models import decode as gen
    from attention_tpu_torch.ops.paged import (
        PagePool,
        paged_fork,
        paged_from_dense,
    )

    model = _model(params, mesh=mesh)
    prompt = _t(np.random.default_rng(5).integers(1, MODEL["vocab"],
                                                  (1, FORK_PROMPT)))
    with torch.no_grad():
        _, dense = gen.prefill(model, prompt, 512)
        pools = [PagePool(16) for _ in dense]
        forks = tuple(
            paged_fork(paged_from_dense(c.k, c.v, [FORK_PROMPT], pool,
                                        num_pages=16),
                       pool, 0, len(FORK_FIRST), reserve_pages=1)
            for c, pool in zip(dense, pools))
        logits, forks = gen.decode_step(model, torch.tensor(FORK_FIRST),
                                        forks)
        toks, _ = gen._token_loop(model, logits, forks, 6, None,
                                  temperature=0.0, top_k=None, top_p=None)
    return toks.numpy(), [pool.used_pages for pool in pools]


def _spec_models(params, mesh):
    target = TinyDecoder(dtype=torch.float32, device="cpu", tp_axis="tp",
                         mesh=mesh, **SPEC_TARGET)
    target.load_state_dict(params["target"])
    draft = TinyDecoder(dtype=torch.float32, device="cpu", tp_axis="tp",
                        mesh=mesh, **SPEC_DRAFT)
    draft.load_state_dict(params["draft"])
    return target, draft


def _engine_model(params):
    model = TinyDecoder(dtype=torch.float32, device="cpu", **ENGINE_MODEL)
    model.load_state_dict(params["engine"])
    return model


def _admit(engine, trace):
    for e in trace:
        engine.add_request(e["prompt"], sampling_of(e), request_id=e["id"],
                           arrival=e["arrival"])


def _collector(outs):
    return lambda req: outs.__setitem__(req.request_id,
                                        list(req.output_tokens))


def _drain(engine, max_steps=300):
    for _ in range(max_steps):
        if not engine.scheduler.has_work():
            return
        engine.step()
    raise AssertionError("engine failed to drain")


def _port_engines(params):
    """{case: (mesh streams, single-device streams, preemptions of
    each)}."""
    model = _engine_model(params)
    out = {}
    for name, (shards, cfg, tkw) in ENGINES.items():
        trace = _engine_trace(tkw)
        runs = []
        for mesh_shards in (shards, 0):
            eng = ServingEngine(model, EngineConfig(**{
                **ENGINE, **cfg, "mesh_shards": mesh_shards}))
            runs.append((replay(eng, trace)[1],
                         eng.scheduler.num_preemptions))
        out[name] = (runs[0][0], runs[1][0], runs[0][1], runs[1][1])
    return out


def _rewrite_meta(src, dst, change):
    """Copy snapshot ``src`` to ``dst`` with its ``meta`` section changed
    by ``change`` and re-CRC'd: a sound file of another geometry."""
    blob = open(src, "rb").read()
    nl = blob.find(b"\n")
    manifest = json.loads(blob[:nl])
    entry = manifest["sections"][0]
    meta = json.loads(blob[nl + 1:nl + 1 + entry["nbytes"]])
    change(meta)
    new = json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()
    tail = blob[nl + 1 + entry["nbytes"]:]
    entry.update(nbytes=len(new), crc32=zlib.crc32(new))
    with open(dst, "wb") as f:
        f.write(json.dumps(manifest, sort_keys=True,
                           separators=(",", ":")).encode() + b"\n" + new
                + tail)


def _flip_in_section(path, name):
    """Flip one byte in the middle of section ``name``."""
    blob = bytearray(open(path, "rb").read())
    nl = blob.find(b"\n")
    off = nl + 1
    for s in json.loads(blob[:nl])["sections"]:
        if s["name"] == name:
            blob[off + s["nbytes"] // 2] ^= 0xFF
            break
        off += s["nbytes"]
    with open(path, "wb") as f:
        f.write(bytes(blob))


def _port_snapshots(params, out_dir, rank):
    """The mesh engine's snapshot cases on the world (every rank runs
    each; rank 0 writes the files)."""
    model = _engine_model(params)
    cfg = EngineConfig(**ENGINE, mesh_shards=SNAP_SHARDS)
    res = {}
    world = dist.group.WORLD

    # a mid-flight (sampled) round trip
    trace = _trace(temperature=0.6)
    eng = ServingEngine(model, cfg)
    _admit(eng, trace)
    for _ in range(8):
        eng.step()
    path = os.path.join(out_dir, "mid.atpsnap")
    save(eng, path)
    info = inspect(path)
    res["inspect"] = (info["valid"], info["shards"],
                      [s["name"] for s in info["sections"]])
    res["verify"] = verify(path)
    clone = restore(path, model)
    res["fingerprints"] = (state_fingerprint(clone), state_fingerprint(eng))
    drained = []
    for e in (clone, eng):
        outs = {}
        e.on_finish = _collector(outs)
        _drain(e)
        drained.append(outs)
    res["drained"] = drained

    # one corrupt shard among two snapshots
    d = os.path.join(out_dir, "corrupt")
    eng = ServingEngine(model, cfg)
    _admit(eng, _trace())
    for _ in range(4):
        eng.step()
    older = os.path.join(d, "snap-00000004.atpsnap")
    save(eng, older)
    for _ in range(4):
        eng.step()
    newer = os.path.join(d, "snap-00000008.atpsnap")
    save(eng, newer)
    if rank == 0:
        _flip_in_section(newer, "pools.1")
    dist.barrier(world)
    res["corrupt_verify"] = verify(newer)
    try:
        restore(newer, model)
        res["corrupt_restore"] = None
    except SnapshotCorruptError as e:
        res["corrupt_restore"] = str(e)
    recovered, report = recover_engine(model, d)
    res["corrupt_recover"] = (report["snapshot_step"],
                              [s["error"] for s in report["skipped"]],
                              recovered.config.mesh_shards)

    # a geometry the world cannot hold
    hostile = os.path.join(out_dir, "geometry.atpsnap")
    if rank == 0:
        _rewrite_meta(older, hostile,
                      lambda m: m["config"].update(mesh_shards=9))
    dist.barrier(world)
    try:
        restore(hostile, model)
        res["geometry"] = None
    except SnapshotError as e:
        res["geometry"] = (type(e).__name__, str(e))

    # a crash between snapshots: warm recovery through the journal, and
    # cold resume of every live request, against the uninterrupted run
    trace = _trace(temperature=0.7)
    res["baseline"] = replay(ServingEngine(model, cfg), trace)[1]
    d = os.path.join(out_dir, "crash")
    eng = ServingEngine(model, cfg)
    manager = SnapshotManager(eng, d, every=4, keep=2)
    _admit(eng, trace)
    for _ in range(10):
        eng.step()
    streamed = {r.request_id: (r, list(r.output_tokens))
                for r in (*eng.scheduler.waiting, *eng.scheduler.running)}
    if manager.engine.journal is not None:
        manager.engine.journal.close()  # the process dies here
    dist.barrier(world)
    warm = {}
    recovered, report = recover_engine(model, d,
                                       on_finish=_collector(warm))
    _drain(recovered)
    cold = {}
    fresh = ServingEngine(model, cfg, on_finish=_collector(cold))
    for rid, (req, toks) in streamed.items():
        if toks:
            fresh.resume_request(req.prompt, req.sampling, request_id=rid,
                                 output_tokens=toks)
    _drain(fresh)
    res["crash"] = (report["snapshot_step"], report["journal_events"],
                    warm, cold, {rid: t for rid, (_, t) in streamed.items()})

    # the cross-package files: this world's snapshot for JAX, and JAX's
    # mesh snapshot drained here
    eng = ServingEngine(model, cfg)
    _admit(eng, _trace())
    for _ in range(4):
        eng.step()
    save(eng, os.path.join(out_dir, "port_mesh.atpsnap"))
    jax_file = os.path.join(out_dir, "jax_mesh.atpsnap")
    outs = {}
    _drain(restore(jax_file, model, on_finish=_collector(outs)))
    res["jax_restored"] = outs
    return res


def _worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        mesh, sp = default_mesh("tp"), default_mesh("sp")
        outs = {"ops": {n: _port_op(
            n, sp if n.startswith("cache") else mesh) for n in OPS}}
        params_file = os.path.join(out_dir, "params.pt")
        while not os.path.exists(params_file):  # the test process writes it
            time.sleep(0.1)
        params = torch.load(params_file)
        outs["models"] = {}
        for name, (extras, _, _) in MODELS.items():
            outs["models"][name] = (
                _port_generate(_model(params, mesh=mesh, **extras), name),
                _port_generate(_model(params, **extras), name))
        outs["fork"] = (_port_fork(params, mesh), _port_fork(params))
        pair = serving_mesh(2)
        target, draft = _spec_models(params, pair)
        prompt = _t(_tokens("spec", SPEC_TARGET["vocab"]))
        outs["spec"] = {c: generate_speculative(
            target, draft, prompt, steps=10, gamma=3, cache_type=c).numpy()
            for c in SPEC_CACHES}
        outs["spec_greedy"] = generate(
            target.clone(tp_axis=None, mesh=None), prompt, steps=10).numpy()
        outs["engines"] = _port_engines(params)
        try:
            small = TinyDecoder(dtype=torch.float32, device="cpu",
                                **dict(ENGINE_MODEL, num_kv_heads=2))
            ServingEngine(small, EngineConfig(**ENGINE, mesh_shards=4))
            outs["kv_indivisible"] = None
        except MeshConfigError as e:
            outs["kv_indivisible"] = str(e)
        jax_file = os.path.join(out_dir, "jax_mesh.atpsnap")
        while not os.path.exists(jax_file):  # the test process writes it
            time.sleep(0.1)
        outs["snapshots"] = _port_snapshots(params, out_dir, rank)
        torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- the JAX side


def _jax_models():
    """JAX's flax models and weights: {key: (model, params)}."""
    import jax
    import jax.numpy as jnp

    from attention_tpu.models import TinyDecoder as JaxDecoder

    out = {}
    probe = jnp.zeros((1, 8), jnp.int32)
    for key, cfg, seed in (("model", MODEL, 0),
                           ("target", SPEC_TARGET, 0),
                           ("draft", SPEC_DRAFT, 1),
                           ("engine", ENGINE_MODEL, 0)):
        model = JaxDecoder(impl="flash", dtype=jnp.float32, **cfg)
        out[key] = (model, jax.device_get(jax.jit(model.init)(
            jax.random.PRNGKey(seed), probe)["params"]))
    return out


def _jax_mesh_snapshot(models, out_dir):
    """JAX's mesh engine (4 shards) 4 steps into the greedy trace, saved
    where the world reads it; returns JAX's uninterrupted streams."""
    from attention_tpu import engine as jax_engine
    from attention_tpu.engine import snapshot as jax_snapshot

    model, params = models["engine"]
    cfg = jax_engine.EngineConfig(**ENGINE, mesh_shards=SNAP_SHARDS)
    _, baseline = jax_engine.replay(
        jax_engine.ServingEngine(model, params, cfg), _trace())
    eng = jax_engine.ServingEngine(model, params, cfg)
    _admit(eng, _trace())
    for _ in range(4):
        eng.step()
    tmp = os.path.join(out_dir, "jax_mesh.tmp")
    jax_snapshot.save(eng, tmp)
    os.replace(tmp, os.path.join(out_dir, "jax_mesh.atpsnap"))
    return baseline


def _jax_reference(models):
    """Each op case through JAX's own serving function on 4 devices of
    its virtual mesh, and each model case through JAX's tp model there."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from attention_tpu.models import TinyDecoder as JaxDecoder
    from attention_tpu.models import decode as jdec
    from attention_tpu.models.speculative import (
        generate_speculative as jax_speculative,
    )
    from attention_tpu.ops.paged import PagedKV as JaxPaged
    from attention_tpu.ops.quant import quantize_kv as jax_quantize
    from attention_tpu.ops.ragged_paged import RaggedPagedStep as JaxStep
    from attention_tpu.parallel import serving as js

    tp = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("tp",))
    sp = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("sp",))
    ops = {}
    for name, (fn, kw) in OPS.items():
        a = {k: jnp.asarray(v) for k, v in _op_inputs(name).items()}
        if fn in ("decode", "decode_chunk"):
            out = js.head_sharded_decode(a["q"], a["k"], a["v"], a["lens"],
                                         mesh=tp, **kw)
        elif fn == "quantized":
            out = js.head_sharded_decode_quantized(
                a["q"], jax_quantize(a["k"], a["v"]), a["lens"], mesh=tp,
                **kw)
        elif fn == "paged":
            out = js.head_sharded_decode_paged(
                a["q"], JaxPaged(a["k"], a["v"], a["table"], a["lens"]),
                mesh=tp, **kw)
        elif fn == "prefill":
            out = js.head_sharded_prefill(a["q"], a["k"], a["v"], mesh=tp,
                                          **kw)
        elif fn == "ragged":
            step = JaxStep(a["k"], a["v"], a["table"], a["kv_lens"],
                           a["cu"], a["dist"], a["pos"], a["slot"],
                           np.zeros((4,), np.int32))
            out, cache = js.head_sharded_ragged_step(
                a["q"], step, a["k_new"], a["v_new"], mesh=tp)
            out = (out, cache.k_pool, cache.v_pool, cache.kv_lens)
        else:
            rest = {k: v for k, v in kw.items() if k != "length"}
            out = js.cache_sharded_decode(a["q"], a["k"], a["v"],
                                          kw["length"], mesh=sp, **rest)
        ops[name] = [np.asarray(t, np.float32)
                     for t in (out if isinstance(out, tuple) else (out,))]
    jmodel, params = models["model"]
    gens = {}
    for name, (extras, fn, kw) in MODELS.items():
        kw = dict(kw)
        prompt = jnp.asarray(_tokens(name, MODEL["vocab"]))
        kw.pop("shape")
        lengths = kw.pop("lengths", None)
        shard = {} if name in JAX_TP_PARTS else dict(tp_axis="tp", mesh=tp)
        model = JaxDecoder(impl="flash", dtype=jnp.float32, **shard,
                           **{**MODEL, **extras})
        if fn in ("generate_paged", "generate_ragged"):
            out = getattr(jdec, fn)(model, params, prompt,
                                    jnp.asarray(lengths, jnp.int32), **kw)
            out = out[0] if fn == "generate_paged" else out
        else:
            out = getattr(jdec, fn)(model, params, prompt, **kw)
        gens[name] = np.asarray(out)
    pair = JaxMesh(np.asarray(jax.devices()[:2]), ("tp",))
    target, tparams = models["target"]
    draft, dparams = models["draft"]
    prompt = jnp.asarray(_tokens("spec", SPEC_TARGET["vocab"]))
    spec = np.asarray(jax_speculative(
        target.clone(tp_axis="tp", mesh=pair), tparams,
        draft.clone(tp_axis="tp", mesh=pair), dparams, prompt, steps=10,
        gamma=3))
    return dict(ops=ops, models=gens, spec=spec)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(each rank's outputs, the JAX side): the world of 4 spawned once,
    the JAX side computed while it runs."""
    from attention_tpu_torch.models import params_from_jax

    out = tmp_path_factory.mktemp("tp_world")
    ctx = mp.spawn(_worker, nprocs=WORLD, join=False,
                   args=(WORLD, str(out / "init"), str(out)))
    try:
        models = _jax_models()
        params = {key: params_from_jax(p) for key, (_, p) in models.items()
                  if key != "model"}
        for rope in (True, False):
            params[("model", rope)] = params_from_jax(models["model"][1])
        torch.save(params, out / "params.tmp")
        os.replace(out / "params.tmp", out / "params.pt")
        jax_baseline = _jax_mesh_snapshot(models, str(out))
        jax_side = _jax_reference(models)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("gloo world of 4 hung")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    jax_side.update(baseline=jax_baseline, models_jax=models, dir=str(out))
    return ranks, jax_side


def _same_on_every_rank(ranks, *keys):
    """The value under ``keys`` on rank 0, after asserting that every
    rank holds the same bits (tensors, arrays, lists, dicts)."""

    def get(outs):
        for key in keys:
            outs = outs[key]
        return outs

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return a == b

    want = get(ranks[0])
    for r, outs in enumerate(ranks[1:], 1):
        assert same(get(outs), want), (keys, r)
    return want


# ----------------------------------------------------------------- ops


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax_and_single_device(world, name):
    """Each sharded serving function on the world: within 2e-5 of JAX's
    own function on 4 devices and of the port's single-device kernel
    call on the same inputs, the same bits on every rank; the ragged
    step's appended pools and lengths equal the single-device append's
    and JAX's."""
    ranks, jax_side = world
    got, one, extra = _same_on_every_rank(ranks, "ops", name)
    want = jax_side["ops"][name]
    if got.dtype == torch.bfloat16:
        # the int8 kernel's bf16 output, held as tests/test_torch_quant.py
        # holds the single-device call against JAX's
        assert mismatch(got, one)[1] <= 1
        assert mismatch(got, torch.from_numpy(want[0]).to(got.dtype))[1] \
            <= 1
    else:
        np.testing.assert_allclose(got.numpy(), one.numpy(), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), want[0], atol=ATOL)
    if extra:
        k_pool, v_pool, lens, k_one, v_one, lens_one = extra
        assert torch.equal(k_pool, k_one) and torch.equal(v_pool, v_one)
        assert torch.equal(lens, lens_one)
        np.testing.assert_array_equal(k_pool.numpy(), want[1])
        np.testing.assert_array_equal(v_pool.numpy(), want[2])
        np.testing.assert_array_equal(lens.numpy(), want[3])


# -------------------------------------------------------------- models


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp_model_tokens_equal_jax_and_single_device(world, name):
    """``TinyDecoder(tp_axis="tp", mesh=)`` on the world: greedy tokens
    equal to JAX's tp model's on 4 devices (its single-device model's in
    `JAX_TP_PARTS`) and to the port's single-device model's, the same on
    every rank."""
    ranks, jax_side = world
    got, single = _same_on_every_rank(ranks, "models", name)
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, jax_side["models"][name])


@pytest.mark.parametrize("cache_type", SPEC_CACHES)
def test_tp_speculative_is_target_greedy(world, cache_type):
    """Speculative decoding with target and draft both tp on a mesh of 2
    ranks (the world's two blocks alike): the target's greedy tokens,
    equal to JAX's tp speculative decoding."""
    ranks, jax_side = world
    got = _same_on_every_rank(ranks, "spec", cache_type)
    np.testing.assert_array_equal(got, _same_on_every_rank(
        ranks, "spec_greedy"))
    np.testing.assert_array_equal(got, jax_side["spec"])


# -------------------------------------------------------------- engine


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_mesh_engine_streams_equal_single_device(world, name):
    """``mesh_shards`` 2 and 4: the mesh engine's streams equal the
    single-device engine's, request for request, greedy and sampled,
    both step modes, the async loop and preemption (the same count)."""
    ranks, _ = world
    mesh, single, pre_mesh, pre_single = _same_on_every_rank(
        ranks, "engines", name)
    assert mesh == single and single and all(single.values())
    assert pre_mesh == pre_single
    if name.startswith("preemption"):
        assert pre_mesh >= 1


# ----------------------------------------------------------- snapshots


def test_mesh_snapshot_sections_and_round_trip(world):
    """A mid-flight mesh snapshot carries ``pools.0`` .. ``pools.3``;
    restored on the world its fingerprint is the engine's, and both
    drain to the same streams."""
    ranks, _ = world
    snap = _same_on_every_rank(ranks, "snapshots")
    valid, shards, names = snap["inspect"]
    assert valid and shards == SNAP_SHARDS and snap["verify"] == []
    assert [n for n in names if n.startswith("pools")] == \
        [f"pools.{s}" for s in range(SNAP_SHARDS)]
    restored, live = snap["fingerprints"]
    assert restored == live
    assert snap["drained"][0] == snap["drained"][1] and snap["drained"][0]


def test_mesh_snapshot_one_corrupt_shard_is_typed(world):
    """A flipped byte in ``pools.1``: verify names it, restore is a typed
    `SnapshotCorruptError` naming it, and `recover_engine` falls back to
    the older snapshot on the same mesh."""
    ranks, _ = world
    snap = _same_on_every_rank(ranks, "snapshots")
    assert snap["corrupt_verify"] and "pools.1" in snap["corrupt_verify"][0]
    assert snap["corrupt_restore"] and "pools.1" in snap["corrupt_restore"]
    step, skipped, shards = snap["corrupt_recover"]
    assert step == 4 and any("pools.1" in e for e in skipped)
    assert shards == SNAP_SHARDS


def test_mesh_snapshot_geometry_mismatch_is_not_corruption(world):
    """A sound snapshot asking for 9 shards on a world of 4: plain
    `SnapshotError` matching "mesh geometry"."""
    ranks, _ = world
    kind, msg = _same_on_every_rank(ranks, "snapshots", "geometry")
    assert kind == "SnapshotError" and "mesh geometry" in msg


def test_mesh_crash_recovery_and_resume(world):
    """A mesh engine with a `SnapshotManager` dies between snapshots:
    `recover_engine` (the journal replayed) and cold `resume_request` of
    every live request each finish the streams of the uninterrupted
    run."""
    ranks, _ = world
    snap = _same_on_every_rank(ranks, "snapshots")
    baseline = snap["baseline"]
    step, events, warm, cold, streamed = snap["crash"]
    assert step == 8 and events > 0 and warm and cold
    for rid, toks in warm.items():
        assert toks == baseline[rid], rid
    for rid, toks in cold.items():
        assert toks == baseline[rid], rid
    assert set(cold) == {rid for rid, t in streamed.items() if t}


def test_snapshots_cross_packages(world):
    """The world's mesh snapshot restored by JAX's `restore` on 4
    devices, and JAX's mesh snapshot restored on the world: each drains
    to JAX's uninterrupted greedy streams."""
    from attention_tpu.engine import snapshot as jax_snapshot

    ranks, jax_side = world
    baseline = jax_side["baseline"]
    ported = _same_on_every_rank(ranks, "snapshots", "jax_restored")
    assert ported and all(ported[r] == baseline[r] for r in ported)
    model, params = jax_side["models_jax"]["engine"]
    outs = {}
    eng = jax_snapshot.restore(
        os.path.join(jax_side["dir"], "port_mesh.atpsnap"), model, params,
        on_finish=_collector(outs))
    assert eng.config.mesh_shards == SNAP_SHARDS
    _drain(eng)
    assert outs and all(outs[r] == baseline[r] for r in outs)


# ------------------------------------------------------------ refusals


def _fake_mesh(size, axis="tp"):
    """A one-rank stand-in for a mesh of ``size`` ranks: its shape is all
    the refusals read."""
    return Mesh((axis,), (size,), (0,), ([0] * size,), (None,))


def _x(*shape):
    return torch.zeros(shape)


REFUSALS = {
    "decode_kv_heads": (MeshConfigError, "kv heads 2 not divisible by mesh "
                        "size 4", lambda: head_sharded_decode(
                            _x(1, 4, 16), _x(1, 2, 128, 16),
                            _x(1, 2, 128, 16), 8, mesh=_fake_mesh(4))),
    "quantized_kv_heads": (MeshConfigError, "not divisible", lambda:
                           head_sharded_decode_quantized(
                               _x(1, 6, 16), quantize_kv(
                                   _x(1, 3, 128, 16), _x(1, 3, 128, 16)),
                               8, mesh=_fake_mesh(2))),
    "paged_kv_heads": (MeshConfigError, "not divisible", lambda:
                       head_sharded_decode_paged(_x(1, 6, 16), PagedKV(
                           _x(2, 3, 128, 16), _x(2, 3, 128, 16),
                           torch.zeros(1, 1, dtype=torch.int32),
                           torch.ones(1, dtype=torch.int32)),
                           mesh=_fake_mesh(2))),
    "prefill_kv_heads": (MeshConfigError, "not divisible", lambda:
                         head_sharded_prefill(_x(1, 6, 8, 16),
                                              _x(1, 3, 8, 16),
                                              _x(1, 3, 8, 16),
                                              mesh=_fake_mesh(2))),
    "ragged_kv_heads": (MeshConfigError, "kv heads 2 not divisible", lambda:
                        head_sharded_ragged_step(
                            _x(1, 4, 8, 16), RaggedPagedStep(
                                _x(2, 2, 128, 16), _x(2, 2, 128, 16),
                                *(torch.zeros(2, dtype=torch.int32),) * 6,
                                4), _x(1, 2, 8, 16), _x(1, 2, 8, 16),
                            mesh=_fake_mesh(3))),
    "ragged_q_heads": (MeshConfigError, "q heads 6 not divisible", lambda:
                       head_sharded_ragged_step(
                           _x(1, 6, 8, 16), RaggedPagedStep(
                               _x(2, 4, 128, 16), _x(2, 4, 128, 16),
                               *(torch.zeros(2, dtype=torch.int32),) * 6,
                               4), _x(1, 4, 8, 16), _x(1, 4, 8, 16),
                           mesh=_fake_mesh(4))),
    "cache_capacity": (ValueError, "cache capacity 500 not divisible",
                       lambda: cache_sharded_decode(
                           _x(1, 4, 16), _x(1, 4, 500, 16),
                           _x(1, 4, 500, 16), 100,
                           mesh=_fake_mesh(8, "sp"))),
    "cache_block_sizes": (NotImplementedError, "block_sizes", lambda:
                          cache_sharded_decode(
                              _x(1, 4, 16), _x(1, 4, 512, 16),
                              _x(1, 4, 512, 16), 100, block_sizes=(8, 8))),
    "model_without_mesh": (ValueError, "tp_axis requires mesh=", lambda:
                           TinyDecoder(device="cpu", tp_axis="tp", **MODEL)),
    "model_xla": (ValueError, "head-sharded serving", lambda: TinyDecoder(
        device="cpu", tp_axis="tp", mesh=_fake_mesh(4), impl="xla",
        **MODEL)),
    "model_axis_not_in_mesh": (ValueError, "is not an axis of the mesh",
                               lambda: TinyDecoder(
                                   device="cpu", tp_axis="tp",
                                   mesh=_fake_mesh(4, "sp"), **MODEL)),
    "model_kv_heads": (ValueError, "kv heads 2 not divisible by tp_axis "
                       "'tp' size 4", lambda: TinyDecoder(
                           device="cpu", tp_axis="tp", mesh=_fake_mesh(4),
                           **dict(MODEL, num_kv_heads=2))),
    "paged_rope_sinks": (ValueError, "no head-sharded form", lambda:
                         _paged_sink_step()),
    "engine_short_world": (MeshConfigError, "available device", lambda:
                           ServingEngine(TinyDecoder(
                               dtype=torch.float32, device="cpu",
                               **ENGINE_MODEL), EngineConfig(
                                   **ENGINE, mesh_shards=2))),
    "engine_negative": (ValueError, "mesh_shards", lambda: EngineConfig(
        **ENGINE, mesh_shards=-1).validate()),
    "engine_model_without_clone": (MeshConfigError, "tp_axis/mesh fields",
                                   lambda: ServingEngine(SimpleNamespace(
                                       impl="flash", num_kv_heads=2,
                                       device=torch.device("cpu")),
                                       EngineConfig(**ENGINE,
                                                    mesh_shards=1))),
    "engine_tp_model_without_mesh_shards": (
        MeshConfigError, "mesh_shards is 0", lambda: ServingEngine(
            TinyDecoder(dtype=torch.float32, device="cpu", tp_axis="tp",
                        mesh=_fake_mesh(1), **ENGINE_MODEL),
            EngineConfig(**ENGINE))),
}


def _paged_sink_step():
    """One paged decode step of a rope + sinks tp model: JAX refuses it
    (the sink read copy has no head-sharded form)."""
    model = TinyDecoder(dtype=torch.float32, device="cpu", tp_axis="tp",
                        mesh=_fake_mesh(1), **MODEL, **BAND)
    cache = PagedKV(_x(2, 4, 128, 8), _x(2, 4, 128, 8),
                    torch.zeros(1, 1, dtype=torch.int32),
                    torch.ones(1, dtype=torch.int32))
    model(torch.zeros(1, 1, dtype=torch.long), (cache,) * MODEL["depth"])


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(name):
    """JAX's typed `MeshConfigError`s and `ValueError`s, with its
    messages."""
    exc, match, call = REFUSALS[name]
    with pytest.raises(exc, match=match):
        call()


def test_clone_keeps_every_constructor_argument():
    """`TinyDecoder.clone` (the mesh engine's step model) rebuilds the
    model from every constructor argument but the device, shares its
    parameters, and takes only the overrides it is given."""
    kw = dict(MODEL, **BAND, dtype=torch.float32, softcap=30.0,
              rope_theta=500.0, remat=True, cp_impl="ring")
    model = TinyDecoder(device="cpu", **kw)
    params = set(signature(TinyDecoder).parameters)
    assert set(model._config) == params - {"device"}
    mesh = _fake_mesh(1)
    twin = model.clone(tp_axis="tp", mesh=mesh)
    assert twin._config == {**model._config, "tp_axis": "tp", "mesh": mesh}
    assert all(getattr(twin, k) == v for k, v in kw.items()
               if hasattr(twin, k))
    assert all(a is b for a, b in zip(twin.parameters(), model.parameters()))


def test_paged_fork_on_tp_pools_equals_single_device(world):
    """`paged_fork` on the tp model's per-rank pools (each rank a block
    of the kv heads, the same page tables on every rank): the forks'
    greedy streams equal the single-device fork's, every rank's equal
    rank 0's, and the pools use the pages the single device's do."""
    ranks, _ = world
    (toks, used), (want, want_used) = ranks[0]["fork"]
    for r in ranks[1:]:
        assert np.array_equal(r["fork"][0][0], toks)
    np.testing.assert_array_equal(toks, want)
    assert used == want_used
    assert len({tuple(row) for row in toks.tolist()}) > 1


def test_engine_kv_heads_indivisible_on_the_world(world):
    """On a world of 4 ranks, an engine of 2 kv heads over 4 shards is
    `MeshConfigError`."""
    ranks, _ = world
    msg = _same_on_every_rank(ranks, "kv_indivisible")
    assert msg == "kv heads 2 not divisible by mesh_shards 4"
