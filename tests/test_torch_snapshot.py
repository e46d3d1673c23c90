"""The port's snapshots, write-ahead journal and recovery
(`attention_tpu_torch.engine.snapshot`, `.journal`), on the CPU.

Against the JAX package: the same greedy trace through a JAX engine and
the port's engine for 4 steps, each saved.  The ``meta``, ``state`` and
``requests`` sections must be byte-equal; the f32 pools are held to
1e-5 max abs (`reference.F32_ATOL`: both sides compute in full f32 and
differ only in summation order; the reading is 1.7e-6 on values up to
3.7).  A JAX
snapshot restored by the port, and a port snapshot restored by JAX, must
each drain to the JAX engine's uninterrupted streams.

The rest mirrors `tests/test_snapshot.py` on the port alone: round
trips, typed refusals of damaged files, fsync order, the journal's torn
tail, the manager's rotation and pruning, and recovery after crashes,
greedy and sampled, with streams equal to the uninterrupted run.
"""

import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_tpu import engine as jax_engine
from attention_tpu.engine import snapshot as jax_snapshot
from attention_tpu.models import TinyDecoder as JaxDecoder
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
from attention_tpu_torch.engine.journal import (
    Journal,
    journal_path,
    list_journals,
)
from attention_tpu_torch.engine.snapshot import (
    SNAPSHOT_VERSION,
    inspect,
    list_snapshots,
    restore,
    save,
    verify,
)
from attention_tpu_torch.models import TinyDecoder, params_from_jax
from attention_tpu_torch.ops.reference import F32_ATOL

SMALL = dict(vocab=43, dim=32, depth=2, num_q_heads=4, num_kv_heads=2,
             rope=True, softcap=20.0)
ENGINE = dict(num_pages=24, page_size=128, max_seq_len=256,
              max_decode_batch=4, max_prefill_rows=2, prefill_chunk=32,
              token_budget=80, watermark_pages=1)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxDecoder(impl="flash", dtype=jnp.float32, **SMALL)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    model = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, model


def _cfg(**overrides):
    return EngineConfig(**dict(ENGINE, **overrides))


def _finished_into(outs):
    return lambda r: outs.__setitem__(r.request_id, list(r.output_tokens))


def _admit_all(engine, trace):
    for e in trace:
        engine.add_request(e["prompt"], sampling_of(e),
                           request_id=e["id"], arrival=e["arrival"])


def _drain(engine, *, max_steps=500):
    steps = 0
    while engine.scheduler.has_work():
        engine.step()
        steps += 1
        assert steps < max_steps, "engine failed to drain"


def _sections(path):
    blob = open(path, "rb").read()
    nl = blob.find(b"\n")
    out, offset = {}, nl + 1
    for s in json.loads(blob[:nl])["sections"]:
        out[s["name"]] = blob[offset:offset + s["nbytes"]]
        offset += s["nbytes"]
    return out


# ------------------------------------------------ against the JAX package

CROSS_TRACE = synthetic_trace(5, vocab=43, seed=11, max_tokens=6,
                              prompt_len_min=4, prompt_len_max=40)


@pytest.fixture(scope="module")
def cut(pair, tmp_path_factory):
    """The JAX engine's uninterrupted streams, and a snapshot of each
    package's engine after 4 steps of the same trace."""
    jmodel, params, model = pair
    jcfg = jax_engine.EngineConfig(**ENGINE)
    _, baseline = jax_engine.replay(
        jax_engine.ServingEngine(jmodel, params, jcfg), CROSS_TRACE)
    d = tmp_path_factory.mktemp("cross")
    paths = {}
    for name, eng in (("jax", jax_engine.ServingEngine(jmodel, params,
                                                       jcfg)),
                      ("port", ServingEngine(model, _cfg()))):
        _admit_all(eng, CROSS_TRACE)
        for _ in range(4):
            eng.step()
        paths[name] = str(d / f"{name}.atpsnap")
        (jax_snapshot.save if name == "jax" else save)(eng, paths[name])
    return baseline, paths


def test_snapshot_sections_byte_equal_jax(cut):
    _, paths = cut
    jax_s, port_s = _sections(paths["jax"]), _sections(paths["port"])
    assert list(jax_s) == list(port_s) == ["meta", "pools", "state",
                                           "requests"]
    for name in ("meta", "state", "requests"):
        assert port_s[name] == jax_s[name], name
    want = np.frombuffer(jax_s["pools"], np.float32)
    got = np.frombuffer(port_s["pools"], np.float32)
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= F32_ATOL
    assert json.loads(jax_s["requests"])  # live requests at the cut


def test_port_restores_jax_snapshot_to_jax_streams(pair, cut):
    baseline, paths = cut
    outs = {}
    eng = restore(paths["jax"], pair[2], on_finish=_finished_into(outs))
    _drain(eng)
    assert outs and all(outs[rid] == baseline[rid] for rid in outs)


def test_jax_restores_port_snapshot_to_jax_streams(pair, cut):
    baseline, paths = cut
    jmodel, params, _ = pair
    outs = {}
    eng = jax_snapshot.restore(paths["port"], jmodel, params,
                               on_finish=_finished_into(outs))
    _drain(eng)
    assert outs and all(outs[rid] == baseline[rid] for rid in outs)


def test_jax_mesh_snapshot_is_a_plain_snapshot_error(pair, cut,
                                                     tmp_path):
    """A sound snapshot of a mesh engine, restored in a world without the
    ranks for its mesh, is refused as `SnapshotError` matching "mesh
    geometry", not as corrupt."""
    _, paths = cut
    blob = open(paths["jax"], "rb").read()
    nl = blob.find(b"\n")
    meta = _sections(paths["jax"])["meta"]
    doc = json.loads(meta)
    doc["config"]["mesh_shards"] = 2
    new_meta = json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()
    manifest = json.loads(blob[:nl])
    manifest["sections"][0].update(nbytes=len(new_meta),
                                   crc32=zlib.crc32(new_meta))
    path = str(tmp_path / "mesh.atpsnap")
    with open(path, "wb") as f:
        f.write(json.dumps(manifest, sort_keys=True,
                           separators=(",", ":")).encode() + b"\n"
                + new_meta + blob[nl + 1 + len(meta):])
    assert verify(path) == []
    with pytest.raises(SnapshotError, match="mesh geometry") as info:
        restore(path, pair[2])
    assert not isinstance(info.value, SnapshotCorruptError)


# ------------------------------------------------------ round trip


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_roundtrip_fingerprint_and_continuation_parity(pair, tmp_path,
                                                        temperature):
    model = pair[2]
    trace = synthetic_trace(5, vocab=43, seed=11, max_tokens=6,
                            temperature=temperature)
    _, baseline = replay(ServingEngine(model, _cfg()), trace)
    outs1 = {}
    eng1 = ServingEngine(model, _cfg(), on_finish=_finished_into(outs1))
    _admit_all(eng1, trace)
    for _ in range(4):
        eng1.step()
    path = str(tmp_path / "snap-00000004.atpsnap")
    assert save(eng1, path)["step"] == 4
    assert verify(path) == []
    outs2 = {}
    eng2 = restore(path, model, on_finish=_finished_into(outs2))
    assert state_fingerprint(eng2) == state_fingerprint(eng1)
    assert eng2.current_step == eng1.current_step
    _drain(eng1)
    _drain(eng2)
    assert outs2
    for outs in (outs1, outs2):
        assert all(toks == baseline[rid] for rid, toks in outs.items())
    assert set(outs1) >= set(baseline) - set(outs2)


def test_bf16_pools_round_trip_without_ml_dtypes(tmp_path):
    """bf16 pools are written as their 16-bit patterns, named
    "bfloat16", and read back to the same bits."""
    model = TinyDecoder(dtype=torch.bfloat16, device="cpu", **SMALL)
    eng = ServingEngine(model, _cfg())
    _admit_all(eng, synthetic_trace(3, vocab=43, seed=2, max_tokens=4))
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "bf16.atpsnap")
    save(eng, path)
    assert inspect(path)["valid"]
    assert json.loads(_sections(path)["meta"])["pool_dtype"] == "bfloat16"
    eng2 = restore(path, model)
    assert eng2._k_pools[0].dtype == torch.bfloat16
    for a, b in zip((*eng._k_pools, *eng._v_pools),
                    (*eng2._k_pools, *eng2._v_pools)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert state_fingerprint(eng2) == state_fingerprint(eng)


# -------------------------------------------------------- corruption


def _corrupt_blob(blob: bytes, mode: str) -> bytes:
    nl = blob.find(b"\n")
    manifest = json.loads(blob[:nl])
    layout, offset = {}, nl + 1
    for s in manifest["sections"]:
        layout[s["name"]] = (offset, s["nbytes"])
        offset += s["nbytes"]
    if mode.startswith("bitflip_"):
        start, nbytes = layout[mode.removeprefix("bitflip_")]
        i = start + nbytes // 2
        return blob[:i] + bytes([blob[i] ^ 0xFF]) + blob[i + 1:]
    if mode == "truncate_mid":
        start, nbytes = layout["state"]
        return blob[:start + nbytes // 2]
    if mode == "truncate_tail":
        return blob[:-7]
    if mode == "trailing_garbage":
        return blob + b"\x00cruft"
    if mode == "stale_version":
        manifest["version"] = SNAPSHOT_VERSION + 1
    elif mode == "bad_magic":
        manifest["magic"] = "not-a-snapshot"
    else:
        raise AssertionError(mode)
    return (json.dumps(manifest, sort_keys=True,
                       separators=(",", ":")).encode() + blob[nl:])


@pytest.mark.parametrize("mode", [
    "bitflip_meta", "bitflip_pools", "bitflip_state",
    "bitflip_requests", "truncate_mid", "truncate_tail",
    "trailing_garbage", "stale_version", "bad_magic",
])
def test_corruption_is_typed_refusal(pair, tmp_path, mode):
    model = pair[2]
    eng = ServingEngine(model, _cfg())
    _admit_all(eng, synthetic_trace(3, vocab=43, seed=5, max_tokens=5,
                                    temperature=0.5))
    for _ in range(3):
        eng.step()
    good = str(tmp_path / "good.atpsnap")
    save(eng, good)
    bad = str(tmp_path / f"{mode}.atpsnap")
    with open(bad, "wb") as f:
        f.write(_corrupt_blob(open(good, "rb").read(), mode))
    assert verify(bad)
    assert not inspect(bad)["valid"]
    with pytest.raises(SnapshotCorruptError):
        restore(bad, model)
    assert verify(good) == []


def test_save_fsyncs_file_and_directory_around_replace(pair, tmp_path,
                                                       monkeypatch):
    eng = ServingEngine(pair[2], _cfg())
    events = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(
        os, "fsync", lambda fd: (events.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(
        os, "replace",
        lambda a, b: (events.append("replace"), real_replace(a, b))[1])
    save(eng, str(tmp_path / "snap.atpsnap"))
    assert events == ["fsync", "replace", "fsync"]


def test_restore_rejects_model_fingerprint_mismatch(pair, tmp_path):
    path = str(tmp_path / "snap.atpsnap")
    save(ServingEngine(pair[2], _cfg()), path)
    other = TinyDecoder(dtype=torch.float32, device="cpu",
                        **dict(SMALL, vocab=44))
    with pytest.raises(SnapshotCorruptError):
        restore(path, other)


# ---------------------------------------------------------- journal


def test_journal_roundtrip_and_torn_tail(tmp_path):
    path = str(tmp_path / "journal-00000000.wal")
    j = Journal(path, snapshot_step=0)
    j.record_token("r1", 7)
    j.record_token("r1", 9)
    j.record_cancel("r2")
    j.close()
    recs = Journal.read(path)
    assert [r["kind"] for r in recs] == ["begin", "token", "token",
                                         "cancel"]
    assert recs[1]["token"] == 7 and recs[0]["snapshot_step"] == 0
    with pytest.raises(SnapshotError):
        j.record_finish("r1")

    os.truncate(path, os.path.getsize(path) - 5)
    torn = Journal.read(path)
    assert [r["kind"] for r in torn] == ["begin", "token", "token"]
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    assert len(Journal.read(path)) < len(torn)
    assert Journal.read(str(tmp_path / "missing.wal")) == []


def test_manager_periodic_snapshots_journals_and_prune(pair, tmp_path):
    eng = ServingEngine(pair[2], _cfg())
    d = str(tmp_path / "snaps")
    mgr = SnapshotManager(eng, d, every=2, keep=2)
    _admit_all(eng, synthetic_trace(4, vocab=43, seed=3, max_tokens=6))
    for _ in range(6):
        eng.step()
    assert [s for s, _ in list_snapshots(d)] == [4, 6]
    assert [s for s, _ in list_journals(d)] == [4, 6]
    assert mgr.saves == 4 and mgr.last_snapshot_step == 6
    kinds = [r["kind"] for r in Journal.read(journal_path(d, 4))]
    assert kinds[0] == "begin" and "token" in kinds
    mgr.detach()
    assert eng.journal is None
    with pytest.raises(SnapshotError):
        SnapshotManager(eng, d, every=0)


# ---------------------------------------------------------- recovery


def _kill(engine):
    """The process dies: its journal's descriptor closes, nothing more
    reaches the disk."""
    engine.journal.close()


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_recovery_chains_past_corrupt_newest_snapshot(pair, tmp_path,
                                                      temperature):
    model = pair[2]
    trace = synthetic_trace(5, vocab=43, seed=21, max_tokens=6,
                            temperature=temperature)
    _, baseline = replay(ServingEngine(model, _cfg()), trace)
    outs = {}
    eng = ServingEngine(model, _cfg(), on_finish=_finished_into(outs))
    d = str(tmp_path / "snaps")
    SnapshotManager(eng, d, every=3, keep=3)
    _admit_all(eng, trace)
    for _ in range(8):
        eng.step()
    newest = list_snapshots(d)[-1][1]
    blob = bytearray(open(newest, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(newest, "wb") as f:
        f.write(bytes(blob))
    _kill(eng)

    outs2 = {}
    eng2, info = recover_engine(model, d, on_finish=_finished_into(outs2))
    assert info["skipped"] and info["snapshot_step"] == 3
    assert info["journal_events"] > 0
    _drain(eng2)
    assert all(toks == baseline[rid] for rid, toks in outs2.items())
    assert set(outs2) == set(baseline) - set(outs)


def test_crash_mid_snapshot_leaves_a_tmp_recovery_ignores(pair, tmp_path):
    model = pair[2]
    trace = synthetic_trace(5, vocab=43, seed=23, max_tokens=6,
                            temperature=0.7)
    _, baseline = replay(ServingEngine(model, _cfg()), trace)
    outs = {}
    eng = ServingEngine(model, _cfg(), on_finish=_finished_into(outs))
    d = str(tmp_path / "snaps")
    mgr = SnapshotManager(eng, d, every=3)
    _admit_all(eng, trace)
    for _ in range(4):
        eng.step()
    mgr.crash_next = True
    for _ in range(3):
        eng.step()
    assert [s for s, _ in list_snapshots(d)] == [0, 3]
    assert [n for n in os.listdir(d) if n.endswith(".tmp")]
    _kill(eng)
    outs2 = {}
    eng2, info = recover_engine(model, d, on_finish=_finished_into(outs2))
    assert info["snapshot_step"] == 3 and not info["skipped"]
    _drain(eng2)
    assert all(toks == baseline[rid] for rid, toks in outs2.items())
    assert set(outs2) == set(baseline) - set(outs)


def test_recover_engine_raises_typed_when_nothing_valid(pair, tmp_path):
    with pytest.raises(SnapshotCorruptError):
        recover_engine(pair[2], str(tmp_path / "empty"))


def test_manager_attach_starts_fresh_incarnation(pair, tmp_path):
    d = tmp_path / "snaps"
    d.mkdir()
    stale = Journal(journal_path(str(d), 0), snapshot_step=0)
    stale.record_token("ghost", 7)
    stale.close()
    (d / "snap-00000009.atpsnap").write_bytes(b"not a snapshot")
    (d / "tmpdead.tmp").write_bytes(b"torn")
    SnapshotManager(ServingEngine(pair[2], _cfg()), str(d), every=4)
    assert [s for s, _ in list_snapshots(str(d))] == [0]
    assert [s for s, _ in list_journals(str(d))] == [0]
    assert not (d / "tmpdead.tmp").exists()
    recs = Journal.read(journal_path(str(d), 0))
    assert [r["kind"] for r in recs] == ["begin"]


def test_warm_restart_then_second_crash_token_parity(pair, tmp_path):
    """After a warm restart the new incarnation's genesis holds the
    replayed records, so a second crash before its next snapshot must
    not replay the dead incarnation's records again."""
    model = pair[2]
    trace = synthetic_trace(6, vocab=43, seed=53, max_tokens=6,
                            temperature=0.7)
    _, baseline = replay(ServingEngine(model, _cfg()), trace)
    outs = {}
    d = str(tmp_path / "snaps")
    eng = ServingEngine(model, _cfg(), on_finish=_finished_into(outs))
    SnapshotManager(eng, d, every=4)
    _admit_all(eng, trace)
    for steps in (6, 2):
        for _ in range(steps):
            eng.step()
        _kill(eng)
        eng, _ = recover_engine(model, d, on_finish=_finished_into(outs))
        assert eng.scheduler.has_work()
        SnapshotManager(eng, d, every=4)
    _drain(eng)
    assert outs == baseline
