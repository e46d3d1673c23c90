"""Crash-consistent `ServingEngine` snapshots: save, verify, restore — the
port of `attention_tpu.engine.snapshot`, the same file format, so a
snapshot written by either package restores in the other.

A snapshot is a consistent between-steps cut of everything that decides
the engine's future outputs:

========== ============================================================
section    contents
========== ============================================================
``meta``   format version, `EngineConfig` fields, model fingerprint
           (vocab/dim/depth/heads/dtype/impl), engine step, seq counter,
           the pools' dtype and shape
``pools``  the raw bytes of every per-layer K pool, then every V pool
           (bf16 as its 16-bit patterns, named ``"bfloat16"``)
``state``  `PagePool` free list (exact order) and refcounts, the prefix
           cache (keys, pages, parent/children links, LRU stamps),
           allocator counters, scheduler knobs
``requests`` waiting and running queues in order: every `Request` field,
           streamed tokens and ``pending_token`` included.  The sampler
           needs nothing more: it is a function of the seed and the
           count of sampled tokens
========== ============================================================

On disk: one ASCII JSON manifest line (magic, version, per-section byte
counts and CRC32s) followed by the concatenated section payloads.
Serialization is deterministic (sorted keys, ordered queues), so
``sha256(serialize(engine))`` is a state fingerprint.

The file lands atomically and durably: ``tempfile.mkstemp`` in the
target directory, ``os.fsync`` of the temp file, ``os.replace``, then an
fsync of the directory.  Any validation failure (bad magic, stale
version, truncated or flipped section, model mismatch) raises the typed
`SnapshotCorruptError`; recovery treats it as "this candidate does not
count" and falls back.  A JAX mesh engine's snapshot (``shards`` > 1, or
any ``mesh_shards``) raises plain `SnapshotError`: the file is sound,
but this engine serves one device.

Not serialized: wall-clock bookkeeping (``_wall`` restarts at restore)
and `EngineMetrics` history.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import tempfile
import time
import zlib

import torch

from attention_tpu_torch.engine.allocator import _PrefixEntry
from attention_tpu_torch.engine.engine import EngineConfig, ServingEngine
from attention_tpu_torch.engine.errors import (
    SnapshotCorruptError,
    SnapshotError,
)
from attention_tpu_torch.engine.journal import (
    Journal,
    apply_journal,
    journal_path,
    list_journals,
)
from attention_tpu_torch.engine.request import (
    Request,
    RequestState,
    SamplingParams,
)

SNAPSHOT_MAGIC = "atp-snapshot"
SNAPSHOT_VERSION = 1
SNAPSHOT_SUFFIX = ".atpsnap"

_SNAP_RE = re.compile(r"^snap-(\d{8})\.atpsnap$")


def snapshot_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"snap-{step:08d}{SNAPSHOT_SUFFIX}")


def list_snapshots(directory: str) -> list[tuple[int, str]]:
    """``(step, path)`` pairs under ``directory``, ascending by step."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def _corrupt(path: str, why: str) -> SnapshotCorruptError:
    return SnapshotCorruptError(f"{path}: {why}")


def _jbytes(o) -> bytes:
    return json.dumps(o, sort_keys=True, separators=(",", ":")).encode()


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16"): the name
    the JAX package writes."""
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def model_fingerprint(model) -> dict:
    """The architecture identity a snapshot is only valid against."""
    return {
        "vocab": int(model.vocab),
        "dim": int(model.dim),
        "depth": int(model.depth),
        "num_q_heads": int(model.num_q_heads),
        "num_kv_heads": int(model.num_kv_heads),
        "dtype": _dtype_name(model.dtype),
        "impl": str(model.impl),
    }


def _request_to_dict(req: Request, queue: str) -> dict:
    s = req.sampling
    return {
        "queue": queue,
        "request_id": req.request_id,
        "prompt": list(req.prompt),
        "sampling": {
            "max_tokens": s.max_tokens,
            "temperature": s.temperature,
            "top_k": s.top_k,
            "top_p": s.top_p,
            "seed": s.seed,
            "stop_token": s.stop_token,
        },
        "arrival": req.arrival,
        "seq": req.seq,
        "deadline_step": req.deadline_step,
        "state": req.state.value,
        "tokens": list(req.tokens),
        "output_tokens": list(req.output_tokens),
        "pending_token": req.pending_token,
        "computed_tokens": req.computed_tokens,
        "pages": list(req.pages),
        "prefix_cached_tokens": req.prefix_cached_tokens,
        "preemptions": req.preemptions,
        "first_scheduled_step": req.first_scheduled_step,
        "first_token_step": req.first_token_step,
        "finish_step": req.finish_step,
        # the request-trace tail the JAX engine keeps here; the port
        # records none, which is what JAX writes with tracing off
        "trace": [],
    }


def _request_from_dict(d: dict) -> Request:
    req = Request(
        request_id=d["request_id"],
        prompt=tuple(int(t) for t in d["prompt"]),
        sampling=SamplingParams(**d["sampling"]),
        arrival=d["arrival"],
        seq=d["seq"],
        deadline_step=d["deadline_step"],
    )
    # lifecycle position is restored, not re-derived: assign directly
    # (transition() validates client-visible edges, not resurrection)
    req.state = RequestState(d["state"])
    req.tokens = [int(t) for t in d["tokens"]]
    req.output_tokens = [int(t) for t in d["output_tokens"]]
    req.pending_token = d["pending_token"]
    req.computed_tokens = d["computed_tokens"]
    req.pages = [int(p) for p in d["pages"]]
    req.prefix_cached_tokens = d["prefix_cached_tokens"]
    req.preemptions = d["preemptions"]
    req.first_scheduled_step = d["first_scheduled_step"]
    req.first_token_step = d["first_token_step"]
    req.finish_step = d["finish_step"]
    return req


def _pool_bytes(pool: torch.Tensor) -> bytes:
    """The pool's raw bytes in C order (bf16 as its 16-bit patterns)."""
    return pool.detach().contiguous().cpu().view(torch.uint8) \
        .numpy().tobytes()


def _serialize_sections(engine: ServingEngine) -> list[tuple[str, bytes]]:
    # a cut must not capture a half-staged async step: settle the double
    # buffer (drop staged rows, wait for the pools) before reading bytes
    engine.quiesce()
    cfg = dataclasses.asdict(engine.config)
    if cfg["cache_dtype"] is not None:
        cfg["cache_dtype"] = _dtype_name(cfg["cache_dtype"])
    meta = {
        "config": cfg,
        "model": model_fingerprint(engine.model),
        "step": engine.current_step,
        "next_seq": engine._next_seq,
        "pool_dtype": _dtype_name(engine._k_pools[0].dtype),
        "pool_shape": list(engine._k_pools[0].shape),
    }
    pools = b"".join(_pool_bytes(a)
                     for a in (*engine._k_pools, *engine._v_pools))
    alloc = engine.allocator
    sched = engine.scheduler
    state = {
        "free": [int(p) for p in engine.pool._free],
        "refs": [int(r) for r in engine.pool._refs],
        "watermark_pages": alloc.watermark_pages,
        "prefix": [
            {
                "key": list(e.key),
                "page": e.page,
                "parent": list(e.parent) if e.parent is not None else None,
                "children": sorted(list(c) for c in e.children),
                "last_use": e.last_use,
            }
            for _, e in sorted(alloc._prefix.items())
        ],
        "counters": {
            "prefix_hits": alloc.prefix_hits,
            "prefix_misses": alloc.prefix_misses,
            "prefix_hit_tokens": alloc.prefix_hit_tokens,
            "prefix_evictions": alloc.prefix_evictions,
        },
        "scheduler": {
            "token_budget": sched.token_budget,
            "prefix_admission": sched.prefix_admission,
            "num_preemptions": sched.num_preemptions,
        },
    }
    requests = (
        [_request_to_dict(r, "waiting") for r in sched.waiting]
        + [_request_to_dict(r, "running") for r in sched.running]
    )
    return [("meta", _jbytes(meta)), ("pools", pools),
            ("state", _jbytes(state)), ("requests", _jbytes(requests))]


def serialize(engine: ServingEngine) -> bytes:
    """Deterministic snapshot bytes (manifest line + section payloads)."""
    sections = _serialize_sections(engine)
    manifest = {
        "magic": SNAPSHOT_MAGIC,
        "version": SNAPSHOT_VERSION,
        "shards": 1,
        "sections": [
            {"name": name, "nbytes": len(payload),
             "crc32": zlib.crc32(payload)}
            for name, payload in sections
        ],
    }
    return (_jbytes(manifest) + b"\n"
            + b"".join(payload for _, payload in sections))


def state_fingerprint(engine: ServingEngine) -> str:
    """sha256 of the deterministic serialization: equal fingerprints
    mean equal future outputs (wall-clock metrics excluded)."""
    return hashlib.sha256(serialize(engine)).hexdigest()


def _fsync_dir(directory: str) -> None:
    """fsync a directory so a just-landed ``os.replace`` survives power
    loss (no-op where directories cannot be opened)."""
    try:
        dfd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save(engine: ServingEngine, path: str) -> dict:
    """Write one snapshot durably and atomically (temp file in the
    target directory, fsync, ``os.replace``, fsync of the directory);
    returns ``{path, nbytes, step}``."""
    blob = serialize(engine)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            # without this fsync a power loss after the rename could
            # leave the final path holding a partial file
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return {"path": path, "nbytes": len(blob),
            "step": engine.current_step}


def _read_sections(path: str) -> tuple[dict, dict[str, bytes]]:
    """Parse and checksum every section; raises `SnapshotCorruptError`
    on any structural damage."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise _corrupt(path, f"unreadable: {e}")
    nl = blob.find(b"\n")
    if nl < 0:
        raise _corrupt(path, "no manifest line")
    try:
        manifest = json.loads(blob[:nl])
    except ValueError:
        raise _corrupt(path, "unparseable manifest")
    if not isinstance(manifest, dict) \
            or manifest.get("magic") != SNAPSHOT_MAGIC:
        raise _corrupt(path, "bad magic (not an engine snapshot)")
    if manifest.get("version") != SNAPSHOT_VERSION:
        raise _corrupt(
            path,
            f"unsupported snapshot version {manifest.get('version')!r} "
            f"(reader speaks {SNAPSHOT_VERSION})")
    sections: dict[str, bytes] = {}
    offset = nl + 1
    try:
        entries = [(s["name"], int(s["nbytes"]), int(s["crc32"]))
                   for s in manifest["sections"]]
    except (KeyError, TypeError, ValueError):
        raise _corrupt(path, "malformed section table")
    for name, nbytes, crc in entries:
        payload = blob[offset:offset + nbytes]
        if len(payload) != nbytes:
            raise _corrupt(path, f"section {name!r} truncated "
                                 f"({len(payload)}/{nbytes} bytes)")
        if zlib.crc32(payload) != crc:
            raise _corrupt(path, f"section {name!r} checksum mismatch")
        sections[name] = payload
        offset += nbytes
    if offset != len(blob):
        raise _corrupt(path, f"{len(blob) - offset} trailing bytes")
    shards = manifest.get("shards", 1)
    if not isinstance(shards, int) or isinstance(shards, bool) \
            or shards < 1:
        raise _corrupt(path, f"bad shards count {shards!r}")
    pools = ("pools",) if shards == 1 else tuple(
        f"pools.{s}" for s in range(shards))
    for name in ("meta", *pools, "state", "requests"):
        if name not in sections:
            raise _corrupt(path, f"missing section {name!r}")
    return manifest, sections


def verify(path: str) -> list[str]:
    """Validation problems of one snapshot file ([] = valid): the
    checks of `restore` less the model fingerprint."""
    try:
        _, sections = _read_sections(path)
        for name in ("meta", "state", "requests"):
            json.loads(sections[name])
    except SnapshotError as e:
        return [str(e)]
    except ValueError as e:
        return [f"{path}: undecodable section payload: {e}"]
    return []


def inspect(path: str) -> dict:
    """Manifest and a decoded summary, for ``cli snapshot inspect``."""
    problems = verify(path)
    out: dict = {"path": path, "valid": not problems,
                 "problems": problems}
    if problems:
        return out
    manifest, sections = _read_sections(path)
    meta = json.loads(sections["meta"])
    requests = json.loads(sections["requests"])
    out.update({
        "version": manifest["version"],
        "shards": manifest.get("shards", 1),
        "sections": manifest["sections"],
        "nbytes": os.path.getsize(path),
        "step": meta["step"],
        "model": meta["model"],
        "config": meta["config"],
        "requests": [
            {"request_id": r["request_id"], "queue": r["queue"],
             "state": r["state"],
             "output_tokens": len(r["output_tokens"]),
             # a page count: page ids mean nothing outside the engine
             "pages": len(r["pages"])}
            for r in requests
        ],
    })
    return out


def _restore_pools(engine: ServingEngine, path: str, meta: dict,
                   payload: bytes) -> None:
    dtype = _torch_dtype(meta["pool_dtype"])
    shape = tuple(int(n) for n in meta["pool_shape"])
    depth = engine.model.depth
    want = torch.Size(shape).numel() * dtype.itemsize
    if len(payload) != 2 * depth * want:
        raise _corrupt(path, f"section 'pools' holds {len(payload)} bytes, "
                             f"expected {2 * depth * want}")
    arrays = [engine._place_pool(torch.frombuffer(
        bytearray(payload[i * want:(i + 1) * want]), dtype=dtype
    ).reshape(shape)) for i in range(2 * depth)]
    engine._k_pools = arrays[:depth]
    engine._v_pools = arrays[depth:]


def restore(path: str, model, *, on_token=None, on_finish=None,
            on_timeout=None) -> ServingEngine:
    """An engine over ``model`` (its weights and device) whose further
    outputs equal the snapshotted engine's.  Raises
    `SnapshotCorruptError` on any validation failure (the caller's cue
    to fall back cold), and plain `SnapshotError` for a sound snapshot
    of a mesh engine."""
    manifest, sections = _read_sections(path)
    try:
        meta = json.loads(sections["meta"])
        state = json.loads(sections["state"])
        requests = json.loads(sections["requests"])
    except ValueError as e:
        raise _corrupt(path, f"undecodable section payload: {e}")
    try:
        fp = model_fingerprint(model)
        if meta["model"] != fp:
            raise _corrupt(path, f"model fingerprint mismatch: snapshot "
                                 f"{meta['model']}, engine {fp}")
        cfg = dict(meta["config"])
        if cfg.get("cache_dtype") is not None:
            cfg["cache_dtype"] = _torch_dtype(cfg["cache_dtype"])
        if manifest.get("shards", 1) > 1 or cfg.get("mesh_shards"):
            raise SnapshotError(
                f"{path}: a mesh engine's snapshot ({manifest.get('shards')}"
                f" shard section(s), mesh_shards "
                f"{cfg.get('mesh_shards')}); this engine serves one device")
        engine = ServingEngine(model, EngineConfig(**cfg),
                               on_token=on_token, on_finish=on_finish,
                               on_timeout=on_timeout)
        _restore_pools(engine, path, meta, sections["pools"])

        engine.pool._free = [int(p) for p in state["free"]]
        engine.pool._refs = [int(r) for r in state["refs"]]
        alloc = engine.allocator
        alloc.watermark_pages = state["watermark_pages"]
        counters = state["counters"]
        alloc.prefix_hits = counters["prefix_hits"]
        alloc.prefix_misses = counters["prefix_misses"]
        alloc.prefix_hit_tokens = counters["prefix_hit_tokens"]
        alloc.prefix_evictions = counters["prefix_evictions"]
        alloc._prefix = {}
        for e in state["prefix"]:
            key = tuple(int(t) for t in e["key"])
            alloc._prefix[key] = _PrefixEntry(
                key=key,
                page=int(e["page"]),
                parent=(tuple(int(t) for t in e["parent"])
                        if e["parent"] is not None else None),
                children={tuple(int(t) for t in c)
                          for c in e["children"]},
                last_use=int(e["last_use"]),
            )
        sched_state = state["scheduler"]
        engine.scheduler.token_budget = sched_state["token_budget"]
        engine.scheduler.prefix_admission = sched_state["prefix_admission"]
        engine.scheduler.num_preemptions = sched_state["num_preemptions"]

        for d in requests:
            req = _request_from_dict(d)
            if d["queue"] == "waiting":
                engine.scheduler.waiting.append(req)
            else:
                engine.scheduler.running.append(req)
            engine._wall[req.request_id] = {"added": time.perf_counter()}
        engine._step = meta["step"]
        engine._next_seq = meta["next_seq"]
    except (KeyError, TypeError, ValueError) as e:
        # CRC-valid but structurally unusable: still a typed refusal
        raise _corrupt(path, f"malformed snapshot contents: {e!r}")
    return engine


def recover_engine(model, directory: str, *, on_token=None, on_finish=None,
                   on_timeout=None) -> tuple[ServingEngine, dict]:
    """Warm recovery: the newest valid snapshot, then journal replay.

    Scans ``directory`` newest first, restores the first snapshot that
    validates, then replays every journal at or after its step (a
    journal closes only after the next snapshot lands, so the chain is
    whole even when the newest snapshot is the damaged one).  Raises
    `SnapshotCorruptError` when nothing validates: the cue for the cold
    path."""
    snaps = list_snapshots(directory)
    skipped: list[dict] = []
    engine = None
    chosen = -1
    chosen_path = None
    for step, path in reversed(snaps):
        try:
            engine = restore(path, model, on_token=on_token,
                             on_finish=on_finish, on_timeout=on_timeout)
            chosen, chosen_path = step, path
            break
        except SnapshotError as e:
            skipped.append({"path": path, "error": str(e)})
    if engine is None:
        raise SnapshotCorruptError(
            f"{directory}: no valid snapshot among {len(snaps)} "
            f"candidate(s): "
            + (skipped[-1]["error"] if skipped else "directory empty"))
    events: list[dict] = []
    for jstep, jpath in list_journals(directory):
        if jstep >= chosen:
            events.extend(Journal.read(jpath))
    replayed = apply_journal(engine, events)
    return engine, {
        "snapshot_step": chosen,
        "snapshot_path": chosen_path,
        "journal_events": replayed,
        "skipped": skipped,
    }


class SnapshotManager:
    """Periodic snapshots and journal rotation for one engine.

    Wraps ``engine.step`` by instance-attribute assignment to snapshot
    every ``every`` steps, attaches the write-ahead `Journal`, and
    writes a genesis snapshot at attach so recovery always has a base.
    Keeps the ``keep`` newest snapshots and every journal needed to
    chain-replay from the oldest kept one.

    Attach starts a new incarnation: every ``snap-*``/``journal-*`` (and
    torn ``.tmp``) a previous manager of this directory left is deleted
    before the genesis lands.  Their names are keyed by step, so left in
    place a dead incarnation's journal would replay records the genesis
    already holds, and its higher-step snapshots would outrank it.

    ``crash_next`` is a crash point: when armed, the next save dies
    mid-write, leaving a partial ``.tmp`` file and never touching the
    final path, which recovery must not even notice.
    """

    def __init__(self, engine: ServingEngine, directory: str, *,
                 every: int = 16, keep: int = 3):
        if every < 1 or keep < 1:
            raise SnapshotError(
                f"SnapshotManager needs every>=1, keep>=1 "
                f"(got every={every}, keep={keep})")
        os.makedirs(directory, exist_ok=True)
        self.engine = engine
        self.directory = directory
        self.every = every
        self.keep = keep
        self.crash_next = False
        self.saves = 0
        self.last_snapshot_step = -1
        self._inner_step = engine.step
        engine.step = self._step
        self._clear_stale()
        # the genesis snapshot creates the incarnation's first journal
        engine.journal = None
        self.snapshot()

    def _clear_stale(self) -> None:
        """Delete a dead incarnation's files (see the class docstring)."""
        stale = [p for _, p in list_snapshots(self.directory)]
        stale += [p for _, p in list_journals(self.directory)]
        stale += [os.path.join(self.directory, name)
                  for name in os.listdir(self.directory)
                  if name.endswith(".tmp")]
        for path in stale:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _step(self):
        metrics = self._inner_step()
        if self.engine.current_step % self.every == 0:
            self.snapshot()
        return metrics

    def snapshot(self) -> str | None:
        """Take one snapshot now; returns its path (None when the armed
        crash point fired instead)."""
        engine = self.engine
        step = engine.current_step
        if self.crash_next:
            self.crash_next = False
            blob = serialize(engine)
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            # deliberately torn: the process dies mid-write, and the
            # final snapshot path is never touched
            with os.fdopen(fd, "wb") as f:
                f.write(blob[:max(1, len(blob) // 2)])
            return None
        path = snapshot_path(self.directory, step)
        save(engine, path)
        # rotate after the snapshot lands: the outgoing journal stays
        # whole on disk, so replay can chain from an older snapshot if
        # this one is later damaged
        if engine.journal is not None:
            engine.journal.close()
        engine.journal = Journal(journal_path(self.directory, step),
                                 snapshot_step=step)
        self.saves += 1
        self.last_snapshot_step = step
        self._prune()
        return path

    def _prune(self) -> None:
        snaps = list_snapshots(self.directory)
        drop = snaps[:-self.keep] if len(snaps) > self.keep else []
        for _, path in drop:
            try:
                os.unlink(path)
            except OSError:
                pass
        oldest_kept = snaps[-self.keep][0] if len(snaps) >= self.keep \
            else (snaps[0][0] if snaps else 0)
        for jstep, jpath in list_journals(self.directory):
            if jstep < oldest_kept:
                try:
                    os.unlink(jpath)
                except OSError:
                    pass

    def detach(self) -> None:
        """Unhook from the engine: step unwrapped, the journal's append
        handle closed and dropped.  Idempotent."""
        self.engine.step = self._inner_step
        if self.engine.journal is not None:
            self.engine.journal.close()
        self.engine.journal = None
