"""Write-ahead journal: the delta between snapshots — the port of
`attention_tpu.engine.journal`, the same file format.

A snapshot (`engine/snapshot.py`) is a consistent cut of the full
engine state; the journal records everything that *changes* the
client-visible contract after that cut — admissions, cancellations,
deadline expiries, and every emitted token — so recovery is

    latest valid snapshot  +  journal replay  =  the crashed engine,

with recovery cost bounded by snapshot lag instead of total live
context (the cold path re-prefills every in-flight prompt from
scratch).

Format: append-only JSONL, one record per line, each carrying a
``crc`` of its own canonical serialization.  Append-only is what makes
the *record* path crash-safe without the tmp+``os.replace`` idiom the
snapshot needs (ATP701 in `analysis/durability.py` enforces exactly
this split): a crash can tear at most the final line, and
:meth:`Journal.read` stops at the first record that fails to parse or
checksum — the valid prefix is used, a torn tail is silently dropped,
never an exception.  The file itself, though, is created FRESH and
atomically (tmp + ``os.replace`` of the ``begin`` record): a journal
extends exactly the snapshot it is named for, so a same-named file
left by a dead incarnation holds records already baked into that
snapshot — appending across incarnations would replay them twice.
Files are named ``journal-<step:08d>.wal`` after the snapshot step
they extend and are rotated by `SnapshotManager` *after* the next
snapshot lands, so a corrupt newest snapshot can still chain-replay
from an older one through the complete journals in between.

Replay (`apply_journal`) applies the *net effect* per request rather
than re-executing events: requests that reached a terminal state after
the snapshot are dropped; snapshot-live requests that emitted tokens
are rewound onto the resume invariant (all emitted tokens fed back
except the newest, which waits in ``pending_token``) with
``computed_tokens`` held at the snapshot value — the KV appended after
the cut died with the process, so the chunked prefill-continuation
path recomputes it; post-snapshot admissions re-enter through
``add_request``/``resume_request``.  The engine's sampler is a function
of the request's seed and its count of sampled tokens, so sampled
continuations stay token-identical to an uninterrupted run.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import zlib

from attention_tpu_torch.engine.errors import (
    DeadlineExceededError,
    SnapshotError,
)
from attention_tpu_torch.engine.request import RequestState, SamplingParams

JOURNAL_SUFFIX = ".wal"

_JOURNAL_RE = re.compile(r"^journal-(\d{8})\.wal$")

#: record kinds replay understands; anything else is skipped (forward
#: compatibility: an old reader ignores kinds a newer writer adds)
RECORD_KINDS = ("begin", "admit", "token", "cancel", "finish", "timeout")


def journal_path(directory: str, step: int) -> str:
    """The journal file extending the snapshot taken at ``step``."""
    return os.path.join(directory, f"journal-{step:08d}{JOURNAL_SUFFIX}")


def list_journals(directory: str) -> list[tuple[int, str]]:
    """``(snapshot_step, path)`` pairs, ascending by step."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in names:
        m = _JOURNAL_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def _canonical(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _record_line(rec: dict) -> bytes:
    crc = zlib.crc32(_canonical(rec).encode())
    return (_canonical({**rec, "crc": crc}) + "\n").encode()


class Journal:
    """Append-only record stream attached to one `ServingEngine`.

    The engine calls the ``record_*`` hooks (guarded on
    ``engine.journal is not None``, so the no-durability path costs one
    attribute check per event).  Appends go through ONE long-lived
    ``"ab"`` handle, flushed per record so readers of the path always
    see every completed line; the only torn state a crash can leave is
    the final line.  The handle's lifetime is explicit: ``close()`` is
    called by `SnapshotManager` on journal rotation and on ``detach``
    so a kill/restart storm leaks neither file descriptors nor
    ResourceWarnings.
    """

    def __init__(self, path: str, *, snapshot_step: int):
        self.path = path
        self.snapshot_step = snapshot_step
        self.records_written = 0
        # The journal extends the snapshot just taken at
        # ``snapshot_step``: a same-named file on disk belongs to a
        # dead incarnation and its records are already baked into that
        # snapshot, so the file is created fresh — atomically, via a
        # sibling temp + os.replace, never truncate-in-place — and a
        # crash here leaves either no journal (reads as empty) or a
        # complete begin record, never a stale or torn head.
        directory = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(_record_line({"kind": "begin",
                                      "snapshot_step": snapshot_step}))
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.records_written = 1
        # O_APPEND handle: a concurrent truncate cannot strand the
        # write position
        self._file = open(path, "ab")

    @property
    def closed(self) -> bool:
        return self._file is None

    def close(self) -> None:
        """Release the append handle.  Idempotent; appending to a
        closed journal is a typed error (the engine's ``journal``
        reference must be dropped alongside)."""
        if self._file is not None:
            self._file.close()
            self._file = None

    def _append(self, rec: dict) -> None:
        if self._file is None:
            raise SnapshotError(
                f"journal {self.path} is closed (detached manager or "
                "rotated-out file); records must not land here"
            )
        self._file.write(_record_line(rec))
        self._file.flush()
        self.records_written += 1

    def record_admit(self, req) -> None:
        s = req.sampling
        self._append({
            "kind": "admit",
            "id": req.request_id,
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
            "deadline_step": req.deadline_step,
            # non-empty for resume_request: the already-streamed tokens
            # the re-prefill feeds back
            "outputs": list(req.output_tokens),
        })

    def record_token(self, request_id: str, token: int) -> None:
        self._append({"kind": "token", "id": request_id,
                      "token": int(token)})

    def record_cancel(self, request_id: str) -> None:
        self._append({"kind": "cancel", "id": request_id})

    def record_finish(self, request_id: str) -> None:
        self._append({"kind": "finish", "id": request_id})

    def record_timeout(self, request_id: str) -> None:
        self._append({"kind": "timeout", "id": request_id})

    @staticmethod
    def read(path: str) -> list[dict]:
        """Every valid record from the head of ``path``.

        Missing file reads as empty; reading stops at the first line
        that fails to parse or checksum (append-only means only the
        tail can tear, so everything after a bad line is the same
        crash's debris).
        """
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return []
        records: list[dict] = []
        for line in raw.split(b"\n"):
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                break
            if not isinstance(rec, dict) or "crc" not in rec:
                break
            crc = rec.pop("crc")
            if zlib.crc32(_canonical(rec).encode()) != crc:
                break
            records.append(rec)
        return records


def _stream_done(outputs: list[int], sampling: SamplingParams) -> bool:
    """Mirror of `Request.emit`'s stop conditions on a raw token list."""
    if not outputs:
        return False
    return (len(outputs) >= sampling.max_tokens
            or (sampling.stop_token is not None
                and outputs[-1] == sampling.stop_token))


def apply_journal(engine, events: list[dict]) -> int:
    """Replay journal ``events`` onto a freshly restored engine.

    Net-effect replay in three deterministic passes (each in first-
    appearance order): terminal requests are dropped, snapshot-live
    requests are rewound onto the resume invariant, post-snapshot
    admissions re-enter through the normal intake paths.  No client
    callbacks fire — every journaled token was already streamed before
    the crash.  Returns the number of events applied.
    """
    sched = engine.scheduler
    live = {r.request_id: r for r in (*sched.waiting, *sched.running)}
    admits: dict[str, dict] = {}
    post: dict[str, list[int]] = {}
    ended: set[str] = set()
    order: list[str] = []
    applied = 0
    for ev in events:
        kind = ev.get("kind")
        rid = ev.get("id")
        if kind == "begin" or rid is None:
            continue
        applied += 1
        if rid not in order:
            order.append(rid)
        if kind == "admit":
            admits[rid] = ev
            post[rid] = []
            ended.discard(rid)
        elif kind == "token":
            post.setdefault(rid, []).append(int(ev["token"]))
        elif kind in ("cancel", "finish", "timeout"):
            ended.add(rid)

    # pass 1: drop every request that reached a terminal state after
    # the snapshot — its stream was fully delivered (or deliberately
    # ended) before the crash, so the snapshot copy is stale
    for rid in order:
        if rid in ended and rid in live:
            engine.cancel(rid)
            live.pop(rid)

    # pass 2: rewind snapshot-live requests that emitted tokens after
    # the cut
    for rid in order:
        if rid in ended or rid in admits:
            continue
        req = live.get(rid)
        toks = post.get(rid)
        if req is None or not toks:
            continue
        outs = list(req.output_tokens) + toks
        if _stream_done(outs, req.sampling):
            # finished before the crash; only the finish record tore off
            engine.cancel(rid)
            continue
        req.tokens = list(req.prompt) + outs[:-1]
        req.output_tokens = outs
        req.pending_token = outs[-1]
        # the KV behind the journaled tail died with the process: hold
        # computed_tokens at the snapshot value and fall back to
        # chunked prefill continuation to recompute it
        req.computed_tokens = min(req.computed_tokens, len(req.tokens))
        if (req.computed_tokens < len(req.tokens)
                and req.state is RequestState.DECODING):
            # recovery-time surgery, not a client-visible lifecycle
            # edge — assign directly instead of transition()
            req.state = RequestState.PREFILLING

    # pass 3: re-admit post-snapshot arrivals still live at the crash
    for rid in order:
        if rid not in admits or rid in ended:
            continue
        ev = admits[rid]
        if rid in live:
            # the id was re-admitted after its snapshot-live copy ended
            # without a journaled terminal record (torn tail): the
            # admit record is the fresher truth
            engine.cancel(rid)
        sampling = SamplingParams(**(ev.get("sampling") or {}))
        outs = list(ev.get("outputs") or []) + post.get(rid, [])
        if _stream_done(outs, sampling):
            continue
        try:
            if outs:
                engine.resume_request(
                    ev["prompt"], sampling, request_id=rid,
                    output_tokens=outs, arrival=ev.get("arrival"),
                    deadline_step=ev.get("deadline_step"),
                )
            else:
                engine.add_request(
                    ev["prompt"], sampling, request_id=rid,
                    arrival=ev.get("arrival"),
                    deadline_step=ev.get("deadline_step"),
                )
        except DeadlineExceededError:
            # expired relative to the restored step; the owner's own
            # deadline/retry machinery already saw the original expiry
            pass
    return applied
