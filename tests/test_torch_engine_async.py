"""The port's serving engine beyond the plain step loop, on the CPU: the
async double buffer (``EngineConfig(async_steps=True)``), a snapshot cut
of it, `resume_request`, `health`/`drain`, the bursty and diurnal traces
and the CLI's snapshot surface.

Token streams are compared exactly: staging the next step's page-table
rows changes no model input, and the sampler draws the k-th token of a
request from ``(seed, k)`` alone, so async against sync, restored or
resumed against uninterrupted, must agree token for token.  Against the
JAX package: `health()` after the same greedy steps, and the traces for
the same seeds, must be equal.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from attention_tpu import engine as jax_engine
from attention_tpu.models import TinyDecoder as JaxDecoder
from attention_tpu_torch import cli
from attention_tpu_torch.engine import (
    EngineConfig,
    ServingEngine,
    bursty_trace,
    diurnal_trace,
    replay,
    sampling_of,
    state_fingerprint,
    synthetic_trace,
)
from attention_tpu_torch.engine.snapshot import list_snapshots, restore, \
    save
from attention_tpu_torch.models import TinyDecoder, params_from_jax

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


# ------------------------------------------------------------ async


@pytest.mark.parametrize("temperature", [0.0, 0.6])
def test_async_steps_streams_equal_sync(pair, temperature):
    model = pair[2]
    trace = synthetic_trace(7, vocab=43, seed=9, max_tokens=6,
                            temperature=temperature, prompt_len_max=60)
    _, sync_out = replay(ServingEngine(model, _cfg()), trace)
    eng = ServingEngine(model, _cfg(async_steps=True))
    staged = []
    inner = eng._stage_next_step

    def spy():
        inner()
        staged.append(len(eng._staged_rows))

    eng._stage_next_step = spy
    _, async_out = replay(eng, trace)
    assert async_out == sync_out
    assert all(len(async_out[e["id"]]) == 6 for e in trace)
    assert len(staged) == eng.model_calls and max(staged) > 0


def test_async_snapshot_cut_restores_equal_streams(pair, tmp_path):
    """A cut of the async loop with staged rows live: `quiesce` drops
    them, the restored engine fingerprints equal and both engines
    finish as the uninterrupted run."""
    model = pair[2]
    trace = synthetic_trace(5, vocab=43, seed=11, max_tokens=6,
                            temperature=0.7)
    _, baseline = replay(ServingEngine(model, _cfg(async_steps=True)),
                         trace)
    outs1 = {}
    eng1 = ServingEngine(model, _cfg(async_steps=True),
                         on_finish=_finished_into(outs1))
    _admit_all(eng1, trace)
    for _ in range(4):
        eng1.step()
    assert eng1._staged_rows
    path = str(tmp_path / "snap-async.atpsnap")
    save(eng1, path)
    assert not eng1._staged_rows
    outs2 = {}
    eng2 = restore(path, model, on_finish=_finished_into(outs2))
    assert eng2.config.async_steps
    assert state_fingerprint(eng2) == state_fingerprint(eng1)
    for eng in (eng1, eng2):
        eng.drain(max_steps=200)
    assert outs2
    for outs in (outs1, outs2):
        assert all(toks == baseline[rid] for rid, toks in outs.items())


# ---------------------------------------------------- resume, health


def test_resume_request_continues_the_sampled_stream(pair):
    """Every request resumed from its first k streamed tokens into a
    fresh engine finishes as the uninterrupted run: prompt and fed
    tokens re-prefilled, nothing resampled, the sampler continued from
    the count."""
    model = pair[2]
    trace = synthetic_trace(4, vocab=43, seed=17, max_tokens=7,
                            temperature=0.8)
    _, baseline = replay(ServingEngine(model, _cfg()), trace)
    outs = {}
    eng = ServingEngine(model, _cfg(), on_finish=_finished_into(outs))
    for i, e in enumerate(trace):
        req = eng.resume_request(e["prompt"], sampling_of(e),
                                 request_id=e["id"],
                                 output_tokens=baseline[e["id"]][:i + 1])
        assert req.pending_token == baseline[e["id"]][i]
        assert req.tokens == e["prompt"] + baseline[e["id"]][:i]
    eng.drain()
    assert outs == baseline
    with pytest.raises(ValueError):
        eng.resume_request(trace[0]["prompt"], sampling_of(trace[0]),
                           request_id="done",
                           output_tokens=baseline["req-0"])


def test_health_and_drain_equal_jax(pair):
    jmodel, params, model = pair
    trace = synthetic_trace(5, vocab=43, seed=3, max_tokens=6,
                            shared_prefix_len=129, shared_count=3)
    engines = (jax_engine.ServingEngine(jmodel, params,
                                        jax_engine.EngineConfig(**ENGINE)),
               ServingEngine(model, _cfg()))
    for eng in engines:
        _admit_all(eng, trace)
        for _ in range(3):
            eng.step()
    want, got = (eng.health() for eng in engines)
    assert got == want and got["running"] > 0
    model_eng = engines[1]
    model_eng.step_cost_multiplier = 2.5
    summary = model_eng.drain(max_steps=200)
    health = model_eng.health()
    assert summary["num_requests"] == len(trace)
    assert health["step_virtual_cost"] == 2.5
    assert health["running"] == health["waiting"] == 0
    assert health["free_pages"] + health["cached_pages"] == ENGINE[
        "num_pages"]


@pytest.mark.parametrize("make,jax_make,kw", [
    (bursty_trace, jax_engine.bursty_trace,
     dict(tenants=3, shared_prefix_len=20, deadline_ticks=9)),
    (diurnal_trace, jax_engine.diurnal_trace,
     dict(period=12, peak_rate=3.0, rag_every=3, rag_prefill_len=16)),
], ids=["bursty", "diurnal"])
def test_traces_equal_jax(pair, make, jax_make, kw):
    trace = make(17, vocab=43, seed=5, **kw)
    assert trace == jax_make(17, vocab=43, seed=5, **kw)
    assert len({e["arrival"] for e in trace}) > 1
    _, outs = replay(ServingEngine(pair[2], _cfg()), trace[:6])
    assert all(len(outs[e["id"]]) == e["max_tokens"] for e in trace[:6])


# --------------------------------------------------------------- CLI

SIM = ["serve-sim", "--num-requests", "3", "--max-tokens", "4",
       "--vocab", "43", "--dim", "32", "--depth", "1", "--q-heads", "4",
       "--kv-heads", "2", "--device", "cpu"]


@pytest.mark.parametrize("trace_flag", ["--bursty", "--diurnal"])
def test_cli_serve_sim_snapshots_and_inspect_verify(tmp_path, capsys,
                                                    trace_flag):
    d = str(tmp_path / "clisnaps")
    assert cli.main([*SIM, trace_flag, "--snapshot-dir", d,
                     "--snapshot-every", "2"]) == 0
    capsys.readouterr()
    assert list_snapshots(d)
    assert cli.main(["snapshot", "verify", d]) == 0
    assert ": ok" in capsys.readouterr().out
    assert cli.main(["snapshot", "inspect", d]) == 0
    infos = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert all(i["valid"] for i in infos)
    assert infos[0]["step"] > infos[-1]["step"]  # newest first
    assert [s["name"] for s in infos[0]["sections"]] == [
        "meta", "pools", "state", "requests"]
    _, victim = list_snapshots(d)[-1]
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(victim, "wb") as f:
        f.write(bytes(blob))
    assert cli.main(["snapshot", "verify", d]) == 1
    capsys.readouterr()


@pytest.mark.parametrize("flag", [["--snapshot-every", "4"],
                                  ["--snapshot-dir", "snaps"]])
def test_cli_snapshot_flags_must_pair(capsys, flag):
    assert cli.main([*SIM, *flag]) == 2
    assert "set together" in capsys.readouterr().err
