#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`attention_tpu_torch`) on one
NVIDIA card.  Run it from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` and ``nvidia-smi``, and imports
nothing of JAX.  Every phase raises on a failure, so the script exits
non-zero unless all of them pass:

1. build   both CUDA kernels from ``attention_tpu_torch/csrc`` (one
           ``nvcc`` each, started together); print the card's name and
           power limit.
2. kernels each kernel against its plain PyTorch version on the card,
           under the limits of `reference.mismatch`: flash in f32 with
           dk != dv and ragged edges, in bf16 causal GQA with softcap,
           at the op path's shape, and at the served model's causal
           forward (32 q / 4 kv heads, sequence 4096); ragged on a step
           that the port's own scheduler packed at the serving
           geometry, with decode, prefill, pad and one poisoned slot.
           Each kernel must give the same bits on a second call, and
           the plain output with a planted fault (its last key tile
           dropped, or its scale 2% off) must fail the same check.
3. op path the ``scale4`` testcase (m = n = 8192, dk = dv = 128) from
           the port's generator, through ``cli run --backend flash`` in
           f32 and bf16: both must print ``Correct!``.
4. serving `TinyDecoder` at the BASELINE.md config-5 attention geometry
           (32 q / 4 kv heads, head_dim 128, dim 4096), depth 4, vocab
           32000, rope, softcap 50, bf16, random weights from a seed,
           serving 8 greedy requests (prompts of 128-1024 tokens, 32
           output tokens each) through `ServingEngine`, then the same
           run once more under `torch.profiler` for device time by
           kernel; then a small f32 model's logits and greedy streams
           on the card against the same model on the CPU (plain
           versions), each side's logits the same bits twice.

Launch counts are reset just before the op path and just before the
serving run and read just after each.  Kernel times are CUDA-event
medians after warm-up.  The second-to-last stdout line is the
``{"kernels": [...]}`` record, the last ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the widest key tile of the kernels' loops (attend_mma's 64 rows)
KEY_TILE = 64
SERVE_MODEL = dict(vocab=32000, dim=4096, depth=4, num_q_heads=32,
                   num_kv_heads=4, rope=True, softcap=50.0)
SERVE_ENGINE = dict(step_mode="ragged", page_size=128, num_pages=512,
                    max_seq_len=2048, max_decode_batch=8,
                    max_prefill_rows=2, prefill_chunk=256,
                    token_budget=512)
# the __graft_entry__.entry() model
SMALL_MODEL = dict(vocab=256, dim=256, depth=2, num_q_heads=8,
                   num_kv_heads=2, rope=True, softcap=50.0)


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time for ``nbytes`` of traffic and ``ops`` operations
    at the card's peaks, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes > t_ops else "operations")


def time_ms(fn, *, calls: int = 5, reps: int = 7) -> float:
    """Median over ``reps`` CUDA-event windows of ``calls`` back-to-back
    calls, per call, after two warm-up calls."""
    fn()
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


def held(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """A kernel's output against its plain version's on the same inputs,
    under `reference.mismatch`'s limits: (max abs error, largest share
    of the limit).  Raises beyond the limits."""
    from attention_tpu_torch.ops.reference import mismatch

    torch.cuda.synchronize()
    err, ratio = mismatch(got, want)
    if not ratio <= 1.0:
        raise AssertionError(f"max abs err {err}: {ratio} x the limit")
    return err, ratio


def rejected(planted: dict, want: torch.Tensor) -> dict:
    """Plain outputs with a fault planted in them must fail the check
    that the kernel passes: {fault: share of the limit}."""
    from attention_tpu_torch.ops.reference import mismatch

    out = {what: mismatch(got, want)[1] for what, got in planted.items()}
    if not all(ratio > 1.0 for ratio in out.values()):
        raise AssertionError(f"the check passes a planted fault: {out}")
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> None:
    """Two calls on the same inputs must give the same bits."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    if not torch.equal(a.view(ints), b.view(ints)):
        raise AssertionError("two calls on the same inputs differ")


def phase_build(ops) -> None:
    t0 = time.perf_counter()
    report = ops.build()
    emit(phase="build", seconds=time.perf_counter() - t0,
         kernels={k: v["seconds"] for k, v in report.items()})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def ragged_step_from_scheduler(model):
    """A packed step at the serving geometry, built by the port's own
    scheduler: an engine over ``model`` runs until some requests decode
    while others still prefill, then packs its next step.  Layer 0's
    step comes back on copies of its pools, with one prefill slot's
    last page unclaimed so that the append poisons that slot."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        RequestState,
        ServingEngine,
        synthetic_trace,
    )
    from attention_tpu_torch.engine.sim import sampling_of

    eng = ServingEngine(model, EngineConfig(**SERVE_ENGINE))
    for e in synthetic_trace(8, vocab=model.vocab, seed=SEED + 1,
                             prompt_len_min=128, prompt_len_max=1024,
                             max_tokens=32, arrival_every=0):
        eng.add_request(e["prompt"], sampling_of(e), request_id=e["id"])

    def states():
        return {r.state for r in eng.scheduler.running}

    for _ in range(64):
        if RequestState.DECODING in states() and (
                eng.scheduler.waiting or RequestState.PREFILLING in states()):
            break
        eng.step()
    else:
        raise AssertionError("no step mixes decode and prefill")
    sched = eng.scheduler.schedule(eng.current_step)
    _, caches, batch = eng.pack_step(sched)
    step = caches[0]
    last = len(sched.decode) + len(sched.prefill) - 1
    if not (sched.decode and sched.prefill and batch.width > batch.num_real):
        raise AssertionError("the packed step lacks decode, prefill or pad")
    table = step.page_table.clone()
    end = int(batch.cu_q_lens[last + 1]) - 1
    table[last, int(batch.token_pos[end]) // step.page_size] = -1
    return step._replace(k_pool=step.k_pool.clone(),
                         v_pool=step.v_pool.clone(), page_table=table)


def ragged_work(step, q) -> tuple[float, float]:
    """(bytes, operations) one ragged call needs on this step's data:
    real query rows and the output read/written once, each live slot's
    K/V rows read once, every causally visible (token, position) pair
    scored and summed."""
    hq, d = q.shape[1], q.shape[-1]
    hkv = step.k_pool.shape[1]
    item = q.element_size()
    cu = step.cu_q_lens.tolist()
    lens = step.kv_lens.tolist()
    real = cu[int(step.distribution[1])]
    nbytes = hq * (real + q.shape[2]) * d * item
    pairs = 0
    for s in range(int(step.distribution[1])):
        q_len, kv_len = cu[s + 1] - cu[s], lens[s]
        if q_len <= 0 or kv_len < 0:
            continue
        nbytes += 2 * hkv * kv_len * d * item
        pairs += q_len * (kv_len - q_len) + q_len * (q_len + 1) // 2
    return nbytes, 2.0 * (d + d) * hq * pairs


def phase_kernels(kernels, serve_model):
    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_plain,
    )
    from attention_tpu_torch.ops.ragged_paged import (
        ragged_paged_append,
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [
        ("f32_dk_ne_dv_ragged", torch.float32,
         ((4, 200, 64), (2, 333, 64), (2, 333, 96)), {}),
        ("bf16_causal_gqa_softcap", torch.bfloat16,
         ((1, 32, 1024, 128), (1, 4, 1024, 128), (1, 4, 1024, 128)),
         {"causal": True, "softcap": 50.0}),
        ("f32_op_path_shape", torch.float32,
         ((8192, 128), (8192, 128), (8192, 128)), {}),
        ("bf16_op_path_shape", torch.bfloat16,
         ((8192, 128), (8192, 128), (8192, 128)), {}),
        ("bf16_serving_causal_gqa", torch.bfloat16,
         ((1, 32, 4096, 128), (1, 4, 4096, 128), (1, 4, 4096, 128)),
         {"causal": True}),
    ]
    for name, dtype, shapes, kw in cases:
        q, k, v = (randn(*s, dtype=dtype) for s in shapes)
        got = flash_attention(q, k, v, **kw)
        same_bits(got, flash_attention(q, k, v, **kw))
        want = flash_attention_plain(q, k, v, **kw)
        err, ratio = held(got, want)
        faults = rejected({
            "dropped_last_key_tile": flash_attention_plain(
                q, k[..., :-KEY_TILE, :], v[..., :-KEY_TILE, :], **kw),
            "scale_off_2pct": flash_attention_plain(
                q, k, v, scale=1.02 * q.shape[-1] ** -0.5, **kw),
        }, want)
        kernels["flash_fwd"]["max_abs_err"] = max(
            kernels["flash_fwd"]["max_abs_err"], err)
        emit(phase="kernels", kernel="flash_fwd", case=name,
             max_abs_err=err, share_of_limit=ratio,
             planted_faults_share_of_limit=faults)

    step = ragged_step_from_scheduler(serve_model)
    hq, hkv = serve_model.num_q_heads, serve_model.num_kv_heads
    width, d = step.token_pos.shape[0], serve_model.head_dim
    dtype = step.k_pool.dtype
    step = ragged_paged_append(step, randn(1, hkv, width, d, dtype=dtype),
                               randn(1, hkv, width, d, dtype=dtype))
    q = randn(1, hq, width, d, dtype=dtype)
    cu = step.cu_q_lens.tolist()
    active = int(step.distribution[1])
    lens = step.kv_lens.tolist()
    poisoned = [s for s in range(active) if lens[s] < 0]
    if len(poisoned) != 1:
        raise AssertionError(f"expected one poisoned slot, got {poisoned}")
    # a decode slot's one token sees its whole cache: cutting the slot's
    # length drops its last key tile
    longest = max(range(int(step.distribution[0])), key=lambda s: lens[s])
    if lens[longest] <= KEY_TILE:
        raise AssertionError(f"no decode slot longer than a key tile: {lens}")
    cut = list(lens)
    cut[longest] -= (lens[longest] - 1) % KEY_TILE + 1
    cut = torch.tensor(cut, dtype=torch.int32, device="cuda")
    for dt in (torch.bfloat16, torch.float32):
        st = step._replace(k_pool=step.k_pool.to(dt),
                           v_pool=step.v_pool.to(dt))
        qd = q.to(dt)
        got = ragged_paged_attention(qd, st, softcap=50.0)
        same_bits(got, ragged_paged_attention(qd, st, softcap=50.0))
        want = ragged_paged_attention_plain(qd, st, softcap=50.0)
        err, ratio = held(got, want)
        faults = rejected({
            "dropped_last_key_tile": ragged_paged_attention_plain(
                qd, st._replace(kv_lens=cut), softcap=50.0),
            "scale_off_2pct": ragged_paged_attention_plain(
                qd, st, scale=1.02 * d ** -0.5, softcap=50.0),
        }, want)
        s = poisoned[0]
        if not (got[:, :, cu[s]:cu[s + 1]].isnan().all()
                and (got[:, :, cu[active]:] == 0).all()):
            raise AssertionError("poisoned rows not NaN or pad not zero")
        kernels["ragged_paged"]["max_abs_err"] = max(
            kernels["ragged_paged"]["max_abs_err"], err)
        emit(phase="kernels", kernel="ragged_paged", case=f"{dt}"[6:],
             decode_slots=int(step.distribution[0]), active_slots=active,
             real_tokens=cu[active], width=width, poisoned_slot=s,
             kv_lens=lens, max_abs_err=err, share_of_limit=ratio,
             planted_faults_share_of_limit=faults)
    return step, q


def phase_op_path(ops, kernels) -> None:
    from attention_tpu_torch import cli
    from attention_tpu_torch.core.testcase import (
        SUITE,
        generate_testcase,
        write_testcase,
    )
    from attention_tpu_torch.ops._native import BUILD_DIR
    from attention_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_plain,
    )

    m, n, dk, dv = SUITE["scale4"]
    path = os.path.join(BUILD_DIR, "scale4.bin")
    t0 = time.perf_counter()
    case = generate_testcase(m, n, dk, dv, seed=SEED)
    write_testcase(path, case)
    emit(phase="op_path", wrote=path, seconds=time.perf_counter() - t0)

    ops.reset_launch_counts()
    for dtype in ("f32", "bf16"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", path, "--backend", "flash", "--dtype",
                           dtype, "--repeats", "5", "--stats"])
        lines = buf.getvalue().splitlines()
        emit(phase="op_path", dtype=dtype, cli=lines)
        if rc != 0 or lines[0] != "Correct!":
            raise AssertionError(f"cli run --dtype {dtype}: {lines}")
    launches = ops.launch_counts()
    if launches["flash_fwd"] < 1:
        raise AssertionError(f"the op path launched no flash kernel: "
                             f"{launches}")
    kernels["flash_fwd"]["launches"] = launches["flash_fwd"]

    nbytes = (m * dk + n * dk + n * dv + m * dv)
    ops_count = 2.0 * (dk + dv) * m * n
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.as_tensor(x).to("cuda", dtype)
                   for x in (case.q, case.k, case.v))
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_attention_plain(q, k, v))
        lib_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q[None], k[None],
                                                       v[None]))
        b_ms, b_by = bound_ms(nbytes * q.element_size(), ops_count, dtype)
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        emit(phase="op_path", kernel="flash_fwd", dtype=f"{dtype}"[6:],
             shape=[m, n, dk, dv], gflop_s=ops_count / ms / 1e6, **rec)
        if dtype is torch.bfloat16:
            kernels["flash_fwd"].update(rec)

    # the served model's uncached causal forward at sequence 4096: many
    # heads, so many more CTAs than scale4's single head gives
    h, hkv, s, d = 32, 4, 4096, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((1, heads, s, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for heads in (h, hkv, hkv))
    kx, vx = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    ops_count = 2.0 * (d + d) * h * s * (s + 1) / 2
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    emit(phase="op_path", kernel="flash_fwd", dtype="bfloat16",
         shape=[h, hkv, s, d], causal=True, ms=ms,
         gflop_s=ops_count / ms / 1e6,
         library_ms=time_ms(lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                q, kx, vx, is_causal=True)),
         bound_ms=bound_ms((2 * h + 2 * hkv) * s * d * 2, ops_count,
                           torch.bfloat16)[0])


def phase_serving(ops, kernels, model) -> None:
    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        replay,
        synthetic_trace,
    )

    trace = synthetic_trace(8, vocab=model.vocab, seed=SEED,
                            prompt_len_min=128, prompt_len_max=1024,
                            max_tokens=32, arrival_every=0)
    eng = ServingEngine(model, EngineConfig(**SERVE_ENGINE))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary, outputs = replay(eng, trace, max_steps=500)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    busy = sum(1 for s in eng.metrics.steps
               if s.decode_tokens or s.prefill_tokens)
    if not all(len(outputs.get(e["id"], [])) == 32 for e in trace):
        raise AssertionError(f"unfinished requests: "
                             f"{ {k: len(v) for k, v in outputs.items()} }")
    if launches["ragged_paged"] != busy * model.depth \
            or eng.model_calls != busy:
        raise AssertionError(f"launches {launches} != {busy} busy steps "
                             f"x depth {model.depth}")
    if eng.nonfinite_events:
        raise AssertionError(f"{eng.nonfinite_events} non-finite logits")
    kernels["ragged_paged"]["launches"] = launches["ragged_paged"]
    emit(phase="serving", steps=summary["num_steps"], busy_steps=busy,
         launches=launches, prompt_tokens=summary["prompt_tokens"],
         output_tokens=summary["output_tokens"], wall_s=wall,
         output_tokens_per_s=summary["output_tokens"] / wall,
         median_step_ms=summary["median_step_ms"],
         mean_host_overhead_ms=summary["mean_host_overhead_ms"],
         pad_tokens=summary["pad_tokens_total"],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)


def phase_reference() -> None:
    """A small f32 model on the card (the kernels) against the same
    weights on the CPU (the plain versions): uncached logits through
    the flash kernel, and greedy token streams through the ragged one.
    A float64 copy on the CPU is the witness that tells which side
    strayed when the two disagree."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        replay,
        synthetic_trace,
    )
    from attention_tpu_torch.models import TinyDecoder, init_params

    cpu = TinyDecoder(dtype=torch.float32, device="cpu", **SMALL_MODEL)
    cpu.load_state_dict(init_params(cpu, SEED))
    gpu = TinyDecoder(dtype=torch.float32, device="cuda", **SMALL_MODEL)
    gpu.load_state_dict(cpu.state_dict())
    f64 = TinyDecoder(dtype=torch.float64, device="cpu", **SMALL_MODEL)
    f64.load_state_dict(cpu.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, SMALL_MODEL["vocab"], (2, 256)))
    with torch.no_grad():
        want = cpu(tokens)
        same_bits(want, cpu(tokens))
        got = gpu(tokens.cuda())
        same_bits(got, gpu(tokens.cuda()))
        got = got.cpu()
        witness = f64(tokens).double()
    err = (got - want).abs().max().item()
    emit(phase="reference", logits_max_abs_err=err, tol=1e-4,
         card_vs_f64=(got.double() - witness).abs().max().item(),
         cpu_vs_f64=(want.double() - witness).abs().max().item())
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the card")
    # the card's kernels and cuBLAS against the host's plain versions and
    # BLAS, all in full f32: the two differ only in summation order
    if not err <= 1e-4:
        raise AssertionError(f"logits differ from the CPU by {err}")
    trace = synthetic_trace(6, vocab=SMALL_MODEL["vocab"], seed=SEED,
                            prompt_len_min=4, prompt_len_max=300,
                            max_tokens=12)
    cfg = EngineConfig(num_pages=32, max_seq_len=512, prefill_chunk=64)
    streams = [replay(ServingEngine(m, cfg), trace)[1] for m in (cpu, gpu)]
    if streams[0] != streams[1]:
        raise AssertionError("greedy streams differ between card and CPU")
    emit(phase="reference", greedy_streams_equal=True, requests=len(trace))


def phase_profile(model) -> None:
    """The serving run once more under `torch.profiler`: device time by
    kernel, summed into classes, and the device's busy share of the
    run's wall time.  Profiling slows the host, so the busy share here
    is a lower bound of the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        replay,
        synthetic_trace,
    )

    trace = synthetic_trace(8, vocab=model.vocab, seed=SEED,
                            prompt_len_min=128, prompt_len_max=1024,
                            max_tokens=32, arrival_every=0)
    eng = ServingEngine(model, EngineConfig(**SERVE_ENGINE))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay(eng, trace, max_steps=500)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes: dict[str, float] = {}
    kernels: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        name = evt.name
        cls = ("ragged_paged" if "ragged_paged" in name
               else "flash_fwd" if "flash_fwd" in name
               else "memcpy/memset" if name.startswith("Mem")
               else "matmul" if any(w in name.lower() for w in
                                    ("gemm", "xmma", "cutlass", "sm90"))
               else "other")
        classes[cls] = classes.get(cls, 0.0) + us / 1e3
        acc = kernels.setdefault(name[:80], [0, 0.0])
        acc[0] += 1
        acc[1] += us / 1e3
    busy_ms = sum(classes.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    emit(phase="profile", steps=eng.current_step, wall_ms=wall * 1e3,
         device_busy_ms=busy_ms, busy_share=busy_ms / (wall * 1e3),
         device_ms_by_class=classes,
         top_kernels=[{"name": n, "count": c, "ms": t}
                      for n, (c, t) in top],
         top_host_ops=[{"name": e.key[:60], "count": e.count,
                        "self_ms": e.self_cpu_time_total / 1e3}
                       for e in host])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    from attention_tpu_torch import ops
    from attention_tpu_torch.models import TinyDecoder, init_params
    from attention_tpu_torch.ops.ragged_paged import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    # f32 stays full f32 on the card: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = {
        "flash_fwd": dict(
            name="flash_fwd", route="cuda",
            source="attention_tpu_torch/csrc/flash_fwd.cu",
            replaces="attention_tpu/ops/flash.py:310", max_abs_err=0.0),
        "ragged_paged": dict(
            name="ragged_paged", route="cuda",
            source="attention_tpu_torch/csrc/ragged_paged.cu",
            replaces="attention_tpu/ops/ragged_paged.py:201",
            max_abs_err=0.0, library_ms=None),
    }
    phase_build(ops)
    model = TinyDecoder(dtype=torch.bfloat16, device="cuda", **SERVE_MODEL)
    model.load_state_dict(init_params(model, SEED))
    step, q = phase_kernels(kernels, model)
    phase_op_path(ops, kernels)
    phase_serving(ops, kernels, model)
    phase_profile(model)
    phase_reference()

    nbytes, ops_count = ragged_work(step, q)
    b_ms, b_by = bound_ms(nbytes, ops_count, q.dtype)
    kernels["ragged_paged"].update(
        ms=time_ms(lambda: ragged_paged_attention(q, step, softcap=50.0)),
        plain_ms=time_ms(lambda: ragged_paged_attention_plain(
            q, step, softcap=50.0)),
        bound_ms=b_ms, bound_by=b_by)
    emit(kernels=list(kernels.values()))
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
