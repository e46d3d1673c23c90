"""CLI harness of the port: the reference's frozen main() contract.

The port's counterpart of `attention_tpu.cli` for the subcommands this
slice carries.  ``run`` loads a ``.bin`` testcase, computes it with the
chosen backend on the chosen device, and prints exactly what the
reference binary prints: ``Correct!`` and ``Elapsed time: ... us``, or
the first-mismatch diagnostic and ``Wrong!`` (exit status 0 either way).

Usage:
  python -m attention_tpu_torch.cli run <testcase.bin> [--backend flash]
      [--dtype bf16|f32|f64] [--repeats 1] [--no-verify] [--stats]
      [--device cuda|cpu]
  python -m torch.distributed.run --standalone --nproc-per-node R
      -m attention_tpu_torch.cli run <testcase.bin> --backend kv-sharded
      # the distributed backends (kv-sharded, q-sharded, auto, ring,
      # ulysses) on a gloo world of R ranks; only rank 0 prints
  python -m attention_tpu_torch.cli generate <out.bin> --m 1024 --n 1024
      --dk 128 --dv 128 [--seed 0]
  python -m attention_tpu_torch.cli suite <out_dir>   # simple..scale5
  python -m attention_tpu_torch.cli backends
  python -m attention_tpu_torch.cli serve-sim [--num-requests 8 ...]
      [--bursty | --diurnal] [--snapshot-dir DIR --snapshot-every N]
      [--mesh-shards N]   # under python -m torch.distributed.run
                          # --nproc-per-node N
      [--device cuda|cpu]
      # the single-engine continuous-batching engine over a synthetic
      # or JSON request trace; prints metrics JSON; with a snapshot
      # directory, snapshots and a write-ahead journal land there
  python -m attention_tpu_torch.cli snapshot inspect|verify PATH
      # a snapshot file, or a --snapshot-dir (newest first)

Every command that computes runs on the card (``--device cuda``, the
default) and fails when there is none; ``--device cpu`` runs the
kernels' plain PyTorch versions on the CPU.  The elapsed time of
``run`` is host clock around calls that end in a device sync, minimum
over ``--repeats`` after one untimed warm-up call; under
``torch.distributed.run`` a barrier brackets each timed call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
           "f64": torch.float64}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cmd_run(args: argparse.Namespace) -> int:
    from attention_tpu_torch.core.testcase import read_testcase
    from attention_tpu_torch.device import resolve_device

    try:
        case = read_testcase(args.testcase)
    except FileNotFoundError:
        # reference diagnostic (attention.c:103-106)
        print(f"Cannot open file: {args.testcase}", file=sys.stderr)
        return 1
    except ValueError:
        print("Invalid testing data.", file=sys.stderr)  # attention.c:112
        return 1

    dev = resolve_device(args.device)
    if args.backend == "oracle":
        q, k, v = case.q, case.k, case.v
    else:
        q, k, v = (torch.as_tensor(x).to(dev, _DTYPES[args.dtype])
                   for x in (case.q, case.k, case.v))
    # under torch.distributed.run every rank runs the backend on its
    # shard; gloo, which also runs several ranks on one card
    joined = (int(os.environ.get("WORLD_SIZE", "1")) > 1
              and not dist.is_initialized())
    if joined:
        dist.init_process_group("gloo")
    try:
        return _run_and_verify(args, case, q, k, v, dev)
    finally:
        if joined:
            dist.destroy_process_group()


def _run_and_verify(args, case, q, k, v, dev) -> int:
    from attention_tpu_torch.api import attention
    from attention_tpu_torch.core.testcase import verify, verify_scan

    world = dist.is_initialized()

    def barrier():
        if world:
            dist.barrier()

    def call():
        out = attention(q, k, v, backend=args.backend, device=dev)
        _sync(dev)
        return out

    # one untimed call makes the result and keeps one-time costs (the
    # kernels' first-use build) out of the timed region
    result = call()
    times = []
    for _ in range(max(1, args.repeats)):
        barrier()
        t0 = time.perf_counter()
        call()
        barrier()
        times.append(time.perf_counter() - t0)
    if world and dist.get_rank() != 0:
        return 0  # rank 0 prints, as the reference's does
    best_us = min(times) * 1e6
    if torch.is_tensor(result):
        result = result.float().cpu().numpy()
    result = np.asarray(result, dtype=np.float64)

    if args.no_verify or case.expected is None:
        print(f"Elapsed time: {best_us:.2f} us")
        return 0
    # the frozen output contract (attention.c:150-151,184-189)
    ok, msg = verify(case.expected, result)
    if ok:
        print("Correct!")
        print(f"Elapsed time: {best_us:.2f} us")
    else:
        print(msg)
        print("Wrong!")
    if args.stats:
        print(verify_scan(case.expected, result).stats_line())
    return 0


def _cmd_generate(args: argparse.Namespace) -> int:
    from attention_tpu_torch.core.testcase import (
        generate_testcase,
        write_testcase,
    )

    case = generate_testcase(args.m, args.n, args.dk, args.dv,
                             seed=args.seed)
    write_testcase(args.out, case)
    print(f"wrote {args.out}: m={args.m} n={args.n} dk={args.dk} "
          f"dv={args.dv} ({case.nbytes()} bytes)")
    return 0


def _cmd_suite(args: argparse.Namespace) -> int:
    from attention_tpu_torch.core.testcase import generate_suite

    for path in generate_suite(args.out_dir, seed=args.seed):
        print(f"wrote {path}")
    return 0


def _cmd_backends(_args: argparse.Namespace) -> int:
    from attention_tpu_torch.api import available_backends

    for name in available_backends():
        print(name)
    return 0


def _cmd_serve_sim(args: argparse.Namespace) -> int:
    """Run the engine on a request trace (from --trace JSON, else
    synthetic) and print metrics JSON."""
    from attention_tpu_torch.engine import (
        EngineConfig,
        ServingEngine,
        SnapshotManager,
        bursty_trace,
        diurnal_trace,
        load_trace,
        replay,
        save_trace,
        synthetic_trace,
    )
    from attention_tpu_torch.models import TinyDecoder, init_params

    model = TinyDecoder(
        vocab=args.vocab, dim=args.dim, depth=args.depth,
        num_q_heads=args.q_heads, num_kv_heads=args.kv_heads,
        dtype=_DTYPES[args.dtype], device=args.device)
    model.load_state_dict(init_params(model, args.model_seed))
    if (args.snapshot_dir is None) != (args.snapshot_every is None):
        print("--snapshot-dir and --snapshot-every must be set together",
              file=sys.stderr)
        return 2
    if args.trace:
        trace = load_trace(args.trace)
    elif args.diurnal:
        trace = diurnal_trace(
            args.num_requests, vocab=args.vocab, seed=args.seed,
            period=args.diurnal_period, base_rate=args.base_rate,
            peak_rate=args.peak_rate, tenants=args.tenants,
            rag_every=args.rag_every,
            rag_prefill_len=args.rag_prefill_len,
            prompt_len_min=args.prompt_len_min,
            prompt_len_max=args.prompt_len_max,
            max_tokens=args.max_tokens,
            temperature=args.temperature,
        )
    elif args.bursty:
        trace = bursty_trace(
            args.num_requests, vocab=args.vocab, seed=args.seed,
            tenants=args.tenants, burst_every=args.burst_every,
            burst_size=args.burst_size,
            shared_prefix_len=args.shared_prefix_len,
            prompt_len_min=args.prompt_len_min,
            prompt_len_max=args.prompt_len_max,
            max_tokens=args.max_tokens,
            temperature=args.temperature,
        )
    else:
        trace = synthetic_trace(
            args.num_requests, vocab=args.vocab, seed=args.seed,
            prompt_len_min=args.prompt_len_min,
            prompt_len_max=args.prompt_len_max,
            max_tokens=args.max_tokens, arrival_every=args.arrival_every,
            shared_prefix_len=args.shared_prefix_len,
            shared_count=args.shared_count,
            temperature=args.temperature,
        )
    if args.trace_out:
        save_trace(args.trace_out, trace)
    config = EngineConfig(
        num_pages=args.num_pages, page_size=args.page_size,
        max_seq_len=args.max_seq_len,
        max_decode_batch=args.max_decode_batch,
        max_prefill_rows=args.max_prefill_rows,
        prefill_chunk=args.prefill_chunk,
        token_budget=args.token_budget,
        watermark_pages=args.watermark_pages,
        mesh_shards=args.mesh_shards,
    )
    # under torch.distributed.run every rank serves the trace on its
    # heads (gloo, which also runs several ranks on one card); rank 0
    # prints the one summary
    joined = (int(os.environ.get("WORLD_SIZE", "1")) > 1
              and not dist.is_initialized())
    if joined:
        dist.init_process_group("gloo")
    try:
        engine = ServingEngine(model, config)
        if args.snapshot_dir is not None:
            SnapshotManager(engine, args.snapshot_dir,
                            every=args.snapshot_every)
        summary, outputs = replay(engine, trace, max_steps=args.max_steps)
        rank = dist.get_rank() if dist.is_initialized() else 0
    finally:
        if joined:
            dist.destroy_process_group()
    if rank != 0:
        return 0
    if args.per_step:
        for m in engine.metrics.steps:
            print(m.to_json())
    out = {"summary": summary,
           "device": {"type": engine.device.type,
                      "name": (torch.cuda.get_device_name(engine.device)
                               if engine.device.type == "cuda" else "cpu")}}
    if args.outputs:
        out["outputs"] = outputs
    print(json.dumps(out))
    return 0


def _snapshot_paths(path: str) -> list[str]:
    """A snapshot file as it is; a directory expands to its snapshots,
    newest first (the order recovery considers them in)."""
    if os.path.isdir(path):
        from attention_tpu_torch.engine.snapshot import list_snapshots

        return [p for _, p in reversed(list_snapshots(path))]
    return [path]


def _cmd_snapshot_inspect(args: argparse.Namespace) -> int:
    """One JSON line per snapshot: manifest and metadata, without
    building an engine."""
    from attention_tpu_torch.engine.snapshot import inspect

    paths = _snapshot_paths(args.path)
    if not paths:
        print(f"no snapshots under {args.path}", file=sys.stderr)
        return 1
    rc = 0
    for p in paths:
        info = inspect(p)
        print(json.dumps(info, sort_keys=True))
        if not info["valid"]:
            rc = 1
    return rc


def _cmd_snapshot_verify(args: argparse.Namespace) -> int:
    """Check each snapshot's magic, version, section table and
    checksums; exit 0 iff every one is restorable."""
    from attention_tpu_torch.engine.snapshot import verify

    paths = _snapshot_paths(args.path)
    if not paths:
        print(f"no snapshots under {args.path}", file=sys.stderr)
        return 1
    rc = 0
    for p in paths:
        problems = verify(p)
        if problems:
            rc = 1
            for problem in problems:
                print(f"{p}: {problem}")
        else:
            print(f"{p}: ok")
    return rc


def _add_serve_sim_args(ss) -> None:
    """serve-sim's single-engine flag set (the JAX CLI's, less the
    front-end, fleet and telemetry options)."""
    ss.add_argument("--trace", default=None,
                    help="JSON request trace to replay (default: "
                         "synthesize one from the --num-requests knobs)")
    ss.add_argument("--trace-out", default=None,
                    help="write the (possibly synthetic) trace here")
    ss.add_argument("--per-step", action="store_true",
                    help="emit one JSON line per engine step")
    ss.add_argument("--outputs", action="store_true",
                    help="include generated token ids in the summary")
    ss.add_argument("--max-steps", type=int, default=10000)
    # synthetic-trace knobs
    ss.add_argument("--num-requests", type=int, default=8)
    ss.add_argument("--seed", type=int, default=0)
    ss.add_argument("--prompt-len-min", type=int, default=4)
    ss.add_argument("--prompt-len-max", type=int, default=24)
    ss.add_argument("--max-tokens", type=int, default=8)
    ss.add_argument("--arrival-every", type=int, default=1)
    ss.add_argument("--shared-prefix-len", type=int, default=0)
    ss.add_argument("--shared-count", type=int, default=0)
    ss.add_argument("--temperature", type=float, default=0.0)
    # bursty multi-tenant trace knobs (engine.sim.bursty_trace)
    ss.add_argument("--bursty", action="store_true",
                    help="synthesize a multi-tenant bursty trace "
                         "(sessions, priorities, per-tenant shared "
                         "prefixes) instead of the plain one")
    ss.add_argument("--tenants", type=int, default=2)
    ss.add_argument("--burst-every", type=int, default=6)
    ss.add_argument("--burst-size", type=int, default=3)
    # diurnal trace knobs (engine.sim.diurnal_trace)
    ss.add_argument("--diurnal", action="store_true",
                    help="synthesize a sinusoidal diurnal trace (one "
                         "day of --diurnal-period ticks between "
                         "--base-rate and --peak-rate req/tick, with "
                         "periodic RAG prefill bursts) instead of the "
                         "plain one")
    ss.add_argument("--diurnal-period", type=int, default=48,
                    help="ticks per simulated day")
    ss.add_argument("--base-rate", type=float, default=1.0,
                    help="trough arrival rate, requests/tick")
    ss.add_argument("--peak-rate", type=float, default=4.0,
                    help="peak arrival rate, requests/tick")
    ss.add_argument("--rag-every", type=int, default=7,
                    help="every Nth diurnal request is a long-prefill "
                         "RAG burst")
    ss.add_argument("--rag-prefill-len", type=int, default=64,
                    help="shared retrieval-header length for RAG "
                         "bursts (0 disables them)")
    # crash-consistent durability (engine.snapshot)
    ss.add_argument("--snapshot-dir", default=None,
                    help="persist checksummed engine snapshots and "
                         "journals here; requires --snapshot-every")
    ss.add_argument("--snapshot-every", type=int, default=None,
                    help="snapshot period in engine steps; requires "
                         "--snapshot-dir")
    ss.add_argument("--mesh-shards", type=int, default=0,
                    help="serve through the KV-head-sharded kernels on a "
                         "'tp' mesh of N ranks (0 = one device; tokens "
                         "are the same either way; --kv-heads must divide "
                         "by N); run under python -m torch.distributed.run "
                         "--nproc-per-node N, which gives the world its N "
                         "ranks")
    # model knobs (weights from --model-seed)
    ss.add_argument("--vocab", type=int, default=64)
    ss.add_argument("--dim", type=int, default=64)
    ss.add_argument("--depth", type=int, default=2)
    ss.add_argument("--q-heads", type=int, default=4)
    ss.add_argument("--kv-heads", type=int, default=2)
    ss.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ss.add_argument("--model-seed", type=int, default=0)
    # engine knobs
    ss.add_argument("--num-pages", type=int, default=64)
    ss.add_argument("--page-size", type=int, default=128)
    ss.add_argument("--max-seq-len", type=int, default=512)
    ss.add_argument("--max-decode-batch", type=int, default=8)
    ss.add_argument("--max-prefill-rows", type=int, default=2)
    ss.add_argument("--prefill-chunk", type=int, default=32)
    ss.add_argument("--token-budget", type=int, default=128)
    ss.add_argument("--watermark-pages", type=int, default=1)
    ss.add_argument("--device", default="cuda")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="attention-tpu-torch",
                                     description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run a testcase and verify "
                                     "(reference main())")
    run.add_argument("testcase")
    run.add_argument("--backend", default="flash")
    run.add_argument("--dtype", choices=sorted(_DTYPES), default="f32")
    run.add_argument("--repeats", type=int, default=1,
                     help="min-over-repeats timing (reference methodology)")
    run.add_argument("--no-verify", action="store_true")
    run.add_argument("--stats", action="store_true",
                     help="append a full-scan statistics line "
                          "(max-abs-error, mismatch count) after the "
                          "frozen verdict lines")
    run.add_argument("--device", default="cuda")
    run.set_defaults(fn=_cmd_run)

    gen = sub.add_parser("generate",
                         help="write a random testcase + oracle output")
    gen.add_argument("out")
    gen.add_argument("--m", type=int, required=True)
    gen.add_argument("--n", type=int, required=True)
    gen.add_argument("--dk", type=int, required=True)
    gen.add_argument("--dv", type=int, required=True)
    gen.add_argument("--seed", type=int, default=0)
    gen.set_defaults(fn=_cmd_generate)

    suite = sub.add_parser("suite", help="write the simple..scale5 ladder")
    suite.add_argument("out_dir")
    suite.add_argument("--seed", type=int, default=0)
    suite.set_defaults(fn=_cmd_suite)

    be = sub.add_parser("backends", help="list available backends")
    be.set_defaults(fn=_cmd_backends)

    ss = sub.add_parser(
        "serve-sim",
        help="continuous-batching engine on a synthetic or JSON request "
             "trace; prints metrics JSON")
    _add_serve_sim_args(ss)
    ss.set_defaults(fn=_cmd_serve_sim)

    sn = sub.add_parser(
        "snapshot",
        help="inspect / verify serve-sim snapshot files")
    snsub = sn.add_subparsers(dest="snapshot_cmd", required=True)
    si = snsub.add_parser("inspect", help="print manifest + metadata "
                                          "JSON per snapshot")
    si.add_argument("path", help=".atpsnap file or a --snapshot-dir")
    si.set_defaults(fn=_cmd_snapshot_inspect)
    sv = snsub.add_parser("verify", help="check integrity (checksums, "
                                         "version, section table); "
                                         "exit 0 iff restorable")
    sv.add_argument("path", help=".atpsnap file or a --snapshot-dir")
    sv.set_defaults(fn=_cmd_snapshot_verify)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
