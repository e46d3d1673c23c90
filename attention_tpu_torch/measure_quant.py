"""Device time of the quantized decode kernels on one CUDA card, by
`torch.profiler`, with the dense and paged decode kernels beside them.
Run it from the root of a checkout:

    python3 attention_tpu_torch/measure_quant.py [--root DIR] [--label L]
        [--head-dim D --heads H KV] [--cases NAME ...] [--no-split-target]

``--root`` imports ``attention_tpu_torch`` from another checkout (say the
parent commit, unpacked beside this one), so that two versions are timed
by one script on one card; the kernels build there at first use.  It
prints one JSON line per measurement, the card's name and power limit
first:

* ``case``: the quantized cases of ``chip_smoke.py`` (8 sequences of 0
  to 4096 rows, 32 q / 4 kv heads, d 128, or ``--heads`` and
  ``--head-dim``, as phase 8's d 256 cases, bf16 caches quantized three
  ways: int8 one token, with softcap 50, with a 512-row window and 4
  sinks, a chunk of 4 with softcap 50; feature-dim and token-paired
  int4 one token), and the dense and paged bf16 decode (the paged one
  with softcap 50) on the same lengths.  Each line: ``kernel_device_ms``
  (the split kernel, by name), ``merge_device_ms``, ``device_ms`` (every
  kernel of a call), ``ms`` (CUDA events over back-to-back calls,
  median of 7 windows of 5 calls), ``host_us`` (host time per call, 200
  calls enqueued back to back), ``bound_ms`` (the bytes the call must
  move at 3.35 TB/s: q and the output once, each sequence's visible
  cache rows and scales once per kv head), and where the checkout has
  them the launch plan and the kernel's registers, shared bytes and
  CTAs per SM;
* ``split_target``: the quantized cases again at each ``CTAS_PER_SM`` of
  2, 3, 4 and 8 (`ops.decode.split_plan`'s aim), where the checkout
  splits them, unless ``--no-split-target``.

``--cases`` keeps only the named cases (the dense and paged ones too).

Device times are means over 30 calls after two warm-up calls.  It needs
a card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

LENS = [0, 1, 517, 1024, 2047, 3000, 4095, 4096]
H, HKV, D, N, PAGE = 32, 4, 128, 4096, 128
PEAK_BYTES_S = 3.35e12  # H100 SXM data sheet


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def device_ms(fn, calls: int = 30) -> dict[str, float]:
    """Mean device ms per call of the split kernel, the merge and every
    kernel ``fn`` launches, by `torch.profiler`, from a profile that
    recorded every call (each kernel a multiple of ``calls`` times): the
    profile of the card's activity alone has missed calls on the H100,
    so a second one is held open a quarter second before and after
    them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    for pad in (0.0, 0.25):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        seen: dict[str, int] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                seen[e.name] = seen.get(e.name, 0) + 1
        if seen and all(c % calls == 0 for c in seen.values()):
            break
    else:
        raise RuntimeError(f"the profiler missed calls: {seen}")
    out = {"kernel_device_ms": 0.0, "merge_device_ms": 0.0,
           "device_ms": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / calls / 1e3
        out["device_ms"] += ms
        if "decode_kernel" in e.name:
            out["kernel_device_ms"] += ms
        elif "merge_splits" in e.name:
            out["merge_device_ms"] += ms
    return out


def time_ms(fn, calls: int = 5, reps: int = 7) -> float:
    import torch

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


def host_us(fn, calls: int = 200) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def bound_ms(s_new: int, row_bytes: int, window=None, sinks=None) -> float:
    """q read and the bf16 output written once, and per kv head each
    sequence's cache rows that any of its rows sees, ``row_bytes`` for K
    and V with their scales, at the card's memory rate."""
    nbytes = 2 * 2 * len(LENS) * H * s_new * D
    for length in LENS:
        lo = length
        for s in range(s_new):
            pos = length - s_new + s
            if pos >= 0:
                lo = min(lo, 0 if window is None else max(pos - window + 1,
                                                          0))
        nbytes += HKV * (length - lo + min(sinks or 0, lo)) * row_bytes
    return nbytes / PEAK_BYTES_S * 1e3


def main(argv=None) -> int:
    global H, HKV, D
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    parser.add_argument("--head-dim", type=int, default=D)
    parser.add_argument("--heads", type=int, nargs=2, default=(H, HKV),
                        metavar=("H", "KV"))
    parser.add_argument("--cases", nargs="+")
    parser.add_argument("--no-split-target", action="store_true")
    args = parser.parse_args(argv)
    H, HKV = args.heads
    D = args.head_dim
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("measure_quant: torch sees no CUDA card", file=sys.stderr)
        return 1
    from attention_tpu_torch.ops import decode, paged, quant

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    emit(label=args.label, root=os.path.abspath(args.root),
         module=quant.__file__, card=smi.stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    b = len(LENS)
    lens = torch.tensor(LENS, dtype=torch.int32, device="cuda")
    k, v, q, q4 = randn(b, HKV, N, D), randn(b, HKV, N, D), \
        randn(b, H, D), randn(b, H, 4, D)
    caches = {"int8": quant.quantize_kv(k, v),
              "int4": quant.quantize_kv_int4(k, v),
              "int4_tok": quant.quantize_kv_int4_tok(k, v)}
    row_bytes = {"int8": 2 * (D + 4), "int4": 2 * (D // 2 + 4),
                 "int4_tok": 2 * (D // 2 + 4)}
    op_of = {"int8": quant.flash_decode_quantized,
             "int4": quant.flash_decode_int4,
             "int4_tok": quant.flash_decode_int4_tok}
    quant_cases = {
        "int8_S1": ("int8", q, {}),
        "int8_S1_softcap": ("int8", q, {"softcap": 50.0}),
        "int8_S1_window512_sinks": ("int8", q, {"window": 512, "sinks": 4}),
        "int8_S4_softcap": ("int8", q4, {"softcap": 50.0}),
        "int4_S1": ("int4", q, {}),
        "int4_tok_S1": ("int4_tok", q, {}),
    }

    def run_quant(fmt, qq, kw):
        fn = quant.flash_decode_quantized_chunk if qq.dim() == 4 \
            else op_of[fmt]
        return lambda: fn(qq, caches[fmt], lens, **kw)

    per = N // PAGE
    perm = torch.randperm(b * per, generator=gen, device="cuda")

    def pool(x):
        out = torch.empty_like(x).view(b * per, HKV, PAGE, D)
        out[perm] = x.view(b, HKV, per, PAGE, D).transpose(1, 2).reshape(
            b * per, HKV, PAGE, D)
        return out

    pcache = paged.PagedKV(pool(k), pool(v), perm.view(b, per).to(
        torch.int32).contiguous(), lens)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = hasattr(quant, "launch_plan")
    kind_of = {"int8": quant.QuantizedKV, "int4": quant.Int4KV,
               "int4_tok": quant.Int4TokKV}
    if args.cases:
        quant_cases = {n: c for n, c in quant_cases.items()
                       if n in args.cases}
    for name, (fmt, qq, kw) in quant_cases.items():
        fn = run_quant(fmt, qq, kw)
        s_new = qq.shape[2] if qq.dim() == 4 else 1
        rec = dict(label=args.label, case=name, **device_ms(fn),
                   ms=time_ms(fn), host_us=host_us(fn),
                   bound_ms=bound_ms(s_new, row_bytes[fmt], kw.get("window"),
                                     kw.get("sinks")))
        if planned:
            plan = quant.launch_plan(qq, caches[fmt], kw.get("window"),
                                     sms=sms)
            rec.update(plan=plan, resources=quant.kernel_resources(
                kind_of[fmt], D, plan["kg"]))
        emit(**rec)
    for name, fn in (
            ("decode_bf16_S1", lambda: decode.flash_decode(q, k, v, lens)),
            ("paged_bf16_S1_softcap", lambda: paged.paged_flash_decode(
                q, pcache, softcap=50.0))):
        if args.cases and name not in args.cases:
            continue
        emit(label=args.label, case=name, **device_ms(fn), ms=time_ms(fn),
             host_us=host_us(fn), bound_ms=bound_ms(1, 4 * D))
    if not planned or args.no_split_target:
        return 0
    chosen = decode.CTAS_PER_SM
    try:
        for cps in (2, 3, 4, 8):
            decode.CTAS_PER_SM = cps
            for name, (fmt, qq, kw) in quant_cases.items():
                emit(label=args.label, split_target=cps, case=name,
                     plan=quant.launch_plan(qq, caches[fmt], kw.get("window"),
                                            sms=sms),
                     **device_ms(run_quant(fmt, qq, kw)))
    finally:
        decode.CTAS_PER_SM = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
