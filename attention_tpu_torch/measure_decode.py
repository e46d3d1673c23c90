"""Device time of the split decode kernels on one CUDA card, by
`torch.profiler`, beside SDPA's on the same inputs.  Run it from the root
of a checkout:

    python3 -m attention_tpu_torch.measure_decode

It prints one JSON line per measurement:

* ``split_target``: the serving decode cases of ``chip_smoke.py`` (8
  sequences of 0 to 4096 rows, 32 q / 4 kv heads, d 128, bf16: one token,
  with softcap 50, a chunk of 4, and the paged kernel with softcap) at
  each ``CTAS_PER_SM`` of 2, 3, 4 and 8: device µs of the split kernel
  and of the merge, the plan, and SDPA's device µs on the first case.
* ``uniform``: 8 sequences of one length, 64 to 4096 rows, at the
  module's ``CTAS_PER_SM``: device µs and the bytes read per µs, with
  the L2 cache warm (the same caches call after call) and cold (a 256
  MiB write in between).
* ``host``: host µs per call of `flash_decode` on the first case, 1000
  calls enqueued back to back.

Device times are means over 30 calls after two warm-up calls.  It needs
a card and fails without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from attention_tpu_torch.ops import decode, paged

LENS = [0, 1, 517, 1024, 2047, 3000, 4095, 4096]
H, HKV, D, N, PAGE = 32, 4, 128, 4096, 128


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def device_us(fn, calls: int = 30) -> dict[str, float]:
    """Mean device µs per call of each kernel class fn launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        key = ("split_kernel" if "decode_kernel" in evt.name
               else "merge" if "merge_splits" in evt.name else "other")
        out[key] = out.get(key, 0.0) + evt.time_range.elapsed_us() / calls
    return out


def plan(b: int, rows: int, s_new: int = 1) -> list[int]:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return list(decode.split_plan(b, HKV, rows, N, s_new, None, sms=sms))


def main() -> int:
    if not torch.cuda.is_available():
        print("measure_decode: torch sees no CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    emit(card=smi.stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    b = len(LENS)
    lens = torch.tensor(LENS, dtype=torch.int32, device="cuda")
    k, v, q, q4 = randn(b, HKV, N, D), randn(b, HKV, N, D), \
        randn(b, H, D), randn(b, H, 4, D)
    per = N // PAGE
    perm = torch.randperm(b * per, generator=gen, device="cuda")

    def pool(x):
        out = torch.empty_like(x).view(b * per, HKV, PAGE, D)
        out[perm] = x.view(b, HKV, per, PAGE, D).transpose(1, 2).reshape(
            b * per, HKV, PAGE, D)
        return out

    cache = paged.PagedKV(pool(k), pool(v), perm.view(b, per).to(
        torch.int32).contiguous(), lens)
    cases = {
        "decode": (lambda: decode.flash_decode(q, k, v, lens), 8),
        "decode_softcap": (lambda: decode.flash_decode(
            q, k, v, lens, softcap=50.0), 8),
        "decode_chunk4": (lambda: decode.flash_decode_chunk(
            q4, k, v, lens, softcap=50.0), 32),
        "paged_softcap": (lambda: paged.paged_flash_decode(
            q, cache, softcap=50.0), 8),
    }
    mask = torch.arange(N, device="cuda") < lens[:, None]
    emit(sdpa_decode_us=device_us(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask[:, None, None],
            enable_gqa=True)))
    chosen = decode.CTAS_PER_SM
    try:
        for cps in (2, 3, 4, 8):
            decode.CTAS_PER_SM = cps
            for name, (fn, rows) in cases.items():
                s_new = rows // 8
                emit(split_target=cps, case=name,
                     plan=plan(b, rows, s_new), device_us=device_us(fn))
    finally:
        decode.CTAS_PER_SM = chosen

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for length in (64, 256, 512, 1024, 2048, 4096):
        ul = torch.full((b,), length, dtype=torch.int32, device="cuda")
        mbytes = 2 * b * HKV * length * D * 2 / 1e6
        warm = device_us(lambda: decode.flash_decode(q, k, v, ul))

        def cold():
            flush.zero_()
            decode.flash_decode(q, k, v, ul)

        cold_us = device_us(cold)
        emit(uniform=length, plan=plan(b, 8), mbytes=mbytes,
             warm_us=warm, cold_split_kernel_us=cold_us["split_kernel"],
             warm_gb_per_s=mbytes * 1e3 / (warm["split_kernel"]
                                           + warm.get("merge", 0.0)))

    fn = cases["decode"][0]
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    emit(host_us_per_call=host)
    return 0


if __name__ == "__main__":
    sys.exit(main())
