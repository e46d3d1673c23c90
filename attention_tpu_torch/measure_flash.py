"""Times of the flash forward kernel on one CUDA card, beside SDPA's on
the same inputs.  Run it from the root of a checkout:

    python3 attention_tpu_torch/measure_flash.py [--root DIR] [--label L]

``--root`` imports ``attention_tpu_torch`` from another checkout (say the
parent commit, unpacked beside this one), so that two versions are
timed by one script on one card; the kernels build there at first use.
It prints one JSON line per case, with the card's name and power limit
first:

* ``serve32_causal`` and ``serve32_causal_softcap50``: the served
  model's uncached forward, 32 q / 4 kv heads, 4096 rows, d 128, causal,
  without and with softcap 50;
* ``scale4``: the ``scale4`` testcase's shape, one head, m = n = 8192,
  d 128, unmasked;
* ``cached_prefill`` and ``cached_prefill_softcap50``: 8 × 32 heads ×
  512 new rows at the start of 1152-row caches (``kv_valid`` 512);
* ``train_layer``: the training layer's call, b = 4, m = n = 2048,
  (b, s, h, d) views, causal, softcap 50, partials.

Each line: ``digest`` (a hash of the output's bits: equal digests from
two checkouts mean equal bits), ``ms`` (CUDA events over back-to-back
calls, median of 7 windows of 5 calls after two warm-up calls: a call
whose host work outlasts its kernels is timed by its host work),
``device_ms`` (the
call's kernels by `torch.profiler`, mean over 30 calls), ``host_us``
(host time per call, 200 calls enqueued back to back), the body and
split where the checkout names them, and SDPA's ``library_ms`` and
``library_device_ms`` where SDPA computes the same function (it has no
softcap).  All inputs bf16 from a seeded generator.  It needs a card
and fails without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


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


def device_ms(fn, calls: int = 30) -> float:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / calls / 1e3


def digest(out) -> str:
    """A hash of the bits of a tensor or of a tuple of tensors."""
    import torch

    h = hashlib.sha256()
    for t in (out,) if torch.is_tensor(out) else out:
        ints = {2: torch.int16, 4: torch.int32}[t.element_size()]
        h.update(t.contiguous().view(ints).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("measure_flash: torch sees no CUDA card", file=sys.stderr)
        return 1
    from attention_tpu_torch.ops import flash

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    emit(label=args.label, root=os.path.abspath(args.root),
         module=flash.__file__, card=smi.stdout.strip().splitlines()[0])
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    cases = {}
    q, k, v = randn(1, 32, 4096, 128), randn(1, 4, 4096, 128), \
        randn(1, 4, 4096, 128)
    cases["serve32_causal"] = (
        (q, k, v), dict(causal=True), lambda q=q, k=k, v=v:
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True))
    cases["serve32_causal_softcap50"] = (
        (q, k, v), dict(causal=True, softcap=50.0), None)
    q, k, v = randn(8192, 128), randn(8192, 128), randn(8192, 128)
    cases["scale4"] = ((q, k, v), {}, lambda q=q, k=k, v=v:
                       F.scaled_dot_product_attention(
                           q[None, None], k[None, None], v[None, None]))
    q, kc, vc = randn(8, 32, 512, 128), randn(8, 4, 1152, 128), \
        randn(8, 4, 1152, 128)
    prefill = dict(causal=True, q_offset=0, kv_valid=512)
    cases["cached_prefill"] = (
        (q, kc, vc), prefill, lambda q=q, kc=kc, vc=vc:
        F.scaled_dot_product_attention(
            q, kc[:, :, :512], vc[:, :, :512], is_causal=True,
            enable_gqa=True))
    cases["cached_prefill_softcap50"] = (
        (q, kc, vc), dict(prefill, softcap=50.0), None)
    layer = tuple(randn(4, 2048, heads, 128).transpose(1, 2)
                  for heads in (32, 4, 4))
    cases["train_layer"] = (layer, dict(causal=True, softcap=50.0), None)

    plan_of = getattr(flash, "flash_launch_plan", None)
    for name, (qkv, kw, sdpa) in cases.items():
        fn = flash.flash_attention_partials if name == "train_layer" \
            else flash.flash_attention

        def run(fn=fn, qkv=qkv, kw=kw):
            return fn(*qkv, **kw)

        rec = dict(label=args.label, case=name, digest=digest(run()),
                   ms=time_ms(run), device_ms=device_ms(run),
                   host_us=host_us(run))
        if plan_of is not None:
            plan = plan_of(*qkv, kv_valid=kw.get("kv_valid"))
            rec.update(body=plan["body"], splits=plan["splits"])
        if sdpa is not None:
            rec.update(library_ms=time_ms(sdpa),
                       library_device_ms=device_ms(sdpa))
        emit(**rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
