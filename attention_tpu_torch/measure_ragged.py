"""Device time of the ragged paged kernel on one CUDA card, by
`torch.profiler`, with the paged decode kernel beside it.  Run it from
the root of a checkout:

    python3 attention_tpu_torch/measure_ragged.py [--root DIR] [--label L]

``--root`` imports ``attention_tpu_torch`` from another checkout (say the
parent commit, unpacked beside this one), so that two versions are timed
by one script on one card; the kernels build there at first use.  It
prints one JSON line per measurement, the card's name and power limit
first.  Three steps at the serving geometry (32 q / 4 kv heads, d 128,
bf16, softcap 50, page 128, 10 slots of 16 pages):

* ``mixed``: the step ``chip_smoke.py`` holds, packed by the port's own
  scheduler at the serving model (`ragged_step_from_scheduler`: decode
  and prefill slots, pad, one poisoned slot), its K/V appended;
* ``decode``: 8 decode slots, one token each, over the seed-0 serving
  trace's prompt lengths plus 16 tokens (the steady state of a serving
  run; `chip_smoke.ragged_step`, as the smoke's decode-only case);
* ``prefill``: two 256-token chunks at lengths 512 and 1024.

Each line: ``digest`` (a hash of the output's bits: equal digests from
two checkouts mean equal bits), ``by_kernel`` (device ms per call of
each kernel name),
``device_ms`` (every kernel of a call), ``ms`` (CUDA events over
back-to-back calls, median of 7 windows of 5 calls), ``host_us`` (host
time per call, 200 calls enqueued back to back), ``bound_ms`` (the
smoke's `ragged_work` at the card's peaks: the larger of the bytes the
call must move, q and the output once and each live slot's K/V rows once
per kv head, and its operations) and, where the checkout has it, the
launch plan
(`ops.ragged_paged.ragged_launch_plan`).  Beside ``decode`` the paged
decode kernel runs the same work as the two-call lowering's (8, 1) call
(``paged_decode``): the nearest yardstick, since no PyTorch call
computes ragged paged attention.  Then, where the checkout has one,
``split_target`` lines: the decode-only and mixed steps at each
``ops.ragged_paged.CTAS_PER_SM`` of 2, 4, 6 and 8 (the decode slots'
key split, `ops.decode.split_plan`'s aim).  Device times are means
over 30 calls after two warm-up calls.  It needs a card and fails
without one.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HQ, HKV, D = 32, 4, 128
SOFTCAP = 50.0
# the seed-0 serving trace's prompt lengths plus 16 decoded tokens
DECODE_LENS = [907, 926, 637, 733, 754, 269, 923, 672]
PREFILL = [(256, 512), (256, 1024)]  # (tokens, length after the append)


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def device_ms(fn, calls: int = 30) -> dict:
    """Mean device ms per call of every kernel ``fn`` launches, in all
    and by kernel name, by `torch.profiler`."""
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
    by: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / \
                calls / 1e3
    return dict(device_ms=sum(by.values()), by_kernel=by)


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


def digest(out) -> str:
    """A hash of a bf16 tensor's bits."""
    import torch

    return hashlib.sha256(out.contiguous().view(torch.int16).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def smoke_module(here: str):
    """This checkout's chip_smoke.py (its step builders), whichever
    checkout ``attention_tpu_torch`` comes from."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mixed_step(smoke, rp, gen):
    """The smoke's mixed step at the serving model, appended."""
    import torch

    from attention_tpu_torch.models import TinyDecoder, init_params

    model = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                        **smoke.SERVE_MODEL)
    model.load_state_dict(init_params(model, smoke.SEED))
    step = smoke.ragged_step_from_scheduler(model)
    del model
    width = step.token_pos.shape[0]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    step = rp.ragged_paged_append(step, randn(1, HKV, width, D),
                                  randn(1, HKV, width, D))
    return randn(1, width, HQ, D).transpose(1, 2), step


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--root", default=here)
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("measure_ragged: torch sees no CUDA card", file=sys.stderr)
        return 1
    from attention_tpu_torch.ops import paged
    from attention_tpu_torch.ops import ragged_paged as rp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    emit(label=args.label, root=os.path.abspath(args.root),
         module=rp.__file__, card=smi.stdout.strip().splitlines()[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smoke = smoke_module(here)
    steps = {
        "mixed": mixed_step(smoke, rp, gen),
        "decode": smoke.ragged_step(gen, [(1, n) for n in DECODE_LENS]),
        "prefill": smoke.ragged_step(gen, PREFILL),
    }
    def bound(q, step):
        return smoke.bound_ms(*smoke.ragged_work(step, q), q.dtype)[0]

    for name, (q, step) in steps.items():
        fn = (lambda step=step, q=q:
              rp.ragged_paged_attention(q, step, softcap=SOFTCAP))
        rec = dict(label=args.label, case=name, digest=digest(fn()),
                   **device_ms(fn),
                   ms=time_ms(fn), host_us=host_us(fn),
                   bound_ms=bound(q, step), width=q.shape[2],
                   q_tile=step.q_tile, kv_lens=step.kv_lens.tolist(),
                   cu_q_lens=step.cu_q_lens.tolist())
        if hasattr(rp, "ragged_launch_plan"):
            rec["plan"] = rp.ragged_launch_plan(q, step, sms=sms)
        emit(**rec)
    q, step = steps["decode"]
    n = len(DECODE_LENS)
    cache = paged.PagedKV(step.k_pool, step.v_pool,
                          step.page_table[:n].contiguous(),
                          step.kv_lens[:n].contiguous())
    q3 = q[0, :, :n].transpose(0, 1).contiguous()  # (8, Hq, d)

    def two_call():
        return paged.paged_flash_decode(q3, cache, softcap=SOFTCAP)

    emit(label=args.label, case="paged_decode", **device_ms(two_call),
         ms=time_ms(two_call), host_us=host_us(two_call),
         bound_ms=bound(q, step))
    if not hasattr(rp, "CTAS_PER_SM"):
        return 0
    chosen = rp.CTAS_PER_SM
    try:
        for cps in (2, 4, 6, 8):
            rp.CTAS_PER_SM = cps
            for name in ("decode", "mixed"):
                q, step = steps[name]
                emit(label=args.label, split_target=cps, case=name,
                     plan=rp.ragged_launch_plan(q, step, sms=sms),
                     **device_ms(lambda q=q, step=step:
                                 rp.ragged_paged_attention(
                                     q, step, softcap=SOFTCAP)))
    finally:
        rp.CTAS_PER_SM = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
