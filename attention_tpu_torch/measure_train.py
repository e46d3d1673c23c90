"""The smoke's dense train cell timed on one CUDA card: the serving
model (dim 4096, 32 q / 4 kv heads, vocab 32000, rope, softcap 50, bf16,
depth 4) from `init_train(seed=0, lr=1e-3)`, 8 fused steps of
`make_train_step` on the smoke's seeded batch of 4 x 2049 tokens.  Run
it from the root of a checkout:

    python3 attention_tpu_torch/measure_train.py [--root DIR] [--label L]

``--root`` imports ``attention_tpu_torch`` from another checkout (say the
parent commit, unpacked beside this one), so that two versions of the
trainer are timed by one script on one card; the kernels build there at
first use.  It prints the card's name and power limit, then one JSON
line: ``median_step_ms`` (CUDA events around each step, the median of
steps 3-8), ``step_ms``, the first three losses, ``peak_memory_gib``
(`torch.cuda.max_memory_allocated` over the 8 steps) and
``adamw_device_ms`` (AdamW's ``multi_tensor_apply`` kernels in one more
step under `torch.profiler`).  It needs a card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("measure_train: torch sees no CUDA card", file=sys.stderr)
        return 1
    from attention_tpu_torch.models import TinyDecoder, init_train, \
        make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TinyDecoder(dtype=torch.bfloat16, device="cuda", vocab=32000,
                        dim=4096, depth=4, num_q_heads=32, num_kv_heads=4,
                        rope=True, softcap=50.0)
    step = make_train_step(model, init_train(model, seed=0, lr=1e-3))
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = torch.randint(0, 32000, (4, 2049), generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(8):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        losses.append(step(batch).item())
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    adamw = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and "multi_tensor" in e.name) / 1e3
    print(json.dumps(dict(label=args.label, root=os.path.abspath(args.root),
                          median_step_ms=statistics.median(ms[2:]),
                          step_ms=ms, losses=losses[:3],
                          peak_memory_gib=peak, adamw_device_ms=adamw)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
