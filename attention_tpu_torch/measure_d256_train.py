"""The smoke's head-dim-256 train cell on several seeds, on one CUDA card:
the losses of `TRAIN_STEPS` fused steps of `make_train_step` on
`D256_MODEL` (``chip_smoke.py``) beside the same steps with the attention
in PyTorch ops (``impl="xla"``, no kernel), from the same start.  Run it
from the root of a checkout:

    python3 attention_tpu_torch/measure_d256_train.py [--seeds 0 1 2 3]

Seed s draws the weights (`init_train(seed=s)`, AdamW at the smoke's
`TRAIN_LR`) and the batch of `TRAIN_BATCH` tokens (a generator seeded s +
5; the smoke's run is seed 0).  It prints the card's name and power
limit, then one JSON line a seed: both paths' losses, each step's
relative difference, and ``first_rise``, the first step at which the
plain path's loss rises (the number of steps where it never does).  The
smoke holds the steps before it to `TRAIN_PLAIN_RTOL` and from it on the
direction of each move.  It needs a card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        print("measure_d256_train: torch sees no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from attention_tpu_torch.models import TinyDecoder, init_train, \
        make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = TinyDecoder(dtype=torch.bfloat16, device="cuda",
                        **smoke.D256_MODEL)
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed + 5)
        batch = torch.randint(0, model.vocab, smoke.TRAIN_BATCH,
                              generator=gen, device="cuda")
        losses = {}
        for impl in ("flash", "xla"):
            for blk in model.blocks:
                blk.attn.impl = impl
            step = make_train_step(model, init_train(model, seed=seed,
                                                     lr=smoke.TRAIN_LR))
            losses[impl] = [step(batch).item()
                            for _ in range(smoke.TRAIN_STEPS)]
            del step
        fused, plain = losses["flash"], losses["xla"]
        rise = next((i for i in range(1, len(plain))
                     if plain[i] > plain[i - 1]), len(plain))
        print(json.dumps(dict(
            seed=seed, fused=fused, plain=plain, first_rise=rise,
            rel=[abs(a - b) / abs(b) for a, b in zip(fused, plain)])),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
