"""Times of the flash backward's kernels on one CUDA card (the fused
kernel, and the dQ + dK/dV pair), beside SDPA's backward on the same
inputs.  Run it from the root of a checkout:

    python3 attention_tpu_torch/measure_bwd.py [--root DIR] [--label L]

``--root`` imports ``attention_tpu_torch`` from another checkout (say the
parent commit, unpacked beside this one), so that two versions are
timed by one script on one card; the kernels build there at first use.
It prints one JSON line per case, with the card's name and power limit
first:

* ``serve32_causal`` and ``serve32_causal_softcap50``: a training call
  at the served model's geometry, b = 1, 32 q / 4 kv heads, m = n =
  4096, d 128, causal, without and with softcap 50;
* ``train_layer``: the training layer's call, b = 4, m = n = 2048,
  (b, s, h, d) views, causal, softcap 50;
* ``serve32_8192_window4096_sinks4``, ``serve32_8192_window1024`` and
  ``serve32_8192_causal``: the same geometry over 8192 rows, causal,
  under Mistral's and Gemma 2's window of 4096 with StreamingLLM's 4
  sinks, a window of 1024, and none (a checkout whose backward refuses
  a window prints ``refused`` for those cases).

Each line: ``kernel_device_ms`` (the fused kernel's own launches, by
name, under `torch.profiler`, mean over 20 calls of `flash_backward`),
``device_ms`` (every kernel of a `flash_backward` call: the staging, the
dQ zero fill, the kernel, the sums and casts), ``ms`` (CUDA events over
back-to-back calls, median of 7 windows of 5 calls after two warm-up
calls), ``host_us`` (host time per call, 50 calls enqueued back to back),
``bound_ms`` (10·d operations per visible pair per q head at the bf16
peak, or the inputs and outputs once at 3.35 TB/s, the larger; under a
window the band's pairs, sinks included),
``by_kernel`` (a call's device ms by kernel name, the six largest),
``fused_kv_digest`` (a hash of the fused dK and dV bits, which are the
same every call: equal digests from two checkouts mean equal bits), the
plans where the checkout names them, and SDPA's backward
(``library_ms``, ``library_device_ms``: `torch.autograd.grad` through
`scaled_dot_product_attention`) where SDPA computes the same function
(it has no softcap; under a window with the band as a boolean mask).
Then the pair, `flash_backward` under
``_FORCE_TWO_KERNEL``: ``pair_dq_device_ms`` and ``pair_dkv_device_ms``
(each kernel's launches by name), ``pair_device_ms`` (every kernel of the
call), ``pair_by_kernel``, ``pair_dq_bound_ms`` and ``pair_dkv_bound_ms``
(6·d and 8·d operations per visible pair per q head, or their bytes), and
``pair_digest`` (all three gradients' bits).  All inputs bf16 from a
seeded generator.  It needs a card and fails without one.
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

PEAK_OPS_S = 989e12  # bf16 dense, H100 SXM data sheet
PEAK_BYTES_S = 3.35e12


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


# kernel names (substrings) of the key-major body (the fused kernel, and
# the dK/dV kernel on the pair's path) and of the dQ kernel: the wgmma
# bodies', and the mma.sync bodies' of earlier checkouts
KEY_MAJOR_NAMES = ("flash_bwd_wgmma", "kv_major")
DQ_NAMES = ("flash_bwd_dq_wgmma", "q_major")


def device_ms(fn, calls: int = 20, also=None):
    """(every kernel's device ms, the key-major body's device ms, the six
    largest kernels' device ms by name) per call, by `torch.profiler`;
    with ``also`` (names) a fourth: those kernels' device ms."""
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
    total = kernel = other = 0.0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        total += us
        if also is not None and any(n in e.name for n in also):
            other += us
        elif any(n in e.name for n in KEY_MAJOR_NAMES):
            kernel += us
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = (total / calls / 1e3, kernel / calls / 1e3,
           {name: us / calls / 1e3 for name, us in top})
    return out if also is None else (*out, other / calls / 1e3)


def digest(tensors) -> str:
    """A hash of the (bf16) tensors' bits."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def host_us(fn, calls: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def kept_pairs(s, window=None, sinks=None) -> int:
    """The (row, key) pairs one head keeps in a causal s x s call under
    ``window`` and ``sinks``: row r keeps min(r + 1, window) band keys and
    the sinks before its band."""
    if window is None:
        return s * (s + 1) // 2
    return sum(min(r + 1, window) + min(sinks or 0, max(r + 1 - window, 0))
               for r in range(s))


def bound_ms(b, h, hkv, s, d, factor=10, outs="qkv", window=None,
             sinks=None) -> float:
    """Causal m = n = s: ``factor``·d operations per visible pair (of
    `kept_pairs`) per q head, or Qs, dO, K, V, lse and delta read and the
    gradients ``outs`` ("q", "kv" or both) written once, bf16."""
    pairs = b * h * kept_pairs(s, window, sinks)
    nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d) + 8 * b * h * s
    nbytes += 2 * (b * h * s * d * ("q" in outs)
                   + 2 * b * hkv * s * d * ("kv" in outs))
    return max(factor * d * pairs / PEAK_OPS_S, nbytes / PEAK_BYTES_S) * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("measure_bwd: torch sees no CUDA card", file=sys.stderr)
        return 1
    from attention_tpu_torch.ops import flash_bwd
    from attention_tpu_torch.ops.flash_vjp import _flash_fwd_impl

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    emit(label=args.label, root=os.path.abspath(args.root),
         module=flash_bwd.__file__, card=smi.stdout.strip().splitlines()[0])
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    serve = tuple(randn(1, n, 4096, 128) for n in (32, 4, 4, 32))
    layer = tuple(randn(4, 2048, n, 128).transpose(1, 2)
                  for n in (32, 4, 4, 32))
    long = tuple(randn(1, n, 8192, 128) for n in (32, 4, 4, 32))
    cases = {"serve32_causal": (serve, None, {}),
             "serve32_causal_softcap50": (serve, 50.0, {}),
             "train_layer": (layer, 50.0, {}),
             "serve32_8192_window4096_sinks4": (
                 long, None, dict(window=4096, sinks=4)),
             "serve32_8192_window1024": (long, None, dict(window=1024)),
             "serve32_8192_causal": (long, None, {})}
    plan_of = getattr(flash_bwd, "bwd_launch_plan", None)
    for name, ((q, k, v, dout), cap, band) in cases.items():
        b, h, s, d = q.shape
        kw = dict(scale=d ** -0.5, causal=True, softcap=cap, **band)
        try:
            out, lse = _flash_fwd_impl(q, k, v, **kw)
            flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)
        except NotImplementedError as err:
            emit(label=args.label, case=name, refused=str(err))
            continue

        def run(q=q, k=k, v=v, out=out, lse=lse, dout=dout, kw=kw):
            return flash_bwd.flash_backward(q, k, v, out, lse, dout, **kw)

        total, kernel, by_kernel = device_ms(run)
        rec = dict(label=args.label, case=name, kernel_device_ms=kernel,
                   device_ms=total, ms=time_ms(run), host_us=host_us(run),
                   bound_ms=bound_ms(b, h, k.shape[1], s, d, **band),
                   by_kernel=by_kernel, fused_kv_digest=digest(run()[1:]))
        if plan_of is not None:
            rec["plan"] = plan_of(q, k, v, out, lse, dout, causal=True,
                                  **({"window": band["window"]} if band
                                     else {}))
        flash_bwd._FORCE_TWO_KERNEL = True
        total, dkv, by_kernel, dq = device_ms(run, also=DQ_NAMES)
        rec.update(pair_dq_device_ms=dq, pair_dkv_device_ms=dkv,
                   pair_device_ms=total, pair_by_kernel=by_kernel,
                   pair_dq_bound_ms=bound_ms(b, h, k.shape[1], s, d, 6, "q",
                                             **band),
                   pair_dkv_bound_ms=bound_ms(b, h, k.shape[1], s, d, 8,
                                              "kv", **band),
                   pair_digest=digest(run()))
        flash_bwd._FORCE_TWO_KERNEL = False
        if cap is None:
            mask, kv = None, (k, v)
            if band:
                # a boolean mask takes the heads repeated, not enable_gqa
                row = torch.arange(s, device="cuda")[:, None]
                col = torch.arange(s, device="cuda")[None, :]
                mask = (col <= row) & ((col > row - band["window"])
                                       | (col < (band.get("sinks") or 0)))
                kv = (t.repeat_interleave(h // k.shape[1], dim=1)
                      for t in (k, v))
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, *kv))
            o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                               is_causal=mask is None,
                                               enable_gqa=mask is None)

            def sdpa(o=o, qkv=(qq, kk, vv), dout=dout):
                return torch.autograd.grad(o, qkv, dout, retain_graph=True)

            rec.update(library_ms=time_ms(sdpa),
                       library_device_ms=device_ms(sdpa)[0])
        emit(**rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
