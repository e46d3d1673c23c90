"""Build and load the port's CUDA kernels, and count their launches.

Each kernel is a shared library with a plain C interface, built from
one ``csrc/<name>.cu`` file, or from it and further translation units (a
source compiled with its own ``-D`` flags: the max_mode variants'
instances, `VARIANT_UNITS`), each compiled to an object and linked
after.  ``nvcc`` compiles for ``sm_90a`` under
``attention_tpu_torch/_build/`` at first use (nothing is compiled at
import), and ``ctypes`` loads the library.  Its file name
carries a hash of every source in ``csrc/``, so an edited source is
rebuilt and a stale library is never loaded.  `build` runs one
``nvcc`` per translation unit, as many at once as there are CPU cores,
the longest units first, and waits for them together.

The launch counters are the port's only global state: each kernel
wrapper adds one where it launches its kernel and nowhere else, so a
run can show that its main path went through the kernels; a bound
launch also adds its guard's verdict to a count on its card
(`count_demotion`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: kernel name -> source file in csrc/ (the one with its C entry point)
KERNELS = {
    "flash_fwd": "flash_fwd.cu",
    "ragged_paged": "ragged_paged.cu",
    "decode": "decode.cu",
    "paged_decode": "paged_decode.cu",
    "quant_decode": "quant_decode.cu",
    "quant_tok4": "quant_tok4_decode.cu",
    "flash_bwd_fused": "flash_bwd_fused.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
}

#: kernel name -> its other translation units, (source, extra nvcc flags)
#: each, compiled apart from the entry's source and linked with it: each
#: max_mode variant's instances in a build of their own, and the int4
#: instances of the int8/int4 decode kernel
VARIANT_UNITS = {
    "quant_decode": [("quant_decode.cu", ("-DQUANT_INT4=1",))],
    "flash_fwd": [("flash_fwd_variant.cu", (f"-DFLASH_VARIANT={v}",))
                  for v in (1, 2, 3)],
    "ragged_paged": [("ragged_paged_variant.cu", (f"-DRAGGED_VARIANT={v}",))
                     for v in (2, 3)],
    "decode": [("decode_variant.cu", (f"-DDECODE_VARIANT={v}",))
               for v in (2, 3)],
}

#: ctypes argument types of the kernels' C entry points
P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
#: the C entry points' dtype codes (atk:: kernels take fp32 and bf16)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: largest head dim the kernels take (atk::MAX_HEAD_DIM)
MAX_HEAD_DIM = 256

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
#: a translation unit of a kernel of several: an object, linked after
NVCC_OBJECT_FLAGS = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]

_LAUNCHES = dict.fromkeys(KERNELS, 0)
_VARIANT_LAUNCHES: dict[tuple[str, str], int] = {}
_DEMOTIONS: dict[torch.device, torch.Tensor] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` failed (or is missing) for one of the port's kernels."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def count_launch(name: str, variant: str | None = None) -> None:
    """One launch of kernel ``name``; ``variant``, where given, the
    rescaling math it was launched with (`variant_counts`)."""
    _LAUNCHES[name] += 1
    if variant is not None:
        key = (name, variant)
        _VARIANT_LAUNCHES[key] = _VARIANT_LAUNCHES.get(key, 0) + 1


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last `reset_launch_counts`."""
    return dict(_LAUNCHES)


def variant_counts() -> dict[str, dict[str, int]]:
    """Launches of each kernel by the ``max_mode`` variant it ran, since
    the last `reset_launch_counts` (kernels that take one)."""
    out: dict[str, dict[str, int]] = {}
    for (name, variant), n in _VARIANT_LAUNCHES.items():
        out.setdefault(name, {})[variant] = n
    return out


def count_demotion(verdict: torch.Tensor) -> None:
    """Add a bound launch's guard verdict (a 0-d int32 on its card, 1
    where the launch ran the online body) to that card's count, on the
    card: no sync."""
    total = _DEMOTIONS.get(verdict.device)
    if total is None:
        _DEMOTIONS[verdict.device] = verdict.clone()
    else:
        total += verdict


def demotion_count() -> int:
    """Bound launches whose guard sent them to the online body since the
    last `reset_launch_counts` (reads the cards' counts: a sync)."""
    return sum(int(t) for t in _DEMOTIONS.values())


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    _VARIANT_LAUNCHES.clear()
    _DEMOTIONS.clear()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card ``index``: the launches that
    split keys across CTAs size the split by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nvcc() -> str:
    """``nvcc`` from PATH, else from the toolkit under ``CUDA_HOME``
    (default ``/usr/local/cuda``, the toolkit's own install prefix)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelBuildError(f"nvcc not found on PATH or in {home}/bin")
    return path


def _sources_digest() -> str:
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC)):
        if fname.endswith((".cu", ".cuh")):
            h.update(fname.encode())
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:12]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_sources_digest()}.so")


def units(name: str) -> list[tuple[str, tuple[str, ...]]]:
    """The translation units of kernel ``name``: (source, flags) pairs,
    the entry's source first."""
    return [(KERNELS[name], ()), *VARIANT_UNITS.get(name, ())]


def _run(cmds: dict) -> dict:
    """Run each ``{key: argv}``, in order, as many at once as there are
    CPU cores (an ``nvcc`` runs its compilers one after another, on one
    core); {key: (exit code, output, CPU seconds of the process and of
    the compilers it waited for, seconds until it ended)}."""
    procs, logs, pids = {}, {}, {}
    todo = list(cmds)
    slots = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 8)
    out, t0 = {}, time.perf_counter()
    while todo or pids:
        while todo and len(pids) < slots:
            key = todo.pop(0)
            logs[key] = tempfile.TemporaryFile(mode="w+")
            procs[key] = subprocess.Popen(cmds[key], stdout=logs[key],
                                          stderr=subprocess.STDOUT)
            pids[procs[key].pid] = key
        for pid in list(pids):
            got, status, usage = os.wait4(pid, os.WNOHANG)
            if got == 0:
                continue
            key = pids.pop(pid)
            procs[key].returncode = os.waitstatus_to_exitcode(status)
            logs[key].seek(0)
            out[key] = (procs[key].returncode, logs[key].read(),
                        usage.ru_utime + usage.ru_stime,
                        time.perf_counter() - t0)
            logs[key].close()
        time.sleep(0.05)
    return out


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per translation unit (`_run`), then link the kernels of
    several units.  Returns per kernel ``{"seconds": wall
    time until its library was written, "ptxas": the compiler's resource
    report, "cpu_seconds": the compilers' CPU time, "units": each
    translation unit's CPU seconds and seconds until it was compiled}``
    (seconds 0.0 and an empty report when already built).
    Raises `KernelBuildError` with the compiler output on a failure."""
    names = list(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    todo = [n for n in names if not os.path.exists(library_path(n))]
    tag = f"{os.getpid()}.tmp"
    cmds, outs = {}, {}
    for name in todo:
        out = library_path(name)
        parts = units(name)
        for i, (src, flags) in enumerate(parts):
            single = len(parts) == 1
            dst = f"{out}.{tag}" if single else f"{out}.{i}.{tag}.o"
            cmds[(name, i)] = [_nvcc(),
                               *(NVCC_FLAGS if single else NVCC_OBJECT_FLAGS),
                               *flags, "-o", dst, os.path.join(CSRC, src)]
            outs[(name, i)] = dst
    # the kernels of several units, whose units are the longest, first
    done = _run({key: cmds[key] for key in sorted(
        cmds, key=lambda key: (-len(units(key[0])), todo.index(key[0]),
                               key[1]))})
    report = {name: {"seconds": 0.0, "ptxas": "", "cpu_seconds": 0.0}
              for name in names}
    failures, links = [], {}
    for name in todo:
        keys = sorted(key for key in done if key[0] == name)
        report[name] = {
            "seconds": max(done[key][3] for key in keys),
            "ptxas": "".join(done[key][1] for key in keys),
            "cpu_seconds": sum(done[key][2] for key in keys),
            "units": {f"{units(name)[key[1]][0]}"
                      f"{''.join(units(name)[key[1]][1])}":
                      dict(cpu_seconds=done[key][2], seconds=done[key][3])
                      for key in keys}}
        bad = [key for key in keys if done[key][0] != 0]
        if bad:
            failures.append(f"{name} (exit {done[bad[0]][0]}):\n"
                            f"{report[name]['ptxas']}")
        elif len(keys) > 1:
            links[name] = [_nvcc(), "-shared", "-o",
                           f"{library_path(name)}.{tag}",
                           *(outs[key] for key in keys)]
        else:
            os.replace(outs[keys[0]], library_path(name))
    for name, (code, log, cpu, _) in _run(links).items():
        report[name]["seconds"] = time.perf_counter() - t0
        report[name]["ptxas"] += log
        report[name]["cpu_seconds"] += cpu
        if code != 0:
            failures.append(f"{name} link (exit {code}):\n{log}")
            continue
        os.replace(f"{library_path(name)}.{tag}", library_path(name))
    for dst in outs.values():
        if dst.endswith(".o") and os.path.exists(dst):
            os.remove(dst)
    if failures:
        raise KernelBuildError("nvcc failed for " + "\n".join(failures))
    return report


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of kernel ``name``, building and
    loading its library on first use, with ``argtypes`` declared and an
    ``int`` return (the launch's ``cudaGetLastError``)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise `KernelLaunchError` for a non-zero CUDA error code."""
    if err != 0:
        raise KernelLaunchError(
            f"{name} launch failed with CUDA error {err}")
