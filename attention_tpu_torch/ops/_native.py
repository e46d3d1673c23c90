"""Build and load the port's CUDA kernels, and count their launches.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface.
``nvcc`` compiles it for ``sm_90a`` into a shared library under
``attention_tpu_torch/_build/`` at first use (nothing is compiled at
import), and ``ctypes`` loads it.  The library's file name carries a
hash of every source in ``csrc/``, so an edited source is rebuilt and a
stale library is never loaded.  `build` starts one ``nvcc`` per kernel,
all at once, and waits for them together.

The launch counters are the port's only global state: each kernel
wrapper adds one where it launches its kernel and nowhere else, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: kernel name -> source file in csrc/
KERNELS = {
    "flash_fwd": "flash_fwd.cu",
    "ragged_paged": "ragged_paged.cu",
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

_LAUNCHES = dict.fromkeys(KERNELS, 0)
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` failed (or is missing) for one of the port's kernels."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last `reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


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


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` each, all started together.  Returns per kernel
    ``{"seconds": wall time, "ptxas": the compiler's resource report}``
    (seconds 0.0 and an empty report when already built).  Raises
    `KernelBuildError` with the compiler output on a failure."""
    names = list(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, KERNELS[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    report = {name: {"seconds": 0.0, "ptxas": ""} for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
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
