"""Device selection for the port's entry points.

Entry points (`api.attention`, `cli`, `ServingEngine`, `TinyDecoder`)
run on the card by default.  The CPU is taken only when the caller asks
for it (``device="cpu"``), and then every kernel wrapper runs its plain
PyTorch version.  Asking for the card on a machine without one raises;
nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """``device="cuda"`` was asked for and no CUDA device is present."""


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The `torch.device` for ``device``; raises `NoCudaDeviceError`
    when it names CUDA and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            f"device {str(dev)!r} was asked for but torch sees no CUDA "
            "device; pass device='cpu' to run the plain versions on the "
            "CPU"
        )
    return dev
