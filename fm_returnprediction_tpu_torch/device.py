"""Device resolution shared by every entry point of the port.

``device=None`` means the GPU. There is no silent CPU fallback: asking for
the GPU on a machine without one raises, and the CPU runs only when the
caller names it (the tests do).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises when a CUDA device is asked for and none
    is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
