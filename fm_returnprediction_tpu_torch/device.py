"""Device and compute-dtype resolution shared by every entry point of the
port.

``device=None`` means the GPU. There is no silent CPU fallback: asking for
the GPU on a machine without one raises, and the CPU runs only when the
caller names it (the tests do).
"""

from __future__ import annotations

import numpy as np
import torch

from fm_returnprediction_tpu_torch.settings import config

__all__ = ["resolve_device", "resolve_dtype", "synchronize"]


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


_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_dtype(dtype=None) -> torch.dtype:
    """The compute dtype: ``dtype`` (a torch or numpy dtype, or a name)
    when given, else the ``DTYPE`` setting (``settings``; default
    ``float32``)."""
    if dtype is None:
        dtype = config("DTYPE")
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported compute dtype {name!r}; "
                         f"expected one of {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[name]
