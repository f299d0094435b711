"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    first CUDA device. With no GPU and no explicit device this raises:
    the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("fastpm_torch: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")
