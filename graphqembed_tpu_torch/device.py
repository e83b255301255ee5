"""Device policy of the port: entry points run on the card unless the caller
asks for the CPU, and never fall back to it quietly."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda". A CUDA device with no card present raises; the
    CPU is used only when the caller names it (the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def check_placed(dev: torch.device, what: str, t: torch.Tensor) -> None:
    """Raise unless tensor `t` lives on the run's device `dev`."""
    if t.device.type != dev.type or (dev.index is not None
                                     and t.device.index != dev.index):
        raise ValueError(f"{what} is on {t.device}; the run's device is {dev}")
