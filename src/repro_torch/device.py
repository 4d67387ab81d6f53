"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Asking
for the card on a machine without one raises; nothing carries on on the
CPU unless the caller says ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_on_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it is a CUDA
    device and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain versions on the "
            f"CPU"
        )
    return dev


def check_on_device(where: str, device: torch.device, *tensors) -> None:
    """Raise unless every non-None tensor lies on ``device``."""
    for t in tensors:
        if t is None:
            continue
        if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index
        ):
            raise ValueError(
                f"{where}: tensor on {t.device} but device={str(device)!r}"
            )
