"""Device selection for the port's entry points.

Every public solver takes ``device=None``, which means the CUDA card. The
CPU runs only when the caller names it (``device="cpu"``, as the tests do):
there is no silent fallback from the card to the host.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when the requested device is CUDA and no
    CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "feastkit_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
