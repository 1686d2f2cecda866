"""Device and backend selection for the port's entry points.

Every public solver takes ``device=None``, which means the CUDA card. The
CPU runs only when the caller names it (``device="cpu"``, as the tests do):
there is no silent fallback from the card to the host.

Backend selection is the JAX package's (``feastkit_tpu/core/backend.py``):
serial or sharded, with legacy names folded into sharded, and the same
strict-versus-fallback messages. The sharded drivers
(``parallel/pfeast.py``) run one rank per process of a
``torch.distributed`` process group, so the devices that the selection
counts are the ranks of the initialized default group (1 without one,
whatever cards the host has). The reports (``feast_parallel_capabilities``,
``feast_parallel_info``) give the cards (the CUDA cards, or one CPU where
there is none) and the ranks, with "sharded" available on two or more
ranks.
"""
from __future__ import annotations

import warnings

import torch

__all__ = ["resolve_device", "select_parallel_backend",
           "determine_parallel_backend", "feast_parallel_capabilities",
           "feast_parallel_info"]

_BACKENDS = ("auto", "serial", "sharded")
_LEGACY = {"threads": "sharded", "distributed": "sharded", "mpi": "sharded"}


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


def _n_devices(device=None) -> int:
    """The devices a sharded solve spans: the ranks of the initialized
    default process group, 1 without one (``device``, the solve's, does
    not change the count: each rank runs on its own device)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _n_cards(device: torch.device) -> int:
    """Cards of the device's type: the CUDA cards, or one CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _default_device() -> torch.device:
    """The devices the reports count: CUDA where there is a card, else the
    CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def determine_parallel_backend(backend="auto") -> str:
    """"auto" / "serial" / "sharded" (legacy "threads" / "distributed" /
    "mpi" accepted) after the availability fallback
    (determine_parallel_backend, feast_backend_utils.jl:17-50): sharded
    needs two or more ranks."""
    b = str(backend).lstrip(":")
    b = _LEGACY.get(b, b)
    if b not in _BACKENDS:
        raise ValueError(f"Unknown backend {backend!r}; valid: "
                         f"{_BACKENDS + tuple(_LEGACY)}")
    if b == "auto":
        return "sharded" if _n_devices() > 1 else "serial"
    if b == "sharded" and _n_devices() < 2:
        return "serial"
    return b


def feast_parallel_capabilities() -> dict:
    """Capability report (feast_parallel_capabilities,
    feast_backend_utils.jl:212-278): the cards (the CUDA cards, or one
    CPU) and the ranks of the default process group; "sharded" is
    available on two or more ranks."""
    dev = _default_device()
    n = _n_cards(dev)
    kinds = ({torch.cuda.get_device_name(i) for i in range(n)}
             if dev.type == "cuda" else {"cpu"})
    ranks = _n_devices()
    return {
        "n_devices": n,
        "n_ranks": ranks,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "backends": {"serial": True, "sharded": ranks > 1},
        "device_kinds": sorted(kinds),
    }


def feast_parallel_info(file=None):
    import sys
    file = file or sys.stdout
    caps = feast_parallel_capabilities()
    print("FEAST parallel capabilities:", file=file)
    print(f"  platform      : {caps['platform']}", file=file)
    print(f"  devices       : {caps['n_devices']} "
          f"({', '.join(caps['device_kinds'])})", file=file)
    print(f"  ranks         : {caps['n_ranks']}", file=file)
    for k, v in caps["backends"].items():
        print(f"  backend {k:<8}: {'available' if v else 'unavailable'}",
              file=file)
    return caps


def select_parallel_backend(backend, device=None, *, allow_fallback=True,
                            auto_sharded=True) -> str:
    """"serial" or "sharded" for ``backend``, over the ranks of the default
    process group (``_n_devices``; ``device`` is the solve's). "auto"
    picks sharded on two or more ranks where ``auto_sharded`` (the JAX
    package's sparse operands; dense ones shard only on request). A sharded
    request on one rank warns and runs serially, or raises when
    ``allow_fallback`` is False (the JAX package's strict selection)."""
    b = str(backend).lstrip(":")
    b = _LEGACY.get(b, b)
    if b not in _BACKENDS:
        raise ValueError(f"Unknown backend {backend!r}")
    n = _n_devices(device)
    if b == "auto":
        return "sharded" if (auto_sharded and n > 1) else "serial"
    if b == "sharded" and n < 2:
        if not allow_fallback:
            raise RuntimeError(
                f"backend='sharded' requires >= 2 devices but only {n} "
                "visible. Run every rank of a torch.distributed process "
                "group (init_process_group) through the same call.")
        warnings.warn("backend='sharded' unavailable (single device); "
                      "falling back to serial", stacklevel=4)
        return "serial"
    return b
