"""Build and load the port's CUDA kernels (nvcc + ctypes).

``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is then
loaded with ``ctypes``. Libraries go to ``csrc/build/`` inside the package
(listed in ``.gitignore``) under a name that carries a hash of the source,
the headers beside it (``csrc/*.h``) and the flags, so an edited source or
header is rebuilt and never loaded stale.
``defines`` (``-D`` flags) build a variant of a source beside the default
library (``chip_smoke.py`` times ``cheb_stream4.cu`` built with
``-DCHEB_RUNTIME_COUNT_ONLY`` against the default build).
Nothing here runs at import time: this module imports on machines without
a CUDA toolkit, and only a call to :func:`build` or :func:`load` needs
``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SHARED_BYTES_PER_BLOCK",
           "SM_SHARED_BYTES", "SMS", "sm_count", "library_path", "build",
           "load"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = SRC_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_NVCC_TIMEOUT_S = 600
# the card the kernels are built for (sm_90a): the dynamic shared memory
# one thread block may use (227 KB) and a multiprocessor's (it keeps 1 KB
# per resident block for itself); the multiprocessors of an H100 SXM, the
# plans' default where no card is asked
SHARED_BYTES_PER_BLOCK = 232448
SM_SHARED_BYTES = 233472
SMS = 132


@functools.cache
def sm_count(device) -> int:
    """The multiprocessors of a CUDA device (an index or a device)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str, defines: tuple = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = SRC_DIR / f"{name}.cu"
    flags = (*NVCC_FLAGS, *defines)
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.h")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with the ``-D`` flags ``defines``)
    unless its library exists; return the library's path. Raises if
    ``nvcc`` fails or times out."""
    defines = tuple(defines)
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
             str(SRC_DIR / f"{name}.cu")],
            capture_output=True, text=True, timeout=_NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)           # atomic: concurrent builders agree
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def load(name: str, *defines: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with the ``-D``
    flags ``defines``), built first if needed."""
    return ctypes.CDLL(str(build(name, defines)))
