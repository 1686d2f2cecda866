"""feastkit_tpu_torch — the FEAST eigensolver on PyTorch and CUDA (Hopper).

A port of ``feastkit_tpu`` (JAX on a TPU), slice by slice. This slice is
the main path: ``feast(A, B, (Emin, Emax), M0, fpm)`` on a sparse symmetric
stencil operator with B None or a positive diagonal, through the
polynomial-filter FEAST driver whose Chebyshev recurrence runs in fused
CUDA kernels written for Hopper (``ops/csrc/cheb_step.cu``). Entry points
take ``device=None``, which means CUDA; ``device="cpu"`` runs the plain
PyTorch versions of the kernels on the host.

The package imports torch, numpy and scipy only; it never imports jax or
the JAX package.
"""
from .core.parameters import (FeastConfig, FeastParameters, feastdefault,
                              feastinit)
from .core.types import Contour, FeastError, FeastResult
from .interfaces.feast import feast, feast_summary
from .solvers.sparse import feast_scsrev, feast_scsrgv, sparse_feast_interval

__all__ = ["feast", "feast_summary", "feastinit", "feastdefault",
           "FeastParameters", "FeastConfig", "FeastResult", "FeastError",
           "Contour", "feast_scsrev", "feast_scsrgv",
           "sparse_feast_interval"]
