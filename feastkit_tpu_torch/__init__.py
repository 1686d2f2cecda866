"""feastkit_tpu_torch — the FEAST eigensolver on PyTorch and CUDA (Hopper).

A port of ``feastkit_tpu`` (JAX on a TPU), slice by slice. It holds the
sparse interval driver of ``feast(A, B, (Emin, Emax), M0, fpm)`` for
real symmetric and complex Hermitian pencils (the polynomial filter, whose
Chebyshev recurrence runs in fused CUDA kernels written for Hopper, or
unfused on the DIA and CSR products, and the Krylov contour engine), and
the direct-solver
contour engines: the dense symmetric / Hermitian drivers (batched LU of
the shifted pencils) and the banded ones (block cyclic reduction). Entry
points take ``device=None``, which means CUDA; ``device="cpu"`` runs the
plain PyTorch versions of the kernels on the host.

The package imports torch, numpy and scipy only; it never imports jax or
the JAX package.
"""
from .core.parameters import (FeastConfig, FeastParameters, feastdefault,
                              feastinit)
from .core.types import Contour, FeastError, FeastResult
from .interfaces.feast import (feast, feast_banded, feast_summary,
                               feast_validate_interval)
from .solvers.banded import feast_hbev, feast_hbgv, feast_sbev, feast_sbgv
from .solvers.dense import feast_heev, feast_hegv, feast_syev, feast_sygv
from .solvers.sparse import (feast_hcsrev, feast_hcsrgv, feast_scsrev,
                             feast_scsrgv, sparse_feast_interval)

__all__ = ["feast", "feast_banded", "feast_summary",
           "feast_validate_interval", "feastinit", "feastdefault",
           "FeastParameters", "FeastConfig", "FeastResult", "FeastError",
           "Contour", "feast_scsrev", "feast_scsrgv", "feast_hcsrev",
           "feast_hcsrgv",
           "sparse_feast_interval", "feast_syev", "feast_sygv",
           "feast_heev", "feast_hegv", "feast_sbev", "feast_sbgv",
           "feast_hbev", "feast_hbgv"]
