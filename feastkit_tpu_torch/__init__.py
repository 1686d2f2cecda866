"""feastkit_tpu_torch — the FEAST eigensolver on PyTorch and CUDA (Hopper).

A port of ``feastkit_tpu`` (JAX on a TPU), slice by slice. It holds the
sparse interval driver of ``feast(A, B, (Emin, Emax), M0, fpm)`` for
real symmetric and complex Hermitian pencils (the polynomial filter, whose
Chebyshev recurrence runs in fused CUDA kernels written for Hopper, or
unfused on the DIA and CSR products, and the Krylov contour engine), the
direct-solver contour engines: the dense symmetric / Hermitian drivers
(batched LU of the shifted pencils) and the banded ones (block cyclic
reduction), and the general-contour family of ``feast_general(A, B, Emid,
r, M0, fpm)`` and ``feast_polynomial``: dense, banded and sparse general
and complex-symmetric pencils (the sparse ones on the Krylov contour
engine and the complex DIA kernels) and polynomial eigenproblems, the
matrix-free drivers of ``feast_matvec`` / ``feast_matvec_general`` on
the caller's operators (``LinearOperator``), and the reverse-communication
step machines (``FeastSRCI``, ``FeastHRCI``, ``FeastGRCI``, ``FeastPRCI``,
``FeastPolyRCI``), where the caller owns the linear algebra. Entry
points take ``device=None``, which means CUDA; ``device="cpu"`` runs the
plain PyTorch versions of the kernels on the host.

The package imports torch, numpy and scipy only; it never imports jax or
the JAX package.
"""
from .core.parameters import (FeastConfig, FeastParameters, feastdefault,
                              feastinit)
from .core.aux import (check_complex_symmetric, feast_cauchy_weights,
                       feast_clear_custom_contour, feast_get_custom_contour,
                       feast_inside_contourx, feast_set_custom_contour,
                       with_custom_contour)
from .core.contour import (feast_contour, feast_contour_custom_weights,
                           feast_contour_expert, feast_customcontour,
                           feast_gcontour, feast_grational, feast_grationalx,
                           feast_inside_contour, feast_inside_gcontour,
                           feast_rational, feast_rationalx)
from .core.types import (Contour, FeastError, FeastGeneralResult,
                         FeastRCIJob, FeastResult)
from .interfaces.feast import (feast, feast_banded, feast_custom_contour,
                               feast_general, feast_polynomial,
                               feast_summary, feast_validate_interval)
from .solvers.banded import (feast_gbev, feast_gbgv, feast_hbev, feast_hbgv,
                             feast_sbev, feast_sbev_complex, feast_sbgv,
                             feast_sbgv_complex)
from .solvers.dense import feast_heev, feast_hegv, feast_syev, feast_sygv
from .solvers.dense_general import (feast_geev, feast_geev_complex_sym,
                                    feast_gegv, feast_gegv_complex_sym,
                                    feast_pep, feast_pep_direct)
from .solvers.sparse import (feast_gcsrev, feast_gcsrgv, feast_hcsrev,
                             feast_hcsrgv, feast_scsrev, feast_scsrev_complex,
                             feast_scsrgv, feast_scsrgv_complex,
                             feast_scsrpev, sparse_feast_general,
                             sparse_feast_interval)
from .solvers.sparse import feast_gcsrpev, feast_hcsrpev
from .solvers.matfree import (LinearOperator, MatrixVecFunction,
                              create_iterative_solver, feast_matvec,
                              feast_matvec_general)
from .kernel.rci import (FeastGRCI, FeastHRCI, FeastPolyRCI, FeastPRCI,
                         FeastSRCI)

__all__ = ["feast", "feast_banded", "feast_summary",
           "feast_validate_interval", "feastinit", "feastdefault",
           "FeastParameters", "FeastConfig", "FeastResult", "FeastError",
           "Contour", "feast_scsrev", "feast_scsrgv", "feast_hcsrev",
           "feast_hcsrgv",
           "sparse_feast_interval", "feast_syev", "feast_sygv",
           "feast_heev", "feast_hegv", "feast_sbev", "feast_sbgv",
           "feast_hbev", "feast_hbgv", "feast_general", "feast_polynomial",
           "feast_custom_contour", "FeastGeneralResult", "feast_geev",
           "feast_gegv", "feast_geev_complex_sym", "feast_gegv_complex_sym",
           "feast_pep", "feast_pep_direct", "feast_gbev", "feast_gbgv",
           "feast_sbev_complex", "feast_sbgv_complex", "feast_gcsrev",
           "feast_gcsrgv", "feast_scsrev_complex", "feast_scsrgv_complex",
           "feast_scsrpev", "feast_hcsrpev", "feast_gcsrpev",
           "sparse_feast_general", "feast_contour", "feast_gcontour",
           "feast_customcontour", "feast_contour_expert",
           "feast_contour_custom_weights", "feast_rational",
           "feast_rationalx", "feast_grational", "feast_grationalx",
           "feast_inside_contour", "feast_inside_gcontour",
           "feast_set_custom_contour", "feast_get_custom_contour",
           "feast_clear_custom_contour", "with_custom_contour",
           "feast_inside_contourx", "feast_cauchy_weights",
           "check_complex_symmetric", "LinearOperator", "MatrixVecFunction",
           "create_iterative_solver", "feast_matvec", "feast_matvec_general",
           "FeastSRCI", "FeastHRCI", "FeastGRCI", "FeastPRCI", "FeastPolyRCI",
           "FeastRCIJob"]
