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
``FeastPolyRCI``), where the caller owns the linear algebra.

The public surface is the JAX package's: the FEAST-named aliases
(``{s,d,c,z}[i]feast_*[x]``, ``interfaces/aliases.py``), the FeastKit.jl
compatibility names (``interfaces/compat.py``), the ``Feast_*``
constants (``deprecations.py``), ``eigvals_feast`` / ``eigen_feast`` /
``feast_set_defaults``, checkpoint / resume (``utils/checkpoint.py``),
the profiling helpers (``utils/profiling.py``), the stochastic
eigenvalue count fpm[14] = 2 on every driver, and the validation, info,
memory and backend reports of ``core/aux.py`` and ``core/backend.py``.
The sharded drivers (``parallel/pfeast.py``: ``pfeast_dense`` /
``pfeast_sparse`` / ``pfeast_general`` / ``pfeast_sparse_general`` and the
meshes ``contour_mesh`` / ``contour_rhs_mesh`` / ``contour_model_mesh``)
run on the ranks of a ``torch.distributed`` process group, every rank
calling the same driver; ``feast(..., backend="sharded")``, the parallel
aliases ``p{s,d,c,z}[i]feast_*``, ``pfeast_sygv`` / ``pfeast_scsrgv``, the
``mpi_feast*`` family, ``MPIFeastState`` and ``feast_hybrid`` reach them.

Entry points take ``device=None``, which means CUDA; ``device="cpu"``
runs the plain PyTorch versions of the kernels on the host. The package
imports torch, numpy and scipy only; it never imports jax or the JAX
package.
"""
from .core.types import (Contour, FeastError, FeastGeneralResult,
                         FeastRCIJob, FeastResult)
from .core.parameters import (FEAST_UNINITIALIZED, FeastConfig,
                              FeastParameters, feast_tolerance, feastdefault,
                              feastinit, feastinit_driver)
from .core.contour import (feast_contour, feast_contour_custom_weights,
                           feast_contour_expert, feast_customcontour,
                           feast_gcontour, feast_grational, feast_grationalx,
                           feast_inside_contour, feast_inside_gcontour,
                           feast_rational, feast_rationalx,
                           zolotarev_quadrature)
from .core.tools import feast_name, seeded_subspace
from .solvers.dense import feast_heev, feast_hegv, feast_syev, feast_sygv
from .solvers.banded import (feast_gbev, feast_gbgv, feast_hbev, feast_hbgv,
                             feast_sbev, feast_sbev_complex, feast_sbgv,
                             feast_sbgv_complex)
from .ops.banded import banded_to_full, full_to_banded
from .solvers.sparse import (feast_gcsrev, feast_gcsrgv, feast_hcsrev,
                             feast_hcsrgv, feast_scsrev, feast_scsrev_complex,
                             feast_scsrgv, feast_scsrgv_complex,
                             sparse_feast_general, sparse_feast_interval)
from .solvers.sparse import feast_gcsrpev, feast_hcsrpev, feast_scsrpev
from .utils.checkpoint import (FeastCheckpoint, load_checkpoint,
                               resume_kwargs, save_checkpoint)
from .utils.profiling import (FeastTimer, feast_benchmark,
                              feast_parallel_comparison, phase_timer,
                              trace_to)
from .solvers.matfree import (LinearOperator, MatrixVecFunction,
                              create_iterative_solver, feast_matvec,
                              feast_matvec_general)
from .solvers.dense_general import (feast_geev, feast_geev_complex_sym,
                                    feast_gegv, feast_gegv_complex_sym,
                                    feast_pep, feast_pep_direct)
from .core.aux import (check_complex_symmetric, feast_cauchy_weights,
                       feast_clear_all_contours, feast_clear_custom_contour,
                       feast_estimate_count, feast_get_custom_contour,
                       feast_info, feast_inside_contourx,
                       feast_memory_estimate, feast_set_custom_contour,
                       feast_trace_eigenvalues, validate_contour,
                       with_custom_contour)
from .core.backend import (determine_parallel_backend,
                           feast_parallel_capabilities, feast_parallel_info,
                           select_parallel_backend)
from .interfaces.feast import (eigen_feast, eigvals_feast, feast,
                               feast_banded, feast_custom_contour,
                               feast_general, feast_polynomial,
                               feast_set_defaults, feast_summary,
                               feast_validate_interval)
from .parallel.pfeast import (contour_mesh, contour_model_mesh,
                              contour_rhs_mesh, pfeast_dense, pfeast_general,
                              pfeast_sparse, pfeast_sparse_general)
from .interfaces.aliases import *  # noqa: F401,F403 - s/d/c/z FEAST names
from .kernel.rci import (FeastGRCI, FeastHRCI, FeastPolyRCI, FeastPRCI,
                         FeastSRCI)
from .interfaces.compat import *  # noqa: F401,F403 - FeastKit.jl names
from .deprecations import (Feast_ERROR_EMID_R, Feast_ERROR_EMIN_EMAX,
                           Feast_ERROR_INTERNAL, Feast_ERROR_M0,
                           Feast_ERROR_MEMORY, Feast_ERROR_N,
                           Feast_ERROR_NO_CONVERGENCE,
                           Feast_ERROR_PROBLEM_SIZE, Feast_RCI_DONE,
                           Feast_RCI_FACTORIZE, Feast_RCI_FACTORIZE_TRANSPOSE,
                           Feast_RCI_INIT, Feast_RCI_MULT_A, Feast_RCI_MULT_B,
                           Feast_RCI_SOLVE, Feast_RCI_SOLVE_TRANSPOSE,
                           Feast_SUCCESS)

__all__ = sorted(name for name, value in globals().items()
                 if not name.startswith("_")
                 and type(value).__name__ != "module")
