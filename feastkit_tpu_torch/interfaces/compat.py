"""Reference-surface compatibility layer of the PyTorch port.

Counterpart of ``feastkit_tpu/interfaces/compat.py``: the FeastKit.jl
export names that the core modules and the alias table do not define,
mapped onto the port (src/FeastKit.jl export list; the RCI and type
surface feast_types.jl, feast_kernel.jl:296-395; the workspace and
matrix-free surface feast_matfree.jl:157-417; the backend helpers
feast_backend_utils.jl; the parallel RCI helpers
feast_parallel_rci.jl:269-383). The reference's mutating ``foo!(...)``
convention drops the bang and returns results instead of writing into
argument arrays.

The sharded names run ``parallel/pfeast.py`` on the ranks of a
``torch.distributed`` process group (every rank calling): ``pfeast_sygv``
/ ``pfeast_scsrgv``, and the MPI surface (feast_mpi.jl,
feast_mpi_interface.jl), where a communicator becomes a mesh
(``_mesh_from_comm``: None, a rank count, or a ``DeviceMesh``):
``MPIFeastState``, ``mpi_feast``, ``mpi_feast_general``, ``feast_hybrid``
(contour x rhs over the world) and the ``mpi_feast_{he,ge}{ev,gv}`` /
``mpi_feast_{h,g}csr{ev,gv}`` drivers. The parallel RCI machine and its
helpers need no mesh (``pfeast_srci``, ``distribute_contour_points``,
``pfeast_compute_all_contour_points``, ``pfeast_show_distribution``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.backend import _default_device, _n_devices, resolve_device
from ..core.types import Contour
from ..kernel.rci import (FeastGRCI, FeastHRCI, FeastPolyRCI, FeastPRCI,
                          FeastSRCI)
from ..solvers.matfree import LinearOperator, _real_of, _torch_dtype

__all__ = [
    # RCI naming parity
    "FeastSRCIState", "FeastHRCIState", "FeastGRCIState",
    "FeastPolyRCIState", "ParallelFeastState",
    "feast_srci", "feast_hrci", "feast_grci",
    "feast_srcix", "feast_hrcix", "feast_grcix",
    "ifeast_srci", "ifeast_hrci", "ifeast_grci",
    # workspaces / matfree
    "FeastWorkspaceReal", "FeastWorkspaceComplex",
    "allocate_matfree_workspace", "MatrixFreeOperator",
    "feast_matfree_srci", "feast_matfree_grci",
    # validation / info helpers
    "check_feast_srci_input", "feast_banded_info", "feast_sparse_info",
    "full_to_general_banded", "feast_rational_expert",
    # backend conveniences
    "feast_serial", "feast_with_backend", "feast_parallel", "mpi_available",
    # the parallel RCI machine and its helpers
    "pfeast_srci", "psfeast_srci", "pdfeast_srci",
    "distribute_contour_points", "pfeast_compute_all_contour_points",
    "pfeast_show_distribution",
    # the sharded drivers and the MPI surface
    "pfeast_sygv", "pfeast_scsrgv",
    "MPIFeastState", "mpi_feast", "mpi_feast_general", "feast_hybrid",
    "mpi_feast_heev", "mpi_feast_hegv", "mpi_feast_geev", "mpi_feast_gegv",
    "mpi_feast_hcsrev", "mpi_feast_hcsrgv", "mpi_feast_gcsrev",
    "mpi_feast_gcsrgv",
]


# The reference exports both the state structs and the step functions;
# here the state machine class is both.
FeastSRCIState = FeastSRCI
FeastHRCIState = FeastHRCI
FeastGRCIState = FeastGRCI
FeastPolyRCIState = FeastPolyRCI
ParallelFeastState = FeastPRCI


def feast_srci(N, M0, Emin, Emax, fpm=None, **kw) -> FeastSRCI:
    """Real-symmetric RCI entry point (feast_srci!, feast_kernel.jl:7-293):
    the state machine; drive it with ``job = state.step()``, servicing
    FACTORIZE / SOLVE / MULT_A / MULT_B."""
    return FeastSRCI(N, M0, Emin, Emax, fpm, **kw)


def feast_hrci(N, M0, Emin, Emax, fpm=None, **kw) -> FeastHRCI:
    """Complex-Hermitian RCI (feast_hrci!, feast_kernel.jl:397-644)."""
    return FeastHRCI(N, M0, Emin, Emax, fpm, **kw)


def feast_grci(N, M0, Emid, r, fpm=None, **kw) -> FeastGRCI:
    """General non-Hermitian RCI (feast_grci!, feast_kernel.jl:646-962)."""
    return FeastGRCI(N, M0, Emid, r, fpm, **kw)


def _rci_x(ctor, args, Zne, Wne, fpm, kw):
    from ..core.aux import with_custom_contour
    from ..core.parameters import _ensure_fpm
    fpm = _ensure_fpm(fpm)
    contour = Contour(np.asarray(Zne, complex), np.asarray(Wne, complex))
    with with_custom_contour(fpm, contour):
        return ctor(*args, fpm, **kw)


def feast_srcix(N, M0, Emin, Emax, fpm, Zne, Wne, **kw) -> FeastSRCI:
    """Custom-contour real-symmetric RCI (feast_srcix!,
    feast_kernel.jl:296-395): the (Zne, Wne) nodes replace the contour of
    [Emin, Emax] for this state machine."""
    return _rci_x(FeastSRCI, (N, M0, Emin, Emax), Zne, Wne, fpm, kw)


def feast_hrcix(N, M0, Emin, Emax, fpm, Zne, Wne, **kw) -> FeastHRCI:
    return _rci_x(FeastHRCI, (N, M0, Emin, Emax), Zne, Wne, fpm, kw)


def feast_grcix(N, M0, Emid, r, fpm, Zne, Wne, **kw) -> FeastGRCI:
    return _rci_x(FeastGRCI, (N, M0, Emid, r), Zne, Wne, fpm, kw)


# The reference's ifeast_*rci are the direct kernels: the RCI protocol
# leaves the shifted solve to the caller, who chooses direct or iterative.
ifeast_srci = feast_srci
ifeast_hrci = feast_hrci
ifeast_grci = feast_grci


def _workspace_dtypes(dtype):
    """(real, complex) torch dtypes of a workspace of real precision
    ``dtype``."""
    rdt = _real_of(_torch_dtype(dtype))
    return rdt, (torch.complex64 if rdt == torch.float32
                 else torch.complex128)


class FeastWorkspaceReal:
    """RCI buffers for real-symmetric problems (FeastWorkspaceReal{T},
    feast_types.jl:30-54), tensors on ``device`` (None: CUDA). The port's
    drivers allocate their own; these serve callers porting RCI loops
    that bring their own storage."""

    def __init__(self, N, M0, dtype=torch.float64, device=None):
        rdt, cdt = _workspace_dtypes(dtype)
        kw = dict(device=resolve_device(device))
        self.N, self.M0 = int(N), int(M0)
        self.work = torch.zeros((N, M0), dtype=rdt, **kw)
        self.workc = torch.zeros((N, M0), dtype=cdt, **kw)
        self.Aq = torch.zeros((M0, M0), dtype=rdt, **kw)
        self.Sq = torch.zeros((M0, M0), dtype=rdt, **kw)
        self.lam = torch.zeros(M0, dtype=rdt, **kw)
        self.q = torch.zeros((N, M0), dtype=rdt, **kw)
        self.res = torch.zeros(M0, dtype=rdt, **kw)


class FeastWorkspaceComplex:
    """RCI buffers for complex problems (FeastWorkspaceComplex{T},
    feast_types.jl:56-80), tensors on ``device`` (None: CUDA)."""

    def __init__(self, N, M0, dtype=torch.float64, device=None):
        rdt, cdt = _workspace_dtypes(dtype)
        kw = dict(device=resolve_device(device))
        self.N, self.M0 = int(N), int(M0)
        self.work = torch.zeros((N, M0), dtype=rdt, **kw)
        self.workc = torch.zeros((N, M0), dtype=cdt, **kw)
        self.zAq = torch.zeros((M0, M0), dtype=cdt, **kw)
        self.zSq = torch.zeros((M0, M0), dtype=cdt, **kw)
        self.lam = torch.zeros(M0, dtype=rdt, **kw)
        self.q = torch.zeros((N, M0), dtype=cdt, **kw)
        self.res = torch.zeros(M0, dtype=rdt, **kw)


def allocate_matfree_workspace(dtype, N, M0, device=None):
    """Matrix-free RCI workspace dict (allocate_matfree_workspace,
    feast_matfree.jl:392-417): a complex ``dtype`` gets the complex
    workspace of its real precision."""
    if _torch_dtype(dtype).is_complex:
        ws = FeastWorkspaceComplex(N, M0, dtype, device)
        return dict(work=ws.work, workc=ws.workc,
                    rhs=torch.zeros_like(ws.workc), zAq=ws.zAq, zSq=ws.zSq,
                    lam=ws.lam, q=ws.q, res=ws.res)
    ws = FeastWorkspaceReal(N, M0, dtype, device)
    return dict(work=ws.work, workc=ws.workc, rhs=torch.zeros_like(ws.workc),
                Aq=ws.Aq, Sq=ws.Sq, lam=ws.lam, q=ws.q, res=ws.res)


# The reference's abstract MatrixFreeOperator has one user-facing concrete
# type (LinearOperator, feast_matfree.jl:13-134).
MatrixFreeOperator = LinearOperator


def _fpm_with(fpm, maxiter, tol):
    from ..core.parameters import _ensure_fpm
    fpm = _ensure_fpm(fpm)
    if maxiter is not None or tol is not None:
        fpm = fpm.copy()
        if maxiter is not None:
            fpm[4] = int(maxiter)
        if tol is not None:
            fpm[3] = max(int(round(-np.log10(float(tol)))), 1)
    return fpm


def feast_matfree_srci(A_op, B_op, interval, M0, *, fpm=None,
                       linear_solver=None, workspace=None, maxiter=None,
                       tol=None, **kw):
    """Matrix-free symmetric driver (feast_matfree_srci!,
    feast_matfree.jl:157-263): ``linear_solver(z, RHS) -> X`` solves
    (z B - A) X = RHS (the reference's mutating callback, returned instead
    of written in place); ``workspace`` is taken for the signature and not
    needed."""
    del workspace
    from ..solvers.matfree import feast_matvec
    return feast_matvec(A_op, B_op, interval, M0,
                        _fpm_with(fpm, maxiter, tol),
                        solve_shifted=linear_solver, **kw)


def feast_matfree_grci(A_op, B_op, center, radius, M0, *, fpm=None,
                       linear_solver=None, workspace=None, maxiter=None,
                       tol=None, **kw):
    """Matrix-free general driver (feast_matfree_grci!,
    feast_matfree.jl:275-380)."""
    del workspace
    from ..solvers.matfree import feast_matvec_general
    return feast_matvec_general(A_op, B_op, center, radius, M0,
                                _fpm_with(fpm, maxiter, tol),
                                solve_shifted=linear_solver, **kw)


def check_feast_srci_input(N, M0, Emin, Emax, fpm=None):
    """RCI input validation (check_feast_srci_input,
    feast_aux.jl:369-398)."""
    from ..core.aux import check_feast_input
    from ..core.parameters import _ensure_fpm
    check_feast_input(N, M0, Emin=Emin, Emax=Emax)
    if fpm is not None:
        _ensure_fpm(fpm)
    return True


def feast_banded_info(A_banded, k, N, file=None):
    """Band-storage summary (feast_banded_info, feast_banded.jl:1389-1407):
    (N, bandwidth, stored elements)."""
    stored = int(A_banded.shape[0] * A_banded.shape[1])
    bandwidth = 2 * int(k) + 1
    pct = stored / float(N * N) * 100.0
    print("Banded Matrix Information:", file=file)
    print(f"  Size: {N} x {N}", file=file)
    print(f"  Bandwidth: {bandwidth}", file=file)
    print(f"  Super-diagonals: {int(k)}", file=file)
    print(f"  Stored elements: {stored}", file=file)
    print(f"  Storage efficiency: {pct:.1f}%", file=file)
    return (int(N), bandwidth, stored)


def feast_sparse_info(A, file=None):
    """Sparse-matrix summary (feast_sparse_info, feast_sparse.jl:1499-1512):
    (N, nnz, density in percent) of a scipy sparse matrix, a torch sparse
    tensor or a dense array or tensor (its nonzeros)."""
    N = int(A.shape[0])
    if isinstance(A, torch.Tensor):
        nnz = A._nnz() if A.layout != torch.strided \
            else torch.count_nonzero(A)
    else:
        nnz = getattr(A, "nnz", None)
        if nnz is None:
            nnz = np.count_nonzero(np.asarray(A))
    nnz = int(nnz)
    density = nnz / float(N * N) * 100.0
    print("Sparse Matrix Information:", file=file)
    print(f"  Size: {N} x {N}", file=file)
    print(f"  Non-zeros: {nnz}", file=file)
    print(f"  Density: {density:.2f}%", file=file)
    return (N, nnz, density)


def full_to_general_banded(M, kl, ku):
    """General (kl != ku) band extraction (full_to_general_banded,
    feast_banded.jl:1304): the LAPACK layout of ``ops/banded.full_to_banded``,
    which takes unequal bandwidths."""
    from ..ops.banded import full_to_banded
    return full_to_banded(M, kl, ku)


def feast_rational_expert(Zne, Wne, lam):
    """The rational filter at explicit nodes and weights
    (feast_rational_expert = feast_rationalx, feast_tools.jl:616)."""
    from ..core.contour import feast_rationalx
    return feast_rationalx(Zne, Wne, lam)


def feast_serial(A, B, interval, M0, fpm=None, **kw):
    """Serial storage-dispatched solve (feast_serial,
    feast_backend_utils.jl:166-198)."""
    from .feast import feast
    return feast(A, B, interval, M0, fpm, backend="serial", **kw)


def feast_with_backend(backend, A, B, interval, M0, fpm=None, **kw):
    """Explicit-backend solve (feast_with_backend,
    feast_backend_utils.jl:103-121); the reference's threads /
    distributed / mpi names mean the sharded backend, as in ``feast``."""
    from .feast import feast
    return feast(A, B, interval, M0, fpm, backend=backend, **kw)


def feast_parallel(A, B, interval, M0=10, fpm=None, *, use_threads=True,
                   auto_rci=True, **kw):
    """Auto-managed parallel solve (feast_parallel,
    feast_parallel_rci.jl:325-383): serial on one rank, else the sharded
    backend over the default process group's ranks."""
    del use_threads, auto_rci
    from .feast import feast
    device = resolve_device(kw.get("device"))
    backend = "serial" if _n_devices(device) == 1 else "sharded"
    return feast(A, B, interval, M0, fpm, backend=backend, **kw)


def mpi_available() -> bool:
    """Whether the distributed backend is usable (mpi_available,
    feast_backend_utils.jl:8-10): wherever ``torch.distributed`` is (a
    world of one rank runs serially)."""
    import torch.distributed as dist
    return bool(dist.is_available())


def pfeast_srci(N, M0, Emin, Emax, fpm=None, **kw) -> FeastPRCI:
    """Parallel RCI state machine (ParallelFeastState + pfeast_srci!,
    feast_parallel_rci.jl:47-266): one PARALLEL_SOLVE hands the caller all
    contour nodes at once."""
    return FeastPRCI(N, M0, Emin, Emax, fpm, **kw)


# p{s,d}feast_srci: the same machine (the precision prefix is the caller's
# solves'; the machine itself works in float64)
psfeast_srci = pdfeast_srci = pfeast_srci


def distribute_contour_points(ne, nw):
    """Block partition of ne contour points over nw workers
    (distribute_contour_points, feast_parallel.jl:433-447): a list of
    0-based index ranges."""
    ne, nw = int(ne), max(int(nw), 1)
    per = -(-ne // nw)
    return [range(w * per, min((w + 1) * per, ne)) for w in range(nw)
            if w * per < ne]


def pfeast_compute_all_contour_points(state: FeastPRCI, A, B=None):
    """Service a FeastPRCI PARALLEL_SOLVE on the state's device: one
    batched complex128 solve of (Z_e B - A) X_e = workc for every node
    (pfeast_compute_all_contour_points!, feast_parallel_rci.jl:269-322, as
    one batched LU instead of a thread pool). Assigns ``state.Xall`` and
    returns it."""
    dev = state.device

    def tensor(X):
        X = X if isinstance(X, torch.Tensor) else torch.as_tensor(
            np.asarray(X))
        return X.to(device=dev, dtype=torch.complex128)

    A = tensor(A)
    Bm = torch.eye(A.shape[0], dtype=A.dtype, device=dev) if B is None \
        else tensor(B)
    Z = tensor(state.Zall)
    pencils = Z[:, None, None] * Bm[None] - A[None]
    rhs = tensor(state.workc)
    state.Xall = torch.linalg.solve(
        pencils, rhs[None].expand(Z.shape[0], *rhs.shape))
    return state.Xall


def pfeast_show_distribution(ne, *, n_devices=None, use_threads=True,
                             file=None):
    """Print the contour-point -> device partition
    (pfeast_show_distribution, feast_parallel.jl:299-322) over
    ``n_devices`` (default: the CUDA cards, or one CPU)."""
    del use_threads
    nd = int(n_devices) if n_devices else _n_devices(_default_device())
    print(f"Device-mesh distribution for {ne} contour points across "
          f"{nd} devices:", file=file)
    for d, rng in enumerate(distribute_contour_points(ne, nd)):
        print(f"  Device {d}: contour points {rng.start + 1}:{rng.stop}",
              file=file)


# ---------------------------------------------------------------------------
# The sharded drivers and the MPI surface (feast_parallel.jl, feast_mpi.jl,
# feast_mpi_interface.jl): communicators become meshes over the ranks of
# the default process group, Allreduce the all-reduces of the drivers.
# ---------------------------------------------------------------------------

def pfeast_sygv(A, B, Emin, Emax, M0, fpm=None, **kw):
    """Contour-parallel dense symmetric solve (pfeast_sygv!,
    feast_parallel.jl:58-207) over the ranks."""
    from ..parallel.pfeast import pfeast_dense
    return pfeast_dense(A, B, Emin, Emax, M0, fpm, **kw)


def pfeast_scsrgv(A, B, Emin, Emax, M0, fpm=None, **kw):
    """Contour-parallel sparse symmetric solve (pfeast_scsrgv!,
    feast_parallel.jl:450-572)."""
    from ..parallel.pfeast import pfeast_sparse
    return pfeast_sparse(A, B, Emin, Emax, M0, fpm, **kw)


def _mesh_from_comm(comm):
    """None -> the drivers' default contour mesh; an int -> a contour mesh
    of that many ranks (the world's size); a DeviceMesh -> as is. Anything
    else (e.g. an mpi4py communicator) is refused."""
    if comm is None:
        return None
    if isinstance(comm, (int, np.integer)):
        from ..parallel.pfeast import contour_mesh
        return contour_mesh(int(comm))
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(comm, DeviceMesh):
        return comm
    raise TypeError(
        f"comm must be None, an int rank count, or a "
        f"torch.distributed.device_mesh.DeviceMesh; got "
        f"{type(comm).__name__}. The communicator is the mesh over the "
        "ranks of the default process group (parallel/pfeast.py).")


class MPIFeastState:
    """Per-rank contour bookkeeping (MPIFeastState{T}, feast_mpi.jl:9-54):
    the block partition of the nodes over the ranks (``local_points``,
    ``local_Zne``, ``local_Wne``, one entry per rank), this process's
    ``rank`` and the shared convergence state."""

    def __init__(self, N, M0, Zne, Wne, *, comm=None, root=0):
        import torch.distributed as dist
        mesh = _mesh_from_comm(comm)
        self.comm = mesh
        self.size = int(mesh.size()) if mesh is not None else _n_devices()
        self.rank = dist.get_rank() if (dist.is_available()
                                        and dist.is_initialized()) else 0
        self.root = int(root)
        self.N, self.M0 = int(N), int(M0)
        Zne = np.asarray(Zne, complex)
        Wne = np.asarray(Wne, complex)
        self.ne = len(Zne)
        parts = distribute_contour_points(self.ne, self.size)
        self.local_points = [list(p) for p in parts]
        self.local_Zne = [Zne[list(p)] for p in parts]
        self.local_Wne = [Wne[list(p)] for p in parts]
        self.converged = False
        self.loop = 0
        self.epsout = np.inf
        self.info = 0


def _interval_args(B, interval):
    """The reference's 2-positional standard form ``(A, interval)``."""
    if interval is None and isinstance(B, (tuple, list)) and len(B) == 2:
        B, interval = None, B
    if interval is None:
        raise ValueError("interval=(Emin, Emax) is required")
    return B, interval


def _mpi_kw(comm, root, kw):
    del root
    mesh = _mesh_from_comm(comm)
    if mesh is not None:
        kw["mesh"] = mesh
    return kw


def mpi_feast(A, B=None, interval=None, M0=10, fpm=None, *, comm=None,
              root=0, **kw):
    """Distributed solve, communicator -> mesh (mpi_feast dispatchers,
    feast_mpi.jl:1077-1197), through ``feast(..., backend="mpi")``.
    Accepts the reference's 2-positional standard form
    ``mpi_feast(A, interval)``."""
    from .feast import feast
    B, interval = _interval_args(B, interval)
    return feast(A, B, interval, M0, fpm, backend="mpi",
                 **_mpi_kw(comm, root, kw))


def mpi_feast_general(A, B=None, center=0.0 + 0.0j, radius=1.0, M0=10,
                      fpm=None, *, comm=None, root=0, **kw):
    """Distributed general solve (mpi_feast_general,
    feast_mpi.jl:1199-1273)."""
    from .feast import feast_general
    return feast_general(A, B, center, radius, M0, fpm, backend="mpi",
                         **_mpi_kw(comm, root, kw))


def feast_hybrid(A, B=None, interval=None, M0=10, fpm=None, *, comm=None,
                 use_threads_per_rank=True, **kw):
    """Hybrid MPI x threads -> a contour x rhs mesh over the world
    (feast_hybrid, feast_mpi_interface.jl:10-178): the contour axis the
    largest divisor of the rank count not above the node count, the RHS
    columns across the rest (the threads-within-a-rank analog)."""
    from .feast import feast
    B, interval = _interval_args(B, interval)
    mesh = _mesh_from_comm(comm)
    if mesh is None and use_threads_per_rank:
        from ..core.parameters import _ensure_fpm
        from ..parallel.pfeast import contour_rhs_mesh
        nd = _n_devices()
        ne = max(int(_ensure_fpm(fpm)[2]), 1)
        n_contour = 1
        for d in range(min(ne, nd), 0, -1):
            if nd % d == 0:
                n_contour = d
                break
        n_rhs = nd // n_contour
        if n_rhs > 1:
            mesh = contour_rhs_mesh(n_contour, n_rhs)
    if mesh is not None:
        kw["mesh"] = mesh
    return feast(A, B, interval, M0, fpm, backend="mpi", **kw)


def mpi_feast_hegv(A, B, Emin, Emax, M0, fpm=None, *, comm=None, root=0,
                   **kw):
    """Distributed dense Hermitian generalized solve (mpi_feast_hegv!,
    feast_mpi.jl:925-932)."""
    from ..parallel.pfeast import pfeast_dense
    return pfeast_dense(A, B, Emin, Emax, M0, fpm, hermitian=True,
                        **_mpi_kw(comm, root, kw))


def mpi_feast_heev(A, Emin, Emax, M0, fpm=None, *, comm=None, root=0, **kw):
    """Distributed dense Hermitian standard solve (mpi_feast_heev!,
    feast_mpi.jl:934-939)."""
    from ..parallel.pfeast import pfeast_dense
    return pfeast_dense(A, None, Emin, Emax, M0, fpm, hermitian=True,
                        **_mpi_kw(comm, root, kw))


def mpi_feast_hcsrgv(A, B, Emin, Emax, M0, fpm=None, *, comm=None, root=0,
                     **kw):
    """Distributed sparse Hermitian generalized solve (mpi_feast_hcsrgv!,
    feast_mpi.jl:911-916)."""
    from ..parallel.pfeast import pfeast_sparse
    return pfeast_sparse(A, B, Emin, Emax, M0, fpm, hermitian=True,
                         **_mpi_kw(comm, root, kw))


def mpi_feast_hcsrev(A, Emin, Emax, M0, fpm=None, *, comm=None, root=0,
                     **kw):
    """Distributed sparse Hermitian standard solve (mpi_feast_hcsrev!,
    feast_mpi.jl:918-923)."""
    from ..parallel.pfeast import pfeast_sparse
    return pfeast_sparse(A, None, Emin, Emax, M0, fpm, hermitian=True,
                         **_mpi_kw(comm, root, kw))


def mpi_feast_gegv(A, B, Emid, r, M0, fpm=None, *, comm=None, root=0, **kw):
    """Distributed dense general solve (mpi_feast_gegv!,
    feast_mpi.jl:1063-1068)."""
    from ..parallel.pfeast import pfeast_general
    return pfeast_general(A, B, Emid, r, M0, fpm,
                          **_mpi_kw(comm, root, kw))


def mpi_feast_geev(A, Emid, r, M0, fpm=None, *, comm=None, root=0, **kw):
    """Distributed dense general standard solve (mpi_feast_geev!,
    feast_mpi.jl:1070-1074)."""
    from ..parallel.pfeast import pfeast_general
    return pfeast_general(A, None, Emid, r, M0, fpm,
                          **_mpi_kw(comm, root, kw))


def mpi_feast_gcsrgv(A, B, Emid, r, M0, fpm=None, *, comm=None, root=0,
                     **kw):
    """Distributed sparse general solve (mpi_feast_gcsrgv!,
    feast_mpi.jl:1048-1053)."""
    from ..parallel.pfeast import pfeast_sparse_general
    return pfeast_sparse_general(A, B, Emid, r, M0, fpm,
                                 **_mpi_kw(comm, root, kw))


def mpi_feast_gcsrev(A, Emid, r, M0, fpm=None, *, comm=None, root=0, **kw):
    """Distributed sparse general standard solve (mpi_feast_gcsrev!,
    feast_mpi.jl:1055-1061)."""
    from ..parallel.pfeast import pfeast_sparse_general
    return pfeast_sparse_general(A, None, Emid, r, M0, fpm,
                                 **_mpi_kw(comm, root, kw))
