"""Sharded FEAST over the ranks of a ``torch.distributed`` process group:
contour nodes, right-hand-side columns and operator rows split across
ranks (PyTorch).

Counterpart of ``feastkit_tpu/parallel/pfeast.py``, in the reference's own
model (FeastKit.jl's MPI backend, feast_mpi.jl): SPMD. Every rank of the
default process group calls the same driver with the same arguments,
builds the same mesh and the same seeded subspace, runs its share of the
work on its own device with the port's engines and kernels, and the shares
meet in all-reduces; the small reduced eigenproblem is solved on every
rank (the reference's every-rank-solves-redundantly consistency,
feast_mpi.jl:121-139). The JAX package's single controller, one process
driving a mesh of local devices through ``shard_map``, has no counterpart.

* A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over all the
  ranks of the default group, with the JAX package's axis names
  ``contour``, ``rhs`` and ``model`` in its order. Every rank joins every
  collective, so a mesh spans the world: a count that differs from the
  world's size is a ValueError. Without a process group, or in a world of
  one rank, there is nothing to shard: a mesh is None and the drivers run
  on this rank alone.
* Every collective is a ``dist.all_reduce`` (SUM, MAX or MIN) over an
  axis's group. A gather (the RHS columns, the polynomial filter's column
  blocks, the halo rows, the V-cycle's rows) is a SUM of zero-filled
  blocks, exact since x + 0 = x: gloo takes CUDA tensors for
  ``all_reduce`` and ``broadcast`` only, and NCCL takes the same calls.
* Contour nodes are padded to a multiple of the contour axis with
  zero-weight nodes (``pad_contour``) and block-partitioned over it; each
  rank's filter sums its nodes and the sums meet in one all-reduce per
  filter application, with a MIN consensus of the inner solves' flags.
* The model axis splits N: each rank holds its rows of the operators'
  diagonals and of the subspace, its DIA products are the halo products of
  ``_dia_halo_matvec`` (the port's DIA kernels on the block extended by
  the neighbours' rows), its Krylov contractions and refinement norms are
  summed over the model axis (``ops/gmres.py``'s ``axis_name``), every
  loop of the inner solves runs the same number of trips on every rank
  (``sync_axes``), the V-cycle gathers the rows, and the Hermitian core
  runs its Gram route with ``nsum`` (``kernel/hermitian.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.aux import feast_get_custom_contour
from ..core.backend import resolve_device
from ..core.contour import feast_contour, feast_gcontour
from ..core.parameters import FeastConfig, _ensure_fpm, ifeast_solver_options
from ..core.tools import initial_subspace
from ..kernel.general import feast_general_core, general_result
from ..kernel.hermitian import feast_hermitian_core, hermitian_result
from ..ops.gmres import _psum

__all__ = ["contour_mesh", "contour_rhs_mesh", "contour_model_mesh",
           "pad_contour", "pfeast_dense", "pfeast_sparse", "pfeast_general",
           "pfeast_sparse_general"]

AXIS = "contour"
RHS_AXIS = "rhs"
MODEL_AXIS = "model"

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


# ---------------------------------------------------------------------------
# Meshes and collectives
# ---------------------------------------------------------------------------

def _world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _make_mesh(shape, names, devices=None):
    """A DeviceMesh of ``shape`` over the whole world (``devices``: the
    world's ranks in the mesh's order), or None in a world of one."""
    n = int(np.prod(shape))
    world = _world_size()
    if n != world:
        raise ValueError(
            f"a mesh of {n} ranks must span the world of {world} rank(s) "
            "of the default process group: every rank joins every "
            "collective, so a mesh over the first n devices has no "
            "counterpart")
    ranks = np.arange(n) if devices is None else np.asarray(devices)
    if sorted(ranks.reshape(-1).tolist()) != list(range(world)):
        raise ValueError(f"devices must be the world's ranks 0..{world - 1}"
                         f" in some order, got {ranks.tolist()}")
    if world == 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    # the mesh only names the ranks' groups; every tensor stays where its
    # rank put it
    return DeviceMesh("cpu", torch.as_tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(names))


def contour_mesh(n_devices: int | None = None, devices=None):
    """1-D mesh over the contour axis (the reference's L2 communicator,
    fpm[9]), over every rank of the default group (``n_devices``, when
    given, must be the world's size)."""
    n = _world_size() if n_devices is None else int(n_devices)
    return _make_mesh((n,), (AXIS,), devices)


def contour_rhs_mesh(n_contour: int, n_rhs: int, devices=None):
    """2-D mesh (contour x rhs): contour nodes on one axis, RHS columns on
    the other."""
    return _make_mesh((int(n_contour), int(n_rhs)), (AXIS, RHS_AXIS),
                      devices)


def contour_model_mesh(n_contour: int, n_model: int, n_rhs: int = 1,
                       devices=None):
    """Mesh with a MODEL axis splitting the operator rows N; an optional
    middle rhs axis: (contour, rhs, model)."""
    if int(n_rhs) > 1:
        return _make_mesh((int(n_contour), int(n_rhs), int(n_model)),
                          (AXIS, RHS_AXIS, MODEL_AXIS), devices)
    return _make_mesh((int(n_contour), int(n_model)), (AXIS, MODEL_AXIS),
                      devices)


def _axis(mesh, name):
    """(size, this rank's index, group) on axis ``name``: (1, 0, None)
    where the mesh is None, lacks the axis or has one rank on it."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if name not in names:
        return 1, 0, None
    size = int(mesh.size(names.index(name)))
    if size == 1:
        return 1, 0, None
    return size, int(mesh.get_local_rank(name)), mesh.get_group(name)


def _all_reduce(t, mesh, names, op="sum"):
    """``t`` reduced in place over the ranks that differ along the axes
    ``names``: one all-reduce over the world where those are all of the
    mesh's axes with more than one rank, else one per axis."""
    axes = [n for n in names if _axis(mesh, n)[0] > 1]
    if not axes:
        return t
    redop = getattr(dist.ReduceOp, _OPS[op])
    t = t.resolve_conj().contiguous()
    every = [n for n in mesh.mesh_dim_names if _axis(mesh, n)[0] > 1]
    if set(every) <= set(axes):
        dist.all_reduce(t, op=redop)
    else:
        for n in axes:
            dist.all_reduce(t, op=redop, group=_axis(mesh, n)[2])
    return t


def _consensus(ok, mesh, names):
    """Whether ``ok`` (a bool tensor) holds on every rank along ``names``."""
    t = torch.as_tensor(ok).to(torch.int32).reshape(1)
    return _all_reduce(t, mesh, names, "min")[0] > 0


def _gather_cols(local, c0, M, mesh, names):
    """The (N, M) block whose columns c0 : c0 + k are this rank's (N, k)
    ``local``, gathered over ``names`` as a SUM of zero-filled blocks."""
    full = torch.zeros((local.shape[0], M), dtype=local.dtype,
                       device=local.device)
    full[:, c0:c0 + local.shape[1]] = local
    return _all_reduce(full, mesh, names)


def pad_contour(Zne, Wne, n_shards: int):
    """Pad node/weight arrays to a multiple of the mesh axis size.

    Zero-weight padding is exact (the padded solves are computed and
    discarded by the weighted sum). Padded nodes reuse the first node so the
    padded pencil stays factorizable. This replaces the reference's
    block+remainder partition (distribute_contour_points,
    feast_parallel.jl:433-447) with an even-shard constraint.
    """
    ne = len(Zne)
    pad = (-ne) % n_shards
    if pad:
        Zne = np.concatenate([np.asarray(Zne), np.repeat(np.asarray(Zne[:1]), pad)])
        Wne = np.concatenate([np.asarray(Wne), np.zeros(pad, np.asarray(Wne).dtype)])
    return Zne, Wne


def _local_nodes(contour, mesh):
    """This rank's block of the padded contour nodes and weights."""
    n_c, i_c, _ = _axis(mesh, AXIS)
    Zp, Wp = pad_contour(contour.Zne, contour.Wne, n_c)
    k = len(Zp) // n_c
    return np.asarray(Zp)[i_c * k:(i_c + 1) * k], \
        np.asarray(Wp)[i_c * k:(i_c + 1) * k]


def _column_block(mesh, M0):
    """(c0, c1) of this rank's columns where M0 splits evenly over every
    rank of ``mesh``, else None (nothing is sharded)."""
    if mesh is None:
        return None
    size = int(mesh.size())
    if size <= 1 or M0 % size:
        return None
    k = M0 // size
    r = dist.get_rank()
    return r * k, (r + 1) * k, mesh


def _column_sharded(filt, block):
    """The polynomial filter ``filt(ctx, Q, **kw)`` on this rank's column
    block, the blocks gathered over every rank (one all-reduce)."""
    c0, c1, mesh = block

    def sharded(ctx, Q, **kw):
        local = filt(ctx, Q[:, c0:c1].contiguous(), **kw)
        return _gather_cols(local, c0, Q.shape[1], mesh,
                            mesh.mesh_dim_names)
    return sharded


# ---------------------------------------------------------------------------
# The halo DIA product and the gathered V-cycle (model axis)
# ---------------------------------------------------------------------------

# The last gathered V-cycle's output on this rank: (its local rows, the
# whole block, the rows' start). Every rank computed the whole block from
# the same gathered input, so the halo of a product of those local rows is
# already here (``_halo_extend`` takes it without a collective).
_LAST_GATHER = [None, None, 0]


def _gather_rows_prec(prec, group):
    """The row-sharded preconditioner: the V-cycle is a full-grid
    operation, so the local rows (..., n_loc, K) of every rank of ``group``
    are gathered (a SUM all-reduce of zero-filled full blocks, exact), the
    full-grid V-cycle runs on every rank, and each keeps its own rows."""
    i, n = dist.get_rank(group), dist.get_world_size(group)

    def sharded(X):
        n_loc = X.shape[-2]
        full = torch.zeros(X.shape[:-2] + (n * n_loc, X.shape[-1]),
                           dtype=X.dtype, device=X.device)
        full[..., i * n_loc:(i + 1) * n_loc, :] = X
        dist.all_reduce(full, group=group)
        Y = prec(full)
        loc = Y[..., i * n_loc:(i + 1) * n_loc, :]
        _LAST_GATHER[:] = [loc, Y, i * n_loc]
        return loc
    return sharded

def _halo(offsets) -> int:
    return max(max((abs(int(o)) for o in offsets), default=1), 1)


def _halo_extend(X, h, row_axis):
    """This rank's rows (..., n_loc, K) extended by h rows of each
    neighbour on the model axis (zeros at the grid's edges): every rank's
    first and last h rows meet in one SUM all-reduce of zero-filled
    slots, except for the rows of the last gathered V-cycle, whose halo
    this rank computed itself."""
    size, index, group = row_axis
    loc, Y, r0 = _LAST_GATHER
    if X is loc:
        zero = torch.zeros(X.shape[:-2] + (h, X.shape[-1]), dtype=X.dtype,
                           device=X.device)
        n_loc = X.shape[-2]
        prev = Y[..., r0 - h:r0, :] if r0 > 0 else zero
        nxt = Y[..., r0 + n_loc:r0 + n_loc + h, :] \
            if r0 + n_loc < Y.shape[-2] else zero
        return torch.cat([prev, X, nxt], dim=-2)
    slots = torch.zeros((size, 2) + X.shape[:-2] + (h, X.shape[-1]),
                        dtype=X.dtype, device=X.device)
    slots[index, 0] = X[..., :h, :]
    slots[index, 1] = X[..., X.shape[-2] - h:, :]
    dist.all_reduce(slots, group=group)
    zero = torch.zeros_like(slots[0, 0])
    prev = slots[index - 1, 1] if index > 0 else zero
    nxt = slots[index + 1, 0] if index < size - 1 else zero
    return torch.cat([prev, X, nxt], dim=-2)


def _extend_diags(diags_loc, h):
    """The local diagonals (nd, n_loc) zero-padded by h columns each side
    (row-aligned: the extended block's halo rows get no product)."""
    nd, n_loc = diags_loc.shape
    ext = torch.zeros((nd, n_loc + 2 * h), dtype=diags_loc.dtype,
                      device=diags_loc.device)
    ext[:, h:h + n_loc] = diags_loc
    return ext


def _dia_halo_matvec(diags_loc, X, offsets, row_axis, diags_ext=None):
    """Row-sharded DIA product y = A x for this rank's rows: X (n_loc, K) or
    (g, n_loc, K), ``diags_loc`` the row-aligned local (nd, n_loc) slice of
    the diagonals, ``row_axis`` the model axis (size, index, group). The
    block is extended by the neighbours' halo rows and the port's DIA
    kernel (``ops/dia.dia_matvec_any``: one launch, the batched entry for
    a node group) runs on the extended block with the zero-padded
    diagonals; rows h .. h + n_loc are the product (an interior row never
    reaches the kernel's zero boundary). ``diags_ext``: the padded
    diagonals, when the caller keeps them."""
    from ..ops.dia import dia_matvec_any
    h = _halo(offsets)
    n_loc = X.shape[-2]
    if diags_ext is None:
        diags_ext = _extend_diags(diags_loc, h)
    y = dia_matvec_any(diags_ext, offsets, _halo_extend(X, h, row_axis))
    return y[..., h:h + n_loc, :]


def _dia_halo_matvec_plain(diags_loc, X, offsets, row_axis):
    """The plain version: the JAX package's shifted adds on the extended
    block (``_dia_halo_matvec``, pfeast.py:85-103)."""
    h = _halo(offsets)
    n_loc = X.shape[-2]
    x_ext = _halo_extend(X, h, row_axis)
    dt = torch.promote_types(diags_loc.dtype, X.dtype)
    y = torch.zeros(X.shape, dtype=dt, device=X.device)
    for k, off in enumerate(offsets):
        y = y + diags_loc[k][:, None] * x_ext[..., h + int(off):
                                               h + int(off) + n_loc, :]
    return y


def _halo_operator(dia_rows, offsets, row_axis):
    """apply(X) = the halo product of this rank's rows ``dia_rows``."""
    ext = _extend_diags(dia_rows, _halo(offsets))

    def apply(X):
        return _dia_halo_matvec(dia_rows, X, offsets, row_axis,
                                diags_ext=ext)
    return apply


# ---------------------------------------------------------------------------
# Dense drivers
# ---------------------------------------------------------------------------

def _contour_of(contour, fpm, default):
    if contour is None:
        contour = feast_get_custom_contour(fpm)
    return default() if contour is None else contour


def pfeast_dense(A, B, Emin, Emax, M0, fpm=None, *, hermitian=None,
                 contour=None, Q0=None, mesh=None, n_devices=None,
                 device=None):
    """Dense symmetric / Hermitian FEAST with the contour nodes over the
    mesh's contour axis and the subspace's columns over its rhs axis
    (parity surface: pfeast_sygv! / pfeast_scsrgv! / mpi_feast). Each rank
    factors its nodes' shifted pencils (one batched LU,
    ``solvers/dense._make_ops``), filters its column block, and the
    partial sums meet in one all-reduce per filter application; the
    refinement runs on every rank. M0 is padded to a multiple of the rhs
    axis. fpm[14]=2 counts through the sharded filter on contour meshes.
    ``device=None`` means CUDA."""
    from ..solvers.dense import _make_ops, _np_dtype, _operand
    from ..solvers.sparse import _stochastic_estimate_result
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    if mesh is None:
        mesh = contour_mesh(n_devices)
    standard = B is None
    N = tuple(A.shape)[0]
    dt_in = np.result_type(*[_np_dtype(X) for X in (A, B) if X is not None])
    single = dt_in in (np.dtype(np.float32), np.dtype(np.complex64))
    rdtype = np.dtype(np.float32 if single else np.float64)
    cdtype = np.dtype(np.complex64 if single else np.complex128)
    if hermitian is None:
        hermitian = dt_in.kind == "c"
    work = cdtype if hermitian else rdtype
    A = _operand(A, work, device)
    B = None if standard else _operand(B, work, device)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    contour = _contour_of(contour, fpm,
                          lambda: feast_contour(Emin, Emax, fpm))
    n_rhs, i_rhs, _ = _axis(mesh, RHS_AXIS)
    M0 = M0 + ((-M0) % n_rhs)
    Zl, Wl = _local_nodes(contour, mesh)
    apply_A, apply_B, local_filter = _make_ops(
        A, B, torch.as_tensor(np.asarray(Zl, cdtype)).to(device),
        torch.as_tensor(np.asarray(Wl, cdtype)).to(device),
        standard=standard, hermitian=bool(hermitian),
        store_factorization=config.store_factorization)

    def filter_apply(Q):
        k = Q.shape[1] // n_rhs
        local = local_filter(Q[:, i_rhs * k:(i_rhs + 1) * k])
        if n_rhs > 1:
            return _gather_cols(local, i_rhs * k, Q.shape[1], mesh,
                                (AXIS, RHS_AXIS))
        return _all_reduce(local, mesh, (AXIS,))

    if config.mode == 2:
        if n_rhs > 1:
            raise NotImplementedError(
                "stochastic estimate (fpm[14]=2) is supported on contour "
                "meshes only; drop the rhs axis")
        return _stochastic_estimate_result(filter_apply, N, fpm, work,
                                           device)
    Q0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, work)).to(device)
    state = feast_hermitian_core(
        apply_A, apply_B, filter_apply, Q0, float(Emin), float(Emax),
        tol=config.tol, max_loops=config.max_loops,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1))
    return hermitian_result(state)


def pfeast_general(A, B, Emid, r, M0, fpm=None, *, bilinear=False,
                   eig_method=None, contour=None, Q0=None, mesh=None,
                   n_devices=None, device=None, **kw):
    """Dense general / complex-symmetric FEAST with the full contour's
    nodes over the mesh's contour axis (parity: _mpi_feast_complex_general!
    + mpi_feast_general, feast_mpi.jl:941-1046, :1199-1273): each rank
    factors its nodes, the partial sums meet in one all-reduce per loop,
    and the reduced general eigenproblem is solved on every rank. Sparse
    operands route to :func:`pfeast_sparse_general`. ``device=None`` means
    CUDA."""
    import scipy.sparse as sp
    if sp.issparse(A):
        return pfeast_sparse_general(A, B, Emid, r, M0, fpm,
                                     bilinear=bilinear,
                                     eig_method=eig_method, contour=contour,
                                     Q0=Q0, mesh=mesh, n_devices=n_devices,
                                     device=device, **kw)
    from ..ops.eig import check_method
    from ..solvers.dense import _np_dtype, _operand
    from ..solvers.dense_general import (_cdtype_of, _check_general,
                                         _general_ops)
    from ..solvers.sparse import (_general_estimate,
                                  _stochastic_estimate_result)
    check_method(eig_method)
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    if mesh is None:
        mesh = contour_mesh(n_devices)
    standard = B is None
    N = tuple(A.shape)[0]
    _check_general(N, M0, r)
    cdtype = _cdtype_of(*[_np_dtype(X) for X in (A, B) if X is not None])
    A = _operand(A, cdtype, device)
    B = None if standard else _operand(B, cdtype, device)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    contour = _contour_of(contour, fpm, lambda: feast_gcontour(
        complex(Emid), float(r), fpm))
    Zl, Wl = _local_nodes(contour, mesh)
    apply_A, apply_B, local_filter = _general_ops(
        A, B, torch.as_tensor(np.asarray(Zl, cdtype)).to(device),
        torch.as_tensor(np.asarray(Wl, cdtype)).to(device),
        standard=standard, store_factorization=config.store_factorization)

    def filter_apply(Q):
        return _all_reduce(local_filter(Q), mesh, (AXIS,))

    if config.mode == 2:
        # the raw full-contour sum: trace(P) = M for the oblique projector
        return _general_estimate(_stochastic_estimate_result(
            filter_apply, N, fpm, cdtype, device))
    Q0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, cdtype,
                                          general=True)).to(device)
    state = feast_general_core(
        apply_A, apply_B, filter_apply, Q0, complex(Emid), float(r),
        tol=config.tol, max_loops=config.max_loops,
        aspect_ratio=config.aspect_ratio, rotation_deg=config.rotation_deg,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1), bilinear=bilinear)
    return general_result(state)


# ---------------------------------------------------------------------------
# Sparse drivers
# ---------------------------------------------------------------------------

def _iopts(fpm, solver, solver_tol, solver_maxiter):
    """The IFEAST inner-solver knobs (fpm[43..46]) over the defaults."""
    iopts = ifeast_solver_options(fpm) or {}
    if iopts:
        solver = iopts["solver"] if solver == "gmres" else solver
        solver_tol = iopts["solver_tol"] if solver_tol is None else solver_tol
        solver_maxiter = iopts["solver_maxiter"] \
            if solver_maxiter == 500 else solver_maxiter
    return solver, solver_tol, solver_maxiter


def _sharded_filter(local_filter, mesh, sum_axes, ok_axes):
    """filter_apply(Q, lam, tol_hint) -> (the sum over ``sum_axes`` of the
    ranks' partial sums, the MIN consensus over ``ok_axes`` of their inner
    solves' flags), with the local filter's warm-start and tolerance
    protocols."""
    def filter_apply(Q, **kw):
        acc, ok = local_filter(Q, **kw)
        return _all_reduce(acc, mesh, sum_axes), \
            _consensus(ok, mesh, ok_axes).to(acc.device)
    filter_apply.takes_ritz = local_filter.takes_ritz
    filter_apply.takes_tol = local_filter.takes_tol
    return filter_apply


def _krylov_record(result, *, solver, precond, mg_A, restart, standard,
                   hermitian, general, offsets_A, offsets_B, events):
    """``result.krylov`` as the serial Krylov engine records it (this
    rank's solves: ``solvers/sparse.krylov_dia_launches``)."""
    result.krylov = dict(solver=solver, precond=precond,
                         mg_levels=mg_A[3] if precond == "mg" else None,
                         restart=int(restart), standard=standard,
                         hermitian=bool(hermitian),
                         complex=bool(hermitian or general),
                         a_dia=offsets_A is not None,
                         b_dia=offsets_B is not None, events=events)
    if general:
        result.krylov["general"] = True
    return result


def pfeast_sparse(A, B, Emin, Emax, M0, fpm=None, *, hermitian=None,
                  contour=None, Q0=None, mesh=None, n_devices=None,
                  solver="gmres", solver_tol=None, solver_maxiter=500,
                  solver_restart=30, grid=None, precond=None, device=None):
    """Sparse symmetric / Hermitian FEAST on a mesh (parity:
    pfeast_scsrgv! threads / Distributed, mpi_feast_scsrgv! MPI), with the
    serial Krylov engine's full machinery on each rank's share
    (``solvers/sparse._sparse_ops``: multigrid or Jacobi preconditioning,
    mixed-precision refinement under fpm[42], the DIA kernels in node
    groups).

    * ``solver="cheb"`` / ``"contour_poly"``: the polynomial filter has no
      nodes; ``solvers/sparse._sparse_cheb_interval(mesh=mesh)`` splits the
      subspace's columns over every rank of the mesh where M0 allows (each
      rank runs the fused Chebyshev kernels on its block), else runs
      unsharded.
    * A contour mesh (its rhs axis, if any, replicated): each rank solves
      its nodes; one all-reduce per loop. fpm[14]=2 counts through this
      sharded filter.
    * A model axis splits N: the operators need a DIA form (the halo
      products), N divides over the axis, and no shard is narrower than
      the bandwidth; no fpm[14]=2 there.

    ``device=None`` means CUDA."""
    from ..solvers.sparse import (_is_double, _peek_dtype, _plan_mg,
                                  _solver_fn, _sparse_cheb_interval,
                                  _sparse_ops, _stochastic_estimate_result,
                                  _structured_forms, sparse_coo_arrays)
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    if solver in ("cheb", ":cheb", "contour_poly", ":contour_poly"):
        contour_r = None
        if solver in ("contour_poly", ":contour_poly"):
            contour_r = _contour_of(contour, fpm,
                                    lambda: feast_contour(Emin, Emax, fpm))
        return _sparse_cheb_interval(A, B, Emin, Emax, M0, fpm,
                                     hermitian=hermitian, Q0=Q0, mesh=mesh,
                                     contour=contour_r, device=device)
    solver, solver_tol, solver_maxiter = _iopts(fpm, solver, solver_tol,
                                                solver_maxiter)
    solver = _solver_fn(solver)
    if mesh is None:
        mesh = contour_mesh(n_devices)
    is_complex = np.iscomplexobj(_peek_dtype(A)) or (
        B is not None and np.iscomplexobj(_peek_dtype(B)))
    if hermitian is None:
        hermitian = is_complex
    f64 = _is_double(_peek_dtype(A).dtype)
    rdtype = np.float64 if f64 else np.float32
    cdtype = np.complex128 if f64 else np.complex64
    work = np.dtype(cdtype if hermitian else rdtype)
    A_data, A_idx, shape = sparse_coo_arrays(A, work)
    N = shape[0]
    standard = B is None
    if standard:
        B_data, B_idx = A_data, A_idx
    else:
        B_data, B_idx, _ = sparse_coo_arrays(B, work)
    (A_dia, offsets_A, B_dia, offsets_B, diagA, diagB, precond_auto, mg_A,
     mg_B) = _structured_forms(A_data, A_idx, B_data, B_idx, N, standard,
                               work, grid=grid)
    precond, mg_A, mg_B = _plan_mg(mg_A, mg_B, float(Emax), precond_auto,
                                   precond)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    if solver_tol is None:
        solver_tol = max(config.tol * 0.02, 10 * float(np.finfo(rdtype).eps))
    contour = _contour_of(contour, fpm,
                          lambda: feast_contour(Emin, Emax, fpm))
    Zl, Wl = _local_nodes(contour, mesh)
    every = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    model = MODEL_AXIS in every
    if model:
        # the JAX package's checks and texts, in its order
        if offsets_A is None or (not standard and offsets_B is None):
            raise ValueError(
                "model-axis sharding requires operators with DIA "
                "(few-diagonal/stencil) structure; got unstructured sparse")
        nm = int(mesh.size(every.index(MODEL_AXIS)))
        if N % nm != 0:
            raise ValueError(f"N={N} must divide evenly over the model axis "
                             f"({nm} shards)")
        h = max(max(abs(int(o)) for o in offsets_A), 1)
        if N // nm < h:
            raise ValueError("model shards smaller than the operator "
                             "bandwidth; reduce the model axis size")
        if config.mode == 2:
            raise NotImplementedError(
                "stochastic estimate (fpm[14]=2) on a model-sharded mesh is "
                "not supported; use a contour-only mesh")
    n_model, i_model, g_model = _axis(mesh, MODEL_AXIS)
    n_loc = N // n_model
    rows = slice(i_model * n_loc, (i_model + 1) * n_loc)
    kw = {}
    if g_model is not None:
        def make_operator(dia, offsets, dtype):
            return _halo_operator(torch.as_tensor(dia[:, rows]).to(
                device=device, dtype=dtype), offsets,
                (n_model, i_model, g_model))

        kw = dict(make_operator=make_operator, axis_name=g_model,
                  sync_axes=dist.group.WORLD, prec_gather_axis=g_model)
    record = []
    apply_A, apply_B, local_filter = _sparse_ops(
        A_data, A_idx, B_data, B_idx, A_dia, B_dia, diagA[rows],
        diagB[rows], Zl, Wl, N=n_loc, config=config, standard=standard,
        solver=solver, solver_tol=float(solver_tol),
        solver_maxiter=int(solver_maxiter),
        solver_restart=int(solver_restart), offsets_A=offsets_A,
        offsets_B=offsets_B, precond=precond, mg_A=mg_A, mg_B=mg_B,
        device=device, f64=f64, record=record,
        nodes="mirrored" if hermitian else "half", **kw)
    filter_apply = _sharded_filter(local_filter, mesh, (AXIS,),
                                   every if model else (AXIS,))
    if config.mode == 2:
        return _stochastic_estimate_result(filter_apply, N, fpm, work,
                                           device)
    Q0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, work))[rows].to(
        device)
    nsum = None if g_model is None else (lambda x: _psum(x, g_model))
    state = feast_hermitian_core(
        apply_A, apply_B, filter_apply, Q0, float(Emin), float(Emax),
        tol=config.tol, max_loops=config.max_loops,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1), nsum=nsum)
    _LAST_GATHER[:] = [None, None, 0]
    if g_model is not None:
        # every rank returns the whole basis: its rows gathered
        full = torch.zeros((N, state.Q.shape[1]), dtype=state.Q.dtype,
                           device=state.Q.device)
        full[rows] = state.Q
        dist.all_reduce(full, group=g_model)
        state = state._replace(Q=full)
    return _krylov_record(hermitian_result(state), solver=solver,
                          precond=precond, mg_A=mg_A, restart=solver_restart,
                          standard=standard, hermitian=hermitian,
                          general=False, offsets_A=offsets_A,
                          offsets_B=offsets_B, events=record)


def pfeast_sparse_general(A, B, Emid, r, M0, fpm=None, *, bilinear=False,
                          eig_method=None, contour=None, Q0=None, mesh=None,
                          n_devices=None, solver="gmres", solver_tol=None,
                          solver_maxiter=500, solver_restart=30, grid=None,
                          precond=None, device=None):
    """Sparse general / complex-symmetric FEAST with the full contour's
    nodes over the mesh's contour axis: each rank runs the serial general
    engine (``solvers/sparse._sparse_general_ops``) on its nodes, the
    partial sums meet in one all-reduce per loop with a MIN consensus of
    the inner solves' flags, and the reduced problem is solved on every
    rank. fpm[14]=2 is one filter application: the serial general driver
    serves it on every rank, as in the JAX package. ``device=None`` means
    CUDA."""
    from ..core.aux import (feast_clear_custom_contour,
                            feast_set_custom_contour)
    from ..ops.eig import check_method
    from ..solvers.sparse import (_is_double, _peek_dtype, _plan_mg,
                                  _solver_fn, _sparse_general_ops,
                                  _structured_forms, sparse_coo_arrays,
                                  sparse_feast_general)
    check_method(eig_method)
    device = resolve_device(device)
    fpm = _ensure_fpm(fpm)
    solver, solver_tol, solver_maxiter = _iopts(fpm, solver, solver_tol,
                                                solver_maxiter)
    solver = _solver_fn(solver)
    if int(fpm[14]) == 2:
        # an explicit contour rides the fpm[29] registry for the call
        scoped = contour is not None
        fpm_est = fpm.copy() if scoped else fpm
        if scoped:
            feast_set_custom_contour(fpm_est, contour)
        try:
            return sparse_feast_general(
                A, B, Emid, r, M0, fpm_est, bilinear=bilinear,
                eig_method=eig_method, solver=solver, solver_tol=solver_tol,
                solver_maxiter=solver_maxiter,
                solver_restart=solver_restart, grid=grid, precond=precond,
                device=device)
        finally:
            if scoped:
                feast_clear_custom_contour(fpm_est)
    if mesh is None:
        mesh = contour_mesh(n_devices)
    f64 = _is_double(_peek_dtype(A).dtype)
    rdtype = np.float64 if f64 else np.float32
    cdtype = np.dtype(np.complex128 if f64 else np.complex64)
    A_data, A_idx, shape = sparse_coo_arrays(A, cdtype)
    N = shape[0]
    standard = B is None
    if standard:
        B_data, B_idx = A_data, A_idx
    else:
        B_data, B_idx, _ = sparse_coo_arrays(B, cdtype)
    (A_dia, offsets_A, B_dia, offsets_B, diagA, diagB, precond_auto, mg_A,
     mg_B) = _structured_forms(A_data, A_idx, B_data, B_idx, N, standard,
                               cdtype, grid=grid)
    precond, mg_A, mg_B = _plan_mg(
        mg_A, mg_B, float(np.real(complex(Emid))) + float(r), precond_auto,
        precond)
    config = FeastConfig.from_fpm(fpm, dtype=cdtype)
    if solver_tol is None:
        solver_tol = max(config.tol * 0.1, 10 * float(np.finfo(rdtype).eps))
    contour = _contour_of(contour, fpm, lambda: feast_gcontour(
        complex(Emid), float(r), fpm))
    Zl, Wl = _local_nodes(contour, mesh)
    record = []
    apply_A, apply_B, local_filter = _sparse_general_ops(
        A_data, A_idx, B_data, B_idx, A_dia, B_dia, diagA, diagB,
        Zl, Wl, N=N, config=config, standard=standard, solver=solver,
        solver_tol=float(solver_tol), solver_maxiter=int(solver_maxiter),
        solver_restart=int(solver_restart), offsets_A=offsets_A,
        offsets_B=offsets_B, precond=precond, mg_A=mg_A, mg_B=mg_B,
        device=device, f64=f64, record=record)
    filter_apply = _sharded_filter(local_filter, mesh, (AXIS,), (AXIS,))
    Q0 = torch.as_tensor(initial_subspace(fpm, Q0, N, M0, cdtype,
                                          general=True)).to(device)
    state = feast_general_core(
        apply_A, apply_B, filter_apply, Q0, complex(Emid), float(r),
        tol=config.tol, max_loops=config.max_loops,
        aspect_ratio=config.aspect_ratio, rotation_deg=config.rotation_deg,
        convergence_criterion=config.convergence_criterion,
        subspace_only=(config.mode == 1), bilinear=bilinear)
    return _krylov_record(general_result(state), solver=solver,
                          precond=precond, mg_A=mg_A, restart=solver_restart,
                          standard=standard, hermitian=False, general=True,
                          offsets_A=offsets_A, offsets_B=offsets_B,
                          events=record)
