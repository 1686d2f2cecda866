"""PyTorch port: the public surface against the JAX package's.

Export parity: the port's public names are the JAX package's and its two
extra names, and ``feastkit_tpu_torch.parallel`` imports; the names of the
sharded drivers (``ITEM_15``) each reach the JAX package's
``parallel/pfeast.py`` or a device mesh, and the port's own
``parallel/pfeast.py`` or a mesh over the ranks; the FeastKit.jl export
list of tests/test_compat_surface.py resolves on the port. Then, against
the JAX package on the same inputs: the validation, info, memory and count helpers of ``core/aux.py``,
the backend reports, the ``Feast_*`` constants and their deprecated
spellings, ``feast_name``, ``feastinit_driver`` and ``feast_set_defaults``
(equal values and texts); the compatibility layer (workspaces, the RCI
constructors and x forms, the parallel RCI machine serviced by
``pfeast_compute_all_contour_points``, the matrix-free RCI drivers, the
info helpers and the backend conveniences: eigenvalues within 1e-10 of
the exact ones); checkpoints across the packages: the JAX package saves
and the port resumes, the port saves and the JAX package resumes, with
loop <= 1 and eigenvalues within 1e-12 of the saved run's
(tests/test_utils.py:13-26), the JAX package's solves in a child process
(this file run as a script, one core); and ``FeastTimer``,
``phase_timer``, ``feast_benchmark`` and ``trace_to``.
"""
import importlib
import inspect
import io
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import feastkit_tpu as ref_ft  # noqa: E402
import feastkit_tpu_torch as ft  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool and numpy's / scipy's OpenBLAS pools
    # would starve their neighbours
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


# the sharded drivers and what reaches them
ITEM_15 = sorted("""
parallel contour_mesh contour_model_mesh contour_rhs_mesh pfeast_dense
pfeast_general pfeast_sparse pfeast_sparse_general pfeast_sygv pfeast_scsrgv
MPIFeastState feast_hybrid mpi_feast mpi_feast_general mpi_feast_heev
mpi_feast_hegv mpi_feast_geev mpi_feast_gegv mpi_feast_hcsrev
mpi_feast_hcsrgv mpi_feast_gcsrev mpi_feast_gcsrgv
psfeast_syev psfeast_sygv psfeast_scsrev psfeast_scsrgv
pdfeast_syev pdfeast_sygv pdfeast_scsrev pdfeast_scsrgv
pcfeast_heev pcfeast_hegv pcfeast_geev pcfeast_gegv pcfeast_hcsrev
pcfeast_hcsrgv pcfeast_gcsrev pcfeast_gcsrgv
pzfeast_heev pzfeast_hegv pzfeast_geev pzfeast_gegv pzfeast_hcsrev
pzfeast_hcsrgv pzfeast_gcsrev pzfeast_gcsrgv
pcifeast_heev pcifeast_hegv pcifeast_geev pcifeast_gegv pcifeast_hcsrev
pcifeast_hcsrgv pcifeast_gcsrev pcifeast_gcsrgv
pzifeast_heev pzifeast_hegv pzifeast_geev pzifeast_gegv pzifeast_hcsrev
pzifeast_hcsrgv pzifeast_gcsrev pzifeast_gcsrgv
""".split())


def _public(pkg):
    """The package's public names, less its subpackages and modules (which
    appear as attributes once anything imports them)."""
    return {n for n in dir(pkg) if not n.startswith("_")
            and not isinstance(getattr(pkg, n), types.ModuleType)}


def _reaches_item_15(obj):
    """Whether the JAX package's ``obj`` runs a sharded driver or builds a
    device mesh: the module ``parallel``, a function of
    ``parallel/pfeast.py``, or a body that imports from it or turns a
    communicator into a mesh."""
    if isinstance(obj, types.ModuleType):
        return obj.__name__ == "feastkit_tpu.parallel"
    if getattr(obj, "__module__", "") == "feastkit_tpu.parallel.pfeast":
        return True
    src = inspect.getsource(obj)
    return "parallel.pfeast import" in src or "_mesh_from_comm(" in src


def _reaches_port_drivers(obj):
    """Whether the port's ``obj`` runs its sharded drivers or builds a mesh
    over the ranks (the module ``parallel``, a function of
    ``parallel/pfeast.py``, or a body that calls it or turns a communicator
    into a mesh, by ``_mesh_from_comm`` or ``_mpi_kw``)."""
    if isinstance(obj, types.ModuleType):
        return obj.__name__ == "feastkit_tpu_torch.parallel"
    if getattr(obj, "__module__", "") == \
            "feastkit_tpu_torch.parallel.pfeast":
        return True
    src = inspect.getsource(obj)
    return ("parallel.pfeast import" in src or "_mesh_from_comm(" in src
            or "_mpi_kw(" in src or "getattr(_pf, driver)" in src)


def test_exports_match_reference_less_item_15():
    """The port exports every public name of the JAX package (the sharded
    drivers' among them) and its own two; ``parallel`` imports."""
    ref, port = _public(ref_ft), _public(ft)
    assert ref - port == set()
    # the port's two extra names: its sparse drivers under their own names
    assert port - ref == {"sparse_feast_general", "sparse_feast_interval"}
    assert set(ft.__all__) == port
    # the JAX package's subpackages and modules, ``parallel`` among them
    for name in dir(ref_ft):
        if isinstance(getattr(ref_ft, name), types.ModuleType) \
                and not name.startswith("_"):
            importlib.import_module(f"feastkit_tpu_torch.{name}")
    assert importlib.import_module("feastkit_tpu_torch.parallel")


@pytest.mark.parametrize("name", ITEM_15)
def test_item_15_names_reach_the_sharded_drivers(name):
    assert _reaches_item_15(getattr(ref_ft, name)), name
    port = importlib.import_module("feastkit_tpu_torch.parallel") \
        if name == "parallel" else getattr(ft, name)
    assert _reaches_port_drivers(port), name


def test_reference_exports_resolve():
    """tests/test_compat_surface.py's FeastKit.jl export list, the sharded
    names among them."""
    from test_compat_surface import REFERENCE_EXPORTS
    missing = [n for n in REFERENCE_EXPORTS if not hasattr(ft, n)]
    assert not missing
    assert [n for n in REFERENCE_EXPORTS if n in ITEM_15]


def test_device_defaults_to_cuda():
    """Every public entry point with a ``device`` parameter defaults it to
    None, which means CUDA: the new ones refuse to run without a card."""
    for name in ft.__all__:
        obj = getattr(ft, name)
        try:
            params = inspect.signature(obj).parameters
        except (TypeError, ValueError):
            continue
        if "device" in params:
            assert params["device"].default is None, name
    from feastkit_tpu_torch.solvers.banded import identity_bands
    assert inspect.signature(identity_bands).parameters[
        "device"].default is None
    if torch.cuda.is_available():
        return
    A = np.eye(4)
    for call in (lambda: ft.dfeast_syev(A, 0.5, 1.5, 2),
                 lambda: ft.difeast_syev(A, 0.5, 1.5, 2),
                 lambda: ft.zfeast_grcipev([A, A], 0.0, 1.0, 2),
                 lambda: ft.FeastWorkspaceReal(4, 2),
                 lambda: ft.allocate_matfree_workspace(np.float64, 4, 2),
                 lambda: ft.pfeast_srci(4, 2, 0.5, 1.5),
                 lambda: ft.feast_parallel(A, None, (0.5, 1.5), 2),
                 lambda: ft.feast_estimate_count(lambda V: V, 4, (0, 1)),
                 lambda: ft.eigvals_feast(A, (0.5, 1.5), M0=2),
                 lambda: ft.pfeast_dense(A, None, 0.5, 1.5, 2),
                 lambda: ft.pfeast_general(A, None, 1.0, 0.5, 2),
                 lambda: ft.pfeast_sparse(sp.csr_matrix(A), None, 0.5, 1.5,
                                          2),
                 lambda: ft.pfeast_sparse_general(sp.csr_matrix(A), None,
                                                  1.0, 0.5, 2),
                 lambda: ft.pdfeast_syev(A, 0.5, 1.5, 2),
                 lambda: ft.pfeast_sygv(A, None, 0.5, 1.5, 2),
                 lambda: ft.mpi_feast(A, (0.5, 1.5), M0=2),
                 lambda: ft.mpi_feast_heev(A, 0.5, 1.5, 2),
                 lambda: ft.feast_hybrid(A, (0.5, 1.5), M0=2),
                 lambda: identity_bands(4, 1, 1, torch.float64)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# aux, backend, deprecations, names and defaults
# ---------------------------------------------------------------------------

def _raises(fn, *a, **k):
    try:
        fn(*a, **k)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("args", [
    (0, 4, {}), (10, 0, {}), (10, 11, {}), (10, 4, dict(Emin=1.0, Emax=0.5)),
    (10, 4, dict(r=0.0)), (10, 4, dict(Emin=0.0, Emax=1.0, r=1.0))])
def test_check_feast_input_matches_reference(args):
    N, M0, kw = args
    assert _raises(ft.core.aux.check_feast_input, N, M0, **kw) == \
        _raises(ref_ft.core.aux.check_feast_input, N, M0, **kw)


def test_validate_contour_matches_reference():
    c = ref_ft.feast_contour(0.0, 1.0, ref_ft.feastinit())
    for Z, W in ((c.Zne, c.Wne), (c.Zne[:3], c.Wne[:4]),
                 (np.r_[c.Zne[:3], np.nan], c.Wne[:4]),
                 (np.r_[c.Zne[:2], c.Zne[:2]], c.Wne[:4]),
                 (np.zeros(0), np.zeros(0))):
        assert _raises(ft.validate_contour, ft.Contour(Z, W)) == \
            _raises(ref_ft.validate_contour, ref_ft.Contour(Z, W))
    assert ft.validate_contour(ft.Contour(c.Zne, c.Wne)) is True


@pytest.mark.parametrize("kw", [{}, dict(dense=False),
                                dict(store_factorization=False,
                                     dtype=np.float32)])
def test_memory_estimate_matches_reference(kw):
    assert ft.feast_memory_estimate(1000, 24, 8, **kw) == \
        ref_ft.feast_memory_estimate(1000, 24, 8, **kw)


def _result(pkg, lam, general=False):
    cls = pkg.FeastGeneralResult if general else pkg.FeastResult
    q = torch.zeros((5, len(lam))) if pkg is ft else np.zeros((5, len(lam)))
    return cls(np.asarray(lam), q, len(lam), np.full(len(lam), 1e-13),
               pkg.FeastError.SUCCESS, 1e-13, 3)


@pytest.mark.parametrize("general", [False, True])
def test_info_and_trace_text_match_reference(general):
    lam = [0.5 + 0.1j, 1.25 - 0.2j] if general else [0.5, 1.25, 2.0]
    texts = []
    for pkg in (ref_ft, ft):
        buf = io.StringIO()
        r = _result(pkg, lam, general)
        pkg.feast_info(r, file=buf)
        pkg.feast_info(r, fpm=[0] + [-111] * 63, file=buf)   # print level 0
        pkg.feast_trace_eigenvalues(r, file=buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "FEAST run info" in texts[1]


def test_clear_all_contours():
    fpm = ft.feastinit()
    c = ft.feast_contour(0.0, 1.0, fpm)
    ft.feast_set_custom_contour(fpm, c)
    assert ft.feast_get_custom_contour(fpm) is not None
    ft.feast_clear_all_contours()
    assert ft.feast_get_custom_contour(fpm) is None


def test_estimate_count_matches_reference():
    """The Hutchinson count on a caller's filter: the same probes in both
    packages (a projector onto the first 7 coordinates: trace 7)."""
    def proj(V):
        out = V * 0
        out[:7] = V[:7]
        return out
    ref = ref_ft.feast_estimate_count(proj, 60, (0.0, 1.0), trials=30,
                                      seed=5)
    port = ft.feast_estimate_count(proj, 60, (0.0, 1.0), trials=30, seed=5,
                                   device="cpu")
    assert port == ref
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ft.feast_estimate_count(proj, 60, (0.0, 1.0))


def test_backend_reports():
    for b in ("auto", "serial", "sharded", "threads", ":mpi"):
        assert ft.determine_parallel_backend(b) == "serial"
    with pytest.raises(ValueError, match="Unknown backend"):
        ft.determine_parallel_backend("gpu-cluster")
    caps = ft.feast_parallel_capabilities()
    assert caps["backends"] == {"serial": True, "sharded": False}
    if not torch.cuda.is_available():
        assert caps["n_devices"] == 1 and caps["platform"] == "cpu"
    buf = io.StringIO()
    assert ft.feast_parallel_info(file=buf) == caps
    assert "backend sharded : unavailable" in buf.getvalue()
    # the JAX package's report has the same keys, and the port's the ranks
    assert set(ref_ft.feast_parallel_capabilities()) | {"n_ranks"} \
        == set(caps)
    assert caps["n_ranks"] == 1 and "ranks         : 1" in buf.getvalue()
    with pytest.warns(UserWarning, match="single device"):
        assert ft.select_parallel_backend("sharded", "cpu") == "serial"


def test_deprecated_constants_match_reference():
    from feastkit_tpu import deprecations as ref_dep
    from feastkit_tpu_torch import deprecations as port_dep
    names = [n for n in dir(ref_dep) if n.startswith("Feast_")]
    assert names == [n for n in dir(port_dep) if n.startswith("Feast_")]
    for n in names:
        assert int(getattr(port_dep, n)) == int(getattr(ref_dep, n))
        assert int(getattr(ft, n)) == int(getattr(ref_ft, n))
        legacy = n.replace("Feast_", "FEAST_", 1)
        with pytest.warns(DeprecationWarning, match=legacy):
            assert getattr(port_dep, legacy) == getattr(port_dep, n)
    with pytest.raises(AttributeError):
        getattr(port_dep, "FEAST_NOT_A_NAME")


@pytest.mark.parametrize("code", [121112, 241225, 232343, 143356, 212446,
                                  131457, 222512, 0, 999999])
def test_feast_name_matches_reference(code):
    assert ft.feast_name(code) == ref_ft.feast_name(code)


def test_defaults_helpers_match_reference():
    for N in (0, 10, 400, 10 ** 6):
        assert np.array_equal(ft.feastinit_driver(N).to_array(),
                              ref_ft.feastinit_driver(N).to_array())
    kw = dict(nodes=12, tol_exp=9, max_loops=7, print_level=1,
              quadrature=2, aspect_ratio=0.55, full_nodes=24)
    assert np.array_equal(ft.feast_set_defaults(**kw).to_array(),
                          ref_ft.feast_set_defaults(**kw).to_array())
    base = ref_ft.feastinit()
    base[4] = 3
    assert np.array_equal(
        ft.feast_set_defaults(base.to_array(), nodes=4).to_array(),
        ref_ft.feast_set_defaults(base, nodes=4).to_array())
    assert ft.FEAST_UNINITIALIZED == ref_ft.FEAST_UNINITIALIZED
    fpm = ft.feastinit()
    ft.core.parameters.feastdefault(fpm)
    for dt in (np.float32, np.float64):
        assert ft.feast_tolerance(fpm, dt) == ref_ft.feast_tolerance(
            ref_ft.FeastParameters(fpm.to_array()), dt)
    assert np.array_equal(ft.seeded_subspace(30, 6, np.float64),
                          ref_ft.seeded_subspace(30, 6, np.float64))
    zp, zr = ft.zolotarev_quadrature(8), ref_ft.zolotarev_quadrature(8)
    for a, b in zip(zp, zr):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the compatibility layer
# ---------------------------------------------------------------------------

def _lap(n):
    return (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
            + np.diag(-np.ones(n - 1), -1))


def _lap_eigs(n, lo=0.5, hi=1.5):
    w = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    return np.sort(w[(w >= lo) & (w <= hi)])


def test_workspaces_match_reference():
    for cls in ("FeastWorkspaceReal", "FeastWorkspaceComplex"):
        for dt in (np.float32, np.float64):
            ref = getattr(ref_ft, cls)(30, 6, dt)
            port = getattr(ft, cls)(30, 6, dt, device="cpu")
            for k, v in vars(ref).items():
                p = getattr(port, k)
                if isinstance(v, np.ndarray):
                    assert tuple(p.shape) == v.shape
                    assert str(p.dtype).replace("torch.", "") == str(v.dtype)
                else:
                    assert p == v
    for dt in (np.float64, np.complex64):
        ref = ref_ft.allocate_matfree_workspace(dt, 30, 6)
        port = ft.allocate_matfree_workspace(dt, 30, 6, device="cpu")
        assert set(port) == set(ref)
        for k in ref:
            assert tuple(port[k].shape) == ref[k].shape
            assert str(port[k].dtype).replace("torch.", "") == \
                str(ref[k].dtype)
    assert ft.MatrixFreeOperator is ft.LinearOperator


def _drive_port(st, A):
    """Service a port step machine with torch LU on the CPU."""
    At = torch.as_tensor(A, dtype=torch.complex128)
    n = A.shape[0]
    job, guard, lu = st.step(), 0, None
    while job != ft.FeastRCIJob.DONE:
        guard += 1
        assert guard < 500
        if job == ft.FeastRCIJob.FACTORIZE:
            lu = torch.linalg.lu_factor(st.Ze * torch.eye(
                n, dtype=torch.complex128) - At)
        elif job == ft.FeastRCIJob.SOLVE:
            st.workc = torch.linalg.lu_solve(*lu, st.workc.to(At.dtype))
        elif job == ft.FeastRCIJob.PARALLEL_SOLVE:
            ft.pfeast_compute_all_contour_points(st, A)
        elif job == ft.FeastRCIJob.MULT_A:
            st.workc = (At @ st.workc.to(At.dtype)).to(st.workc.dtype)
        elif job == ft.FeastRCIJob.MULT_B:
            pass
        job = st.step()
    return st


def test_rci_constructors_and_parallel_machine():
    n = 40
    A = _lap(n)
    exp = _lap_eigs(n)
    st = ft.feast_srci(n, 10, 0.5, 1.5, standard_B=True, device="cpu")
    assert isinstance(st, ft.FeastSRCIState)
    assert ft.ifeast_srci is ft.feast_srci
    assert isinstance(ft.feast_grci(n, 10, 1.0 + 0j, 0.5, device="cpu"),
                      ft.FeastGRCIState)
    assert isinstance(ft.feast_hrci(n, 10, 0.5, 1.5, device="cpu"),
                      ft.FeastHRCIState)
    theta = np.pi * (2 * np.arange(8) + 1) / 8
    stx = ft.feast_srcix(n, 10, 0.5, 1.5, ft.feastinit(),
                         1.0 + 0.6 * np.exp(1j * theta),
                         np.full(8, 0.25 + 0j), device="cpu")
    assert len(stx.contour.Zne) == 8
    for make in (ft.pfeast_srci, ft.pdfeast_srci, ft.psfeast_srci):
        st = _drive_port(make(n, len(exp) + 3, 0.5, 1.5, standard_B=True,
                              device="cpu"), A)
        assert isinstance(st, ft.ParallelFeastState)
        assert st.M == len(exp) and int(st.info) == 0
        assert np.abs(np.sort(np.asarray(st.lam)[:st.M]) - exp).max() \
            < 1e-10
    assert ft.distribute_contour_points(8, 3) == \
        ref_ft.distribute_contour_points(8, 3)
    assert ft.distribute_contour_points(2, 8) == \
        ref_ft.distribute_contour_points(2, 8)
    texts = []
    for pkg in (ref_ft, ft):
        buf = io.StringIO()
        pkg.pfeast_show_distribution(8, n_devices=3, file=buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]


def test_matfree_rci_drivers():
    n = 80
    A = _lap(n)
    exp = _lap_eigs(n)
    op = ft.LinearOperator.from_matrix(A, symmetric=True)
    r = ft.feast_matfree_srci(op, None, (0.5, 1.5), len(exp) + 3,
                              tol=1e-10, maxiter=25, device="cpu")
    assert r.M == len(exp) and np.abs(np.sort(r.lam) - exp).max() < 1e-8
    D = np.diag(np.arange(1.0, 31.0))
    Dt = torch.as_tensor(D, dtype=torch.complex128)

    def solve(z, R):
        return torch.linalg.solve(z * torch.eye(30, dtype=Dt.dtype) - Dt,
                                  R.to(Dt.dtype))
    rg = ft.feast_matfree_grci(ft.LinearOperator.from_matrix(D), None,
                               5.0 + 0j, 2.5, 8, linear_solver=solve,
                               device="cpu")
    assert rg.M == 5
    assert np.abs(np.sort(rg.lam.real) - np.arange(3.0, 8.0)).max() < 1e-10


def test_info_helpers_and_backend_conveniences():
    Asp = sp.diags([2.0 * np.ones(8), -np.ones(7), -np.ones(7)],
                   [0, 1, -1], format="csr")
    for A in (Asp, Asp.toarray(), sp.csr_matrix((5, 5))):
        ref = ref_ft.feast_sparse_info(A, file=io.StringIO())
        assert ft.feast_sparse_info(A, file=io.StringIO()) == ref
    assert ft.feast_sparse_info(torch.as_tensor(Asp.toarray()).to_sparse(),
                                file=io.StringIO())[:2] == (8, 22)
    bands = ft.full_to_general_banded(Asp.toarray(), 2, 1)
    assert np.array_equal(bands, ref_ft.full_to_general_banded(
        Asp.toarray(), 2, 1))
    assert ft.feast_banded_info(bands, 1, 8, file=io.StringIO()) == \
        ref_ft.feast_banded_info(bands, 1, 8, file=io.StringIO())
    c = ft.feast_contour(-1.0, 1.0, ne=8)
    lam = np.array([0.0, 2.5, -0.9])
    assert np.allclose(ft.feast_rational_expert(c.Zne, c.Wne, lam),
                       ref_ft.feast_rational_expert(c.Zne, c.Wne, lam),
                       rtol=1e-14, atol=1e-15)
    assert ft.check_feast_srci_input(60, 10, 0.5, 1.5) is True
    with pytest.raises(ValueError):
        ft.check_feast_srci_input(60, 0, 0.5, 1.5)
    assert ft.mpi_available() is ref_ft.mpi_available() is True
    n = 60
    A = _lap(n)
    exp = _lap_eigs(n)
    M0 = len(exp) + 3
    for r in (ft.feast_serial(A, None, (0.5, 1.5), M0, device="cpu"),
              ft.feast_parallel(A, None, (0.5, 1.5), M0, device="cpu")):
        assert r.M == len(exp) and np.abs(np.sort(r.lam) - exp).max() < 1e-10
    with pytest.warns(UserWarning, match="single device"):
        r = ft.feast_with_backend("threads", A, None, (0.5, 1.5), M0,
                                  device="cpu")
    assert r.M == len(exp)
    lam = ft.eigvals_feast(A, (0.5, 1.5), M0=M0, device="cpu")
    assert np.abs(np.sort(lam) - exp).max() < 1e-10
    lam, q = ft.eigen_feast(A, (0.5, 1.5), M0=M0, device="cpu")
    assert isinstance(q, torch.Tensor) and tuple(q.shape) == (n, len(exp))


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

CK_N, CK_M0, CK_REGION = 60, 14, (0.5, 1.5)


def _write_reference(where):
    """The JAX package's side: a solve and its checkpoint, and the resume
    of the port's checkpoint (written before this child starts)."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    A = _lap(CK_N)
    r = ref_ft.feast_syev(A, *CK_REGION, CK_M0)
    ref_ft.save_checkpoint(os.path.join(where, "jax.npz"), r,
                           ref_ft.feastinit(), CK_REGION)
    ck = ref_ft.load_checkpoint(os.path.join(where, "port.npz"))
    r2 = ref_ft.feast_syev(A, *CK_REGION, CK_M0, **ref_ft.resume_kwargs(ck))
    np.savez(os.path.join(where, "out.npz"), lam=np.asarray(r.lam),
             resumed_lam=np.asarray(r2.lam), resumed_loop=r2.loop,
             resumed_M=r2.M)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    where = tmp_path_factory.mktemp("checkpoints")
    A = _lap(CK_N)
    port = ft.feast_syev(A, *CK_REGION, CK_M0, device="cpu")
    ft.save_checkpoint(where / "port.npz", port, ft.feastinit(), CK_REGION)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (
            os.environ.get("XLA_FLAGS"),
            "--xla_backend_optimization_level=0 "
            "--xla_llvm_disable_expensive_passes=true"))))
    cmd = [sys.executable, __file__, str(where)]
    if hasattr(os, "sched_setaffinity"):
        cpu = sorted(os.sched_getaffinity(0))[-5 % max(
            1, len(os.sched_getaffinity(0)))]
        cmd = [sys.executable, "-c",
               "import os, runpy, sys; "
               "os.sched_setaffinity(0, {int(sys.argv[1])}); "
               "sys.argv = sys.argv[2:]; "
               "runpy.run_path(sys.argv[0], run_name='__main__')",
               str(cpu), __file__, str(where)]
    assert subprocess.run(cmd, env=env, timeout=600).returncode == 0
    with np.load(where / "out.npz") as z:
        ref = dict(z)
    return where, port, ref


def test_reference_checkpoint_resumes_in_port(checkpoints):
    where, _, ref = checkpoints
    ck = ft.load_checkpoint(where / "jax.npz")
    assert ck.Q.shape == (CK_N, CK_M0) and ck.kind == "interval"
    assert ck.region == CK_REGION
    r2 = ft.feast_syev(_lap(CK_N), *CK_REGION, CK_M0,
                       **ft.resume_kwargs(ck), device="cpu")
    assert r2.loop <= 1 and r2.M == len(ref["lam"])
    assert np.abs(np.sort(r2.lam) - np.sort(ref["lam"])).max() < 1e-12


def test_port_checkpoint_resumes_in_reference(checkpoints):
    where, port, ref = checkpoints
    assert int(ref["resumed_loop"]) <= 1
    assert int(ref["resumed_M"]) == port.M
    assert np.abs(np.sort(ref["resumed_lam"]) - np.sort(port.lam)).max() \
        < 1e-12
    # the port's file has the JAX package's layout
    with np.load(where / "port.npz") as z, \
            np.load(where / "jax.npz") as zr:
        assert sorted(z.files) == sorted(zr.files)
        for k in z.files:
            assert z[k].dtype.kind == zr[k].dtype.kind
            assert z[k].shape == zr[k].shape


def test_port_checkpoint_round_trip(tmp_path):
    """A checkpoint saved and resumed in the port, from a result whose
    basis is a tensor: loop <= 1, eigenvalues within 1e-12."""
    A = _lap(CK_N)
    r = ft.feast_syev(A, *CK_REGION, CK_M0, device="cpu")
    assert isinstance(r.q_full, torch.Tensor)
    ft.save_checkpoint(tmp_path / "ck.npz", r, ft.feastinit(), CK_REGION)
    ck = ft.load_checkpoint(tmp_path / "ck.npz")
    assert isinstance(ck, ft.FeastCheckpoint) and ck.loop == r.loop
    kw = ft.resume_kwargs(ck)
    assert kw["fpm"][5] == 1
    r2 = ft.feast_syev(A, *CK_REGION, CK_M0, **kw, device="cpu")
    assert r2.loop <= 1 and r2.M == r.M
    assert np.abs(np.sort(r2.lam) - np.sort(r.lam)).max() < 1e-12


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_timers_and_benchmark():
    t = ft.FeastTimer()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    buf = io.StringIO()
    phases = t.report(file=buf)
    assert set(phases) == {"a", "b"} and "total" in buf.getvalue()
    buf = io.StringIO()
    with ft.phase_timer("x", file=buf):
        pass
    with ft.phase_timer("y", print_level=0, file=buf):
        pass
    assert buf.getvalue().startswith("[feast] x:") and "y" not in \
        buf.getvalue()
    calls = []
    out = ft.feast_benchmark(lambda v: calls.append(v), 1, warmup=2,
                             repeats=3)
    assert len(calls) == 5 and out["repeats"] == 3
    assert 0 <= out["min_s"] <= out["mean_s"]
    A = _lap(40)
    with pytest.warns(UserWarning, match="single device"):
        cmp = ft.feast_parallel_comparison(A, None, (0.5, 1.5), 12,
                                           file=io.StringIO(), device="cpu")
    assert cmp["serial"]["M"] == cmp["sharded"]["M"] == len(_lap_eigs(40))


def test_trace_to_writes_a_trace(tmp_path):
    import json
    import time
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(20, 20))
    A2 = (sp.kron(sp.eye(20), T) + sp.kron(T, sp.eye(20))).tocsr()
    t0 = time.time_ns()
    with ft.trace_to(str(tmp_path)) as prof:
        ft.feast_syev(_lap(40), 0.5, 1.5, 12, device="cpu")
        r = ft.feast(A2, None, (0.0, 0.3), 16, device="cpu")
    t1 = time.time_ns()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("lu" in e.key for e in prof.key_averages())
    # the port's spans of the block beside it, and tracing off again
    from feastkit_tpu_torch.utils import trace
    assert not trace.enabled() and r.M > 0
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)["spans"]
    by_index = {s["index"]: s for s in spans}
    assert spans[0]["name"] == "feast" and spans[0]["parent"] is None
    assert spans[0]["attrs"]["path"] == "cheb"
    assert spans[0]["attrs"]["N"] == 400 and spans[0]["attrs"]["M0"] == 16
    assert {"route", "route.coeffs", "q0", "result"} <= {
        s["name"] for s in spans}
    for s in spans:
        assert s["solve"] == spans[0]["solve"]
        assert t0 <= s["start_ns"] <= s["end_ns"] <= t1
        assert s is spans[0] or s["parent"] in by_index


@pytest.mark.parametrize("was_on", [False, True])
def test_trace_to_leaves_the_span_list_as_it_found_it(tmp_path, was_on):
    """trace_to forgets its block's spans where tracing was off before the
    block and keeps them where it was on; a ``trace.clear()`` inside the
    block leaves ``spans.json`` the spans recorded after it."""
    import json
    from feastkit_tpu_torch.utils import trace
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(12, 12))
    A = (sp.kron(sp.eye(12), T) + sp.kron(T, sp.eye(12))).tocsr()
    trace.clear()
    if was_on:
        trace.enable()
    try:
        with ft.trace_to(str(tmp_path)):
            ft.feast(A, None, (0.0, 0.6), 12, device="cpu")
            trace.clear()
            r = ft.feast(A, None, (0.0, 0.6), 12, device="cpu")
        assert trace.enabled() is was_on and r.M > 0
        left = [s.as_dict() for s in trace.spans()]
    finally:
        trace.disable()
        trace.clear()
    with open(tmp_path / "spans.json") as f:
        spans = json.load(f)["spans"]
    assert spans[0]["name"] == "feast" and spans[0]["index"] == 0
    assert {s["solve"] for s in spans} == {spans[0]["solve"]}
    assert left == (spans if was_on else [])


if __name__ == "__main__":
    _write_reference(sys.argv[1])
