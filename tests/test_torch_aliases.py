"""PyTorch port: the FEAST-named aliases against the JAX package's.

Every alias name the port defines (``interfaces/aliases.py``, the
s/d/c/z, i and x names, the unprefixed x names and the parallel p-names,
all 300 of the JAX package's) is called in both packages with the drivers
that the alias modules reach through their modules' attributes replaced
by recorders (the p-names': ``parallel/pfeast.py``'s drivers and the
parallel RCI machine), no solve run: both must reach the same driver with
operands of the same dtype and shape, the same positional layout and the
same keywords (``solver``, ``hermitian``, ``bilinear``, the fpm slots, and
the custom contour an x name registers in the fpm[29] registry for the
call; the port's own ``device`` keyword aside). One parametrised case per
name. The compatibility layer's sharded names (``pfeast_sygv`` /
``pfeast_scsrgv``, the ``mpi_feast*`` family, ``feast_hybrid``) get the
same route parity, in a world of one rank (one JAX device): the sharded
drivers where the JAX package calls them, else the serial driver its
fallback reaches. Then a handful of real solves per
family (n <= 120) against the JAX package's, its solves in one child
process (this file run as a script, one core): the same M, eigenvalues
within ROADMAP.md's tolerances (real symmetric 1e-10, Hermitian 1e-9,
general 1e-7, float32 / complex64 1e-5 max(1, |lam|), the Beyn scheme
1e-8).
"""
import importlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import feastkit_tpu as ref_ft  # noqa: E402
import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu.interfaces import aliases as ref_aliases  # noqa: E402
from feastkit_tpu_torch.interfaces import aliases as port_aliases  # noqa: E402


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


NAMES = sorted(port_aliases.__all__)

# the driver attributes the alias modules call, per module
DRIVERS = {
    "solvers.dense": ("dense_hermitian_feast",),
    "solvers.dense_general": ("dense_general_feast", "feast_pep"),
    "solvers.sparse": ("sparse_feast_interval", "sparse_feast_general",
                       "feast_scsrpev"),
    "solvers.banded": ("feast_sbev", "feast_sbgv", "feast_hbev",
                       "feast_hbgv", "feast_gbev", "feast_gbgv",
                       "feast_sbev_complex", "feast_sbgv_complex"),
    "solvers.matfree": ("feast_matvec", "feast_polynomial_matvec"),
    "parallel.pfeast": ("pfeast_dense", "pfeast_sparse", "pfeast_general",
                        "pfeast_sparse_general"),
}
# the step machines an alias constructs, and the modules that bind them
MACHINES = {"FeastPolyRCI": ("kernel.rci",),
            "FeastPRCI": ("kernel.rci", "interfaces.compat")}


class _Recorded(Exception):
    pass


def _norm(pkg, x):
    """A comparable summary of an argument: arrays and tensors by kind,
    dtype and shape, operators by dtype, shape and flags, fpm by its
    slots and the contour registered under fpm[29]."""
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, torch.device):
        return str(x)
    if isinstance(x, (int, float, complex, np.number)):
        return complex(x)
    if isinstance(x, (list, tuple)):
        return [_norm(pkg, v) for v in x]
    if isinstance(x, pkg.FeastParameters):
        fpm = x.to_array().tolist()
        contour = pkg.feast_get_custom_contour(x)
        fpm[28] = 0          # the registry id differs between packages
        return ("fpm", fpm, None if contour is None
                else np.asarray(contour.Zne).round(12).tolist())
    if isinstance(x, pkg.LinearOperator):
        return ("operator", str(x.dtype).replace("torch.", ""),
                tuple(x.shape), x.symmetric, x.hermitian, x.posdef)
    if sp.issparse(x):
        return ("sparse", str(x.dtype), x.shape)
    if isinstance(x, torch.Tensor) or hasattr(x, "dtype"):
        return ("array", str(x.dtype).replace("torch.", ""),
                tuple(x.shape))
    raise TypeError(f"unexpected argument {type(x)}")


def _record(pkg, module, monkeypatch, name, args, kw):
    """Call alias ``name`` of ``pkg`` with every driver replaced by a
    recorder; returns (driver, positional summary, keyword summary)."""
    seen = []
    for mod, fns in DRIVERS.items():
        m = importlib.import_module(f"{pkg.__name__}.{mod}")
        for fn in fns:
            def rec(*a, _fn=fn, **k):
                seen.append((_fn, [_norm(pkg, v) for v in a],
                             {key: _norm(pkg, v) for key, v in k.items()}))
                raise _Recorded
            monkeypatch.setattr(m, fn, rec)
    for machine, mods in MACHINES.items():
        def rec_rci(*a, _m=machine, **k):
            seen.append((_m, [_norm(pkg, v) for v in a],
                         {key: _norm(pkg, v) for key, v in k.items()}))
            raise _Recorded
        for mod in mods:
            m = importlib.import_module(f"{pkg.__name__}.{mod}")
            if hasattr(m, machine):
                monkeypatch.setattr(m, machine, rec_rci)
    with warnings.catch_warnings():
        # a sharded request in a world of one warns before its fallback
        warnings.simplefilter("ignore", UserWarning)
        with pytest.raises(_Recorded):
            getattr(module, name)(*args, **kw)
    assert len(seen) == 1
    return seen[0]


def _parse(name):
    """(prefix, iterative, kind, form, x) of an alias name (a parallel
    p-name parses as its serial name)."""
    if name[:1] == "p" and name[1:2] in ("s", "d", "c", "z"):
        name = name[1:]
    x = name.endswith("x")
    core = name[:-1] if x else name
    head, tail = core.split("feast_")
    prefix = head[:1] if head[:1] in "sdcz" and head else ""
    if tail == "srci":
        return prefix, False, "prci", "", False
    iterative = head.endswith("i")
    for form in ("pev", "gv", "ev"):
        if tail.endswith(form):
            return prefix, iterative, tail[:-len(form)], form, x
    raise ValueError(name)


def _arguments(name):
    """Positional arguments of alias ``name`` on small operands."""
    prefix, _, kind, form, x = _parse(name)
    n = 12
    if kind == "prci" and not form:
        return [n, 4, 0.5, 1.5]
    rng = np.random.default_rng(3)
    cplx = prefix in ("c", "z") or (prefix == "" and kind not in (
        "sy", "sb", "scsr"))
    A = rng.standard_normal((n, n))
    A = A + A.T
    if cplx:
        A = A + 1j * rng.standard_normal((n, n))
    B = np.eye(n)
    interval = kind in ("he", "hb", "hcsr") or (
        kind in ("sy", "sb", "scsr") and not (prefix in ("c", "z")))
    region = (0.5, 1.5) if interval else (1.0 + 0.5j, 0.5)
    if form == "pev":
        coeffs = [A, 0.1 * B, B]
        if kind.endswith("csr"):
            coeffs = [sp.csr_matrix(c) for c in coeffs]
        args = [coeffs, 1.0 + 0.5j, 0.5, 4]
    elif kind in ("sb", "hb", "gb"):
        bands = np.stack([np.diag(A, 1).tolist() + [0.0],
                          np.diag(A).tolist(),
                          [0.0] + np.diag(A, -1).tolist()]).astype(A.dtype)
        eye = np.stack([np.zeros(n), np.ones(n), np.zeros(n)])
        args = [bands, 1, 1] + ([eye, 1, 1] if form == "gv" else []) \
            + list(region) + [4]
    else:
        op = sp.csr_matrix(A) if kind.endswith("csr") else A
        opB = sp.csr_matrix(B) if kind.endswith("csr") else B
        args = [op] + ([opB] if form == "gv" else []) + list(region) + [4]
    if x:
        c = ref_ft.feast_contour(0.5, 1.5, ref_ft.feastinit())
        args += [np.asarray(c.Zne), np.asarray(c.Wne)]
    return args


def test_alias_names_match_the_reference():
    """The port defines the JAX package's alias names, the parallel
    p-names of the sharded drivers among them; ``p{s,d}feast_srci`` are
    the compatibility layer's parallel RCI machine."""
    from feastkit_tpu_torch.interfaces import compat as port_compat
    assert set(NAMES) == set(ref_aliases.__all__)
    assert len(NAMES) == 300
    assert sum(n.startswith("p") for n in NAMES) == 42
    assert port_aliases.psfeast_srci is port_compat.psfeast_srci \
        is port_compat.pfeast_srci


@pytest.mark.parametrize("name", NAMES)
def test_alias_route_matches_reference(name, monkeypatch):
    args = _arguments(name)
    ref = _record(ref_ft, ref_aliases, monkeypatch, name, args, {})
    port = _record(ft, port_aliases, monkeypatch, name, args,
                   {"device": "cpu"})
    assert port[2].pop("device") == "cpu"
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]


# the compatibility layer's sharded names: name -> arguments
def _compat_arguments(name):
    rng = np.random.default_rng(4)
    n = 12
    A = rng.standard_normal((n, n))
    A = A + A.T
    Ac = A + 1j * (rng.standard_normal((n, n)) - 0.5)
    H = (Ac + Ac.conj().T) / 2
    sparse = "csr" in name
    op = (lambda X: sp.csr_matrix(X)) if sparse else (lambda X: X)
    B = np.eye(n)
    general = "_ge" in name or "_gcsr" in name or name.endswith("general")
    if name in ("pfeast_sygv", "pfeast_scsrgv"):
        return [op(A), op(B), 0.5, 1.5, 4]
    if name == "mpi_feast":
        return [A, (0.5, 1.5)], {"M0": 4}
    if name == "feast_hybrid":
        return [sp.csr_matrix(A), None, (0.5, 1.5), 4]
    if name == "mpi_feast_general":
        # complex symmetric: both packages pass the transpose pairing
        return [Ac + Ac.T, None, 1.0 + 0.5j, 0.5, 4]
    M = Ac if general else H
    region = [1.0 + 0.5j, 0.5] if general else [0.5, 1.5]
    if name.endswith("gv"):
        return [op(M), op(B)] + region + [4]
    return [op(M)] + region + [4]


COMPAT_SHARDED = ["pfeast_sygv", "pfeast_scsrgv", "mpi_feast",
                  "mpi_feast_general", "feast_hybrid", "mpi_feast_heev",
                  "mpi_feast_hegv", "mpi_feast_geev", "mpi_feast_gegv",
                  "mpi_feast_hcsrev", "mpi_feast_hcsrgv", "mpi_feast_gcsrev",
                  "mpi_feast_gcsrgv"]


@pytest.mark.parametrize("name", COMPAT_SHARDED)
def test_compat_sharded_route_matches_reference(name, monkeypatch):
    """In a world of one rank (the JAX package on one device): the same
    driver, operands and keywords as the JAX package's name reaches."""
    from feastkit_tpu.core import backend as ref_backend
    from feastkit_tpu.interfaces import compat as ref_compat
    from feastkit_tpu_torch.interfaces import compat as port_compat
    monkeypatch.setattr(ref_backend, "_n_devices", lambda: 1)
    args = _compat_arguments(name)
    args, kw = args if isinstance(args, tuple) else (args, {})
    ref = _record(ref_ft, ref_compat, monkeypatch, name, args, dict(kw))
    port = _record(ft, port_compat, monkeypatch, name, args,
                   dict(kw, device="cpu"))
    assert port[2].pop("device") == "cpu"
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]


# ---------------------------------------------------------------------------
# real solves, one or two per family, against the JAX package's
# ---------------------------------------------------------------------------

def _lap(n):
    return (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
            + np.diag(-np.ones(n - 1), -1))


def _bands(n):
    b = np.zeros((3, n))
    b[0, 1:] = -1.0
    b[1] = 2.0
    b[2, :-1] = -1.0
    return b


def _general(n=60):
    rng = np.random.default_rng(0)
    return np.diag(np.arange(1.0, n + 1)) + 0.01 * rng.standard_normal((n, n))


def _quadratic():
    return [np.diag(np.arange(1.0, 11.0)), 0.1 * np.eye(10), np.eye(10)]


# name -> (arguments, tolerance, relative)
SOLVES = {
    "dfeast_syev": (lambda: [_lap(60), 0.5, 1.5, 16], 1e-10, False),
    "sfeast_syev": (lambda: [_lap(60), 0.5, 1.5, 16], 1e-5, True),
    "zfeast_heev": (lambda: [_lap(60).astype(complex), 0.5, 1.5, 16], 1e-9,
                    False),
    "dfeast_sbev": (lambda: [_bands(120), 1, 1, 0.5, 0.8, 16], 1e-10, False),
    "dfeast_scsrev": (lambda: [sp.csr_matrix(_lap(120)), 0.5, 0.8, 16],
                      1e-10, False),
    "zfeast_geev": (lambda: [_general(), 10.0, 2.5, 10], 1e-7, False),
    "cfeast_geev": (lambda: [_general(), 10.0, 2.5, 10], 1e-5, True),
    "zfeast_syev": (lambda: [(_general() + _general().T) / 2
                             + 0.01j * np.eye(60), 10.0, 2.5, 10], 1e-7,
                    False),
    "zfeast_gepev": (lambda: [_quadratic(), 2.0j, 1.0, 8], 1e-7, False),
    "difeast_syev": (lambda: [_lap(60), 0.5, 1.5, 16], 1e-10, False),
    "difeast_scsrev": (lambda: [sp.csr_matrix(_lap(60)), 0.5, 1.5, 16],
                       1e-10, False),
    "zifeast_gepev": (lambda: [_quadratic(), 2.0j, 1.0, 8], 1e-7, False),
    "dfeast_syevx": (lambda: [_lap(60), 0.5, 1.5, 16] + list(
        _contour_nodes()), 1e-10, False),
    "zfeast_grcipev": (lambda: [_quadratic(), 2.0j, 1.0, 8], 1e-8, False),
}


def _contour_nodes():
    c = ref_ft.feast_contour(0.5, 1.5, ref_ft.feastinit())
    return np.asarray(c.Zne), np.asarray(c.Wne)


# the JAX solves in two children: the i names (Krylov), the rest
CHILDREN = (sorted(n for n in SOLVES if "ifeast" in n),
            sorted(n for n in SOLVES if "ifeast" not in n))


def _write_reference(path, child):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {}
    for name in CHILDREN[child]:
        r = getattr(ref_ft, name)(*SOLVES[name][0]())
        out[f"{name}/M"] = r.M
        out[f"{name}/lam"] = np.asarray(r.lam)
    np.savez(path, **out)


# small solves: XLA's compile is most of their time
_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")
_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(sys.argv[1])}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _reference_command(path, child):
    """This file as a script on ``path`` for CHILDREN[child], kept to one
    core, the last or the second from last of this process's set."""
    args = [__file__, str(path), str(child)]
    if not hasattr(os, "sched_setaffinity"):
        return [sys.executable] + args
    cpus = sorted(os.sched_getaffinity(0))
    cpu = cpus[-1 - child] if len(cpus) > child else cpus[-1]
    return [sys.executable, "-c", _CHILD, str(cpu)] + args


@pytest.fixture(scope="module")
def solves(tmp_path_factory):
    """(reference, port) of SOLVES: the JAX package's in two child
    processes of one core each, the port's here meanwhile."""
    where = tmp_path_factory.mktemp("alias_reference")
    paths = [where / f"ref{i}.npz" for i in range(len(CHILDREN))]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        XLA_FLAGS=" ".join(filter(None, (os.environ.get("XLA_FLAGS"),
                                         _FAST_COMPILE))))
    children = [subprocess.Popen(_reference_command(path, i), env=env)
                for i, path in enumerate(paths)]
    try:
        port = {name: getattr(ft, name)(*args(), device="cpu")
                for name, (args, _, _) in SOLVES.items()}
        for child in children:
            assert child.wait(timeout=600) == 0, \
                "the reference solves failed"
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    ref = {}
    for path in paths:
        with np.load(path) as z:
            ref.update(z)
    return ref, port


def _match_err(got, exp, rel=False):
    from scipy.optimize import linear_sum_assignment
    got, exp = np.asarray(got), np.asarray(exp)
    assert len(got) == len(exp)
    if len(got) == 0:
        return 0.0
    D = np.abs(got[:, None] - exp[None, :])
    if rel:
        D = D / np.maximum(1.0, np.abs(exp))[None, :]
    ri, ci = linear_sum_assignment(D)
    return D[ri, ci].max()


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_alias_solve_matches_reference(solves, name):
    ref, port = solves
    _, tol, rel = SOLVES[name]
    r = port[name]
    assert r.M == int(ref[f"{name}/M"]) > 0
    assert _match_err(r.lam, ref[f"{name}/lam"], rel) <= tol


if __name__ == "__main__":
    _write_reference(sys.argv[1], int(sys.argv[2]))
