"""PyTorch port: the sharded drivers (``parallel/pfeast.py``) on the CPU, in
a 4-rank gloo world, against the port's serial drivers and the JAX
package's sharded drivers.

One world of four ranks serves the whole module: a module fixture starts
this file as a script four times (one process per rank, torch and the BLAS
pools pinned to one thread), each rank joins the default group through a
file store (``init_process_group(..., timeout=60 s)``) and runs the legs
of ``__graft_entry__.dryrun_multichip`` at its shapes (the n = 64
Laplacian and its fpm) on meshes that fit four ranks: dense on a 2 x 2
contour x rhs mesh, the stochastic count on ``contour_mesh(4)``, sparse on
``contour_model_mesh(2, 2)`` and ``contour_model_mesh(1, 2, n_rhs=2)``,
sparse general on 4, the polynomial filter (``solver="cheb"`` and
``"contour_poly"``) on 4; then the unit cases that need ranks: the halo
DIA product on 2 and 4 row shards, the model path's refusals and the mesh
counts. Every rank writes its results to a file the parent reads. The
JAX package's sharded drivers run the same legs once, in two child
processes with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(one core each), and the port's serial drivers run in the parent
meanwhile. The parent
waits with its own time limit and kills every child on expiry, so a hung
collective fails the module instead of cutting the suite.

Checks: every leg agrees with the port's serial path within 1e-6 (the
JAX package's gate, ``_assert_leg_agrees``; the count within 1e-6
relative) and with the JAX package's sharded drivers within 1e-6; the
polynomial legs equal the serial ones to the bit (each rank filters its
own columns with the serial kernels); every rank returns the same result.
Without a process group: ``pad_contour`` against the JAX function, the
meshes of a world of one, a sharded request that warns and runs serially,
or raises under ``strict_backend``, with the JAX package's texts, and the
two sharded counts of tests/test_estimate_modes.py.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu_torch.parallel import pfeast as port_pf  # noqa: E402

WORLD = 4
LEGS = ("dense", "estimate", "model_2x2", "model_1x2x2", "general", "cheb",
        "contour_poly")
EXACT = ("cheb", "contour_poly")
TIME_LIMIT = 600


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


# ---------------------------------------------------------------------------
# the legs, one call for either package
# ---------------------------------------------------------------------------

def _problem(n=64, dtype=np.float32):
    """``__graft_entry__._problem``: the Laplacian and a seeded SPD B."""
    rng = np.random.default_rng(0)
    A = (np.diag(2.0 * np.ones(n)) + np.diag(-1.0 * np.ones(n - 1), 1)
         + np.diag(-1.0 * np.ones(n - 1), -1)).astype(dtype)
    C = rng.standard_normal((n, n)).astype(dtype) * 0.05
    B = (C @ C.T + np.eye(n, dtype=dtype)).astype(dtype)
    return A, B


def _lap(ns=64):
    return sp.diags([2.0 * np.ones(ns), -np.ones(ns - 1), -np.ones(ns - 1)],
                    [0, 1, -1], format="csr")


def _fpm(pkg, **slots):
    fpm = pkg.feastinit()
    for k, v in slots.items():
        fpm[int(k[1:])] = v
    return fpm


def _leg(pkg, pf, name, mesh=True, **kw):
    """Leg ``name`` of the dry run in ``pkg`` (``pf`` its parallel module):
    the sharded driver on its mesh, or with ``mesh=False`` the serial
    driver the dry run compares it with."""
    A, B = _problem()
    As = _lap()
    if name in ("dense", "estimate"):
        fpm = _fpm(pkg, f2=8, f3=4, f4=2) if name == "dense" else \
            _fpm(pkg, f2=8, f14=2, f32=24)
        if not mesh:
            return pkg.feast_sygv(A, B, 0.5, 1.0, 12, fpm, **kw)
        m = pf.contour_rhs_mesh(2, 2) if name == "dense" \
            else pf.contour_mesh(WORLD)
        return pf.pfeast_dense(A, B, 0.5, 1.0, 12, fpm, hermitian=False,
                               mesh=m, **kw)
    if name.startswith("model"):
        fpm = _fpm(pkg, f3=4, f4=2)
        if not mesh:
            return pkg.sparse_feast_interval(As, None, 0.5, 1.0, 12, fpm,
                                             **kw)
        m = pf.contour_model_mesh(2, 2) if name == "model_2x2" \
            else pf.contour_model_mesh(1, 2, n_rhs=2)
        return pf.pfeast_sparse(As, None, 0.5, 1.0, 12, fpm, mesh=m, **kw)
    if name == "general":
        fpm = _fpm(pkg, f3=4, f4=2)
        Ac = As.astype(complex)
        if not mesh:
            return pkg.sparse_feast_general(Ac, None, 0.75 + 0.0j, 0.25, 12,
                                            fpm, **kw)
        return pf.pfeast_sparse_general(Ac, None, 0.75 + 0.0j, 0.25, 12,
                                        fpm, mesh=pf.contour_mesh(WORLD),
                                        **kw)
    fpm = _fpm(pkg, f3=4, f4=3)
    if not mesh:
        return pkg.sparse_feast_interval(As, None, 0.5, 1.0, 16, fpm,
                                         solver=name, **kw)
    return pf.pfeast_sparse(As, None, 0.5, 1.0, 16, fpm,
                            mesh=pf.contour_mesh(WORLD), solver=name, **kw)


def _summary(r, out, name):
    out[f"{name}/M"] = int(r.M)
    out[f"{name}/epsout"] = float(r.epsout)
    out[f"{name}/lam"] = np.sort(np.real(np.asarray(r.lam)))


# the model path's refusals: name -> (operand, mesh shape, fpm slots)
def _refusal_cases(pkg, pf):
    rng = np.random.default_rng(5)
    wide = sp.random(64, 64, density=0.3, random_state=rng, format="csr")
    wide = (wide + wide.T).tocsr()
    return {
        "unstructured": (wide, (2, 2), {}),
        "indivisible": (_lap(63), (2, 2), {}),
        "narrow_shards": (sp.diags([2.0 * np.ones(8), -np.ones(3),
                                    -np.ones(3)], [0, 5, -5], format="csr"),
                          (1, 4), {}),
        "estimate": (_lap(), (2, 2), dict(f14=2)),
    }


def _refusals(pkg, pf, out, **kw):
    for name, (A, shape, slots) in _refusal_cases(pkg, pf).items():
        try:
            pf.pfeast_sparse(A, None, 0.5, 1.0, 8, _fpm(pkg, **slots),
                             mesh=pf.contour_model_mesh(*shape), **kw)
            out[f"refuse/{name}"] = "no error"
        except (ValueError, NotImplementedError) as e:
            out[f"refuse/{name}"] = f"{type(e).__name__}: {e}"


# the JAX package's legs in two children: the model legs, the rest
JAX_CHILDREN = (("model_2x2", "model_1x2x2"),
                tuple(n for n in LEGS if not n.startswith("model")))


def _write_jax(path, child):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import feastkit_tpu as ref_ft
    from feastkit_tpu.parallel import pfeast as ref_pf
    out = {}
    for name in JAX_CHILDREN[child]:
        _summary(_leg(ref_ft, ref_pf, name), out, name)
    if child:
        _refusals(ref_ft, ref_pf, out)
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# a rank of the world
# ---------------------------------------------------------------------------

def _halo_cases(out, rank):
    """The halo product of this rank's rows on 2 and 4 row shards (real
    and complex operands, unbatched and node-batched), both the kernel
    route and the plain version."""
    import torch.distributed as dist
    rng = np.random.default_rng(7)
    N, offsets = 48, (-3, -1, 0, 1, 3)
    diags = torch.as_tensor(rng.standard_normal((5, N)))
    X = torch.as_tensor(rng.standard_normal((2, N, 3))
                        + 1j * rng.standard_normal((2, N, 3)))
    for shards, mesh in ((2, port_pf.contour_model_mesh(2, 2)),
                         (4, port_pf.contour_model_mesh(1, 4))):
        size, index, group = port_pf._axis(mesh, "model")
        n_loc = N // size
        rows = slice(index * n_loc, (index + 1) * n_loc)
        for label, x in (("real", X[0].real.contiguous()),
                         ("complex", X[0]), ("batched", X)):
            y = port_pf._dia_halo_matvec(diags[:, rows], x[..., rows, :],
                                         offsets, (size, index, group))
            yp = port_pf._dia_halo_matvec_plain(
                diags[:, rows], x[..., rows, :], offsets,
                (size, index, group))
            out[f"halo/{shards}/{label}/rows"] = np.array(
                [rows.start, rows.stop])
            out[f"halo/{shards}/{label}/y"] = y.numpy()
            out[f"halo/{shards}/{label}/plain"] = yp.numpy()
    out["halo/diags"] = diags.numpy()
    out["halo/X"] = X.numpy()
    out["halo/offsets"] = np.asarray(offsets)
    # a mesh that does not span the world names its size
    try:
        port_pf.contour_mesh(3)
        out["mesh_count"] = "no error"
    except ValueError as e:
        out["mesh_count"] = str(e)
    out["world"] = dist.get_world_size()


def _run_rank(rank, store, path):
    from datetime import timedelta
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        out = {}
        for name in LEGS:
            t0 = time.perf_counter()
            _summary(_leg(ft, port_pf, name, device="cpu"), out, name)
            out[f"{name}/seconds"] = time.perf_counter() - t0
        _refusals(ft, port_pf, out, device="cpu")
        _halo_cases(out, rank)
        np.savez(path, **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the module fixture: the world, the JAX child and the serial references
# ---------------------------------------------------------------------------

_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")
_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(sys.argv[1])}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


def _env(**extra):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(here), here,
                    os.environ.get("PYTHONPATH")) if p),
        OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(per-rank results, the JAX package's, the port's serial)."""
    where = tmp_path_factory.mktemp("parallel_world")
    ref_paths = [where / f"jax{i}.npz" for i in range(len(JAX_CHILDREN))]
    flags = " ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), _FAST_COMPILE,
        f"--xla_force_host_platform_device_count={WORLD}")))
    children = []
    for i, path in enumerate(ref_paths):
        cmd = [__file__, "--jax", str(path), str(i)]
        if hasattr(os, "sched_setaffinity"):
            # one core each, the last and the second from last of this
            # process's set
            cpus = sorted(os.sched_getaffinity(0))
            cmd = ["-c", _CHILD, str(cpus[-1 - i] if len(cpus) > i
                                     else cpus[-1])] + cmd
        children.append(subprocess.Popen([sys.executable] + cmd,
                                         env=_env(XLA_FLAGS=flags)))
    store = where / "store"
    paths = [where / f"rank{r}.npz" for r in range(WORLD)]
    children += [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(store),
         str(paths[r])], env=_env()) for r in range(WORLD)]
    try:
        serial = {}
        for name in LEGS:
            _summary(_leg(ft, port_pf, name, mesh=False, device="cpu"),
                     serial, name)
        deadline = time.monotonic() + TIME_LIMIT
        for child in children:
            rc = child.wait(timeout=max(deadline - time.monotonic(), 1))
            assert rc == 0, f"a child of the world failed: {child.args}"
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    ranks = []
    for p in paths:
        with np.load(p) as z:
            ranks.append({k: z[k] for k in z.files})
    ref = {}
    for p in ref_paths:
        with np.load(p) as z:
            ref.update({k: z[k] for k in z.files})
    return ranks, ref, serial


# ---------------------------------------------------------------------------
# the legs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LEGS)
def test_leg_agrees_with_serial(world, name):
    ranks, _, serial = world
    got = ranks[0]
    assert int(got[f"{name}/M"]) == serial[f"{name}/M"]
    if name == "estimate":
        est = serial["estimate/epsout"]
        assert abs(float(got["estimate/epsout"]) - est) <= 1e-6 * abs(est)
        return
    lam, lam_s = got[f"{name}/lam"], serial[f"{name}/lam"]
    assert len(lam) > 0
    if name in EXACT:
        assert np.array_equal(lam, lam_s)
    else:
        assert np.abs(lam - lam_s).max() <= 1e-6


@pytest.mark.parametrize("name", LEGS)
def test_leg_agrees_with_reference(world, name):
    ranks, ref, _ = world
    got = ranks[0]
    assert int(got[f"{name}/M"]) == int(ref[f"{name}/M"])
    if name == "estimate":
        est = float(ref["estimate/epsout"])
        assert abs(float(got["estimate/epsout"]) - est) <= 1e-6 * abs(est)
        return
    assert np.abs(got[f"{name}/lam"] - ref[f"{name}/lam"]).max() <= 1e-6


@pytest.mark.parametrize("name", LEGS)
def test_every_rank_returns_the_same_result(world, name):
    ranks, _, _ = world
    for other in ranks[1:]:
        assert np.array_equal(other[f"{name}/lam"], ranks[0][f"{name}/lam"])
        assert float(other[f"{name}/epsout"]) == \
            float(ranks[0][f"{name}/epsout"])


@pytest.mark.parametrize("case", ["unstructured", "indivisible",
                                  "narrow_shards", "estimate"])
def test_model_path_refusals_match_reference(world, case):
    """The model path's checks and texts, in the JAX package's order: DIA
    structure, N divisible over the axis, shards no narrower than the
    bandwidth (ValueError), and no fpm[14]=2 (NotImplementedError)."""
    ranks, ref, _ = world
    got = str(ranks[0][f"refuse/{case}"])
    assert got != "no error"
    assert got == str(ref[f"refuse/{case}"])


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("label", ["real", "complex", "batched"])
def test_halo_product_matches_serial(world, shards, label):
    """Each rank's rows of the halo product (the DIA kernel route on the
    extended block, and the plain shifted adds) equal the rows of the
    serial DIA product on the whole operand."""
    from feastkit_tpu_torch.ops.dia import dia_matvec_plain
    ranks, _, _ = world
    r0 = ranks[0]
    diags = torch.as_tensor(r0["halo/diags"])
    X = torch.as_tensor(r0["halo/X"])
    x = {"real": X[0].real, "complex": X[0], "batched": X}[label]
    want = dia_matvec_plain(diags.to(x.dtype), tuple(r0["halo/offsets"]),
                            x).numpy()
    covered = 0
    for r in ranks:
        lo, hi = r[f"halo/{shards}/{label}/rows"]
        for key in ("y", "plain"):
            got = r[f"halo/{shards}/{label}/{key}"]
            assert np.abs(got - want[..., lo:hi, :]).max() \
                <= 1e-13 * np.abs(want).max()
        covered += hi - lo
    assert covered == want.shape[-2] * WORLD // shards


def test_mesh_must_span_the_world(world):
    ranks, _, _ = world
    msg = str(ranks[0]["mesh_count"])
    assert msg.startswith("a mesh of 3 ranks must span the world of 4 ")


# ---------------------------------------------------------------------------
# without a process group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ne,shards", [(8, 4), (8, 3), (5, 2), (1, 4)])
def test_pad_contour_matches_reference(ne, shards):
    from feastkit_tpu.parallel.pfeast import pad_contour
    c = ft.feast_contour(0.0, 1.0, _fpm(ft, f2=ne))
    Zr, Wr = pad_contour(c.Zne, c.Wne, shards)
    Zp, Wp = port_pf.pad_contour(c.Zne, c.Wne, shards)
    assert np.array_equal(Zp, Zr) and np.array_equal(Wp, Wr)
    assert len(Zp) % shards == 0


def test_meshes_of_a_world_of_one():
    """No process group: a one-rank mesh is None (nothing to shard), any
    other count names the world's size."""
    assert port_pf.contour_mesh() is None
    assert port_pf.contour_mesh(1) is None
    assert port_pf.contour_rhs_mesh(1, 1) is None
    assert port_pf.contour_model_mesh(1, 1) is None
    for make in (lambda: port_pf.contour_mesh(2),
                 lambda: port_pf.contour_rhs_mesh(2, 2),
                 lambda: port_pf.contour_model_mesh(1, 2, n_rhs=2)):
        with pytest.raises(ValueError, match="world of 1 rank"):
            make()
    caps = ft.feast_parallel_capabilities()
    assert caps["n_ranks"] == 1 and caps["backends"]["sharded"] is False
    assert ft.determine_parallel_backend("sharded") == "serial"
    assert ft.mpi_available() is True


@pytest.mark.parametrize("operand", ["sparse", "dense"])
def test_sharded_request_without_a_group_runs_serially(monkeypatch,
                                                       operand):
    """The JAX package's warning, then a serial solve equal to the serial
    driver's; under strict_backend its RuntimeError."""
    import feastkit_tpu as ref_ft
    from feastkit_tpu.core import backend as ref_backend
    from feastkit_tpu.solvers import dense as ref_dense
    from feastkit_tpu.solvers import sparse as ref_sparse
    monkeypatch.setattr(ref_backend, "_n_devices", lambda: 1)
    monkeypatch.setattr(ref_sparse, "sparse_feast_interval",
                        lambda *a, **k: "serial solve")
    monkeypatch.setattr(ref_dense, "dense_hermitian_feast",
                        lambda *a, **k: "serial solve")
    A = _lap(40) if operand == "sparse" else _lap(40).toarray()
    serial = ft.feast(A, None, (0.5, 1.5), 16, backend="serial",
                      device="cpu")
    with pytest.warns(UserWarning) as w_ref:
        assert ref_ft.feast(A, None, (0.5, 1.5), 16, backend="sharded") \
            == "serial solve"
    with pytest.warns(UserWarning) as w_port:
        r = ft.feast(A, None, (0.5, 1.5), 16, backend="sharded",
                     device="cpu")
    assert [str(w.message) for w in w_port] == \
        [str(w.message) for w in w_ref]
    assert r.M == serial.M > 0 and np.array_equal(r.lam, serial.lam)
    with pytest.raises(RuntimeError) as e_ref:
        ref_ft.feast(A, None, (0.5, 1.5), 16, backend="sharded",
                     strict_backend=True)
    with pytest.raises(RuntimeError) as e_port:
        ft.feast(A, None, (0.5, 1.5), 16, backend="sharded",
                 strict_backend=True, device="cpu")
    assert str(e_port.value).split(". ")[0] == \
        str(e_ref.value).split(". ")[0]


def _estimate_fpm(trials):
    return _fpm(ft, f14=2, f32=trials)


def test_pfeast_general_estimate_unbiased():
    """tests/test_estimate_modes.py's sharded general count, in a world of
    one rank: the full contour's raw sum (no halved weights), equal to
    the serial dense general driver's count on the same probes."""
    n = 400
    A = np.asarray(_lap(n).toarray(), np.complex128)
    w = np.linalg.eigvalsh(_lap(n).toarray())
    true = int((np.abs(w - 2.0) <= 0.8).sum())
    r = ft.pfeast_general(A, None, 2.0 + 0.0j, 0.8, 8, _estimate_fpm(20),
                          device="cpu")
    assert r.info == 0 and r.lam.size == 0
    assert abs(r.M - true) <= 0.2 * true
    s = ft.feast_general(A, None, 2.0 + 0.0j, 0.8, 8, _estimate_fpm(20),
                         device="cpu")
    assert abs(r.epsout - s.epsout) <= 1e-10 * abs(s.epsout)


def test_pfeast_sparse_general_estimate_honors_contour_and_hints(
        monkeypatch):
    """The sharded sparse-general count delegates to the serial driver
    with the explicit contour (its (Emid, r) encloses nothing) and the
    inner-solve hints; here on a diagonal operator (the Laplacian's
    spectrum of n = 400 on the diagonal), whose shifted solves converge at
    once."""
    w = np.linalg.eigvalsh(_lap(400).toarray())
    A = sp.diags(w.astype(np.complex128), 0, format="csr")
    true = int((np.abs(w - 2.0) <= 0.8).sum())
    contour = ft.feast_gcontour(2.0 + 0.0j, 0.8, ft.feastinit())
    from feastkit_tpu_torch.solvers import sparse as port_sparse
    seen = []
    serial = port_sparse.sparse_feast_general
    monkeypatch.setattr(port_sparse, "sparse_feast_general",
                        lambda *a, **k: seen.append(k) or serial(*a, **k))
    r = ft.pfeast_sparse_general(A, None, 5.0 + 0.0j, 0.05, 8,
                                 _estimate_fpm(20), contour=contour,
                                 solver_tol=1e-8, precond="jacobi",
                                 device="cpu")
    assert r.info == 0 and r.lam.size == 0
    assert abs(r.M - true) <= 0.2 * true
    assert seen[0]["solver_tol"] == 1e-8 and seen[0]["precond"] == "jacobi"


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        _write_jax(sys.argv[2], int(sys.argv[3]))
    else:
        _run_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
