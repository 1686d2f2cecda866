"""PyTorch port: the polynomial path with mixed precision off, on solves
that do not converge, against the JAX package.

With fpm[42] = 0 the JAX package runs its fused FEAST core
(``_sparse_cheb_jit``): no stall exit and no best state, the refinement
loops to fpm[4]. The port follows the same semantics
(``kernel/hermitian.feast_hermitian_core``); only the mixed-precision
ladder keeps the host loop with its stall exit and best state. Two solves
of the 2D Laplacian on a 16 x 16 grid (N = 256), ``solver="cheb"``, that
run out of loops:
  * fpm[3] = 8, M0 = 8 for the 22 eigenvalues of [0, (w20 + w21) / 2]:
    M = 3, info 5, epsout 9.06e-2 after loop 20;
  * fpm[3] = 15 (tol 1e-15, below what the residuals reach), M0 = 16,
    the interval up to the 11th eigenvalue: M = 11, info 5, loop 20.
Each must give the JAX package's M, info and loop, and eigenvalues within
1e-8 (the BASELINE.md sparse tolerance). Loop counts are comparable here
because both solves run to fpm[4]: no loop's residual is near tol. The
ladder (fpm[42] = 2) keeps its own host loop and still agrees with the JAX
package's on the first case (M = 0 after loop 1).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import scipy.sparse as sp  # noqa: E402

import feastkit_tpu_torch as ft  # noqa: E402
from feastkit_tpu import feastinit as ref_feastinit  # noqa: E402
from feastkit_tpu.interfaces.feast import feast as ref_feast  # noqa: E402
from feastkit_tpu_torch.convert import fpm_from_reference  # noqa: E402

NX = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool (one spinning thread per core) then
    # starves its neighbours. The port's CPU tensors here are small.
    # numpy's and scipy's OpenBLAS pools (a spinning thread per core
    # each) would too, and worse: beside busy cores a small SVD runs
    # hundreds of times slower on them than on one thread
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _lap2d():
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(NX, NX))
    I = sp.eye(NX)
    return (sp.kron(D, I) + sp.kron(I, D)).tocsr()


def _solve_both(case, mixed):
    A = _lap2d()
    w = np.linalg.eigvalsh(A.toarray())
    if case == "few_columns":
        Emax, M0, fpm3 = 0.5 * (w[20] + w[21]), 8, 8
    else:
        Emax, M0, fpm3 = 0.5 * (w[10] + w[11]), 16, 15
    fpm = ref_feastinit()
    fpm[3] = fpm3
    fpm[42] = mixed
    r = ref_feast(A, None, (0.0, Emax), M0, fpm, backend="serial",
                  solver="cheb")
    p = ft.feast(A, None, (0.0, Emax), M0, fpm_from_reference(fpm),
                 device="cpu", solver="cheb")
    return r, p


@pytest.mark.parametrize("case,M,loop", [("few_columns", 3, 20),
                                         ("tol_below_floor", 11, 20)])
def test_mixed_off_runs_the_fused_core(case, M, loop):
    r, p = _solve_both(case, mixed=0)
    assert (r.M, int(r.info), r.loop) == (M, 5, loop)
    assert (p.M, int(p.info), p.loop) == (r.M, int(r.info), r.loop)
    gap = np.abs(np.sort(np.asarray(p.lam)) - np.sort(np.asarray(r.lam)))
    assert float(gap.max()) <= 1e-8
    if case == "few_columns":
        assert abs(p.epsout - r.epsout) <= 1e-8


def test_ladder_keeps_its_host_loop():
    r, p = _solve_both("few_columns", mixed=2)
    assert (r.M, int(r.info), r.loop) == (0, 5, 1)
    assert (p.M, int(p.info), p.loop) == (r.M, int(r.info), r.loop)
