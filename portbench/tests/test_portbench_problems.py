"""The generators against their closed-form spectra, and the plain
references against dense NumPy."""
import math

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp

from portbench.generators import fields, schrodinger_fd, schrodinger_fem
from portbench.reference import common
from portbench.reference import schrodinger_fd as ref_fd
from portbench.reference import schrodinger_fem as ref_fem

# P = 5: a 32 x 32 grid
CFG = dict(grid=[32, 32], potential=dict(modes=4, amplitude=0.05),
           lowest_1d=32, pairs_past=50, M0=72)
CASES = [(schrodinger_fd, ref_fd), (schrodinger_fem, ref_fem)]


def dense_spectrum(problem):
    A = problem["A"].toarray()
    B = None if problem["B"] is None else problem["B"].toarray()
    return sla.eigh(A, B, eigvals_only=True)


@pytest.mark.parametrize("gen,ref", CASES)
def test_generator_spectrum_is_the_closed_form(gen, ref):
    p = gen.build(CFG, 2 ** 40 + 11, 3)
    w = dense_spectrum(p)
    Emin, Emax = p["interval"]
    inside = w[(w >= Emin) & (w <= Emax)]
    assert p["count"] == len(inside) >= 51
    exact = ref.exact_eigenvalues(p["inputs"], Emin, Emax, CFG["lowest_1d"])
    assert len(exact) == len(inside)
    assert np.abs(np.sort(exact) - inside).max() < 1e-12
    assert fields.subspace_size(p["count"]) == p["M0"] == 72


def test_reference_operators_match_the_matrices():
    gen, ref = schrodinger_fem, ref_fem
    p = gen.build(CFG, 5, 0)
    n = p["A"].shape[0]
    B = sp.eye(n) if p["B"] is None else p["B"]
    X = np.random.default_rng(1).standard_normal((n, 9))
    apply_A, apply_B = ref.operators(p["inputs"])
    assert np.abs(apply_A(X) - p["A"] @ X).max() < 1e-12
    assert np.abs(apply_B(X) - B @ X).max() < 1e-12


@pytest.mark.parametrize("gen,ref", CASES)
def test_reference_residual_against_a_dense_product(gen, ref):
    p = gen.build(CFG, 9, 1)
    n = p["A"].shape[0]
    A = p["A"].toarray()
    B = np.eye(n) if p["B"] is None else p["B"].toarray()
    lam, V = sla.eigh(A, B)
    lam, V = lam[:20], V[:, :20] * 3.0
    V[:, 4] += 1e-3 * np.random.default_rng(0).standard_normal(n)
    got = ref.residuals(p["inputs"], lam, V)
    want = (np.linalg.norm(A @ V - B @ V * lam, axis=0)
            / (np.maximum(np.abs(lam), 1.0) * np.linalg.norm(V, axis=0)))
    assert np.allclose(got, want, rtol=1e-9, atol=1e-15)
    assert got[4] > 1e-5 > np.delete(got, 4).max()


def test_fd_operator_is_the_kronecker_sum():
    rng = np.random.default_rng(4)
    v, w = rng.random(7), rng.random(5)

    def T(d):
        return sp.diags([-np.ones(len(d) - 1), 2 + d, -np.ones(len(d) - 1)],
                        [-1, 0, 1])
    K = sp.kron(T(v), sp.eye(5)) + sp.kron(sp.eye(7), T(w))
    A = schrodinger_fd.operator(v, w)
    assert abs(K - A).max() == 0 and K.nnz == A.nnz


def test_field_spans_zero_to_amplitude_and_follows_the_seed():
    a = fields.smooth_field(fields.rng(2 ** 35 + 1, 4, 0), 64, 4, 3e-5)
    b = fields.smooth_field(fields.rng(2 ** 35 + 1, 4, 0), 64, 4, 3e-5)
    c = fields.smooth_field(fields.rng(2 ** 35 + 2, 4, 0), 64, 4, 3e-5)
    assert a.min() == 0.0 and math.isclose(a.max(), 3e-5)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # any whole seed, also a negative one
    fields.rng(-7, 0, 0).random()


def test_eigenvalue_errors():
    exact = np.array([1.0, 2.0, 3.0])
    assert common.eigenvalue_error([3.0, 1.0, 2.0 + 1e-9], exact) \
        == pytest.approx(1e-9)
    assert common.eigenvalue_error([1.0, 2.0], exact) == math.inf
    assert common.eigenvalue_error([1.0, 2.0, math.nan], exact) == math.inf
    assert common.nearest_error([2.0 + 1e-6, 3.0], exact) \
        == pytest.approx(1e-6)
    assert common.nearest_error([math.nan], exact) == math.inf
