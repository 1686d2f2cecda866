"""PyTorch port: the DIA matvec entries against the JAX package's kernels.

On the CPU each entry of ``feastkit_tpu_torch/ops/dia.py`` runs its plain
version (the CUDA kernels of ``ops/csrc/dia_matvec.cu`` run on the card:
tests/test_torch_cuda.py, chip_smoke.py). Here the plain versions are held
against the JAX package's Pallas kernels run in interpret mode:
``_dia_matvec_32`` (``_dia_kernel``) and ``_dia_matvec_batched``
(``_dia_kernel_b``) with 32-bit data under ``jax.enable_x64(False)``, as
tests/test_pallas.py runs them, at f32 tolerance (1e-5 relative to max|y|:
the sums of up to five f32 products are taken in another order), and
against ``dia_matvec_reference`` in float64 at 1e-13. The shapes are those
of tests/test_pallas.py plus ragged ones (M = 1, 7, 11; N = 1073, 100; an
offset beyond N / 2). Inputs come from numpy seeds.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from feastkit_tpu.ops import pallas_kernels as ref_pk  # noqa: E402
from feastkit_tpu_torch.ops import dia  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs files in parallel worker processes on a few cores;
    # torch's default intra-op pool would starve its neighbours
    # numpy's and scipy's OpenBLAS pools (a spinning thread per core
    # each) would too, and worse: beside busy cores a small SVD runs
    # hundreds of times slower on them than on one thread
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(n)


def _operator(seed, N, offsets):
    """Random row-aligned diagonals (zero where out of range)."""
    rng = np.random.default_rng(seed)
    d = np.zeros((len(offsets), N))
    for k, o in enumerate(offsets):
        d[k, max(0, -o):N - max(0, o)] = rng.standard_normal(N - abs(o))
    return d


# (N, offsets, M): tests/test_pallas.py's band shapes (kl, ku) = (2, 2),
# (1, 3), (0, 0) and its 2D-Laplacian offsets, then ragged ones
SHAPES = [
    (100, (-2, -1, 0, 1, 2), 4),
    (1000, (-1, 0, 1, 2, 3), 8),
    (64, (0,), 2),
    (200, (-10, -1, 0, 1, 10), 3),
    (1073, (-37, -1, 0, 1, 37), 1),
    (1073, (-1, 0, 1), 7),
    (100, (-60, -1, 0, 1, 60), 11),
    (150, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 5),
]


@pytest.mark.parametrize("N,offsets,M", SHAPES)
def test_plain_f32_matches_interpret_kernel(N, offsets, M):
    d = _operator(N + M, N, offsets).astype(np.float32)
    x = np.random.default_rng(M).standard_normal((N, M)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(ref_pk._dia_matvec_32(
            jnp.asarray(d), jnp.asarray(x), offsets, block=64,
            interpret=True))
    before = dia.dia_matvec_f32.launches
    got = dia.dia_matvec(torch.as_tensor(d), offsets, torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == (N, M)
    assert dia.dia_matvec_f32.launches == before   # plain on the CPU
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("N,offsets,M", SHAPES)
def test_plain_f64_matches_reference(N, offsets, M):
    d = _operator(N + M, N, offsets)
    x = np.random.default_rng(M).standard_normal((N, M))
    ref = np.asarray(ref_pk.dia_matvec_reference(jnp.asarray(d),
                                                 jnp.asarray(x), offsets))
    got = dia.dia_matvec(torch.as_tensor(d), offsets,
                         torch.as_tensor(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("g,N,offsets,M", [
    (3, 150, (-7, -1, 0, 2, 7), 4),      # tests/test_pallas.py's shape
    (2, 1073, (-37, -1, 0, 1, 37), 11),
    (4, 120, (-10, 0, 10), 1)])
def test_plain_batched_matches_interpret_kernel(g, N, offsets, M):
    d = _operator(g + N, N, offsets).astype(np.float32)
    x = np.random.default_rng(g).standard_normal((g, N, M)).astype(
        np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(ref_pk._dia_matvec_batched(
            jnp.asarray(d), jnp.asarray(x), offsets, block=64,
            interpret=True))
    got = dia.dia_matvec_batched(torch.as_tensor(d), offsets,
                                 torch.as_tensor(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # fp64: each member against the reference product
    d64, x64 = d.astype(np.float64), x.astype(np.float64)
    got64 = dia.dia_matvec_batched(torch.as_tensor(d64), offsets,
                                   torch.as_tensor(x64)).numpy()
    ref64 = np.stack([np.asarray(ref_pk.dia_matvec_reference(
        d64, x64[i], offsets)) for i in range(g)])
    assert np.abs(got64 - ref64).max() <= 1e-13 * np.abs(ref64).max()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("complex_diags", [False, True])
def test_any_matches_jax_decomposition(batched, complex_diags):
    # the JAX package's dia_matvec_any (Pallas in interpret mode) on the
    # offsets (-10, -1, 0, 1, 10): real diagonals x complex x is one real
    # product on the (N, 2K) view in the port, two kernel calls there;
    # complex diagonals keep the four-product form in both
    N, K, offsets = 200, 6, (-10, -1, 0, 1, 10)
    rng = np.random.default_rng(7)
    d = _operator(3, N, offsets)
    if complex_diags:
        d = d + 1j * _operator(4, N, offsets)
    shape = (2, N, K) if batched else (N, K)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if batched:
        ref = np.stack([np.asarray(ref_pk.dia_matvec_any(
            jnp.asarray(d), jnp.asarray(xi), offsets, use_pallas=True,
            interpret=True)) for xi in x])
    else:
        ref = np.asarray(ref_pk.dia_matvec_any(
            jnp.asarray(d), jnp.asarray(x), offsets, use_pallas=True,
            interpret=True))
    before = dict(dia.launch_counts())
    got = dia.dia_matvec_any(torch.as_tensor(d), offsets,
                             torch.as_tensor(x)).numpy()
    assert got.dtype == np.complex128 and got.shape == shape
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert dia.launch_counts() == before


def test_any_complex_f32_matches_interpret_kernel():
    # the mixed-precision Krylov operand: f32 diagonals x complex64 x
    N, K, offsets = 1073, 7, (-37, -1, 0, 1, 37)
    d = _operator(5, N, offsets).astype(np.float32)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((N, K))
         + 1j * rng.standard_normal((N, K))).astype(np.complex64)
    with jax.enable_x64(False):
        ref = np.asarray(ref_pk.dia_matvec_any(
            jnp.asarray(d), jnp.asarray(x), offsets, use_pallas=True,
            interpret=True))
    got = dia.dia_matvec_any(torch.as_tensor(d), offsets,
                             torch.as_tensor(x)).numpy()
    assert got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_vector_operand():
    N, offsets = 100, (-3, 0, 3)
    d = _operator(9, N, offsets)
    x = np.random.default_rng(9).standard_normal(N)
    got = dia.dia_matvec(torch.as_tensor(d), offsets, torch.as_tensor(x))
    ref = np.asarray(ref_pk.dia_matvec_reference(d, jnp.asarray(x), offsets))
    assert got.shape == (N,)
    assert np.abs(got.numpy() - ref).max() <= 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["dtype", "shape", "diag_count", "cpu"])
def test_wrappers_refuse_what_the_kernel_does_not_take(case):
    N, offsets = 50, (-1, 0, 1)
    d = torch.as_tensor(_operator(1, N, offsets))
    x = torch.zeros(N, 3, dtype=torch.float64)
    if case == "dtype":
        with pytest.raises(TypeError, match="float32"):
            dia.dia_matvec_f32(d, offsets, x)
        with pytest.raises(TypeError, match="float32 or float64"):
            dia.dia_matvec(d.to(torch.int64), offsets, x.to(torch.int64))
    elif case == "shape":
        with pytest.raises(ValueError, match="g, N, M"):
            dia.dia_matvec_batched_f64(d, offsets, x)
        with pytest.raises(ValueError, match="diags must be"):
            dia.dia_matvec_f64(d[:, :-1], offsets, x)
    elif case == "diag_count":
        offs = tuple(range(-16, 17))
        with pytest.raises(ValueError, match="at most 32"):
            dia.dia_matvec_f64(torch.zeros(33, N, dtype=torch.float64),
                               offs, x)
    else:
        # the launch path takes CUDA tensors only; on the CPU the wrapper
        # runs the plain version and counts no launch
        with pytest.raises(ValueError, match="CUDA tensors"):
            dia._launch(dia.dia_matvec_f64, d, offsets, x, False)
        before = dia.dia_matvec_f64.launches
        dia.dia_matvec_f64(d, offsets, x)
        assert dia.dia_matvec_f64.launches == before


def test_bcoo_and_bands_helpers_match():
    import scipy.sparse as sp
    rng = np.random.default_rng(11)
    n = 60
    A = sp.diags([rng.standard_normal(n - abs(k)) for k in (-3, 0, 2)],
                 [-3, 0, 2], format="coo")
    idx = np.stack([A.row, A.col], 1)
    r, p = ref_pk.bcoo_to_dia(A.data, idx, n), dia.bcoo_to_dia(A.data, idx, n)
    assert r[1] == p[1] and np.array_equal(r[0], p[0])
    bands = rng.standard_normal((4, n))
    r, p = ref_pk.bands_to_dia(bands, 1, 2), dia.bands_to_dia(bands, 1, 2)
    assert r[1] == p[1] and np.array_equal(r[0], p[0])
