"""PyTorch port: the convolution realization of the multigrid stencil
(``FEAST_STENCIL_CONV=1``) against the JAX package's.

With the switch set (by ``monkeypatch``), ``ops/multigrid.apply_stencil``
on 2-D and 3-D float32 grids (a batch of right-hand sides; complex64 x as
two real convolutions) is one ``torch.nn.functional.conv2d`` / ``conv3d``
and equals the JAX package's ``_stencil_conv`` (one XLA convolution) on
the same inputs, and the shifted-add path, within float32 rounding. The
gate is the JAX package's ``_conv_ok`` on the same inputs: opt-in, a 2-D
or 3-D grid, real coefficients, |disp| <= 1, 32-bit or narrower, so
complex coefficients, a reach of 2 (a coarsened stencil), float64 and a
1-D grid keep the shifted adds. With the switch off the V-cycle runs the
shifted adds, bit for bit the same as with it unset.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from feastkit_tpu.ops import multigrid as ref_mg  # noqa: E402
from feastkit_tpu_torch.ops import multigrid as port_mg  # noqa: E402


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


def _laplacian(ndim):
    """The (2 ndim + 1)-point Laplacian's displacements and coefficients."""
    disps = [[0] * ndim]
    coeffs = [2.0 * ndim]
    for k in range(ndim):
        for s in (1, -1):
            d = [0] * ndim
            d[k] = s
            disps.append(d)
            coeffs.append(-1.0 - 0.25 * k)      # anisotropic
    return np.asarray(disps, np.int64), coeffs


def _nine_point():
    disps = np.asarray([[a, b] for a in (-1, 0, 1) for b in (-1, 0, 1)],
                       np.int64)
    rng = np.random.default_rng(3)
    return disps, list(rng.standard_normal(9))


CASES = {
    "2d": ((17, 12), _laplacian(2)),
    "2d_nine_point": ((9, 11), _nine_point()),
    "3d": ((6, 7, 5), _laplacian(3)),
}


def _x(grid, complex_x=False):
    rng = np.random.default_rng(11)
    shape = (2, 3) + tuple(grid)
    x = rng.standard_normal(shape).astype(np.float32)
    if complex_x:
        x = x + 1j * rng.standard_normal(shape).astype(np.float32)
    return x


def _off(monkeypatch, x, disps, coeffs, grid):
    monkeypatch.delenv("FEAST_STENCIL_CONV", raising=False)
    return port_mg.apply_stencil(torch.as_tensor(x), disps, coeffs,
                                 grid).numpy()


@pytest.mark.parametrize("complex_x", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_matches_reference_and_shifted_adds(monkeypatch, case,
                                                 complex_x):
    grid, (disps, coeffs) = CASES[case]
    x = _x(grid, complex_x)
    shifted = _off(monkeypatch, x, disps, coeffs, grid)
    monkeypatch.setenv("FEAST_STENCIL_CONV", "1")
    xt = torch.as_tensor(x)
    assert port_mg._conv_ok(xt, disps, coeffs, grid)
    assert ref_mg._conv_ok(jax.numpy.asarray(x), disps, coeffs, grid)
    got = port_mg.apply_stencil(xt, disps, coeffs, grid)
    assert got.dtype == xt.dtype and tuple(got.shape) == x.shape
    ref = np.asarray(ref_mg._stencil_conv(jax.numpy.asarray(x), disps,
                                          coeffs, grid))
    scale = np.abs(shifted).max()
    bar = 8 * np.finfo(np.float32).eps * scale * len(coeffs)
    assert np.abs(got.numpy() - ref).max() <= bar
    assert np.abs(got.numpy() - shifted).max() <= bar


@pytest.mark.parametrize("refusal", ["complex_coeffs", "reach_2", "float64",
                                     "one_dim", "switch_off"])
def test_gate_matches_reference(monkeypatch, refusal):
    grid, (disps, coeffs) = CASES["2d"]
    x = _x(grid)
    if refusal == "complex_coeffs":
        coeffs = [c + 0.5j for c in coeffs]
        x = _x(grid, complex_x=True)
    elif refusal == "reach_2":
        disps = disps * 2
    elif refusal == "float64":
        x = x.astype(np.float64)
    elif refusal == "one_dim":
        grid, (disps, coeffs) = (20,), _laplacian(1)
        x = np.random.default_rng(1).standard_normal((3, 20))
        x = x.astype(np.float32)
    if refusal != "switch_off":
        monkeypatch.setenv("FEAST_STENCIL_CONV", "1")
    with jax.enable_x64(True):
        ref = ref_mg._conv_ok(jax.numpy.asarray(x), disps, coeffs, grid)
    port = port_mg._conv_ok(torch.as_tensor(x), disps, coeffs, grid)
    assert port is False and bool(ref) is False
    # a refused case keeps the shifted adds, bit for bit
    got = port_mg.apply_stencil(torch.as_tensor(x), disps, coeffs, grid)
    want = _off(monkeypatch, x, disps, coeffs, grid)
    assert np.array_equal(got.numpy(), want)


def test_vcycle_with_and_without_the_switch(monkeypatch):
    """The complex64 V-cycle of a real 2-D stencil: with the switch off it
    is the same, bit for bit, as with it unset; with it on its every
    stencil product is a convolution and the result agrees within float32
    rounding."""
    import feastkit_tpu_torch.ops.multigrid as mg
    disps, coeffs = _laplacian(2)
    st = mg.GridStencil(disps, np.asarray(coeffs), (16, 16))
    rng = np.random.default_rng(2)
    X = torch.as_tensor((rng.standard_normal((256, 3))
                         + 1j * rng.standard_normal((256, 3)))
                        .astype(np.complex64))
    z = 0.7 + 0.3j

    def run():
        return mg.make_shifted_vcycle(st, None, z, dtype=torch.complex64,
                                      n_levels=3)(X).numpy()

    monkeypatch.delenv("FEAST_STENCIL_CONV", raising=False)
    unset = run()
    monkeypatch.setenv("FEAST_STENCIL_CONV", "0")
    assert np.array_equal(run(), unset)
    monkeypatch.setenv("FEAST_STENCIL_CONV", "1")
    calls = []
    conv = mg._stencil_conv
    monkeypatch.setattr(mg, "_stencil_conv",
                        lambda *a: calls.append(1) or conv(*a))
    on = run()
    assert calls
    assert np.abs(on - unset).max() <= 1e-5 * np.abs(unset).max()
