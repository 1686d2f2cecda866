"""PyTorch port: the matrix-free polynomial filter's enclosure and degree
at config 4's full width, against the JAX package.

The operator is the 2D Laplacian at P = 10 (N = 1,048,576) as a pure
five-point stencil, the interval its lowest 52 eigenvalues (the main
path's); ``operator_spectrum_bounds`` takes its 192 Lanczos steps in both
packages on the CPU, and ``build_cheb_filter_coeffs`` chooses the degree
on each enclosure. The enclosures agree within 1e-8 of the span and the
degrees are equal. The degree is the cap, 8000: the outward pad of 1e-3
of the span puts the enclosure's lower end far below the interval, so the
degree rule no longer sees an interval at the spectrum's edge; on the
exact ends it would be under 2000. Run as a script, the file prints the
enclosures and degrees of both packages as one JSON line; the test runs
it so, on one core, with glibc's mmap threshold fixed at 64 KiB (the
dynamic one lets the 8 MiB temporaries of the steps grow the heap to
3 GiB).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

NX = 1024


def _interval():
    """(Emin, Emax, w) of the lowest 52 eigenvalues of the P = 10
    Laplacian, Emax at a genuine gap (chip_smoke.py's interval_lowest)."""
    wx = 2.0 - 2.0 * np.cos(np.arange(1, NX + 1) * np.pi / (NX + 1))
    w = np.sort((wx[:200, None] + wx[None, :200]).ravel())
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, 50)]
    return float(w[0] * 0.5), float(0.5 * (w[hi] + w[hi + 1])), wx


def _reference():
    import jax.numpy as jnp
    import feastkit_tpu as ref_ft
    from feastkit_tpu.ops.chebfilter import build_cheb_filter_coeffs
    from feastkit_tpu.solvers.matfree import operator_spectrum_bounds

    def mv(X):
        G = jnp.pad(X.reshape(NX, NX, -1), ((1, 1), (1, 1), (0, 0)))
        Y = (4.0 * G[1:-1, 1:-1] - G[:-2, 1:-1] - G[2:, 1:-1]
             - G[1:-1, :-2] - G[1:-1, 2:])
        return Y.reshape(NX * NX, -1)
    op = ref_ft.MatrixVecFunction(mv, (NX * NX, NX * NX), jnp.float64,
                                  issymmetric=True)
    lo, hi = operator_spectrum_bounds(op, NX * NX, np.float64)
    Emin, Emax, _ = _interval()
    return lo, hi, build_cheb_filter_coeffs(lo, hi, Emin, Emax)[1]["degree"]


def _port():
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.ops.chebfilter import build_cheb_filter_coeffs
    from feastkit_tpu_torch.solvers.matfree import operator_spectrum_bounds

    def mv(X):
        G = torch.nn.functional.pad(X.reshape(NX, NX, -1).permute(2, 0, 1),
                                    (1, 1, 1, 1))
        Y = (4.0 * G[:, 1:-1, 1:-1] - G[:, :-2, 1:-1] - G[:, 2:, 1:-1]
             - G[:, 1:-1, :-2] - G[:, 1:-1, 2:])
        return Y.permute(1, 2, 0).reshape(NX * NX, -1)
    op = ft.MatrixVecFunction(mv, (NX * NX, NX * NX), torch.float64,
                              issymmetric=True)
    lo, hi = operator_spectrum_bounds(op, NX * NX, np.float64, device="cpu")
    Emin, Emax, _ = _interval()
    return lo, hi, build_cheb_filter_coeffs(lo, hi, Emin, Emax)[1]["degree"]


_CHILD = ("import os, runpy, sys; "
          "os.sched_setaffinity(0, {int(sys.argv[1])}); "
          "sys.argv = sys.argv[2:]; runpy.run_path(sys.argv[0], "
          "run_name='__main__')")


@pytest.fixture(scope="module")
def enclosures():
    """The script's JSON line: this file run in a child on the
    second-to-last core of this process's set (the affinity set before
    JAX sizes its thread pools)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MALLOC_MMAP_THRESHOLD_="65536",
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, __file__]
    if hasattr(os, "sched_setaffinity"):
        cpus = sorted(os.sched_getaffinity(0))
        cmd = [sys.executable, "-c", _CHILD,
               str(cpus[-2] if len(cpus) > 1 else cpus[0]), __file__]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_p10_enclosure_and_degree_match_reference(enclosures):
    (rlo, rhi), rdeg = (enclosures["jax"]["enclosure"],
                        enclosures["jax"]["degree"])
    (lo, hi), deg = (enclosures["port"]["enclosure"],
                     enclosures["port"]["degree"])
    wx = _interval()[2]
    w0, w1 = 2 * wx[0], 2 * wx[-1]
    span = w1 - w0
    assert abs(lo - rlo) <= 1e-8 * span and abs(hi - rhi) <= 1e-8 * span
    assert lo <= w0 and hi >= w1
    assert deg == rdeg == 8000


def test_p10_degree_on_the_exact_ends():
    """The cap comes from the pad: on the spectrum's exact ends both
    packages' rule asks for less than a quarter of it."""
    from feastkit_tpu.ops.chebfilter import auto_cheb_degree as ref_rule
    from feastkit_tpu_torch.ops.chebfilter import auto_cheb_degree
    Emin, Emax, wx = _interval()
    ends = (2 * wx[0], 2 * wx[-1], Emin, Emax)
    assert auto_cheb_degree(*ends) == ref_rule(*ends) < 2000


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(1)
    Emin, Emax, wx = _interval()
    (rlo, rhi, rdeg), (lo, hi, deg) = _reference(), _port()
    from feastkit_tpu_torch.ops.chebfilter import auto_cheb_degree
    json.dump({"interval": [Emin, Emax],
               "spectrum": [2 * wx[0], 2 * wx[-1]],
               "jax": {"enclosure": [rlo, rhi], "degree": rdeg},
               "port": {"enclosure": [lo, hi], "degree": deg},
               "degree_on_exact_ends": auto_cheb_degree(
                   2 * wx[0], 2 * wx[-1], Emin, Emax)}, sys.stdout)
    print()
