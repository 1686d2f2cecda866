"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py           # every phase (about a few minutes)
    python3 chip_smoke.py --quick   # phases 1-3e: build and check kernels
    python3 chip_smoke.py --krylov-solve 9   # one Krylov solve at P = 9
    python3 chip_smoke.py --stream-sweep     # block shapes and bodies of the
                                             # streamed 2- and 4-step kernel,
                                             # timed, and its registers
    python3 chip_smoke.py --dia-sweep        # the DIA ring body's block
                                             # shapes and the flat body
    python3 chip_smoke.py --dia-turns DIR    # the DIA entries of the tree
                                             # unpacked in DIR (a parent
                                             # commit) and of this one, timed
                                             # in turns
    python3 chip_smoke.py --direct           # phase 10 alone
    python3 chip_smoke.py --hermitian        # phases 3c and 11 alone
    python3 chip_smoke.py --general          # phases 3c and 12 alone
    python3 chip_smoke.py --matfree          # phases 3c and 13 alone
    python3 chip_smoke.py --surface          # phases 3c and 14 alone
    python3 chip_smoke.py --sharded          # phases 3c and 15 alone
    python3 chip_smoke.py --direct-sweep     # BCR blocks, dense LU batching

Phases, each printed before the last line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of every kernel from feastkit_tpu_torch/ops/csrc with nvcc
     (sm_90a), one nvcc per source, all started together, and its time
     (with cheb_stream4.cu, the 2- and 4-step kernels, built a second time
     with the run-time diagonal count only, for phase 3b);
  3. each of the six kernels against its plain PyTorch version on the card,
     at the main path's shapes (2D Laplacian P=10: N = 1,048,576, M = 72,
     five diagonals; 8 steps for the 1-step kernels, two consecutive passes
     for the 2- and 4-step kernels, so their output pair is read back as
     the next input pair) and at awkward shapes (M = 11, 1, 40; N not a
     multiple of any tile; |offset| = nx; one operator whose S max|offset|
     exceeds N, so every halo is clipped at both ends; operators with 3,
     7 and 11 diagonals); T outputs and acc,
     tolerance relative to max|acc|: f32 1e-5, fp64 1e-13. Then each
     kernel's time per launch and per step, its plain version's time, the
     bound, a torch.sparse.mm (CSR) matvec for scale, and each multi-step
     plan's block shape and reckoned L2 bytes per element; the 2-step
     kernels also at the P=9 shapes (N = 262,144, halo 512, M = 72: the
     passes of the P=9 FEAST_CHEB_FUSE4=0 solve), checked and timed; and
     the Rayleigh-Ritz update's time at the main path's shapes;
  3b. the SPD-B composite's kernels against their plain versions at the
     P=8 consistent-mass shapes (N = 65,536, M = 72, nine diagonals) and
     at awkward shapes, same tolerances, and their times: the column-major
     one-step entries cheb_step_cm_f32/f64 (ops/csrc/cheb_step_cm.cu) on
     A~ in each of their four forms (T0 and acc present or absent), each
     form's device time (CUDA graph) and its time launched one call at a
     time against its own bound, torch.sparse.mm (A~ in CSR) on the
     function the form without T0 and acc computes, block shapes other
     than the plan's, and the registers and spills of every
     instantiation (nvcc -Xptxas -v, run beside the build); the combine
     cheb_combine_f32/f64; and the 2- and 4-step kernels on the
     nine-diagonal B~ with the ND = 9 instantiation and with the
     run-time-count body, each checked and timed (on the device by CUDA
     graphs, and one call at a time), with each plan's block shape;
  3c. the DIA matvec kernels of ops/csrc/dia_matvec.cu (dia_matvec_f32/f64
     and dia_matvec_batched_f32/f64), with the ptxas report of its ring
     body (no instantiation may spill), against their plain version at the
     Krylov path's P=8 shapes (N = 65,536, five diagonals: fp64 M = 72,
     f32 M = 128, batched g = 2, M = 128 in both types), at the P=10
     Rayleigh-Ritz shape (fp64, N = 1,048,576, M = 72, offsets +-1,
     +-1024), at the Lanczos shape (f32, M = 1) and at awkward shapes
     (M = 1, 7, 11; N = 1073, 100, 1089; |offset| = nx; 2 max|offset| >
     N; 1, 3, 9 and 11 diagonals; g = 3), each under the entry's own plan
     and under every other body that takes the shape, tolerance relative
     to max|y|: f32 1e-5, fp64 1e-13; which body each shape took (the
     ring body at the Krylov shapes, the flat one at P=10, whose rings
     leave one block a multiprocessor, and at M = 1); then their times over
     four rotating operands: on the device (CUDA graph), one call at a time
     and the host's cost per call, the plan's body and the other in turns
     (other, own, own, other, by CUDA graph), the plain version's, the
     bound, the plan's reckoned L2 bytes per element and a torch.sparse.mm
     (CSR) call on the same product (library_ms); the complex entries
     dia_matvec_c64/c128 and dia_matvec_batched_c64/c128 the same way at
     the Hermitian paths' shapes (unbatched at P=10: N = 1,048,576,
     M = 72, offsets +-1, +-1024; batched g = 2 at the Hermitian Krylov
     leg's P=7 shape, N = 16,384, M = 72, offsets +-1, +-128, which gives
     their times in the kernels line, and at the Krylov path's P=8 shape,
     M = 64) and the awkward shapes (also 7 diagonals with M = 3,
     and offsets all negative), tolerance c64 1e-5, c128 1e-13, the
     library time a complex CSR product; and that a CUDA entry refuses a
     wrong dtype, a non-contiguous operand and a CPU tensor;
  3e. the complex one-step entries cheb_step_c64/c128 (ops/csrc/
     cheb_step.cu) against their plain version at the shape of each
     operator this script runs them on: the herm_p9 cell's Hofstadter
     cylinder (512 x 512 sites: N = 262,144, M = 72, seven complex
     diagonals 0, +-1, +-511, +-512), phase 11 leg 1's gauge-rotated P=10
     Laplacian (N = 1,048,576, M = 72, five) and phase 11's banded
     Hermitian leg (N = 65,536, M = 24, nine), each operator's Gershgorin
     interval mapped onto [-1, 1] as the solver maps it: one step, then
     8 steps; and at the awkward shapes of phase 3 with complex diagonals; T
     outputs and acc, tolerance relative to max|acc|: one step c64 1e-6,
     c128 1e-14; 8 steps c64 1e-5, c128 1e-13. Then at each of the three
     shapes each entry's time per launch (CUDA events), its plain
     version's, and the bound (5 planes and the diagonals at the card's
     bandwidth); the kernels line gives herm_p9's as the row's own;
  3d. the seeded subspace drawn on the card (ops/seeded_draw.py,
     ops/csrc/seeded_draw.cu): the card's log1p and exp against the host
     libm's (the once-a-process check, which must pass), then
     seeded_subspace_f32_bits at the main path's shape (N = 1,048,576,
     M0 = 72) and the consistent-mass cell's (N = 65,536, M0 = 72) held
     bit for bit against the host draw it replaces (seeded_subspace(...)
     rounded to float32 and widened), its five launches a draw, its time
     (CUDA events), the host draw's time, and the bound: the (N, M0)
     float64 buffer written by the parse, read by the column norms, read
     and written by the scaling, at the card's bandwidth;
  4. the main path: feast(lap2d(1024), None, (Emin, Emax), 72, fpm) with
     fpm[3] = 8 and the default fpm[42] (mixed precision on CUDA) under the
     default switches, once cold and three times warm, the kernel launch
     counts (the seeded draw's among them) reset just before the first
     warm solve and read just after it; checks that it drew its subspace
     on the card once (five launches, the libm check already made), M = 52, eigenvalue error against the analytic values <= 1e-8,
     residuals <= 1e-8, info = 0, and, from the series lengths read back
     from that solve, that per filter application the 1-step kernel
     launched once for the init, the 4-step kernel floor(r/4) times and the
     2-step / 1-step tail as r = len(coeffs) - 2 demands, on both rungs;
     then one more warm solve with its stages timed (where the time goes);
  5. P = 9: the same call with fpm[42] = 0 (fp64 kernels only), a
     positive-diagonal-B pencil with analytic eigenvalues, and the default
     call under the default switches, FEAST_CHEB_FUSE4=0 (the 2-step
     kernels carry it) and FEAST_CHEB_FUSE2=0 (the 1-step kernels carry
     every step), which must agree to 1e-8;
  6. the SPD-B path: feast(A, B, (0, Emax), 72, fpm) on the
     consistent-mass pencil of scripts/scale_sparse_gen.py at P=8
     (N = 65,536, A = Dx(x)Mx + Mx(x)Dx, B = Mx(x)Mx, Emax at the gap after
     the 50th analytic eigenvalue, fpm[3] = 8) through the auto route,
     once cold and three times warm, the launch counts reset just before
     the first warm solve and read just after it; checks M against the
     analytic count, eigenvalue error <= 1e-8, residuals <= 1e-8, info 0,
     the launches of every kernel against the schedule the solve's outer
     and inner series imply, on both rungs, and the column-major entries'
     launches by form; then one more warm solve with its stages timed
     (the Lanczos bounds, coefficients, each rung's filter, Rayleigh-Ritz,
     back-transform, Q0), and each rung's launches x times per launch
     (each column-major form's launches x that form's time);
  8. the Krylov contour engine: feast(lap2d(256), None, (Emin, Emax), 72,
     fpm, solver="gmres", solver_maxiter=250) with fpm[3] = 8 and the
     default fpm[42] (complex64 Krylov inside a complex128 refinement on
     CUDA), once cold and once warm; checks M = 52, eigenvalue
     error <= 1e-8, residuals <= 1e-8, info 0, the multigrid
     preconditioner with 4 levels, and that each DIA entry's launches in
     the cold solve (counts set to 0 just before, read just after) equal
     the count the solve's own Krylov record implies
     (``krylov_dia_launches``); the warm solve has its stages timed; then
     one with FEAST_GROUP_MAX=1 (the unbatched entries carry every apply,
     counted and held to its record the same way) that must agree with
     the default node groups to 1e-8;
  9. the consistent-mass pencil at P = 7 (N = 16,384) through
     solver="gmres" with grid=(128, 128) (multigrid with a B stencil),
     against its analytic eigenvalues, its launches held to its record;
  10. the direct-solver contour engines, through the entry points with the
     default device, each leg once cold and three times warm (the median,
     the peak device memory and the Chebyshev kernels' launches of the
     first warm solve), then once with its stages timed (factorization,
     filter solves or polynomial filter, Rayleigh-Ritz), checked for M,
     the eigenvalues against float64 LAPACK on the host (f32 1e-5 times
     max(1, |lam|), real symmetric 1e-10, Hermitian 1e-9, sparse 1e-8),
     residuals <= the
     solve's tolerance, info 0 and the engine that ran: config 2 of the
     JAX package's bench.py (feast_sygv, n = 2048, f32, M0 = 32, 16
     nodes, 24 eigenvalues; the dense engine) and its complex128 Hermitian
     counterpart (feast_hegv); config 1 (the quickstart, n = 100); config 3
     (feast_banded, n = 2048, kd = 4, f32: block cyclic reduction); the
     banded throughput leg (n = 65,536, kd = 4, f32, 20 spikes: the
     polynomial route, its Chebyshev launches counted); the narrow-band
     leg (n = 8192, kd = 2, as CSR through feast, f32 and f64: the
     narrow-band hand-off, then the banded driver's polynomial route in
     f32 and, as the JAX package's routing gives under mixed precision,
     BCR in f64); and lap2d(20) under FEAST_CHEB_DEGREE=4 (off the
     polynomial route, so densified onto the dense engine);
  11. complex Hermitian pencils and operators beyond 32 diagonals, through
     the entry points: (1) feast on the P=10 Laplacian under a seeded
     diagonal unitary gauge D A D^* (five complex diagonals, the spectrum
     exactly lap2d's; the polynomial path's fused complex one-step
     entries, cheb_step_c64 on the f32 rung and cheb_step_c128 on the
     fp64 rung, and dia_matvec_c128 for Rayleigh-Ritz) once cold and twice
     warm (the first with every kernel's launches counted, which must show
     those entries and no real DIA entry or real Chebyshev kernel; the
     second with its stages timed: each rung's filter, its launches inside
     the filter and their time a launch against the bound, Rayleigh-Ritz,
     host set-up), checked
     for M = 52, error <= 1e-8, residuals <= 1e-8 and info 0; (2) the P=9
     Laplacian under a seeded symmetric permutation (hundreds of DIA
     diagonals: the unfused recurrence on torch CSR products, no kernel
     launched), cold and once warm; (3) the P=8 consistent-mass pencil
     under one seeded permutation of A and B (the host scipy bounds of B~
     and of the pencil's edge, the composite on CSR products), once; (4)
     the P=7 Laplacian with a uniform phase on its +-1 bonds through
     solver="gmres" (the mirrored node set, multigrid on the complex
     stencil, the batched complex entries, launches held to the Krylov
     record); (5) feast_hbev on a
     Hermitian band (n = 65,536, kd = 4, complex64: the banded driver's
     polynomial route, the c64 entry) against float64 LAPACK; (6) the
     crowded Hermitian tridiagonal of tests/test_sparse_matfree.py
     (n = 240) through feast_hcsrev: the banded engine (BCR);
  12. the general-contour family through the entry points with the
     default device: (1) feast_general on A = (1 + 0.5i) T (x) I + I (x) T
     at P=8 (N = 65,536, five constant complex diagonals, non-Hermitian,
     normal and complex symmetric, eigenvalues exactly (1 + 0.5i) mu_j +
     mu_k), the circle (0.005, 0.0055446) holding 44 of them, M0 = 72,
     fpm[3] = 8: the Krylov engine on the full contour (16 nodes, complex64
     GMRES inside a complex128 refinement, multigrid), once cold with
     every DIA entry's launches held to the solve's Krylov record and the
     peak device memory, once warm with its stages timed (filter, GMRES,
     Gram-Schmidt, V-cycle, SVD, reduced eig, Rayleigh-Ritz, host set-up)
     and its DIA launches x their phase-3c time at its own shapes; M = 44,
     info 0, residuals <= 1e-8, eigenvalue error <= 1e-7; (2) the same
     operator at P=7 with complex_symmetric=True (the transpose pairing),
     44 inside, once, counted; (3) T + 0.5i T^2 (n = 8192, kd = 2) as CSR
     through feast_gcsrev around 21 mid-spectrum eigenvalues: the
     narrow-band hand-off to BCR; (4) config 5 dense (bench.py's
     _general_bench: n = 1024 complex64, feast_general, 16 inside) and (5)
     its polynomial leg (_pep_bench: n = 512 complex64, feast_polynomial
     with method "companion" and "direct"), each once cold and three times
     warm (the median), then once with its stages timed, against the
     stated eigenvalues (complex128 1e-7, complex64 1e-5 x max(1, |lam|));
     phase 3c holds the complex entries leg (1) launches at its shapes;
  13. the matrix-free drivers and the RCI step machines through the entry
     points on the card: (1) feast on a LinearOperator whose matvec is
     dia_matvec_f64 on the P=10 Laplacian's five diagonals (BASELINE.json
     config 4, N = 1,048,576, the main path's interval, M0 = 72, fpm[3] =
     8), solver="cheb": 192 Lanczos steps for the bounds, the unfused
     Chebyshev recurrence on the operator; once cold with the peak device
     memory and the launches counted and held to their reckoning (192 +
     applications x (series length - 1) + 2 per loop, from the series
     and the applications the solve records), once warm with its stages
     timed (Lanczos bounds, filter, Rayleigh-Ritz, Q0; the filter's
     launches x phase 3c's time at this shape); M = 52, error <= 1e-8,
     residuals <= 1e-8, info 0, no other kernel launched; (2) the
     matrix-free Krylov engine (unpreconditioned GMRES(30), then BiCGStab)
     through feast on the real Laplacian's DIA operator at
     P = MATFREE_P_REAL (the complex blocks as two real products), and
     feast_general on phase 12's complex stencil at P = MATFREE_P_GEN (a
     circle holding 40), against the analytic eigenvalues (1e-8 / 1e-7);
     (3) feast_polynomial(method="matfree") on config 5's coefficients as
     operators on the card (1e-5 x max(1, |lam|)), and feast_matvec on
     config 2's pencil in float64 with the caller's solve_shifted (torch LU
     on the card) against float64 LAPACK (1e-10); (4) FeastSRCI on config
     2's pencil (float64, 16 nodes, M0 = 32) and FeastGRCI on config 5's
     dense matrix (complex128, M0 = 24), serviced with torch LU on the
     card, against the port's feast_sygv / feast_general there (1e-10 /
     1e-7), each timed;
  14. the public surface on the card: (1) dfeast_scsrev on BASELINE.json
     config 4 at P=10 (the main path under its FEAST name), its launches
     counted and equal to the main path's, its eigenvalues within 1e-12 of
     the main path's feast call (run here when phase 4 is not), M = 52,
     error <= 1e-8, residuals <= 1e-8, info 0; (2) save_checkpoint of that
     solve into a temporary directory, load_checkpoint, and feast with
     resume_kwargs: no seeded Q0 drawn, on the host or the card, the same M, eigenvalues within
     1e-10 of (1), no more loops; (3) the stochastic count fpm[14] = 2
     (fpm[32] = 10 probes): the unfused recurrence on dia_matvec_f64 at
     (N, 10), its launches equal to the series' products, |est - 52| <=
     5 sqrt(2 x 52 / 10), then the same filter on the same probes with the
     plain DIA product on the card tensors within 1e-9 relative; (4)
     zfeast_heev, dfeast_sbev, cfeast_geev, zfeast_syev, zfeast_gepev,
     difeast_scsrev, dfeast_syevx, eigvals_feast and feast_srci on small
     problems against the port's generic drivers (1e-12; the RCI machine
     1e-10), and a torch.profiler trace (trace_to) of one small polynomial
     solve, whose CUDA events must name a Chebyshev or DIA kernel; phase
     3c holds and times dia_matvec_f64 at the count's (N, 10) shape;
  15. the sharded drivers (parallel/pfeast.py): the gloo calls the drivers
     make, each on a tiny CUDA tensor first, then two ranks of a gloo
     world on the one card (this script with --sharded-rank, both on
     cuda:0) run (1) the main path with its columns over the ranks:
     pfeast_sparse(solver="cheb") on contour_mesh(2) at P=10, M0 = 72,
     36 columns a rank, M = 52, eigenvalues within 1e-8 of the analytic
     ones and within 1e-12 of phase 4's serial solve (equal to the bit or
     not, printed), residuals <= tol, each rank's launches of rows 1-6
     equal to the serial schedule's; (2) the contour-sharded Krylov
     engine at P=7 (lap2d(128), solver="gmres", multigrid) and (3) the
     model-sharded one at P=6 (contour_model_mesh(1, 2): each rank's rows,
     halo products on the extended blocks, the V-cycle's rows gathered),
     the analytic M, eigenvalues within 1e-8, residuals <= tol, DIA
     launches equal to the Krylov record's; (4) dense config 2
     (pfeast_dense, f32, n = 2048) on a 1 x 2 contour x rhs mesh, M = 24
     within 1e-5; (5) fpm[14] = 2 through leg 2's sharded filter, within
     5 sqrt(2M/10) of leg 2's M; each leg's time per rank beside the
     card's name and power limit (two ranks share one card: no speed-up
     can be read); and the stencil as one convolution
     (FEAST_STENCIL_CONV=1) against the shifted adds at the P=8 grid,
     float32;
  7. one JSON line {"kernels": [...]} with each kernel's launches on its
     path (the main path's, for the composite's own kernels the SPD-B
     path's, for the real DIA kernels the Krylov path's: phase 8's counted
     solves; for the complex DIA entries phase 11's Hermitian P=10 leg,
     unbatched, and its Krylov leg, batched; "path" names it; the complex
     entries leg (1) of phase 12 launches carry a "general_p8" object with
     that leg's launches and phase 3c's times at its shapes; the fp64
     entry's "matfree_p9" object has phase 13 leg (1)'s launches at P=9,
     and its "count_p10" object phase 14 leg (3)'s launches and phase
     3c's times at the count's shape; every entry phase 15 launches has a
     "sharded" object, its launches on each rank per leg), its error
     against its plain version and its times (for seeded_draw_f64 the host
     draw's, phase 3d's times at the main path's shape and, under
     "cmass_p8", at the consistent-mass cell's); the
     column-major entries' ms, bound_ms and library_ms are those of the
     form without T0 and acc, and their "forms" give every form's times,
     bound and launches.
Run without a flag, the script leaves out the staged warm solves of phase
8, of phase 11 leg (1), of phase 12 leg (1) and of phase 13 leg (1), runs
phase 11 leg (3) at P=7, phase 13 leg (1) at P=9 and its leg (2) at
P=5, to finish inside its time limit with phases 13, 14 and 15;
--hermitian, --general and --matfree run those phases at full depth.
The last line is {"ok": true, "device": {...}}. Any failed check raises
and exits nonzero before that line. Without a CUDA device the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

# Published HBM bandwidth (bytes/s) and non-tensor-core peaks (FLOP/s) of
# the H100 parts, from NVIDIA's data sheets; the SXM part is the default.
_CARDS = {"PCIe": (2.0e12, 51.2e12, 25.6e12),
          "NVL": (3.9e12, 60.0e12, 30.0e12),
          "SXM": (3.35e12, 67.0e12, 34.0e12)}


def _card_rates(name):
    for key in ("PCIe", "NVL"):
        if key in name:
            return _CARDS[key]
    return _CARDS["SXM"]


def lap2d(nx):
    import scipy.sparse as sp
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    return (sp.kron(D, sp.eye(nx)) + sp.kron(sp.eye(nx), D)).tocsr()


def lap2d_eigs(nx, kmax=200):
    wx = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    k = min(kmax, nx)
    return np.sort((wx[:k, None] + wx[None, :k]).ravel())


def interval_lowest(w, count=50):
    """(Emin, Emax, expected) for the lowest ~count eigenvalues with Emax
    at a genuine gap (the rule of the repo's scale experiments)."""
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, count)]
    Emin = float(w[0] * 0.5)
    Emax = float(0.5 * (w[hi] + w[hi + 1]))
    return Emin, Emax, w[(w >= Emin) & (w <= Emax)]


def separable_pencil(nx, seed):
    """A = Dx (x) By + Bx (x) Dy, B = Bx (x) By (positive diagonal): a
    five-point pencil whose eigenvalues are mu_i + nu_j of the two 1D
    generalized tridiagonal problems, so they are known exactly."""
    import scipy.linalg as sla
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    bx = 1.0 + 0.5 * rng.random(nx)
    by = 1.0 + 0.5 * rng.random(nx)

    def gen_eigs(b):
        s = 1.0 / np.sqrt(b)
        return sla.eigh_tridiagonal(2.0 * s * s, -s[:-1] * s[1:],
                                    eigvals_only=True)

    Bx, By = sp.diags(bx), sp.diags(by)
    A = (sp.kron(D, By) + sp.kron(Bx, D)).tocsr()
    B = sp.kron(Bx, By).tocsr()
    mu, nu = gen_eigs(bx)[:200], gen_eigs(by)[:200]
    return A, B, np.sort((mu[:, None] + nu[None, :]).ravel())


def consistent_mass_pencil(p):
    """The consistent-mass rung of scripts/scale_sparse_gen.py: on an
    nx = 2^p grid, A = Dx (x) Mx + Mx (x) Dx and B = Mx (x) Mx with
    Mx = (1/6)[1 4 1], nine diagonals each. The pencil's eigenvalues are
    mu_i + mu_j of the 1D pencil Dx v = mu Mx v (one dense eigh)."""
    import scipy.linalg as sla
    import scipy.sparse as sp
    nx = 2 ** p
    Dx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    Mx = sp.diags([4 / 6, 1 / 6, 1 / 6], [0, 1, -1], shape=(nx, nx))
    A = (sp.kron(Dx, Mx) + sp.kron(Mx, Dx)).tocsr()
    B = sp.kron(Mx, Mx).tocsr()
    mu = sla.eigh(Dx.toarray(), Mx.toarray(), eigvals_only=True)
    return A, B, np.sort((mu[:64, None] + mu[None, :64]).ravel())


def congruenced_dia(A, B):
    """The unit-diagonal congruences of A and B as (nd, N) DIA arrays and
    offsets, as the solver builds them."""
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    from feastkit_tpu_torch.solvers.sparse import sparse_coo_arrays
    d = 1.0 / np.sqrt(B.diagonal())
    out = []
    for X in (A, B):
        data, idx, _ = sparse_coo_arrays(X, np.float64)
        out.append(bcoo_to_dia(data * d[idx[:, 0]] * d[idx[:, 1]], idx,
                               X.shape[0]))
    return out


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def cuda_time_ms(fn, reps, warm=3):
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_time_ms(fn, reps=20, replays=20):
    """Device time per call of ``fn`` (a few kernel launches and no host
    synchronisation): ``reps`` calls captured in one CUDA graph, the graph
    replayed ``replays`` times between CUDA events. Without the host's
    per-call cost (Python, ctypes, the launch itself), which for a kernel
    of tens of microseconds can exceed the kernel."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: a launch may set its kernel's shared-memory attribute
    # (cudaFuncSetAttribute) while the graph is captured
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    ms = cuda_time_ms(graph.replay, replays, warm=2) / reps
    del graph
    return ms


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"== 1. card: {smi}", flush=True)
    print(f"   torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return smi


RUNTIME_COUNT_ONLY = ("-DCHEB_RUNTIME_COUNT_ONLY",)
MULTISTEP_SOURCES = ("cheb_stream4",)


def phase_build():
    """Build every source, and the multi-step kernels with the run-time
    diagonal count only (timed against the nine-diagonal instantiation,
    phase 3b), one nvcc per build, all started together; beside them the
    ptxas reports of cheb_step_cm.cu and dia_matvec.cu (printed in phases
    3b and 3c)."""
    from feastkit_tpu_torch.ops import cuda_build
    sources = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
    builds = [(name, ()) for name in sources] + [
        (name, RUNTIME_COUNT_ONLY) for name in MULTISTEP_SOURCES]
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds) + 2) as pool:
        reports = {src: pool.submit(_ptxas, src)
                   for src in ("cheb_step_cm", "dia_matvec")}
        list(pool.map(lambda b: cuda_build.build(*b), builds))
        reports = {src: r.result() for src, r in reports.items()}
    dt = time.perf_counter() - t0
    print(f"== 2. built {sources} and {MULTISTEP_SOURCES} with "
          f"{RUNTIME_COUNT_ONLY} for sm_90a in {dt:.2f} s", flush=True)
    return reports


KERNELS = {   # name -> (steps per launch, source, TPU kernel it replaces)
    "cheb_step_f32": (1, "cheb_step.cu", "feastkit_tpu/ops/cheb_pallas.py:685"),
    "cheb_step_f64": (1, "cheb_step.cu", "feastkit_tpu/ops/cheb_pallas.py:256"),
    # no TPU kernel: the JAX package runs a complex recurrence unfused
    "cheb_step_c64": (1, "cheb_step.cu", None),
    "cheb_step_c128": (1, "cheb_step.cu", None),
    "cheb_step_cm_f32": (1, "cheb_step_cm.cu",
                         "feastkit_tpu/ops/cheb_pallas.py:685"),
    "cheb_step_cm_f64": (1, "cheb_step_cm.cu",
                         "feastkit_tpu/ops/cheb_pallas.py:256"),
    "cheb_combine_f32": (0, "cheb_combine.cu",
                         "feastkit_tpu/ops/cheb_pallas.py:990"),
    "cheb_combine_f64": (0, "cheb_combine.cu",
                         "feastkit_tpu/ops/cheb_pallas.py:990"),
    "cheb_step2_f32": (2, "cheb_stream4.cu",
                       "feastkit_tpu/ops/cheb_pallas.py:749"),
    "cheb_step4_f32": (4, "cheb_stream4.cu",
                       "feastkit_tpu/ops/cheb_pallas.py:847"),
    "cheb_step2_f64": (2, "cheb_stream4.cu",
                       "feastkit_tpu/ops/cheb_pallas.py:370"),
    "cheb_step4_f64": (4, "cheb_stream4.cu",
                       "feastkit_tpu/ops/cheb_pallas.py:522"),
}


def _planes(torch, dtype, shape, count, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(*shape, generator=g, device="cuda", dtype=dtype)
            for _ in range(count)]


def _errors(k, p):
    """Max abs error over the carry (T outputs and acc) and that error
    relative to max|acc| of the plain version."""
    err = max(float((a - b).abs().max()) for a, b in zip(k, p))
    return err, err / float(p[2].abs().max())


def _compare(torch, wrapper, plain, dia, offsets, carry, sc, sh, coeffs):
    """Run len(coeffs) 1-step launches through the kernel and the plain
    version from the same row-major carry (T0, T1, acc)."""
    k = [t.clone() for t in carry]
    p = [t.clone() for t in carry]
    for ck in coeffs:
        wrapper(dia, offsets, k[0], k[1], k[2], sc, sh, ck)
        k[0], k[1] = k[1], k[0]
        plain(dia, offsets, p[0], p[1], p[2], float(sc), float(sh),
              float(ck))
        p[0], p[1] = p[1], p[0]
    torch.cuda.synchronize()
    return _errors(k, p)


def _compare_multi(torch, wrapper, plain, S, dia, offsets, carry, sc, sh,
                   coeffs):
    """Run len(coeffs) / S consecutive passes through the multi-step
    kernel and its plain version from the same column-major carry; the
    output pair of one pass is the input pair of the next."""
    k = [t.clone() for t in carry] + [torch.empty_like(carry[0])
                                      for _ in range(2)]
    p = [t.clone() for t in k]
    for i in range(0, len(coeffs), S):
        wrapper(dia, offsets, *k, sc, sh, coeffs[i:i + S])
        plain(dia, offsets, *p, float(sc), float(sh), coeffs[i:i + S])
        k = [k[3], k[4], k[2], k[0], k[1]]
        p = [p[3], p[4], p[2], p[0], p[1]]
    torch.cuda.synchronize()
    return _errors(k[:3], p[:3])


def _awkward_operators():
    """(diags, offsets, N, M): three five-point operators with M = 11, 1,
    40 and N = 1073, 1073, 1089; one whose 2 max|offset| exceeds N; a
    3-diagonal and an 11-diagonal operator (the multi-step kernels have a
    body for five diagonals and one for any other count); and a 7-point 3D
    stencil on a 20 x 17 x 5 grid (cheb_step4_f32's ND = 7 body)."""
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    from feastkit_tpu_torch.solvers.sparse import sparse_coo_arrays
    out = []
    for (ax, ay, am) in ((37, 29, 11), (29, 37, 1), (33, 33, 40)):
        d2, i2, _ = sparse_coo_arrays(sp_awkward(ax, ay), np.float64)
        dn, on = bcoo_to_dia(d2, i2, ax * ay)
        out.append((dn, on, ax * ay, am))
    rng = np.random.default_rng(60)
    for N, am, offs in ((100, 7, (-60, -1, 0, 1, 60)),
                        (1073, 5, (-1, 0, 1)),
                        (1089, 3, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40)),
                        (1700, 6, (-340, -20, -1, 0, 1, 20, 340))):
        dn = np.zeros((len(offs), N))
        for k, d in enumerate(offs):
            dn[k, max(0, -d):N - max(0, d)] = rng.random(N - abs(d)) - 0.5
        out.append((dn, offs, N, am))
    return out


def phase_kernels(card_name):
    import torch
    from feastkit_tpu_torch.ops import cheb_kernels as ck
    from feastkit_tpu_torch.ops.chebfilter import gershgorin_interval
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    from feastkit_tpu_torch.solvers.sparse import sparse_coo_arrays
    bw, peak32, peak64 = _card_rates(card_name)
    print("== 3. kernels against their plain versions", flush=True)
    nx = 1024
    A = lap2d(nx)
    data, idx, _ = sparse_coo_arrays(A, np.float64)
    N, M = nx * nx, 72
    lo, hi = gershgorin_interval(data, idx, N)
    dia_np, offsets = bcoo_to_dia(data, idx, N)
    dia64 = torch.as_tensor(dia_np, device="cuda")
    nd = len(offsets)
    coeffs = np.random.default_rng(0).standard_normal(8) * 0.1
    awkward = _awkward_operators()
    # the card's sustained copy rate, for scale: 2 GiB read + 2 GiB written
    src_buf = torch.empty(2**29, device="cuda", dtype=torch.float32)
    dst_buf = torch.empty_like(src_buf)
    copy_ms = cuda_time_ms(lambda: dst_buf.copy_(src_buf), 20)
    copy_tbs = 2 * src_buf.numel() * 4 / (copy_ms * 1e-3) / 1e12
    print(f"   device copy: {copy_tbs:.3f} TB/s sustained (published "
          f"{bw / 1e12:.2f} TB/s)", flush=True)
    del src_buf, dst_buf
    out = {"copy_tbs": copy_tbs}
    plains = {1: ck.cheb_step_plain, 2: ck.cheb_step2_plain,
              4: ck.cheb_step4_plain}
    for dtype, tol, peak, names in (
            (torch.float32, 1e-5, peak32,
             ("cheb_step_f32", "cheb_step2_f32", "cheb_step4_f32")),
            (torch.float64, 1e-13, peak64,
             ("cheb_step_f64", "cheb_step2_f64", "cheb_step4_f64"))):
        npd = np.float32 if dtype == torch.float32 else np.float64
        size = torch.finfo(dtype).bits // 8
        sc, sh = npd(2.0 / (hi - lo)), npd((hi + lo) / (hi - lo))
        cs = np.asarray(coeffs, npd)
        dia = dia64.to(dtype)
        with warnings.catch_warnings():   # "CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            Acsr = torch.sparse_csr_tensor(
                torch.as_tensor(A.indptr, dtype=torch.int64),
                torch.as_tensor(A.indices, dtype=torch.int64),
                torch.as_tensor(A.data, dtype=dtype), size=A.shape).cuda()
        x = _planes(torch, dtype, (N, M), 1, 9)[0]
        csr_ms = cuda_time_ms(lambda: torch.sparse.mm(Acsr, x), 20)
        del Acsr, x
        for name in names:
            S = KERNELS[name][0]
            wrapper, plain = getattr(ck, name), plains[S]

            def shape(n, m):
                # row-major (N, M) for the 1-step kernels, column-major
                # (M, N) for the multi-step kernels
                return (n, m) if S == 1 else (m, n)

            carry = _planes(torch, dtype, shape(N, M), 3, 1)
            if S == 1:
                err, rel = _compare(torch, wrapper, plain, dia, offsets,
                                    carry, sc, sh, cs)
            else:
                err, rel = _compare_multi(torch, wrapper, plain, S, dia,
                                          offsets, carry, sc, sh,
                                          cs[:2 * S])
            print(f"   {name} main shapes N={N} M={M} nd={nd}: max abs "
                  f"err {err:.3e}, relative {rel:.3e} (tol {tol:g})",
                  flush=True)
            check(rel <= tol, f"{name} agrees with its plain version at "
                  "the main path's shapes")
            worst = rel
            for dn, on, an, am in awkward:
                dd = torch.as_tensor(dn, device="cuda").to(dtype)
                c2 = _planes(torch, dtype, shape(an, am), 3, 2)
                if S == 1:
                    _, r2 = _compare(torch, wrapper, plain, dd, on, c2,
                                     npd(0.37), npd(0.61), cs[:5])
                else:
                    _, r2 = _compare_multi(torch, wrapper, plain, S, dd, on,
                                           c2, npd(0.37), npd(0.61),
                                           cs[:2 * S])
                print(f"   {name} N={an} M={am} offsets={on}: relative "
                      f"{r2:.3e}", flush=True)
                check(r2 <= tol, f"{name} agrees at N={an} M={am}")
                worst = max(worst, r2)
            # time per launch at the main path's shapes
            if S > 1:
                carry += [torch.empty_like(carry[0]) for _ in range(2)]
            cks = [0.01] * S

            def kern():
                if S == 1:
                    wrapper(dia, offsets, *carry, sc, sh, 0.01)
                    carry[0], carry[1] = carry[1], carry[0]
                else:
                    wrapper(dia, offsets, *carry, sc, sh, cks)
                    carry[:] = [carry[3], carry[4], carry[2], carry[0],
                                carry[1]]

            def plain_fn():
                if S == 1:
                    plain(dia, offsets, *carry, float(sc), float(sh), 0.01)
                    carry[0], carry[1] = carry[1], carry[0]
                else:
                    plain(dia, offsets, *carry, float(sc), float(sh), cks)
                    carry[:] = [carry[3], carry[4], carry[2], carry[0],
                                carry[1]]

            before = wrapper.launches
            ms = cuda_time_ms(kern, 100)
            plain_ms = cuda_time_ms(plain_fn, 10)
            check(wrapper.launches == before + 103,
                  f"{name} counts one launch per call")
            # least bytes: T0, T1, acc read, two T planes (one for the
            # in-place 1-step kernel) and acc written, the diagonals once
            nbytes = ((5 if S == 1 else 6) * N * M + nd * N) * size
            flops = S * N * M * (2 * nd + 6)
            bound_ms = max(nbytes / bw, flops / peak) * 1e3
            line = (f"   {name}: {ms:.4f} ms/launch = {ms / S:.4f} ms/step "
                    f"(plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
                    f"{nbytes / 1e9:.3f} GB at {bw / 1e12:.2f} TB/s, "
                    f"{bound_ms / ms:.1%} of bound; torch.sparse.mm CSR "
                    f"matvec alone {csr_ms:.4f} ms)")
            plan = (ck.multistep_plan(offsets, N, M, dtype, S)
                    if S > 1 else None)
            if plan:
                rec = ck.reckoned_traffic(plan, offsets, N, size)
                shape = (f"strips of {plan['tile']} rows x {plan['groups']} "
                         f"groups of {plan['cols']} columns = "
                         f"{plan['tiles'] * plan['groups']} blocks, lag "
                         f"{plan['lag']}, {plan['blocks_per_sm']} per SM by "
                         "its budget")
                line += (f"\n      {shape}, halo {plan['halo']}, "
                         f"{plan['shared_bytes']} B shared per block; "
                         "reckoned from the plan, not measured: recompute "
                         f"{rec['recompute']:.3f}, L2 bytes per element "
                         f"{rec['l2_bytes_per_element']:.1f}")
            print(line, flush=True)
            out[name] = dict(
                max_abs_err=err, max_rel_err=worst, ms=ms, ms_per_step=ms / S,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / bw >= flops / peak
                else "operations", csr_spmm_ms=csr_ms)
            if S == 2:
                out[name]["p9"] = _two_step_p9(torch, ck, name, dtype, tol,
                                               bw, M, sc, sh)
            del carry
            torch.cuda.empty_cache()
        del dia
    return out


def _coo_dia(A):
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    C = A.tocoo()
    return bcoo_to_dia(C.data, np.stack([C.row, C.col], 1), A.shape[0])


def cylinder_dia(nx, ny, flux=1 / 4096, seed=0):
    """The Harper-Hofstadter cylinder of the herm_p9 cell (the benchmark's
    generator, a seeded potential) in DIA form: seven complex diagonals
    0, +-1, +-(ny - 1), +-ny."""
    from portbench.generators import hofstadter_cyl
    v = 0.01 * np.random.default_rng(seed).standard_normal(nx)
    return _coo_dia(hofstadter_cyl.operator(v, flux, ny))


def complex_step_shapes():
    """(label, diags, offsets, M) of each operator on which this script
    launches cheb_step_c64 / _c128: the herm_p9 cell's cylinder (N =
    262,144, seven diagonals), phase 11 leg 1's gauge-rotated P=10
    Laplacian (N = 1,048,576, five) and phase 11's banded Hermitian leg
    (N = 65,536, kd 4: nine)."""
    import scipy.sparse as sp
    nx, kd = 1024, 4
    lap = gauge_rotated(lap2d(nx), np.random.default_rng(12).uniform(
        0.0, 2.0 * np.pi, nx * nx))
    bands = banded_hermitian_throughput(kd=kd)
    n = bands.shape[1]
    # row r of the band holds offset kd - r (band_eigs' upper layout)
    band = sp.diags([bands[r, kd - r:] if r <= kd else bands[r, :n + kd - r]
                     for r in range(2 * kd + 1)],
                    [kd - r for r in range(2 * kd + 1)])
    return [("herm_p9", *cylinder_dia(512, 512), 72),
            ("hermitian_p10", *_coo_dia(lap), 72),
            ("banded_hermitian", *_coo_dia(band), 24)]


def phase_complex_kernels(card_name):
    """Phase 3e: the complex one-step entries against their plain version
    at the shape of every operator this script runs them on and at phase
    3's awkward shapes, and their time a launch against the bound at each
    of those operators' shapes. The row's own numbers are herm_p9's."""
    import torch
    from feastkit_tpu_torch.ops import cheb_kernels as ck
    from feastkit_tpu_torch.ops.chebfilter import _map_scalars
    bw, _, peak64 = _card_rates(card_name)
    print("== 3e. complex one-step entries against their plain version",
          flush=True)
    shapes = complex_step_shapes()
    coeffs = np.random.default_rng(0).standard_normal(8) * 0.1
    rng = np.random.default_rng(61)
    awkward = [(dn * np.exp(2j * np.pi * rng.random(dn.shape)), on, an, am)
               for dn, on, an, am in _awkward_operators()]
    out = {}
    for name, dtype, tol1, tol8 in (
            ("cheb_step_c64", torch.complex64, 1e-6, 1e-5),
            ("cheb_step_c128", torch.complex128, 1e-14, 1e-13)):
        wrapper, plain = getattr(ck, name), ck.cheb_step_plain
        size = torch.empty((), dtype=dtype).element_size()
        rows = {}
        for label, dia_np, offsets, M in shapes:
            N, nd = dia_np.shape[1], len(offsets)
            # the solver's map: the operator's Gershgorin interval onto
            # [-1, 1], in the rung's real precision
            d0 = np.real(dia_np[offsets.index(0)]).astype(np.float64)
            radius = np.abs(dia_np).astype(np.float64).sum(0) - np.abs(d0)
            sc, sh = _map_scalars(float((d0 - radius).min()),
                                  float((d0 + radius).max()), dtype)
            dia = torch.as_tensor(dia_np, device="cuda").to(dtype)
            carry = _planes(torch, dtype, (N, M), 3, 1)
            _, rel1 = _compare(torch, wrapper, plain, dia, offsets, carry,
                               sc, sh, coeffs[:1])
            err, rel = _compare(torch, wrapper, plain, dia, offsets, carry,
                                sc, sh, coeffs)
            print(f"   {name} {label} N={N} M={M} nd={nd}: one step "
                  f"relative {rel1:.3e} (tol {tol1:g}); 8 steps max abs "
                  f"err {err:.3e}, relative {rel:.3e} (tol {tol8:g})",
                  flush=True)
            check(rel1 <= tol1 and rel <= tol8,
                  f"{name} agrees with its plain version at {label}'s shape")

            def kern():
                wrapper(dia, offsets, *carry, sc, sh, 0.01)
                carry[0], carry[1] = carry[1], carry[0]

            def plain_fn():
                plain(dia, offsets, *carry, sc, sh, 0.01)
                carry[0], carry[1] = carry[1], carry[0]

            before = wrapper.launches
            ms = cuda_time_ms(kern, 100)
            plain_ms = cuda_time_ms(plain_fn, 10)
            check(wrapper.launches == before + 103,
                  f"{name} counts one launch per call")
            # least bytes: T0, T1, acc read, T2 and acc written, the
            # diagonals once; the real operations of a complex step
            # (8 nd + 10)
            nbytes = (5 * N * M + nd * N) * size
            flops = N * M * (8 * nd + 10)
            bound_ms = max(nbytes / bw, flops / peak64) * 1e3
            print(f"   {name} {label}: {ms:.4f} ms/launch (plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
                  f"{nbytes / 1e9:.3f} GB at {bw / 1e12:.2f} TB/s, "
                  f"{bound_ms / ms:.1%} of bound)", flush=True)
            rows[label] = dict(
                shape=[N, M, nd], max_abs_err=err, max_rel_err=rel,
                one_step_rel_err=rel1, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes"
                if nbytes / bw >= flops / peak64 else "operations")
            del carry, dia, kern, plain_fn
            torch.cuda.empty_cache()
        worst = max(r["max_rel_err"] for r in rows.values())
        for dn, on, an, am in awkward:
            dd = torch.as_tensor(dn, device="cuda").to(dtype)
            c2 = _planes(torch, dtype, (an, am), 3, 2)
            _, r2 = _compare(torch, wrapper, plain, dd, on, c2, 0.37, 0.61,
                             coeffs[:5])
            print(f"   {name} N={an} M={am} offsets={on}: relative "
                  f"{r2:.3e}", flush=True)
            check(r2 <= tol8, f"{name} agrees at N={an} M={am}")
            worst = max(worst, r2)
        out[name] = dict(rows["herm_p9"], max_rel_err=worst,
                         ms_per_step=rows["herm_p9"]["ms"],
                         csr_spmm_ms=None, shapes=rows)
    return out


def _pass_time(torch, ck, S, dtype, dia, offsets, carry, sc, sh):
    """ms per pass of the S-step entry of ``dtype`` on the five
    column-major planes ``carry`` (rotated after each pass as the chunk
    functions rotate them)."""
    rung = "f32" if dtype == torch.float32 else "f64"
    wrapper = getattr(ck, f"cheb_step{S}_{rung}")
    cks = [0.01] * S

    def step():
        wrapper(dia, offsets, *carry, sc, sh, cks)
        carry[:] = [carry[3], carry[4], carry[2], carry[0], carry[1]]
    return cuda_time_ms(step, 100)


def _two_step_p9(torch, ck, name, dtype, tol, bw, M, sc, sh):
    """Phase 3 for a two-step entry at the P=9 shapes (the 2D Laplacian on
    a 512^2 grid, N = 262,144, halo 512; the 2-step passes of the P=9
    FEAST_CHEB_FUSE4=0 solve): against the plain version, its time per
    launch, its bound and the plan's block shape."""
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    from feastkit_tpu_torch.solvers.sparse import sparse_coo_arrays
    size = torch.finfo(dtype).bits // 8
    data, idx, _ = sparse_coo_arrays(lap2d(512), np.float64)
    d9_np, o9 = bcoo_to_dia(data, idx, 512 * 512)
    d9 = torch.as_tensor(d9_np, device="cuda").to(dtype)
    n9 = d9.shape[1]
    planes = _planes(torch, dtype, (M, n9), 5, 11)
    k = [t.clone() for t in planes]
    p_ = [t.clone() for t in planes]
    ck._multistep(getattr(ck, name), 2, dtype, d9, o9, *k, sc, sh,
                  [0.3, -0.2])
    ck._multistep_plain(2, d9, o9, *p_, sc, sh, [0.3, -0.2])
    torch.cuda.synchronize()
    _, rel = _errors([k[3], k[4], k[2]], [p_[3], p_[4], p_[2]])
    check(rel <= tol, f"{name} agrees with its plain version at the P=9 "
          "shapes")
    del k, p_
    ms = _pass_time(torch, ck, 2, dtype, d9, o9, planes, sc, sh)
    bound_ms = (6 * n9 * M + len(o9) * n9) * size / bw * 1e3
    plan = ck.multistep_plan(o9, n9, M, dtype, 2)
    print(f"   {name} P=9 shapes N={n9} M={M} halo {plan['halo']} (strips "
          f"of {plan['tile']} rows x {plan['groups']} groups of "
          f"{plan['cols']} columns): {ms:.4f} ms/launch, bound "
          f"{bound_ms:.4f} ms, {bound_ms / ms:.1%} of bound; relative error "
          f"{rel:.3e}", flush=True)
    del planes, d9
    return dict(ms=ms, bound_ms=bound_ms, max_rel_err=rel)


def _lap3d_dia(nx):
    """The 7-point 3D Laplacian on an nx^3 grid in DIA form (offsets +-1,
    +-nx, +-nx^2), as scripts/scale_sparse_3d.py builds it."""
    import scipy.sparse as sp
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    D = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    eye = sp.eye(nx)
    A = (sp.kron(sp.kron(D, eye), eye) + sp.kron(sp.kron(eye, D), eye)
         + sp.kron(sp.kron(eye, eye), D)).tocoo()
    return bcoo_to_dia(A.data, np.stack([A.row, A.col], axis=1), nx ** 3)


def _lap2d_rect_dia(nx, ny):
    """The 2D Laplacian on an nx x ny grid in DIA form (offsets +-1,
    +-nx): a halo of nx rows at N = nx ny."""
    import scipy.sparse as sp
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    def D(k):
        return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    A = (sp.kron(D(ny), sp.eye(nx)) + sp.kron(sp.eye(ny), D(nx))).tocoo()
    return bcoo_to_dia(A.data, np.stack([A.row, A.col], axis=1), nx * ny)


def stream_sweep(card_name):
    """``--stream-sweep``: the streamed kernels under block shapes,
    schedules and bodies the plan does not take, M = 72, each checked
    against the plain version and timed between two timings of what it is
    compared with:
    - f32 (cheb_step4_f32) at the main shapes (five diagonals,
      N = 1,048,576) and the nine-diagonal P=8 shapes (N = 65,536): 2 and
      1 columns per block against the plan's 4, and T1, T0 and acc brought
      in with cp.async (1 iteration in flight at the main shapes, no more
      fits the shared memory; 1, 2, 4 and 7 at nine diagonals) against the
      register prefetch the plan takes;
    - fp64 (cheb_step4_f64) at the same shapes: the strips cut for 2 and
      3 waves of resident blocks against one wave (the plan takes the cut
      its reckoning says is least), and 1 column per block against the
      plan's 2;
    - wider halos: the 2D Laplacian on a 2048^2 grid (halo 2048) and the
      7-point 3D Laplacian on 32^3 and 64^3 grids (halos 1024 and 4096,
      scripts/scale_sparse_3d.py) in f32; in fp64 the 2D Laplacian on
      1030^2 and 2048^2 grids; and in both the widest halo one column's
      rings hold (a 2D grid of 5632 x 256 in f32, 2816 x 512 in fp64):
      the plan's block shape, or one column per block, against two passes
      of cheb_step2 (the route where the four-step plan refuses a shape),
      the 3D grids against the run-time-count body too, and the plan's
      strip cut against one wave where they differ;
    - the two-step kernels (cheb_step2_f32 / _f64) at every one of those
      operators: each column group (1, 2, 4 in f32; 1, 2 in fp64) with the
      strips cut for 1, 2 and 3 waves and for one block per
      multiprocessor, against the two-step plan.
    Then each instantiation's registers and spills (nvcc -Xptxas -v)."""
    import torch
    from feastkit_tpu_torch.ops import cheb_kernels as ck
    bw, _, _ = _card_rates(card_name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"== sweep: block shapes and bodies of the streamed 4-step kernel "
          f"({sms} SMs)", flush=True)
    A, B, _ = consistent_mass_pencil(8)
    (_, _), (d9, o9) = congruenced_dia(A, B)
    M = 72
    cks = [0.01] * 4
    rows = []
    f32, f64 = torch.float32, torch.float64
    operators = [("nd5", f32, 1024, 1024), ("nd9", f32, d9, o9),
                 ("lap2d_2048", f32, 2048, 2048), ("lap3d_32", f32, 32, None),
                 ("lap3d_64", f32, 64, None),
                 ("lap2d_5632x256", f32, 5632, 256),
                 ("nd5", f64, 1024, 1024), ("nd9", f64, d9, o9),
                 ("lap2d_1030", f64, 1030, 1030),
                 ("lap2d_2048", f64, 2048, 2048),
                 ("lap2d_2816x512", f64, 2816, 512)]
    for label, dtype, a, b in operators:
        if label == "nd9":
            dia_np, offsets = a, b
        elif b is None:
            dia_np, offsets = _lap3d_dia(a)
        else:
            dia_np, offsets = _lap2d_rect_dia(a, b)
        size = torch.finfo(dtype).bits // 8
        rung = "f32" if dtype == f32 else "f64"
        # sc maps the spectrum ([0, 8] in 2D, [0, 12] in 3D) into [-1, 1],
        # so the carry stays bounded over the timed passes
        sc = 1 / 6 if label.startswith("lap3d") else 0.25
        sh = 1.0
        tol = 1e-5 if dtype == f32 else 1e-13
        N = dia_np.shape[1]
        halo = max(abs(d) for d in offsets if abs(d) < N)
        dia = torch.as_tensor(dia_np, device="cuda").to(dtype)
        bound_ms = (6 * N * M + len(offsets) * N) * size / bw * 1e3
        carry = _planes(torch, dtype, (M, N), 5, 21)

        def streamed(plan=None, defines=(), steps=4):
            def run(planes):
                ck._multistep(getattr(ck, f"cheb_step{steps}_{rung}"), steps,
                              dtype, dia, offsets, *planes, sc, sh,
                              cks[:steps], defines=defines, plan=plan)
            return run

        def shape(cols, **kw):
            return ck._stream_shape(halo, N, M, cols, sms=sms, itemsize=size,
                                    **kw)

        def named(plan):
            blocks = plan["tiles"] * plan["groups"]
            waves = -(-blocks // (plan["blocks_per_sm"] * sms))
            return (f"{plan['cols']} column" + "s" * (plan["cols"] > 1)
                    + f", {blocks} blocks in {waves} wave" + "s" * (waves > 1))

        def two_step_twice(planes):
            step2 = getattr(ck, f"cheb_step2_{rung}")
            for i in (0, 2):
                step2(dia, offsets, *planes, sc, sh, cks[i:i + 2])
                planes[:] = [planes[3], planes[4], planes[2], planes[0],
                             planes[1]]
            planes[:] = [planes[3], planes[4], planes[2], planes[0],
                         planes[1]]      # undone by the caller's rotation

        # (variant, its function, baseline, its function, steps per pass)
        plan = ck._stream_plan(offsets, N, M, sms, size)
        plan2 = ck._stream_plan(offsets, N, M, sms, size, steps=2)
        pairs = []
        if label in ("nd5", "nd9"):
            base = (f"plan, {named(plan)}", streamed())
            if dtype == f32:
                pairs += [(named(shape(c)), streamed(shape(c)), *base, 4)
                          for c in (2, 1)]
                pairs += [(f"cp.async {depth} in flight", streamed(
                    shape(4, depth=depth)), "register prefetch", streamed(),
                    4) for depth in ((1,) if label == "nd5" else (1, 2, 4, 7))]
            else:
                one = shape(plan["cols"], waves=1)
                pairs += [(f"{w} waves, {named(shape(plan['cols'], waves=w))}",
                           streamed(shape(plan["cols"], waves=w)),
                           f"1 wave, {named(one)}", streamed(one), 4)
                          for w in (2, 3)]
                pairs.append((named(shape(1)), streamed(shape(1)), *base, 4))
        else:
            shp = plan or shape(1)
            name = (f"plan, {named(plan)}" if plan else
                    f"{named(shp)}, refused by the plan")
            step2 = f"2 x cheb_step2_{rung}"
            pairs.append((name, streamed(shp), step2, two_step_twice, 4))
            if plan and plan["cols"] > 1 and ck._stream_ring_bytes(
                    halo, 1, itemsize=size) <= ck.SHARED_BYTES_PER_BLOCK:
                pairs.append((named(shape(1)), streamed(shape(1)), step2,
                              two_step_twice, 4))
            if len(offsets) == 7:
                pairs.append((name, streamed(shp), "run-time count",
                              streamed(shp, RUNTIME_COUNT_ONLY), 4))
            one = shape(shp["cols"], waves=1)
            if one["tiles"] != shp["tiles"]:
                pairs.append((name, streamed(shp), f"1 wave, {named(one)}",
                              streamed(one), 4))
        # the two-step kernel: other column groups and strip cuts (1 to 3
        # waves, and one block per multiprocessor) against its plan
        base2 = (f"2-step plan, {named(plan2)}", streamed(steps=2))
        for c in ck._STREAM_COLS[size]:
            if ck._stream_ring_bytes(halo, c, itemsize=size, steps=2) \
                    > ck.SHARED_BYTES_PER_BLOCK:
                continue
            cuts = {shape(c, waves=w, steps=2)["tiles"] for w in (1, 2, 3)}
            cuts.add(max(1, sms // -(-M // c)))
            for k in sorted(cuts):
                shp2 = shape(c, strips=k, steps=2)
                if (c, shp2["tiles"]) != (plan2["cols"], plan2["tiles"]):
                    pairs.append((f"2-step {named(shp2)}",
                                  streamed(shp2, steps=2), *base2, 2))

        def timed(fn):
            def step():
                fn(carry)
                carry[:] = [carry[3], carry[4], carry[2], carry[0], carry[1]]
            return cuda_time_ms(step, 50 if N > 10**6 else 200)

        for name, fn, base_name, base, S in pairs:
            k = [t.clone() for t in carry]
            p_ = [t.clone() for t in carry]
            fn(k)
            ck._multistep_plain(S, dia, offsets, *p_, sc, sh, cks[:S])
            torch.cuda.synchronize()
            _, rel = _errors([k[3], k[4], k[2]], [p_[3], p_[4], p_[2]])
            check(rel <= tol, f"{rung} {label} {name} agrees with the plain "
                  "version")
            del k, p_
            t_a = timed(base)
            ms = timed(fn)
            t_b = timed(base)
            print(f"   {rung} {label} (N={N}, halo {halo}) {name}: {ms:.4f} "
                  f"ms ({bound_ms / ms:.1%} of the {bound_ms:.4f} ms bound); "
                  f"{base_name} {t_a:.4f} / {t_b:.4f} ms", flush=True)
            rows.append(dict(dtype=rung, operator=label, steps=S,
                             variant=name, ms=ms, baseline=base_name,
                             baseline_ms=[t_a, t_b], bound_ms=bound_ms,
                             max_rel_err=rel))
        del dia, carry
        torch.cuda.empty_cache()
    print(json.dumps({"stream_sweep": rows}), flush=True)
    _print_ptxas("cheb_stream4", _ptxas("cheb_stream4"))
    return rows


# source -> (its kernel template, the names of the template arguments
# after the value type), for the ptxas reports
PTXAS_KERNELS = {
    "cheb_stream4": ("cheb_stream_kernel",
                     ("steps", "nd", "cols", "async_copies")),
    "cheb_step_cm": ("cheb_step_cm_kernel", ("nd", "has_t0", "has_acc")),
    "dia_matvec": ("dia_ring_kernel", ("nd",)),
}


def _ptxas(source):
    """Registers and spill bytes of every instantiation of ``source``'s
    kernel, as ptxas reports them (nvcc -Xptxas -v, the build's flags)."""
    import re
    from feastkit_tpu_torch.ops import cuda_build
    kernel, fields = PTXAS_KERNELS[source]
    src = cuda_build.SRC_DIR / f"{source}.cu"
    out = cuda_build.BUILD_DIR / f"{source}.ptxas.cubin"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v", "-o", str(out),
         str(src)], capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc -Xptxas -v builds {source}.cu")
    report, name = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            t = re.search(kernel + r"I(f|d|6float2|7double2)"
                          r"((?:L[ib]\d+E)+)", name)
            if t:
                args = [int(a) for a in re.findall(r"L[ib](\d+)E",
                                                   t.group(2))]
                report.append(dict(
                    dtype={"f": "f32", "d": "f64", "6float2": "c64",
                           "7double2": "c128"}[t.group(1)],
                    **dict(zip(fields, args)),
                    registers=int(m.group(1)), spill_stores=spill[0],
                    spill_loads=spill[1]))
            name = None
    return report


def _print_ptxas(source, report):
    fields = PTXAS_KERNELS[source][1]
    for r in sorted(report, key=lambda r: (r["dtype"],
                                           *(r[f] for f in fields[::-1]))):
        print(f"   ptxas {source} {r['dtype']} "
              + " ".join(f"{f}={r[f]}" for f in fields)
              + f": {r['registers']} registers, spill stores "
              f"{r['spill_stores']} B, loads {r['spill_loads']} B",
              flush=True)
    check(len(report) > 0, f"ptxas reported {source}'s registers")
    print(json.dumps({"ptxas": {source: report}}), flush=True)


def _cm_operands(form):
    """(has T0, has acc) of a form of the column-major entries."""
    return form in ("full", "no_acc"), form in ("full", "no_t0")


def _cm_compare(torch, ck, wrapper, dia, offs, planes, form, sc, sh, cs):
    """The column-major entry in ``form`` against its plain version from
    the same (M, N) planes (T0, T1, acc): the full form over len(cs)
    steps (the carry rotated as the chunk functions do), the others one
    launch, whose T2 must land in a new plane and which must leave T1 as
    it was. Max abs error over the outputs and that error relative to the
    plain outputs' largest entry."""
    if form == "full":
        return _compare(torch, wrapper, ck.cheb_step_cm_plain, dia, offs,
                        planes, sc, sh, cs)
    has_t0, has_acc = _cm_operands(form)
    c = cs[0] if has_acc else 0.0
    k = [t.clone() for t in planes]
    p = [t.clone() for t in planes]
    ko = wrapper(dia, offs, k[0] if has_t0 else None, k[1],
                 k[2] if has_acc else None, sc, sh, c)
    po = ck.cheb_step_cm_plain(dia, offs, p[0] if has_t0 else None, p[1],
                               p[2] if has_acc else None, float(sc),
                               float(sh), float(c))
    torch.cuda.synchronize()
    check(torch.equal(k[1], planes[1]) and (ko is k[0]) == has_t0
          and ko.data_ptr() != k[1].data_ptr(),
          f"{wrapper.__name__} {form}: T1 untouched, T2 where the form "
          "puts it")
    pairs = [(ko, po)] + [(k[2], p[2])] * has_acc
    err = max(float((a - b).abs().max()) for a, b in pairs)
    return err, err / max(float(b.abs().max()) for _, b in pairs)


def _cm_entry(torch, ck, name, dtype, tol, peak, bw, Acsr, dia_np, offs,
              awkward, cs):
    """Phase 3b for one column-major one-step entry on the nine-diagonal A~
    at the consistent-mass shapes (N = 65,536, M = 72) and at the awkward
    operators: every form (:data:`CM_FORMS`) against the plain version;
    each form's device time per launch (CUDA graph), its time launched one
    call at a time from Python, the plain version's time, its bound (the
    planes the form moves: full 5, no_t0 4, no_acc 3, bare 2) and its share
    of the bound; torch.sparse.mm with A~ in CSR on the (N, M) view of T1,
    the function the bare form computes (its scalars 0.5, 0, as the
    composite's y = A~ T1 launch); and block shapes other than the plan's
    on the bare and full forms, each checked against the plain version."""
    wrapper = getattr(ck, name)
    size = torch.finfo(dtype).bits // 8
    npd = np.float32 if size == 4 else np.float64
    N, M, nd = dia_np.shape[1], 72, len(offs)
    dia = torch.as_tensor(dia_np, device="cuda").to(dtype)
    # A~'s Gershgorin interval mapped onto [-1, 1], so the timed carries
    # stay bounded
    main = dia_np[list(offs).index(0)]
    radius = np.abs(dia_np).sum(axis=0) - np.abs(main)
    lo, hi = float((main - radius).min()), float((main + radius).max())
    sc, sh = npd(2.0 / (hi - lo)), npd((hi + lo) / (hi - lo))
    row = dict(forms={})
    for form in ck.CM_FORMS:
        planes = _planes(torch, dtype, (M, N), 3, 1)
        err, rel = _cm_compare(torch, ck, wrapper, dia, offs, planes, form,
                               sc, sh, cs)
        print(f"   {name} {form} N={N} M={M} nd={nd}: max abs err "
              f"{err:.3e}, relative {rel:.3e} (tol {tol:g})", flush=True)
        check(rel <= tol, f"{name} {form} agrees with its plain version at "
              "the consistent-mass shapes")
        worst = rel
        for dn, on, an, am in awkward:
            dd = torch.as_tensor(dn, device="cuda").to(dtype)
            c2 = _planes(torch, dtype, (am, an), 3, 2)
            _, r2 = _cm_compare(torch, ck, wrapper, dd, on, c2, form,
                                npd(0.37), npd(0.61), cs[:5])
            print(f"   {name} {form} N={an} M={am} offsets={on}: relative "
                  f"{r2:.3e}", flush=True)
            check(r2 <= tol, f"{name} {form} agrees at N={an} M={am}")
            worst = max(worst, r2)
        row["forms"][form] = dict(max_abs_err=err, max_rel_err=worst)
        del planes

    def caller(fn, form, plan=None):
        """One call of the form on a carry of its own; in place forms
        rotate T0 and T1 as the chunk functions do."""
        has_t0, has_acc = _cm_operands(form)
        c = 0.01 if has_acc else 0.0
        carry = _planes(torch, dtype, (M, N), 3, 4)
        kw = {} if plan is None else dict(plan=plan)

        def call():
            fn(dia, offs, carry[0] if has_t0 else None, carry[1],
               carry[2] if has_acc else None, sc, sh, c, **kw)
            if has_t0:
                carry[0], carry[1] = carry[1], carry[0]
        return call

    def with_plan(*a, plan):
        return ck._step_cm(wrapper, dtype, *a, plan=plan)

    for form in ck.CM_FORMS:
        has_t0, has_acc = _cm_operands(form)
        before = wrapper.launches
        eager_ms = cuda_time_ms(caller(wrapper, form), 100)
        check(wrapper.launches == before + 103,
              f"{name} counts one launch per call")
        ms = graph_time_ms(caller(wrapper, form))
        plain_ms = cuda_time_ms(caller(ck.cheb_step_cm_plain, form), 10)
        planes = 2 + has_t0 + 2 * has_acc
        nbytes = (planes * N * M + nd * N) * size
        flops = N * M * (2 * nd + 3 + has_t0 + 2 * has_acc)
        bound_ms = max(nbytes / bw, flops / peak) * 1e3
        print(f"   {name} {form}: {ms:.4f} ms/launch on the device (CUDA "
              f"graph; {eager_ms:.4f} ms launched one call at a time), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms = "
              f"{nbytes / 1e6:.1f} MB ({planes} planes) at "
              f"{bw / 1e12:.2f} TB/s, {bound_ms / ms:.1%} of bound",
              flush=True)
        row["forms"][form].update(
            ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes" if nbytes / bw >= flops / peak
            else "operations")
    # the library call computing the bare form's function, y = A~ T1
    t1 = _planes(torch, dtype, (M, N), 1, 6)[0]
    y = wrapper(dia, offs, None, t1, None, 0.5, 0.0, 0.0)
    ylib = torch.sparse.mm(Acsr, t1.t())
    torch.cuda.synchronize()
    lib_rel = float((y.t() - ylib).abs().max() / ylib.abs().max())
    check(lib_rel <= tol, f"{name} bare form (0.5, 0, 0) equals "
          f"torch.sparse.mm with A~ ({lib_rel:.2e})")
    library_ms = cuda_time_ms(lambda: torch.sparse.mm(Acsr, t1.t()), 100)
    bare = row["forms"]["bare"]
    print(f"   {name}: torch.sparse.mm (A~ CSR, T1 as (N, M)) "
          f"{library_ms:.4f} ms against the bare form's {bare['ms']:.4f} ms "
          f"(device) / {bare['eager_ms']:.4f} ms (one call at a time)",
          flush=True)
    del t1, y, ylib
    # what the bare form costs beyond its bytes: its device time at
    # M = 8 ... 144 fitted as a + b M (a: what a launch costs whatever its
    # size), and a device copy of the same two planes (T1 read, T2 written)
    ms_of_m = {}
    for m in (8, 24, 72, 144):
        x = _planes(torch, dtype, (m, N), 1, 8)[0]
        ms_of_m[m] = graph_time_ms(
            lambda x=x: wrapper(dia, offs, None, x, None, sc, sh, 0.0))
        del x
    ms_m = np.array(list(ms_of_m.items()))
    slope, intercept = np.polyfit(ms_m[:, 0], ms_m[:, 1], 1)
    x = _planes(torch, dtype, (M, N), 1, 9)[0]
    y = torch.empty_like(x)
    copy_ms = graph_time_ms(lambda: y.copy_(x))
    # and with fewer of A~'s diagonals (the same bytes, fewer loads of T1
    # per element)
    ms_of_nd = {}
    for keep in ((0,), (-1, 0, 1), (-N ** 0.5, -1, 0, 1, N ** 0.5),
                 tuple(offs)):
        idx = [k for k, o in enumerate(offs) if o in keep]
        sub = dia[idx].contiguous()
        so = tuple(offs[k] for k in idx)
        ms_of_nd[len(so)] = graph_time_ms(
            lambda sub=sub, so=so: wrapper(sub, so, None, x, None, sc, sh,
                                           0.0))
    del x, y, sub
    print(f"   {name} bare: device ms at M = "
          + ", ".join(f"{m}: {t:.4f}" for m, t in ms_of_m.items())
          + f"; fitted {intercept * 1e3:.1f} us + {slope * 1e3:.3f} us per "
          f"column ({2 * N * size / (slope * 1e-3) / 1e12:.2f} TB/s for the "
          f"two planes); a device copy of T1 at M = {M}: {copy_ms:.4f} ms "
          f"({bare['ms'] / copy_ms:.2f}x); at M = {M} with "
          + ", ".join(f"{k}: {t:.4f}" for k, t in ms_of_nd.items())
          + " diagonals", flush=True)
    row.update(ms_by_columns=ms_of_m, fitted_launch_us=intercept * 1e3,
               fitted_us_per_column=slope * 1e3, copy_ms=copy_ms,
               ms_by_diagonals=ms_of_nd)
    # block shapes: columns per thread x threads per block
    plan = ck.cm_step_plan(N, M)
    sweep = {}
    for form in ("bare", "full"):
        times = {}
        for cols in (2, 4, 8):
            for threads in ck._CM_THREADS:
                shape = ck._cm_shape(N, M, cols, threads)
                if form == "bare":
                    planes = _planes(torch, dtype, (M, N), 3, 7)
                    k = ck._step_cm(wrapper, dtype, dia, offs, None,
                                    planes[1], None, sc, sh, 0.0, plan=shape)
                    p = ck.cheb_step_cm_plain(dia, offs, None, planes[1],
                                              None, float(sc), float(sh),
                                              0.0)
                    torch.cuda.synchronize()
                    r = float((k - p).abs().max() / p.abs().max())
                    check(r <= tol, f"{name} bare, {cols} columns x "
                          f"{threads} threads agrees with its plain version")
                    del planes, k, p
                times[f"{cols}x{threads}"] = graph_time_ms(
                    caller(with_plan, form, plan=shape))
        best = min(times, key=times.get)
        print(f"   {name} {form} block shapes (columns per thread x threads "
              f"per block), ms on the device: "
              + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
              + f"; plan {plan['cols']}x{plan['threads']}, fastest {best}",
              flush=True)
        sweep[form] = times
    row.update(max_abs_err=row["forms"]["bare"]["max_abs_err"],
               max_rel_err=max(f["max_rel_err"]
                               for f in row["forms"].values()),
               ms=bare["ms"], eager_ms=bare["eager_ms"],
               ms_per_step=bare["ms"], plain_ms=bare["plain_ms"],
               bound_ms=bare["bound_ms"], bound_by=bare["bound_by"],
               library_ms=library_ms, csr_spmm_ms=None,
               plan={k: plan[k] for k in ("cols", "threads")},
               block_shapes=sweep)
    del dia
    torch.cuda.empty_cache()
    return row


def phase_gen_kernels(card_name, ptxas_cm):
    """Phase 3 for the kernels of the sparse-SPD-B composite: the
    column-major one-step entries (every form, on the nine-diagonal A~,
    :func:`_cm_entry`) and the combine against their plain versions at the
    P=8 consistent-mass shapes (N = 65,536, M = 72) and at awkward shapes;
    their times; and the multi-step kernels on the nine-diagonal B~, with
    the ND = 9 instantiation and with the run-time-count body. First the
    registers and spills of every instantiation of cheb_step_cm.cu
    (``ptxas_cm``, reported during the build)."""
    import torch
    from feastkit_tpu_torch.ops import cheb_kernels as ck
    bw, peak32, peak64 = _card_rates(card_name)
    print("== 3b. the SPD-B composite's kernels (P=8 consistent mass)",
          flush=True)
    A, B, _ = consistent_mass_pencil(8)
    (dA_np, offs_A), (dB_np, offs) = congruenced_dia(A, B)
    N, M, nd = A.shape[0], 72, len(offs)
    # b_lo, b_hi of the solve (0.9 / 1.1 x the B~ spectrum (0.25, 2.25))
    scB, shB = 2.0 / (2.475 - 0.225), (2.475 + 0.225) / (2.475 - 0.225)
    awkward = _awkward_operators()
    _print_ptxas("cheb_step_cm", ptxas_cm)
    import scipy.sparse as sp
    dsq = sp.diags(1.0 / np.sqrt(B.diagonal()))
    At = (dsq @ A @ dsq).tocsr()             # A~, the y = A~ T1 operator
    out = {}
    for dtype, tol, peak in ((torch.float32, 1e-5, peak32),
                             (torch.float64, 1e-13, peak64)):
        rung = "f32" if dtype == torch.float32 else "f64"
        npd = np.float32 if dtype == torch.float32 else np.float64
        size = torch.finfo(dtype).bits // 8
        dia = torch.as_tensor(dB_np, device="cuda").to(dtype)
        with warnings.catch_warnings():   # "CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            Acsr = torch.sparse_csr_tensor(
                torch.as_tensor(At.indptr, dtype=torch.int64),
                torch.as_tensor(At.indices, dtype=torch.int64),
                torch.as_tensor(At.data, dtype=dtype),
                size=At.shape).cuda()
        cs = np.asarray(np.random.default_rng(0).standard_normal(8) * 0.1,
                        npd)
        # the column-major one-step entry, every form, on A~
        name = f"cheb_step_cm_{rung}"
        out[name] = _cm_entry(torch, ck, name, dtype, tol, peak, bw, Acsr,
                              dA_np, offs_A, awkward, cs)
        # the combine: in place (the outer step) and from zero (the inits)
        name = f"cheb_combine_{rung}"
        wrapper = getattr(ck, name)
        worst, err = 0.0, 0.0
        for (an, am) in ((N, M), (1089, 1), (1089, 7), (100, 11)):
            z, x, t0, f = _planes(torch, dtype, (am, an), 4, 3)
            t0p, fp = t0.clone(), f.clone()
            wrapper(z, x, t0, f, npd(0.3), npd(0.7), npd(0.11))
            ck.cheb_combine_plain(z, x, t0p, fp, 0.3, 0.7, 0.11)
            o = wrapper(z, x, None, None, npd(0.3), npd(-0.7), 0.5)
            op = ck.cheb_combine_plain(z, x, None, None, 0.3, -0.7, 0.5)
            torch.cuda.synchronize()
            e = max(float((a - b).abs().max())
                    for a, b in ((t0, t0p), (f, fp), (o, op)))
            r = e / max(float(fp.abs().max()), float(op.abs().max()))
            print(f"   {name} N={an} M={am}: max abs err {e:.3e}, "
                  f"relative {r:.3e} (tol {tol:g})", flush=True)
            check(r <= tol, f"{name} agrees with its plain version at "
                  f"N={an} M={am}")
            if an == N:
                err = e
            worst = max(worst, r)
        before = wrapper.launches
        z, x, t0, f = _planes(torch, dtype, (M, N), 4, 4)
        ms = cuda_time_ms(lambda: wrapper(z, x, t0, f, 0.3, 0.7, 1e-3), 100)
        check(wrapper.launches == before + 103,
              f"{name} counts one launch per call")
        plain_ms = cuda_time_ms(lambda: ck.cheb_combine_plain(
            z, x, t0, f, 0.3, 0.7, 1e-3), 10)
        nbytes = 6 * N * M * size          # z, x, t0, f read; t2, f written
        flops = 6 * N * M
        bound_ms = max(nbytes / bw, flops / peak) * 1e3
        print(f"   {name}: {ms:.4f} ms/launch (plain, three torch "
              f"operations and their temporaries: {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms = {nbytes / 1e9:.4f} GB at "
              f"{bw / 1e12:.2f} TB/s, {bound_ms / ms:.1%} of bound)",
              flush=True)
        out[name] = dict(max_abs_err=err, max_rel_err=worst, ms=ms,
                         ms_per_step=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms,
                         bound_by="bytes" if nbytes / bw >= flops / peak
                         else "operations", csr_spmm_ms=None)
        del z, x, t0, f
        # the multi-step kernels on the nine-diagonal B~: the ND = 9
        # instantiation and the run-time-count body, both against plain
        for S in (2, 4):
            name = f"cheb_step{S}_{rung}"
            wrapper = getattr(ck, name)
            plan = ck.multistep_plan(offs, N, M, dtype, S)
            row = {}
            bodies = [("nd9", wrapper, ()),
                      ("runtime_count", wrapper, RUNTIME_COUNT_ONLY)]
            for body, w, defines in bodies:
                def kern(planes, cks, w=w, defines=defines):
                    ck._multistep(w, S, dtype, dia, offs, *planes,
                                  npd(scB), npd(shB), cks, defines=defines)
                k = _planes(torch, dtype, (M, N), 5, 5)
                p_ = [t.clone() for t in k]
                kern(k, cs[:S])
                ck._multistep_plain(S, dia, offs, *p_, npd(scB), npd(shB),
                                    cs[:S])
                torch.cuda.synchronize()
                # the pass's outputs: out0, out1 and acc
                _, r = _errors([k[3], k[4], k[2]], [p_[3], p_[4], p_[2]])
                check(r <= tol, f"{name} ({body} body) agrees with its "
                      "plain version on the nine-diagonal operator")

                def step(k=k, kern=kern):
                    kern(k, [0.01] * S)
                    k[:] = [k[3], k[4], k[2], k[0], k[1]]
                # the device time (CUDA graph) and the time launched one
                # call at a time, which the host's cost per call can exceed
                row[body] = dict(ms=graph_time_ms(step),
                                 eager_ms=cuda_time_ms(step, 50),
                                 max_rel_err=r)
                del k, p_
            print(f"   {name} nd={nd} (strips of {plan['tile']} rows x "
                  f"{plan['groups']} groups of {plan['cols']} columns, "
                  f"{plan['blocks_per_sm']} blocks per SM by its budget): "
                  f"ND=9 body {row['nd9']['ms']:.4f} ms/launch on the "
                  f"device ({row['nd9']['eager_ms']:.4f} one call at a "
                  f"time), run-time-count body "
                  f"{row['runtime_count']['ms']:.4f} "
                  f"({row['runtime_count']['eager_ms']:.4f})", flush=True)
            out[f"{name}_nd9"] = row
        del dia, Acsr
        torch.cuda.empty_cache()
    return out


DIA_KERNELS = {   # name -> (batched, dtype name, TPU kernel it replaces)
    "dia_matvec_f32": (False, "float32",
                       "feastkit_tpu/ops/pallas_kernels.py:91"),
    "dia_matvec_f64": (False, "float64",
                       "feastkit_tpu/ops/pallas_kernels.py:91"),
    "dia_matvec_batched_f32": (True, "float32",
                               "feastkit_tpu/ops/pallas_kernels.py:206"),
    "dia_matvec_batched_f64": (True, "float64",
                               "feastkit_tpu/ops/pallas_kernels.py:206"),
    "dia_matvec_c64": (False, "complex64",
                       "feastkit_tpu/ops/pallas_kernels.py:91"),
    "dia_matvec_c128": (False, "complex128",
                        "feastkit_tpu/ops/pallas_kernels.py:91"),
    "dia_matvec_batched_c64": (True, "complex64",
                               "feastkit_tpu/ops/pallas_kernels.py:206"),
    "dia_matvec_batched_c128": (True, "complex128",
                                "feastkit_tpu/ops/pallas_kernels.py:206"),
}
REAL_DIA = tuple(n for n in DIA_KERNELS if n[-3:] in ("f32", "f64"))
COMPLEX_DIA = tuple(n for n in DIA_KERNELS if n not in REAL_DIA)
# the Krylov path's shapes at P = 8 (N = 65,536, five diagonals): the
# Rayleigh-Ritz and residual products (fp64, M = M0 = 72), one c64 column
# chunk of 64 as its (N, 128) real view at g = 1, and a node group of two
# in both precisions (the inner c64 Krylov and the fp64 refinement)
DIA_MAIN_SHAPES = {"dia_matvec_f32": (1, 128), "dia_matvec_f64": (1, 72),
                   "dia_matvec_batched_f32": (2, 128),
                   "dia_matvec_batched_f64": (2, 128)}
# (N, offsets, M, g): ragged and awkward operands for every entry
DIA_AWKWARD = (
    (1073, (-37, -1, 0, 1, 37), 1, 3),      # |offset| = nx, M = 1, g = 3
    (1073, (-1, 0, 1), 7, 1),               # three diagonals, M = 7
    (100, (-60, -1, 0, 1, 60), 11, 3),      # 2 max|offset| > N, M = 11
    (100, (0,), 7, 3),                      # one diagonal
    (1089, (-34, -33, -32, -1, 0, 1, 32, 33, 34), 11, 2),   # nine
    (1089, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40), 5, 3),  # eleven
    (1000, (-7, -2, -1, 0, 1, 2, 7), 3, 2),  # seven, M = 3
    (1000, (-5, -3, -1), 6, 2),             # negative offsets only
)


def _random_dia(N, offsets, seed, complex_values=False):
    rng = np.random.default_rng(seed)
    d = np.zeros((len(offsets), N), complex if complex_values else float)
    for k, o in enumerate(offsets):
        n = N - abs(o)
        if n > 0:
            v = rng.random(n) - 0.5
            if complex_values:
                v = v + 1j * (rng.random(n) - 0.5)
            d[k, max(0, -o):max(0, -o) + n] = v
    return d


def _dia_dtype(torch, name):
    return getattr(torch, DIA_KERNELS[name][1])


def _dia_operand(torch, name, N, offsets, seed):
    """Random diagonals of entry ``name``'s dtype on the card."""
    dtype = _dia_dtype(torch, name)
    return torch.as_tensor(_random_dia(N, offsets, seed, dtype.is_complex),
                           device="cuda").to(dtype)


# lap2d(256)'s offsets, the Krylov path's operator at P = 8
DIA_LAP = (-256, -1, 0, 1, 256)
# (label, entry, N, offsets, operand shape) of every DIA product timed: the
# Krylov path's four (DIA_MAIN_SHAPES), the P=10 main path's Rayleigh-Ritz
# and residual products (fp64, M = M0 = 72, offsets +-1, +-1024) and the
# consistent-mass bounds' Lanczos products (f32, M = 1, where the host's
# cost per call rules), and the stochastic count's recurrence at P=10 (fp64,
# its fpm[32] = 10 probe columns)
DIA_CASES = tuple(
    ("krylov", name, 65536, DIA_LAP,
     (DIA_MAIN_SHAPES[name][0], 65536, DIA_MAIN_SHAPES[name][1])
     if batched else (65536, DIA_MAIN_SHAPES[name][1]))
    for name in REAL_DIA for batched in (DIA_KERNELS[name][0],)) + (
    ("rr_p10", "dia_matvec_f64", 1048576, (-1024, -1, 0, 1, 1024),
     (1048576, 72)),
    ("count_p10", "dia_matvec_f64", 1048576, (-1024, -1, 0, 1, 1024),
     (1048576, 10)),
    ("lanczos_m1", "dia_matvec_f32", 65536, DIA_LAP, (65536, 1)))
# the complex entries at the complex Hermitian paths' shapes: the P=10
# polynomial path's recurrence, Rayleigh-Ritz and residual products
# (unbatched, M = 72, offsets +-1, +-1024; complex64 on the f32 rung,
# complex128 on the fp64 rung); a node group of two of the Hermitian
# Krylov leg of phase 11 at P = 7 (all M0 = 72 columns, offsets +-1,
# +-128; the inner complex64 Krylov and the complex128 refinement), the
# batched entries' own path; and the general Krylov leg of phase 12 at
# P = 8, whose shapes these are: a node group of two on one column chunk
# of 64 (offsets +-1, +-256; complex64 GMRES, complex128 refinement) and
# its Rayleigh-Ritz and residual products (unbatched complex128, M = 72)
DIA_COMPLEX_CASES = tuple(
    ("p10", name, 1048576, (-1024, -1, 0, 1, 1024), (1048576, 72))
    for name in ("dia_matvec_c64", "dia_matvec_c128")) + tuple(
    (label, name, n, offsets, (2, n, m))
    for label, n, offsets, m in (
        ("krylov_p7", 16384, (-128, -1, 0, 1, 128), 72),
        ("general_p8", 65536, DIA_LAP, 64))
    for name in ("dia_matvec_batched_c64", "dia_matvec_batched_c128")) + (
    ("general_p8", "dia_matvec_c128", 65536, DIA_LAP, (65536, 72)),)


def _rotating(entry, dia, offsets, xs):
    """A call of ``entry(dia, offsets, x)`` on the next of the operands
    ``xs`` each time."""
    turn = [0]

    def run():
        entry(dia, offsets, xs[turn[0] % len(xs)])
        turn[0] += 1
    return run


def _dia_time(torch, entry, dia, offsets, xs):
    """Times of ``entry(dia, offsets, x)`` over the rotating operands
    ``xs``: one call at a time (CUDA events around 200 calls), on the device
    (CUDA graph) and the host's cost per call (the median over 5 batches of
    the host clock around 100 calls that are enqueued, not waited for)."""
    run = _rotating(entry, dia, offsets, xs)
    eager = cuda_time_ms(run, 200)
    graph = graph_time_ms(run)
    batches = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            run()
        batches.append((time.perf_counter() - t0) / 100 * 1e6)
    torch.cuda.synchronize()
    return dict(eager_ms=eager, graph_ms=graph,
                host_us=float(np.median(batches)))


def _dia_bound(card_name, name, N, nd, shape):
    """Least ms of a DIA product: x and y once and the diagonals once over
    the card's bytes rate, above its operations over the peak rate of the
    entry's real precision (a complex multiply-add is 8 operations, a real
    one 2)."""
    bw, peak32, peak64 = _card_rates(card_name)
    kind = name.rsplit("_", 1)[1]
    size = {"f32": 4, "f64": 8, "c64": 8, "c128": 16}[kind]
    peak = peak32 if kind in ("f32", "c64") else peak64
    elems = int(np.prod(shape))
    nbytes = (2 * elems + nd * N) * size
    flops = (8 if kind[0] == "c" else 2) * nd * elems
    by_bytes = nbytes / bw >= flops / peak
    return (max(nbytes / bw, flops / peak) * 1e3,
            "bytes" if by_bytes else "operations", nbytes)


def dia_times(root):
    """--dia-times ROOT: the DIA entries of the package under ROOT (this
    tree, or a parent commit's checkout) timed at DIA_CASES, one JSON
    line. Only the public entries are called, so a parent's package
    without plans is timed the same way."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    from feastkit_tpu_torch.ops import dia as D
    check(os.path.abspath(D.__file__).startswith(os.path.abspath(root)),
          f"the DIA module comes from {root}")
    rows = {}
    for label, name, N, offsets, shape in DIA_CASES:
        dtype = torch.float32 if name.endswith("f32") else torch.float64
        dia = torch.as_tensor(_random_dia(N, offsets, 5),
                              device="cuda").to(dtype)
        xs = _planes(torch, dtype, shape, 4, 11)
        rows[f"{label}:{name}"] = _dia_time(torch, getattr(D, name), dia,
                                            offsets, xs)
        del dia, xs
        torch.cuda.empty_cache()
    print(json.dumps({"dia_times": {"root": root, "rows": rows}}),
          flush=True)


def dia_turns(parent):
    """--dia-turns PARENT: --dia-times of the parent's checkout and of this
    tree in turns (parent, change, change, parent), each in a process of
    its own; prints each case's four readings."""
    runs = []
    for root in (parent, ".", ".", parent):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--dia-times", root],
            capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout[-4000:])
        check(proc.returncode == 0,
              f"--dia-times {root} ran (exit {proc.returncode}) "
              f"{proc.stderr[-2000:]}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith('{"dia_times"')][-1]
        runs.append(json.loads(line)["dia_times"]["rows"])
    print("== DIA entries in turns: parent, change, change, parent",
          flush=True)
    for case in runs[0]:
        for key in ("graph_ms", "eager_ms", "host_us"):
            v = [r[case][key] for r in runs]
            print(f"   {case} {key}: parent {v[0]:.4f} / {v[3]:.4f}, "
                  f"change {v[1]:.4f} / {v[2]:.4f}", flush=True)
    print(json.dumps({"dia_turns": runs}), flush=True)
    return runs


def _dia_sweep_plans(D, torch, N, offsets, M, g, dtype):
    """The ring body's plans swept at one shape: every column group of
    16-byte pieces up to 64 bytes a row per operand (and M), copies in
    flight 2, 4, 6 and 8, and the strips of the plan's rule, half and twice
    as many and one wave at the most resident blocks."""
    vec = 16 // D.itemsize(dtype)
    out = []
    for cols in sorted({c for c in (vec, 2 * vec, 4 * vec, 8 * vec, 16 * vec)
                        if c <= M and g * c // vec <= 256}):
        for depth in (2, 4, 6, 8):
            try:
                base = D.dia_plan(offsets, N, M, g, dtype, body="ring",
                                  cols=cols, depth=depth)
            except ValueError:
                continue
            wave = max(1, base["blocks_per_sm"] * 132 // base["groups"])
            for strips in sorted({base["tiles"], max(1, base["tiles"] // 2),
                                  2 * base["tiles"], wave}):
                out.append(D.dia_plan(offsets, N, M, g, dtype, body="ring",
                                      cols=cols, depth=depth,
                                      strips=strips))
    return out


def dia_sweep(card_name, ptxas_dia):
    """--dia-sweep: the ring body's block shapes (_dia_sweep_plans) and the
    flat body at every DIA_CASES shape but the Lanczos one and at the
    complex entries' shapes (DIA_COMPLEX_CASES), each timed on the device
    by CUDA graph over four rotating operands and checked once against the
    plain version; the plan's own choice marked."""
    import torch
    from feastkit_tpu_torch.ops import dia as D
    print("== DIA sweep: ring block shapes and the flat body", flush=True)
    rows = []
    for label, name, N, offsets, shape in (DIA_CASES[:-1]
                                           + DIA_COMPLEX_CASES):
        batched = DIA_KERNELS[name][0]
        dtype = _dia_dtype(torch, name)
        tol = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-13
        g = shape[0] if batched else 1
        M = shape[-1]
        wrapper = getattr(D, name)
        dia = _dia_operand(torch, name, N, offsets, 5)
        xs = _planes(torch, dtype, shape, 4, 11)
        yp = D.dia_matvec_plain(dia, offsets, xs[0])
        bound, _, _ = _dia_bound(card_name, name, N, len(offsets), shape)
        own = D.dia_plan(offsets, N, M, g, dtype, D._sm_count(0))
        plans = [D.dia_plan(offsets, N, M, g, dtype, body="flat")] + \
            _dia_sweep_plans(D, torch, N, offsets, M, g, dtype)
        for plan in plans:
            def call(d, o, x, plan=plan):
                return D._launch(wrapper, d, o, x, batched, plan=plan)
            y = call(dia, offsets, xs[0])
            rel = float((y - yp).abs().max() / yp.abs().max())
            if rel > tol:
                raise AssertionError(f"{name} {plan} disagrees at {shape}: "
                                     f"relative {rel:.3e}")
            ms = graph_time_ms(_rotating(call, dia, offsets, xs))
            key = {k: plan.get(k) for k in ("body", "cols", "depth", "tiles",
                                            "blocks", "blocks_per_sm",
                                            "shared_bytes")}
            mine = all(own.get(k) == v for k, v in key.items())
            rows.append(dict(case=label, name=name, shape=list(shape), ms=ms,
                             bound_ms=bound, planned=mine, **key))
            print(f"   {label} {name} {tuple(shape)} {plan['body']} "
                  f"cols={plan.get('cols')} depth={plan.get('depth')} "
                  f"tiles={plan.get('tiles')} blocks={plan['blocks']} "
                  f"per_sm={plan.get('blocks_per_sm')}: {ms:.4f} ms "
                  f"({bound / ms:.1%} of bound){' <- plan' if mine else ''}",
                  flush=True)
        del dia, xs, yp
        torch.cuda.empty_cache()
    print(json.dumps({"dia_sweep": rows}), flush=True)
    check(True, f"{len(rows)} plans agree with the plain version")
    _print_ptxas("dia_matvec", ptxas_dia)
    return rows


def _dia_check(torch, D, wrapper, batched, dia, offsets, x, tol, label):
    """The entry's own plan and every body that takes the shape, each held
    to the plain version; the body counts checked against the plan. Returns
    (max abs error of the entry's own call, worst relative error, plan)."""
    g = x.shape[0] if batched else 1
    n, m = x.shape[-2], x.shape[-1]
    plan = D.dia_plan(offsets, n, m, g, x.dtype, D._sm_count(x.device.index))
    yp = D.dia_matvec_plain(dia, offsets, x)
    scale = float(yp.abs().max())
    before = (wrapper.launches, dict(wrapper.body_launches))
    y = wrapper(dia, offsets, x)
    torch.cuda.synchronize()
    check(wrapper.launches == before[0] + 1
          and wrapper.body_launches[plan["body"]]
          == before[1][plan["body"]] + 1,
          f"{wrapper.__name__} {label}: one launch, counted on the "
          f"{plan['body']} body its plan names")
    err = float((y - yp).abs().max())
    worst = err / scale
    bodies = [plan["body"]]
    for body in ("ring", "flat"):
        if body == plan["body"]:
            continue
        try:
            other = D.dia_plan(offsets, n, m, g, x.dtype, body=body)
        except ValueError:
            continue
        yo = D._launch(wrapper, dia, offsets, x, batched, plan=other)
        worst = max(worst, float((yo - yp).abs().max()) / scale)
        bodies.append(body)
    print(f"   {wrapper.__name__} {label}: plan {plan['body']}"
          + (f" (cols {plan['cols']}, depth {plan['depth']}, tiles "
             f"{plan['tiles']}, blocks {plan['blocks']})"
             if plan["body"] == "ring" else f" ({plan['reason']})")
          + f"; bodies {bodies} relative {worst:.3e} (tol {tol:g})",
          flush=True)
    check(worst <= tol, f"{wrapper.__name__} {label}: every body agrees "
          "with the plain version")
    return err, worst, plan


def phase_dia_kernels(card_name, ptxas_dia):
    """Phase 3c: the DIA matvec entries (``ops/csrc/dia_matvec.cu``)
    against their plain version at the Krylov path's shapes, the P=10
    Rayleigh-Ritz shape and awkward ones, each body that takes the shape
    (the entry's own plan, and the other body by a plan override),
    tolerance relative to max|y|: f32 1e-5, fp64 1e-13; which body each
    shape took; then each entry's times over four rotating operands (the
    128-column f32 operand alone fits the 50 MB L2): on the device by CUDA
    graph, one call at a time and the host's cost per call, the plan's
    body and the other in turns (other, own, own, other, by CUDA graph), the
    plain version's, the bound, the plan's reckoned L2 bytes per element
    and one torch.sparse.mm (CSR) call on the same product; the same at the
    P=10 Rayleigh-Ritz and the Lanczos (M = 1) shapes, and for the complex
    entries at DIA_COMPLEX_CASES' shapes (each entry's own path's shape
    gives its row; the others go to the "dia_other_shapes" line). Returns
    (rows, the other shapes' rows keyed "label entry")."""
    import torch
    from feastkit_tpu_torch.ops import dia as D
    print("== 3c. the DIA matvec kernels against their plain version "
          "(Krylov path, P=8; the complex entries at the Hermitian paths' "
          "shapes)", flush=True)
    _print_ptxas("dia_matvec", ptxas_dia)
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
              for r in ptxas_dia), "no ring-body instantiation spills")
    A = lap2d(256)
    N = A.shape[0]
    out = {}
    extra = {}
    for label, name, n, offsets, shape in DIA_CASES + DIA_COMPLEX_CASES:
        batched = DIA_KERNELS[name][0]
        dtype = _dia_dtype(torch, name)
        tol = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-13
        wrapper = getattr(D, name)
        dia = _dia_operand(torch, name, n, offsets, 5)
        x = _planes(torch, dtype, shape, 1, 7)[0]
        err, worst, plan = _dia_check(torch, D, wrapper, batched, dia,
                                      offsets, x, tol, f"{label} {shape}")
        want = "ring" if label.startswith(("krylov", "general")) \
            else "flat"
        check(plan["body"] == want, f"{name} {label} takes the {want} body")
        # an entry's own path's shape: the Krylov path's for the real
        # entries, P=10 for the unbatched complex entries, the Hermitian
        # Krylov leg's (P=7) for the batched complex ones
        main_case = (label == "krylov" and name not in COMPLEX_DIA) or (
            label == "p10" and name in COMPLEX_DIA) or label == "krylov_p7"
        if main_case:
            for an, aoffs, am, ag in DIA_AWKWARD:
                dd = _dia_operand(torch, name, an, aoffs, an + am)
                xa = _planes(torch, dtype, (ag, an, am) if batched
                             else (an, am), 1, ag)[0]
                _, r, _ = _dia_check(
                    torch, D, wrapper, batched, dd, aoffs, xa, tol,
                    f"N={an} M={am}{f' g={ag}' if batched else ''} "
                    f"nd={len(aoffs)}")
                worst = max(worst, r)
        # times over four rotating operands
        xs = _planes(torch, dtype, shape, 4, 11)
        t = _dia_time(torch, wrapper, dia, offsets, xs)
        g = shape[0] if batched else 1
        # the plan's body and the other one in turns (other, own, own,
        # other) where the other takes the shape
        turns = {}
        try:
            other = D.dia_plan(offsets, n, shape[-1], g, dtype, body=(
                "flat" if plan["body"] == "ring" else "ring"))
        except ValueError:
            other = None
        if other is not None:
            for pl in (other, plan, plan, other):
                def call(d, o, v, pl=pl):
                    return D._launch(wrapper, d, o, v, batched, plan=pl)
                turns.setdefault(pl["body"], []).append(
                    graph_time_ms(_rotating(call, dia, offsets, xs)))
        plain_ms = cuda_time_ms(
            lambda: D.dia_matvec_plain(dia, offsets, xs[0]), 20)
        bound_ms, bound_by, nbytes = _dia_bound(card_name, name, n,
                                                len(offsets), shape)
        traffic = D.reckoned_traffic(plan, n, shape[-1], g)
        library_ms = None
        if label != "lanczos_m1":
            # the library yardstick: one CSR product on the (N, g M)
            # operand, laid out beforehand (complex values for a complex
            # entry: torch runs complex CSR on the card)
            import scipy.sparse as sp
            dn = _random_dia(n, offsets, 5, dtype.is_complex)
            Acsr_np = sp.diags(
                [dn[k][max(0, -o):n - max(0, o)]
                 for k, o in enumerate(offsets)], list(offsets),
                shape=(n, n)).tocsr()
            with warnings.catch_warnings():   # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                Acsr = torch.sparse_csr_tensor(
                    torch.as_tensor(Acsr_np.indptr, dtype=torch.int64),
                    torch.as_tensor(Acsr_np.indices, dtype=torch.int64),
                    torch.as_tensor(Acsr_np.data, dtype=dtype),
                    size=Acsr_np.shape).cuda()
            xl = [v.permute(1, 0, 2).reshape(n, g * shape[-1]).contiguous()
                  if batched else v for v in xs]
            lib_turn = [0]

            def lib():
                torch.sparse.mm(Acsr, xl[lib_turn[0] % 4])
                lib_turn[0] += 1
            library_ms = cuda_time_ms(lib, 50)
            del Acsr, xl
        ms = t["graph_ms"]
        print(f"   {name} {label} {tuple(shape)}: {ms:.4f} ms on the device "
              f"(CUDA graph), {t['eager_ms']:.4f} ms one call at a time, "
              f"host {t['host_us']:.1f} us a call; "
              + (f"in turns flat {turns['flat'][0]:.4f} / "
                 f"{turns['flat'][1]:.4f}, ring {turns['ring'][0]:.4f} / "
                 f"{turns['ring'][1]:.4f} ms (device); " if turns else "")
              + f"plain {plain_ms:.4f} ms; torch.sparse.mm CSR "
              + (f"{library_ms:.4f} ms; " if library_ms else "- ; ")
              + f"bound {bound_ms:.4f} ms = {nbytes / 1e6:.1f} MB at "
              f"{_card_rates(card_name)[0] / 1e12:.2f} TB/s, "
              f"{bound_ms / ms:.1%} of bound on the device, "
              f"{bound_ms / t['eager_ms']:.1%} one call at a time; reckoned "
              f"L2 {traffic['l2_bytes_per_element']:.2f} B/element, halo "
              f"share {traffic['halo_share']:.3f}", flush=True)
        row = dict(max_abs_err=err, max_rel_err=worst, ms=ms,
                   eager_ms=t["eager_ms"], host_us=t["host_us"],
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, shape=list(shape),
                   body=plan["body"], plan=plan, turns=turns,
                   l2_bytes_per_element=traffic["l2_bytes_per_element"])
        if main_case:
            out[name] = row
        else:
            extra[f"{label} {name}"] = row
        del dia, x, xs
        torch.cuda.empty_cache()
    print(json.dumps({"dia_other_shapes": extra}), flush=True)
    # what a CUDA entry refuses
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    from feastkit_tpu_torch.solvers.sparse import sparse_coo_arrays
    data, idx, _ = sparse_coo_arrays(A, np.float64)
    dia_np, offsets = bcoo_to_dia(data, idx, N)
    xf = torch.zeros(N, 4, device="cuda", dtype=torch.float64)
    xt = torch.zeros(4, N, device="cuda", dtype=torch.float64).t()
    d64 = torch.as_tensor(dia_np, device="cuda")
    for what, call, exc in (
            ("a wrong dtype", lambda: D.dia_matvec_f32(d64, offsets, xf),
             TypeError),
            ("a non-contiguous operand",
             lambda: D.dia_matvec_f64(d64, offsets, xt), ValueError),
            ("a CPU tensor", lambda: D._launch(
                D.dia_matvec_f64, d64.cpu(), offsets, xf.cpu(), False),
             ValueError)):
        try:
            call()
        except exc:
            print(f"  ok: a CUDA entry refuses {what}", flush=True)
        else:
            raise AssertionError(f"a CUDA entry accepted {what}")
    return out, extra


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def group_max(g):
    """FEAST_GROUP_MAX for the block (None: unset), then restore."""
    saved = os.environ.pop("FEAST_GROUP_MAX", None)
    if g is not None:
        os.environ["FEAST_GROUP_MAX"] = str(g)
    try:
        yield
    finally:
        os.environ.pop("FEAST_GROUP_MAX", None)
        if saved is not None:
            os.environ["FEAST_GROUP_MAX"] = saved


def _krylov_solve(A, B, Emin, Emax, M0, fpm, device="cuda", **kw):
    import feastkit_tpu_torch as ft
    _sync()
    t0 = time.perf_counter()
    r = ft.feast(A, B, (Emin, Emax), M0, fpm, device=device, **kw)
    _sync()
    return r, time.perf_counter() - t0


def _krylov_counted(A, B, Emin, Emax, M0, fpm, label, device="cuda", **kw):
    """One Krylov solve with the DIA launch counts set to 0 just before and
    read just after, held to the counts the solve's own record implies."""
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.solvers.sparse import krylov_dia_launches
    D.reset_launch_counts()
    r, seconds = _krylov_solve(A, B, Emin, Emax, M0, fpm, device, **kw)
    counts = D.launch_counts()
    want = krylov_dia_launches(r.krylov)
    ev = r.krylov["events"]
    trips = sum(e.get("trips", 0) for e in ev if e["op"] == "gmres")
    calls = sum(1 for e in ev if e["op"] == "gmres")
    bodies = D.body_counts()
    print(f"   {label}: {seconds:.2f} s, {calls} GMRES calls, {trips} "
          f"restart cycles; DIA launches {counts}, by body {bodies}",
          flush=True)
    if device == "cuda":
        check(counts == want, f"{label}: DIA launches equal the count the "
              f"solve's Krylov record implies {want}")
        check(all(bodies[n]["ring"] > 0 for n in counts if counts[n]),
              f"{label}: every DIA entry launched runs the ring body")
    return r, seconds, counts, want


def _krylov_breakdown(A, B, Emin, Emax, M0, fpm, dia_ms, device="cuda",
                      **kw):
    """One more warm Krylov solve with its stages timed (the device
    synchronised at each stage's edges): the filter (all shifted solves),
    within it the inner Krylov calls and within those the V-cycles, the
    Gram-Schmidt and the Hessenberg least squares; the refinement (the
    filter outside its Krylov calls); Rayleigh-Ritz; host set-up; Q0; and
    the DIA launches times their phase-3c time per launch."""
    from feastkit_tpu_torch.kernel import hermitian
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.ops import gmres
    from feastkit_tpu_torch.solvers import sparse
    times = {}
    saved = []

    def add(key, dt):
        times[key] = times.get(key, 0.0) + dt

    def timed_fn(fn, key, sync=True):
        def wrapper(*a, **k):
            if sync:
                _sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                _sync()
            add(key, time.perf_counter() - t0)
            return out
        return wrapper

    def patch(mod, name, make):
        orig = getattr(mod, name)
        saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    patch(sparse, "gmres_block", lambda f: timed_fn(f, "krylov"))
    patch(sparse, "bicgstab_block", lambda f: timed_fn(f, "krylov"))
    patch(gmres, "_gram_schmidt", lambda f: timed_fn(f, "gram_schmidt"))
    patch(gmres, "_hessenberg_lstsq", lambda f: timed_fn(f, "lstsq"))
    patch(sparse, "make_shifted_vcycle",
          lambda f: lambda *a, **k: timed_fn(f(*a, **k), "vcycle"))
    patch(sparse, "_make_sparse_solve_all",
          lambda f: lambda *a, **k: timed_fn(f(*a, **k), "filter"))
    patch(hermitian, "make_rayleigh_ritz_update",
          lambda f: lambda *a, **k: timed_fn(f(*a, **k), "rayleigh_ritz"))
    for name in ("sparse_coo_arrays", "_structured_forms", "_plan_mg",
                 "feast_contour"):
        patch(sparse, name, lambda f: timed_fn(f, "host_setup", sync=False))
    patch(sparse, "initial_subspace",
          lambda f: timed_fn(f, "host_q0", sync=False))
    D.reset_launch_counts()
    try:
        r, wall = _krylov_solve(A, B, Emin, Emax, M0, fpm, device, **kw)
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)
    counts = D.launch_counts()
    times["refinement"] = times.get("filter", 0.0) - times.get("krylov", 0.0)
    times["dia_launches_x_ms"] = sum(counts[n] * dia_ms.get(n, 0.0)
                                     for n in counts) / 1e3
    times = {k: round(v, 4) for k, v in sorted(times.items())}
    outside = wall - times.get("filter", 0.0) - times.get(
        "rayleigh_ritz", 0.0) - times.get("host_setup", 0.0) - times.get(
        "host_q0", 0.0)
    print(f"   breakdown of a warm Krylov solve ({wall:.2f} s): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; outside filter, Rayleigh-Ritz and host {outside:.3f} s "
          "(nested: krylov within filter; vcycle, gram_schmidt and lstsq "
          "within krylov)", flush=True)
    return dict(wall_s=wall, other_s=outside, launches=counts, M=r.M,
                info=int(r.info), **times)


def phase_krylov(dia_kernels, nx=256, device="cuda", staged=True):
    """Phase 8: the Krylov contour engine on the 2D Laplacian at P = 8 with
    solver="gmres": once cold (its launches counted, its peak memory
    read), with ``staged`` once warm with its stages timed (the whole
    script cuts it for time), and once with FEAST_GROUP_MAX=1 (the
    unbatched entries carry every apply), which must agree with the
    default node groups."""
    import torch
    print(f"== 8. Krylov path: feast(lap2d({nx}), solver='gmres') with "
          "multigrid", flush=True)
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = int(-(-int(len(exp) * 1.3) // 8) * 8)
    if nx == 256:
        check(len(exp) == 52 and M0 == 72, "fixture: 52 pairs, M0 = 72")
    import feastkit_tpu_torch as ft
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    kw = dict(solver="gmres", solver_maxiter=250)
    print(f"   N={nx * nx} interval=({Emin:.6e}, {Emax:.6e}) M0={M0}",
          flush=True)
    if device == "cuda":
        torch.cuda.empty_cache()
        gc.collect()    # no earlier phase's cyclic garbage in this peak
        torch.cuda.reset_peak_memory_stats()
    r, cold_s, counts, _ = _krylov_counted(A, None, Emin, Emax, M0, fpm,
                                           "Krylov cold", device, **kw)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    print(f"   cold solve {cold_s:.2f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    _check_result(r, exp, 1e-8, f"P={int(np.log2(nx))} Krylov cold")
    levels = {256: 4}.get(nx)
    print(f"   preconditioner {r.krylov['precond']} with "
          f"{r.krylov['mg_levels']} levels", flush=True)
    check(r.krylov["precond"] == "mg"
          and (levels is None or r.krylov["mg_levels"] == levels),
          f"multigrid preconditioner{f' with {levels} levels' if levels else ''}")
    lam_default = np.sort(r.lam)
    groups = sorted({e["nodes"] for e in r.krylov["events"]
                     if e["op"] == "gmres"})
    print(f"   node groups {groups}, loops {r.loop}", flush=True)
    del r
    # the warm solve, its stages timed (the timers synchronise the device
    # at each stage's edges)
    dia_ms = {n: k["ms"] for n, k in dia_kernels.items()}
    breakdown, warm = None, []
    if staged:
        breakdown = _krylov_breakdown(A, None, Emin, Emax, M0, fpm, dia_ms,
                                      device, **kw)
        check(breakdown["M"] == len(exp) and breakdown["info"] == 0,
              "the warm Krylov solve agrees")
        warm = [breakdown["wall_s"]]
        print(f"   warm solve {warm[0]:.3f} s (with stage timers)",
              flush=True)
    with group_max(1):
        r1, g1_s, counts1, _ = _krylov_counted(
            A, None, Emin, Emax, M0, fpm, "Krylov FEAST_GROUP_MAX=1",
            device, **kw)
    _check_result(r1, exp, 1e-8, "Krylov FEAST_GROUP_MAX=1")
    gap = float(np.abs(np.sort(r1.lam) - lam_default).max())
    print(f"   FEAST_GROUP_MAX=1 vs default groups: eigenvalues {gap:.3e} "
          "apart", flush=True)
    check(gap <= 1e-8, "the group-1 solve agrees with the default groups")
    total = {n: counts[n] + counts1[n] for n in counts}
    if device == "cuda":
        for name in REAL_DIA:
            check(total[name] > 0, f"{name} launched on the Krylov path "
                  f"({total[name]})")
        check(counts1["dia_matvec_batched_f32"] == 0
              and counts1["dia_matvec_batched_f64"] == 0,
              "FEAST_GROUP_MAX=1: the unbatched entries carry every apply")
    return dict(cold_s=cold_s, warm_s=warm,
                warm_median_s=float(np.median(warm)) if warm else None,
                group1_s=g1_s,
                peak_bytes=peak, counts=counts, counts_group1=counts1,
                launches=total, breakdown=breakdown)


def phase_gen_krylov(nx_p=7, device="cuda"):
    """Phase 9: the consistent-mass pencil of scripts/scale_sparse_gen.py at
    P = 7 through solver="gmres" with grid=(nx, nx): multigrid with a B
    stencil, against the analytic eigenvalues."""
    import feastkit_tpu_torch as ft
    print(f"== 9. generalized Krylov path: the consistent-mass pencil, "
          f"P={nx_p}", flush=True)
    A, B, w = consistent_mass_pencil(nx_p)
    nx = 2 ** nx_p
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, 50)]
    Emax = float(0.5 * (w[hi] + w[hi + 1]))
    exp = w[w <= Emax]
    M0 = 72
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    r, secs, counts, _ = _krylov_counted(
        A, B, 0.0, Emax, M0, fpm, f"P={nx_p} consistent mass (gmres)",
        device, solver="gmres", grid=(nx, nx))
    print(f"   preconditioner {r.krylov['precond']} with "
          f"{r.krylov['mg_levels']} levels", flush=True)
    _check_result(r, exp, 1e-8, f"P={nx_p} consistent mass Krylov")
    check(r.krylov["precond"] == "mg", "multigrid with the B stencil")
    return dict(seconds=secs, launches=counts,
                mg_levels=r.krylov["mg_levels"], loops=r.loop)


def krylov_scale(p):
    """One Krylov solve of the 2D Laplacian at P = p (N = 4^p), the first
    in its process, with its peak device memory and its DIA launches held
    to its record: the size ladder beyond the smoke run's P = 8
    (``--krylov-solve P``)."""
    import torch
    import feastkit_tpu_torch as ft
    nx = 2 ** p
    print(f"== Krylov solve at P={p}: feast(lap2d({nx}), solver='gmres')",
          flush=True)
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = int(-(-int(len(exp) * 1.3) // 8) * 8)
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    kw = dict(solver="gmres", solver_maxiter=250)
    gc.collect()    # no earlier phase's cyclic garbage in this peak
    torch.cuda.reset_peak_memory_stats()
    r, seconds, counts, _ = _krylov_counted(A, None, Emin, Emax, M0, fpm,
                                            f"P={p} Krylov", **kw)
    peak = torch.cuda.max_memory_allocated()
    _check_result(r, exp, 1e-8, f"P={p} Krylov")
    ev = r.krylov["events"]
    out = dict(p=p, N=nx * nx, M0=M0, M=r.M, seconds=seconds,
               peak_bytes=peak, loops=r.loop, epsout=r.epsout,
               precond=r.krylov["precond"], mg_levels=r.krylov["mg_levels"],
               gmres_calls=sum(1 for e in ev if e["op"] == "gmres"),
               restart_cycles=sum(e.get("trips", 0) for e in ev
                                  if e["op"] == "gmres"),
               launches=counts)
    print(f"   P={p}: {seconds:.2f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(json.dumps({"krylov_scale": out}), flush=True)
    return out


def sp_awkward(nx, ny):
    """A 2D five-point operator with random coefficients on an nx-by-ny
    grid (offsets -nx, -1, 0, 1, nx)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(nx * 1000 + ny)
    n = nx * ny
    main = 4.0 + rng.random(n)
    e1 = -rng.random(n - 1)
    e1[np.arange(1, n) % nx == 0] = 0.0
    en = -rng.random(n - nx)
    A = sp.diags([en, e1, main, e1, en], [-nx, -1, 0, 1, nx], format="csr")
    return A


def phase_rayleigh_ritz():
    import torch
    from feastkit_tpu_torch.kernel.hermitian import (
        init_hermitian_state, make_rayleigh_ritz_update)
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia, dia_matvec
    from feastkit_tpu_torch.solvers.sparse import sparse_coo_arrays
    nx, M0 = 1024, 72
    N = nx * nx
    data, idx, _ = sparse_coo_arrays(lap2d(nx), np.float64)
    dia_np, offsets = bcoo_to_dia(data, idx, N)
    dia = torch.as_tensor(dia_np, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    Qp = torch.randn(N, M0, generator=g, device="cuda", dtype=torch.float64)
    state = init_hermitian_state(Qp)
    update = make_rayleigh_ritz_update(
        lambda X: dia_matvec(dia, offsets, X), lambda X: X, 0.0, 0.2,
        tol=1e-8)
    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(state, Qp)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rr_ms = float(np.median(ms[1:]))
    print(f"   Rayleigh-Ritz update at N={N} M0={M0} (f64): {rr_ms:.1f} ms "
          f"(median of 3 warm)", flush=True)
    return rr_ms


def _run_feast(A, B, Emin, Emax, M0, fpm, solve=None):
    """``feast(A, B, (Emin, Emax), M0, fpm)``, or ``solve(A, B, Emin, Emax,
    M0, fpm)``, and its seconds, the card synchronised at both ends."""
    import torch
    import feastkit_tpu_torch as ft
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if solve is None:
        r = ft.feast(A, B, (Emin, Emax), M0, fpm)
    else:
        r = solve(A, B, Emin, Emax, M0, fpm)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def _check_result(r, exp, tol, label):
    print(f"   {label}: M={r.M} info={int(r.info)} epsout={r.epsout:.3e} "
          f"loops={r.loop}", flush=True)
    check(r.M == len(exp), f"{label}: M = {len(exp)}")
    err = float(np.abs(np.sort(r.lam) - exp).max())
    print(f"   {label}: eigenvalue error {err:.3e}, max residual "
          f"{float(r.res.max()):.3e}", flush=True)
    check(err <= tol, f"{label}: eigenvalue error <= {tol:g}")
    check(float(r.res.max()) <= tol, f"{label}: residuals <= {tol:g}")
    check(int(r.info) == 0, f"{label}: info = 0")
    check(r.q.shape[1] == r.M and bool(r.q.isfinite().all()),
          f"{label}: finite (N, M) eigenvectors")


def expected_launches(applications, steps):
    """Launch counts the schedule of ``_sparse_cheb_filter_host_fused``
    must give: per application of a series of n coefficients on a rung,
    one 1-step init, then over the r = n - 2 remaining steps floor(r/4)
    4-step passes, a 2-step pass if r mod 4 >= 2 and a 1-step launch if r
    is odd (``steps[rung]`` = 4); r // 2 2-step passes and the odd step
    (= 2); r 1-step launches (= 1)."""
    want = {name: 0 for name in KERNELS}
    for rung, n in applications:
        r = n - 2
        n4 = r // 4 if steps[rung] == 4 else 0
        n2 = (r - 4 * n4) // 2 if steps[rung] >= 2 else 0
        want[f"cheb_step4_{rung}"] += n4
        want[f"cheb_step2_{rung}"] += n2
        want[f"cheb_step_{rung}"] += 1 + r - 4 * n4 - 2 * n2
    return want


def expected_gen_launches(applications, inner, qlen):
    """Launch counts the composite's schedule (``ops/cheb_gen.py``) must
    give: an application of n outer coefficients runs n - 1 outer steps
    (the init's and the chunk's), each with one column-major one-step
    launch for A, one for the inner init, the r = len(qc) - 2 other inner
    steps split 4 / 2 / 1 as ``inner[rung]`` allows, and one combine; the
    fp64 carry's inner init adds a combine per outer step and its outer
    init one more."""
    from feastkit_tpu_torch.ops.cheb_gen import inner_split
    want = {name: 0 for name in KERNELS}
    for rung, n in applications:
        outer = n - 1
        n4, n2, n1 = inner_split(qlen[rung] - 2, inner[rung])
        want[f"cheb_step_cm_{rung}"] += outer * (2 + n1)
        want[f"cheb_step4_{rung}"] += outer * (n4 // 4)
        want[f"cheb_step2_{rung}"] += outer * (n2 // 2)
        ds = rung == "f64"
        want[f"cheb_combine_{rung}"] += outer * (1 + ds) + ds
    return want


def expected_gen_forms(applications, inner, qlen):
    """Launches of the column-major one-step entries by form that the
    composite's schedule must give: per outer step the y = A~ T1 launch
    without T0 and acc ("bare"), the inner init without T0 ("bare" on the
    fp64 carry, "no_t0" with the accumulator on the f32 carry), and the
    inner one-step launches of the 4 / 2 / 1 split in the full form."""
    from feastkit_tpu_torch.ops.cheb_gen import inner_split
    from feastkit_tpu_torch.ops.cheb_kernels import CM_FORMS
    want = {f"cheb_step_cm_{rung}": dict.fromkeys(CM_FORMS, 0)
            for rung in ("f32", "f64")}
    for rung, n in applications:
        outer = n - 1
        n1 = inner_split(qlen[rung] - 2, inner[rung])[2]
        forms = want[f"cheb_step_cm_{rung}"]
        forms["bare"] += outer * (1 + (rung == "f64"))
        forms["no_t0"] += outer * (rung == "f32")
        forms["full"] += outer * n1
    return want


@contextlib.contextmanager
def recorded_applications(gen=False):
    """Record (rung, series length) of every filter application and each
    rung's steps per pass (the composite's: its inner steps per pass and
    the length of its inner series), read back from the solver as it
    runs."""
    from feastkit_tpu_torch.solvers import sparse
    name = ("_sparse_cheb_filter_host_fused_gen" if gen
            else "_sparse_cheb_filter_host_fused")
    orig = getattr(sparse, name)
    seen = dict(applications=[], steps={}, qlen={})

    def recorder(ctx, Q, *, rung, n_coeffs=None):
        n = len(ctx[rung]["coeffs"])
        if n_coeffs is not None:
            n = min(n, max(int(n_coeffs), 3))
        seen["applications"].append((rung, n))
        seen["steps"][rung] = ctx[rung]["inner_steps" if gen else "steps"]
        if gen:
            seen["qlen"][rung] = len(ctx[rung]["qc"])
        return orig(ctx, Q, rung=rung, n_coeffs=n_coeffs)

    setattr(sparse, name, recorder)
    try:
        yield seen
    finally:
        setattr(sparse, name, orig)


@contextlib.contextmanager
def switches(**env):
    """Set the FEAST_CHEB_FUSE2 / FEAST_CHEB_FUSE4 switches, and any other
    named in ``env`` (None: unset), for the block, then restore the
    environment."""
    names = ("FEAST_CHEB_FUSE2", "FEAST_CHEB_FUSE4") + tuple(
        k for k in env if k not in ("FEAST_CHEB_FUSE2", "FEAST_CHEB_FUSE4"))
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


def phase_seeded_draw(card_name):
    """The seeded subspace drawn on the card against the host draw it
    replaces, bit for bit, at the main path's shape and the consistent-mass
    cell's; each draw's time (CUDA events), the host draw's, the bound."""
    import torch
    from feastkit_tpu_torch.core.tools import seeded_subspace
    from feastkit_tpu_torch.ops import seeded_draw as sd
    print("== 3d. the seeded subspace on the card against the host draw",
          flush=True)
    bw = _card_rates(card_name)[0]
    check(sd.libm_matches(torch.cuda.current_device()),
          "the card's log1p and exp give the host libm's bits")
    out = {}
    for N, M0 in ((1048576, 72), (65536, 72)):
        t0 = time.perf_counter()
        want = seeded_subspace(N, M0, np.float64).astype(
            np.float32).astype(np.float64)
        plain_ms = (time.perf_counter() - t0) * 1e3
        before = sd.seeded_draw_f64.launches
        q = sd.seeded_subspace_f32_bits(N, M0, "cuda")
        launches = sd.seeded_draw_f64.launches - before
        got = q.cpu().numpy()
        differ = int(np.count_nonzero(got.view(np.uint64)
                                      != want.view(np.uint64)))
        err = float(np.abs(got - want).max())
        rel = err / float(np.abs(want).max())
        check(differ == 0, f"({N}, {M0}): the card's subspace is the host "
              f"draw's float32 bits widened, bit for bit")
        check(launches == 5, f"({N}, {M0}): five launches a draw")
        ms = cuda_time_ms(lambda: sd.seeded_draw_f64(q), 5, warm=1)
        # the buffer written by the parse, read by the column norms, read
        # and written by the scaling
        nbytes = 4 * N * M0 * 8
        bound_ms = nbytes / bw * 1e3
        print(f"   ({N}, {M0}): {ms:.4f} ms a draw on the card (host draw "
              f"{plain_ms:.1f} ms; bound {bound_ms:.4f} ms = "
              f"{nbytes / 1e9:.3f} GB at {bw / 1e12:.2f} TB/s, "
              f"{bound_ms / ms:.1%} of bound)", flush=True)
        out[N] = dict(shape=[N, M0], ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by="bandwidth",
                      max_abs_err=err, max_rel_err=rel,
                      bits_differing=differ,
                      launches_per_draw=launches)
        del q, got, want
    torch.cuda.empty_cache()
    return out


def _counted_solve(A, B, Emin, Emax, M0, fpm, label, gen=False,
                   solve=None):
    """One solve (``feast``, or ``solve`` as ``_run_feast`` takes it) with
    the launch counts set to 0 just before and read just after; checks the
    counts against the schedule the solve reports."""
    from feastkit_tpu_torch.ops.cheb_kernels import (form_launch_counts,
                                                      launch_counts,
                                                      reset_launch_counts)
    with recorded_applications(gen) as seen:
        reset_launch_counts()
        r, seconds = _run_feast(A, B, Emin, Emax, M0, fpm, solve)
        counts = launch_counts()
        seen["forms"] = form_launch_counts()
    want = (expected_gen_launches(seen["applications"], seen["steps"],
                                  seen["qlen"]) if gen
            else expected_launches(seen["applications"], seen["steps"]))
    print(f"   {label}: {seconds:.2f} s, steps per pass {seen['steps']}, "
          f"applications {seen['applications']}, launches {counts}",
          flush=True)
    check(counts == want, f"{label}: launches follow the schedule {want}")
    if gen:
        want = expected_gen_forms(seen["applications"], seen["steps"],
                                  seen["qlen"])
        print(f"   {label}: column-major launches by form {seen['forms']}",
              flush=True)
        check(seen["forms"] == want, f"{label}: column-major launches by "
              f"form follow the schedule {want}")
    return r, seconds, counts, seen


def phase_main_path(kernels):
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.ops import seeded_draw as sd
    print("== 4. main path: feast on the 2D Laplacian, P=10", flush=True)
    nx = 1024
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = int(-(-int(len(exp) * 1.3) // 8) * 8)
    check(len(exp) == 52 and M0 == 72, "fixture: 52 pairs, M0 = 72")
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    print(f"   N={nx * nx} interval=({Emin:.6e}, {Emax:.6e}) M0={M0}",
          flush=True)
    r, cold_s = _run_feast(A, None, Emin, Emax, M0, fpm)
    print(f"   cold solve {cold_s:.2f} s", flush=True)
    _check_result(r, exp, 1e-8, "P=10 cold")
    del r
    torch.cuda.empty_cache()
    gc.collect()    # no earlier phase's cyclic garbage in this peak
    torch.cuda.reset_peak_memory_stats()
    sd.reset_launch_counts()
    with switches():
        r, warm_s, counts, seen = _counted_solve(A, None, Emin, Emax, M0,
                                                 fpm, "P=10 warm")
    seeded = sd.launch_counts()
    print(f"   P=10 warm: seeded draw launches {seeded}", flush=True)
    check(seeded == {"seeded_draw_f64": 5, "libm_matches": 0},
          "the warm solve draws its subspace on the card once (five "
          "launches; the libm check made by the cold solve)")
    peak = torch.cuda.max_memory_allocated()
    print(f"   warm solve {warm_s:.2f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    _check_result(r, exp, 1e-8, "P=10 warm")
    check(seen["steps"] == {"f32": 4, "f64": 4},
          "both rungs take four steps per pass at the main shapes")
    for name in MAIN_PATH_KERNELS:
        check(counts[name] > 0,
              f"{name} launched on the main path ({counts[name]})")
    r_lam = np.sort(r.lam)
    del r
    warm = [warm_s]
    for _ in range(2):
        r, s = _run_feast(A, None, Emin, Emax, M0, fpm)
        check(r.M == 52 and int(r.info) == 0, "repeat warm solve agrees")
        warm.append(s)
        del r
    print(f"   warm solves {[round(s, 3) for s in warm]} s, median "
          f"{float(np.median(warm)):.3f} s", flush=True)
    breakdown = _breakdown(A, None, Emin, Emax, M0, fpm)
    for rung in ("f32", "f64"):
        names = [n for n in counts if n.endswith(rung) and counts[n]]
        kernel_s = sum(counts[n] * kernels[n]["ms"] for n in names) / 1e3
        print(f"   {rung} rung: launches "
              f"{ {n: counts[n] for n in names} } x ms/launch (CUDA events, "
              f"phase 3) = {kernel_s:.3f} s; filter stage "
              f"{breakdown.get('filter_' + rung, 0.0):.3f} s", flush=True)
    return dict(cold_s=cold_s, warm_s=warm, warm_median_s=float(
        np.median(warm)), peak_bytes=peak, counts=counts,
        seeded_launches=seeded["seeded_draw_f64"],
        applications=seen["applications"], breakdown=breakdown,
        lam=r_lam)


def _breakdown(A, B, Emin, Emax, M0, fpm):
    """One more warm solve with the solver's stages wrapped in timers (the
    device synchronised at each stage's edges): where the time goes; and
    the DIA entries' and the Chebyshev kernels' launches inside each filter
    stage's timer (``filter_launches``)."""
    import torch
    from feastkit_tpu_torch.ops import cheb_kernels as ck
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.solvers import sparse
    times = {}
    filter_launches = {}

    def launch_counts():
        return {**D.launch_counts(), **ck.launch_counts()}

    def timed(name, bucket, sync=True, count=False):
        orig = getattr(sparse, name)

        def wrapper(*a, **k):
            if sync:
                torch.cuda.synchronize()
            before = launch_counts() if count else None
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if sync:
                torch.cuda.synchronize()
            key = bucket(k) if callable(bucket) else bucket
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
            if count:
                seen = filter_launches.setdefault(key, {})
                for n, v in launch_counts().items():
                    if v > before[n]:
                        seen[n] = seen.get(n, 0) + v - before[n]
            return out
        setattr(sparse, name, wrapper)
        return name, orig

    def rr_factory(*a, **k):
        update = saved_rr(*a, **k)

        def timed_update(*ua, **uk):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = update(*ua, **uk)
            torch.cuda.synchronize()
            times["rayleigh_ritz"] = (times.get("rayleigh_ritz", 0.0)
                                      + time.perf_counter() - t0)
            return out
        return timed_update

    saved_rr = sparse.make_rayleigh_ritz_update
    saved = [timed("_sparse_cheb_filter_host_fused",
                   lambda k: f"filter_{k['rung']}", count=True),
             timed("_sparse_cheb_filter_host",
                   lambda k: f"filter_{k['rung']}", count=True),
             timed("_sparse_cheb_filter_host_fused_gen",
                   lambda k: f"filter_{k['rung']}", count=True),
             timed("_b_spd_bounds", "b_bounds_lanczos"),
             timed("_pencil_upper_edge_fast", "pencil_edge_lanczos"),
             timed("cheb_inverse_coeffs", "host_coeffs", sync=False),
             timed("sparse_coo_arrays", "host_coo", sync=False),
             timed("bcoo_to_dia", "host_dia", sync=False),
             timed("gershgorin_interval", "host_enclosure", sync=False),
             timed("rational_filter_cheb_coeffs", "host_coeffs",
                   sync=False),
             timed("build_cheb_filter_coeffs", "host_coeffs", sync=False),
             timed("initial_subspace", "host_q0", sync=False),
             timed("verify_spurious_from", "verify_mask"),
             timed("_backxform", "backxform")]
    sparse.make_rayleigh_ritz_update = rr_factory
    try:
        _, wall = _run_feast(A, B, Emin, Emax, M0, fpm)
    finally:
        sparse.make_rayleigh_ritz_update = saved_rr
        for name, orig in saved:
            setattr(sparse, name, orig)
    rest = wall - sum(times.values())
    times = {k: round(v, 4) for k, v in sorted(times.items())}
    print(f"   breakdown of a warm solve ({wall:.2f} s): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f", other {rest:.3f} s", flush=True)
    return dict(wall_s=wall, other_s=rest, filter_launches=filter_launches,
                **times)


def phase_p9():
    import feastkit_tpu_torch as ft
    print("== 5. P=9: fpm[42]=0 (fp64 kernels only), a diagonal B, and the "
          "FEAST_CHEB_FUSE2 / FEAST_CHEB_FUSE4 switches", flush=True)
    nx = 512
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = int(-(-int(len(exp) * 1.3) // 8) * 8)
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    fpm[42] = 0
    with switches():
        r, f64_s, counts, _ = _counted_solve(A, None, Emin, Emax, M0, fpm,
                                             "P=9 fpm[42]=0")
    _check_result(r, exp, 1e-8, "P=9 fpm[42]=0")
    check(all(n == 0 for name, n in counts.items() if name.endswith("f32"))
          and counts["cheb_step_f64"] > 0 and counts["cheb_step4_f64"] > 0,
          "fpm[42]=0 runs the fp64 kernels only")
    # the default call under the reference's two switches
    fpm[42] = 1
    sw = {}
    for label, env, carried in (
            ("default", {}, ("cheb_step4_f32", "cheb_step4_f64")),
            ("FEAST_CHEB_FUSE4=0", {"FEAST_CHEB_FUSE4": "0"},
             ("cheb_step2_f32", "cheb_step2_f64")),
            ("FEAST_CHEB_FUSE2=0", {"FEAST_CHEB_FUSE2": "0"},
             ("cheb_step_f32", "cheb_step_f64"))):
        with switches(**env):
            r, secs, c, seen = _counted_solve(A, None, Emin, Emax, M0, fpm,
                                              f"P=9 {label}")
        _check_result(r, exp, 1e-8, f"P=9 {label}")
        S = {"default": 4, "FEAST_CHEB_FUSE4=0": 2}.get(label, 1)
        check(set(seen["steps"].values()) == {S},
              f"{label}: {S} step(s) per pass on both rungs")
        check(all(c[n] > 0 for n in carried), f"{label}: {carried} launched")
        if S == 2:
            check(c["cheb_step4_f32"] == 0 and c["cheb_step4_f64"] == 0,
                  "FEAST_CHEB_FUSE4=0: no 4-step launch")
            print(f"   P=9 FEAST_CHEB_FUSE4=0: {secs:.3f} s, 2-step launches "
                  f"cheb_step2_f32 {c['cheb_step2_f32']}, cheb_step2_f64 "
                  f"{c['cheb_step2_f64']}", flush=True)
        if S == 1:
            check(all(c[n] == 0 for n in c if "step2" in n or "step4" in n),
                  "FEAST_CHEB_FUSE2=0: only the 1-step kernels launched")
        sw[label] = dict(seconds=secs, launches=c, M=r.M,
                         lam=np.sort(r.lam))
    for label in ("FEAST_CHEB_FUSE4=0", "FEAST_CHEB_FUSE2=0"):
        gap = float(np.abs(sw[label]["lam"] - sw["default"]["lam"]).max())
        print(f"   {label} vs default: eigenvalues {gap:.3e} apart",
              flush=True)
        check(sw[label]["M"] == sw["default"]["M"] and gap <= 1e-8,
              f"{label} agrees with the default switches")
    for v in sw.values():
        del v["lam"]
    A, B, w = separable_pencil(nx, seed=5)
    Emin, Emax, exp = interval_lowest(w)
    M0 = int(-(-int(len(exp) * 1.3) // 8) * 8)
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    with switches():
        r, diag_s = _run_feast(A, B, Emin, Emax, M0, fpm)
    print(f"   diagonal B: {diag_s:.2f} s", flush=True)
    _check_result(r, exp, 1e-8, "P=9 diagonal B")
    return dict(f64_only_s=f64_s, f64_only_launches=counts,
                diag_b_s=diag_s, diag_b_loops=r.loop, switches=sw)


MAIN_PATH_KERNELS = ("cheb_step_f32", "cheb_step_f64", "cheb_step2_f32",
                     "cheb_step4_f32", "cheb_step2_f64", "cheb_step4_f64")
SPD_B_KERNELS = ("cheb_step_cm_f32", "cheb_step_cm_f64", "cheb_combine_f32",
                 "cheb_combine_f64")


def phase_consistent_mass(kernels):
    """The SPD-B path: feast on the consistent-mass pencil at P=8 through
    the auto route, once cold, then three warm solves (the first counted),
    then one with its stages timed."""
    import torch
    import feastkit_tpu_torch as ft
    print("== 6. SPD-B path: feast on the consistent-mass pencil, P=8",
          flush=True)
    A, B, w = consistent_mass_pencil(8)
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, 50)]
    Emax = float(0.5 * (w[hi] + w[hi + 1]))
    exp = w[w <= Emax]
    M0 = 72
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    print(f"   N={A.shape[0]} interval=(0, {Emax:.6e}) M0={M0}, "
          f"{len(exp)} analytic pairs", flush=True)
    r, cold_s = _run_feast(A, B, 0.0, Emax, M0, fpm)
    print(f"   cold solve {cold_s:.2f} s", flush=True)
    _check_result(r, exp, 1e-8, "P=8 consistent mass cold")
    del r
    torch.cuda.empty_cache()
    gc.collect()    # no earlier phase's cyclic garbage in this peak
    torch.cuda.reset_peak_memory_stats()
    with switches():
        r, warm_s, counts, seen = _counted_solve(
            A, B, 0.0, Emax, M0, fpm, "P=8 consistent mass warm", gen=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"   warm solve {warm_s:.2f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB; inner steps per pass {seen['steps']}, "
          f"inner series lengths {seen['qlen']}", flush=True)
    _check_result(r, exp, 1e-8, "P=8 consistent mass warm")
    for name in SPD_B_KERNELS:
        check(counts[name] > 0, f"{name} launched on the SPD-B path "
              f"({counts[name]})")
    rungs = {rung for rung, _ in seen["applications"]}
    check(rungs == {"f32", "f64"}
          and all(counts[f"cheb_step4_{rung}"] > 0 for rung in rungs),
          "both rungs ran, their inner recurrences in 4-step passes")
    del r
    warm = [warm_s]
    for _ in range(2):
        r, s = _run_feast(A, B, 0.0, Emax, M0, fpm)
        check(r.M == len(exp) and int(r.info) == 0,
              "repeat warm solve agrees")
        warm.append(s)
        del r
    print(f"   warm solves {[round(s, 3) for s in warm]} s, median "
          f"{float(np.median(warm)):.3f} s", flush=True)
    breakdown = _breakdown(A, B, 0.0, Emax, M0, fpm)
    forms = seen["forms"]

    def seconds(n):
        # the column-major entries: each form's launches x its own time
        if n in forms:
            return sum(c * kernels[n]["forms"][f]["ms"]
                       for f, c in forms[n].items()) / 1e3
        return counts[n] * kernels[n]["ms"] / 1e3
    for rung in ("f32", "f64"):
        names = [n for n in counts if n.endswith(rung) and counts[n]]
        kernel_s = sum(seconds(n) for n in names if n in kernels)
        print(f"   {rung} rung: launches "
              f"{ {n: counts[n] for n in names} }; x ms/launch (phase 3, "
              f"nine-diagonal device times for the multi-step kernels, "
              f"each form's device time for the column-major entries) = "
              f"{kernel_s:.3f} s, of which the column-major entries "
              f"{sum(seconds(n) for n in names if n in forms):.3f} s; "
              f"filter stage {breakdown.get('filter_' + rung, 0.0):.3f} s",
              flush=True)
    return dict(cold_s=cold_s, warm_s=warm, warm_median_s=float(
        np.median(warm)), peak_bytes=peak, counts=counts,
        form_counts=forms, applications=seen["applications"],
        inner_steps=seen["steps"], inner_series=seen["qlen"],
        breakdown=breakdown)


# -- phase 10: the direct-solver contour engines ---------------------------

def dense_config2(n=2048, seed=0):
    """bench.py's config 2 pencil (``_problem``): the 1D Laplacian A and
    B = C C^T + I with C seeded, both f32."""
    rng = np.random.default_rng(seed)
    A = (np.diag(2.0 * np.ones(n)) + np.diag(-1.0 * np.ones(n - 1), 1)
         + np.diag(-1.0 * np.ones(n - 1), -1))
    C = rng.standard_normal((n, n)) * (0.5 / np.sqrt(n))
    return A.astype(np.float32), (C @ C.T + np.eye(n)).astype(np.float32)


def hermitian_config2(n=2048, seed=1):
    """The complex counterpart of config 2: a seeded Hermitian A (entries of
    size ~1/sqrt(n)) and HPD B = C C^H + I, complex128."""
    rng = np.random.default_rng(seed)
    H = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
    C = (rng.standard_normal((n, n))
         + 1j * rng.standard_normal((n, n))) * (0.5 / np.sqrt(n))
    return (H + H.conj().T) / 2, C @ C.conj().T + np.eye(n)


def middle_interval(w, count):
    """The interval around ``count`` eigenvalues from the middle of the
    sorted spectrum w, its ends halfway between neighbours (bench.py)."""
    k = len(w) // 2
    return (float((w[k - 1] + w[k]) / 2),
            float((w[k + count - 1] + w[k + count]) / 2))


def banded_config3(n=2048, kd=4):
    """bench.py's config 3 (``_banded_bench``): a seeded symmetric band of
    half bandwidth kd, f32: (band storage, the interval of 15 eigenvalues
    at the middle of the spectrum, the float64 eigenvalues)."""
    from feastkit_tpu_torch.ops.banded import full_to_banded
    rng = np.random.default_rng(0)
    A = np.zeros((n, n), np.float32)
    for d in range(kd + 1):
        v = (rng.standard_normal(n - d) * (0.5 if d else 1.0)).astype(
            np.float32)
        A[np.arange(n - d), np.arange(d, n)] = v
        A[np.arange(d, n), np.arange(n - d)] = v
    A[np.arange(n), np.arange(n)] += 2 * kd
    w = np.linalg.eigvalsh(A.astype(np.float64))
    k = n // 2 - 32             # 992 at n = 2048, as in bench.py
    Emin, Emax = float((w[k] + w[k + 1]) / 2), float((w[k + 16]
                                                       + w[k + 15]) / 2)
    return full_to_banded(A, kd, kd), (Emin, Emax), w


def banded_throughput(n=65536, kd=4):
    """bench.py's banded throughput leg (``_banded_large_bench``): a seeded
    f32 band of half bandwidth kd with 20 diagonal spikes in [28, 32]."""
    rng = np.random.default_rng(0)
    bands = np.zeros((2 * kd + 1, n), np.float32)
    for d in range(1, kd + 1):
        v = (rng.standard_normal(n - d) * 0.5).astype(np.float32)
        bands[kd - d, d:] = v
        bands[kd + d, :n - d] = v
    bands[kd] = 2 * kd + rng.standard_normal(n).astype(np.float32) * 0.5
    bands[kd, rng.choice(n, 20, replace=False)] = np.linspace(
        28.0, 32.0, 20).astype(np.float32)
    return bands


def narrow_band(f64, n=8192, kd=2):
    """bench.py's narrow-band leg (``_narrowband_bench``): a seeded band of
    half bandwidth 2 with 20 spikes in [18, 22], as CSR, and its band
    storage."""
    import scipy.sparse as sp
    dt = np.float64 if f64 else np.float32
    rng = np.random.default_rng(7)
    diags, offs = [2.0 * kd + rng.standard_normal(n) * 0.5], [0]
    for d in range(1, kd + 1):
        v = rng.standard_normal(n - d) * 0.5
        diags += [v, v]
        offs += [d, -d]
    diags[0][rng.choice(n, 20, replace=False)] = np.linspace(18.0, 22.0, 20)
    A = sp.diags([d.astype(dt) for d in diags], offs, format="csr")
    bands = np.zeros((2 * kd + 1, n))
    for d, v in zip(offs, diags):
        if d >= 0:
            bands[kd - d, d:] = v.astype(dt)
        else:
            bands[kd - d, :n + d] = v.astype(dt)
    return A, bands


def band_eigs(bands, kd, lo, hi):
    """Eigenvalues in [lo, hi] of a symmetric band in band storage, in
    float64 on the host (LAPACK's upper band storage is rows 0..kd)."""
    import scipy.linalg as sla
    dt = np.complex128 if np.iscomplexobj(bands) else np.float64
    return np.sort(sla.eig_banded(np.asarray(bands[:kd + 1], dt),
                                  eigvals_only=True, select="v",
                                  select_range=(lo, hi)))


@contextlib.contextmanager
def direct_stages(times, device="cuda"):
    """Time the direct engines' stages for the block (the device
    synchronised at each stage's edges): the factorizations (dense LU, the
    BCR re-blocking and factor), the filter solves (dense triangular
    solves, BCR solves), the polynomial filter, and Rayleigh-Ritz; and
    record which engine ran (``times["engines"]``)."""
    import torch
    from feastkit_tpu_torch.kernel import hermitian
    from feastkit_tpu_torch.solvers import banded, dense, sparse
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    engines = times.setdefault("engines", [])
    saved = []

    def timed(mod, name, key, engine=None):
        orig = getattr(mod, name)

        def wrapper(*a, **k):
            if engine and engine not in engines:
                engines.append(engine)
            sync()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            sync()
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
            return out
        setattr(mod, name, wrapper)
        saved.append((mod, name, orig))

    def rr(mod):
        orig = mod.make_rayleigh_ritz_update

        def factory(*a, **k):
            update = orig(*a, **k)

            def timed_update(*ua, **uk):
                sync()
                t0 = time.perf_counter()
                out = update(*ua, **uk)
                sync()
                times["rayleigh_ritz"] = (times.get("rayleigh_ritz", 0.0)
                                          + time.perf_counter() - t0)
                return out
            return timed_update
        mod.make_rayleigh_ritz_update = factory
        saved.append((mod, "make_rayleigh_ritz_update", orig))

    timed(dense, "_factor", "factor", "dense")
    timed(dense, "_solve", "filter_solves")
    timed(banded, "banded_to_blocktridiag", "factor", "bcr")
    timed(banded, "bcr_factor", "factor")
    timed(banded, "bcr_solve", "filter_solves")
    timed(sparse, "_sparse_cheb_filter_host_fused", "filter_polynomial",
          "polynomial")
    timed(sparse, "_sparse_cheb_filter_host", "filter_polynomial",
          "polynomial")
    rr(hermitian)
    rr(sparse)
    try:
        yield times
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)


def _direct_leg(label, solve, exp, bar, tol, want_engine, device="cuda",
                warm=3, launch_source="cheb"):
    """One leg: a cold solve, ``warm`` warm ones (the median reported, the
    Chebyshev kernels' launches counted in the first, or the DIA entries'
    with ``launch_source="dia"``, the peak device memory over it), then one
    with its stages timed. Checks M, the eigenvalues against the host's
    float64 ones (bar; for single precision times max(1, |lam|)), every
    residual (<= tol), info 0, finite eigenvectors and the engine that
    ran."""
    import torch
    from feastkit_tpu_torch.ops import cheb_kernels as ck
    from feastkit_tpu_torch.ops import dia as D
    if launch_source == "dia":
        ck = D
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def run():
        sync()
        t0 = time.perf_counter()
        r = solve()
        sync()
        return r, time.perf_counter() - t0

    r, cold = run()
    del r
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(warm):
        if i == 0:
            ck.reset_launch_counts()
        r, s = run()
        if i == 0:
            launches = {k: v for k, v in ck.launch_counts().items() if v}
            peak = torch.cuda.max_memory_allocated() if device == "cuda" \
                else 0
        secs.append(s)
        if i < warm - 1:
            del r
    stages = {}
    with direct_stages(stages, device):
        _, staged = run()
    engines = stages.pop("engines")
    stages = {k: round(v, 4) for k, v in sorted(stages.items())}
    err = float(np.abs(np.sort(r.lam) - exp).max()) if r.M == len(exp) \
        else float("inf")
    if bar >= 1e-5:
        # single precision: the bar relative to the eigenvalues' size, as
        # FEAST's residuals are (an f32 Rayleigh quotient of |lam| ~ 30
        # over 65,536 rows carries ~1e-6 relative rounding)
        bar *= max(1.0, float(np.abs(exp).max(initial=0.0)))
    res = float(np.max(r.res)) if r.M else 0.0
    median = float(np.median(secs))
    print(f"   {label}: engine {'+'.join(engines)}, M={r.M} info="
          f"{int(r.info)} loops={r.loop} eigenvalue error {err:.3e} max "
          f"residual {res:.3e}; cold {cold:.3f} s, warm "
          f"{[round(s, 4) for s in secs]} s, median {median:.4f} s, peak "
          f"{peak / 2**30:.3f} GiB; stages of one more ({staged:.4f} s): "
          f"{stages}, other {staged - sum(stages.values()):.4f} s; "
          f"{'DIA' if launch_source == 'dia' else 'Chebyshev'} launches "
          f"{launches}", flush=True)
    check(r.M == len(exp), f"{label}: M = {len(exp)}")
    check(err <= bar, f"{label}: eigenvalue error <= {bar:g}")
    check(res <= tol, f"{label}: residuals <= tol {tol:.3g}")
    check(int(r.info) == 0, f"{label}: info = 0")
    check(r.q.shape[1] == r.M and bool(torch.isfinite(r.q).all())
          and r.q.device.type == device, f"{label}: finite (N, M) "
          f"eigenvectors on {device}")
    check(engines == [want_engine], f"{label}: the {want_engine} engine "
          "ran, and no other")
    if want_engine == "polynomial" and device == "cuda":
        check(sum(launches.values()) > 0, f"{label}: the "
              f"{'DIA' if launch_source == 'dia' else 'Chebyshev'} kernels "
              "carried the filter")
    return dict(engine=want_engine, M=r.M, loops=r.loop, eig_err=err,
                max_res=res, cold_s=cold, warm_s=secs, warm_median_s=median,
                peak_bytes=peak, stages=stages, staged_s=staged,
                launches=launches)


def phase_direct(device="cuda", scale=1):
    """Phase 10: the direct-solver contour engines at the widths of the
    JAX package's bench.py legs, through the entry points with the default
    device (scale > 1 shrinks N, for a dry run)."""
    import scipy.linalg as sla
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.core.parameters import feast_tolerance
    print("== 10. the direct engines: dense (configs 1-2), banded (config 3, "
          "the throughput and narrow-band legs) and the densified sparse "
          "pencil", flush=True)
    kw = {} if device == "cuda" else {"device": device}
    legs = {}

    def tol_of(dtype):
        return feast_tolerance(ft.feastdefault(ft.feastinit()), dtype)

    n = 2048 // scale
    A, B = dense_config2(n)
    w = sla.eigh(A.astype(np.float64), B.astype(np.float64),
                 eigvals_only=True)
    Emin, Emax = middle_interval(w, 24)
    exp = w[(w >= Emin) & (w <= Emax)]
    fpm = ft.feastinit()
    fpm[2] = 16
    At, Bt = (torch_tensor(X, device) for X in (A, B))
    legs["config2_sygv_f32"] = _direct_leg(
        f"config 2 feast_sygv f32 n={n}", lambda: ft.feast_sygv(
            At, Bt, Emin, Emax, 32, fpm, **kw), exp, 1e-5,
        tol_of(np.float32), "dense", device)
    check(len(exp) == 24, "config 2: 24 eigenvalues in the interval")

    A, B = hermitian_config2(n)
    w = sla.eigh(A, B, eigvals_only=True)
    Emin, Emax = middle_interval(w, 24)
    exp = w[(w >= Emin) & (w <= Emax)]
    At, Bt = (torch_tensor(X, device) for X in (A, B))
    legs["config2_hegv_c128"] = _direct_leg(
        f"config 2 feast_hegv complex128 n={n}", lambda: ft.feast_hegv(
            At, Bt, Emin, Emax, 32, fpm, **kw), exp, 1e-9,
        tol_of(np.complex128), "dense", device)
    del At, Bt, A, B

    nq = 100
    Aq = (np.diag(2.0 * np.ones(nq)) + np.diag(-np.ones(nq - 1), 1)
          + np.diag(-np.ones(nq - 1), -1))
    wq = 2.0 - 2.0 * np.cos(np.arange(1, nq + 1) * np.pi / (nq + 1))
    exp = np.sort(wq[(wq >= 0.5) & (wq <= 1.5)])
    legs["config1_quickstart"] = _direct_leg(
        "config 1 quickstart feast n=100", lambda: ft.feast(
            Aq, None, (0.5, 1.5), 24, **kw), exp, 1e-10,
        tol_of(np.float64), "dense", device)
    check(len(exp) == 19, "config 1: 19 eigenvalues")

    bands, (Emin, Emax), w = banded_config3(n)
    exp = w[(w >= Emin) & (w <= Emax)]
    legs["config3_bcr_f32"] = _direct_leg(
        f"config 3 feast_banded f32 n={n} kd=4", lambda: ft.feast_banded(
            bands, 4, 4, (Emin, Emax), 16, **kw), exp, 1e-5,
        tol_of(np.float32), "bcr", device)

    nt = 65536 // scale
    bands = banded_throughput(nt)
    exp = band_eigs(bands, 4, 25.0, 35.0)
    legs["banded_throughput_f32"] = _direct_leg(
        f"banded throughput feast_banded f32 n={nt} kd=4",
        lambda: ft.feast_banded(bands, 4, 4, (25.0, 35.0), 24, **kw), exp,
        1e-5, tol_of(np.float32), "polynomial", device)
    check(len(exp) == 20, "throughput leg: 20 eigenvalues")

    nn = 8192 // scale
    for f64 in (False, True):
        A, bands = narrow_band(f64, nn)
        exp = band_eigs(bands, 2, 15.0, 25.0)
        name = "f64" if f64 else "f32"
        # the hand-off to the banded driver, then its polynomial route; in
        # f64 under mixed precision (auto: on for CUDA, as the JAX package's
        # is on its TPU) the ladder's sharper rational realization blows up
        # on this interval and the indicator is refused, so BCR answers:
        # the JAX package at fpm[42] = 2 routes it the same way
        legs[f"narrow_band_{name}"] = _direct_leg(
            f"narrow band feast(CSR) {name} n={nn} kd=2", lambda: ft.feast(
                A, None, (15.0, 25.0), 24, **kw), exp,
            1e-8 if f64 else 1e-5, tol_of(np.float64 if f64 else np.float32),
            "bcr" if f64 and device == "cuda" else "polynomial", device)
        check(len(exp) == 20, "narrow-band leg: 20 eigenvalues")

    A = lap2d(20)
    w = np.linalg.eigvalsh(A.toarray())
    Emin, Emax, exp = interval_lowest(w, 8)
    saved = os.environ.get("FEAST_CHEB_DEGREE")
    os.environ["FEAST_CHEB_DEGREE"] = "4"
    try:
        legs["densify_lap2d20"] = _direct_leg(
            "lap2d(20) under FEAST_CHEB_DEGREE=4 (densified)",
            lambda: ft.feast(A, None, (Emin, Emax), 16, **kw), exp, 1e-8,
            tol_of(np.float64), "dense", device)
    finally:
        os.environ.pop("FEAST_CHEB_DEGREE")
        if saved is not None:
            os.environ["FEAST_CHEB_DEGREE"] = saved
    return legs


# -- phase 11: the complex Hermitian sparse path, operators beyond 32
# diagonals ----------------------------------------------------------------

def gauge_rotated(A, theta):
    """D A D^* with D = diag(exp(i theta)): a tight-binding Hamiltonian in
    a pure-gauge vector potential, with A's spectrum exactly."""
    import scipy.sparse as sp
    C = A.tocoo()
    data = C.data * np.exp(1j * (theta[C.row] - theta[C.col]))
    return sp.csr_matrix((data, (C.row, C.col)), shape=A.shape)


def permuted(X, perm):
    """P X P^T for the permutation ``perm`` (the ordering an unstructured
    mesh generator leaves): the same spectrum, far more than 32 DIA
    diagonals."""
    return X[perm][:, perm].tocsr()


def banded_hermitian_throughput(n=65536, kd=4):
    """The banded throughput leg's band (``banded_throughput``) made
    Hermitian: seeded complex64 off-diagonals, the same spikes."""
    rng = np.random.default_rng(4)
    bands = np.zeros((2 * kd + 1, n), np.complex64)
    for d in range(1, kd + 1):
        v = (rng.standard_normal(n - d) + 1j * rng.standard_normal(n - d)) \
            * (0.5 / np.sqrt(2.0))
        bands[kd - d, d:] = v
        bands[kd + d, :n - d] = np.conj(v)
    bands[kd] = 2 * kd + rng.standard_normal(n) * 0.5
    bands[kd, rng.choice(n, 20, replace=False)] = np.linspace(28.0, 32.0, 20)
    return bands


def f3_fixture():
    """tests/test_sparse_matfree.py's crowded Hermitian tridiagonal pencil
    (n = 240) and its eigenvalues in [-0.35, 0.23]."""
    import scipy.sparse as sp
    n = 240
    d = np.linspace(-1.0, 1.0, n)
    A = sp.diags([np.full(n - 1, 0.08 - 0.05j), d.astype(complex),
                  np.full(n - 1, 0.08 + 0.05j)], [-1, 0, 1]).tocsr()
    w = np.linalg.eigvalsh(A.toarray())
    return A, w[(w >= -0.35) & (w <= 0.23)]


@contextlib.contextmanager
def all_counts():
    """The DIA and Chebyshev kernels' launch counts, set to 0 for the block
    and read into the dict it yields just after."""
    from feastkit_tpu_torch.ops import cheb_kernels as ck
    from feastkit_tpu_torch.ops import dia as D
    seen = {}
    D.reset_launch_counts()
    ck.reset_launch_counts()
    try:
        yield seen
    finally:
        seen.update(D.launch_counts())
        seen.update(ck.launch_counts())


def _hermitian_p10(p, staged=True):
    """Leg 1: feast(A_g, None, (Emin, Emax), 72) on the gauge-rotated 2D
    Laplacian at P = p (the polynomial path, the fused complex one-step
    entries): once cold, once warm (the launch counts and the peak memory
    are the warm solve's), and with ``staged`` once more with its stages
    timed."""
    import torch
    import feastkit_tpu_torch as ft
    nx = 2 ** p
    A = lap2d(nx)
    N = nx * nx
    A = gauge_rotated(A, np.random.default_rng(12).uniform(
        0.0, 2.0 * np.pi, N))
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = 72
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    print(f"   leg 1: gauge-rotated lap2d({nx}), N={N}, five complex "
          f"diagonals, interval=({Emin:.6e}, {Emax:.6e}) M0={M0}",
          flush=True)
    secs = {}
    for label in ("cold", "warm"):
        torch.cuda.empty_cache()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        with all_counts() as counts:
            r, secs[label] = _run_feast(A, None, Emin, Emax, M0, fpm)
        peak = torch.cuda.max_memory_allocated()
        print(f"   {label} solve {secs[label]:.2f} s, peak device memory "
              f"{peak / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        _check_result(r, exp, 1e-8, f"Hermitian P={p} {label}")
        check(len(exp) == 52 or p != 10, "fixture: 52 pairs")
        check(r.q.dtype == torch.complex128, "complex128 eigenvectors")
        check(counts["cheb_step_c64"] > 0 and counts["cheb_step_c128"] > 0,
              "the complex64 (f32 rung) and complex128 (fp64 rung) "
              "one-step entries carried the filter")
        check(counts["dia_matvec_c128"] > 0 and counts["dia_matvec_c64"] == 0,
              "the complex128 DIA entry carried Rayleigh-Ritz, and no "
              "filter product launched a DIA entry")
        check(all(counts[n] == 0 for n in REAL_DIA) and all(
            counts[n] == 0 for n in KERNELS
            if n not in ("cheb_step_c64", "cheb_step_c128")),
            "no real DIA entry and no real Chebyshev kernel launched")
        del r
    cold_s, warm_s = secs["cold"], secs["warm"]
    if not staged:
        return dict(N=N, cold_s=cold_s, warm_s=[warm_s],
                    warm_median_s=warm_s, peak_bytes=peak,
                    launches={k: v for k, v in counts.items() if v})
    breakdown = _breakdown(A, None, Emin, Emax, M0, fpm)
    warm = [warm_s, breakdown["wall_s"]]
    bw = _card_rates(torch.cuda.get_device_name(0))[0]
    stages = {}
    for rung, name, size in (("f32", "cheb_step_c64", 8),
                             ("f64", "cheb_step_c128", 16)):
        filt = breakdown.get(f"filter_{rung}", 0.0)
        # the launches inside the rung's filter timer only (not those of
        # Rayleigh-Ritz and the residuals); the bound: 5 planes and the
        # diagonals a launch
        n = breakdown["filter_launches"].get(f"filter_{rung}", {}).get(
            name, 0)
        bound_ms = (5 * N * M0 + 5 * N) * size / bw * 1e3
        ms = filt / n * 1e3 if n else float("nan")
        stages[rung] = dict(filter_s=filt, launches=n, ms_per_launch=ms,
                            bound_ms=bound_ms)
        print(f"   {rung} rung: filter {filt:.3f} s; {name} {n} launches "
              f"inside the filter, {ms:.4f} ms a launch with the host's "
              f"share (bound {bound_ms:.4f} ms)", flush=True)
    print(f"   warm solves {[round(s, 3) for s in warm]} s (the second with "
          f"stage timers), median {float(np.median(warm)):.3f} s",
          flush=True)
    return dict(N=N, cold_s=cold_s, warm_s=warm,
                warm_median_s=float(np.median(warm)), peak_bytes=peak,
                launches={k: v for k, v in counts.items() if v},
                breakdown=breakdown, stages=stages)


def _permuted_leg(p, warm=1):
    """Leg 2: the 2D Laplacian at P = p under a seeded symmetric
    permutation (far more than 32 diagonals): the unfused recurrence on
    torch CSR products."""
    import feastkit_tpu_torch as ft
    nx = 2 ** p
    N = nx * nx
    A = permuted(lap2d(nx), np.random.default_rng(21).permutation(N))
    offs = np.unique(A.tocoo().col.astype(np.int64) - A.tocoo().row)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    print(f"   leg 2: permuted lap2d({nx}), N={N}, {len(offs)} DIA "
          f"diagonals, interval=({Emin:.6e}, {Emax:.6e}) M0=72", flush=True)
    check(len(offs) > 32, "more than 32 diagonals")
    r, cold_s = _run_feast(A, None, Emin, Emax, 72, fpm)
    _check_result(r, exp, 1e-8, f"permuted P={p} cold")
    secs = []
    for i in range(warm):
        with all_counts() as counts:
            r, s = _run_feast(A, None, Emin, Emax, 72, fpm)
        secs.append(s)
    _check_result(r, exp, 1e-8, f"permuted P={p} warm")
    check(all(v == 0 for v in counts.values()),
          "no Chebyshev kernel and no DIA entry launched (CSR products)")
    print(f"   cold {cold_s:.2f} s, warm {[round(s, 3) for s in secs]} s",
          flush=True)
    return dict(N=N, diagonals=len(offs), cold_s=cold_s, warm_s=secs,
                loops=r.loop)


def _permuted_mass_leg(p):
    """Leg 3: the consistent-mass pencil at P = p under one seeded
    symmetric permutation of A and B (B on more than 32 diagonals): the
    host scipy bounds of B~ and of the pencil's upper edge, then the
    unfused composite q(B~) A~ on CSR products."""
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.solvers import sparse
    A, B, w = consistent_mass_pencil(p)
    N = A.shape[0]
    perm = np.random.default_rng(22).permutation(N)
    A, B = permuted(A, perm), permuted(B, perm)
    gaps = np.nonzero(np.diff(w) > 1e-12)[0]
    hi = gaps[np.searchsorted(gaps, 50)]
    Emax = float(0.5 * (w[hi] + w[hi + 1]))
    exp = w[w <= Emax]
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    print(f"   leg 3: permuted consistent-mass pencil, P={p}, N={N}",
          flush=True)
    seen = []
    saved = sparse._pencil_upper_edge, sparse._b_spd_bounds

    def edge(*a, **k):
        seen.append("host pencil edge")
        return saved[0](*a, **k)

    def bounds(B_data, B_idx, N, B_dia, offsets_B, device):
        seen.append("host B bounds" if offsets_B is None else "device")
        return saved[1](B_data, B_idx, N, B_dia, offsets_B, device)
    sparse._pencil_upper_edge, sparse._b_spd_bounds = edge, bounds
    try:
        with all_counts() as counts:
            r, secs = _run_feast(A, B, 0.0, Emax, 72, fpm)
    finally:
        sparse._pencil_upper_edge, sparse._b_spd_bounds = saved
    print(f"   one solve {secs:.2f} s; bounds {seen}", flush=True)
    _check_result(r, exp, 1e-8, f"permuted consistent mass P={p}")
    check(len(exp) == 52, "fixture: 52 pairs")
    check(seen == ["host B bounds", "host pencil edge"],
          "the host scipy bounds of B~ and of the pencil's edge ran")
    check(all(v == 0 for v in counts.values()),
          "no Chebyshev kernel and no DIA entry launched (CSR products)")
    return dict(N=N, seconds=secs, loops=r.loop, bounds=seen)


def _hermitian_krylov_leg(p):
    """Leg 4: the Laplacian at P = p with a uniform phase on its +-1 bonds
    (a constant complex stencil, so the multigrid plan sees it) through
    solver="gmres": the mirrored node set on the complex DIA entries."""
    import feastkit_tpu_torch as ft
    nx = 2 ** p
    N = nx * nx
    theta = 0.1 * (np.arange(N) % nx)
    A = gauge_rotated(lap2d(nx), theta)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = 72
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    print(f"   leg 4: lap2d({nx}) with phase 0.1 on the +-1 bonds, N={N}, "
          "solver='gmres'", flush=True)
    r, secs, counts, _ = _krylov_counted(
        A, None, Emin, Emax, M0, fpm, f"Hermitian Krylov P={p}",
        solver="gmres", solver_maxiter=250)
    _check_result(r, exp, 1e-8, f"Hermitian Krylov P={p}")
    print(f"   preconditioner {r.krylov['precond']} "
          f"({r.krylov['mg_levels']} levels)", flush=True)
    check(r.krylov["hermitian"] and r.krylov["precond"] == "mg",
          "the Hermitian engine with the multigrid preconditioner")
    check(counts["dia_matvec_batched_c64"] > 0
          and counts["dia_matvec_batched_c128"] > 0
          and all(counts[n] == 0 for n in REAL_DIA),
          "the batched complex DIA entries carried the node groups, no "
          "real entry launched")
    return dict(N=N, seconds=secs, loops=r.loop, launches=counts,
                precond=r.krylov["precond"], mg_levels=r.krylov["mg_levels"])


def phase_hermitian(device="cuda", staged=True, p_mass=8):
    """Phase 11: complex Hermitian pencils and operators beyond 32
    diagonals through the entry points a user calls (``staged``: leg 1's
    staged warm solve; ``p_mass``: the permuted consistent-mass leg's P;
    the whole script cuts both for time)."""
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.core.parameters import feast_tolerance
    print("== 11. complex Hermitian sparse pencils, operators on more than "
          "32 diagonals", flush=True)
    out = {"hermitian_p10": _hermitian_p10(10, staged)}
    out["permuted_p9"] = _permuted_leg(9)
    out[f"permuted_mass_p{p_mass}"] = _permuted_mass_leg(p_mass)
    out["hermitian_krylov_p7"] = _hermitian_krylov_leg(7)
    tol = feast_tolerance(ft.feastdefault(ft.feastinit()), np.complex64)
    bands = banded_hermitian_throughput()
    exp = band_eigs(bands, 4, 25.0, 35.0)
    out["banded_hermitian_c64"] = _direct_leg(
        "banded Hermitian throughput feast_hbev complex64 n=65536 kd=4",
        lambda: ft.feast_hbev(bands, 4, 4, 25.0, 35.0, 24), exp, 1e-5, tol,
        "polynomial", device)
    check(len(exp) == 20, "banded Hermitian leg: 20 eigenvalues")
    check(out["banded_hermitian_c64"]["launches"].get("cheb_step_c64", 0)
          > 0, "banded Hermitian leg: the complex64 one-step entry carried "
          "the filter")
    A, exp = f3_fixture()
    out["f3_hcsrev"] = _direct_leg(
        "F3 fixture feast_hcsrev n=240", lambda: ft.feast_hcsrev(
            A, -0.35, 0.23, 90), exp, 1e-9,
        feast_tolerance(ft.feastdefault(ft.feastinit()), np.complex128),
        "bcr", device)
    return out


# -- phase 12: the general-contour family ---------------------------------

GENERAL_BETA = 0.5


def general_stencil(p, beta=GENERAL_BETA):
    """(A, its eigenvalues): A = (1 + i beta) T_x (x) I + I (x) T_y on the
    2^p x 2^p grid (rows of nx, so the +-1 diagonals carry the complex
    coefficient), T = tridiag(-1, 2, -1): five constant complex diagonals,
    non-Hermitian, normal and complex symmetric, with the eigenvalues
    exactly (1 + i beta) mu_j + mu_k, mu_j = 4 sin^2(j pi / (2 nx + 2))."""
    import scipy.sparse as sp
    nx = 2 ** p
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(nx, nx))
    A = ((1 + 1j * beta) * sp.kron(sp.eye(nx), T)
         + sp.kron(T, sp.eye(nx))).tocsr()
    mu = 4 * np.sin(np.arange(1, nx + 1) * np.pi / (2 * (nx + 1))) ** 2
    return A, ((1 + 1j * beta) * mu[None, :] + mu[:, None]).ravel()


def general_band(n=8192, beta=GENERAL_BETA):
    """(A as CSR, its eigenvalues): T + i beta T^2 with T = tridiag(-1, 2,
    -1) (half bandwidth 2, normal and complex symmetric), eigenvalues
    mu_k + i beta mu_k^2."""
    import scipy.sparse as sp
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    mu = 4 * np.sin(np.arange(1, n + 1) * np.pi / (2 * (n + 1))) ** 2
    return (T + 1j * beta * (T @ T)).tocsr(), mu + 1j * beta * mu ** 2


def general_config5_dense(n=1024):
    """The JAX package's bench.py ``_general_bench`` (BASELINE config 5):
    diag(linspace(-1, 1)) plus strictly upper complex noise of scale
    0.01/sqrt(n), complex64: the eigenvalues are the diagonal."""
    rng = np.random.default_rng(2)
    d = np.linspace(-1.0, 1.0, n)
    A = np.triu(rng.standard_normal((n, n))
                + 1j * rng.standard_normal((n, n)), 1).astype(np.complex64)
    A *= 0.01 / np.sqrt(n)
    A += np.diag(d.astype(np.complex64))
    return A, d.astype(complex)


def general_config5_pep(n=512):
    """The JAX package's bench.py ``_pep_bench``: [K, C, M] with K =
    diag(uniform(0.5, 2)), C = 0.05 I, M = I, complex64; the eigenvalues
    -0.025 +- i sqrt(k - 0.000625)."""
    rng = np.random.default_rng(4)
    k = rng.uniform(0.5, 2.0, n)
    K = np.diag(k).astype(np.complex64)
    C = (0.05 * np.eye(n)).astype(np.complex64)
    M = np.eye(n, dtype=np.complex64)
    root = np.sqrt(k - 0.000625 + 0j)
    return [K, C, M], np.concatenate([-0.025 + 1j * root, -0.025 - 1j * root])


def _in_circle(w, Emid, r):
    return w[np.abs(w - Emid) <= r]


def _match_err(got, exp, rel=False):
    """Largest eigenvalue distance under the optimal pairing (complex
    eigenvalues whose real parts tie to rounding do not sort stably);
    ``rel``: relative to max(1, |lam|)."""
    from scipy.optimize import linear_sum_assignment
    got, exp = np.asarray(got), np.asarray(exp)
    if len(got) != len(exp):
        return float("inf")
    D = np.abs(got[:, None] - exp[None, :])
    if rel:
        D = D / np.maximum(1.0, np.abs(exp))[None, :]
    ri, ci = linear_sum_assignment(D)
    return float(D[ri, ci].max(initial=0.0))


def _general_check(r, exp, bar, tol, label, rel=False):
    """M, info 0, the eigenvalue error against the stated truth (<= bar,
    relative to max(1, |lam|) with ``rel``), residuals <= tol, finite (N, M)
    eigenvectors on the card; returns (error, max residual)."""
    import torch
    err = _match_err(r.lam, exp, rel)
    res = float(np.max(r.res)) if r.M else 0.0
    print(f"   {label}: M={r.M} info={int(r.info)} loops={r.loop} "
          f"eigenvalue error {err:.3e}{' relative' if rel else ''}, max "
          f"residual {res:.3e}", flush=True)
    check(r.M == len(exp), f"{label}: M = {len(exp)}")
    check(int(r.info) == 0, f"{label}: info = 0")
    check(err <= bar, f"{label}: eigenvalue error <= {bar:g}")
    check(res <= tol, f"{label}: residuals <= {tol:.3g}")
    check(r.q.shape[1] == r.M and bool(torch.isfinite(r.q).all())
          and r.q.is_cuda, f"{label}: finite (N, M) eigenvectors on the "
          "card")
    return err, res


@contextlib.contextmanager
def general_stages(times):
    """Time a general solve's stages for the block (the device synchronised
    at each stage's edges): the filter (each application; within it, for
    the Krylov engine, GMRES, and within GMRES the V-cycles, Gram-Schmidt
    and the Hessenberg least squares; for the direct engines the
    factorizations and the solves), the thin SVD and the reduced eig of
    Rayleigh-Ritz, Rayleigh-Ritz in all (a loop less its filter
    application), host set-up and Q0; ``times["engines"]`` records the
    engines that ran."""
    import torch
    from feastkit_tpu_torch.kernel import general
    from feastkit_tpu_torch.ops import gmres
    from feastkit_tpu_torch.solvers import (banded, dense, dense_general,
                                            sparse)
    engines = times.setdefault("engines", [])
    saved = []
    in_body = [False]

    def add(key, dt):
        times[key] = times.get(key, 0.0) + dt

    def timed_fn(fn, key, engine=None, sync=True):
        def wrapper(*a, **k):
            if engine and engine not in engines:
                engines.append(engine)
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            add(key, dt)
            if key == "filter" and in_body[0]:
                add("filter_in_loops", dt)
            return out
        return wrapper

    def patch(mod, name, make):
        orig = getattr(mod, name)
        saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    def body_factory(orig):
        def factory(*a, **k):
            body = orig(*a, **k)

            def timed_body(*ba, **bk):
                in_body[0] = True
                try:
                    return timed_fn(body, "loops")(*ba, **bk)
                finally:
                    in_body[0] = False
            return timed_body
        return factory

    patch(general, "_filter_with_ok", lambda f: timed_fn(f, "filter"))
    patch(general, "thin_svd", lambda f: timed_fn(f, "svd"))
    patch(general, "generalized_eig", lambda f: timed_fn(f, "reduced_eig"))
    patch(general, "make_general_body", body_factory)
    def marked(fn, engine):
        def wrapper(*a, **k):
            if engine not in engines:
                engines.append(engine)
            return fn(*a, **k)
        return wrapper

    patch(sparse, "_make_sparse_solve_all", lambda f: marked(f, "krylov"))
    patch(sparse, "gmres_block", lambda f: timed_fn(f, "gmres"))
    patch(sparse, "bicgstab_block", lambda f: timed_fn(f, "gmres"))
    patch(gmres, "_gram_schmidt", lambda f: timed_fn(f, "gram_schmidt"))
    patch(gmres, "_hessenberg_lstsq", lambda f: timed_fn(f, "lstsq"))
    patch(sparse, "make_shifted_vcycle",
          lambda f: lambda *a, **k: timed_fn(f(*a, **k), "vcycle"))
    patch(dense, "_factor", lambda f: timed_fn(f, "factor", "dense"))
    patch(dense_general, "lu_factor",
          lambda f: timed_fn(f, "factor", "dense"))
    patch(dense, "_solve", lambda f: timed_fn(f, "solves"))
    patch(banded, "banded_to_blocktridiag",
          lambda f: timed_fn(f, "factor", "bcr"))
    patch(banded, "bcr_factor", lambda f: timed_fn(f, "factor"))
    patch(banded, "bcr_solve", lambda f: timed_fn(f, "solves"))
    for name in ("sparse_coo_arrays", "_structured_forms", "_plan_mg",
                 "contour_tensors"):
        patch(sparse, name,
              lambda f: timed_fn(f, "host_setup", sync=False))
    for mod in (sparse, dense_general, banded):
        patch(mod, "initial_subspace",
              lambda f: timed_fn(f, "host_q0", sync=False))
    try:
        yield times
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)
        if "loops" in times:
            times["rayleigh_ritz"] = times["loops"] - times.get(
                "filter_in_loops", 0.0)


def _timed_call(solve):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solve()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def _general_krylov_leg(label, A, exp, Emid, r, M0, dia_ms, warm,
                        complex_symmetric=False):
    """A sparse general solve through feast_general with the default
    device: once cold with every DIA entry's launches counted (set to 0
    just before, read just after) and held to the solve's Krylov record,
    the peak device memory over it; then, with ``warm``, once warm with
    its stages timed and its DIA launches x their phase-3c time at this
    leg's shapes (``dia_ms``: phase 3c's rows there, by entry)."""
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.solvers.sparse import krylov_dia_launches
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    gc.collect()    # no earlier phase's cyclic garbage in this peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    D.reset_launch_counts()
    res, cold = _timed_call(lambda: ft.feast_general(
        A, None, Emid, r, M0, fpm, complex_symmetric=complex_symmetric))
    counts = D.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    k = res.krylov
    want = krylov_dia_launches(k)
    ev = k["events"]
    calls = sum(1 for e in ev if e["op"] == "gmres")
    trips = sum(e.get("trips", 0) for e in ev if e["op"] == "gmres")
    print(f"   {label}: cold {cold:.2f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB; precond {k['precond']} "
          f"({k['mg_levels']} levels), {calls} GMRES calls, {trips} restart "
          f"cycles; DIA launches { {n: v for n, v in counts.items() if v} }"
          f", by body {D.body_counts()}", flush=True)
    tol = 1e-8
    err, mres = _general_check(res, exp, 1e-7, tol, f"{label} cold")
    check(counts == want, f"{label}: DIA launches equal the count the "
          f"solve's Krylov record implies {want}")
    check(k["general"] and k["complex"] and k["precond"] == "mg",
          f"{label}: the general engine, complex work, multigrid")
    check(counts["dia_matvec_batched_c64"] > 0
          and counts["dia_matvec_batched_c128"] > 0
          and counts["dia_matvec_c128"] > 0
          and all(counts[n] == 0 for n in REAL_DIA),
          f"{label}: the batched complex entries carried the node groups "
          "(complex64 GMRES, complex128 refinement), the unbatched "
          "complex128 one Rayleigh-Ritz and the residuals; no real entry")
    out = dict(N=A.shape[0], M=res.M, info=int(res.info), loops=res.loop,
               eig_err=err, max_res=mres, cold_s=cold, peak_bytes=peak,
               precond=k["precond"], mg_levels=k["mg_levels"],
               gmres_calls=calls, restart_cycles=trips,
               launches={n: v for n, v in counts.items() if v})
    del res
    if not warm:
        return out
    stages = {}
    with general_stages(stages):
        D.reset_launch_counts()
        res, warm_s = _timed_call(lambda: ft.feast_general(
            A, None, Emid, r, M0, fpm, complex_symmetric=complex_symmetric))
        launched = D.launch_counts()
    engines = stages.pop("engines")
    _general_check(res, exp, 1e-7, tol, f"{label} warm")
    per_entry = {n: dict(launches=v, ms=dia_ms[n]["ms"],
                         shape=dia_ms[n]["shape"],
                         seconds=v * dia_ms[n]["ms"] / 1e3)
                 for n, v in launched.items() if v}
    dia_s = sum(e["seconds"] for e in per_entry.values())
    stages = {key: round(v, 4) for key, v in sorted(stages.items())}
    print(f"   {label}: warm {warm_s:.2f} s (stage timers on), engines "
          f"{engines}; stages {stages}", flush=True)
    for n, e in per_entry.items():
        print(f"   {label}: {n} {e['launches']} launches x {e['ms']:.4f} ms "
              f"(phase 3c, CUDA graph, shape {tuple(e['shape'])}) = "
              f"{e['seconds']:.3f} s", flush=True)
    print(f"   {label}: DIA launches x their phase-3c time {dia_s:.3f} s of "
          f"the {stages.get('filter', 0.0):.3f} s filter", flush=True)
    out.update(warm_s=warm_s, stages=stages, dia_launches_x_ms_s=dia_s,
               dia_per_entry=per_entry)
    return out


def _general_direct_leg(label, solve, exp, bar, tol, want_engine, warm=3,
                        rel=False):
    """A direct-engine general leg: one cold solve, ``warm`` warm ones (the
    median), the peak device memory over them, then one with its stages
    timed; checks M, info 0, the eigenvalues against the stated truth,
    residuals and the engine that ran."""
    import torch
    r, cold = _timed_call(solve)
    del r
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(warm):
        r, s = _timed_call(solve)
        secs.append(s)
    peak = torch.cuda.max_memory_allocated()
    stages = {}
    with general_stages(stages):
        _, staged = _timed_call(solve)
    engines = stages.pop("engines")
    stages = {key: round(v, 4) for key, v in sorted(stages.items())}
    median = float(np.median(secs))
    print(f"   {label}: engines {engines}; cold {cold:.4f} s, warm "
          f"{[round(s, 4) for s in secs]} s, median {median:.4f} s, peak "
          f"{peak / 2**30:.3f} GiB; stages of one more ({staged:.4f} s): "
          f"{stages}", flush=True)
    err, res = _general_check(r, exp, bar, tol, label, rel)
    check(engines == [want_engine], f"{label}: the {want_engine} engine "
          "ran, and no other")
    return dict(engine=want_engine, M=r.M, loops=r.loop, eig_err=err,
                max_res=res, cold_s=cold, warm_s=secs, warm_median_s=median,
                peak_bytes=peak, stages=stages, staged_s=staged)


# the path whose run gives each DIA entry's launches and times in the
# kernels line
DIA_PATHS = {
    "dia_matvec_f32": "Krylov P=8 (phase 8)",
    "dia_matvec_f64": "Krylov P=8 (phase 8)",
    "dia_matvec_batched_f32": "Krylov P=8 (phase 8)",
    "dia_matvec_batched_f64": "Krylov P=8 (phase 8)",
    # the fused complex step carries every Hermitian filter on a DIA
    # form; phase 3c alone runs dia_matvec_c64
    "dia_matvec_c64": "none in this script's solves",
    "dia_matvec_c128": "Hermitian P=10 (phase 11 leg 1, Rayleigh-Ritz)",
    "dia_matvec_batched_c64": "Hermitian Krylov P=7 (phase 11 leg 4)",
    "dia_matvec_batched_c128": "Hermitian Krylov P=7 (phase 11 leg 4)",
}


def general_dia_rows(dia_other):
    """Phase 3c's rows of the complex entries at the general Krylov leg's
    shapes (phase 12, P=8), keyed by entry."""
    return {key.split(" ", 1)[1]: dict(row) for key, row in dia_other.items()
            if key.startswith("general_p8 ")}


def phase_general(dia_general, p=8, p_sym=7, staged=True):
    """Phase 12: the general-contour family through the entry points with
    the default device (``staged``: leg 1's staged warm solve, which the
    whole script cuts for time)."""
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.core.parameters import feast_tolerance
    print("== 12. the general-contour family: feast_general, the sparse "
          "engine on the complex DIA entries, the narrow-band hand-off, "
          "config 5 (dense general, polynomial)", flush=True)
    out = {}
    # (1) P=8 through feast_general: 44 eigenvalues inside the circle, the
    # nearest outside 7.1% of r from its edge and the nearest inside 6.6%
    A, lam = general_stencil(p)
    Emid, r = 0.005, 0.0055446
    exp = _in_circle(lam, Emid, r)
    print(f"   leg 1: (1 + {GENERAL_BETA}i) T (x) I + I (x) T at P={p}, "
          f"N={A.shape[0]}, circle ({Emid}, {r}), {len(exp)} eigenvalues "
          f"inside, M0=72, fpm[3]=8", flush=True)
    check(len(exp) == 44 or p != 8, "leg 1 fixture: 44 eigenvalues inside")
    out["general_p8"] = _general_krylov_leg(
        f"general P={p}", A, exp, Emid, r, 72, dia_general, warm=staged)
    # (2) the transpose pairing at P=7: 44 inside
    A, lam = general_stencil(p_sym)
    Emid, r = 0.0195, 0.022230
    exp = _in_circle(lam, Emid, r)
    print(f"   leg 2: the same operator at P={p_sym} with "
          f"complex_symmetric=True, circle ({Emid}, {r}), {len(exp)} "
          "inside", flush=True)
    check(len(exp) == 44 or p_sym != 7,
          "leg 2 fixture: 44 eigenvalues inside")
    out["complex_symmetric_p7"] = _general_krylov_leg(
        f"complex symmetric P={p_sym}", A, exp, Emid, r, 72, None,
        warm=False, complex_symmetric=True)
    tol64 = feast_tolerance(ft.feastdefault(ft.feastinit()), np.complex128)
    tol32 = feast_tolerance(ft.feastdefault(ft.feastinit()), np.complex64)
    # (3) the narrow-band hand-off: T + i beta T^2 (n = 8192, kd = 2) as
    # CSR, a circle around the mid-spectrum eigenvalue and its ten
    # neighbours each side, the edge half-way to the next ones
    A, lam = general_band()
    Emid = complex(lam[len(lam) // 2])
    d = np.sort(np.abs(lam - Emid))
    r = float(d[20] + d[21]) / 2
    exp = _in_circle(lam, Emid, r)
    out["narrow_band"] = _general_direct_leg(
        f"narrow band feast_gcsrev n={A.shape[0]} kd=2, {len(exp)} inside",
        lambda: ft.feast_gcsrev(A, Emid, r, 40), exp, 1e-7, tol64, "bcr",
        warm=1)
    # (4) config 5, dense: bench.py's _general_bench
    A, d = general_config5_dense()
    exp = _in_circle(d, 0.0, 0.016)
    out["config5_dense"] = _general_direct_leg(
        f"config 5 dense feast_general n=1024 complex64, {len(exp)} "
        "inside", lambda: ft.feast_general(A, None, 0.0, 0.016, 24), exp,
        1e-5, tol32, "dense", rel=True)
    # (5) config 5, polynomial: bench.py's _pep_bench, both methods
    coeffs, lam = general_config5_pep()
    Emid, r = -0.025 + 1.05j, 0.011
    exp = _in_circle(lam, Emid, r)
    for method in ("companion", "direct"):
        out[f"config5_pep_{method}"] = _general_direct_leg(
            f"config 5 feast_polynomial n=512 complex64 method={method}, "
            f"{len(exp)} inside", lambda: ft.feast_polynomial(
                coeffs, Emid, r, 24, method=method), exp, 1e-5, tol32,
            "dense", rel=True)
    return out


# the Laplacian's and the complex stencil's P on the matrix-free Krylov
# leg of phase 13 (unpreconditioned GMRES(30) resolves both within its
# default maxiter)
MATFREE_P_REAL = 6
MATFREE_P_GEN = 6


# -- phase 13: the matrix-free drivers and the RCI step machines ----------

def dia_operator(A, dtype, entry=None):
    """A LinearOperator over A's DIA diagonals on the card
    (``bcoo_to_dia``), its matvec the DIA kernel: the entry ``entry`` of
    ops/dia.py, else ``dia_matvec_any``."""
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.solvers.sparse import sparse_coo_arrays
    data, idx, _ = sparse_coo_arrays(A, dtype)
    dia, offsets = D.bcoo_to_dia(data, idx, A.shape[0])
    d = torch.as_tensor(dia, device="cuda")
    mv = entry or D.dia_matvec_any
    return ft.LinearOperator(lambda X: mv(d, offsets, X), A.shape, d.dtype,
                             symmetric=not d.is_complex())


@contextlib.contextmanager
def matfree_stages(record, timed=False):
    """Record a matrix-free polynomial solve's filter (its series length
    ``n_coeffs`` and its ``applications``) and, with ``timed``, time its
    stages into ``record`` (the device synchronised at each stage's
    edges): the Lanczos bounds, the filter applications, Rayleigh-Ritz
    with the residuals (each loop's update), the seeded Q0."""
    import torch
    from feastkit_tpu_torch.kernel import hermitian
    from feastkit_tpu_torch.ops import chebfilter
    from feastkit_tpu_torch.solvers import matfree as MF
    record["applications"] = 0
    saved = (MF.operator_spectrum_bounds, MF.initial_subspace,
             chebfilter.make_cheb_filter, hermitian.make_rayleigh_ritz_update)

    def timer(key, fn):
        def run(*a, **k):
            if not timed:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            record[key] = record.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    def make_filter(apply_A, lo, hi, coeffs):
        filt = saved[2](apply_A, lo, hi, coeffs)
        record["n_coeffs"] = len(coeffs)

        def counted(Q):
            record["applications"] += 1
            return filt(Q)
        return timer("filter", counted)

    MF.operator_spectrum_bounds = timer("lanczos_bounds", saved[0])
    MF.initial_subspace = timer("q0", saved[1])
    chebfilter.make_cheb_filter = make_filter
    hermitian.make_rayleigh_ritz_update = lambda *a, **k: timer(
        "rayleigh_ritz", saved[3](*a, **k))
    try:
        yield record
    finally:
        (MF.operator_spectrum_bounds, MF.initial_subspace,
         chebfilter.make_cheb_filter,
         hermitian.make_rayleigh_ritz_update) = saved


def matfree_launches(N, record, loops, steps=192):
    """The DIA launches a matrix-free polynomial solve must make: the
    Lanczos steps (one M = 1 product each), then per filter application
    one product per series term after the first (the recurrence's init
    and its len(coeffs) - 2 steps), and per refinement loop two more
    (Rayleigh-Ritz and the residuals)."""
    return (min(steps, N) + record["applications"] * (record["n_coeffs"] - 1)
            + 2 * loops)


def _matfree_p10(dia_rr, staged=True, p=10):
    """Leg 1: feast on a LinearOperator whose matvec is dia_matvec_f64 on
    the P = p Laplacian's five diagonals (p = 10; 9 in the default run, a
    depth cut for time), solver="cheb" (the Lanczos bounds, the unfused
    recurrence on the operator): once cold with its launches counted and
    held to their reckoning, and (``staged``) once warm with its stages
    timed. ``dia_rr``: phase 3c's row of dia_matvec_f64 at the P=10 shape
    (the P=10 Rayleigh-Ritz product's)."""
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.ops import dia as D
    nx = 2 ** p
    N = nx * nx
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = 72
    check(len(exp) == 52 or p != 10, "fixture: 52 pairs")
    op = dia_operator(A, np.float64, D.dia_matvec_f64)
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    print(f"   leg 1: feast(LinearOperator(dia_matvec_f64 on lap2d({nx})), "
          f"None, ({Emin:.6e}, {Emax:.6e}), {M0}, fpm, solver='cheb'), "
          f"N={N}", flush=True)

    def solve():
        return ft.feast(op, None, (Emin, Emax), M0, fpm, solver="cheb")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    record = {}
    with matfree_stages(record), all_counts() as counts:
        r, cold = _timed_call(solve)
    peak = torch.cuda.max_memory_allocated()
    print(f"   cold {cold:.2f} s, peak device memory {peak / 2**30:.2f} GiB; "
          f"series of {record['n_coeffs']} coefficients, "
          f"{record['applications']} filter applications; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    _check_result(r, exp, 1e-8, f"matrix-free P={p} cold")
    loops = r.loop + 1
    want = matfree_launches(N, record, loops)
    check(record["applications"] == loops + 1,
          "one filter application a loop and one for the spurious check")
    check(counts["dia_matvec_f64"] == want,
          f"dia_matvec_f64 launches {counts['dia_matvec_f64']} equal their "
          f"reckoning {want} (192 Lanczos steps, {record['applications']} "
          f"applications x {record['n_coeffs'] - 1} products, {loops} "
          "loops x 2)")
    check(all(v == 0 for n, v in counts.items() if n != "dia_matvec_f64"),
          "no other DIA entry and no Chebyshev kernel launched")
    launches = counts["dia_matvec_f64"]
    out = dict(p=p, N=N, M=r.M, loops=r.loop, eig_err=float(np.abs(
        np.sort(r.lam) - exp).max()), max_res=float(r.res.max()),
        cold_s=cold, peak_bytes=peak, launches=launches,
        n_coeffs=record["n_coeffs"], applications=record["applications"])
    del r
    if not staged:
        return out
    stages = {}
    with matfree_stages(stages, timed=True), all_counts() as counts:
        r, warm = _timed_call(solve)
    _check_result(r, exp, 1e-8, "matrix-free P=10 warm")
    check(counts["dia_matvec_f64"] == matfree_launches(N, stages,
                                                       r.loop + 1),
          "the warm solve's launches equal their reckoning")
    in_filter = stages["applications"] * (stages["n_coeffs"] - 1)
    kernel_s = in_filter * dia_rr["ms"] / 1e3
    times = {k: round(v, 4) for k, v in stages.items()
             if isinstance(v, float)}
    other = warm - sum(times.values())
    print(f"   warm {warm:.2f} s (stage timers on): {times}, other "
          f"{other:.3f} s; the filter's {in_filter} dia_matvec_f64 launches "
          f"x {dia_rr['ms']:.4f} ms (phase 3c, CUDA graph) = {kernel_s:.3f} "
          f"s, the recurrence's torch glue {times['filter'] - kernel_s:.3f} s",
          flush=True)
    out.update(warm_s=warm, stages=times, other_s=other,
               filter_kernel_s=kernel_s,
               filter_glue_s=times["filter"] - kernel_s)
    return out


def general_circle(lam, count):
    """(Emid, r, inside) of a circle about the lowest-real-part corner of
    the spectrum ``lam`` holding ``count`` eigenvalues, its edge halfway
    between the count-th and the next distance."""
    c = complex(lam[np.argmin(lam.real)].real)
    d = np.sort(np.abs(lam - c))
    c = complex(np.mean(lam[np.abs(lam - c) <= (d[count - 1] + d[count]) / 2]
                        ).real)
    d = np.sort(np.abs(lam - c))
    r = float(d[count - 1] + d[count]) / 2
    return c, r, _in_circle(lam, c, r)


def _matfree_krylov(p_real=MATFREE_P_REAL, p_gen=MATFREE_P_GEN):
    """Leg 2: the matrix-free contour engine (unpreconditioned GMRES(30) /
    BiCGStab per node) on DIA operators: feast on the real Laplacian at
    P = p_real (its complex blocks through the real entry, A Re X + i A Im
    X), then feast_general on the complex stencil of phase 12 at P = p_gen
    (the complex128 entry through dia_matvec_any)."""
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.ops import dia as D
    out = {}
    nx = 2 ** p_real
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx), 50)
    M0 = int(-(-int(len(exp) * 1.3) // 8) * 8)
    op = dia_operator(lap2d(nx), np.float64, D.dia_matvec_f64)
    fpm = ft.feastinit()
    fpm[3] = 8
    for solver in ("gmres", "bicgstab"):
        label = f"matrix-free {solver} P={p_real}"
        with all_counts() as counts:
            r, s = _timed_call(lambda: ft.feast(op, None, (Emin, Emax), M0,
                                                fpm, solver=solver))
        print(f"   {label}: N={nx * nx}, {len(exp)} pairs, M0={M0}: "
              f"{s:.2f} s, inner solves converged {r.inner_converged}; "
              f"launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
        _check_result(r, exp, 1e-8, label)
        check(counts["dia_matvec_f64"] > 0 and all(
            v == 0 for n, v in counts.items() if n != "dia_matvec_f64"),
            f"{label}: the real entry carried every product, the complex "
            "blocks as two real calls")
        out[solver] = dict(N=nx * nx, pairs=len(exp), M0=M0, M=r.M,
                           loops=r.loop, seconds=s,
                           inner_converged=bool(r.inner_converged),
                           launches=counts["dia_matvec_f64"])
        del r
    A, lam = general_stencil(p_gen)
    Emid, rad, exp = general_circle(lam, 40)
    M0 = 56
    op = dia_operator(A, np.complex128)
    label = f"matrix-free feast_general P={p_gen}"
    with all_counts() as counts:
        r, s = _timed_call(lambda: ft.feast_general(op, None, Emid, rad, M0,
                                                    fpm))
    print(f"   {label}: N={A.shape[0]}, circle ({Emid.real:.6g}, {rad:.6g}) "
          f"holding {len(exp)}, M0={M0}: {s:.2f} s; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    err, res = _general_check(r, exp, 1e-7, 1e-8, label)
    check(counts["dia_matvec_c128"] > 0 and all(
        v == 0 for n, v in counts.items() if n != "dia_matvec_c128"),
        f"{label}: the complex128 entry carried every product")
    out["general"] = dict(N=A.shape[0], inside=len(exp), M0=M0, M=r.M,
                          loops=r.loop, seconds=s, eig_err=err, max_res=res,
                          launches=counts["dia_matvec_c128"])
    return out


def _matfree_polynomial_and_solver():
    """Leg 3: feast_polynomial(method="matfree") on config 5's polynomial
    coefficients as operators on the card; feast_matvec on config 2's
    pencil (float64) with the caller's solve_shifted (torch LU on the
    card)."""
    import scipy.linalg as sla
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.core.parameters import feast_tolerance
    out = {}
    coeffs, lam = general_config5_pep(512)
    Emid, r = -0.025 + 1.05j, 0.011
    exp = _in_circle(lam, Emid, r)
    ops = [ft.LinearOperator.from_matrix(torch.as_tensor(c, device="cuda"))
           for c in coeffs]
    tol32 = feast_tolerance(ft.feastdefault(ft.feastinit()), np.complex64)
    label = "config 5 feast_polynomial method=matfree n=512 complex64"
    res, s = _timed_call(lambda: ft.feast_polynomial(
        ops, Emid, r, 24, method="matfree"))
    print(f"   {label}: {s:.2f} s", flush=True)
    err, mres = _general_check(res, exp, 1e-5, tol32, label, rel=True)
    out["config5_pep_matfree"] = dict(M=res.M, loops=res.loop, seconds=s,
                                      eig_err=err, max_res=mres)
    A, B = (X.astype(np.float64) for X in dense_config2(2048))
    w = sla.eigh(A, B, eigvals_only=True)
    Emin, Emax = middle_interval(w, 24)
    exp = w[(w >= Emin) & (w <= Emax)]
    At, Bt = (torch.as_tensor(X, device="cuda") for X in (A, B))
    factorizations = []

    def solve_shifted(z, RHS):
        LU, piv = torch.linalg.lu_factor(z * Bt.to(RHS.dtype)
                                         - At.to(RHS.dtype))
        factorizations.append(z)
        return torch.linalg.lu_solve(LU, piv, RHS)

    fpm = ft.feastinit()
    fpm[2] = 16
    label = "config 2 pencil (float64) feast_matvec with solve_shifted"
    r, s = _timed_call(lambda: ft.feast_matvec(
        ft.LinearOperator.from_matrix(At, symmetric=True),
        ft.LinearOperator.from_matrix(Bt, symmetric=True), (Emin, Emax), 32,
        fpm, solve_shifted=solve_shifted))
    print(f"   {label}: {s:.3f} s, {len(factorizations)} factorizations",
          flush=True)
    _check_result(r, exp, 1e-10, label)
    out["config2_solve_shifted"] = dict(M=r.M, loops=r.loop, seconds=s,
                                        factorizations=len(factorizations))
    return out


def _rci_drive(state, A, B):
    """Service an RCI machine's jobs on the card: torch LU of (Ze B - A)
    at FACTORIZE, lu_solve (adjoint for SOLVE_TRANSPOSE), dense products.
    Returns the number of jobs."""
    import torch
    from feastkit_tpu_torch.core.types import FeastRCIJob as Job
    factor = None
    jobs = 0
    job = state.step()
    while job != Job.DONE:
        jobs += 1
        check(jobs < 100000, "the RCI machine finishes")
        if job == Job.FACTORIZE:
            factor = torch.linalg.lu_factor(state.Ze * B - A)
        elif job in (Job.SOLVE, Job.SOLVE_TRANSPOSE):
            state.workc = torch.linalg.lu_solve(
                *factor, state.workc, adjoint=job == Job.SOLVE_TRANSPOSE)
        elif job == Job.MULT_A:
            state.workc = A @ state.workc
        elif job == Job.MULT_B:
            state.workc = B @ state.workc
        job = state.step()
    return jobs


def _match_check(got, want, bar, label):
    err = _match_err(got, want)
    check(err <= bar, f"{label}: eigenvalues within {bar:g} of the port's "
          f"driver on the card ({err:.3e})")
    return err


def _rci_legs():
    """Leg 4: FeastSRCI on config 2's pencil (float64, n = 2048, 16 nodes,
    M0 = 32) and FeastGRCI on config 5's dense general matrix (complex128,
    n = 1024, M0 = 24), serviced on the card with torch LU, against the
    port's feast_sygv / feast_general on the same data on the card."""
    import torch
    import feastkit_tpu_torch as ft
    import scipy.linalg as sla
    out = {}
    A, B = (X.astype(np.float64) for X in dense_config2(2048))
    w = sla.eigh(A, B, eigvals_only=True)
    Emin, Emax = middle_interval(w, 24)
    fpm = ft.feastinit()
    fpm[2] = 16
    Ac, Bc = (torch.as_tensor(X, device="cuda").to(torch.complex128)
              for X in (A, B))
    st = ft.FeastSRCI(A.shape[0], 32, Emin, Emax, fpm)
    jobs, s = _timed_call(lambda: _rci_drive(st, Ac, Bc))
    ref, s_ref = _timed_call(lambda: ft.feast_sygv(A, B, Emin, Emax, 32,
                                                   fpm))
    lam = st.lam[st.inside]
    print(f"   FeastSRCI config 2 (float64): {jobs} jobs, {st.loop} loops, "
          f"M={st.M} info={int(st.info)}, {s:.3f} s; feast_sygv {s_ref:.3f}"
          f" s, M={ref.M}", flush=True)
    check(st.M == ref.M == 24 and int(st.info) == 0,
          "FeastSRCI: M = 24, info 0, as feast_sygv")
    err = _match_check(lam, ref.lam, 1e-10, "FeastSRCI")
    check(isinstance(st.q, torch.Tensor) and st.q.is_cuda,
          "FeastSRCI: the Ritz vectors on the card")
    out["srci_config2"] = dict(jobs=jobs, loops=st.loop, M=st.M, seconds=s,
                               driver_s=s_ref, eig_err=err)
    Ag, d = general_config5_dense(1024)
    Ag = Ag.astype(np.complex128)
    exp = _in_circle(d, 0.0, 0.016)
    At = torch.as_tensor(Ag, device="cuda")
    st = ft.FeastGRCI(Ag.shape[0], 24, 0.0, 0.016)
    jobs, s = _timed_call(lambda: _rci_drive(
        st, At, torch.eye(Ag.shape[0], dtype=At.dtype, device="cuda")))
    ref, s_ref = _timed_call(lambda: ft.feast_general(Ag, None, 0.0, 0.016,
                                                      24))
    lam = st.lam[st.inside]
    print(f"   FeastGRCI config 5 (complex128): {jobs} jobs, {st.loop} "
          f"loops, M={st.M} info={int(st.info)}, {s:.3f} s; feast_general "
          f"{s_ref:.3f} s, M={ref.M}", flush=True)
    check(st.M == ref.M == len(exp) and int(st.info) == 0,
          f"FeastGRCI: M = {len(exp)}, info 0, as feast_general")
    err = _match_check(lam, ref.lam, 1e-7, "FeastGRCI")
    _match_check(lam, exp, 1e-7, "FeastGRCI against the diagonal")
    out["grci_config5"] = dict(jobs=jobs, loops=st.loop, M=st.M, seconds=s,
                               driver_s=s_ref, eig_err=err)
    return out


def phase_matfree(dia_rr, staged=True, p=10, p_krylov=MATFREE_P_REAL):
    """Phase 13: the matrix-free drivers and the RCI step machines through
    the entry points on the card (``staged``: leg 1's staged warm solve
    too; ``p``: leg 1's size, 9 in the default run; ``p_krylov``: leg 2's,
    5 in the default run)."""
    print(f"== 13. the matrix-free drivers and the RCI step machines: "
          f"feast on a DIA-kernel operator at P={p}, the matrix-free Krylov "
          "engine, feast_polynomial by operators, a caller's solver, "
          "FeastSRCI / FeastGRCI", flush=True)
    out = {f"matfree_p{p}": _matfree_p10(dia_rr, staged, p)}
    out["krylov"] = _matfree_krylov(p_krylov, p_krylov)
    out.update(_matfree_polynomial_and_solver())
    out.update(_rci_legs())
    return out


# -- phase 14: the public surface -------------------------------------------

@contextlib.contextmanager
def _seeded_draws():
    """Count the draws of the seeded subspace made inside the block, in the
    dict it yields: on the host (``core/tools.seeded_subspace``) under
    "draws", on the card (``ops/seeded_draw``'s launches) under
    "card_launches"."""
    from feastkit_tpu_torch.core import tools
    from feastkit_tpu_torch.ops import seeded_draw as sd
    orig = tools.seeded_subspace
    seen = {"draws": 0}

    def counted(*a, **k):
        seen["draws"] += 1
        return orig(*a, **k)
    tools.seeded_subspace = counted
    before = sd.seeded_draw_f64.launches
    try:
        yield seen
    finally:
        tools.seeded_subspace = orig
        seen["card_launches"] = sd.seeded_draw_f64.launches - before


@contextlib.contextmanager
def unfused_series():
    """Record the series length (and rung) of every application of the
    unfused recurrence (``solvers/sparse._sparse_cheb_filter_host``)."""
    from feastkit_tpu_torch.solvers import sparse
    orig = sparse._sparse_cheb_filter_host
    seen = []

    def recorder(ctx, Q, *, rung, n_coeffs=None):
        seen.append((rung, len(ctx[rung]["coeffs"]), tuple(Q.shape)))
        return orig(ctx, Q, rung=rung, n_coeffs=n_coeffs)
    sparse._sparse_cheb_filter_host = recorder
    try:
        yield seen
    finally:
        sparse._sparse_cheb_filter_host = orig


@contextlib.contextmanager
def plain_dia_products():
    """The sparse engines' DIA products by the plain PyTorch version on
    the card tensors, called directly (no kernel launched)."""
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.solvers import sparse
    orig = sparse.dia_matvec_any
    sparse.dia_matvec_any = D.dia_matvec_plain
    try:
        yield
    finally:
        sparse.dia_matvec_any = orig


def _surface_p10(main=None):
    """Legs 1-3 of phase 14 on BASELINE.json config 4 at P=10: the FEAST
    name ``dfeast_scsrev``, a checkpoint and its resume, the stochastic
    count. ``main``: the main path's eigenvalues and launch counts (phase
    4), else this phase runs ``feast`` once, counted, for them."""
    import tempfile
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.ops import dia as D
    nx = 1024
    N = nx * nx
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = 72
    check(len(exp) == 52, "fixture: 52 pairs")
    fpm = ft.feastinit()
    fpm[3] = 8
    fpm[1] = 1
    out = {}
    if main is None:
        r, s, counts, _ = _counted_solve(A, None, Emin, Emax, M0, fpm,
                                         "P=10 feast (for comparison)")
        _check_result(r, exp, 1e-8, "P=10 feast")
        main = dict(lam=np.sort(r.lam), counts=counts)
        del r

    # leg 1: the FEAST-named alias on the main path
    def alias(A_, B_, lo, hi, m0, f):
        return ft.dfeast_scsrev(A_, lo, hi, m0, f)
    r1, leg1_s, counts, _ = _counted_solve(A, None, Emin, Emax, M0, fpm,
                                           "leg 1: dfeast_scsrev",
                                           solve=alias)
    _check_result(r1, exp, 1e-8, "leg 1: dfeast_scsrev")
    path = {n: counts[n] for n in MAIN_PATH_KERNELS}
    check(path == {n: main["counts"][n] for n in MAIN_PATH_KERNELS},
          f"leg 1: launches {path} equal the main path's")
    lam_diff = float(np.abs(np.sort(r1.lam) - main["lam"]).max())
    print(f"   leg 1: {leg1_s:.2f} s, loops {r1.loop}; eigenvalues against "
          f"the main path's feast call {lam_diff:.3e}", flush=True)
    check(lam_diff <= 1e-12, "leg 1: eigenvalues within 1e-12 of feast's")
    out["alias_p10"] = dict(seconds=leg1_s, loops=r1.loop, launches=path,
                            lam_vs_feast=lam_diff, eig_err=float(np.abs(
                                np.sort(r1.lam) - exp).max()),
                            max_res=float(r1.res.max()))

    # leg 2: checkpoint and resume
    with tempfile.TemporaryDirectory() as where:
        ck_path = os.path.join(where, "p10.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ft.save_checkpoint(ck_path, r1, fpm, (Emin, Emax))
        save_s = time.perf_counter() - t0
        size = os.path.getsize(ck_path)
        t0 = time.perf_counter()
        ck = ft.load_checkpoint(ck_path)
        load_s = time.perf_counter() - t0
    check(ck.Q.shape == (N, M0) and ck.loop == r1.loop,
          "leg 2: the checkpoint holds the (N, M0) basis and the loops")
    lam1 = np.sort(r1.lam)
    loops1 = r1.loop
    del r1
    torch.cuda.empty_cache()
    with _seeded_draws() as draws:
        r2, resume_s = _run_feast(A, None, Emin, Emax, M0, fpm,
                                  lambda A_, B_, lo, hi, m0, f: ft.feast(
                                      A_, B_, (lo, hi), m0,
                                      **ft.resume_kwargs(ck)))
    del ck
    _check_result(r2, exp, 1e-8, "leg 2: resume")
    resume_diff = float(np.abs(np.sort(r2.lam) - lam1).max())
    print(f"   leg 2: checkpoint {size / 1e6:.1f} MB, saved in {save_s:.2f} s "
          f"(warm page cache), loaded in {load_s:.2f} s; resume {resume_s:.2f} "
          f"s, {r2.loop} loops against leg 1's {leg1_s:.2f} s, {loops1} "
          f"loops; seeded draws {draws['draws']} on the host, "
          f"{draws['card_launches']} launches on the card; eigenvalues "
          f"against leg 1 {resume_diff:.3e}", flush=True)
    check(draws["draws"] == 0 and draws["card_launches"] == 0,
          "leg 2: the resume draws no seeded Q0, on the host or the card")
    check(r2.M == 52 and resume_diff <= 1e-10,
          "leg 2: the same M, eigenvalues within 1e-10 of leg 1")
    check(r2.loop <= loops1, "leg 2: no more loops than leg 1")
    out["resume_p10"] = dict(bytes=size, save_s=save_s, load_s=load_s,
                             seconds=resume_s, loops=r2.loop,
                             leg1_loops=loops1, lam_vs_leg1=resume_diff)
    del r2
    torch.cuda.empty_cache()

    # leg 3: the stochastic count fpm[14] = 2 (fpm[32] = 10 probes)
    fc = fpm.copy()
    fc[14] = 2
    with unfused_series() as series, all_counts() as counts:
        rc, count_s = _run_feast(A, None, Emin, Emax, M0, fc)
    check(len(series) == 1 and series[0][2] == (N, 10),
          f"leg 3: one application of the unfused recurrence on the "
          f"(N, 10) probes ({series})")
    degree = series[0][1] - 1
    est = float(rc.epsout)
    print(f"   leg 3: count {est:.6f} (M = {rc.M}) in {count_s:.2f} s, "
          f"degree {degree}, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    check(rc.lam.size == 0 and tuple(rc.q.shape) == (N, 0) and rc.q.is_cuda
          and rc.loop == 1 and int(rc.info) == 0, "leg 3: a count-only "
          "result on the card")
    check(abs(est - 52) <= 5 * np.sqrt(2 * 52 / 10),
          "leg 3: |est - 52| <= 5 sqrt(2 x 52 / 10)")
    check(counts["dia_matvec_f64"] == degree, f"leg 3: dia_matvec_f64 "
          f"launches {counts['dia_matvec_f64']} equal the series' products "
          f"{degree} (Gershgorin bounds on the host)")
    check(all(v == 0 for n, v in counts.items() if n != "dia_matvec_f64"),
          "leg 3: no other kernel launched")
    with plain_dia_products(), all_counts() as plain_counts:
        rp, plain_s = _run_feast(A, None, Emin, Emax, M0, fc)
    rel = abs(est - float(rp.epsout)) / abs(float(rp.epsout))
    print(f"   leg 3: the same filter and probes with the plain DIA product "
          f"on the card: {float(rp.epsout):.6f} in {plain_s:.2f} s, "
          f"relative {rel:.3e}", flush=True)
    check(sum(plain_counts.values()) == 0,
          "leg 3: the plain run launched no kernel")
    check(rel <= 1e-9, "leg 3: the kernel's count within 1e-9 of the "
          "plain product's")
    out["count_p10"] = dict(estimate=est, M=rc.M, seconds=count_s,
                            degree=degree, launches=counts["dia_matvec_f64"],
                            plain_estimate=float(rp.epsout),
                            plain_seconds=plain_s, relative=rel)
    del rc, rp
    torch.cuda.empty_cache()
    return out


def _match_same(got, want, label, tol=1e-12):
    got, want = np.sort_complex(np.asarray(got)), np.sort_complex(
        np.asarray(want))
    err = float(np.abs(got - want).max()) if len(got) == len(want) > 0 \
        else np.inf
    print(f"   {label}: M = {len(got)}, against the generic driver "
          f"{err:.3e}", flush=True)
    check(len(got) == len(want) > 0 and err <= tol,
          f"{label}: the generic driver's eigenvalues within {tol:g}")
    return err


def _surface_small():
    """Leg 4: one FEAST name of each family on the card against the port's
    own generic driver on the same operands, eigvals_feast, and a
    torch.profiler trace of one small sparse solve."""
    import json
    import tempfile
    import scipy.sparse as sp
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.solvers import sparse
    out = {}
    rng = np.random.default_rng(14)
    n = 200
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    T40 = T[:40, :40].tocsr()     # the Krylov engine's host-bound loop
    H = T.toarray() + 1j * (np.eye(n, k=1) - np.eye(n, k=-1)) * 0.1
    G = np.diag(np.arange(1.0, n + 1)) + 0.01 * rng.standard_normal((n, n))
    S = (G + G.T) / 2 + 0.01j * np.eye(n)
    bands = np.stack([np.r_[np.diag(T.toarray(), 1), 0.0],
                      np.diag(T.toarray()),
                      np.r_[0.0, np.diag(T.toarray(), -1)]])
    K = [np.diag(np.arange(1.0, 11.0)), 0.1 * np.eye(10), np.eye(10)]
    c = ft.feast_contour(0.5, 1.5, ft.feastinit())
    legs = (
        ("zfeast_heev", lambda: ft.zfeast_heev(H, 0.5, 1.5, 60),
         lambda: ft.feast_heev(H.astype(np.complex128), 0.5, 1.5, 60)),
        ("dfeast_sbev", lambda: ft.dfeast_sbev(bands, 1, 1, 0.5, 1.5, 60),
         lambda: ft.feast_sbev(bands, 1, 1, 0.5, 1.5, 60)),
        ("cfeast_geev", lambda: ft.cfeast_geev(G, 10.0, 2.5, 10),
         lambda: ft.feast_geev(G.astype(np.complex64), 10.0, 2.5, 10)),
        ("zfeast_syev", lambda: ft.zfeast_syev(S, 10.0, 2.5, 10),
         lambda: ft.feast_geev_complex_sym(S, 10.0, 2.5, 10)),
        ("zfeast_gepev", lambda: ft.zfeast_gepev(K, 2.0j, 1.0, 8),
         lambda: ft.feast_pep([k.astype(complex) for k in K], 2.0j, 1.0,
                              8)),
        ("difeast_scsrev", lambda: ft.difeast_scsrev(T40, 0.5, 1.5, 12),
         lambda: sparse.sparse_feast_interval(T40, None, 0.5, 1.5, 12,
                                              hermitian=False,
                                              solver="gmres")),
        ("dfeast_syevx", lambda: ft.dfeast_syevx(T.toarray(), 0.5, 1.5, 60,
                                                 c.Zne, c.Wne),
         lambda: ft.feast_syev(T.toarray(), 0.5, 1.5, 60, contour=c)),
        ("eigvals_feast", lambda: ft.eigvals_feast(T.toarray(), (0.5, 1.5),
                                                   M0=60),
         lambda: ft.feast(T.toarray(), None, (0.5, 1.5), 60)),
    )
    for label, alias, generic in legs:
        t0 = time.perf_counter()
        got = alias()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        want = generic()
        lam = got if isinstance(got, np.ndarray) else got.lam
        if not isinstance(got, np.ndarray):
            check(got.q.is_cuda, f"{label}: eigenvectors on the card")
        out[label] = dict(seconds=seconds, err=_match_same(lam, want.lam,
                                                           label))
    # the RCI machine serviced with torch LU on the card
    Td = torch.as_tensor(T.toarray(), device="cuda").to(torch.complex128)
    st = ft.feast_srci(n, 60, 0.5, 1.5)
    _rci_drive(st, Td, torch.eye(n, dtype=Td.dtype, device="cuda"))
    want = ft.feast_syev(T.toarray(), 0.5, 1.5, 60)
    out["feast_srci"] = dict(err=_match_same(
        st.lam[st.inside], want.lam, "feast_srci", 1e-10))
    # a torch.profiler trace of one small polynomial solve
    A = lap2d(64)
    Emin, Emax, _ = interval_lowest(lap2d_eigs(64))
    with tempfile.TemporaryDirectory() as where:
        with ft.trace_to(where) as prof:
            ft.feast(A, None, (Emin, Emax), 72)
        with open(os.path.join(where, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {}
    for e in kernels:
        # "void (anonymous namespace)::cheb_stream_kernel<...>(...)" ->
        # "cheb_stream_kernel"
        key = e["name"].removeprefix("void ").replace(
            "(anonymous namespace)::", "").split("<")[0].split("(")[0]
        names[key] = names.get(key, 0.0) + e.get("dur", 0.0)
    starts = [e["ts"] for e in events if "ts" in e and "dur" in e]
    ends = [e["ts"] + e["dur"] for e in events if "ts" in e and "dur" in e]
    span_us = max(ends) - min(starts)
    busy_us = sum(e.get("dur", 0.0) for e in kernels)
    device_us = sum(getattr(k, "self_device_time_total", 0.0)
                    for k in prof.key_averages())
    top = dict(sorted(names.items(), key=lambda kv: -kv[1])[:8])
    print(f"   trace: {len(kernels)} kernel events, kernel time "
          f"{busy_us / 1e3:.3f} ms of a {span_us / 1e3:.3f} ms window "
          f"({busy_us / span_us:.1%} busy), key_averages device time "
          f"{device_us / 1e3:.3f} ms; by kernel (us) "
          f"{ {k: round(v, 1) for k, v in top.items()} }", flush=True)
    check(any(("cheb" in k or "dia_" in k) for k in names),
          "trace: the CUDA events name a Chebyshev or DIA kernel")
    out["trace"] = dict(kernel_events=len(kernels), busy_ms=busy_us / 1e3,
                        window_ms=span_us / 1e3, device_ms=device_us / 1e3,
                        top_kernels_us=top)
    return out


def phase_surface(main=None):
    """Phase 14: the public surface on the card: legs 1-3 at P=10
    (``_surface_p10``), leg 4 on small problems (``_surface_small``)."""
    print("== 14. the public surface: dfeast_scsrev, a checkpoint resume and "
          "the stochastic count at P=10; one FEAST name of each family, "
          "eigvals_feast, a torch.profiler trace", flush=True)
    t0 = time.perf_counter()
    out = _surface_p10(main)
    out["small"] = _surface_small()
    out["seconds"] = time.perf_counter() - t0
    print(f"   phase 14: {out['seconds']:.1f} s", flush=True)
    return out


# -- phase 15: the sharded drivers ------------------------------------------

SHARDED_RANKS = 2
SHARDED_TIME_LIMIT_S = 900


def _gloo_on_cuda(torch, dist):
    """Every all-reduce the sharded drivers make, on a tiny CUDA tensor
    through gloo before anything is built on it: SUM in float32 / float64
    / complex64 / complex128 / int32, MAX and MIN in int32 and float64.
    A call that refuses a CUDA tensor raises here (nothing is staged
    through the host around it)."""
    rank = dist.get_rank()
    done = []
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128, torch.int32):
        ops = ("SUM",) if dtype.is_complex or dtype == torch.float32 \
            else ("SUM", "MAX", "MIN")
        for op in ops:
            t = torch.full((3,), rank + 1, dtype=dtype, device="cuda")
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
            want = {"SUM": SHARDED_RANKS * (SHARDED_RANKS + 1) // 2,
                    "MAX": SHARDED_RANKS, "MIN": 1}[op]
            check(t.is_cuda and bool((t == want).all()),
                  f"gloo all_reduce {op} on a CUDA {dtype} tensor")
            done.append(f"{op} {str(dtype).replace('torch.', '')}")
    return done


def _sharded_leg(label, solve, rank, dist, torch):
    """``solve()`` on every rank, started together (a barrier), with the
    DIA and Chebyshev kernels' launch counts set to 0 just before and read
    just after; (result, seconds, counts)."""
    torch.cuda.synchronize()
    dist.barrier()
    with all_counts() as counts:
        t0 = time.perf_counter()
        r = solve()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    print(f"   rank {rank} {label}: {seconds:.2f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return r, seconds, dict(counts)


def _sharded_rank(rank, store, path):
    """One rank of phase 15's world (``--sharded-rank``): gloo on the one
    card, the five legs, its results to ``path`` (JSON)."""
    from datetime import timedelta
    import scipy.linalg as sla
    import torch
    import torch.distributed as dist
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.core.parameters import feast_tolerance
    from feastkit_tpu_torch.parallel import pfeast as pf
    from feastkit_tpu_torch.solvers.sparse import krylov_dia_launches
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=SHARDED_RANKS,
                            timeout=timedelta(seconds=600))
    out = {"gloo_cuda": _gloo_on_cuda(torch, dist)}

    # leg 1: the main path, its columns over the ranks (config 4 at P=10)
    nx = 1024
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = 72
    fpm = ft.feastinit()
    fpm[3] = 8
    mesh = pf.contour_mesh(SHARDED_RANKS)
    with recorded_applications() as seen:
        r, seconds, counts = _sharded_leg(
            "leg 1 (pfeast_sparse solver='cheb', P=10, M0 = 72 over 2 "
            "ranks)", lambda: pf.pfeast_sparse(
                A, None, Emin, Emax, M0, fpm, solver="cheb", mesh=mesh),
            rank, dist, torch)
    _check_result(r, exp, 1e-8, f"rank {rank} leg 1")
    check(len(exp) == 52, "leg 1: 52 pairs")
    want = expected_launches(seen["applications"], seen["steps"])
    check({n: counts[n] for n in want} == want,
          f"rank {rank} leg 1: launches follow the schedule {want}")
    for name in MAIN_PATH_KERNELS:
        check(counts[name] > 0, f"rank {rank} leg 1: {name} launched")
    out["main_cheb_p10"] = dict(
        seconds=seconds, M=r.M, loops=r.loop,
        eig_err=float(np.abs(np.sort(r.lam) - exp).max()),
        max_res=float(r.res.max()), lam=np.sort(r.lam).tolist(),
        columns=M0 // SHARDED_RANKS, steps=seen["steps"],
        applications=seen["applications"],
        launches={n: counts[n] for n in MAIN_PATH_KERNELS})
    del r
    torch.cuda.empty_cache()

    # legs 2 and 5: the contour-sharded Krylov engine at P=7 and its count
    nx = 128
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = int(-(-int(len(exp) * 1.3) // 8) * 8)
    kw = dict(solver="gmres", solver_maxiter=250, mesh=mesh)
    r, seconds, counts = _sharded_leg(
        f"leg 2 (pfeast_sparse solver='gmres', P=7, contour over 2 ranks)",
        lambda: pf.pfeast_sparse(A, None, Emin, Emax, M0, fpm, **kw), rank,
        dist, torch)
    _check_result(r, exp, 1e-8, f"rank {rank} leg 2")
    check(r.krylov["precond"] == "mg", "leg 2: multigrid")
    dia = {n: counts[n] for n in DIA_KERNELS}
    check(dia == krylov_dia_launches(r.krylov),
          f"rank {rank} leg 2: DIA launches follow the Krylov record")
    out["krylov_contour_p7"] = dict(
        seconds=seconds, M=r.M, loops=r.loop, N=nx * nx, M0=M0,
        eig_err=float(np.abs(np.sort(r.lam) - exp).max()),
        max_res=float(r.res.max()), mg_levels=r.krylov["mg_levels"],
        launches=dia)
    M2 = r.M
    del r
    fpm_e = ft.feastinit()
    fpm_e[3] = 8
    fpm_e[14] = 2
    r, seconds, counts = _sharded_leg(
        "leg 5 (fpm[14]=2 through the contour-sharded filter, P=7)",
        lambda: pf.pfeast_sparse(A, None, Emin, Emax, M0, fpm_e, **kw),
        rank, dist, torch)
    bar = 5.0 * np.sqrt(2.0 * M2 / 10)
    print(f"   rank {rank} leg 5: estimate {r.epsout:.4f} against M = {M2} "
          f"(bar {bar:.2f})", flush=True)
    check(abs(r.epsout - M2) <= bar and r.lam.size == 0,
          f"rank {rank} leg 5: the count within 5 sqrt(2M/10) of M")
    out["count_contour_p7"] = dict(
        seconds=seconds, estimate=float(r.epsout), M=int(r.M), bar=bar,
        launches={n: counts[n] for n in DIA_KERNELS})
    del r

    # leg 3: the model axis splits the rows (P=6)
    nx = 64
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    M0 = int(-(-int(len(exp) * 1.3) // 8) * 8)
    mmesh = pf.contour_model_mesh(1, SHARDED_RANKS)
    r, seconds, counts = _sharded_leg(
        "leg 3 (pfeast_sparse solver='gmres', P=6, rows over 2 ranks)",
        lambda: pf.pfeast_sparse(A, None, Emin, Emax, M0, fpm,
                                 solver="gmres", solver_maxiter=250,
                                 mesh=mmesh), rank, dist, torch)
    _check_result(r, exp, 1e-8, f"rank {rank} leg 3")
    check(r.krylov["precond"] == "mg", "leg 3: multigrid (rows gathered)")
    dia = {n: counts[n] for n in DIA_KERNELS}
    check(dia == krylov_dia_launches(r.krylov),
          f"rank {rank} leg 3: DIA launches (the extended blocks) follow "
          "the Krylov record")
    out["krylov_model_p6"] = dict(
        seconds=seconds, M=r.M, loops=r.loop, N=nx * nx, M0=M0,
        rows=nx * nx // SHARDED_RANKS,
        eig_err=float(np.abs(np.sort(r.lam) - exp).max()),
        max_res=float(r.res.max()), launches=dia)
    del r

    # leg 4: dense config 2 on a 1 x 2 contour x rhs mesh
    A, B = dense_config2(2048)
    w = sla.eigh(A.astype(np.float64), B.astype(np.float64),
                 eigvals_only=True)
    Emin, Emax = middle_interval(w, 24)
    exp = w[(w >= Emin) & (w <= Emax)]
    fpm_d = ft.feastinit()
    fpm_d[2] = 16
    r, seconds, _ = _sharded_leg(
        "leg 4 (pfeast_dense f32 n=2048, contour x rhs 1 x 2)",
        lambda: pf.pfeast_dense(A, B, Emin, Emax, 32, fpm_d,
                                hermitian=False,
                                mesh=pf.contour_rhs_mesh(1, SHARDED_RANKS)),
        rank, dist, torch)
    err = float((np.abs(np.sort(r.lam) - exp)
                 / np.maximum(1.0, np.abs(exp))).max()) \
        if r.M == len(exp) else float("inf")
    tol = feast_tolerance(ft.feastdefault(ft.feastinit()), np.float32)
    print(f"   rank {rank} leg 4: M={r.M} error {err:.3e} max residual "
          f"{float(r.res.max()):.3e} (tol {tol:.2e})", flush=True)
    check(r.M == 24 == len(exp), f"rank {rank} leg 4: M = 24")
    check(err <= 1e-5, f"rank {rank} leg 4: eigenvalues within 1e-5")
    check(float(r.res.max()) <= tol and int(r.info) == 0,
          f"rank {rank} leg 4: residuals <= tol, info 0")
    out["dense_config2"] = dict(seconds=seconds, M=r.M, eig_err=err,
                                max_res=float(r.res.max()))
    with open(path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_sharded(main=None):
    """Phase 15: the sharded drivers on the card. Two ranks of a gloo
    world (the ``spawn`` start method's fresh processes: this script with
    ``--sharded-rank``), both on cuda:0, run the legs of
    ``_sharded_rank``; a rank that fails stops the phase. ``main``: phase
    4's serial P=10 solve (its eigenvalues and launches), else this phase
    runs one. Then the stencil convolution (FEAST_STENCIL_CONV=1) against
    the shifted adds at the P=8 Krylov leg's grid, float32."""
    import tempfile
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.ops.multigrid import apply_stencil
    print("== 15. the sharded drivers: two ranks on the one card (gloo); "
          "the column-sharded main path at P=10, the contour- and "
          "model-sharded Krylov engine, dense config 2, the count",
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    nx = 1024
    A = lap2d(nx)
    Emin, Emax, exp = interval_lowest(lap2d_eigs(nx))
    if main is None:
        fpm = ft.feastinit()
        fpm[3] = 8
        r, serial_s, counts, _ = _counted_solve(A, None, Emin, Emax, 72, fpm,
                                                "P=10 serial")
        _check_result(r, exp, 1e-8, "P=10 serial")
        main = dict(lam=np.sort(r.lam), counts=counts)
        del r
    gc.collect()
    torch.cuda.empty_cache()
    where = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    paths = [os.path.join(where, f"rank{r}.json")
             for r in range(SHARDED_RANKS)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sharded-rank", str(r),
                               os.path.join(where, "store"), paths[r]])
             for r in range(SHARDED_RANKS)]
    try:
        deadline = time.monotonic() + SHARDED_TIME_LIMIT_S
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            check(not failed, "every rank of phase 15 ran to its end")
            check(time.monotonic() < deadline,
                  f"phase 15 within {SHARDED_TIME_LIMIT_S} s")
            time.sleep(0.5)
        check(all(p.returncode == 0 for p in procs),
              "every rank of phase 15 ran to its end")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    world_s = time.perf_counter() - t0
    ranks = []
    for p in paths:
        with open(p) as f:
            ranks.append(json.load(f))
    lam = [np.asarray(r["main_cheb_p10"].pop("lam")) for r in ranks]
    check(all(np.array_equal(x, lam[0]) for x in lam),
          "leg 1: every rank returns the same eigenvalues")
    delta = float(np.abs(lam[0] - main["lam"]).max())
    bits = bool(np.array_equal(lam[0], main["lam"]))
    print(f"   leg 1 against the serial solve: max |difference| {delta:.3e}"
          f", equal to the bit: {bits}", flush=True)
    check(delta <= 1e-12, "leg 1: eigenvalues within 1e-12 of the serial "
          "solve's")
    for r in ranks:
        got = r["main_cheb_p10"]["launches"]
        check(got == {n: main["counts"][n] for n in MAIN_PATH_KERNELS},
              f"leg 1: each rank's launches {got} equal the serial "
              "schedule's")
    for leg in ("main_cheb_p10", "krylov_contour_p7", "count_contour_p7",
                "krylov_model_p6", "dense_config2"):
        secs = [round(r[leg]["seconds"], 3) for r in ranks]
        print(f"   {leg}: {secs} s on ranks 0 and 1 ({smi}; two ranks "
              "share one card, so no speed-up can be read from it)",
              flush=True)
    print(f"   the world: {world_s:.1f} s with its start-up ({smi})",
          flush=True)
    # the stencil as one convolution on the card (FEAST_STENCIL_CONV=1)
    disps = np.asarray([[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1]])
    coeffs = [4.0, -1.0, -1.0, -1.0, -1.0]
    x = torch.randn((72, 256, 256), generator=torch.Generator().manual_seed(
        15)).cuda()
    with switches(FEAST_STENCIL_CONV=None):
        shifted = apply_stencil(x, disps, coeffs, (256, 256))
    with switches(FEAST_STENCIL_CONV="1"):
        conv = apply_stencil(x, disps, coeffs, (256, 256))
        conv_ms = cuda_time_ms(lambda: apply_stencil(x, disps, coeffs,
                                                     (256, 256)), 20)
    shifted_ms = cuda_time_ms(lambda: apply_stencil(x, disps, coeffs,
                                                    (256, 256)), 20)
    err = float((conv - shifted).abs().max())
    print(f"   FEAST_STENCIL_CONV=1 at the P=8 grid (72 x 256 x 256 f32): "
          f"{conv_ms:.4f} ms a product against {shifted_ms:.4f} ms by "
          f"shifted adds, max |difference| {err:.3e} ({smi})", flush=True)
    check(err <= 8 * 1.2e-7 * 5 * float(shifted.abs().max()),
          "the stencil convolution agrees with the shifted adds within "
          "float32 rounding")
    legs = {leg: [r[leg] for r in ranks] for leg in ranks[0]
            if leg != "gloo_cuda"}
    return dict(ranks=SHARDED_RANKS, world_s=world_s, gloo_cuda=ranks[0][
        "gloo_cuda"], serial_delta=delta, serial_bits=bits, legs=legs,
        stencil_conv=dict(ms=conv_ms, shifted_ms=shifted_ms, max_err=err))


def sharded_launches(sharded):
    """Each kernel's launches on every rank, per leg of phase 15 (the
    ``sharded`` object of its row in the kernels line)."""
    out = {}
    for leg, per_rank in sharded["legs"].items():
        for rank, r in enumerate(per_rank):
            for name, n in r.get("launches", {}).items():
                if n:
                    row = out.setdefault(name, {})
                    row.setdefault(leg, [0] * sharded["ranks"])[rank] = n
    return out


def torch_tensor(X, device):
    import torch
    return torch.as_tensor(X).to(device)


def direct_sweep(device="cuda", scale=1):
    """The BCR block sweep (``ops/banded.bcr_block``'s rule) and the dense
    factorization's batching: re-blocking plus factor, and one solve of
    the right-hand sides, for blocks minimal, 16, 32 and 64 at config 3's
    shape (n = 2048, kd = 4, complex64, 8 nodes, 16 columns) and the
    narrow-band leg's (n = 8192, kd = 2, complex64 and complex128, 24
    columns); config 3's whole solve under each block; and the (16, 2048,
    2048) batched LU against one factorization per node."""
    import torch
    import feastkit_tpu_torch as ft
    from feastkit_tpu_torch.core.contour import feast_contour
    from feastkit_tpu_torch.core.tools import lu_factor
    from feastkit_tpu_torch.ops import banded as OB
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    print("== direct sweep: BCR blocks and the dense LU's batching",
          flush=True)

    def med(fn, reps=5):
        fn()
        ts = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    out = {}
    z = torch.as_tensor(feast_contour(0.0, 1.0, ne=8).Zne)
    for n, kd, cdt, M in ((2048 // scale, 4, torch.complex64, 16),
                          (8192 // scale, 2, torch.complex64, 24),
                          (8192 // scale, 2, torch.complex128, 24)):
        bands = torch.as_tensor(narrow_band(True, n, kd)[1] if kd == 2
                                else banded_config3(n, kd)[0]).to(device)
        I = torch.zeros_like(bands)
        I[kd] = 1.0
        shifted = (z.to(device, cdt)[:, None, None] * I.to(cdt)[None]
                   - bands.to(cdt)[None])
        rhs = torch.randn(n, M, dtype=cdt, device=device)
        for b in sorted({max(kd, 1), 16, 32, 64}):
            def factor():
                D, L, U, bb, _ = OB.banded_to_blocktridiag(shifted, kd, kd,
                                                           block=b)
                return OB.bcr_factor(D, L, U), D.shape[-3] * bb
            (lv, rl, rp), npad = factor()

            def solve():
                r = torch.zeros(npad, M, dtype=cdt, device=device)
                r[:n] = rhs
                return OB.bcr_solve(lv, rl, rp, r.reshape(-1, b, M))
            key = f"n{n}_kd{kd}_{str(cdt)[6:]}_b{b}"
            out[key] = dict(levels=len(lv), factor_ms=med(factor),
                            solve_ms=med(solve))
            print(f"   {key}: {len(lv)} levels, re-block + factor "
                  f"{out[key]['factor_ms']:.3f} ms, solve "
                  f"{out[key]['solve_ms']:.3f} ms", flush=True)
    bands, iv, _ = banded_config3(2048 // scale)
    kw = {} if device == "cuda" else {"device": device}
    orig = OB.bcr_block
    try:
        for b in (4, 16, 32, 64):
            OB.bcr_block = lambda *a, _b=b: _b
            ms = med(lambda: ft.feast_banded(bands, 4, 4, iv, 16, **kw), 3)
            out[f"config3_solve_b{b}"] = ms
            print(f"   config 3 whole solve, block {b}: {ms:.2f} ms",
                  flush=True)
    finally:
        OB.bcr_block = orig
    nd = 2048 // scale
    for cdt in (torch.complex64, torch.complex128):
        S = torch.randn(16, nd, nd, dtype=cdt, device=device) \
            + nd * torch.eye(nd, dtype=cdt, device=device)
        batched = med(lambda: lu_factor(S), 3)
        looped = med(lambda: [torch.linalg.lu_factor(s) for s in S], 3)
        lu, piv = lu_factor(S)
        rhs = torch.randn(nd, 32, dtype=cdt, device=device)
        solve = med(lambda: torch.linalg.lu_solve(lu, piv, rhs), 5)
        name = str(cdt)[6:]
        out[f"dense_lu_{name}"] = dict(batched_ms=batched, looped_ms=looped,
                                       solve_ms=solve)
        print(f"   dense (16, {nd}, {nd}) {name}: batched LU {batched:.2f} "
              f"ms, one per node {looped:.2f} ms; (16, {nd}, 32) solve "
              f"{solve:.3f} ms", flush=True)
    return out


def main(argv):
    started = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if "--dia-times" in argv:       # a child of --dia-turns
        dia_times(argv[argv.index("--dia-times") + 1])
        return 0
    if "--sharded-rank" in argv:    # a rank of phase 15's world
        i = argv.index("--sharded-rank")
        _sharded_rank(int(argv[i + 1]), argv[i + 2], argv[i + 3])
        return 0
    import feastkit_tpu_torch  # noqa: F401  (fails outside the repo)
    quick = "--quick" in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    ptxas = phase_build()
    if "--dia-turns" in argv or "--dia-sweep" in argv:
        if "--dia-sweep" in argv:
            dia_sweep(smi.split(",")[0], ptxas["dia_matvec"])
        if "--dia-turns" in argv:
            dia_turns(argv[argv.index("--dia-turns") + 1])
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--stream-sweep" in argv:
        stream_sweep(smi.split(",")[0])
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--krylov-solve" in argv:
        krylov_scale(int(argv[argv.index("--krylov-solve") + 1]))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--hermitian" in argv:
        phase_dia_kernels(smi.split(",")[0], ptxas["dia_matvec"])
        print(json.dumps({"hermitian": phase_hermitian()}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--general" in argv:
        _, dia_other = phase_dia_kernels(smi.split(",")[0],
                                         ptxas["dia_matvec"])
        print(json.dumps({"general": phase_general(
            general_dia_rows(dia_other))}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--matfree" in argv:
        _, dia_other = phase_dia_kernels(smi.split(",")[0],
                                         ptxas["dia_matvec"])
        print(json.dumps({"matfree": phase_matfree(
            dia_other["rr_p10 dia_matvec_f64"])}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--sharded" in argv:
        phase_dia_kernels(smi.split(",")[0], ptxas["dia_matvec"])
        sharded = phase_sharded()
        print(json.dumps({"sharded": sharded,
                          "sharded_launches": sharded_launches(sharded)}),
              flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--surface" in argv:
        phase_dia_kernels(smi.split(",")[0], ptxas["dia_matvec"])
        print(json.dumps({"surface": phase_surface()}), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--direct" in argv or "--direct-sweep" in argv:
        out = {}
        if "--direct-sweep" in argv:
            out["sweep"] = direct_sweep()
        if "--direct" in argv:
            out["direct"] = phase_direct()
        print(json.dumps(out), flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    kernels = phase_kernels(smi.split(",")[0])
    kernels.update(phase_complex_kernels(smi.split(",")[0]))
    gen_kernels = phase_gen_kernels(smi.split(",")[0], ptxas["cheb_step_cm"])
    nd9 = {k: gen_kernels.pop(k) for k in list(gen_kernels)
           if k.endswith("_nd9")}
    kernels.update(gen_kernels)
    dia_kernels, dia_other = phase_dia_kernels(smi.split(",")[0],
                                               ptxas["dia_matvec"])
    dia_general = general_dia_rows(dia_other)
    rr_ms = phase_rayleigh_ritz()
    draw = phase_seeded_draw(smi.split(",")[0])
    counts = {name: None for name in (*KERNELS, *DIA_KERNELS)}
    seeded_launches = None
    form_counts = {}
    per_rank = {}
    if not quick:
        main_path = phase_main_path(kernels)
        main_lam = main_path.pop("lam")
        seeded_launches = main_path["seeded_launches"]
        p9 = phase_p9()
        # each kernel's launches on its own path: the main path for the
        # kernels it runs, the SPD-B path for the composite's own, the
        # Krylov path (phase 8) for the DIA matvec kernels
        ms9 = dict(kernels)
        ms9.update({k[:-4]: v["nd9"] for k, v in nd9.items()})
        spd_b = phase_consistent_mass(ms9)
        counts = dict(main_path["counts"])
        counts.update({n: spd_b["counts"][n] for n in SPD_B_KERNELS})
        form_counts = spd_b["form_counts"]
        print(json.dumps({"main_path": main_path, "p9": p9,
                          "spd_b": spd_b}), flush=True)
        # depth cut for time since phase 13 (PERF.md, Findings): the staged
        # warm solves of phases 8, 11 (leg 1), 12 (leg 1) and, since phase
        # 14, 13 (leg 1), and the permuted consistent-mass leg at P=7
        krylov = phase_krylov(dia_kernels, staged=False)
        gen_krylov = phase_gen_krylov()
        counts.update(krylov["launches"])
        print(json.dumps({"krylov": krylov, "gen_krylov": gen_krylov}),
              flush=True)
        print(json.dumps({"direct": phase_direct()}), flush=True)
        # the complex entries' own paths: the Hermitian polynomial leg for
        # the unbatched ones, the Hermitian Krylov leg for the batched ones
        herm = phase_hermitian(staged=False, p_mass=7)
        for name in ("dia_matvec_c64", "dia_matvec_c128", "cheb_step_c64",
                     "cheb_step_c128"):
            counts[name] = herm["hermitian_p10"]["launches"].get(name, 0)
        for name in ("dia_matvec_batched_c64", "dia_matvec_batched_c128"):
            counts[name] = herm["hermitian_krylov_p7"]["launches"][name]
        print(json.dumps({"hermitian": herm}), flush=True)
        general = phase_general(dia_general, staged=False)
        # the general leg's launches of the complex entries, beside their
        # times at its own shapes
        for name, row in dia_general.items():
            row["launches"] = general["general_p8"]["launches"].get(name, 0)
        print(json.dumps({"general": general}), flush=True)
        # depth cuts for time since phase 15: phase 13 leg 1 at P=9, leg
        # 2 at P=5 (--matfree keeps P=10 and P=6)
        matfree = phase_matfree(dia_other["rr_p10 dia_matvec_f64"],
                                staged=False, p=9, p_krylov=5)
        print(json.dumps({"matfree": matfree}), flush=True)
        surface = phase_surface(dict(lam=main_lam,
                                     counts=main_path["counts"]))
        print(json.dumps({"surface": surface}), flush=True)
        sharded = phase_sharded(dict(lam=main_lam,
                                     counts=main_path["counts"]))
        print(json.dumps({"sharded": sharded}), flush=True)
        per_rank = sharded_launches(sharded)
    rows = []
    copy_tbs = kernels.pop("copy_tbs")
    for name, k in kernels.items():
        steps, source, replaces = KERNELS[name]
        rows.append(dict(
            name=name, route="cuda",
            source=f"feastkit_tpu_torch/ops/csrc/{source}",
            replaces=replaces, launches=counts[name],
            max_abs_err=k["max_abs_err"], max_rel_err=k["max_rel_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k.get("library_ms"),
            steps_per_launch=steps, ms_per_step=k["ms_per_step"],
            csr_spmm_ms=k["csr_spmm_ms"]))
        if name in per_rank:  # phase 15: each rank's launches, per leg
            rows[-1]["sharded"] = per_rank[name]
        if "shapes" in k:     # the complex entries: ms at herm_p9's shape,
            # the launches phase 11 leg 1's, each shape's times beside
            rows[-1].update(shape=k["shape"], shapes=k["shapes"],
                            path="Hermitian P=10 (phase 11 leg 1)")
        if "forms" in k:      # the column-major entries: ms, bound of "bare"
            rows[-1].update(eager_ms=k["eager_ms"], plan=k["plan"], forms={
                f: dict(v, launches=form_counts.get(name, {}).get(f))
                for f, v in k["forms"].items()})
    for name, k in dia_kernels.items():
        rows.append(dict(
            name=name, route="cuda",
            source="feastkit_tpu_torch/ops/csrc/dia_matvec.cu",
            replaces=DIA_KERNELS[name][2], launches=counts[name],
            max_abs_err=k["max_abs_err"], max_rel_err=k["max_rel_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            steps_per_launch=0, ms_per_step=k["ms"], csr_spmm_ms=None,
            shape=k["shape"], eager_ms=k["eager_ms"], host_us=k["host_us"],
            body=k["body"], turns_ms=k["turns"],
            path=DIA_PATHS[name]))
        if name in per_rank:  # phase 15: each rank's launches, per leg
            rows[-1]["sharded"] = per_rank[name]
        if name in dia_general:
            # the general Krylov leg (phase 12, P=8) at its own shape
            g = dia_general[name]
            rows[-1]["general_p8"] = {key: g.get(key) for key in (
                "launches", "shape", "max_abs_err", "ms", "eager_ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name == "dia_matvec_f64" and not quick:
            # the matrix-free leg (phase 13, P=9 in this run): its
            # launches; phase 3c times the product at the P=10 shape only
            rows[-1]["matfree_p9"] = dict(
                shape=[matfree["matfree_p9"]["N"], 72],
                launches=matfree["matfree_p9"]["launches"])
            # the stochastic count at P=10 (phase 14 leg 3): its launches,
            # beside phase 3c's times at its (N, 10) shape
            g = dia_other["count_p10 dia_matvec_f64"]
            rows[-1]["count_p10"] = dict(
                {key: g.get(key) for key in (
                    "shape", "body", "turns", "max_abs_err", "ms",
                    "eager_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                launches=surface["count_p10"]["launches"])
    # the seeded draw: the main path's launches, phase 3d's times at its
    # shape and at the consistent-mass cell's
    main_draw, cmass_draw = draw[1048576], draw[65536]
    rows.append(dict(
        name="seeded_draw_f64", route="cuda",
        source="feastkit_tpu_torch/ops/csrc/seeded_draw.cu",
        replaces=None, launches=seeded_launches,
        max_abs_err=main_draw["max_abs_err"],
        max_rel_err=main_draw["max_rel_err"],
        ms=main_draw["ms"], plain_ms=main_draw["plain_ms"],
        bound_ms=main_draw["bound_ms"], bound_by=main_draw["bound_by"],
        library_ms=None, steps_per_launch=0, ms_per_step=main_draw["ms"],
        csr_spmm_ms=None, shape=main_draw["shape"],
        bits_differing=main_draw["bits_differing"], cmass_p8=cmass_draw))
    print(json.dumps({"rayleigh_ritz_ms": rr_ms, "copy_tbs": copy_tbs,
                      "multistep_nine_diagonals": nd9,
                      "two_step_p9": {n: kernels[n].pop("p9") for n in (
                          "cheb_step2_f32", "cheb_step2_f64")}}),
          flush=True)
    print(f"== the whole script: {time.perf_counter() - started:.1f} s "
          f"({smi})", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
