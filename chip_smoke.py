"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py           # every phase (about a few minutes)
    python3 chip_smoke.py --quick   # phases 1-3c: build and check kernels
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
     (CSR) call on the same product (library_ms); and that a CUDA entry
     refuses a wrong dtype, a non-contiguous operand and a CPU tensor;
  4. the main path: feast(lap2d(1024), None, (Emin, Emax), 72, fpm) with
     fpm[3] = 8 and the default fpm[42] (mixed precision on CUDA) under the
     default switches, once cold and three times warm, the kernel launch
     counts reset just before the first warm solve and read just after it;
     checks M = 52, eigenvalue error against the analytic values <= 1e-8,
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
     CUDA), once cold and twice warm; checks M = 52, eigenvalue
     error <= 1e-8, residuals <= 1e-8, info 0, the multigrid
     preconditioner with 4 levels, and that each DIA entry's launches in
     the first warm solve (counts set to 0 just before, read just after)
     equal the count the solve's own Krylov record implies
     (``krylov_dia_launches``); then one warm solve with its stages timed,
     and one with FEAST_GROUP_MAX=1 (the unbatched entries carry every
     apply, counted and held to its record the same way) that must agree
     with the default node groups to 1e-8;
  9. the consistent-mass pencil at P = 7 (N = 16,384) through
     solver="gmres" with grid=(128, 128) (multigrid with a B stencil),
     against its analytic eigenvalues, its launches held to its record;
  7. one JSON line {"kernels": [...]} with each kernel's launches on its
     path (the main path's, for the composite's own kernels the SPD-B
     path's, for the DIA kernels the Krylov path's: phase 8's counted
     solves), its error against its plain version and its times; the
     column-major entries' ms, bound_ms and library_ms are those of the
     form without T0 and acc, and their "forms" give every form's times,
     bound and launches.
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
            t = re.search(kernel + r"I([fd])((?:L[ib]\d+E)+)", name)
            if t:
                args = [int(a) for a in re.findall(r"L[ib](\d+)E",
                                                   t.group(2))]
                report.append(dict(
                    dtype="f32" if t.group(1) == "f" else "f64",
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
}
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
)


def _random_dia(N, offsets, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros((len(offsets), N))
    for k, o in enumerate(offsets):
        n = N - abs(o)
        if n > 0:
            d[k, max(0, -o):max(0, -o) + n] = rng.random(n) - 0.5
    return d


# lap2d(256)'s offsets, the Krylov path's operator at P = 8
DIA_LAP = (-256, -1, 0, 1, 256)
# (label, entry, N, offsets, operand shape) of every DIA product timed: the
# Krylov path's four (DIA_MAIN_SHAPES), the P=10 main path's Rayleigh-Ritz
# and residual products (fp64, M = M0 = 72, offsets +-1, +-1024) and the
# consistent-mass bounds' Lanczos products (f32, M = 1, where the host's
# cost per call rules)
DIA_CASES = tuple(
    ("krylov", name, 65536, DIA_LAP,
     (DIA_MAIN_SHAPES[name][0], 65536, DIA_MAIN_SHAPES[name][1])
     if batched else (65536, DIA_MAIN_SHAPES[name][1]))
    for name, (batched, _, _) in DIA_KERNELS.items()) + (
    ("rr_p10", "dia_matvec_f64", 1048576, (-1024, -1, 0, 1, 1024),
     (1048576, 72)),
    ("lanczos_m1", "dia_matvec_f32", 65536, DIA_LAP, (65536, 1)))


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
    the card's bytes rate, above its operations over the peak rate."""
    bw, peak32, peak64 = _card_rates(card_name)
    f32 = name.endswith("f32")
    size = 4 if f32 else 8
    elems = int(np.prod(shape))
    nbytes = (2 * elems + nd * N) * size
    flops = 2 * nd * elems
    by_bytes = nbytes / bw >= flops / (peak32 if f32 else peak64)
    return (max(nbytes / bw, flops / (peak32 if f32 else peak64)) * 1e3,
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
    vec = 4 if dtype == torch.float32 else 2
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
    flat body at every DIA_CASES shape but the Lanczos one, each timed on
    the device by CUDA graph over four rotating operands and checked once
    against the plain version; the plan's own choice marked."""
    import torch
    from feastkit_tpu_torch.ops import dia as D
    print("== DIA sweep: ring block shapes and the flat body", flush=True)
    rows = []
    for label, name, N, offsets, shape in DIA_CASES[:-1]:
        batched = DIA_KERNELS[name][0]
        dtype = torch.float32 if name.endswith("f32") else torch.float64
        tol = 1e-5 if dtype == torch.float32 else 1e-13
        g = shape[0] if batched else 1
        M = shape[-1]
        wrapper = getattr(D, name)
        dia = torch.as_tensor(_random_dia(N, offsets, 5),
                              device="cuda").to(dtype)
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
    P=10 Rayleigh-Ritz and the Lanczos (M = 1) shapes."""
    import torch
    from feastkit_tpu_torch.ops import dia as D
    print("== 3c. the DIA matvec kernels against their plain version "
          "(Krylov path, P=8)", flush=True)
    _print_ptxas("dia_matvec", ptxas_dia)
    check(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
              for r in ptxas_dia), "no ring-body instantiation spills")
    A = lap2d(256)
    N = A.shape[0]
    out = {}
    extra = {}
    for label, name, n, offsets, shape in DIA_CASES:
        batched, dname, _ = DIA_KERNELS[name]
        dtype = getattr(torch, dname)
        tol = 1e-5 if dtype == torch.float32 else 1e-13
        wrapper = getattr(D, name)
        dia = torch.as_tensor(_random_dia(n, offsets, 5),
                              device="cuda").to(dtype)
        x = _planes(torch, dtype, shape, 1, 7)[0]
        err, worst, plan = _dia_check(torch, D, wrapper, batched, dia,
                                      offsets, x, tol, f"{label} {shape}")
        want = "ring" if label == "krylov" else "flat"
        check(plan["body"] == want, f"{name} {label} takes the {want} body")
        if label == "krylov":
            for an, aoffs, am, ag in DIA_AWKWARD:
                dd = torch.as_tensor(_random_dia(an, aoffs, an + am),
                                     device="cuda").to(dtype)
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
            # operand, laid out beforehand
            import scipy.sparse as sp
            Acsr_np = sp.diags(
                [_random_dia(n, offsets, 5)[k][max(0, -o):n - max(0, o)]
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
        if label == "krylov":
            out[name] = row
        else:
            extra[label] = row
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
    return out


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
        _, wall = _krylov_solve(A, B, Emin, Emax, M0, fpm, device, **kw)
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
    return dict(wall_s=wall, other_s=outside, launches=counts, **times)


def phase_krylov(dia_kernels, nx=256, device="cuda"):
    """Phase 8: the Krylov contour engine on the 2D Laplacian at P = 8 with
    solver="gmres": once cold, then warm solves (the first counted), a
    staged one, and one with FEAST_GROUP_MAX=1 (the unbatched entries carry
    every apply) that must agree with the default node groups."""
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
    r, cold_s = _krylov_solve(A, None, Emin, Emax, M0, fpm, device, **kw)
    print(f"   cold solve {cold_s:.2f} s", flush=True)
    _check_result(r, exp, 1e-8, f"P={int(np.log2(nx))} Krylov cold")
    levels = {256: 4}.get(nx)
    print(f"   preconditioner {r.krylov['precond']} with "
          f"{r.krylov['mg_levels']} levels", flush=True)
    check(r.krylov["precond"] == "mg"
          and (levels is None or r.krylov["mg_levels"] == levels),
          f"multigrid preconditioner{f' with {levels} levels' if levels else ''}")
    del r
    if device == "cuda":
        torch.cuda.empty_cache()
        gc.collect()    # no earlier phase's cyclic garbage in this peak
        torch.cuda.reset_peak_memory_stats()
    r, warm_s, counts, _ = _krylov_counted(A, None, Emin, Emax, M0, fpm,
                                           "Krylov warm", device, **kw)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    print(f"   warm solve {warm_s:.2f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    _check_result(r, exp, 1e-8, "Krylov warm")
    lam_default = np.sort(r.lam)
    groups = sorted({e["nodes"] for e in r.krylov["events"]
                     if e["op"] == "gmres"})
    print(f"   node groups {groups}, loops {r.loop}", flush=True)
    del r
    warm = [warm_s]
    for _ in range(1):
        r, s = _krylov_solve(A, None, Emin, Emax, M0, fpm, device, **kw)
        check(r.M == len(exp) and int(r.info) == 0,
              "repeat warm Krylov solve agrees")
        warm.append(s)
        del r
    print(f"   warm solves {[round(s, 3) for s in warm]} s, median "
          f"{float(np.median(warm)):.3f} s", flush=True)
    dia_ms = {n: k["ms"] for n, k in dia_kernels.items()}
    breakdown = _krylov_breakdown(A, None, Emin, Emax, M0, fpm, dia_ms,
                                  device, **kw)
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
        for name in DIA_KERNELS:
            check(total[name] > 0, f"{name} launched on the Krylov path "
                  f"({total[name]})")
        check(counts1["dia_matvec_batched_f32"] == 0
              and counts1["dia_matvec_batched_f64"] == 0,
              "FEAST_GROUP_MAX=1: the unbatched entries carry every apply")
    return dict(cold_s=cold_s, warm_s=warm,
                warm_median_s=float(np.median(warm)), group1_s=g1_s,
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


def _run_feast(A, B, Emin, Emax, M0, fpm):
    import torch
    import feastkit_tpu_torch as ft
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ft.feast(A, B, (Emin, Emax), M0, fpm)
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
    """Set the FEAST_CHEB_FUSE2 / FEAST_CHEB_FUSE4 switches (None: unset)
    for the block, then restore the environment."""
    names = ("FEAST_CHEB_FUSE2", "FEAST_CHEB_FUSE4")
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


def _counted_solve(A, B, Emin, Emax, M0, fpm, label, gen=False):
    """One solve with the launch counts set to 0 just before and read just
    after; checks the counts against the schedule the solve reports."""
    from feastkit_tpu_torch.ops.cheb_kernels import (form_launch_counts,
                                                      launch_counts,
                                                      reset_launch_counts)
    with recorded_applications(gen) as seen:
        reset_launch_counts()
        r, seconds = _run_feast(A, B, Emin, Emax, M0, fpm)
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
    with switches():
        r, warm_s, counts, seen = _counted_solve(A, None, Emin, Emax, M0,
                                                 fpm, "P=10 warm")
    peak = torch.cuda.max_memory_allocated()
    print(f"   warm solve {warm_s:.2f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    _check_result(r, exp, 1e-8, "P=10 warm")
    check(seen["steps"] == {"f32": 4, "f64": 4},
          "both rungs take four steps per pass at the main shapes")
    for name in MAIN_PATH_KERNELS:
        check(counts[name] > 0,
              f"{name} launched on the main path ({counts[name]})")
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
        applications=seen["applications"], breakdown=breakdown)


def _breakdown(A, B, Emin, Emax, M0, fpm):
    """One more warm solve with the solver's stages wrapped in timers (the
    device synchronised at each stage's edges): where the time goes."""
    import torch
    from feastkit_tpu_torch.solvers import sparse
    times = {}

    def timed(name, bucket, sync=True):
        orig = getattr(sparse, name)

        def wrapper(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if sync:
                torch.cuda.synchronize()
            key = bucket(k) if callable(bucket) else bucket
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
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
                   lambda k: f"filter_{k['rung']}"),
             timed("_sparse_cheb_filter_host_fused_gen",
                   lambda k: f"filter_{k['rung']}"),
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
    return dict(wall_s=wall, other_s=rest, **times)


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


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if "--dia-times" in argv:       # a child of --dia-turns
        dia_times(argv[argv.index("--dia-times") + 1])
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
    kernels = phase_kernels(smi.split(",")[0])
    gen_kernels = phase_gen_kernels(smi.split(",")[0], ptxas["cheb_step_cm"])
    nd9 = {k: gen_kernels.pop(k) for k in list(gen_kernels)
           if k.endswith("_nd9")}
    kernels.update(gen_kernels)
    dia_kernels = phase_dia_kernels(smi.split(",")[0], ptxas["dia_matvec"])
    rr_ms = phase_rayleigh_ritz()
    counts = {name: None for name in (*KERNELS, *DIA_KERNELS)}
    form_counts = {}
    if not quick:
        main_path = phase_main_path(kernels)
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
        krylov = phase_krylov(dia_kernels)
        gen_krylov = phase_gen_krylov()
        counts.update(krylov["launches"])
        print(json.dumps({"krylov": krylov, "gen_krylov": gen_krylov}),
              flush=True)
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
            body=k["body"], turns_ms=k["turns"]))
    print(json.dumps({"rayleigh_ritz_ms": rr_ms, "copy_tbs": copy_tbs,
                      "multistep_nine_diagonals": nd9,
                      "two_step_p9": {n: kernels[n].pop("p9") for n in (
                          "cheb_step2_f32", "cheb_step2_f64")}}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
