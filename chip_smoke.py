"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py           # every phase (about a few minutes)
    python3 chip_smoke.py --quick   # phases 1-3c: build and check kernels
    python3 chip_smoke.py --krylov-solve 9   # one Krylov solve at P = 9

Phases, each printed before the last line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of every kernel from feastkit_tpu_torch/ops/csrc with nvcc
     (sm_90a), one nvcc per source, all started together, and its time
     (with cheb_multistep.cu built a second time with the run-time
     diagonal count only, for phase 3b);
  3. each of the six kernels against its plain PyTorch version on the card,
     at the main path's shapes (2D Laplacian P=10: N = 1,048,576, M = 72,
     five diagonals; 8 steps for the 1-step kernels, two consecutive passes
     for the 2- and 4-step kernels, so their output pair is read back as
     the next input pair) and at awkward shapes (M = 11, 1, 40; N not a
     multiple of any tile; |offset| = nx; one operator whose S max|offset|
     exceeds N, so every halo is clipped at both ends; operators with 3
     and with 11 diagonals); T outputs and acc,
     tolerance relative to max|acc|: f32 1e-5, fp64 1e-13. Then each
     kernel's time per launch and per step, its plain version's time, the
     bound, and a torch.sparse.mm (CSR) matvec for scale; and the
     Rayleigh-Ritz update's time at the main path's shapes;
  3b. the SPD-B composite's kernels (the column-major one-step entries
     cheb_step_cm_f32/f64 and the combine cheb_combine_f32/f64) against
     their plain versions at the P=8 consistent-mass shapes (N = 65,536,
     M = 72, the nine-diagonal B~) and at awkward shapes, same
     tolerances, and their times; and the 2- and 4-step kernels on the
     nine-diagonal operator with the ND = 9 instantiation and with the
     run-time-count body, each checked and timed;
  3c. the DIA matvec kernels of ops/csrc/dia_matvec.cu (dia_matvec_f32/f64
     and dia_matvec_batched_f32/f64) against their plain version at the
     Krylov path's P=8 shapes (N = 65,536, five diagonals: fp64 M = 72,
     f32 M = 128, batched g = 2, M = 128 in both types) and at awkward
     shapes (M = 1, 7, 11; N = 1073, 100, 1089; |offset| = nx; 2 max|offset|
     > N; 1, 3, 9 and 11 diagonals; g = 3), tolerance relative to max|y|:
     f32 1e-5, fp64 1e-13; their times over four rotating operands, the
     plain version's, the bound and a torch.sparse.mm (CSR) call on the
     same product (library_ms); and that a CUDA entry refuses a wrong
     dtype, a non-contiguous operand and a CPU tensor;
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
     and inner series imply, on both rungs; then one more warm solve with
     its stages timed (the Lanczos bounds, coefficients, each rung's
     filter, Rayleigh-Ritz, back-transform, Q0);
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
     solves), its error against its plain version and its times.
The last line is {"ok": true, "device": {...}}. Any failed check raises
and exits nonzero before that line. Without a CUDA device the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
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


def phase_build():
    from feastkit_tpu_torch.ops import cuda_build
    sources = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
    # every source, and the multi-step kernels with the run-time diagonal
    # count only (timed against the nine-diagonal instantiation, phase 3)
    builds = [(name, ()) for name in sources] + [("cheb_multistep",
                                                  RUNTIME_COUNT_ONLY)]
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:    # one nvcc per build
        list(pool.map(lambda b: cuda_build.build(*b), builds))
    dt = time.perf_counter() - t0
    print(f"== 2. built {sources} and cheb_multistep {RUNTIME_COUNT_ONLY} "
          f"for sm_90a in {dt:.2f} s", flush=True)
    return dt


KERNELS = {   # name -> (steps per launch, source, TPU kernel it replaces)
    "cheb_step_f32": (1, "cheb_step.cu", "feastkit_tpu/ops/cheb_pallas.py:685"),
    "cheb_step_f64": (1, "cheb_step.cu", "feastkit_tpu/ops/cheb_pallas.py:256"),
    "cheb_step_cm_f32": (1, "cheb_step.cu",
                         "feastkit_tpu/ops/cheb_pallas.py:685"),
    "cheb_step_cm_f64": (1, "cheb_step.cu",
                         "feastkit_tpu/ops/cheb_pallas.py:256"),
    "cheb_combine_f32": (0, "cheb_combine.cu",
                         "feastkit_tpu/ops/cheb_pallas.py:990"),
    "cheb_combine_f64": (0, "cheb_combine.cu",
                         "feastkit_tpu/ops/cheb_pallas.py:990"),
    "cheb_step2_f32": (2, "cheb_multistep.cu",
                       "feastkit_tpu/ops/cheb_pallas.py:749"),
    "cheb_step4_f32": (4, "cheb_multistep.cu",
                       "feastkit_tpu/ops/cheb_pallas.py:847"),
    "cheb_step2_f64": (2, "cheb_multistep.cu",
                       "feastkit_tpu/ops/cheb_pallas.py:370"),
    "cheb_step4_f64": (4, "cheb_multistep.cu",
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
    40 and N = 1073, 1073, 1089; one whose 2 max|offset| exceeds N; and a
    3-diagonal and an 11-diagonal operator (the multi-step kernels have a
    body for five diagonals and one for any other count)."""
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
                        (1089, 3, (-40, -33, -7, -2, -1, 0, 1, 2, 7, 33, 40))):
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
                line += (f"\n      tile {plan['tile']} rows x {plan['tiles']}"
                         f" tiles x {M} columns, halo {plan['halo']}, "
                         f"{plan['shared_bytes']} B shared per block; "
                         "reckoned from the tile, not measured: recompute "
                         f"{plan['recompute']:.3f}, planes moved "
                         f"{plan['planes_moved']:.2f} per launch")
            print(line, flush=True)
            out[name] = dict(
                max_abs_err=err, max_rel_err=worst, ms=ms, ms_per_step=ms / S,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / bw >= flops / peak
                else "operations", csr_spmm_ms=csr_ms)
            del carry
            torch.cuda.empty_cache()
        del dia
    return out


def phase_gen_kernels(card_name):
    """Phase 3 for the kernels of the sparse-SPD-B composite: the
    column-major one-step entries and the combine against their plain
    versions at the P=8 consistent-mass shapes (N = 65,536, M = 72, the
    nine-diagonal B~) and at awkward shapes; their times; and the
    multi-step kernels on the nine-diagonal operator, with the ND = 9
    instantiation and with the run-time-count body."""
    import torch
    from feastkit_tpu_torch.ops import cheb_kernels as ck
    bw, peak32, peak64 = _card_rates(card_name)
    print("== 3b. the SPD-B composite's kernels (P=8 consistent mass)",
          flush=True)
    A, B, _ = consistent_mass_pencil(8)
    (_, _), (dB_np, offs) = congruenced_dia(A, B)
    N, M, nd = A.shape[0], 72, len(offs)
    # b_lo, b_hi of the solve (0.9 / 1.1 x the B~ spectrum (0.25, 2.25))
    scB, shB = 2.0 / (2.475 - 0.225), (2.475 + 0.225) / (2.475 - 0.225)
    awkward = _awkward_operators()
    out = {}
    for dtype, tol, peak in ((torch.float32, 1e-5, peak32),
                             (torch.float64, 1e-13, peak64)):
        rung = "f32" if dtype == torch.float32 else "f64"
        npd = np.float32 if dtype == torch.float32 else np.float64
        size = torch.finfo(dtype).bits // 8
        dia = torch.as_tensor(dB_np, device="cuda").to(dtype)
        cs = np.asarray(np.random.default_rng(0).standard_normal(8) * 0.1,
                        npd)
        # the column-major one-step entry (8 steps, as for cheb_step_*)
        name = f"cheb_step_cm_{rung}"
        wrapper, plain = getattr(ck, name), ck.cheb_step_cm_plain
        carry = _planes(torch, dtype, (M, N), 3, 1)
        err, rel = _compare(torch, wrapper, plain, dia, offs, carry,
                            npd(scB), npd(shB), cs)
        print(f"   {name} N={N} M={M} nd={nd}: max abs err {err:.3e}, "
              f"relative {rel:.3e} (tol {tol:g})", flush=True)
        check(rel <= tol, f"{name} agrees with its plain version at the "
              "consistent-mass shapes")
        worst = rel
        for dn, on, an, am in awkward:
            dd = torch.as_tensor(dn, device="cuda").to(dtype)
            c2 = _planes(torch, dtype, (am, an), 3, 2)
            _, r2 = _compare(torch, wrapper, plain, dd, on, c2, npd(0.37),
                             npd(0.61), cs[:5])
            print(f"   {name} N={an} M={am} offsets={on}: relative "
                  f"{r2:.3e}", flush=True)
            check(r2 <= tol, f"{name} agrees at N={an} M={am}")
            worst = max(worst, r2)

        def step():
            wrapper(dia, offs, *carry, scB, shB, 0.01)
            carry[0], carry[1] = carry[1], carry[0]

        def step_plain():
            plain(dia, offs, *carry, float(scB), float(shB), 0.01)
            carry[0], carry[1] = carry[1], carry[0]
        ms = cuda_time_ms(step, 100)
        plain_ms = cuda_time_ms(step_plain, 10)
        nbytes = (5 * N * M + nd * N) * size
        flops = N * M * (2 * nd + 6)
        bound_ms = max(nbytes / bw, flops / peak) * 1e3
        print(f"   {name}: {ms:.4f} ms/launch (plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms, {bound_ms / ms:.1%} of bound)",
              flush=True)
        out[name] = dict(max_abs_err=err, max_rel_err=worst, ms=ms,
                         ms_per_step=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms,
                         bound_by="bytes" if nbytes / bw >= flops / peak
                         else "operations", csr_spmm_ms=None)
        del carry
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
            for body, defines in (("nd9", ()),
                                  ("runtime_count", RUNTIME_COUNT_ONLY)):
                def kern(planes, cks, defines=defines):
                    ck._multistep(wrapper, S, dtype, dia, offs, *planes,
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
                row[body] = dict(ms=cuda_time_ms(step, 50), max_rel_err=r)
                del k, p_
            print(f"   {name} nd={nd} (tile {plan['tile']}): ND=9 body "
                  f"{row['nd9']['ms']:.4f} ms/launch, run-time-count body "
                  f"{row['runtime_count']['ms']:.4f} ms/launch", flush=True)
            out[f"{name}_nd9"] = row
        del dia
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


def phase_dia_kernels(card_name):
    """Phase 3c: the DIA matvec entries (``ops/csrc/dia_matvec.cu``)
    against their plain version at the Krylov path's shapes and at awkward
    ones, tolerance relative to max|y|: f32 1e-5, fp64 1e-13; then each
    entry's time per launch over four rotating operands (the 128-column f32
    operand alone fits the 50 MB L2), the plain version's, the bound and
    one torch.sparse.mm (CSR) call on the same product."""
    import torch
    from feastkit_tpu_torch.ops import dia as D
    from feastkit_tpu_torch.ops.dia import bcoo_to_dia
    from feastkit_tpu_torch.solvers.sparse import sparse_coo_arrays
    bw, peak32, peak64 = _card_rates(card_name)
    print("== 3c. the DIA matvec kernels against their plain version "
          "(Krylov path, P=8)", flush=True)
    A = lap2d(256)
    N = A.shape[0]
    data, idx, _ = sparse_coo_arrays(A, np.float64)
    dia_np, offsets = bcoo_to_dia(data, idx, N)
    nd = len(offsets)
    out = {}
    for name, (batched, dname, _) in DIA_KERNELS.items():
        dtype = getattr(torch, dname)
        tol = 1e-5 if dtype == torch.float32 else 1e-13
        size = torch.finfo(dtype).bits // 8
        peak = peak32 if dtype == torch.float32 else peak64
        wrapper = getattr(D, name)
        dia = torch.as_tensor(dia_np, device="cuda").to(dtype)
        g, M = DIA_MAIN_SHAPES[name]
        shape = (g, N, M) if batched else (N, M)
        x = _planes(torch, dtype, shape, 1, 7)[0]
        before = wrapper.launches
        y = wrapper(dia, offsets, x)
        yp = D.dia_matvec_plain(dia, offsets, x)
        torch.cuda.synchronize()
        check(wrapper.launches == before + 1,
              f"{name} counts one launch per call")
        err = float((y - yp).abs().max())
        rel = err / float(yp.abs().max())
        print(f"   {name} main shapes {tuple(shape)} nd={nd}: max abs err "
              f"{err:.3e}, relative {rel:.3e} (tol {tol:g})", flush=True)
        check(rel <= tol, f"{name} agrees with its plain version at the "
              "Krylov path's shapes")
        worst = rel
        for an, aoffs, am, ag in DIA_AWKWARD:
            dd = torch.as_tensor(_random_dia(an, aoffs, an + am),
                                 device="cuda").to(dtype)
            xs = _planes(torch, dtype, (ag, an, am) if batched else (an, am),
                         1, ag)[0]
            r = float((wrapper(dd, aoffs, xs)
                       - D.dia_matvec_plain(dd, aoffs, xs)).abs().max()
                      / D.dia_matvec_plain(dd, aoffs, xs).abs().max())
            print(f"   {name} N={an} M={am}{f' g={ag}' if batched else ''} "
                  f"offsets={aoffs}: relative {r:.3e}", flush=True)
            check(r <= tol, f"{name} agrees at N={an} M={am} nd={len(aoffs)}")
            worst = max(worst, r)
        # times over four rotating operands
        xs = _planes(torch, dtype, shape, 4, 11)
        turn = [0]

        def kern(fn):
            def run():
                fn(xs[turn[0] % 4])
                turn[0] += 1
            return run
        ms = cuda_time_ms(kern(lambda v: wrapper(dia, offsets, v)), 200)
        plain_ms = cuda_time_ms(
            kern(lambda v: D.dia_matvec_plain(dia, offsets, v)), 20)
        # the library yardstick: one CSR product on the (N, g M) operand,
        # laid out beforehand
        with warnings.catch_warnings():   # "CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            Acsr = torch.sparse_csr_tensor(
                torch.as_tensor(A.indptr, dtype=torch.int64),
                torch.as_tensor(A.indices, dtype=torch.int64),
                torch.as_tensor(A.data, dtype=dtype), size=A.shape).cuda()
        xl = [v.permute(1, 0, 2).reshape(N, g * M).contiguous()
              if batched else v for v in xs]
        lib_turn = [0]

        def lib():
            torch.sparse.mm(Acsr, xl[lib_turn[0] % 4])
            lib_turn[0] += 1
        library_ms = cuda_time_ms(lib, 50)
        nbytes = (2 * g * N * M + nd * N) * size    # x, y once; diagonals
        flops = 2 * nd * g * N * M
        bound_ms = max(nbytes / bw, flops / peak) * 1e3
        print(f"   {name}: {ms:.4f} ms/launch over 4 rotating operands "
              f"(plain {plain_ms:.4f} ms; torch.sparse.mm CSR "
              f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms = "
              f"{nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s, "
              f"{bound_ms / ms:.1%} of bound)", flush=True)
        out[name] = dict(max_abs_err=err, max_rel_err=worst, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by="bytes" if nbytes / bw >= flops / peak
                         else "operations", library_ms=library_ms,
                         shape=list(shape))
        del dia, x, y, yp, xs, xl, Acsr
        torch.cuda.empty_cache()
    # what a CUDA entry refuses
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
    print(f"   {label}: {seconds:.2f} s, {calls} GMRES calls, {trips} "
          f"restart cycles; DIA launches {counts}", flush=True)
    if device == "cuda":
        check(counts == want, f"{label}: DIA launches equal the count the "
              f"solve's Krylov record implies {want}")
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
    from feastkit_tpu_torch.ops.cheb_kernels import (launch_counts,
                                                      reset_launch_counts)
    with recorded_applications(gen) as seen:
        reset_launch_counts()
        r, seconds = _run_feast(A, B, Emin, Emax, M0, fpm)
        counts = launch_counts()
    want = (expected_gen_launches(seen["applications"], seen["steps"],
                                  seen["qlen"]) if gen
            else expected_launches(seen["applications"], seen["steps"]))
    print(f"   {label}: {seconds:.2f} s, steps per pass {seen['steps']}, "
          f"applications {seen['applications']}, launches {counts}",
          flush=True)
    check(counts == want, f"{label}: launches follow the schedule {want}")
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
    for rung in ("f32", "f64"):
        names = [n for n in counts if n.endswith(rung) and counts[n]]
        kernel_s = sum(counts[n] * kernels[n]["ms"] for n in names
                       if n in kernels) / 1e3
        print(f"   {rung} rung: launches "
              f"{ {n: counts[n] for n in names} }; x ms/launch (phase 3, "
              f"nine-diagonal times for the multi-step kernels) = "
              f"{kernel_s:.3f} s; filter stage "
              f"{breakdown.get('filter_' + rung, 0.0):.3f} s", flush=True)
    return dict(cold_s=cold_s, warm_s=warm, warm_median_s=float(
        np.median(warm)), peak_bytes=peak, counts=counts,
        applications=seen["applications"], inner_steps=seen["steps"],
        inner_series=seen["qlen"], breakdown=breakdown)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import feastkit_tpu_torch  # noqa: F401  (fails outside the repo)
    quick = "--quick" in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    if "--krylov-solve" in argv:
        krylov_scale(int(argv[argv.index("--krylov-solve") + 1]))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    kernels = phase_kernels(smi.split(",")[0])
    gen_kernels = phase_gen_kernels(smi.split(",")[0])
    nd9 = {k: gen_kernels.pop(k) for k in list(gen_kernels)
           if k.endswith("_nd9")}
    kernels.update(gen_kernels)
    dia_kernels = phase_dia_kernels(smi.split(",")[0])
    rr_ms = phase_rayleigh_ritz()
    counts = {name: None for name in (*KERNELS, *DIA_KERNELS)}
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
            bound_by=k["bound_by"], library_ms=None,
            steps_per_launch=steps, ms_per_step=k["ms_per_step"],
            csr_spmm_ms=k["csr_spmm_ms"]))
    for name, k in dia_kernels.items():
        rows.append(dict(
            name=name, route="cuda",
            source="feastkit_tpu_torch/ops/csrc/dia_matvec.cu",
            replaces=DIA_KERNELS[name][2], launches=counts[name],
            max_abs_err=k["max_abs_err"], max_rel_err=k["max_rel_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            steps_per_launch=0, ms_per_step=k["ms"], csr_spmm_ms=None,
            shape=k["shape"]))
    print(json.dumps({"rayleigh_ritz_ms": rr_ms, "copy_tbs": copy_tbs,
                      "multistep_nine_diagonals": nd9}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
