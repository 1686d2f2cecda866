"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py           # every phase (about a few minutes)
    python3 chip_smoke.py --quick   # phases 1-3: build and check kernels

Phases, each printed before the last line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of every kernel from feastkit_tpu_torch/ops/csrc with nvcc
     (sm_90a), one nvcc per source, all started together, and its time;
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
  6. one JSON line {"kernels": [...]} with each kernel's launches on the
     main path, its error against its plain version and its times.
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


def phase_build():
    from feastkit_tpu_torch.ops import cuda_build
    sources = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        list(pool.map(cuda_build.build, sources))
    dt = time.perf_counter() - t0
    print(f"== 2. built {sources} for sm_90a in {dt:.2f} s", flush=True)
    return dt


KERNELS = {   # name -> (steps per launch, source, TPU kernel it replaces)
    "cheb_step_f32": (1, "cheb_step.cu", "feastkit_tpu/ops/cheb_pallas.py:685"),
    "cheb_step_f64": (1, "cheb_step.cu", "feastkit_tpu/ops/cheb_pallas.py:256"),
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


@contextlib.contextmanager
def recorded_applications():
    """Record (rung, series length) of every filter application and each
    rung's steps per pass, read back from the solver as it runs."""
    from feastkit_tpu_torch.solvers import sparse
    orig = sparse._sparse_cheb_filter_host_fused
    seen = dict(applications=[], steps={})

    def recorder(ctx, Q, *, rung, n_coeffs=None):
        n = len(ctx[rung]["coeffs"])
        if n_coeffs is not None:
            n = min(n, max(int(n_coeffs), 3))
        seen["applications"].append((rung, n))
        seen["steps"][rung] = ctx[rung]["steps"]
        return orig(ctx, Q, rung=rung, n_coeffs=n_coeffs)

    sparse._sparse_cheb_filter_host_fused = recorder
    try:
        yield seen
    finally:
        sparse._sparse_cheb_filter_host_fused = orig


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


def _counted_solve(A, B, Emin, Emax, M0, fpm, label):
    """One solve with the launch counts set to 0 just before and read just
    after; checks the counts against the schedule the solve reports."""
    from feastkit_tpu_torch.ops.cheb_kernels import (launch_counts,
                                                      reset_launch_counts)
    with recorded_applications() as seen:
        reset_launch_counts()
        r, seconds = _run_feast(A, B, Emin, Emax, M0, fpm)
        counts = launch_counts()
    want = expected_launches(seen["applications"], seen["steps"])
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
    for name, n in counts.items():
        check(n > 0, f"{name} launched on the main path ({n})")
    del r
    warm = [warm_s]
    for _ in range(2):
        r, s = _run_feast(A, None, Emin, Emax, M0, fpm)
        check(r.M == 52 and int(r.info) == 0, "repeat warm solve agrees")
        warm.append(s)
        del r
    print(f"   warm solves {[round(s, 3) for s in warm]} s, median "
          f"{float(np.median(warm)):.3f} s", flush=True)
    breakdown = _breakdown(A, Emin, Emax, M0, fpm)
    for rung in ("f32", "f64"):
        names = [n for n in counts if n.endswith(rung)]
        kernel_s = sum(counts[n] * kernels[n]["ms"] for n in names) / 1e3
        print(f"   {rung} rung: launches "
              f"{ {n: counts[n] for n in names} } x ms/launch (CUDA events, "
              f"phase 3) = {kernel_s:.3f} s; filter stage "
              f"{breakdown.get('filter_' + rung, 0.0):.3f} s", flush=True)
    return dict(cold_s=cold_s, warm_s=warm, warm_median_s=float(
        np.median(warm)), peak_bytes=peak, counts=counts,
        applications=seen["applications"], breakdown=breakdown)


def _breakdown(A, Emin, Emax, M0, fpm):
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
        _, wall = _run_feast(A, None, Emin, Emax, M0, fpm)
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
    kernels = phase_kernels(smi.split(",")[0])
    rr_ms = phase_rayleigh_ritz()
    counts = {name: None for name in KERNELS}
    if not quick:
        main_path = phase_main_path(kernels)
        counts = main_path["counts"]
        p9 = phase_p9()
        print(json.dumps({"main_path": main_path, "p9": p9}), flush=True)
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
    print(json.dumps({"rayleigh_ritz_ms": rr_ms, "copy_tbs": copy_tbs}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
