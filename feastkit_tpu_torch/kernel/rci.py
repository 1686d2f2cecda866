"""The reverse-communication (RCI) step machines on torch tensors: the
caller owns the linear algebra.

Counterpart of ``feastkit_tpu/kernel/rci.py``, for callers who bring their
own solvers (an external factorization, an out-of-core solve). The state
machine hands out jobs with the JAX package's codes
(``core/types.FeastRCIJob``) and in the same order:

    state = FeastSRCI(N, M0, Emin, Emax, fpm, device="cuda")
    job = state.step()          # FACTORIZE with state.Ze (MULT_B first
                                # for a generalized B)
    while job != FeastRCIJob.DONE:
        if job == FeastRCIJob.FACTORIZE:   # factorize (Ze B - A)
            ...
        elif job == FeastRCIJob.SOLVE:     # workc <- (Ze B - A)^-1 workc
            state.workc = my_solve(state.Ze, state.workc)
        elif job == FeastRCIJob.MULT_A:    # workc <- A @ workc
            state.workc = A @ state.workc
        elif job == FeastRCIJob.MULT_B:    # workc <- B @ workc
            state.workc = B @ state.workc
        job = state.step()
    lam, q, res, M = state.lam, state.q, state.res, state.M

``workc``, ``q`` and the projections are complex128 (or float64) tensors
on the state's device (``device=None`` means CUDA); whatever the caller
assigns to ``workc`` (or ``Xall``) is read as a tensor there. The
M0 x M0 reduced problems run on the host (``scipy.linalg.eigh`` / ``eig``),
as in the JAX package; ``lam``, ``res`` and ``inside`` are host numpy
arrays. The seeded starts are the JAX package's numpy ``default_rng``
draws, bit for bit, and the counters are mirrored into fpm[50..53] at the
same steps.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch

from ..core.aux import feast_get_custom_contour
from ..core.backend import resolve_device
from ..core.contour import feast_contour, feast_gcontour
from ..core.parameters import _ensure_fpm, feast_tolerance
from ..core.tools import thin_svd
from ..core.types import FeastError, FeastRCIJob

__all__ = ["FeastSRCI", "FeastHRCI", "FeastGRCI", "FeastPRCI",
           "FeastPolyRCI"]


def _seeded_real(N, M0):
    rng = np.random.default_rng((N * 1000003 + M0 * 101) % (2**31 - 1))
    Q = rng.standard_normal((N, M0))
    return Q / np.linalg.norm(Q, axis=0, keepdims=True)


def _seeded_complex(N, M0):
    rng = np.random.default_rng((N * 1000003 + M0 * 101 + 7) % (2**31 - 1))
    Q = rng.standard_normal((N, M0)) + 1j * rng.standard_normal((N, M0))
    return Q / np.linalg.norm(Q, axis=0, keepdims=True)


def _normalized(q):
    nrm = torch.linalg.vector_norm(q, dim=0)
    return q / torch.where(nrm > 0, nrm, 1.0)[None, :]


class _RCIBase:
    """The contour sweep, the Rayleigh-Ritz jobs and the loop bookkeeping
    shared by the S, H, G and P machines. A machine gives its field
    (``_complex``), its node weight, its pairing, its reduced problem
    (``_rr``), its inside test and its sort key."""

    _complex = True

    def __init__(self, N, M0, fpm, contour, Q0, seeded, standard_B, device):
        self.N, self.M0 = int(N), int(M0)
        self.fpm = fpm
        self.contour = contour
        self.device = resolve_device(device)
        self.tol = feast_tolerance(fpm, np.float64)
        self.max_loops = fpm[4]
        self.loop = 0
        self.e = 0                 # contour node index
        self.phase = "init"
        self.Ze = complex(contour.Zne[0])
        self.epsout = np.inf
        self.M = 0
        self.info = FeastError.SUCCESS
        self.lam = None
        self.q = None
        self.res = None
        self._Qproj = None
        self._rank_cut = float(np.finfo(np.float64).eps) ** 0.25
        self.standard_B = standard_B
        self.Q = self._tensor(Q0 if fpm[5] == 1 and Q0 is not None
                              else seeded, torch.complex128 if self._complex
                              else torch.float64).clone()
        self.workc = None

    def _tensor(self, X, dtype=torch.complex128):
        """A caller's block (tensor or array) as ``dtype`` on the device."""
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X))
        return X.to(device=self.device, dtype=dtype)

    def _work(self):
        return self._tensor(self.workc)

    def _field(self, X):
        """X in the machine's field: the real part for a real machine."""
        return X if self._complex else X.real

    def _out(self, X):
        """A block handed to the caller: a complex copy."""
        return X.to(torch.complex128, copy=True)

    def _mirror_fpm(self):
        """The counters in fpm[50..53]: node, loop, M, info."""
        self.fpm[50] = self.e + 1
        self.fpm[51] = self.loop
        self.fpm[52] = self.M
        self.fpm[53] = int(self.info)

    def _sweep_or_mult_b(self):
        """The next sweep, after a MULT_B for B Q unless B is the
        identity."""
        if self.standard_B:
            self._BQ = self.Q.clone()
            return self._start_sweep()
        self.phase = "mult_b_init"
        self.workc = self._out(self.Q)
        return FeastRCIJob.MULT_B

    def _start_sweep(self):
        self._Qproj = torch.zeros((self.N, self.M0), dtype=torch.complex128,
                                  device=self.device)
        self.e = 0
        return self._emit_factorize()

    def _emit_factorize(self):
        """FACTORIZE with the node's shift in ``Ze``, before the first SOLVE
        at each contour node."""
        self.Ze = complex(self.contour.Zne[self.e])
        self.phase = "factorize"
        self._mirror_fpm()
        return FeastRCIJob.FACTORIZE

    def _rhs(self):
        """SOLVE's input: B Q (from the MULT_B before the sweep), or Q."""
        return self._out(self.Q if self.standard_B else self._BQ)

    def _next_node(self):
        self.e += 1
        self._mirror_fpm()
        if self.e < self.contour.ne:
            return self._emit_factorize()
        return self._after_sweep()

    def _after_sweep(self):
        """The filtered block's orthonormal basis, its directions below
        eps^(1/4) of the largest singular value masked out; then ask for
        A U."""
        U, s = thin_svd(self._field(self._Qproj))
        m = (s >= self._rank_cut * s[0]).to(s.dtype)
        self._U = U * m[None, :].to(U.dtype)
        self._mask = m.cpu().numpy()
        self.workc = self._out(self._U)
        self.phase = "mult_a_rr"
        return FeastRCIJob.MULT_A

    def _ask_residual(self):
        self.workc = self._out(self.q)
        self.phase = "mult_a_res"
        return FeastRCIJob.MULT_A

    def _pair(self, U):
        return U.mH

    def step(self) -> FeastRCIJob:
        if self.phase == "init":
            return self._sweep_or_mult_b()

        if self.phase == "mult_b_init":
            self._BQ = self._field(self._work()).clone()
            return self._start_sweep()

        if self.phase == "factorize":
            self.workc = self._rhs()
            self.phase = "solve"
            return FeastRCIJob.SOLVE

        if self.phase == "solve":
            self._Qproj += self._node_weight() * self._work()
            return self._next_node()

        if self.phase == "mult_a_rr":
            AU = self._field(self._work())
            if self.standard_B:
                self._rr(AU, self._pair(self._U) @ self._U)
                return self._ask_residual()
            self._AU = AU.clone()
            self.workc = self._out(self._U)
            self.phase = "mult_b_rr"
            return FeastRCIJob.MULT_B

        if self.phase == "mult_b_rr":
            self._rr(self._AU,
                     self._pair(self._U) @ self._field(self._work()))
            return self._ask_residual()

        if self.phase == "mult_a_res":
            self._Aq = self._field(self._work()).clone()
            if self.standard_B:
                return self._finish(self.q.clone())
            self.workc = self._out(self.q)
            self.phase = "mult_b_res"
            return FeastRCIJob.MULT_B

        if self.phase == "mult_b_res":
            return self._finish(self._field(self._work()).clone())

        return FeastRCIJob.DONE

    def _finish(self, Bq):
        """Residuals, the inside-first order, M and epsout after a loop;
        DONE once converged or out of loops, else the next sweep from the
        Ritz vectors."""
        res = (torch.linalg.vector_norm(self._Aq - torch.as_tensor(
            self.lam, device=self.device)[None, :].to(Bq.dtype) * Bq, dim=0)
            .cpu().numpy() / np.maximum(np.abs(self.lam), 1.0))
        inside = self._inside(self.lam)
        order = np.lexsort((self._key(self.lam), ~inside * 1))
        self.lam, self.res = self.lam[order], res[order]
        self.q = self.q[:, torch.as_tensor(order, device=self.device)]
        plausible = inside[order] & (self.res < 0.1)
        self.M = int(plausible.sum())
        self.inside = plausible
        self.epsout = float(np.max(np.where(plausible, self.res, 0.0))) \
            if self.M else 0.0
        self.loop += 1
        self._mirror_fpm()
        if (self.epsout <= self.tol and self.M > 0) or \
                self.loop > self.max_loops:
            if not (self.epsout <= self.tol and self.M > 0):
                self.info = FeastError.NO_CONVERGENCE
            self.phase = "done"
            return FeastRCIJob.DONE
        self.Q = self._field(self.q).clone()
        return self._sweep_or_mult_b()


class FeastSRCI(_RCIBase):
    """Real-symmetric RCI (the reference's feast_srci!).

    Caller services: SOLVE overwrites ``state.workc`` (complex N x M0) with
    (Ze B - A)^-1 workc; MULT_A / MULT_B overwrite ``state.workc`` (its
    real part is used) with A or B times ``state.workc``. ``standard_B``:
    B is the identity, and no MULT_B is asked for."""

    _complex = False

    def __init__(self, N, M0, Emin, Emax, fpm=None, *, Q0=None,
                 standard_B=False, device=None):
        fpm = _ensure_fpm(fpm)
        contour = feast_get_custom_contour(fpm) or feast_contour(Emin, Emax,
                                                                 fpm)
        self.Emin, self.Emax = float(Emin), float(Emax)
        super().__init__(N, M0, fpm, contour, Q0, self._seeded(N, M0),
                         standard_B, device)

    @staticmethod
    def _seeded(N, M0):
        return _seeded_real(N, M0)

    def _node_weight(self):
        return 2.0 * complex(self.contour.Wne[self.e])

    def _rr(self, AU, G):
        """The reduced pencil on the host, deflated directions moved to a
        Ritz value far outside the interval."""
        m = self._mask
        BIG = self.Emax + 2.0 * (self.Emax - self.Emin)
        S = (self._U.mH @ AU).cpu().numpy() + BIG * np.diag(1 - m)
        G = G.cpu().numpy() + np.diag(1 - m)
        lam, V = sla.eigh((S + S.conj().T) / 2, (G + G.conj().T) / 2)
        self.lam = lam.real
        self.q = _normalized(self._U @ self._tensor(V, self._U.dtype))

    def _inside(self, lam):
        return (lam >= self.Emin) & (lam <= self.Emax)

    def _key(self, lam):
        return lam


class FeastHRCI(FeastSRCI):
    """Complex-Hermitian RCI (the reference's feast_hrci!).

    The same protocol on complex data; each node's SOLVE is followed by
    FACTORIZE_TRANSPOSE and SOLVE_TRANSPOSE: overwrite ``state.workc``
    with (Ze B - A)^-H workc (the adjoint solve on the same
    factorization)."""

    _complex = True
    _adj = False       # the next SOLVE of a node is its adjoint one

    @staticmethod
    def _seeded(N, M0):
        rng = np.random.default_rng((N * 1000003 + M0 * 101 + 1)
                                    % (2**31 - 1))
        Q = rng.standard_normal((N, M0)).astype(complex)
        return Q / np.linalg.norm(Q, axis=0, keepdims=True)

    def step(self) -> FeastRCIJob:
        if self.phase == "factorize_adj":
            self.workc = self._rhs()
            self.phase = "solve"
            return FeastRCIJob.SOLVE_TRANSPOSE
        if self.phase == "solve":
            W = complex(self.contour.Wne[self.e])
            if not self._adj:
                self._Qproj += W * self._work()
                self._adj = True
                self.phase = "factorize_adj"
                self._mirror_fpm()
                # announce the adjoint factorization (Ze B - A)^H; a caller
                # that solves with the plain one transposed may do nothing
                return FeastRCIJob.FACTORIZE_TRANSPOSE
            self._Qproj += W.conjugate() * self._work()
            self._adj = False
            return self._next_node()
        return super().step()


class FeastGRCI(_RCIBase):
    """General non-Hermitian RCI (the reference's feast_grci!): the full
    contour, complex Ritz values, membership of the rotated ellipse
    (Emid, r, fpm[18], fpm[19]); ``bilinear``: the transpose pairing of a
    complex-symmetric problem. The caller's services are FeastSRCI's on
    complex data."""

    def __init__(self, N, M0, Emid, r, fpm=None, *, Q0=None,
                 standard_B=False, bilinear=False, device=None):
        fpm = _ensure_fpm(fpm)
        contour = feast_get_custom_contour(fpm) or feast_gcontour(
            complex(Emid), float(r), fpm)
        self.Emid, self.r = complex(Emid), float(r)
        self.aspect = fpm[18] / 100.0
        self.rot = fpm[19]
        self.bilinear = bilinear
        super().__init__(N, M0, fpm, contour, Q0, _seeded_complex(N, M0),
                         standard_B, device)

    def _node_weight(self):
        return complex(self.contour.Wne[self.e])

    def _pair(self, U):
        return U.mT if self.bilinear else U.mH

    def _rr(self, AU, G):
        m = self._mask
        marker = self.Emid + 3.0 * self.r
        S = (self._pair(self._U) @ AU).cpu().numpy() \
            + marker * np.diag(1 - m)
        G = G.cpu().numpy() + np.diag(1 - m)
        lam, V = sla.eig(S, G)
        self.lam = lam
        self.q = _normalized(self._U @ self._tensor(V))

    def _inside(self, lam):
        w = (lam - self.Emid) * np.exp(-1j * self.rot / 180.0 * np.pi)
        return (w.real / self.r) ** 2 + (w.imag / (self.r * self.aspect)) \
            ** 2 <= 1.0

    def _key(self, lam):
        return np.abs(lam) ** 2


class FeastPRCI(FeastSRCI):
    """Parallel (batch) real-symmetric RCI (the reference's
    ParallelFeastState + pfeast_srci!): one PARALLEL_SOLVE per sweep hands
    the caller every node at once. Read ``state.Zall`` (ne,) and
    ``state.workc`` (N, M0), solve (Zall[e] B - A) X_e = workc for every e
    (in parallel, however the caller likes) and assign the stack to
    ``state.Xall`` (ne, N, M0); the machine then accumulates (the
    PARALLEL_ACCUMULATE step, emitted for observability) and goes on with
    the MULT_A / MULT_B jobs of Rayleigh-Ritz."""

    def _start_sweep(self):
        self.Zall = np.asarray(self.contour.Zne, complex)
        self.workc = self._rhs()
        self.Xall = None
        self.phase = "psolve"
        self._mirror_fpm()
        return FeastRCIJob.PARALLEL_SOLVE

    def step(self) -> FeastRCIJob:
        if self.phase == "psolve":
            if self.Xall is None:
                raise ValueError(
                    "PARALLEL_SOLVE not serviced: assign state.Xall "
                    "(ne, N, M0) before calling step() again")
            self.Xall = self._tensor(self.Xall)
            shape = tuple(self.Xall.shape)
            if shape != (self.contour.ne, self.N, self.M0):
                raise ValueError(
                    f"state.Xall must be (ne={self.contour.ne}, N={self.N}, "
                    f"M0={self.M0}), got {shape}")
            self.e = self.contour.ne
            self._mirror_fpm()
            self.phase = "paccum"
            return FeastRCIJob.PARALLEL_ACCUMULATE

        if self.phase == "paccum":
            W = self._tensor(2.0 * np.asarray(self.contour.Wne, complex))
            self._Qproj = torch.einsum("e,enm->nm", W, self.Xall)
            self.Xall = None
            return self._after_sweep()

        return super().step()


class FeastPolyRCI:
    """Polynomial RCI (the reference's _feast_poly_grci! and
    feast_srcipev! / grcipev!): the moment (Beyn) scheme on the
    polynomial resolvent.

        state = FeastPolyRCI(N, d, M0, Emid, r, fpm)
        job = state.step()                     # FACTORIZE with state.Ze
        while job != FeastRCIJob.DONE:
            if job == FeastRCIJob.FACTORIZE:   # factorize P(state.Ze)
                ...
            elif job == FeastRCIJob.SOLVE:     # workc <- P(Ze)^-1 workc
                state.workc = my_solve(state.Ze, state.workc)
            elif job == FeastRCIJob.MULT_A:    # workc[:, j] <- P(lam[j]) q[:, j]
                state.workc = apply_P_columns(state.lam, state.q)
            job = state.step()

    The machine accumulates the moments A0 = sum w_e Y_e and A1 = sum w_e
    z_e Y_e over the full contour (at least 32 nodes), deflates A0 by its
    SVD (cut 1e-2 of the largest singular value), solves the small Beyn
    problem on the host and measures residuals through the caller's
    P(lam_j) q_j products. M0 is clamped to N."""

    def __init__(self, N, d, M0, Emid, r, fpm=None, *, Q0=None,
                 device=None):
        fpm = _ensure_fpm(fpm)
        if fpm[8] < 32:
            fpm = fpm.copy()
            fpm[8] = 32     # the Beyn scheme's accuracy is its quadrature's
        self.contour = (feast_get_custom_contour(fpm)
                        or feast_gcontour(complex(Emid), float(r), fpm))
        self.N, self.d, self.M0 = int(N), int(d), min(int(M0), int(N))
        self.fpm = fpm
        self.device = resolve_device(device)
        self.Emid, self.r = complex(Emid), float(r)
        self.aspect = fpm[18] / 100.0
        self.tol = feast_tolerance(fpm, np.float64)
        self.max_loops = fpm[4]
        self.loop = 0
        self.e = 0
        self.info = FeastError.SUCCESS
        self.M = 0
        self.epsout = np.inf
        self.lam = None
        self.q = None
        self.res = None
        V = np.asarray(Q0, complex) if fpm[5] == 1 and Q0 is not None \
            else _seeded_complex(N, M0)
        self.V = torch.as_tensor(V).to(self.device)
        self.phase = "init"
        self._rank_cut = 1e-2       # the quadrature-leakage cut

    _mirror_fpm = _RCIBase._mirror_fpm
    _tensor = _RCIBase._tensor
    _work = _RCIBase._work

    def _emit_factorize(self):
        self.Ze = complex(self.contour.Zne[self.e])
        self.phase = "factorize"
        self._mirror_fpm()
        return FeastRCIJob.FACTORIZE

    def _start_sweep(self):
        self._A0 = torch.zeros((self.N, self.M0), dtype=torch.complex128,
                               device=self.device)
        self._A1 = torch.zeros_like(self._A0)
        self.e = 0
        return self._emit_factorize()

    def _inside(self, lam):
        w = lam - self.Emid
        return ((w.real / self.r) ** 2
                + (w.imag / (self.r * self.aspect)) ** 2) <= 1.0

    def step(self) -> FeastRCIJob:
        if self.phase == "init":
            return self._start_sweep()

        if self.phase == "factorize":
            self.workc = self.V.clone()
            self.phase = "solve"
            return FeastRCIJob.SOLVE

        if self.phase == "solve":
            w = complex(self.contour.Wne[self.e])
            z = complex(self.contour.Zne[self.e])
            Y = self._work()
            self._A0 += w * Y
            self._A1 += (w * z) * Y
            self.e += 1
            self._mirror_fpm()
            if self.e < self.contour.ne:
                return self._emit_factorize()
            # the Beyn pencil on the moments; the thin SVD of A0 as QR and
            # the SVD of its small factor
            Qq, R = torch.linalg.qr(self._A0, mode="reduced")
            Ur, s, Wh = torch.linalg.svd(R)
            U = Qq @ Ur
            s = s.cpu().numpy()
            m = (s >= self._rank_cut * s[0]).astype(float)
            s_inv = np.where(m > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)
            Bred = (U.mH @ self._A1 @ Wh.mH).cpu().numpy() * s_inv[None, :]
            marker = self.Emid + 3.0 * self.r
            Bred = Bred * (m[:, None] * m[None, :]) \
                + marker * np.diag(1.0 - m)
            lam, Sv = np.linalg.eig(Bred)
            self.lam = lam
            self.q = _normalized(U @ self._tensor(Sv))
            self.workc = None
            self.phase = "mult_p"
            return FeastRCIJob.MULT_A

        if self.phase == "mult_p":
            # the caller's P(lam_j) q_j columns
            res = (torch.linalg.vector_norm(self._work(), dim=0).cpu().numpy()
                   / np.maximum(np.abs(self.lam), 1.0))
            inside = self._inside(self.lam)
            order = np.lexsort((np.abs(self.lam) ** 2, ~inside * 1))
            self.lam = self.lam[order]
            self.q = self.q[:, torch.as_tensor(order, device=self.device)]
            self.res = res[order]
            plausible = inside[order] & (self.res < 0.1)
            self.M = int(plausible.sum())
            self.inside = plausible
            self.epsout = (float(np.max(np.where(plausible, self.res, 0.0)))
                           if self.M else np.inf)
            self.loop += 1
            self._mirror_fpm()
            if self.epsout <= self.tol and self.M > 0:
                self.phase = "done"
                return FeastRCIJob.DONE
            if self.loop > self.max_loops:
                self.info = FeastError.NO_CONVERGENCE
                self.phase = "done"
                self._mirror_fpm()
                return FeastRCIJob.DONE
            self.V = self.q.clone()
            return self._start_sweep()

        return FeastRCIJob.DONE
