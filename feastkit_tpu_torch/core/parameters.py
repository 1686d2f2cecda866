"""The 64-slot ``fpm`` FEAST parameter contract (PyTorch port).

A copy of ``feastkit_tpu/core/parameters.py``, kept in the port so that it
imports nothing of the JAX package: the same sentinel (-111) "unset"
convention, the same defaulting and validation rules, and a typed
:class:`FeastConfig` veneer used internally by the port's solvers.

Slot numbering is **1-based** to match every piece of FEAST documentation
(Fortran, Julia reference, and this repo's SURVEY.md): ``fpm[2]`` is the
half-contour node count, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

FEAST_UNINITIALIZED = -111

# Allowed large Gauss node counts (feast_parameters.jl:113, :173)
_ALLOWED_LARGE_HALF = (24, 32, 40, 48, 56)
_ALLOWED_LARGE_FULL = (48, 64, 80, 96, 112)


class FeastParameters:
    """1-based view over a 64-slot int array, mirroring the Julia wrapper
    ``FeastParameters`` (feast_types.jl) that forwards indexing to ``fpm``."""

    __slots__ = ("_fpm",)

    def __init__(self, fpm=None):
        if fpm is None:
            self._fpm = np.full(64, FEAST_UNINITIALIZED, dtype=np.int64)
        elif isinstance(fpm, FeastParameters):
            self._fpm = fpm._fpm.copy()
        else:
            arr = np.asarray(fpm, dtype=np.int64)
            if arr.shape[0] < 64:
                raise ValueError("fpm array must have at least 64 elements")
            self._fpm = arr[:64].copy()

    def __getitem__(self, k: int) -> int:
        if not 1 <= k <= 64:
            raise IndexError(f"fpm index must be in 1..64, got {k}")
        return int(self._fpm[k - 1])

    def __setitem__(self, k: int, v: int) -> None:
        if not 1 <= k <= 64:
            raise IndexError(f"fpm index must be in 1..64, got {k}")
        self._fpm[k - 1] = int(v)

    def __len__(self) -> int:
        return 64

    def __eq__(self, other) -> bool:
        if isinstance(other, FeastParameters):
            return bool(np.array_equal(self._fpm, other._fpm))
        return NotImplemented

    def copy(self) -> "FeastParameters":
        return FeastParameters(self._fpm)

    def to_array(self) -> np.ndarray:
        """Export the raw 64-int array (0-based numpy; slot k is index k-1)."""
        return self._fpm.copy()

    def __repr__(self) -> str:
        set_slots = {
            k + 1: int(v) for k, v in enumerate(self._fpm)
            if v != FEAST_UNINITIALIZED
        }
        return f"FeastParameters({set_slots})"


def feastinit(fpm: FeastParameters | None = None) -> FeastParameters:
    """Fill all 64 slots with the -111 sentinel (feast_parameters.jl:7-18)."""
    if fpm is None:
        fpm = FeastParameters()
    fpm._fpm[:] = FEAST_UNINITIALIZED
    return fpm


def feastinit_driver(N: int, fpm: FeastParameters | None = None
                     ) -> FeastParameters:
    """feastinit and the suggested node count ne = clamp(ceil(sqrt(N)), 8,
    64) in fpm[2] (feast_parameters.jl:26-34)."""
    fpm = feastinit(fpm)
    if N > 0:
        fpm[2] = int(np.clip(np.ceil(np.sqrt(float(N))), 8, 64))
    return fpm


def _decode_routine_digits(code: int) -> list[int]:
    """fpm[30] six-digit routine code -> digit list d1..d6
    (feast_parameters.jl:49-60). d1: 1=FEAST 2=PFEAST; d2: precision;
    d3: 1=direct 2=iterative; d4: 1=S 2=H 3=G; d5: interface; d6: variant."""
    dig = [0] * 6
    if code > 0:
        rem = code
        for i in range(6):
            dig[5 - i] = rem % 10
            rem //= 10
    return dig


def feastdefault(fpm: FeastParameters) -> FeastParameters:
    """Apply Fortran-matching defaults/validation to still-sentinel slots.

    Semantics of feastdefault! (feast_parameters.jl:41-386): only slots that
    are still -111 (or 0/negative where the reference treats that as unset)
    are overwritten; invalid user-set values raise ValueError.
    """
    f = fpm  # alias
    dig = _decode_routine_digits(f[30] if f[30] != FEAST_UNINITIALIZED else 0)

    # fpm[1]: print level
    if f[1] == FEAST_UNINITIALIZED:
        f[1] = 0
    elif f[1] > 1:
        raise ValueError(f"Invalid fpm[1]={f[1]}: print level must be 0, 1, or negative")

    # fpm[14]: execution mode (0 normal, 1 subspace only, 2 stochastic estimate)
    if f[14] == FEAST_UNINITIALIZED:
        f[14] = 0
    elif not 0 <= f[14] <= 2:
        raise ValueError(f"Invalid fpm[14]={f[14]}: must be 0, 1, or 2")

    # fpm[16]: quadrature (0 Gauss, 1 trapezoid, 2 Zolotarev); defaults depend
    # on problem class (feast_parameters.jl:77-99)
    if f[16] == FEAST_UNINITIALIZED:
        f[16] = 0
        if dig[2] == 2:          # IFEAST
            f[16] = 1
        if dig[3] == 3:          # general non-symmetric
            f[16] = 1
        if dig[3] == 1 and dig[1] == 4:  # complex symmetric
            f[16] = 1
    elif not 0 <= f[16] <= 2:
        raise ValueError(f"Invalid fpm[16]={f[16]}: must be 0, 1, or 2")
    if f[16] == 2 and (dig[3] == 3 or (dig[3] == 1 and dig[1] == 4)):
        raise ValueError("Invalid fpm[16]=2: Zolotarev not allowed for non-Hermitian problems")

    # fpm[2]: half-contour node count
    if f[2] == FEAST_UNINITIALIZED or f[2] <= 0:
        f[2] = 8
        if dig[2] == 2:
            f[2] = 4
        if f[14] == 2:
            f[2] = 3
    elif f[16] in (0, 2) and f[2] > 20 and f[2] not in _ALLOWED_LARGE_HALF:
        raise ValueError(
            f"Invalid fpm[2]={f[2]}: max 20 for Gauss/Zolotarev, or one of {_ALLOWED_LARGE_HALF}")

    # fpm[3]: tolerance exponent
    if f[3] == FEAST_UNINITIALIZED:
        f[3] = 12
    elif not 0 <= f[3] <= 16:
        raise ValueError(f"Invalid fpm[3]={f[3]}: must be between 0 and 16")

    # fpm[4]: max refinement loops
    if f[4] == FEAST_UNINITIALIZED or f[4] <= 0:
        f[4] = 20
        if dig[2] == 2:
            f[4] = 50
    # fpm[5]: initial subspace flag
    if f[5] == FEAST_UNINITIALIZED:
        f[5] = 0
    elif f[5] not in (0, 1):
        raise ValueError(f"Invalid fpm[5]={f[5]}: must be 0 or 1")
    # fpm[6]: convergence criterion (0 trace, 1 residual)
    if f[6] == FEAST_UNINITIALIZED:
        f[6] = 1
    elif f[6] not in (0, 1):
        raise ValueError(f"Invalid fpm[6]={f[6]}: must be 0 or 1")
    # fpm[7]: deprecated single-precision exponent
    if f[7] == FEAST_UNINITIALIZED:
        f[7] = 5
    elif not 0 <= f[7] <= 7:
        raise ValueError(f"Invalid fpm[7]={f[7]}: must be between 0 and 7")

    # fpm[8]: full-contour node count
    if f[8] == FEAST_UNINITIALIZED or f[8] <= 0:
        f[8] = 16
        if dig[2] == 2:
            f[8] = 8
        if f[14] == 2:
            f[8] = 6
    elif f[8] < 2:
        raise ValueError(f"Invalid fpm[8]={f[8]}: must be at least 2")
    elif f[16] == 0 and f[8] > 40 and f[8] not in _ALLOWED_LARGE_FULL:
        raise ValueError(
            f"Invalid fpm[8]={f[8]}: max 40 for Gauss, or one of {_ALLOWED_LARGE_FULL}")

    if f[9] == FEAST_UNINITIALIZED:
        f[9] = 0
    # fpm[10]: store factorizations
    if f[10] == FEAST_UNINITIALIZED:
        f[10] = 0 if dig[4] == 1 else 1
    elif f[10] not in (0, 1):
        raise ValueError(f"Invalid fpm[10]={f[10]}: must be 0 or 1")
    for i in (11, 12):
        if f[i] == FEAST_UNINITIALIZED:
            f[i] = 0
    # fpm[13]: RCI customization
    if f[13] == FEAST_UNINITIALIZED:
        f[13] = 0
    elif not 0 <= f[13] <= 3:
        raise ValueError(f"Invalid fpm[13]={f[13]}: must be 0..3")

    # fpm[15]: contour scheme
    if f[15] == FEAST_UNINITIALIZED:
        f[15] = 2 if dig[3] == 1 else 0
    elif not 0 <= f[15] <= 2:
        raise ValueError(f"Invalid fpm[15]={f[15]}: must be 0, 1, or 2")
    if f[14] == 2:
        f[15] = 1

    if f[17] == FEAST_UNINITIALIZED:
        f[17] = 0

    # fpm[18]: ellipse aspect ratio * 100
    if f[18] == FEAST_UNINITIALIZED:
        f[18] = 100
        if dig[2] == 1 and dig[5] <= 5:
            if dig[3] == 2:      # Hermitian
                f[18] = 30
            if dig[3] == 1 and dig[1] not in (3, 4):  # real symmetric
                f[18] = 30
    elif f[18] < 0:
        raise ValueError(f"Invalid fpm[18]={f[18]}: aspect ratio must be non-negative")

    # fpm[19]: rotation degrees
    if f[19] == FEAST_UNINITIALIZED:
        f[19] = 0
    elif not -180 <= f[19] <= 180:
        raise ValueError(f"Invalid fpm[19]={f[19]}: must be in [-180, 180]")

    for i in range(20, 29):
        if f[i] == FEAST_UNINITIALIZED:
            f[i] = 0
    if f[29] == FEAST_UNINITIALIZED:
        f[29] = 0
    if f[31] == FEAST_UNINITIALIZED:
        f[31] = 40
    if f[32] == FEAST_UNINITIALIZED:
        f[32] = 10
    for i in (33, 34, 35):
        if f[i] == FEAST_UNINITIALIZED:
            f[i] = 0
    if f[36] == FEAST_UNINITIALIZED:
        f[36] = 1
    if f[37] == FEAST_UNINITIALIZED:
        f[37] = 0
    if f[38] == FEAST_UNINITIALIZED:
        f[38] = 1
    if f[39] == FEAST_UNINITIALIZED:
        f[39] = 0
    if f[40] == FEAST_UNINITIALIZED:
        f[40] = 0
    if f[41] == FEAST_UNINITIALIZED:
        f[41] = 1
    if f[42] == FEAST_UNINITIALIZED:
        f[42] = 1
    if f[43] == FEAST_UNINITIALIZED:
        f[43] = 0
    if f[44] == FEAST_UNINITIALIZED:
        f[44] = 0
    if f[45] == FEAST_UNINITIALIZED:
        f[45] = 1
    if f[46] == FEAST_UNINITIALIZED:
        f[46] = 40
    if f[47] == FEAST_UNINITIALIZED:
        f[47] = 0
    if f[48] == FEAST_UNINITIALIZED:
        f[48] = 0
    if f[49] == FEAST_UNINITIALIZED:
        f[49] = 0
    for i in range(50, 59):
        if f[i] == FEAST_UNINITIALIZED:
            f[i] = 0
    if f[59] == FEAST_UNINITIALIZED:
        f[59] = 0
    if f[60] == FEAST_UNINITIALIZED:
        f[60] = 0
    for i in (61, 62, 63):
        if f[i] == FEAST_UNINITIALIZED:
            f[i] = 0
    if f[64] == FEAST_UNINITIALIZED:
        f[64] = 0
    return f


def feast_tolerance(fpm: FeastParameters, dtype=None) -> float:
    """tol = 10^(-fpm[3]); floored at sqrt(eps) for single precision
    (feast_parameters.jl:391-405)."""
    e = fpm[3]
    tol = 1e-12 if not 0 <= e <= 16 else 10.0 ** (-e)
    if dtype is not None:
        dt = np.dtype(dtype)
        if dt in (np.dtype(np.float32), np.dtype(np.complex64)):
            tol = max(tol, float(np.sqrt(np.finfo(np.float32).eps)))
    return tol


def ifeast_solver_options(fpm: FeastParameters) -> dict | None:
    """IFEAST inner-solver knobs -> driver kwargs (fpm[43]=1 switches to
    IFEAST interfaces; fpm[44] solver type 0=BiCGstab, fpm[45] inner accuracy
    10^-fpm[45], fpm[46] max inner iterations; feast_parameters.jl:321-339).
    Returns None when fpm[43]=0 (direct-FEAST semantics)."""
    if fpm[43] != 1:
        return None
    return {
        "solver": "bicgstab" if fpm[44] == 0 else "gmres",
        "solver_tol": 10.0 ** (-max(fpm[45], 0)),
        "solver_maxiter": max(fpm[46], 1),
    }


def _ensure_fpm(fpm) -> FeastParameters:
    """nothing / list / ndarray / FeastParameters -> defaulted FeastParameters
    (feast_interfaces.jl:6-18 `_ensure_feast_parameters`)."""
    if fpm is None:
        out = feastinit()
    elif isinstance(fpm, FeastParameters):
        out = fpm.copy()
    else:
        out = FeastParameters(fpm)
    feastdefault(out)
    return out


@dataclasses.dataclass(frozen=True)
class FeastConfig:
    """Typed veneer over fpm with the fields the port's solvers read (the
    JAX package's config also carries contour and dispatch fields for
    engines not ported yet). The environment overrides are the JAX
    package's, read when the config is built."""

    tol: float = 1e-12           # 10^-fpm[3], dtype-floored
    max_loops: int = 20          # fpm[4]
    convergence_criterion: int = 1      # fpm[6]: 0 trace, 1 residual
    print_level: int = 0         # fpm[1]
    mode: int = 0                # fpm[14]
    store_factorization: bool = True    # fpm[10]: the direct engines
    #   factor each shifted pencil once per solve (0: on every application)
    mixed: int = 1               # fpm[42]: mixed precision (the f32 rung of
    #   the polynomial filter; c64 Krylov inside a double-precision
    #   iterative refinement in the Krylov engine).
    #   0 = off, 1 = auto (on for CUDA tensors, where the f32 rung halves
    #   the bytes of the bandwidth-bound recurrence; off on the CPU),
    #   2 = force everywhere
    ir_max: int = 5              # max mixed-precision iterative-refinement
    #   steps per contour node (FEAST_IR_MAX); each multiplies the accuracy
    #   by the c64 floor (~2e-5)
    mg_nu_pre: int = 2           # multigrid V-cycle: damped-Jacobi pre-
    mg_nu_post: int = 2          #   and post-smoothing steps, damping and
    mg_omega: float = 0.8        #   V-cycles per preconditioner application
    mg_cycles: int = 1           #   (FEAST_MG_NU_PRE / _NU_POST / _OMEGA /
    #   _CYCLES)
    warm_start: int = 1          # Ritz warm starts of the Krylov solves
    #   (FEAST_WARM_START): X0 = Q diag(1/(z - lam)), kept per column only
    #   where it beats the zero iterate
    adaptive_inner_tol: int = 1  # inexact-FEAST inner tolerances
    #   (FEAST_ADAPTIVE_TOL): loop solves aim at clip(0.1 epsout^2,
    #   solver_tol, 3e-5), the verify pass at 2e-3
    cheb_degree: int = 0         # polynomial-filter degree (FEAST_CHEB_DEGREE):
    #   0 = auto; > 0 fixes the indicator's degree and caps the rational
    #   realization's
    group_max: int = 2           # contour nodes solved together in one
    #   batched Krylov solve (FEAST_GROUP_MAX)
    aspect_ratio: float = 1.0    # fpm[18]/100: the general region's ellipse
    rotation_deg: int = 0        # fpm[19]: and its rotation

    @staticmethod
    def from_fpm(fpm: FeastParameters, dtype=None) -> "FeastConfig":
        return FeastConfig(
            tol=feast_tolerance(fpm, dtype),
            max_loops=fpm[4],
            convergence_criterion=fpm[6],
            print_level=fpm[1],
            mode=fpm[14],
            store_factorization=bool(fpm[10]),
            mixed=int(fpm[42]),
            ir_max=int(os.environ.get("FEAST_IR_MAX", 5)),
            mg_nu_pre=int(os.environ.get("FEAST_MG_NU_PRE", 2)),
            mg_nu_post=int(os.environ.get("FEAST_MG_NU_POST", 2)),
            mg_omega=float(os.environ.get("FEAST_MG_OMEGA", 0.8)),
            mg_cycles=int(os.environ.get("FEAST_MG_CYCLES", 1)),
            warm_start=int(os.environ.get("FEAST_WARM_START", 1)),
            adaptive_inner_tol=int(os.environ.get("FEAST_ADAPTIVE_TOL", 1)),
            cheb_degree=int(os.environ.get("FEAST_CHEB_DEGREE", 0)),
            group_max=int(os.environ.get("FEAST_GROUP_MAX", 2)),
            aspect_ratio=fpm[18] / 100.0,
            rotation_deg=fpm[19],
        )
