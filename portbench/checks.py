"""What decides ``correct``: every solve of the window judged by the
configuration's plain reference once the window has closed, and the guard
against the JAX package.

Numbers compared, each with its limit from the configuration's file:
``failed`` (solves that raised, returned info != 0 or a count M other than
the exact one), ``eig_err`` (the largest |lambda_i - exact_i| of a solve,
both sorted, absolute; where the count is wrong, the largest distance of a
returned eigenvalue to the nearest exact one), ``res_max`` (the largest relative
residual ||A x - lambda B x|| / (max(|lambda|, 1) ||x||) that the
reference computes for a returned pair).
"""
from __future__ import annotations

import math
import sys

import numpy as np

from .reference.common import eigenvalue_error, nearest_error

FORBIDDEN = ("jax", "jaxlib", "flax", "feastkit_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is the JAX stack's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in modules}
                  & set(FORBIDDEN))


def judge(reference, cfg: dict, records: list) -> dict:
    """The numbers compared, each with its value and its limit."""
    limits = cfg["limits"]
    failed = 0
    eig_err = res_max = 0.0
    for rec in records:
        prob = rec["problem"]
        if "error" in rec:
            failed += 1
            continue
        Emin, Emax = prob["interval"]
        spectrum = reference.exact_eigenvalues(prob["inputs"], -math.inf,
                                               math.inf, cfg["lowest_1d"])
        inside = spectrum[(spectrum >= Emin) & (spectrum <= Emax)]
        if rec["info"] != 0 or rec["M"] != len(inside):
            failed += 1
        if rec["M"]:
            eig_err = max(eig_err, eigenvalue_error(rec["lam"], inside)
                          if rec["M"] == len(inside)
                          else nearest_error(rec["lam"], spectrum))
            res = reference.residuals(prob["inputs"], rec["lam"], rec["q"])
            res_max = max(res_max, float(np.max(res)) if np.all(
                np.isfinite(res)) else math.inf)
    return {"failed": dict(value=failed, limit=limits["failed"]),
            "eig_err": dict(value=eig_err, limit=limits["eig_err"]),
            "res_max": dict(value=res_max, limit=limits["res_max"])}


def passes(numbers: dict, attempted: int) -> bool:
    """Every number at or under its limit (NaN fails), and a solve made."""
    return attempted > 0 and all(
        n["limit"] is not None and n["value"] <= n["limit"]
        for n in numbers.values())
