"""Legacy FEAST_* constant bindings (PyTorch port; parity:
src/deprecations.jl).

A copy of ``feastkit_tpu/deprecations.py``: the Feast_* names bound to the
port's ``core/types.FeastError`` and ``FeastRCIJob``, and the legacy
SCREAMING_CASE spellings resolved by the module's ``__getattr__`` with a
DeprecationWarning.
"""
from __future__ import annotations

import warnings

from .core.types import FeastError, FeastRCIJob

Feast_SUCCESS = FeastError.SUCCESS
Feast_ERROR_N = FeastError.ERROR_N
Feast_ERROR_M0 = FeastError.ERROR_M0
Feast_ERROR_EMIN_EMAX = FeastError.ERROR_EMIN_EMAX
Feast_ERROR_EMID_R = FeastError.ERROR_EMID_R
Feast_ERROR_NO_CONVERGENCE = FeastError.NO_CONVERGENCE
Feast_ERROR_MEMORY = FeastError.MEMORY
Feast_ERROR_INTERNAL = FeastError.INTERNAL_ERROR_1
Feast_ERROR_PROBLEM_SIZE = FeastError.PROBLEM_SIZE

Feast_RCI_DONE = FeastRCIJob.DONE
Feast_RCI_INIT = FeastRCIJob.INIT
Feast_RCI_FACTORIZE = FeastRCIJob.FACTORIZE
Feast_RCI_SOLVE = FeastRCIJob.SOLVE
Feast_RCI_FACTORIZE_TRANSPOSE = FeastRCIJob.FACTORIZE_TRANSPOSE
Feast_RCI_SOLVE_TRANSPOSE = FeastRCIJob.SOLVE_TRANSPOSE
Feast_RCI_MULT_A = FeastRCIJob.MULT_A
Feast_RCI_MULT_B = FeastRCIJob.MULT_B

_LEGACY = {name.replace("Feast_", "FEAST_", 1): value
           for name, value in dict(globals()).items()
           if name.startswith("Feast_")}


def __getattr__(name):
    if name in _LEGACY:
        warnings.warn(f"{name} is deprecated; use "
                      f"{name.replace('FEAST_', 'Feast_', 1)}",
                      DeprecationWarning, stacklevel=2)
        return _LEGACY[name]
    raise AttributeError(name)
