"""Custom-contour registry (PyTorch port).

A copy of the registry half of ``feastkit_tpu/core/aux.py``: a contour
registered under an id that lives in fpm[29], so copying fpm keeps the
association. The auto route of the sparse driver reads it
(``feast_get_custom_contour``) before it builds the default contour.
"""
from __future__ import annotations

import threading

import numpy as np

from .parameters import FeastParameters
from .types import Contour

__all__ = ["feast_set_custom_contour", "feast_get_custom_contour",
           "feast_clear_custom_contour"]

_CUSTOM_CONTOURS: dict[int, Contour] = {}
_REGISTRY_LOCK = threading.Lock()
_NEXT_ID = [1]


def feast_set_custom_contour(fpm, contour: Contour) -> int:
    """Register a contour; stores its id in fpm[29] and returns the id."""
    fpm = fpm if isinstance(fpm, FeastParameters) else FeastParameters(fpm)
    with _REGISTRY_LOCK:
        cid = _NEXT_ID[0]
        _NEXT_ID[0] += 1
        _CUSTOM_CONTOURS[cid] = Contour(np.asarray(contour.Zne, complex),
                                        np.asarray(contour.Wne, complex))
    fpm[29] = cid
    return cid


def feast_get_custom_contour(fpm) -> Contour | None:
    fpm = fpm if isinstance(fpm, FeastParameters) else FeastParameters(fpm)
    cid = fpm[29]
    if cid <= 0:
        return None
    with _REGISTRY_LOCK:
        return _CUSTOM_CONTOURS.get(cid)


def feast_clear_custom_contour(fpm) -> None:
    fpm = fpm if isinstance(fpm, FeastParameters) else FeastParameters(fpm)
    cid = fpm[29]
    with _REGISTRY_LOCK:
        _CUSTOM_CONTOURS.pop(cid, None)
    fpm[29] = 0
