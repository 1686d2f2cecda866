"""Checkpoint / resume for FEAST runs (PyTorch port).

A copy of ``feastkit_tpu/utils/checkpoint.py`` with the same ``.npz``
layout (Q, fpm, loop, region, kind, lam, res), so a checkpoint written by
either package resumes in the other. A checkpoint is the restart basis,
the loop counter and fpm; a resume warm-starts any driver with fpm[5] = 1
and Q0 = the saved basis (feast_kernel.jl:67-79). The result's buffers
may live on the card: they are copied to the host before they are
written.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.parameters import FeastParameters, _ensure_fpm

__all__ = ["FeastCheckpoint", "save_checkpoint", "load_checkpoint",
           "resume_kwargs"]


@dataclasses.dataclass
class FeastCheckpoint:
    Q: np.ndarray          # (N, M0) current subspace (the restart basis)
    fpm: np.ndarray        # 64-slot parameter array (with counters 50-53)
    loop: int              # refinement loops completed
    region: tuple          # (Emin, Emax) or (Emid_re, Emid_im, r)
    kind: str              # 'interval' | 'general'
    lam: np.ndarray | None = None
    res: np.ndarray | None = None


def _host(X) -> np.ndarray:
    if hasattr(X, "detach"):
        X = X.detach().cpu().numpy()
    return np.asarray(X)


def _full(result, name):
    full = getattr(result, f"{name}_full")
    return _host(full if full is not None else getattr(result, name))


def save_checkpoint(path, result, fpm, region, kind="interval") -> None:
    """Write a FeastResult / FeastGeneralResult's checkpoint to ``path``
    (the full M0-column buffers, so the restart keeps every slot)."""
    fpm = _ensure_fpm(fpm)
    np.savez(path, Q=_full(result, "q"), fpm=fpm.to_array(),
             loop=np.int64(result.loop), region=np.asarray(region, float),
             kind=np.str_(kind), lam=_full(result, "lam"),
             res=_full(result, "res"))


def load_checkpoint(path) -> FeastCheckpoint:
    with np.load(path, allow_pickle=False) as z:
        return FeastCheckpoint(
            Q=z["Q"], fpm=z["fpm"], loop=int(z["loop"]),
            region=tuple(z["region"].tolist()), kind=str(z["kind"]),
            lam=z["lam"], res=z["res"])


def resume_kwargs(ckpt: FeastCheckpoint) -> dict:
    """Driver keywords of the fpm[5] = 1 warm start: ``fpm`` and ``Q0``.
    Every driver takes them (dense, dense general, sparse, sparse general,
    banded, matrix-free, polynomial: an (N, M0) basis is lifted into the
    companion space by tiling); a driver ignores a Q0 under fpm[5] = 0."""
    fpm = FeastParameters(ckpt.fpm)
    fpm[5] = 1
    return {"fpm": fpm, "Q0": ckpt.Q}
