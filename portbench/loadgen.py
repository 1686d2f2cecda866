"""The one generator of traffic: it reads a mix from ``traffic/<name>.json``
and drives the port with it.

A mix is a closed loop of solver jobs: ``clients`` callers (one), each
sending its next problem when the last one returns. Set-up builds a pool
of problems from (seed, k) with the configuration's generator, more than
the window can solve at ``solve_floor_s`` seconds a solve, and warms up
on ``warmup_solves`` problems outside the pool. The window hands the port
each pool problem once, as its own scipy CSR object, and runs whole
solves until the window's seconds have passed, the card synchronised at
both ends. Should the pool run out (a port faster than the floor), the
window starts over on copies of the same problems.
"""
from __future__ import annotations

import json
import math
import sys
import time
import traceback
from pathlib import Path

import numpy as np

SUPPORTED = {"loop": ("closed",), "clients": (1,), "q0": ("seeded",)}


def load(root: Path, name: str) -> dict:
    mix = json.loads((Path(root) / "portbench" / "traffic"
                      / f"{name}.json").read_text())
    for key, allowed in SUPPORTED.items():
        if mix[key] not in allowed:
            raise ValueError(f"traffic {name}: {key} = {mix[key]!r}; this "
                             f"generator drives {allowed}")
    return mix


def pool_size(mix: dict, seconds: float) -> int:
    return int(math.ceil(seconds / float(mix["solve_floor_s"]))) + 1


def build_pool(cfg: dict, generator, mix: dict, seed: int,
               seconds: float) -> list:
    return [generator.build(cfg, seed, k)
            for k in range(pool_size(mix, seconds))]


def build_warmup(cfg: dict, generator, mix: dict, seed: int,
                 seconds: float) -> list:
    first = pool_size(mix, seconds)
    return [generator.build(cfg, seed, first + i)
            for i in range(int(mix["warmup_solves"]))]


def fpm_for(ft, cfg: dict, mix: dict):
    """The configuration's FEAST parameters, fpm[5] = 0: the port draws its
    own seeded Q0 (``q0`` = "seeded")."""
    fpm = ft.feastinit()
    for slot, value in cfg.get("fpm", {}).items():
        fpm[int(slot)] = value
    fpm[5] = 0
    return fpm


def solve(ft, problem: dict, fpm, *, device, precision=None, A=None,
          label=None) -> dict:
    """One call of ``feast`` on the problem; the record the reference
    judges later: count, status, loops, eigenvalues, and the eigenvectors
    on the host. An exception is recorded, never raised."""
    A = problem["A"] if A is None else A
    B = problem["B"]
    if precision is not None:
        A = A.astype(precision)
        B = None if B is None else B.astype(precision)
    rec = dict(problem=problem)
    t0 = time.perf_counter()
    try:
        r = ft.feast(A, B, problem["interval"], problem["M0"], fpm.copy(),
                     device=device)
        rec.update(M=int(r.M), info=int(r.info), loop=int(r.loop),
                   lam=np.asarray(r.lam), q=r.q.cpu().numpy())
    except Exception:  # noqa: BLE001 - a failed solve is counted, not fatal
        rec.update(error=traceback.format_exc())
        print(f"solve {label} raised:\n{rec['error']}", file=sys.stderr,
              flush=True)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def run_window(ft, pool: list, fpm, seconds: float, *, device, sync,
               span=None, precision=None) -> dict:
    """The closed loop: whole solves until ``seconds`` have passed since
    the first one started. Returns the records and the window's edges on
    the host clock (perf_counter)."""
    records = []
    sync()
    t0 = time.perf_counter()
    k = 0
    while True:
        problem = pool[k % len(pool)]
        A = problem["A"] if k < len(pool) else problem["A"].copy()
        if span is None:
            rec = solve(ft, problem, fpm, device=device, A=A,
                        precision=precision, label=k)
        else:
            with span("solve"):
                rec = solve(ft, problem, fpm, device=device, A=A,
                            precision=precision, label=k)
        records.append(rec)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    t1 = time.perf_counter()
    return dict(records=records, start=t0, end=t1)
