"""Profiling and benchmarking helpers (PyTorch port).

Counterpart of ``feastkit_tpu/utils/profiling.py`` (the reference's
@elapsed printers: pfeast_benchmark feast_parallel.jl:754-805,
feast_parallel_comparison feast_mpi_interface.jl:181-249): per-phase wall
timers under the fpm[1] print level, a benchmark that synchronises the
card, a ``torch.profiler`` trace in place of ``jax.profiler`` (with the
port's own spans beside it, ``utils/trace``), and the serial / sharded
comparison.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from . import trace

__all__ = ["phase_timer", "FeastTimer", "trace_to", "feast_benchmark",
           "feast_parallel_comparison"]


class FeastTimer:
    """Accumulates named phase timings (wall clock)."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) \
                + (time.perf_counter() - t0)

    def report(self, file=None):
        import sys
        file = file or sys.stdout
        total = sum(self.phases.values())
        print("FEAST phase timings:", file=file)
        for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * v / total if total else 0.0
            print(f"  {k:<24} {v:9.4f} s  ({pct:5.1f}%)", file=file)
        print(f"  {'total':<24} {total:9.4f} s", file=file)
        return self.phases


@contextlib.contextmanager
def phase_timer(name: str, *, print_level: int = 1, file=None):
    """One-off timer, silent under print level 0 (the fpm[1] contract)."""
    import sys
    file = file or sys.stdout
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if print_level > 0:
            print(f"[feast] {name}: {time.perf_counter() - t0:.4f} s",
                  file=file)


@contextlib.contextmanager
def trace_to(logdir: str):
    """A ``torch.profiler`` trace of the block, CPU and (with a card) CUDA
    activities, written as a Chrome trace (``trace.json``) into
    ``logdir``, and the port's own spans of the block (``utils/trace``,
    turned on for it) as ``spans.json`` beside it: each span's index,
    name, start and end in ns on the Unix-epoch clock (``time.time_ns()``),
    the index of its parent, its solve's id and its attributes (where
    tracing was off before the block, its spans are then forgotten). The
    profiler is yielded (``key_averages()`` sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on, first = trace.enabled(), trace.mark()
    trace.enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
            _sync()
    finally:
        block = [s.as_dict() for s in trace.since(first)]
        if not was_on:
            # the block's spans go with it where tracing was off before
            trace.disable()
            trace.drop_since(first)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"clock": "time.time_ns(): ns since the Unix epoch",
                   "spans": block}, f)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def feast_benchmark(fn, *args, warmup: int = 1, repeats: int = 3,
                    **kw) -> dict:
    """Min / mean wall time of fn(*args, **kw), the card synchronised after
    each call (pfeast_benchmark)."""
    for _ in range(warmup):
        fn(*args, **kw)
        _sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        times.append(time.perf_counter() - t0)
    return {"min_s": min(times), "mean_s": sum(times) / len(times),
            "repeats": repeats}


def feast_parallel_comparison(A, B, interval, M0, fpm=None, file=None,
                              **kw) -> dict:
    """Serial against sharded wall clock on the same problem
    (feast_parallel_comparison, feast_mpi_interface.jl:181-249). On one
    rank the sharded request warns and runs serially, as ``feast`` does;
    on two or more every rank must call it (``parallel/pfeast.py``).
    ``kw`` goes to ``feast`` (``device=``)."""
    import sys
    from ..interfaces.feast import feast
    file = file or sys.stdout
    out = {}
    for backend in ("serial", "sharded"):
        _sync()
        t0 = time.perf_counter()
        r = feast(A, B, interval, M0, fpm, backend=backend, **kw)
        _sync()
        out[backend] = {"time_s": time.perf_counter() - t0, "M": r.M,
                        "epsout": r.epsout, "loops": r.loop}
    s, p = out["serial"]["time_s"], out["sharded"]["time_s"]
    out["speedup"] = s / p if p > 0 else float("inf")
    print(f"serial {s:.4f} s vs sharded {p:.4f} s -> speedup "
          f"{out['speedup']:.2f}x", file=file)
    return out
