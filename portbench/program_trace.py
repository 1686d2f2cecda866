"""The program's own spans and counters in a traced run, for the per-layer
metrics that read them (``feastkit_tpu_torch/utils/trace.py``).

Importing this module turns the program's tracing on. The harness loads
per-layer readers only for a ``--trace 1`` run, and before its warm-up,
so a run with ``--trace 0`` never traces. Where the program has no such
module (a checkout older than it), nothing is turned on and every reader
returns None.

The program stamps its spans with ``time.time_ns()``, the clock of the
benchmark's own spans, so the traced run's ``offset_ns`` places both on
the device trace's clock. The window's solves are the program's ``feast``
spans that lie inside the benchmark's ``solve`` spans. Each idle stretch
of the device (the window less the union of its activities) inside a
solve belongs to the innermost program span open then, split where it
straddles a span's edge.
"""
from __future__ import annotations

import bisect
import sys

from portbench.tracing import union

try:
    from feastkit_tpu_torch.utils import trace as program
except ImportError:
    program = None
else:
    program.enable()

_KEY = "program_trace"


class Busy:
    """The device's busy time inside any stretch of the trace's clock."""

    def __init__(self, intervals):
        self.iv = union(intervals, -1 << 62, 1 << 62)
        self.starts = [s for s, _ in self.iv]
        self.before = [0]
        for s, e in self.iv:
            self.before.append(self.before[-1] + e - s)

    def _upto(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        if k < 0:
            return 0
        s, e = self.iv[k]
        return self.before[k] + min(t, e) - s

    def idle(self, a, b) -> int:
        """ns of [a, b] that no device activity covers."""
        return (b - a) - (self._upto(b) - self._upto(a))


def _shifted(spans, offset):
    return [dict(index=s.index, name=s.name, start=s.start_ns + offset,
                 end=s.end_ns + offset, parent=s.parent, solve=s.solve,
                 attrs=dict(s.attrs))
            for s in spans if s.end_ns is not None]


def reduce(spans, solve_windows, device, offset_ns, idle_s) -> dict | None:
    """The five metrics and the checks behind them, from the program's
    spans (``utils/trace.Span`` objects, host clock), the benchmark's solve
    spans and the device's activities ((start, end) ns, both on the
    trace's clock), the offset between the clocks and the window's idle
    seconds. None where no program solve lies in the window."""
    rows = _shifted(spans, offset_ns)
    feasts = [r for r in rows if r["name"] == "feast" and any(
        s <= r["start"] and r["end"] <= e for s, e in solve_windows)]
    if not feasts:
        return None
    ids = {r["solve"] for r in feasts}
    rows = [r for r in rows if r["solve"] in ids]
    children = {}
    for r in rows:
        children.setdefault(r["parent"], []).append(r)
    busy = Busy(device)
    idle_by_span, filter_idle = {}, 0
    for r in rows:
        # the span's own stretches: its interval less its children's
        inner = union(((c["start"], c["end"])
                       for c in children.get(r["index"], ())),
                      r["start"], r["end"])
        edge, idle = r["start"], 0
        for s, e in inner + [[r["end"], r["end"]]]:
            if s > edge:
                idle += busy.idle(edge, s)
            edge = max(edge, e)
        idle_by_span[r["name"]] = idle_by_span.get(r["name"], 0) + idle
        if r["name"] == "filter":
            filter_idle += busy.idle(r["start"], r["end"])
    cover = []
    for f in feasts:
        inner = union(((c["start"], c["end"])
                       for c in children.get(f["index"], ())),
                      f["start"], f["end"])
        cover.append(sum(e - s for s, e in inner)
                     / max(f["end"] - f["start"], 1))
    n = len(feasts)
    launches = sum(f["attrs"]["launches"] for f in feasts)
    # the host's cost a launch where the launch queue does not fill: the
    # f32 filter applications (the f64 ones wait in a full queue, and the
    # route's Lanczos products are another population)
    f32 = [r for r in rows
           if r["name"] == "filter" and r["attrs"].get("rung") == "f32"]
    f32_launches = sum(r["attrs"]["launches"] for r in f32)
    f32_host_ns = sum(r["attrs"]["launch_host_ns"] for r in f32)
    in_spans = sum(idle_by_span.values()) * 1e-9
    return dict(
        solves=n, cover=cover, idle_in_spans_s=in_spans, idle_s=idle_s,
        idle_by_span={k: v * 1e-9 / n for k, v in idle_by_span.items()},
        launches=launches / n,
        launch_host_us=(f32_host_ns / f32_launches * 1e-3 if f32_launches
                        else None),
        filter_idle_s=filter_idle * 1e-9 / n,
        h2d_gib=sum(f["attrs"]["h2d_bytes"] for f in feasts) / n / 2 ** 30,
        cheb_steps=sum(r["attrs"]["steps"] for r in rows
                       if r["name"] == "filter") / n)


def note(run: dict, offset_ns: int) -> None:
    top = sorted(run["idle_by_span"].items(), key=lambda kv: -kv[1])[:5]
    share = (run["idle_in_spans_s"] / run["idle_s"] if run["idle_s"] > 0
             else float("nan"))
    print(f"program spans: {run['solves']} solves read; direct children "
          f"cover {[round(c, 4) for c in run['cover']]} of each feast span; "
          f"offset_ns {offset_ns}; device idle inside program spans "
          f"{run['idle_in_spans_s']:.6f} s of the window's {run['idle_s']:.6f}"
          f" s ({100 * share:.2f}%); most idle, s a solve: "
          + ", ".join(f"{k} {v:.6f}" for k, v in top),
          file=sys.stderr, flush=True)


def read(ctx: dict) -> dict | None:
    """The reduction of this run (made on the first read, then kept in
    ``ctx``), or None without the program's spans or a device trace."""
    trace = ctx.get("trace")
    if program is None or trace is None:
        return None
    if _KEY not in ctx:
        windows = [(s, e) for label, s, e in trace["spans"]
                   if label == "solve"]
        run = reduce(program.spans(), windows,
                     [(d[1], d[2]) for d in trace["device"]],
                     trace["offset_ns"],
                     trace["window_s"] - trace["busy_s"])
        ctx[_KEY] = run
        if run is not None:
            note(run, trace["offset_ns"])
    return ctx[_KEY]


def metric(ctx: dict, name: str):
    run = read(ctx)
    return None if run is None else run[name]
