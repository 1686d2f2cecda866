"""The traced run: spans around the port's layers, hooks on its kernel
launches, the profiler over the window, and the reduction of its trace.

Spans and hooks wrap module functions of the port from outside (as
``chip_smoke.py``'s ``_breakdown`` does) and add no synchronisation. A span
``<layer>/<name>`` is kept on the host's clock; a hook records each launch
of one kernel family with the shape its count file (``kernels/<family>.py``)
reads from the call, the innermost span open at the launch, and the time.
The profiler records the device's activities and the CUDA calls that
launched them, and nothing on the host besides (recording every torch
operation too cost a second a solve). The launches that the hooks logged
place the spans on the trace's clock. The trace is reduced in memory;
nothing of it is written to disk.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import inspect
import re
import time
from pathlib import Path

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# how far ahead in the launch log a kernel's pair may lie
LOOKAHEAD = 64
# the host's waits that the trace draws on the device's timeline
HOST_WAITS = ("Stream Sync", "Event Sync", "Context Sync",
              "Stream Wait Event")


def load_file(path: Path, name: str):
    """Import one file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernel_families(root: Path) -> dict:
    """Every count file under ``kernels/``, by family name."""
    out = {}
    for path in sorted((Path(root) / "portbench" / "kernels").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        out[path.stem] = load_file(path, f"portbench_kernel_{path.stem}")
    return out


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*[(<]")


def port_kernel_names(csrc: Path) -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for path in Path(csrc).glob("*.cu"):
        names.update(_GLOBAL.findall(path.read_text()))
    return names


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list: ``void (anonymous namespace)::f<T, 4>(T*)`` ->
    ``f<T, 4>``."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def base_name(name: str) -> str:
    """``void (anonymous namespace)::f<T, 4>(...)`` -> ``f``."""
    return short_name(name).split("<", 1)[0].rsplit("::", 1)[-1].strip()


class Recorder:
    """The host's side of a traced window: the spans open now, the spans
    closed (label, start, end in ns), and each launch of a counted kernel
    family (family, shape, innermost span, time in ns)."""

    def __init__(self):
        self.stack = []
        self.spans = []
        self.launches = []
        self._saved = []

    @contextlib.contextmanager
    def span(self, label: str):
        self.stack.append(label)
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((label, start, time.time_ns()))
            self.stack.pop()

    def _wrap(self, fn, label):
        span = self.span

        def spanned(*a, **k):
            with span(label):
                return fn(*a, **k)
        return spanned

    def install_spans(self, spans) -> None:
        """``spans``: (layer, module, function, kind) rows; kind "call" spans
        each call, "factory" each call of the function it returns."""
        done = set()
        for layer, module, attr, kind in spans:
            if (module, attr) in done:
                continue
            done.add((module, attr))
            mod = importlib.import_module(module)
            orig = getattr(mod, attr)
            label = f"{layer}/{attr}"
            if kind == "factory":
                wrap = self._wrap

                def factory(*a, _orig=orig, _label=label, **k):
                    return wrap(_orig(*a, **k), _label)
                new = factory
            else:
                new = self._wrap(orig, label)
            setattr(mod, attr, new)
            self._saved.append((mod, attr, orig))

    def install_hooks(self, families: dict) -> None:
        for fam, spec in families.items():
            module, attr = spec.HOOK
            mod = importlib.import_module(module)
            orig = getattr(mod, attr)
            names = list(inspect.signature(orig).parameters)
            setattr(mod, attr, self._hook(fam, spec.launch, orig, names))
            self._saved.append((mod, attr, orig))

    def _hook(self, fam, read, orig, names):
        launches, stack = self.launches, self.stack

        def hooked(*a, **k):
            call = dict(zip(names, a))
            call.update(k)
            shape = read(call)
            if shape is not None:
                launches.append((fam, shape, stack[-1] if stack else None,
                                 time.time_ns()))
            return orig(*a, **k)
        return hooked

    def restore(self) -> None:
        while self._saved:
            mod, attr, orig = self._saved.pop()
            setattr(mod, attr, orig)


def profiler():
    import torch
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def _kind(e) -> str:
    """The activity's kind: "kernel", "gpu_memcpy", "gpu_memset", "launch"
    (a call of the CUDA API) or "" (anything else). Works where
    ``activity_type`` is missing."""
    name = e.name()
    on_device = str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"
    annotation = getattr(e, "is_user_annotation", None)
    if on_device:
        if (annotation and annotation()) or name in HOST_WAITS:
            return ""
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith("cu"):
        return "launch"
    return ""


def read_events(prof) -> dict:
    """The trace's device activities and launch calls, in plain tuples
    (times in ns)."""
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            device.append((e.name(), e.start_ns(), e.start_ns()
                           + e.duration_ns(), kind, e.correlation_id(),
                           e.linked_correlation_id()))
        elif kind == "launch":
            launches[e.correlation_id()] = e.start_ns()
    return dict(device=device, launches=launches)


class Timeline:
    """The innermost benchmark span open on the host at each moment."""

    def __init__(self, spans):
        marks = []
        for label, s, e in spans:
            marks.append((s, 1, e, label))
            marks.append((e, 0, s, label))
        marks.sort()
        self.starts, self.labels = [], []
        open_ = []
        for t, is_start, other, label in marks:
            if is_start:
                open_.append((label, t))
            else:
                for i in range(len(open_) - 1, -1, -1):
                    if open_[i][0] == label and open_[i][1] == other:
                        del open_[i]
                        break
            self.starts.append(t)
            self.labels.append(open_[-1][0] if open_ else None)

    def at(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.labels[i] if i >= 0 else None


def union(intervals, lo, hi) -> list:
    """The merged intervals, clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: dict, spans: list, launch_log: list, families: dict,
           port_kernels: set, peaks: dict) -> dict:
    """Everything the per-layer readers take, from one traced window:
    ``events`` from :func:`read_events`, the recorder's spans and launch
    log, the kernel families' count files, the port's kernel names and the
    card's peaks."""
    device = sorted(events["device"], key=lambda d: d[1])
    calls = events["launches"]

    def call_time(d):
        t = calls.get(d[4])
        return calls.get(d[5]) if t is None else t

    # the port's counted kernels against the launch log, both in launch
    # order: each kernel to the next logged launch of its family, a few
    # entries ahead at most. A record the trace drops leaves its logged
    # launch unpaired (or, amid launches of one family and one shape, moves
    # its neighbours' pairs by one, which changes no shape); what is left
    # without a pair is counted, never guessed.
    counted = {k: fam for fam, spec in families.items() for k in spec.KERNELS}
    ours = [d for d in device
            if d[3] == "kernel" and base_name(d[0]) in counted]
    uncounted = sorted({base_name(d[0]) for d in device if d[3] == "kernel"}
                       & (set(port_kernels) - set(counted)))
    logged, matched, shifts = {}, [], []
    j = 0
    for d in ours:
        fam = counted[base_name(d[0])]
        k = j
        while (k < len(launch_log) and k - j < LOOKAHEAD
               and launch_log[k][0] != fam):
            k += 1
        if k == len(launch_log) or launch_log[k][0] != fam:
            continue
        _, shape, label, t_host = launch_log[k]
        logged[id(d)] = m = (fam, shape, label, (d[2] - d[1]) * 1e-9)
        matched.append(m)
        if call_time(d) is not None:
            shifts.append(call_time(d) - t_host)
        j = k + 1
    unpaired = (len(ours) - len(matched), len(launch_log) - len(matched))
    mismatch = (None if not any(unpaired) else
                f"{unpaired[0]} kernels of the port without a logged launch, "
                f"{unpaired[1]} logged launches without a kernel")
    # the host's clock against the trace's: the median lag of a logged
    # launch to its call (a hook logs some microseconds before the call it
    # wraps; a pair the trace's drops have moved does not sway a median)
    offset = sorted(shifts)[len(shifts) // 2] if shifts else 0
    spans = [(label, s + offset, e + offset) for label, s, e in spans]
    window = [sp for sp in spans if sp[0] == "window"]
    if not window:
        raise RuntimeError("no window span was recorded")
    w0, w1 = window[0][1], window[0][2]
    spans = [sp for sp in spans if sp[0] != "window"]
    timeline = Timeline(spans)
    device = [d for d in device if d[2] > w0 and d[1] < w1]
    busy = union(((d[1], d[2]) for d in device), w0, w1)

    # each device activity's span: its launch call's, else (a counted
    # kernel) the one its launch was logged in
    attributed, unattributed, no_call, disagree = [], 0, 0, 0
    for d in device:
        t = call_time(d)
        m = logged.get(id(d))
        no_call += t is None
        if t is not None:
            label = timeline.at(t)
            disagree += m is not None and m[2] != label
        elif m is not None:
            label = m[2]
        else:
            label = None
            unattributed += 1
        name = m[1]["entry"] if m is not None else short_name(d[0])
        attributed.append((name if d[3] == "kernel" else d[3], d[1], d[2],
                           d[3], label))

    gaps = []
    edge = w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((timeline.at((edge + s) // 2) or "harness",
                         (s - edge) * 1e-9))
        edge = max(edge, e)
    by_op = {}
    for name, s, e, _, _ in attributed:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-9
    return dict(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        spans=spans, device=attributed, matched=matched, mismatch=mismatch,
        uncounted=uncounted, unattributed=unattributed, no_call=no_call,
        disagree=disagree, offset_ns=offset, unpaired=unpaired, peaks=peaks,
        families=families,
        breakdown=dict(
            device_ops=sorted(([k, v] for k, v in by_op.items()),
                              key=lambda kv: -kv[1])[:10],
            idle_gaps=sorted(([k, v] for k, v in gaps),
                             key=lambda kv: -kv[1])[:10]))


def span_seconds(trace: dict, layer: str) -> float:
    """Host seconds inside the spans of one layer (their union)."""
    iv = [(s, e) for label, s, e in trace["spans"]
          if label.split("/", 1)[0] == layer]
    return sum(e - s for s, e in union(iv, -1 << 62, 1 << 62)) * 1e-9


def device_seconds(trace: dict, layer: str) -> float:
    """Device seconds of the activities launched inside one layer's spans."""
    return sum((e - s) * 1e-9 for _, s, e, _, label in trace["device"]
               if label is not None and label.split("/", 1)[0] == layer)
