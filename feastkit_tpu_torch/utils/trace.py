"""Spans and counters inside the port, on the clock of the device trace.

Off by default: :func:`enable` turns tracing on (``utils/profiling.trace_to``
does so for its block), :func:`disable` off. Off, :func:`span` returns one
shared object that does nothing, reads no clock and allocates nothing, and
the counters add nothing: the cost is a flag test at each span and at each
kernel launch.

A span records its name, its start and end in ns, the index of the span it
was opened in (None at the top), the id of the solve it belongs to (a new
one for each call of ``interfaces/feast.feast``, whose span is named
"feast"; None outside any) and attributes that are plain ints, floats and
strings, never a tensor or an array. The clock is ``time.time_ns()``, the
Unix-epoch clock to which ``torch.profiler`` converts its device
timestamps, so an offset measured between the two clocks places every span
on the device's timeline. Spans stay in memory (:func:`spans`) until
:func:`clear`; nothing is written unless a caller asks.

Each span also holds, as attributes, how much three counters moved while
it was open:

- ``launches``: the kernel launches the port's wrappers count
  (``ops/cheb_kernels.launch_counts`` and ``ops/dia.launch_counts``);
- ``launch_host_ns``: host ns spent inside those wrappers, counted only
  while tracing is on (two clock reads a launch);
- ``h2d_bytes``: bytes the sparse polynomial path copies from a host array
  to a card (:func:`count_h2d`).

The state is the process's: one thread at a time traces.
"""
from __future__ import annotations

import itertools
import numbers
import time

__all__ = ["enable", "disable", "enabled", "span", "spans", "clear",
           "mark", "since", "drop_since", "solve_attrs", "note", "counters",
           "count_h2d", "launch_done", "Span"]

# read by the launch wrappers on every launch: keep it a module global
ON = False
_spans: list = []
_stack: list = []
_solve_ids = itertools.count()
_epoch = 0            # moved by clear(): a mark taken before it is stale
_counts = {"launch_host_ns": 0, "h2d_bytes": 0}


def enable() -> None:
    global ON
    ON = True


def disable() -> None:
    global ON
    ON = False


def enabled() -> bool:
    return ON


def spans() -> list:
    """The spans recorded so far, in the order they opened."""
    return list(_spans)


def clear() -> None:
    """Forget every span recorded (spans still open record nothing more)."""
    global _epoch
    _spans.clear()
    _stack.clear()
    _epoch += 1


def mark() -> tuple:
    """A mark of the spans recorded so far, for :func:`since` and
    :func:`drop_since`."""
    return (_epoch, len(_spans))


def _first(m: tuple) -> int:
    # a clear() since the mark forgot everything before it
    epoch, first = m
    return first if epoch == _epoch else 0


def since(m: tuple) -> list:
    """The spans recorded since the mark ``m``."""
    return _spans[_first(m):]


def drop_since(m: tuple) -> None:
    """Forget the spans recorded since the mark ``m``."""
    del _spans[_first(m):]


def counters() -> dict:
    """The three counters' totals now (``launch_host_ns`` and ``h2d_bytes``
    count only while tracing is on)."""
    from ..ops import cheb_kernels, dia
    return dict(launches=sum(cheb_kernels.launch_counts().values())
                + sum(dia.launch_counts().values()), **_counts)


def count_h2d(host, device, dtype=None) -> None:
    """Count the bytes that cross when the host tensor ``host`` is copied
    to ``device``, where that is a card, as ``dtype`` (None: its own). A
    blocking copy converts on the host, so ``dtype``'s bytes cross."""
    if ON and getattr(device, "type", str(device).split(":")[0]) != "cpu":
        _counts["h2d_bytes"] += host.numel() * (dtype or host.dtype).itemsize


def launch_done(t0_ns: int) -> None:
    """A launch wrapper entered at ``time.perf_counter_ns()`` = ``t0_ns``
    has launched its kernel."""
    _counts["launch_host_ns"] += time.perf_counter_ns() - t0_ns


def solve_attrs(**attrs) -> None:
    """Set attributes on the open "feast" span of the current solve."""
    if ON:
        for s in _stack:
            if s.name == "feast":
                s.set(**attrs)
                return


def note(name: str, **attrs) -> None:
    """Set attributes on the innermost open span, where it is named
    ``name``: the work inside a span records what it did."""
    if ON and _stack and _stack[-1].name == name:
        _stack[-1].set(**attrs)


def _plain(attrs: dict) -> dict:
    """``attrs`` with numpy's scalars as Python's; anything but a number
    or a string (a tensor, an array) is refused."""
    for key, value in attrs.items():
        if isinstance(value, numbers.Integral):
            attrs[key] = int(value)
        elif isinstance(value, numbers.Real):
            attrs[key] = float(value)
        elif not isinstance(value, str):
            raise TypeError(f"span attribute {key}={value!r}: a span keeps "
                            "ints, floats and strings only")
    return attrs


class Span:
    """One span; a context manager that opens it on entry and closes it on
    exit."""

    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "solve",
                 "attrs", "_base")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, _plain(attrs)
        self.index = self.start_ns = self.end_ns = None
        self.parent = self.solve = self._base = None

    def set(self, **attrs) -> None:
        self.attrs.update(_plain(attrs))

    def as_dict(self) -> dict:
        return dict(index=self.index, name=self.name, start_ns=self.start_ns,
                    end_ns=self.end_ns, parent=self.parent, solve=self.solve,
                    attrs=dict(self.attrs))

    def __enter__(self):
        up = _stack[-1] if _stack else None
        if up is not None:
            self.parent, self.solve = up.index, up.solve
        if self.name == "feast" and self.solve is None:
            self.solve = next(_solve_ids)
        self._base = counters()
        self.index = len(_spans)
        _spans.append(self)
        _stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        now = counters()
        self.attrs.update((k, now[k] - v) for k, v in self._base.items())
        self._base = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        if _stack and _stack[-1] is self:
            _stack.pop()
        return False


class _Off:
    """What :func:`span` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


def span(name: str, **attrs):
    """A span named ``name`` with ``attrs`` (ints, floats, strings), to use
    as ``with span(...) as s:``; ``s.set(...)`` adds attributes. With
    tracing off: the shared :data:`OFF`."""
    if not ON:
        return OFF
    return Span(name, attrs)
