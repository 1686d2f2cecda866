"""filter_glue_s: device seconds a solve spends in the torch glue of the
unfused Chebyshev recurrence: the work launched inside the program's
``filter`` spans whose ``body`` is "unfused" (``solvers/sparse.
_sparse_cheb_filter_host``: its elementwise passes and casts) that is not
one of the port's own kernels. With ``filter_s`` it splits the filter's
time between the complex DIA products and what a fused step would remove.

An activity belongs to a filter application where it was launched inside
the benchmark's span of the filter functions (``filter/<function>``, the
spans ``filter_s`` reads) and to the program's ``filter`` span that
opened last before it ran: the ladder fetches a result from the card
between two applications, so the card has drained one before the next
opens. A program without the ``body`` attribute gives nothing to read."""
import bisect
from pathlib import Path

from portbench import program_trace
from portbench.metrics import filter_s
from portbench.tracing import base_name, port_kernel_names

SPANS = filter_s.SPANS


def glue_seconds(spans, offset_ns, device, port_names):
    """Device seconds of the non-port activities launched in an unfused
    application: ``spans`` the program's (``name``, ``start_ns``,
    ``attrs``) on the host's clock, ``offset_ns`` that clock's lag behind
    the trace's, ``device`` the trace's attributed activities (name,
    start, end, kind, benchmark span; a port kernel paired with its launch
    is named by its entry), ``port_names`` the port's kernel and entry
    names. None where no filter span has a body."""
    filters = sorted((s.start_ns + offset_ns, s.attrs["body"])
                     for s in spans
                     if s.name == "filter" and "body" in s.attrs)
    if not filters:
        return None
    starts = [t for t, _ in filters]
    seconds = 0.0
    for name, start, end, _, label in device:
        if label is None or label.split("/", 1)[0] != "filter" \
                or name in port_names or base_name(name) in port_names:
            continue
        k = bisect.bisect_right(starts, start) - 1
        if k >= 0 and filters[k][1] == "unfused":
            seconds += (end - start) * 1e-9
    return seconds


def read(ctx):
    trace, window = ctx.get("trace"), ctx.get("window")
    if trace is None or program_trace.program is None \
            or not window["records"]:
        return None
    import feastkit_tpu_torch
    csrc = Path(feastkit_tpu_torch.__file__).resolve().parent / "ops" / "csrc"
    port = port_kernel_names(csrc) | {m[1]["entry"]
                                      for m in trace["matched"]}
    seconds = glue_seconds(program_trace.program.spans(), trace["offset_ns"],
                           trace["device"], port)
    return None if seconds is None else seconds / len(window["records"])
