"""glue_passes: the torch elementwise passes of the unfused Chebyshev
recurrence a solve (the program's ``glue_passes`` counter,
``ops/chebfilter._cheb_init`` and ``make_cheb_stepper``: four a step),
over each ``feast`` span of the window, averaged. With ``filter_glue_s``
it splits the glue's time into how many passes and how long each takes.
A program without the counter gives nothing to read."""
from portbench import program_trace


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or program_trace.program is None:
        return None
    windows = [(s, e) for label, s, e in trace["spans"] if label == "solve"]
    offset = trace["offset_ns"]
    counts = [f.attrs["glue_passes"] for f in program_trace.program.spans()
              if f.name == "feast" and f.end_ns is not None
              and "glue_passes" in f.attrs
              and any(s <= f.start_ns + offset and f.end_ns + offset <= e
                      for s, e in windows)]
    return sum(counts) / len(counts) if counts else None
