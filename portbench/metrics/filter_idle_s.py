"""filter_idle_s: seconds a solve the device sits idle while the host is
inside one of the program's ``filter`` spans (a filter application):
the spans, placed on the device trace's clock, less the union of the
device's activities."""
from portbench import program_trace


def read(ctx):
    return program_trace.metric(ctx, "filter_idle_s")
