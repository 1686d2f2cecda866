"""launches: kernel launches a solve, from the program's own counters
(``ops/cheb_kernels.launch_counts`` and ``ops/dia.launch_counts``): how
far they moved over each ``feast`` span of the window, averaged."""
from portbench import program_trace


def read(ctx):
    return program_trace.metric(ctx, "launches")
