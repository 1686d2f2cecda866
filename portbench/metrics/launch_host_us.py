"""launch_host_us: host microseconds a launch spends in the program's
launch wrappers (checks, plan, the call into the kernel library), from
the program's ``launch_host_ns`` counter over the window's f32 ``filter``
spans divided by their launches. Those kernels are short enough that the
card's launch queue does not fill; in the f64 filter's the wrappers wait
in a full queue, and the route's small Lanczos products are another
population, so both are left out."""
from portbench import program_trace


def read(ctx):
    return program_trace.metric(ctx, "launch_host_us")
