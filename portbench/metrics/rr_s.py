"""rr_s: device seconds a solve spends in the Rayleigh-Ritz updates
(the update ``kernel/hermitian.make_rayleigh_ritz_update`` returns), by
the profiler's launch-to-kernel correlation."""
from portbench.tracing import device_seconds

SPANS = [("rr", "feastkit_tpu_torch.solvers.sparse",
          "make_rayleigh_ritz_update", "factory")]


def read(ctx):
    trace, window = ctx.get("trace"), ctx.get("window")
    if trace is None or not window["records"]:
        return None
    seconds = device_seconds(trace, "rr")
    return seconds / len(window["records"]) if seconds > 0 else None
