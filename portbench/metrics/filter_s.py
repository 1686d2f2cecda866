"""filter_s: device seconds a solve spends in the work launched inside the
filter's applications (``solvers/sparse``: the fused filter, the SPD-B
composite's, the unfused recurrence), by the profiler's launch-to-kernel
correlation."""
from portbench.tracing import device_seconds

SPARSE = "feastkit_tpu_torch.solvers.sparse"
SPANS = [("filter", SPARSE, name, "call") for name in (
    "_sparse_cheb_filter_host_fused", "_sparse_cheb_filter_host_fused_gen",
    "_sparse_cheb_filter_host")]


def read(ctx):
    trace, window = ctx.get("trace"), ctx.get("window")
    if trace is None or not window["records"]:
        return None
    seconds = device_seconds(trace, "filter")
    return seconds / len(window["records"]) if seconds > 0 else None
