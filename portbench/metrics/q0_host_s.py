"""q0_host_s: host seconds a solve spends drawing or taking its initial
subspace (``core/tools.initial_subspace``, spanned where
``solvers/sparse`` calls it)."""
from portbench.tracing import span_seconds

SPANS = [("q0", "feastkit_tpu_torch.solvers.sparse", "initial_subspace",
          "call")]


def read(ctx):
    trace, window = ctx.get("trace"), ctx.get("window")
    if trace is None or not window["records"]:
        return None
    return span_seconds(trace, "q0") / len(window["records"])
