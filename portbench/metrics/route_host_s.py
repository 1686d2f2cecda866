"""route_host_s: host seconds a solve spends in the sparse router's set-up
stages (``solvers/sparse``: CSR to COO, COO to DIA, the Gershgorin
enclosure and the functions of the filter's coefficients), from their spans."""
from portbench.tracing import span_seconds

SPARSE = "feastkit_tpu_torch.solvers.sparse"
SPANS = [("route", SPARSE, name, "call") for name in (
    "sparse_coo_arrays", "bcoo_to_dia", "gershgorin_interval",
    "cheb_inverse_coeffs", "build_cheb_filter_coeffs",
    "rational_filter_cheb_coeffs")]


def read(ctx):
    trace, window = ctx.get("trace"), ctx.get("window")
    if trace is None or not window["records"]:
        return None
    return span_seconds(trace, "route") / len(window["records"])
