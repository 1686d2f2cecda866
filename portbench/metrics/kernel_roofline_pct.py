"""kernel_roofline_pct: the port's own kernels' least time over their
measured device time, summed over every launch in the traced window. A
launch's least time is the larger of its bytes over the card's bandwidth
and its operations over the card's peak in their precision, from its
family's count file (``kernels/<family>.py``) at the launch's shapes.
Read where at least 99% of the port's kernels in the trace were paired
with their logged launch (and so with their shapes)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace["matched"] \
            or trace["unpaired"][0] > 0.01 * len(trace["matched"]):
        return None
    peaks = trace["peaks"]
    least = measured = 0.0
    for fam, shape, _, seconds in trace["matched"]:
        nbytes, ops, precision = trace["families"][fam].cost(shape)
        least += max(nbytes / peaks["bytes_per_s"],
                     ops / peaks["flops"][precision])
        measured += seconds
    return 100.0 * least / measured if measured > 0 else None
