"""device_idle_pct: the share of the traced window that no kernel, copy or
set on the device covers (the union of the device's activity intervals)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
