"""setup_s: host seconds from the process's start to the window's start:
importing, loading (on a checkout's first run, building) the kernels,
building the pool and warming up on the cell's own shapes."""


def read(ctx):
    return ctx.get("setup_s")
