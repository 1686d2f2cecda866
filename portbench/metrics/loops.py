"""loops: the refinement loops a solve takes (``FeastResult.loop``),
averaged over the window's solves that returned."""


def read(ctx):
    window = ctx.get("window")
    loops = [r["loop"] for r in (window or {}).get("records", ())
             if "loop" in r]
    return sum(loops) / len(loops) if loops else None
