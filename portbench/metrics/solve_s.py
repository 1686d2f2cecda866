"""solve_s: the window's seconds over the solves completed in it (the
window runs from the first solve's start to the last solve's end, whole
solves only, on the host clock with the card synchronised at both ends)."""


def read(ctx):
    window = ctx.get("window")
    if not window or not window["records"]:
        return None
    return (window["end"] - window["start"]) / len(window["records"])
