"""h2d_gib: GiB a solve the program copies from host arrays to the card
(its ``h2d_bytes`` counter over each ``feast`` span of the window,
averaged): the seeded subspace, the operators' diagonals, the Lanczos
start vectors and the back-transform's scale."""
from portbench import program_trace


def read(ctx):
    return program_trace.metric(ctx, "h2d_gib")
