"""cheb_steps: the filter's A-products on the block a solve (each
``filter`` span's ``steps``: its series length less one, summed over the
solve's applications, averaged over the window's solves). With the
filter's device seconds it splits a change of ``filter_s`` into how many
steps and how fast each one is."""
from portbench import program_trace


def read(ctx):
    return program_trace.metric(ctx, "cheb_steps")
