"""Operations and bytes of one launch of the row-major one-step Chebyshev
kernel (``csrc/cheb_step.cu``: ``cheb_step_f32``, ``cheb_step_f64``).

One step on (N, M) planes reads T0, T1 and acc and writes T2 (into T0's
buffer) and acc: five planes, and the nd diagonals once. Per element
nd multiply-adds and seven more operations (two scalings, two subtractions,
the doubling, the accumulate's multiply-add)."""

KERNELS = ("cheb_step_kernel",)
HOOK = ("feastkit_tpu_torch.ops.cheb_kernels", "_launch")


def launch(call):
    """The launch's shape from the hooked call's bound arguments."""
    t0 = call["t0"]
    if not t0.is_cuda:
        return None
    n, m = t0.shape
    return dict(entry=call["wrapper"].__name__, N=n, M=m,
                nd=len(call["offsets"]), itemsize=t0.element_size())


def cost(s):
    """(bytes, operations, precision of the operations)."""
    plane = s["N"] * s["M"] * s["itemsize"]
    diags = s["nd"] * s["N"] * s["itemsize"]
    ops = s["N"] * s["M"] * (2 * s["nd"] + 7)
    return 5 * plane + diags, ops, "f64" if s["itemsize"] == 8 else "f32"
