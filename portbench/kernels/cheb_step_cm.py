"""Operations and bytes of one launch of the column-major one-step
Chebyshev kernel (``csrc/cheb_step_cm.cu``: ``cheb_step_cm_f32``,
``cheb_step_cm_f64``) in each of its four forms.

T1 is read and T2 written always; T0 is read only where it is given, and
acc read and written only where it is given: two to five planes, and the
nd diagonals once. Per element nd multiply-adds, four operations of the
map, one more with T0 and two (the accumulate) with acc."""

KERNELS = ("cheb_step_cm_kernel",)
HOOK = ("feastkit_tpu_torch.ops.cheb_kernels", "_step_cm")


def launch(call):
    t1 = call["t1"]
    if not t1.is_cuda:
        return None
    m, n = t1.shape
    return dict(entry=call["wrapper"].__name__, N=n, M=m,
                nd=len(call["offsets"]), itemsize=t1.element_size(),
                t0=call["t0"] is not None, acc=call["acc"] is not None)


def cost(s):
    plane = s["N"] * s["M"] * s["itemsize"]
    diags = s["nd"] * s["N"] * s["itemsize"]
    planes = 2 + s["t0"] + 2 * s["acc"]
    ops = s["N"] * s["M"] * (2 * s["nd"] + 4 + s["t0"] + 2 * s["acc"])
    return planes * plane + diags, ops, "f64" if s["itemsize"] == 8 else "f32"
