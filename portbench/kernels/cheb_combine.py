"""Operations and bytes of one launch of the elementwise combine
(``csrc/cheb_combine.cu``: ``cheb_combine_f32``, ``cheb_combine_f64``):
T2 = 2 (sc z - sh x) - T0, F' = F + ck T2.

z and x are read and F' written always; T0 is read and T2 written only
where T0 is given, F read only where it is given: three to six planes.
Six operations per element."""

KERNELS = ("cheb_combine_kernel",)
HOOK = ("feastkit_tpu_torch.ops.cheb_kernels", "_combine")


def launch(call):
    z = call["z"]
    if not z.is_cuda:
        return None
    return dict(entry=call["wrapper"].__name__, elements=z.numel(),
                itemsize=z.element_size(), t0=call["t0"] is not None,
                f=call["f"] is not None)


def cost(s):
    planes = 3 + 2 * s["t0"] + s["f"]
    return (planes * s["elements"] * s["itemsize"], 6 * s["elements"],
            "f64" if s["itemsize"] == 8 else "f32")
