"""Operations and bytes of one launch of the streamed multi-step Chebyshev
kernel (``csrc/cheb_stream4.cu``: ``cheb_step2_f32`` / ``_f64``,
``cheb_step4_f32`` / ``_f64``).

A pass of S steps on column-major (M, N) planes reads T0, T1 and acc and
writes the two new T planes and acc: six planes, whatever S, and the nd
diagonals once. Per element and step nd multiply-adds and seven more
operations. (1,048,576 rows, 72 columns, 5 diagonals, f32: 6 x 302 MB +
21 MB over 3.35 TB/s = 0.5471 ms.)"""

KERNELS = ("cheb_stream_kernel",)
HOOK = ("feastkit_tpu_torch.ops.cheb_kernels", "_multistep")


def launch(call):
    t0 = call["t0"]
    if not t0.is_cuda:
        return None
    m, n = t0.shape
    return dict(entry=call["wrapper"].__name__, N=n, M=m,
                nd=len(call["offsets"]), itemsize=t0.element_size(),
                steps=int(call["S"]))


def cost(s):
    plane = s["N"] * s["M"] * s["itemsize"]
    diags = s["nd"] * s["N"] * s["itemsize"]
    ops = s["steps"] * s["N"] * s["M"] * (2 * s["nd"] + 7)
    return 6 * plane + diags, ops, "f64" if s["itemsize"] == 8 else "f32"
