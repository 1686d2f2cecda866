"""Operations and bytes of one launch of the DIA product
(``csrc/dia_matvec.cu``: ``dia_matvec[_batched]_{f32,f64,c64,c128}``,
the ring body and the flat one).

Y = A X for g operands of (N, M) reads X, writes Y and reads the nd
diagonals once. Per output element nd multiply-adds: two operations each
for real values, eight for complex ones."""

KERNELS = ("dia_matvec_kernel", "dia_ring_kernel")
HOOK = ("feastkit_tpu_torch.ops.dia", "_launch")


def launch(call):
    x, diags = call["x"], call["diags"]
    if not x.is_cuda:
        return None
    g = x.shape[0] if call["batched"] else 1
    n, m = x.shape[-2], x.shape[-1]
    return dict(entry=call["wrapper"].__name__, g=g, N=n, M=m,
                nd=len(call["offsets"]), itemsize=x.element_size(),
                diag_itemsize=diags.element_size(),
                complex=bool(x.is_complex()))


def cost(s):
    vec = s["g"] * s["N"] * s["M"] * s["itemsize"]
    diags = s["nd"] * s["N"] * s["diag_itemsize"]
    per = 8 if s["complex"] else 2
    real = s["itemsize"] // (2 if s["complex"] else 1)
    return (2 * vec + diags, per * s["nd"] * s["g"] * s["N"] * s["M"],
            "f64" if real == 8 else "f32")
