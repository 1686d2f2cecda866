"""Row-aligned DIA (diagonal-offset) storage and its matvec: CUDA kernels,
plain version, complex and batched entries.

Counterpart of ``feastkit_tpu/ops/pallas_kernels.py``. ``diags`` is (nd, N)
with a static ``offsets`` tuple; row k holds diagonal offsets[k] aligned to
rows: diags[k, i] = A[i, i + offsets[k]] (zero where out of range), so

    y[i, :] = sum_k diags[k, i] * x[i + offsets[k], :]

* ``dia_matvec_f32`` / ``dia_matvec_f64`` replace ``_dia_kernel``
  (pallas_kernels.py:91, via ``_dia_matvec_32`` :163 and ``dia_matvec``
  :141) on a row-major (N, M) operand;
* ``dia_matvec_batched_f32`` / ``dia_matvec_batched_f64`` replace
  ``_dia_kernel_b`` (:206, via ``_dia_matvec_batched`` :226, the
  ``custom_vmap`` rule the JAX package's node-group dispatch runs) on
  (g, N, M) operands that share the diagonals.

The fp64 entries also stand where the JAX package takes an XLA shifted-add
product for 64-bit data (Mosaic has no 64-bit types): on the card every DIA
product of the port runs in these kernels, the Krylov engine's shifted
applications, the Rayleigh-Ritz, residual and back-transform products and
the Lanczos bounds of the polynomial path alike. The recurrence's own
matvec is fused into the Chebyshev step kernels of ``ops/cheb_kernels.py``.

On a CUDA tensor each wrapper launches its kernel (``csrc/dia_matvec.cu``)
or raises; on a CPU tensor it runs :func:`dia_matvec_plain`, the
shifted-add version of the product (the counterpart of
``dia_matvec_reference``). Each wrapper counts its launches in its
``launches`` attribute. :func:`dia_matvec_any` takes any real/complex
combination: real diagonals times a complex x is ONE launch on the real
view of x (a complex (N, K) tensor is a real (N, 2K) one), where the JAX
package makes two calls; complex diagonals keep its four-product
decomposition.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

__all__ = ["bands_to_dia", "bcoo_to_dia", "dia_matvec", "dia_matvec_plain",
           "dia_matvec_batched", "dia_matvec_any", "dia_matvec_f32",
           "dia_matvec_f64", "dia_matvec_batched_f32",
           "dia_matvec_batched_f64", "launch_counts", "reset_launch_counts"]

_MAX_DIAGS = 32


def bands_to_dia(bands, kl: int, ku: int):
    """LAPACK-band layout -> row-aligned (diags, offsets) (host numpy).

    bands[k, j] = A[j - (ku-k), j]  ->  diags[k, i] = A[i, i + d], d = ku-k.
    """
    bands = np.asarray(bands)
    nb, N = bands.shape
    offsets = tuple(ku - k for k in range(nb))
    diags = np.zeros_like(bands)
    for k, d in enumerate(offsets):
        if d >= 0:
            diags[k, : N - d] = bands[k, d:]
        else:
            diags[k, -d:] = bands[k, : N + d]
    return diags, offsets


def bcoo_to_dia(data, indices, N, max_diags: int = _MAX_DIAGS):
    """COO arrays -> (diags, offsets) if the matrix lives on at most
    ``max_diags`` diagonals, else None (host numpy; duplicates add)."""
    data = np.asarray(data)
    indices = np.asarray(indices)
    offs = indices[:, 1].astype(np.int64) - indices[:, 0].astype(np.int64)
    uniq = np.unique(offs)
    if len(uniq) > max_diags:
        return None
    diags = np.zeros((len(uniq), N), data.dtype)
    pos = np.searchsorted(uniq, offs)
    np.add.at(diags, (pos, indices[:, 0]), data)
    return diags, tuple(int(d) for d in uniq)


def dia_matvec_plain(diags: torch.Tensor, offsets, x: torch.Tensor
                     ) -> torch.Tensor:
    """The plain PyTorch version: y = A x for x of shape (..., N, M) (any
    leading batch axes) by shifted multiply-adds (in-place ``addcmul_`` on
    the output: no temporary per diagonal). dtype-generic, so it is the
    plain version of every entry."""
    N = diags.shape[1]
    y = torch.zeros_like(x)
    for k, d in enumerate(offsets):
        if abs(d) >= N:
            continue
        if d >= 0:
            y[..., : N - d, :].addcmul_(diags[k, : N - d, None],
                                        x[..., d:, :])
        else:
            y[..., -d:, :].addcmul_(diags[k, -d:, None], x[..., : N + d, :])
    return y


@functools.cache
def _library():
    from .cuda_build import load
    lib = load("dia_matvec")
    for name, batched in (("dia_matvec_f32", False),
                          ("dia_matvec_f64", False),
                          ("dia_matvec_batched_f32", True),
                          ("dia_matvec_batched_f64", True)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int64, ctypes.c_int64]
                       + [ctypes.c_int64] * batched + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.dia_error_string.argtypes = [ctypes.c_int]
    lib.dia_error_string.restype = ctypes.c_char_p
    return lib


def _check(diags, offsets, x, dtype, batched):
    for name, t in (("diags", diags), ("x", x)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if diags.device != x.device:
        raise ValueError(f"diags is on {diags.device}, x on {x.device}")
    if x.dim() != (3 if batched else 2):
        raise ValueError(f"x must be {'(g, N, M)' if batched else '(N, M)'}"
                         f", got shape {tuple(x.shape)}")
    if diags.dim() != 2 or diags.shape[0] != len(offsets) \
            or diags.shape[1] != x.shape[-2]:
        raise ValueError(f"diags must be ({len(offsets)}, {x.shape[-2]}), "
                         f"got {tuple(diags.shape)}")
    if len(offsets) > _MAX_DIAGS:
        raise ValueError(f"at most {_MAX_DIAGS} diagonals, got "
                         f"{len(offsets)}")


def _launch(wrapper, diags, offsets, x, batched):
    """Launch the kernel of ``wrapper`` on CUDA tensors (raises for any
    other device, a non-contiguous operand or a shape the kernel does not
    take); returns the new output tensor."""
    if not (diags.is_cuda and x.is_cuda):
        raise ValueError(f"{wrapper.__name__}: the kernel takes CUDA "
                         f"tensors, got {diags.device} and {x.device}")
    for name, t in (("diags", diags), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{wrapper.__name__}: {name} must be "
                             "contiguous")
    if batched and x.shape[0] > 65535:
        raise ValueError(f"{wrapper.__name__}: at most 65535 operands, got "
                         f"{x.shape[0]}")
    y = torch.empty_like(x)
    lib = _library()
    offs = (ctypes.c_int64 * max(len(offsets), 1))(*offsets)
    n, m = x.shape[-2], x.shape[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = [diags.data_ptr(), offs, len(offsets), x.data_ptr(),
                y.data_ptr(), n, m]
        if batched:
            args.append(x.shape[0])
        err = getattr(lib, wrapper.__name__)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err} ({lib.dia_error_string(err).decode()})")
    wrapper.launches += 1
    return y


def _matvec(wrapper, dtype, batched, diags, offsets, x):
    offsets = tuple(int(d) for d in offsets)
    _check(diags, offsets, x, dtype, batched)
    if x.is_cuda:
        return _launch(wrapper, diags, offsets, x, batched)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return dia_matvec_plain(diags, offsets, x)


def dia_matvec_f32(diags, offsets, x):
    """y = A x for a row-major (N, M) f32 operand."""
    return _matvec(dia_matvec_f32, torch.float32, False, diags, offsets, x)


def dia_matvec_f64(diags, offsets, x):
    """y = A x for a row-major (N, M) fp64 operand."""
    return _matvec(dia_matvec_f64, torch.float64, False, diags, offsets, x)


def dia_matvec_batched_f32(diags, offsets, x):
    """y[b] = A x[b] for (g, N, M) f32 operands sharing the diagonals."""
    return _matvec(dia_matvec_batched_f32, torch.float32, True, diags,
                   offsets, x)


def dia_matvec_batched_f64(diags, offsets, x):
    """y[b] = A x[b] for (g, N, M) fp64 operands sharing the diagonals."""
    return _matvec(dia_matvec_batched_f64, torch.float64, True, diags,
                   offsets, x)


_WRAPPERS = (dia_matvec_f32, dia_matvec_f64, dia_matvec_batched_f32,
             dia_matvec_batched_f64)


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0


reset_launch_counts()


def _real_entry(x, batched):
    if x.dtype == torch.float32:
        return dia_matvec_batched_f32 if batched else dia_matvec_f32
    if x.dtype == torch.float64:
        return dia_matvec_batched_f64 if batched else dia_matvec_f64
    raise TypeError(f"the DIA matvec takes float32 or float64, got {x.dtype}")


def dia_matvec(diags: torch.Tensor, offsets, x: torch.Tensor
               ) -> torch.Tensor:
    """y = A x for a real (N, M) or (N,) operand of the diagonals' dtype
    (the f32 or the fp64 entry; a strided operand is copied first)."""
    if x.dim() == 1:
        return dia_matvec(diags, offsets, x[:, None])[:, 0]
    return _real_entry(x, False)(diags.contiguous(), offsets, x.contiguous())


def dia_matvec_batched(diags: torch.Tensor, offsets, x: torch.Tensor
                       ) -> torch.Tensor:
    """y[b] = A x[b] for real (g, N, M) operands of the diagonals' dtype
    (a strided operand is copied first)."""
    return _real_entry(x, True)(diags.contiguous(), offsets, x.contiguous())


def dia_matvec_any(diags: torch.Tensor, offsets, x: torch.Tensor
                   ) -> torch.Tensor:
    """DIA matvec for any real/complex combination, on (N, M) or (g, N, M)
    operands (the batched entry for the latter).

    Real diagonals times a complex x: one launch on the real view of x,
    (..., N, K) complex -> (..., N, 2K) real. Complex diagonals: the full
    complex product from four real ones (as the JAX package decomposes
    it). A real x with complex diagonals: two."""
    batched = x.dim() == 3

    def mv(d, v):
        return (dia_matvec_batched if batched else dia_matvec)(d, offsets, v)

    a_c, x_c = diags.is_complex(), x.is_complex()
    if not a_c and not x_c:
        return mv(diags, x)
    if not a_c:
        xr = torch.view_as_real(x.contiguous())
        y = mv(diags, xr.reshape(*x.shape[:-1], 2 * x.shape[-1]))
        return torch.view_as_complex(y.reshape(*x.shape, 2))
    dr, di = diags.real.contiguous(), diags.imag.contiguous()
    if not x_c:
        return torch.complex(mv(dr, x), mv(di, x))
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    return torch.complex(mv(dr, xr) - mv(di, xi), mv(dr, xi) + mv(di, xr))
