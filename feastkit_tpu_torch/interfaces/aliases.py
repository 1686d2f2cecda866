"""FEAST-compatible precision-prefixed aliases of the PyTorch port:
sfeast_* / dfeast_* / cfeast_* / zfeast_*, the iterative i-variants and
the custom-contour x-variants.

Counterpart of ``feastkit_tpu/interfaces/aliases.py`` (the reference's
metaprogrammed alias layer, src/interfaces/feast_precision_aliases.jl):
table-driven closures over the port's drivers, called through their
modules' attributes. Naming grammar (feast_name, feast_tools.jl:758-832):

    {s|d|c|z} [i] feast_ {sy|he|ge|sb|hb|gb|scsr|hcsr|gcsr} {ev|gv|pev} [x]

* s/d = float32 / float64; c/z = complex64 / complex128
* {s,d}feast_sy* = real symmetric; {c,z}feast_sy* = COMPLEX SYMMETRIC
  (transpose-bilinear, elliptical region), as in the reference
* i = iterative inner solves (Krylov on the operator); x = an explicit
  custom contour (Zne, Wne) as the last two positional arguments

An operand is cast to the prefix's precision where it lives: a scipy
sparse matrix stays scipy, a tensor stays on its device, anything else
becomes a numpy array. The solves run on ``device=`` (None: CUDA). The
parallel p-names (``p{s,d,c,z}[i]feast_*``) run the sharded drivers of
``parallel/pfeast.py`` (every rank of the process group calling):
dense names ``pfeast_dense`` / ``pfeast_general``, sparse ones
``pfeast_sparse`` / ``pfeast_sparse_general``, and the i-names the sparse
drivers' Krylov inner solves on any operand, as in the JAX package;
``p{s,d}feast_srci`` are the parallel RCI machine of
``interfaces/compat.py``.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from ..core.backend import resolve_device
from ..core.types import Contour
from ..parallel import pfeast as _pf
from ..solvers import banded as _bnd
from ..solvers import dense as _dn
from ..solvers import dense_general as _dg
from ..solvers import matfree as _mf
from ..solvers import sparse as _sp
from .compat import pdfeast_srci, psfeast_srci

_REAL = {"s": np.float32, "d": np.float64}
_CPLX = {"c": np.complex64, "z": np.complex128}


def _cast(A, dtype):
    """``A`` in ``dtype`` where it lives (None: as it is)."""
    if dtype is None:
        return A
    if sps.issparse(A):
        return A.astype(dtype)
    if isinstance(A, torch.Tensor):
        return A.to(_dn._TORCH_DTYPE[np.dtype(dtype)])
    return np.asarray(A, dtype)


def _split_fpm(rest, kw):
    return rest[0] if rest else kw.pop("fpm", None)


def _make_dense_interval(dtype, generalized, hermitian):
    def alias(A, *args, **kw):
        if generalized:
            B, Emin, Emax, M0, *rest = args
            return _dn.dense_hermitian_feast(
                _cast(A, dtype), _cast(B, dtype), Emin, Emax, M0,
                _split_fpm(rest, kw), hermitian=hermitian, **kw)
        Emin, Emax, M0, *rest = args
        return _dn.dense_hermitian_feast(
            _cast(A, dtype), None, Emin, Emax, M0, _split_fpm(rest, kw),
            hermitian=hermitian, **kw)
    return alias


def _make_dense_general(dtype, generalized, bilinear):
    def alias(A, *args, **kw):
        if generalized:
            B, Emid, r, M0, *rest = args
            return _dg.dense_general_feast(
                _cast(A, dtype), _cast(B, dtype), Emid, r, M0,
                _split_fpm(rest, kw), bilinear=bilinear, **kw)
        Emid, r, M0, *rest = args
        return _dg.dense_general_feast(
            _cast(A, dtype), None, Emid, r, M0, _split_fpm(rest, kw),
            bilinear=bilinear, **kw)
    return alias


def _make_sparse_interval(dtype, generalized, hermitian, iterative=False):
    def alias(A, *args, **kw):
        if iterative:
            # the i-name contract: pin the inner solve to Krylov, so the
            # narrow-band hand-off cannot route to the direct BCR engine
            kw.setdefault("solver", "gmres")
        if generalized:
            B, Emin, Emax, M0, *rest = args
            return _sp.sparse_feast_interval(
                _cast(A, dtype), _cast(B, dtype), Emin, Emax, M0,
                _split_fpm(rest, kw), hermitian=hermitian, **kw)
        Emin, Emax, M0, *rest = args
        return _sp.sparse_feast_interval(
            _cast(A, dtype), None, Emin, Emax, M0, _split_fpm(rest, kw),
            hermitian=hermitian, **kw)
    return alias


def _make_sparse_general(dtype, generalized, bilinear, iterative=False):
    def alias(A, *args, **kw):
        if iterative:
            kw.setdefault("solver", "gmres")      # the i-name contract
        if generalized:
            B, Emid, r, M0, *rest = args
            return _sp.sparse_feast_general(
                _cast(A, dtype), _cast(B, dtype), Emid, r, M0,
                _split_fpm(rest, kw), bilinear=bilinear, **kw)
        Emid, r, M0, *rest = args
        return _sp.sparse_feast_general(
            _cast(A, dtype), None, Emid, r, M0, _split_fpm(rest, kw),
            bilinear=bilinear, **kw)
    return alias


def _make_banded_interval(dtype, generalized, hermitian):
    def alias(A_bands, kl, ku, *args, **kw):
        if generalized:
            B_bands, klb, kub, Emin, Emax, M0, *rest = args
            f = _bnd.feast_hbgv if hermitian else _bnd.feast_sbgv
            return f(_cast(A_bands, dtype), kl, ku, _cast(B_bands, dtype),
                     klb, kub, Emin, Emax, M0, _split_fpm(rest, kw), **kw)
        Emin, Emax, M0, *rest = args
        f = _bnd.feast_hbev if hermitian else _bnd.feast_sbev
        return f(_cast(A_bands, dtype), kl, ku, Emin, Emax, M0,
                 _split_fpm(rest, kw), **kw)
    return alias


def _make_banded_general(dtype, generalized, bilinear):
    def alias(A_bands, kl, ku, *args, **kw):
        if generalized:
            B_bands, klb, kub, Emid, r, M0, *rest = args
            f = _bnd.feast_sbgv_complex if bilinear else _bnd.feast_gbgv
            return f(_cast(A_bands, dtype), kl, ku, _cast(B_bands, dtype),
                     klb, kub, Emid, r, M0, _split_fpm(rest, kw), **kw)
        Emid, r, M0, *rest = args
        f = _bnd.feast_sbev_complex if bilinear else _bnd.feast_gbev
        return f(_cast(A_bands, dtype), kl, ku, Emid, r, M0,
                 _split_fpm(rest, kw), **kw)
    return alias


def _make_pep(dtype):
    def alias(coeffs, Emid, r, M0, fpm=None, **kw):
        return _dg.feast_pep([_cast(c, dtype) for c in coeffs], Emid, r, M0,
                             fpm, **kw)
    return alias


def _bands_to_scipy(bands, kl, ku, dtype):
    """LAPACK band storage -> scipy CSR with the band's explicit entries
    (the i-variant banded aliases run the band operator through the sparse
    iterative engine)."""
    from ..ops.dia import bands_to_dia
    if isinstance(bands, torch.Tensor):
        bands = bands.detach().cpu().numpy()
    diags, offsets = bands_to_dia(np.asarray(bands, dtype), kl, ku)
    N = diags.shape[1]
    arrs, offs = [], []
    for k, d in enumerate(offsets):
        if abs(d) >= N:
            continue
        arrs.append(diags[k, :N - d] if d >= 0 else diags[k, -d:])
        offs.append(d)
    return sps.diags(arrs, offs, shape=(N, N), format="csr")


def _iterative_banded_interval(dtype, generalized, hermitian):
    """{s,d}ifeast_sb* / {c,z}ifeast_hb*: band operands through the sparse
    engine's Krylov solves (the DIA kernels on the card)."""
    def alias(A_bands, kl, ku, *args, **kw):
        A = _bands_to_scipy(A_bands, kl, ku, dtype)
        kw.setdefault("solver", "gmres")          # the i-name contract
        if generalized:
            B_bands, klb, kub, Emin, Emax, M0, *rest = args
            B = _bands_to_scipy(B_bands, klb, kub, dtype)
            return _sp.sparse_feast_interval(A, B, Emin, Emax, M0,
                                             _split_fpm(rest, kw),
                                             hermitian=hermitian, **kw)
        Emin, Emax, M0, *rest = args
        return _sp.sparse_feast_interval(A, None, Emin, Emax, M0,
                                         _split_fpm(rest, kw),
                                         hermitian=hermitian, **kw)
    return alias


def _iterative_banded_general(dtype, generalized, bilinear):
    """{c,z}ifeast_gb* / sb* (complex): banded general / complex-symmetric
    through the sparse general engine's Krylov solves."""
    def alias(A_bands, kl, ku, *args, **kw):
        A = _bands_to_scipy(A_bands, kl, ku, dtype)
        kw.setdefault("solver", "gmres")          # the i-name contract
        if generalized:
            B_bands, klb, kub, Emid, r, M0, *rest = args
            B = _bands_to_scipy(B_bands, klb, kub, dtype)
            return _sp.sparse_feast_general(A, B, Emid, r, M0,
                                            _split_fpm(rest, kw),
                                            bilinear=bilinear, **kw)
        Emid, r, M0, *rest = args
        return _sp.sparse_feast_general(A, None, Emid, r, M0,
                                        _split_fpm(rest, kw),
                                        bilinear=bilinear, **kw)
    return alias


def _tensor_on(M, dtype, device):
    """A dense operand as a tensor of ``dtype`` on ``device``."""
    if not isinstance(M, torch.Tensor):
        M = torch.as_tensor(np.asarray(M, dtype))
    return M.to(device=device, dtype=_dn._TORCH_DTYPE[np.dtype(dtype)])


def _dense_operator(M, **flags):
    """The operator of a dense tensor in its own precision: a block is cast
    to it (a complex block keeps its imaginary part: a real operator takes
    it as two real products, ``LinearOperator``'s split)."""
    return _mf.LinearOperator(lambda X: M @ X.to(M.dtype), M.shape, M.dtype,
                              **flags)


def _coeff_op(c, dtype, device):
    """A polynomial coefficient as an operator that keeps its sparsity (the
    iterative pev path must not densify): a scipy sparse one on the DIA
    kernels or a CSR product on the solve's device, a dense one as a
    tensor there."""
    if not sps.issparse(c):
        return _tensor_on(c, dtype, device)
    data, idx, shape = _sp.sparse_coo_arrays(c, dtype)
    from ..ops.dia import bcoo_to_dia
    dia = bcoo_to_dia(data, idx, shape[0])
    dia_np, offsets = dia if dia else (None, None)
    tdtype = _dn._TORCH_DTYPE[np.dtype(dtype)]
    return _mf.LinearOperator(
        _sp._operator(data, idx, dia_np, offsets, shape[0], tdtype, device),
        shape, tdtype)


def _make_iter_pep(dtype):
    """*ifeast_*pev: the polynomial problem with iterative inner solves, the
    companion linearization by operators solved by GMRES (the reference's
    iterative polynomial families, runtests.jl:965-1029)."""
    def alias(coeffs, Emid, r, M0, fpm=None, **kw):
        device = resolve_device(kw.get("device"))
        dt = dtype if dtype is not None else np.result_type(
            *[_dn._np_dtype(c) for c in coeffs])
        return _mf.feast_polynomial_matvec(
            [_coeff_op(c, dt, device) for c in coeffs], Emid, r, M0, fpm,
            **kw)
    return alias


def _make_sparse_pep(dtype):
    def alias(coeffs, Emid, r, M0, fpm=None, **kw):
        return _sp.feast_scsrpev([_cast(c, dtype) for c in coeffs], Emid, r,
                                 M0, fpm, **kw)
    return alias


def _make_rcipev(dtype, iterative=False):
    """*rcipev aliases: the polynomial RCI state machine serviced on its
    device (feast_srcipev! / grcipev!, feast_kernel.jl:990-1050): P(z) by
    torch LU, or, for ``iterative``, restarted GMRES (the i-variant's
    "the caller chooses direct or iterative", feast_kernel.jl:296-395)."""
    def alias(coeffs, Emid, r, M0, fpm=None, **kw):
        from ..core.types import FeastGeneralResult, FeastRCIJob, _trim
        from ..kernel import rci as _rci
        from ..ops.gmres import gmres_block
        st = _rci.FeastPolyRCI(coeffs[0].shape[0], len(coeffs) - 1, M0,
                               Emid, r, fpm, **kw)
        # the coefficients rounded to the prefix's precision, P(z) in
        # complex128
        C = [_tensor_on(c, dtype, st.device).to(torch.complex128)
             for c in coeffs]
        N, d = st.N, st.d

        def P(z):
            acc = C[d].clone()
            for k in range(d - 1, -1, -1):
                acc = acc * z + C[k]
            return acc

        job = st.step()
        factor = None
        guard = 0
        while job != FeastRCIJob.DONE and guard < 100000:
            guard += 1
            if job == FeastRCIJob.FACTORIZE:
                factor = P(st.Ze) if iterative \
                    else torch.linalg.lu_factor(P(st.Ze))
            elif job == FeastRCIJob.SOLVE:
                if iterative:
                    m = min(40, N)
                    st.workc, _ = gmres_block(
                        lambda X, Pz=factor: Pz @ X, st.workc, tol=1e-12,
                        restart=m, maxiter=200 * m)
                else:
                    st.workc = torch.linalg.lu_solve(*factor, st.workc)
            elif job == FeastRCIJob.MULT_A:
                st.workc = torch.stack(
                    [P(complex(l)) @ st.q[:, j] for j, l in
                     enumerate(st.lam)], dim=1)
            job = st.step()
        return _trim(FeastGeneralResult, st.lam, st.q, st.res, st.inside,
                     int(st.info), float(st.epsout),
                     st.loop)
    return alias


def _iterative_dense_interval(dtype, generalized, hermitian):
    """i-prefixed dense: inner solves by GMRES through the matrix-free
    engine, the operands as operators on the solve's device in the
    prefix's precision."""
    def alias(A, *args, **kw):
        device = resolve_device(kw.get("device"))
        dt = dtype if dtype is not None else _dn._np_dtype(A)
        A_op = _dense_operator(_tensor_on(A, dt, device),
                               symmetric=not hermitian, hermitian=hermitian)
        if generalized:
            B, Emin, Emax, M0, *rest = args
            B_op = _dense_operator(_tensor_on(B, dt, device),
                                   symmetric=not hermitian,
                                   hermitian=hermitian, posdef=True)
            return _mf.feast_matvec(A_op, B_op, (Emin, Emax), M0,
                                    _split_fpm(rest, kw),
                                    hermitian=hermitian, **kw)
        Emin, Emax, M0, *rest = args
        return _mf.feast_matvec(A_op, None, (Emin, Emax), M0,
                                _split_fpm(rest, kw), hermitian=hermitian,
                                **kw)
    return alias


def _looks_like_fpm(obj):
    from ..core.parameters import FeastParameters
    if isinstance(obj, FeastParameters):
        return True
    try:
        arr = np.asarray(obj)
    except (TypeError, ValueError, RuntimeError):
        return False
    return (arr.ndim == 1 and arr.size >= 64
            and np.issubdtype(arr.dtype, np.integer))


def _make_parallel(driver, dtype, generalized, **flags):
    """A p-name: ``driver`` of ``parallel/pfeast.py`` (called through the
    module's attribute) on the operands cast to ``dtype``, with ``flags``
    (``hermitian=`` for an interval driver, ``bilinear=`` for a general
    one)."""
    def alias(A, *args, **kw):
        if generalized:
            B, lo, hi, M0, *rest = args
            B = _cast(B, dtype)
        else:
            lo, hi, M0, *rest = args
            B = None
        fpm = _split_fpm(rest, kw)
        return getattr(_pf, driver)(_cast(A, dtype), B, lo, hi, M0, fpm,
                                    **flags, **kw)
    return alias


def _xify(fn):
    """x-variant: the trailing (Zne, Wne) positional arguments register a
    custom contour in the fpm[29] registry for the call (the reference's
    *x! routines through feast_contour_custom_weights)."""
    def xalias(*args, **kw):
        *base, Zne, Wne = args
        from ..core.aux import with_custom_contour
        from ..core.parameters import FeastParameters, feastinit
        contour = Contour(np.asarray(Zne, complex), np.asarray(Wne, complex))
        fpm = kw.pop("fpm", None)
        if fpm is None and base and _looks_like_fpm(base[-1]):
            fpm = base[-1]
            base = base[:-1]
        fpm = feastinit() if fpm is None else (
            fpm if isinstance(fpm, FeastParameters) else FeastParameters(fpm))
        with with_custom_contour(fpm, contour):
            return fn(*base, fpm=fpm, **kw)
    return xalias


def _build():
    out = {}
    for p, dt in _REAL.items():
        out[f"{p}feast_sygv"] = _make_dense_interval(dt, True, False)
        out[f"{p}feast_syev"] = _make_dense_interval(dt, False, False)
        out[f"{p}feast_sbgv"] = _make_banded_interval(dt, True, False)
        out[f"{p}feast_sbev"] = _make_banded_interval(dt, False, False)
        out[f"{p}feast_scsrgv"] = _make_sparse_interval(dt, True, False)
        out[f"{p}feast_scsrev"] = _make_sparse_interval(dt, False, False)
        out[f"{p}feast_sypev"] = _make_pep(dt)
        out[f"{p}feast_scsrpev"] = _make_sparse_pep(dt)
        out[f"{p}feast_srcipev"] = _make_rcipev(dt)
        # every i-name runs its inner solves iteratively
        out[f"{p}ifeast_sypev"] = _make_iter_pep(dt)
        out[f"{p}ifeast_scsrpev"] = _make_iter_pep(dt)
        out[f"{p}ifeast_srcipev"] = _make_rcipev(dt, iterative=True)
        out[f"{p}ifeast_sygv"] = _iterative_dense_interval(dt, True, False)
        out[f"{p}ifeast_syev"] = _iterative_dense_interval(dt, False, False)
        out[f"{p}ifeast_scsrgv"] = _make_sparse_interval(dt, True, False,
                                                         iterative=True)
        out[f"{p}ifeast_scsrev"] = _make_sparse_interval(dt, False, False,
                                                         iterative=True)
        out[f"{p}ifeast_sbgv"] = _iterative_banded_interval(dt, True, False)
        out[f"{p}ifeast_sbev"] = _iterative_banded_interval(dt, False, False)
        # parallel: the sharded drivers, and the parallel RCI machine
        out[f"p{p}feast_sygv"] = _make_parallel("pfeast_dense", dt, True,
                                                hermitian=False)
        out[f"p{p}feast_syev"] = _make_parallel("pfeast_dense", dt, False,
                                                hermitian=False)
        out[f"p{p}feast_scsrgv"] = _make_parallel("pfeast_sparse", dt, True,
                                                  hermitian=False)
        out[f"p{p}feast_scsrev"] = _make_parallel("pfeast_sparse", dt,
                                                  False, hermitian=False)
    out["psfeast_srci"] = psfeast_srci
    out["pdfeast_srci"] = pdfeast_srci
    for p, dt in _CPLX.items():
        out[f"{p}feast_hegv"] = _make_dense_interval(dt, True, True)
        out[f"{p}feast_heev"] = _make_dense_interval(dt, False, True)
        out[f"{p}feast_hbgv"] = _make_banded_interval(dt, True, True)
        out[f"{p}feast_hbev"] = _make_banded_interval(dt, False, True)
        out[f"{p}feast_hcsrgv"] = _make_sparse_interval(dt, True, True)
        out[f"{p}feast_hcsrev"] = _make_sparse_interval(dt, False, True)
        # complex symmetric: {c,z}feast_sy* / sb* / scsr* (the transpose
        # pairing in an ellipse)
        out[f"{p}feast_sygv"] = _make_dense_general(dt, True, True)
        out[f"{p}feast_syev"] = _make_dense_general(dt, False, True)
        out[f"{p}feast_sbgv"] = _make_banded_general(dt, True, True)
        out[f"{p}feast_sbev"] = _make_banded_general(dt, False, True)
        out[f"{p}feast_scsrgv"] = _make_sparse_general(dt, True, True)
        out[f"{p}feast_scsrev"] = _make_sparse_general(dt, False, True)
        out[f"{p}feast_gegv"] = _make_dense_general(dt, True, False)
        out[f"{p}feast_geev"] = _make_dense_general(dt, False, False)
        out[f"{p}feast_gbgv"] = _make_banded_general(dt, True, False)
        out[f"{p}feast_gbev"] = _make_banded_general(dt, False, False)
        out[f"{p}feast_gcsrgv"] = _make_sparse_general(dt, True, False)
        out[f"{p}feast_gcsrev"] = _make_sparse_general(dt, False, False)
        out[f"{p}feast_hepev"] = _make_pep(dt)
        out[f"{p}feast_gepev"] = _make_pep(dt)
        out[f"{p}feast_hcsrpev"] = _make_sparse_pep(dt)
        out[f"{p}feast_gcsrpev"] = _make_sparse_pep(dt)
        out[f"{p}feast_grcipev"] = _make_rcipev(dt)
        out[f"{p}ifeast_hepev"] = _make_iter_pep(dt)
        out[f"{p}ifeast_gepev"] = _make_iter_pep(dt)
        out[f"{p}ifeast_hcsrpev"] = _make_iter_pep(dt)
        out[f"{p}ifeast_gcsrpev"] = _make_iter_pep(dt)
        out[f"{p}ifeast_grcipev"] = _make_rcipev(dt, iterative=True)
        out[f"{p}ifeast_hegv"] = _iterative_dense_interval(dt, True, True)
        out[f"{p}ifeast_heev"] = _iterative_dense_interval(dt, False, True)
        out[f"{p}ifeast_hbgv"] = _iterative_banded_interval(dt, True, True)
        out[f"{p}ifeast_hbev"] = _iterative_banded_interval(dt, False, True)
        out[f"{p}ifeast_sbgv"] = _iterative_banded_general(dt, True, True)
        out[f"{p}ifeast_sbev"] = _iterative_banded_general(dt, False, True)
        out[f"{p}ifeast_gbgv"] = _iterative_banded_general(dt, True, False)
        out[f"{p}ifeast_gbev"] = _iterative_banded_general(dt, False, False)
        out[f"{p}ifeast_hcsrgv"] = _make_sparse_interval(dt, True, True,
                                                         iterative=True)
        out[f"{p}ifeast_hcsrev"] = _make_sparse_interval(dt, False, True,
                                                         iterative=True)
        out[f"{p}ifeast_gcsrgv"] = _make_sparse_general(dt, True, False,
                                                        iterative=True)
        out[f"{p}ifeast_gcsrev"] = _make_sparse_general(dt, False, False,
                                                        iterative=True)
        # parallel: dense names on the dense sharded drivers, sparse ones
        # on the sparse ones; the i-names take the sparse drivers' Krylov
        # inner solves for any operand
        for i, dense, sparse, gdense, gsparse in (
                ("", "pfeast_dense", "pfeast_sparse", "pfeast_general",
                 "pfeast_sparse_general"),
                ("i", "pfeast_sparse", "pfeast_sparse",
                 "pfeast_sparse_general", "pfeast_sparse_general")):
            for form, gen in (("gv", True), ("ev", False)):
                out[f"p{p}{i}feast_he{form}"] = _make_parallel(
                    dense, dt, gen, hermitian=True)
                out[f"p{p}{i}feast_hcsr{form}"] = _make_parallel(
                    sparse, dt, gen, hermitian=True)
                out[f"p{p}{i}feast_ge{form}"] = _make_parallel(
                    gdense, dt, gen, bilinear=False)
                out[f"p{p}{i}feast_gcsr{form}"] = _make_parallel(
                    gsparse, dt, gen, bilinear=False)

    # x-variants: every serial and iterative name gains an explicit
    # custom-contour form (the reference generates *x for all of them)
    x_real = ["feast_sygv", "feast_syev", "feast_sbgv", "feast_sbev",
              "feast_scsrgv", "feast_scsrev", "feast_sypev", "feast_scsrpev",
              "feast_srcipev", "ifeast_sypev", "ifeast_scsrpev",
              "ifeast_srcipev", "ifeast_sygv", "ifeast_syev", "ifeast_sbgv",
              "ifeast_sbev", "ifeast_scsrgv", "ifeast_scsrev"]
    x_cplx = ["feast_hegv", "feast_heev", "feast_hbgv", "feast_hbev",
              "feast_hcsrgv", "feast_hcsrev", "feast_sygv", "feast_syev",
              "feast_sbgv", "feast_sbev", "feast_scsrgv", "feast_scsrev",
              "feast_gegv", "feast_geev", "feast_gbgv", "feast_gbev",
              "feast_gcsrgv", "feast_gcsrev", "feast_hepev", "feast_gepev",
              "feast_hcsrpev", "feast_gcsrpev", "feast_grcipev",
              "ifeast_hepev", "ifeast_gepev", "ifeast_hcsrpev",
              "ifeast_gcsrpev", "ifeast_grcipev", "ifeast_hegv",
              "ifeast_heev", "ifeast_hbgv", "ifeast_hbev", "ifeast_sbgv",
              "ifeast_sbev", "ifeast_gbgv", "ifeast_gbev", "ifeast_hcsrgv",
              "ifeast_hcsrev", "ifeast_gcsrgv", "ifeast_gcsrev"]
    for p in _REAL:
        for k in x_real:
            out[f"{p}{k}x"] = _xify(out[f"{p}{k}"])
    for p in _CPLX:
        for k in x_cplx:
            out[f"{p}{k}x"] = _xify(out[f"{p}{k}"])

    # the unprefixed dtype-generic names keep the operand's dtype; the
    # package defines feast_sygv etc. as its typed drivers, so only their
    # x-variants come from here, and gepev / hepev plain and as x-variants
    # (FeastKit.jl:110)
    unpref = {
        "feast_sygv": _make_dense_interval(None, True, False),
        "feast_syev": _make_dense_interval(None, False, False),
        "feast_hegv": _make_dense_interval(None, True, True),
        "feast_heev": _make_dense_interval(None, False, True),
        "feast_gegv": _make_dense_general(None, True, False),
        "feast_geev": _make_dense_general(None, False, False),
        "feast_sbgv": _make_banded_interval(None, True, False),
        "feast_sbev": _make_banded_interval(None, False, False),
        "feast_hbgv": _make_banded_interval(None, True, True),
        "feast_hbev": _make_banded_interval(None, False, True),
        "feast_gbgv": _make_banded_general(None, True, False),
        "feast_gbev": _make_banded_general(None, False, False),
        "feast_scsrgv": _make_sparse_interval(None, True, False),
        "feast_scsrev": _make_sparse_interval(None, False, False),
        "feast_hcsrgv": _make_sparse_interval(None, True, True),
        "feast_hcsrev": _make_sparse_interval(None, False, True),
        "feast_gcsrgv": _make_sparse_general(None, True, False),
        "feast_gcsrev": _make_sparse_general(None, False, False),
        "feast_scsrpev": _make_sparse_pep(None),
        "feast_hcsrpev": _make_sparse_pep(None),
        "feast_gcsrpev": _make_sparse_pep(None),
        "feast_sypev": _make_pep(None),
        "feast_hepev": _make_pep(None),
        "feast_gepev": _make_pep(None),
    }
    for k, fn in unpref.items():
        out[f"{k}x"] = _xify(fn)
    out["feast_gepev"] = unpref["feast_gepev"]
    out["feast_hepev"] = unpref["feast_hepev"]
    return out


_ALIASES = _build()
globals().update(_ALIASES)
__all__ = sorted(_ALIASES)
