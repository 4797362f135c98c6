"""``mx.np.linalg`` over ``torch.linalg``.

Counterpart of ``mxnet_tpu/numpy/linalg.py`` (which delegates to
``jnp.linalg``): the 19 functions of the reference's frontend
(``tests/test_op_coverage.py`` ``REF_LINALG``), each through
``multiarray._invoke`` under ``linalg.<name>``, with the reference's
result dtypes (an integer input computes in float32, ``matrix_rank`` gives
int32) and its NamedTuple results (``EigResult``, ``EighResult``,
``QRResult``, ``SlogdetResult``, ``SVDResult``; ``lstsq`` a plain tuple).

``eig`` / ``eigvals`` (general, non-symmetric eigendecomposition) run on
the host, as the reference's do on an accelerator (its
``numpy/linalg.py:23-58``, after the reference C++ library's CPU-only
LAPACK ``geev``): the input is copied to the CPU, decomposed by
``torch.linalg.eig`` there, and the complex result is put back on the
input's device. This is the reference's own design, not a fallback; like
the reference's, these two have no gradient.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import _ops
from .multiarray import _invoke

__all__ = ["cholesky", "det", "eig", "eigh", "eigvals", "eigvalsh", "inv",
           "lstsq", "matrix_power", "matrix_rank", "multi_dot", "norm",
           "pinv", "qr", "slogdet", "solve", "svd", "tensorinv",
           "tensorsolve"]


class EigResult(NamedTuple):
    eigenvalues: object
    eigenvectors: object


class EighResult(NamedTuple):
    eigenvalues: object
    eigenvectors: object


class QRResult(NamedTuple):
    Q: object
    R: object


class SlogdetResult(NamedTuple):
    sign: object
    logabsdet: object


class SVDResult(NamedTuple):
    U: object
    S: object
    Vh: object


def _f(x):
    return _ops._to_float(_ops._t(x))


def _op(fn, name):
    def op(*args, **kwargs):
        return _invoke(fn, args, kwargs, name=f"linalg.{name}")
    op.__name__ = name
    op.__doc__ = fn.__doc__
    return op


def _cholesky(a, upper=False, symmetrize_input=True):
    L = torch.linalg.cholesky(_f(a))
    return L.mT.conj() if upper else L


def _det(a):
    return torch.linalg.det(_f(a))


def _host_eig(a):
    """``torch.linalg.eig`` on the host, the result on ``a``'s device."""
    x = _f(a)
    w, v = torch.linalg.eig(x.detach().cpu())
    return w.to(x.device), v.to(x.device)


def _eig(a):
    """Eigenvalues and right eigenvectors of a general matrix, complex
    (on the host; see the module docstring)."""
    return EigResult(*_host_eig(a))


def _eigvals(a):
    """Eigenvalues of a general matrix, complex (on the host)."""
    return _host_eig(a)[0]


def _eigh(a, UPLO="L", symmetrize_input=True):
    w, v = torch.linalg.eigh(_f(a), UPLO=UPLO)
    return EighResult(w, v)


def _eigvalsh(a, UPLO="L"):
    return torch.linalg.eigvalsh(_f(a), UPLO=UPLO)


def _inv(a):
    return torch.linalg.inv(_f(a))


def _lstsq(a, b, rcond=None, numpy_resid=False):
    """(x, residuals, rank, singular values), NumPy's rule: singular values
    below ``rcond`` (default eps x max(m, n)) of the largest are cut; the
    residuals are the squared column norms of ``b - a x`` when ``a`` is
    tall and of full rank, else empty; the rank is int32."""
    a, b = _f(a), _f(b)
    m, n = a.shape[-2], a.shape[-1]
    rc = max(m, n) * torch.finfo(a.dtype).eps \
        if rcond is None or rcond < 0 else rcond
    s = torch.linalg.svdvals(a)
    rank = (s > rc * s[..., :1]).sum(-1).to(torch.int32)
    col = b if b.ndim == a.ndim else b.unsqueeze(-1)
    x = torch.linalg.pinv(a, rtol=rc) @ col
    if m > n and int(rank) == n:
        r = col - a @ x
        resid = (r * r).sum(-2)
    else:
        resid = torch.zeros((0,), dtype=a.dtype, device=a.device)
    if b.ndim != a.ndim:
        x = x.squeeze(-1)
    return x, resid, rank, s


def _matrix_power(a, n):
    a = _ops._t(a)
    if n < 0:
        a = _f(a)
    return torch.linalg.matrix_power(a, n)


def _matrix_rank(M, rtol=None, hermitian=False, tol=None):
    x = _f(M)
    if x.ndim < 2:
        return (x != 0).any().to(torch.int32)
    s = torch.linalg.svdvals(x)
    if tol is None:
        r = max(x.shape[-2:]) * torch.finfo(x.dtype).eps \
            if rtol is None else rtol
        tol = s.amax(-1, keepdim=True) * r
    return (s > tol).sum(-1).to(torch.int32)


def _multi_dot(arrays):
    xs = _ops._promote_all(arrays)
    first, last = xs[0], xs[-1]
    if first.ndim == 1:
        xs[0] = first.unsqueeze(0)
    if last.ndim == 1:
        xs[-1] = last.unsqueeze(-1)
    out = torch.linalg.multi_dot(xs)
    if first.ndim == 1:
        out = out.squeeze(0)
    if last.ndim == 1:
        out = out.squeeze(-1)
    return out


def _norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    """NumPy's norm: the Frobenius / 2-norm of everything when ``ord`` and
    ``axis`` are None; otherwise a vector norm over one axis or a matrix
    norm over two."""
    x = _f(x)
    if axis is None and ord is None:
        out = torch.linalg.vector_norm(x.reshape(-1), 2)
        return out.reshape((1,) * x.ndim) if keepdims else out
    if axis is None:
        axis = tuple(range(x.ndim)) if x.ndim <= 2 else None
    if isinstance(axis, int) or (isinstance(axis, tuple) and len(axis) == 1):
        ax = axis if isinstance(axis, int) else axis[0]
        o = 2 if ord is None else ord
        return torch.linalg.vector_norm(x, o, dim=ax, keepdim=keepdims)
    if len(axis) == 1:
        return torch.linalg.vector_norm(x, 2 if ord is None else ord,
                                        dim=axis[0], keepdim=keepdims)
    o = "fro" if ord is None else ord
    return torch.linalg.matrix_norm(x, o, dim=tuple(axis), keepdim=keepdims)


def _pinv(a, rtol=None, hermitian=False, rcond=None):
    x = _f(a)
    tol = rcond if rcond is not None else rtol
    if tol is None:
        tol = max(x.shape[-2:]) * torch.finfo(x.dtype).eps
    return torch.linalg.pinv(x, rtol=tol, hermitian=hermitian)


def _qr(a, mode="reduced"):
    q, r = torch.linalg.qr(_f(a), mode=mode)
    if mode == "r":
        return r
    return QRResult(q, r)


def _slogdet(a):
    sign, logabs = torch.linalg.slogdet(_f(a))
    return SlogdetResult(sign, logabs)


def _solve(a, b):
    a, b = _f(a), _f(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.linalg.solve(a.to(dt), b.to(dt))


def _svd(a, full_matrices=True, compute_uv=True, hermitian=False):
    x = _f(a)
    if not compute_uv:
        return torch.linalg.svdvals(x)
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return SVDResult(u, s, vh)


def _tensorinv(a, ind=2):
    x = _f(a)
    if ind <= 0:
        raise MXNetError("ind must be a positive integer")
    out_shape = tuple(x.shape[ind:]) + tuple(x.shape[:ind])
    rows = math.prod(x.shape[:ind])
    inv = torch.linalg.inv(x.reshape(rows, -1))
    return inv.reshape(out_shape)


def _tensorsolve(a, b, axes=None):
    a, b = _f(a), _f(b)
    if axes is not None:
        rest = [i for i in range(a.ndim) if i not in axes]
        a = a.permute(rest + list(axes))
    q = a.shape[b.ndim:]
    n = math.prod(q)
    x = torch.linalg.solve(a.reshape(-1, n), b.reshape(-1))
    return x.reshape(q)


cholesky = _op(_cholesky, "cholesky")
det = _op(_det, "det")
eig = _op(_eig, "eig")
eigh = _op(_eigh, "eigh")
eigvals = _op(_eigvals, "eigvals")
eigvalsh = _op(_eigvalsh, "eigvalsh")
inv = _op(_inv, "inv")
lstsq = _op(_lstsq, "lstsq")
matrix_power = _op(_matrix_power, "matrix_power")
matrix_rank = _op(_matrix_rank, "matrix_rank")
norm = _op(_norm, "norm")
pinv = _op(_pinv, "pinv")
qr = _op(_qr, "qr")
slogdet = _op(_slogdet, "slogdet")
solve = _op(_solve, "solve")
svd = _op(_svd, "svd")
tensorinv = _op(_tensorinv, "tensorinv")
tensorsolve = _op(_tensorsolve, "tensorsolve")


def multi_dot(arrays, out=None):
    return _invoke(lambda xs: _multi_dot(list(xs)), (tuple(arrays),),
                   name="linalg.multi_dot")


def __getattr__(name):
    raise AttributeError(f"module 'mxnet_tpu_torch.numpy.linalg' has no "
                         f"attribute {name!r}")
