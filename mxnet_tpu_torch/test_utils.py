"""``mx.test_utils``: the oracles of the tests.

Counterpart of ``mxnet_tpu/test_utils.py`` (reference:
python/mxnet/test_utils.py): ``assert_almost_equal`` with dtype-aware
default tolerances, ``check_numeric_gradient`` (central finite
differences, evaluated in float64), ``check_consistency`` (the same
function on the CPU and the card), the environment and random-shape
helpers, and the statistical checks of samplers (``chi_square_check`` /
``verify_generator``). Every helper takes ``mx.np`` arrays, ``torch``
tensors and NumPy arrays alike; bf16 is compared widened to float32.

Beyond the reference, ``assert_almost_equal`` takes ``scale_atol`` (the
absolute tolerance as a share of the largest finite ``|b|``) and
``check_dtype`` (the dtypes must match by name): the port's parity tests
state their tolerances that way.
"""
from __future__ import annotations

import contextlib
import os
import random as _pyrandom
import time

import numpy as onp
import torch

from .base import MXNetError

_DTYPE_TOL = {
    "bfloat16": (1e-2, 1e-2),
    "float16": (1e-2, 1e-2),
    "float32": (1e-4, 1e-5),
    "float64": (1e-6, 1e-8),
}


def _dtype_name(a):
    dt = getattr(a, "dtype", None)
    if dt is None:
        return onp.asarray(a).dtype.name
    if isinstance(dt, torch.dtype):
        return str(dt)[6:]
    return getattr(dt, "name", str(dt))


def default_rtol_atol(*arrays):
    """(rtol, atol) for comparing ``arrays``: the loosest of their dtypes'
    (bf16 / fp16 1e-2, fp32 1e-4 / 1e-5, fp64 1e-6 / 1e-8), at least
    1e-5 / 1e-7."""
    rtol, atol = 1e-5, 1e-7
    for a in arrays:
        r, t = _DTYPE_TOL.get(_dtype_name(a), (rtol, atol))
        rtol, atol = max(rtol, r), max(atol, t)
    return rtol, atol


def _to_np(a):
    """A host NumPy array of an ``ndarray``, tensor or array-like (bf16
    widened to float32)."""
    if hasattr(a, "asnumpy"):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        t = a.detach()
        return (t.float() if t.dtype is torch.bfloat16 else t).cpu().numpy()
    return onp.asarray(a)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False, scale_atol=False, check_dtype=False):
    """``|a - b| <= atol + rtol |b|`` elementwise (reference:
    test_utils.py:656), the shapes equal; a missing tolerance is the
    dtypes' default (:func:`default_rtol_atol`). ``scale_atol`` makes
    ``atol`` a share of the largest finite ``|b|``; ``check_dtype``
    requires the same dtype name."""
    if check_dtype:
        assert _dtype_name(a) == _dtype_name(b), \
            f"{names[0]} vs {names[1]}: dtype {_dtype_name(a)} vs " \
            f"{_dtype_name(b)}"
    r, t = default_rtol_atol(a, b)
    rtol = r if rtol is None else rtol
    atol = t if atol is None else atol
    a_np, b_np = _to_np(a), _to_np(b)
    assert a_np.shape == b_np.shape, \
        f"{names[0]} vs {names[1]}: shape {a_np.shape} vs {b_np.shape}"
    if a_np.dtype.kind in "biu" and b_np.dtype.kind in "biu" \
            and not rtol and not atol:
        onp.testing.assert_array_equal(a_np, b_np,
                                       err_msg=f"{names[0]} vs {names[1]}")
        return
    b64 = b_np.astype(onp.float64) if b_np.dtype.kind != "c" else b_np
    if scale_atol:
        fin = b64[onp.isfinite(b64)]
        atol = atol * (float(onp.abs(fin).max()) if fin.size else 0.0)
    onp.testing.assert_allclose(
        a_np.astype(onp.float64) if a_np.dtype.kind != "c" else a_np, b64,
        rtol=rtol, atol=atol, equal_nan=equal_nan,
        err_msg=f"{names[0]} vs {names[1]}")


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    try:
        assert_almost_equal(a, b, rtol, atol, equal_nan=equal_nan)
        return True
    except AssertionError:
        return False


def assert_allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=True):
    """NumPy-style allclose assert (reference: test_utils.py)."""
    onp.testing.assert_allclose(_to_np(a), _to_np(b), rtol=rtol, atol=atol,
                                equal_nan=equal_nan)


def same(a, b):
    return onp.array_equal(_to_np(a), _to_np(b))


def same_array(a, b):
    """Whether two arrays share storage (reference: test_utils.py
    ``same_array``)."""
    ra = getattr(a, "_data", a)
    rb = getattr(b, "_data", b)
    return ra.untyped_storage().data_ptr() == rb.untyped_storage() \
        .data_ptr()


def check_numeric_gradient(f, inputs, grads=None, eps=1e-3, rtol=1e-2,
                           atol=1e-4):
    """Central finite differences against autograd (reference:
    test_utils.py:1044). ``f(list of arrays)`` returns an array whose sum
    is differentiated; ``inputs`` are ``mx.np`` arrays (they get
    ``attach_grad``) unless ``grads`` gives the analytic gradients. The
    differences perturb and evaluate ``f`` in float64."""
    from . import autograd
    from .numpy import array

    if grads is None:
        for x in inputs:
            x.attach_grad()
        with autograd.record():
            out = f(inputs)
        out.backward()
        grads = [_to_np(x.grad) for x in inputs]
    ctx = inputs[0].ctx if inputs and hasattr(inputs[0], "ctx") else None
    for xi, x in enumerate(inputs):
        base = _to_np(x).astype(onp.float64)
        num = onp.zeros_like(base)
        flat, nflat = base.reshape(-1), num.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            vals = []
            for v in (orig + eps, orig - eps):
                flat[i] = v
                xs = list(inputs)
                xs[xi] = array(base.reshape(x.shape), dtype="float64",
                               ctx=ctx)
                vals.append(float(_to_np(f(xs)).sum()))
            flat[i] = orig
            nflat[i] = (vals[0] - vals[1]) / (2 * eps)
        onp.testing.assert_allclose(_to_np(grads[xi]), num, rtol=rtol,
                                    atol=atol,
                                    err_msg=f"input {xi} gradient mismatch")


def check_consistency(fn, inputs, ctx_list=None, rtol=1e-4, atol=1e-5):
    """``fn(list of arrays)`` on each context of ``ctx_list`` (default:
    the CPU, and the card where there is one), compared with the first
    (reference: test_utils.py:1491). Returns the results."""
    from .context import cpu, gpu, num_gpus
    from .numpy import array
    if ctx_list is None:
        ctx_list = [cpu(0)] + ([gpu(0)] if num_gpus() else [])
    results = []
    for ctx in ctx_list:
        placed = [array(_to_np(x), dtype=_dtype_name(x), ctx=ctx)
                  for x in inputs]
        with ctx:
            results.append(fn(placed))
    for r in results[1:]:
        assert_almost_equal(r, results[0], rtol, atol)
    return results


@contextlib.contextmanager
def environment(*args):
    """Scoped environment variables (reference: test_utils.py
    ``environment``): ``environment(name, value)`` or a dict; None
    unsets."""
    updates = {args[0]: args[1]} if len(args) == 2 else args[0]
    old = {k: os.environ.get(k) for k in updates}
    try:
        for k, v in updates.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rand_ndarray(shape, dtype="float32", scale=1.0, ctx=None):
    from .numpy import random as npr
    return npr.uniform(-scale, scale, size=shape, dtype=dtype, ctx=ctx)


def rand_shape_nd(ndim, dim=10):
    return tuple(onp.random.randint(1, dim + 1, size=ndim).tolist())


def rand_shape_2d(dim0=10, dim1=10):
    return (onp.random.randint(1, dim0 + 1),
            onp.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (onp.random.randint(1, dim0 + 1),
            onp.random.randint(1, dim1 + 1),
            onp.random.randint(1, dim2 + 1))


def rand_coord_2d(x_low, x_high, y_low, y_high):
    return (onp.random.randint(x_low, x_high),
            onp.random.randint(y_low, y_high))


def random_arrays(*shapes):
    """Random float32 host arrays; one shape gives one array. A shape is a
    tuple, an int (1-d) or () (0-d)."""
    def one(s):
        if isinstance(s, int):
            s = (s,)
        elif not isinstance(s, (list, tuple)):
            raise MXNetError(f"shape must be int or tuple, got {s!r}")
        if len(s) == 0:
            return onp.asarray(onp.random.randn(), "float32")
        return onp.random.randn(*s).astype("float32")
    arrays = [one(s) for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def random_sample(population, k):
    """``k`` of ``population`` without replacement."""
    return _pyrandom.sample(list(population), k)


def effective_dtype(x):
    return x.dtype


def default_context():
    from .context import current_context
    return current_context()


def set_default_context(ctx):
    ctx.__enter__()


def list_gpus():
    from .context import num_gpus
    return list(range(num_gpus()))


def assert_exception(f, exception_type, *args, **kwargs):
    """Assert that ``f(*args, **kwargs)`` raises ``exception_type``."""
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError(f"{f} did not raise {exception_type.__name__}")


def check_speed(f, *args, n=20, warmup=3, **kwargs):
    """Seconds per call of ``f`` (the card synchronized around the
    timing)."""
    from .numpy_extension import waitall
    for _ in range(warmup):
        f(*args, **kwargs)
    waitall()
    t0 = time.perf_counter()
    for _ in range(n):
        f(*args, **kwargs)
    waitall()
    return (time.perf_counter() - t0) / n


def gen_buckets_probs_with_ppf(ppf, num_buckets):
    """Equal-probability buckets from a percent-point function."""
    probs = [1.0 / num_buckets] * num_buckets
    edges = [ppf(i / num_buckets) for i in range(num_buckets + 1)]
    return [(edges[i], edges[i + 1]) for i in range(num_buckets)], probs


def chi_square_check(generator, buckets, probs, nsamples=1000000):
    """Chi-square goodness of fit of a sampler (reference:
    test_utils.py:2108): (p value, observed, expected). ``buckets`` are
    (low, high) ranges or discrete values."""
    samples = _to_np(generator(nsamples)).ravel()
    obs = onp.zeros(len(buckets))
    if isinstance(buckets[0], (tuple, list)):
        for i, (lo, hi) in enumerate(buckets):
            obs[i] = ((samples >= lo) & (samples < hi)).sum()
    else:
        for i, v in enumerate(buckets):
            obs[i] = (samples == v).sum()
    exp = onp.asarray(probs, "float64") * samples.size
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    df = len(buckets) - 1
    p = float(torch.special.gammaincc(
        torch.tensor(df / 2.0, dtype=torch.float64),
        torch.tensor(chi2 / 2.0, dtype=torch.float64)))
    return p, obs, exp


def verify_generator(generator, buckets, probs, nsamples=1000000,
                     nrepeat=5, success_rate=0.25, alpha=0.05):
    """Repeat :func:`chi_square_check`; pass when at least
    ``success_rate`` of the repeats clear ``alpha``."""
    ps = [chi_square_check(generator, buckets, probs, nsamples)[0]
          for _ in range(nrepeat)]
    if sum(p > alpha for p in ps) / nrepeat < success_rate:
        raise AssertionError(
            f"generator failed the chi-square test: p values {ps} "
            f"(needed {success_rate:.0%} above alpha={alpha})")
    return ps
