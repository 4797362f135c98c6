"""``mx.np.random``: the reference's samplers on the port's generators.

Counterpart of ``mxnet_tpu/numpy/random.py``, where every sampler splits
a subkey off the process-global threefry key. Here each draws from the
default ``torch.Generator`` of its device (``mxnet_tpu_torch/random.py``:
``np.random.seed(s)`` is ``mx.random.seed(s)``) or from an explicit
``generator=``. Shapes and dtypes are the reference's: float samplers give
float32 (or ``dtype=``), ``randint`` / ``choice`` of an int /
``permutation`` of an int / ``poisson`` give int32, ``multinomial`` gives
float32 counts; ``size=None`` gives a 0-d array, or the parameters' shape.
The streams are torch's (Philox on the card), so the draws are held
statistically, not bit for bit, against the reference. Each sampler is a
composition of torch's uniform, normal, gamma, Poisson and multinomial
draws (the inverse CDF where torch has no sampler with a generator).

Arrays are placed on ``ctx`` / ``device``, else on the device of an array
parameter, else on the current context.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from .multiarray import _wrap, ndarray

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint", "choice",
           "shuffle", "permutation", "multinomial", "bernoulli", "gamma",
           "beta", "exponential", "poisson", "laplace", "gumbel",
           "lognormal", "chisquare", "rayleigh", "weibull", "pareto",
           "power", "logistic", "f", "multivariate_normal"]


def seed(s, ctx="all"):
    """Seed the default generators (``mx.random.seed``)."""
    _random.seed(s, ctx if ctx == "all" else resolve_device(ctx))


def _raw(x):
    return x._data if isinstance(x, ndarray) else x


def _device(ctx, device, *params):
    if device is not None or ctx is not None:
        return resolve_device(device if device is not None else ctx)
    for p in params:
        p = _raw(p)
        if isinstance(p, torch.Tensor):
            return p.device
    return resolve_device(None)


def _gen(dev, generator):
    gen = generator if generator is not None \
        else _random.default_generator(dev)
    _random.note_draw(gen)
    return gen


def _shape(size, *params):
    """``size`` as a tuple; None: the broadcast shape of the array
    parameters (a 0-d array for scalars)."""
    if size is None:
        shapes = [tuple(_raw(p).shape) for p in params
                  if isinstance(_raw(p), torch.Tensor)]
        return tuple(torch.broadcast_shapes(*shapes)) if shapes else ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _param(p, dev, dt):
    p = _raw(p)
    if isinstance(p, torch.Tensor):
        return p.to(device=dev, dtype=dt)
    if not isinstance(p, (int, float)):
        p = torch.as_tensor(p, dtype=dt)
        return p.to(dev)
    return p


def _fdt(dtype):
    return torch_dtype(dtype) or torch.float32


def _uniform01(shape, dev, gen, dt=torch.float32, open_low=True):
    """U(0, 1), kept off 0 (for the logs of the inverse CDFs)."""
    u = torch.rand(shape, generator=gen, device=dev, dtype=dt)
    if open_low:
        u = u.clamp_min(torch.finfo(dt).tiny)
    return u


def _std_gamma(alpha, shape, dev, gen):
    a = torch.broadcast_to(torch.as_tensor(alpha, dtype=torch.float32,
                                           device=dev), shape).contiguous()
    return torch._standard_gamma(a, generator=gen)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, device=None,
            out=None, generator=None):
    dev = _device(ctx, device, low, high)
    dt = _fdt(dtype)
    shape = _shape(size, low, high)
    u = torch.rand(shape, generator=_gen(dev, generator), device=dev,
                   dtype=torch.float32)
    lo, hi = _param(low, dev, torch.float32), _param(high, dev, torch.float32)
    return _wrap((lo + u * (hi - lo)).to(dt))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, device=None,
           out=None, generator=None):
    dev = _device(ctx, device, loc, scale)
    dt = _fdt(dtype)
    shape = _shape(size, loc, scale)
    z = torch.randn(shape, generator=_gen(dev, generator), device=dev,
                    dtype=torch.float32)
    return _wrap((z * _param(scale, dev, torch.float32)
                  + _param(loc, dev, torch.float32)).to(dt))


randn_shape = None


def randn(*size, dtype=None, ctx=None, device=None, generator=None):
    return normal(size=size, dtype=dtype, ctx=ctx, device=device,
                  generator=generator)


def rand(*size, dtype=None, ctx=None, device=None, generator=None):
    return uniform(size=size, dtype=dtype, ctx=ctx, device=device,
                   generator=generator)


def randint(low, high=None, size=None, dtype=None, ctx=None, device=None,
            out=None, generator=None):
    if high is None:
        low, high = 0, low
    dev = _device(ctx, device)
    draw = torch.randint(int(low), int(high), _shape(size),
                         generator=_gen(dev, generator), device=dev)
    return _wrap(draw.to(torch_dtype(dtype) or torch.int32))


def choice(a, size=None, replace=True, p=None, ctx=None, device=None,
           out=None, generator=None):
    dev = _device(ctx, device, a, p)
    gen = _gen(dev, generator)
    pool = _raw(a)
    n = pool if isinstance(pool, int) else pool.shape[0]
    shape = _shape(size)
    k = math.prod(shape)
    if p is not None:
        probs = _param(p, dev, torch.float32)
        idx = torch.multinomial(probs, k, replacement=replace,
                                generator=gen)
    elif replace:
        idx = torch.randint(0, n, (k,), generator=gen, device=dev)
    else:
        if k > n:
            raise MXNetError("cannot take a larger sample than the "
                             "population without replacement")
        idx = torch.randperm(n, generator=gen, device=dev)[:k]
    if isinstance(pool, int):
        return _wrap(idx.to(torch.int32).reshape(shape))
    return _wrap(pool.to(dev)[idx].reshape(shape + tuple(pool.shape[1:])))


def shuffle(x, generator=None):
    """Shuffle ``x`` along axis 0 in place (reference:
    ``np.random.shuffle``): ``x`` is rebound to the permuted copy."""
    dev = x._data.device
    perm = torch.randperm(x.shape[0], generator=_gen(dev, generator),
                          device=dev)
    x._rebind(x._data[perm])


def permutation(x, ctx=None, device=None, generator=None):
    if isinstance(x, int):
        dev = _device(ctx, device)
        return _wrap(torch.randperm(x, generator=_gen(dev, generator),
                                    device=dev).to(torch.int32))
    t = _raw(x)
    perm = torch.randperm(t.shape[0], generator=_gen(t.device, generator),
                          device=t.device)
    return _wrap(t[perm])


def multinomial(n, pvals, size=None, ctx=None, device=None, generator=None):
    """Counts of ``n`` draws over ``pvals`` (float32, as the reference's),
    shape ``size + (len(pvals),)``."""
    dev = _device(ctx, device, pvals)
    probs = _param(pvals, dev, torch.float32)
    if not isinstance(probs, torch.Tensor):
        probs = torch.tensor(probs, dtype=torch.float32, device=dev)
    shape = _shape(size)
    rows = math.prod(shape)
    draws = torch.multinomial(probs.expand(rows, -1), int(n),
                              replacement=True,
                              generator=_gen(dev, generator))
    counts = torch.zeros(rows, probs.shape[-1], dtype=torch.float32,
                         device=dev)
    counts.scatter_add_(1, draws, torch.ones_like(draws,
                                                  dtype=torch.float32))
    return _wrap(counts.reshape(shape + (probs.shape[-1],)))


def bernoulli(prob=None, logit=None, size=None, dtype=None, ctx=None,
              device=None, generator=None):
    if (prob is None) == (logit is None):
        raise MXNetError("pass exactly one of prob or logit")
    src = prob if prob is not None else logit
    dev = _device(ctx, device, src)
    p = _param(src, dev, torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    if logit is not None:
        p = torch.sigmoid(p)
    shape = _shape(size, src)
    p = torch.broadcast_to(p, shape).contiguous()
    return _wrap(torch.bernoulli(p, generator=_gen(dev, generator))
                 .to(_fdt(dtype)))


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, device=None,
          out=None, generator=None):
    dev = _device(ctx, device, shape, scale)
    sz = _shape(size, shape, scale)
    g = _std_gamma(_param(shape, dev, torch.float32), sz, dev,
                   _gen(dev, generator))
    return _wrap((g * _param(scale, dev, torch.float32)).to(_fdt(dtype)))


def beta(a, b, size=None, dtype=None, ctx=None, device=None,
         generator=None):
    dev = _device(ctx, device, a, b)
    sz = _shape(size, a, b)
    gen = _gen(dev, generator)
    x = _std_gamma(_param(a, dev, torch.float32), sz, dev, gen)
    y = _std_gamma(_param(b, dev, torch.float32), sz, dev, gen)
    return _wrap((x / (x + y)).to(_fdt(dtype)))


def exponential(scale=1.0, size=None, dtype=None, ctx=None, device=None,
                out=None, generator=None):
    dev = _device(ctx, device, scale)
    u = _uniform01(_shape(size, scale), dev, _gen(dev, generator))
    return _wrap((-torch.log(u) * _param(scale, dev, torch.float32))
                 .to(_fdt(dtype)))


def poisson(lam=1.0, size=None, dtype=None, ctx=None, device=None, out=None,
            generator=None):
    dev = _device(ctx, device, lam)
    sz = _shape(size, lam)
    rate = torch.broadcast_to(torch.as_tensor(_param(lam, dev, torch.float32),
                                              dtype=torch.float32,
                                              device=dev), sz).contiguous()
    return _wrap(torch.poisson(rate, generator=_gen(dev, generator))
                 .to(torch_dtype(dtype) or torch.int32))


def _location_scale(draw):
    """A sampler ``loc + scale * draw(u)`` of a standard variate from
    U(0, 1)."""
    def sampler(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None,
                device=None, out=None, generator=None):
        dev = _device(ctx, device, loc, scale)
        u = _uniform01(_shape(size, loc, scale), dev, _gen(dev, generator))
        return _wrap((draw(u) * _param(scale, dev, torch.float32)
                      + _param(loc, dev, torch.float32)).to(_fdt(dtype)))
    return sampler


laplace = _location_scale(
    lambda u: -torch.sign(u - 0.5) * torch.log1p(-2 * torch.abs(u - 0.5)))
gumbel = _location_scale(lambda u: -torch.log(-torch.log(u)))
logistic = _location_scale(lambda u: torch.log(u) - torch.log1p(-u))
laplace.__name__, gumbel.__name__, logistic.__name__ = \
    "laplace", "gumbel", "logistic"


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, ctx=None,
              device=None, out=None, generator=None):
    return _wrap(torch.exp(normal(mean, sigma, size, "float32", ctx, device,
                                  generator=generator)._data)
                 .to(_fdt(dtype)))


def chisquare(df, size=None, dtype=None, ctx=None, device=None,
              generator=None):
    dev = _device(ctx, device, df)
    sz = _shape(size, df)
    half = _param(df, dev, torch.float32) / 2.0
    return _wrap((2.0 * _std_gamma(half, sz, dev, _gen(dev, generator)))
                 .to(_fdt(dtype)))


def rayleigh(scale=1.0, size=None, dtype=None, ctx=None, device=None,
             out=None, generator=None):
    dev = _device(ctx, device, scale)
    u = _uniform01(_shape(size, scale), dev, _gen(dev, generator))
    return _wrap((_param(scale, dev, torch.float32)
                  * torch.sqrt(-2.0 * torch.log(u))).to(_fdt(dtype)))


def _shape_param(transform):
    """A sampler of one shape parameter ``a`` from U(0, 1)."""
    def sampler(a, size=None, ctx=None, device=None, out=None,
                generator=None):
        dev = _device(ctx, device, a)
        u = _uniform01(_shape(size, a), dev, _gen(dev, generator))
        return _wrap(transform(u, _param(a, dev, torch.float32)))
    return sampler


weibull = _shape_param(lambda u, a: (-torch.log(u)) ** (1.0 / a))
pareto = _shape_param(lambda u, a: u ** (-1.0 / a) - 1.0)
power = _shape_param(lambda u, a: u ** (1.0 / a))
weibull.__name__, pareto.__name__, power.__name__ = \
    "weibull", "pareto", "power"


def f(dfnum, dfden, size=None, ctx=None, device=None, out=None,
      generator=None):
    dev = _device(ctx, device, dfnum, dfden)
    sz = _shape(size, dfnum, dfden)
    gen = _gen(dev, generator)
    num = _param(dfnum, dev, torch.float32)
    den = _param(dfden, dev, torch.float32)
    c1 = 2.0 * _std_gamma(num / 2.0, sz, dev, gen)
    c2 = 2.0 * _std_gamma(den / 2.0, sz, dev, gen)
    return _wrap((c1 / num) / (c2 / den))


def multivariate_normal(mean, cov, size=None, check_valid=None, tol=None,
                        ctx=None, device=None, generator=None):
    dev = _device(ctx, device, mean, cov)
    mu = torch.as_tensor(_param(mean, dev, torch.float32),
                         dtype=torch.float32, device=dev)
    sigma = torch.as_tensor(_param(cov, dev, torch.float32),
                            dtype=torch.float32, device=dev)
    chol = torch.linalg.cholesky(sigma)
    shape = _shape(size) + (mu.shape[-1],)
    z = torch.randn(shape, generator=_gen(dev, generator), device=dev)
    return _wrap(mu + z @ chol.T)
