"""Parameter initializers.

Counterpart of ``mxnet_tpu/initializer.py``: the registry (``register``,
``create``, ``alias``), the same name dispatch (``gamma`` -> ones;
``beta``/``bias``/``mean`` -> zeros; ``running_var`` -> ones; everything
else the initializer's own rule; an ``InitDesc`` whose ``attrs`` carry
``__init__`` takes that initializer instead), the same default,
``Uniform(0.07)``, and the reference's initializers: ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Xavier`` (``rnd_type`` "uniform"
or "gaussian", ``factor_type`` "avg" / "in" / "out", fan-in ``shape[1] x
prod(shape[2:])`` and fan-out ``shape[0] x prod(shape[2:])``),
``MSRAPrelu``, ``Orthogonal``, ``LSTMBias``, ``Bilinear``, ``Mixed``,
``InitDesc`` and ``Load``.

``init(name, arr, generator)`` fills a tensor in place (a block's
parameter), drawing from ``generator`` or else the default generator of
its device (``random.default_generator``, which ``random.seed`` reseeds);
``init(name, arr)`` / ``init(arr)`` with an ``mx.np`` array rebinds the
array to the filled values, as the reference's ``arr._rebind`` does. The
draws are torch's, so only the deterministic initializers (Zero, One,
Constant, LSTMBias, Bilinear, Load) give the reference's values.
"""
from __future__ import annotations

import json
import logging
import math
import re

import numpy as onp
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "Orthogonal", "LSTMBias",
           "Bilinear", "Mixed", "Load", "register", "create", "alias"]

_REGISTRY: dict = {}


def register(klass):
    """Register an initializer class under its lower-case name (reference:
    ``mx.init.register``)."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def alias(*names):
    """Register the decorated class under ``names`` as well."""
    def deco(klass):
        for n in names:
            _REGISTRY[n.lower()] = klass
        return register(klass)
    return deco


def create(spec, **kwargs):
    """An initializer from an instance, a registered name, a JSON
    ``'["name", {kwargs}]'`` (``Initializer.dumps``) or a dict with an
    "initializer" key (reference: ``registry.get_create_func``)."""
    if isinstance(spec, dict):
        spec = dict(spec)
        return create(spec.pop("initializer"), **spec)
    if not isinstance(spec, str):
        if callable(spec):  # an initializer instance
            return spec
        raise MXNetError(f"initializer must be a string, got {spec!r}")
    if spec.startswith("["):
        name, kw = json.loads(spec)
        return create(name, **kw)
    klass = _REGISTRY.get(spec.lower())
    if klass is None:
        raise MXNetError(f"{spec} is not registered. Registered: "
                         f"{sorted(_REGISTRY)}")
    return klass(**kwargs)


class InitDesc(str):
    """A parameter name carrying its attributes and the global fallback
    initializer (reference: initializer.py ``InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _target(arr):
    """(the tensor to fill, the ``mx.np`` array to rebind or None)."""
    data = getattr(arr, "_data", None)
    if isinstance(data, torch.Tensor):
        return data.detach().clone(), arr
    return arr, None


def _generator(t, generator):
    gen = generator if generator is not None \
        else _random.default_generator(t.device)
    _random.note_draw(gen)
    return gen


class Initializer:
    """Base initializer (reference: initializer.py ``Initializer``)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @torch.no_grad()
    def __call__(self, name, arr=None, generator=None):
        if arr is None:
            name, arr = "weight", name
        t, array = _target(arr)
        attr_init = name.attrs.get("__init__", "") \
            if isinstance(name, InitDesc) else ""
        if isinstance(name, InitDesc) and name.global_init is None:
            name.global_init = self
        if attr_init:
            # an attrs['__init__'] config replaces the name dispatch
            create(attr_init)._init_weight(str(name), t, generator)
        else:
            self.init_weight(str(name), t, generator)
        if array is not None:
            array._rebind(t)

    def init_weight(self, name, arr, generator=None):
        if name.endswith("gamma"):
            arr.fill_(1.0)
        elif name.endswith(("beta", "bias", "mean", "moving_mean")):
            arr.zero_()
        elif "running_var" in name or "moving_var" in name:
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self._kwargs.items())
        return f"{type(self).__name__}({args})"


@alias("zeros")
class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.zero_()


@alias("ones")
class One(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, generator):
        if isinstance(self.value, (int, float, bool)):
            arr.fill_(self.value)
        else:
            arr.copy_(torch.as_tensor(getattr(self.value, "_data",
                                              self.value)).expand(arr.shape))


@register
class Uniform(Initializer):
    """U(-scale, scale); the JAX package's default parameter initializer
    (``gluon/parameter.py`` falls back to ``Uniform()``)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale,
                     generator=_generator(arr, generator))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=_generator(arr, generator))


def _fans(shape, name):
    if len(shape) < 2:
        raise MXNetError(f"Xavier requires ndim>=2 param, got {shape} for "
                         f"{name}")
    hw = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
    return shape[1] * hw, shape[0] * hw


@register
class Xavier(Initializer):
    """U(-s, s) or N(0, s^2) with s = sqrt(magnitude / factor), factor the
    fan-in, fan-out or their mean (reference: initializer.py Xavier)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape, name="weight"):
        fan_in, fan_out = _fans(tuple(shape), name)
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, arr, generator):
        s = self.scale(arr.shape, name)
        gen = _generator(arr, generator)
        if self.rnd_type == "uniform":
            arr.uniform_(-s, s, generator=gen)
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, s, generator=gen)
        else:
            raise MXNetError(f"unknown rnd_type {self.rnd_type!r}")


@register
class MSRAPrelu(Xavier):
    """Xavier gaussian with magnitude 2 / (1 + slope^2) (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """``scale`` times the leading (out, prod(in)) block of a random
    orthogonal matrix of side max(out, in) (QR of a Gaussian matrix, its
    signs fixed by R's diagonal: Haar-distributed, as the reference's
    ``jax.random.orthogonal``)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        n = max(nout, nin)
        g = torch.empty(n, n, dtype=torch.float32, device=arr.device)
        g.normal_(0.0, 1.0, generator=_generator(arr, generator))
        q, r = torch.linalg.qr(g)
        q = q * torch.sign(torch.diagonal(r)).unsqueeze(0)
        arr.copy_((self.scale * q[:nout, :nin]).reshape(arr.shape))


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter at ``forget_bias`` (reference:
    initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        arr.zero_()
        n = arr.shape[0] // 4
        arr[n:2 * n] = self.forget_bias


@register
class Bilinear(Initializer):
    """The bilinear-upsampling kernel (reference: initializer.py
    Bilinear)."""

    def _init_weight(self, name, arr, generator):
        shape = tuple(arr.shape)
        size = math.prod(shape)
        weight = onp.zeros(size, dtype=onp.float32)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr.copy_(torch.from_numpy(weight.reshape(shape)))


class Mixed:
    """The first initializer whose pattern matches the name (``re.match``;
    reference: initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            [create(i) for i in initializers]))

    def __call__(self, name, arr=None, generator=None):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr, generator)
                return
        raise MXNetError(f"no initializer pattern matches {name!r}")


class Load:
    """Initialize by name from a params file (``npx.save`` / ``npz``) or a
    dict of arrays; ``arg:`` / ``aux:`` prefixes are stripped (reference:
    initializer.py Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from . import numpy_extension as npx
            param = npx.load(param)
        if not isinstance(param, dict):
            raise MXNetError("param must be a filename or a name->array "
                             "dict")
        self.param = {}
        for name, arr in param.items():
            key = name[4:] if name.startswith(("arg:", "aux:")) else name
            self.param[key] = arr
        self.default_init = default_init
        self.verbose = verbose

    @torch.no_grad()
    def __call__(self, name, arr=None, generator=None):
        if arr is None:
            name, arr = "weight", name
        name = str(name)
        if name in self.param:
            src = self.param[name]
            src = torch.as_tensor(onp.asarray(src) if not isinstance(
                getattr(src, "_data", src), torch.Tensor)
                else getattr(src, "_data", src))
            if tuple(arr.shape) != tuple(src.shape):
                raise MXNetError(
                    f"parameter {name} cannot be initialized by loading: "
                    f"shape {tuple(arr.shape)} vs loaded "
                    f"{tuple(src.shape)}")
            t, array = _target(arr)
            t.copy_(src)
            if array is not None:
                array._rebind(t)
            if self.verbose:
                logging.info("Initialized %s by loading", name)
            return
        if self.default_init is None:
            raise MXNetError(f"cannot initialize {name}: not found in loaded "
                             "params and no default initializer given")
        self.default_init(name, arr, generator)
        if self.verbose:
            logging.info("Initialized %s by default", name)
