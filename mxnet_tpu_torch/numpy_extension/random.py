"""``npx.random``: the extension samplers, and ``mx.np.random`` behind.

Counterpart of ``mxnet_tpu/numpy_extension/random.py`` (reference:
python/mxnet/numpy_extension/random.py): ``seed``, ``bernoulli``,
``normal_n`` and ``uniform_n`` are the ``npx`` functions; any other name
falls through to ``mx.np.random``, as in the reference.
"""
from . import bernoulli, normal_n, seed, uniform_n  # noqa: F401

__all__ = ["seed", "bernoulli", "normal_n", "uniform_n"]


def __getattr__(name):
    from ..numpy import random as _np_random
    return getattr(_np_random, name)
