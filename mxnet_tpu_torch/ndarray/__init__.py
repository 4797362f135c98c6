"""``mx.nd``: the legacy NDArray namespace.

Counterpart of ``mxnet_tpu/ndarray/__init__.py`` (reference parity:
python/mxnet/ndarray/, 23.7k lines of generated legacy op wrappers). The
port is NumPy-first, as MXNet 2.0 is: ``mx.nd`` re-exports ``mx.np``
(``NDArray`` is ``mx.np.ndarray``) and adds the legacy entry points
(``waitall``, ``save`` / ``load`` in the 1.x binary format, ``Custom``)
and ``sparse``. Any other name resolves in the reference's order
(``__getattr__``): the legacy CamelCase table (``register.py``), then
``mx.np``, then ``npx`` (with ``out=``), then the lower-cased name in
``mx.np``.
"""
from __future__ import annotations

import importlib

from ..numpy import *  # noqa: F401,F403
from ..numpy import ndarray as NDArray, array, zeros, ones, full, arange  # noqa: F401
from ..numpy.multiarray import _wrap, _invoke  # noqa: F401
from ..numpy import random  # noqa: F401
from .. import numpy as _np
from . import sparse  # noqa: F401
from .sparse import RowSparseNDArray, CSRNDArray  # noqa: F401
from . import register as _legacy

# the legacy table resolves first (__getattr__): drop the np names it
# shadows (broadcast_to, zeros_like, norm, ...) from the star import
for _name in _legacy.LEGACY_OPS:
    globals().pop(_name, None)
del _name


def waitall():
    """Wait for every queued computation (reference: ``nd.waitall``)."""
    from ..numpy_extension import waitall as _waitall
    _waitall()


def save(fname, data):
    """Write an array, a list of arrays or a dict of str -> array in the
    1.x legacy NDArray binary format (reference: ndarray.py ``save`` over
    ``NDArray::Save``, ndarray.cc:2125): files interchange with Apache
    MXNet and with the JAX package. ``npx.save`` writes npz."""
    from .. import serialization
    from ..base import MXNetError
    if isinstance(data, NDArray):
        data = [data]
    if not isinstance(data, (dict, list, tuple)):
        # a raw host or device array would be iterated row by row; refuse
        # it as the reference does
        raise MXNetError(
            "nd.save expects an NDArray, a list of NDArrays, or a "
            f"dict of str->NDArray, got {type(data).__name__}")
    serialization.save_legacy_params(fname, data)


def load(fname):
    """Arrays from the legacy binary format or an npz file (reference:
    ndarray.py ``load``), on the current context."""
    from .. import serialization
    if serialization.is_legacy_params(fname):
        loaded = serialization.load_legacy_params(fname)
        if isinstance(loaded, list):
            return [array(v) for v in loaded]
        return {k: array(v) for k, v in loaded.items()}
    from .. import numpy_extension as npx
    return npx.load(fname)


def Custom(*inputs, op_type=None, **kwargs):
    """A registered Python custom op (reference: ``mx.nd.Custom``); raises
    until ``mx.operator`` is ported (``register.py``)."""
    from .register import LEGACY_OPS
    return LEGACY_OPS["Custom"](*inputs, op_type=op_type, **kwargs)


def __getattr__(name):
    if name in ("register", "contrib"):  # submodules, not ops
        return importlib.import_module(__name__ + "." + name)
    # 1) the legacy table (CamelCase layer ops, legacy snake_case names)
    _register = importlib.import_module(__name__ + ".register")
    fn = _register.get(name)
    if fn is not None:
        return fn
    # 2) np, then npx (legacy nd exposed both layer and tensor ops)
    try:
        return getattr(_np, name)
    except AttributeError:
        pass
    from .. import numpy_extension as _npx
    fn = getattr(_npx, name, None)
    if fn is not None:
        if callable(fn) and not isinstance(fn, type):
            return _register.with_out(fn)
        return fn
    lowered = name.lower()
    if lowered != name:
        return getattr(_np, lowered)
    raise AttributeError(name)
