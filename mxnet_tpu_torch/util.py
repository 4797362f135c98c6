"""``mx.util``: NumPy-mode scopes and small helpers.

A copy of ``mxnet_tpu/util.py`` (reference: python/mxnet/util.py), on the
port's devices. The framework always has NumPy semantics, so the
``np_shape`` / ``np_array`` scopes, the ``use_np`` decorator and
``set_np`` / ``reset_np`` do nothing and are kept for the reference's
scripts.
"""
from __future__ import annotations

import contextlib
import os

__all__ = ["is_np_shape", "is_np_array", "np_shape", "np_array", "use_np",
           "set_np", "reset_np", "default_array", "get_gpu_count",
           "get_gpu_memory", "getenv", "setenv", "set_module"]


def is_np_shape():
    return True


def is_np_array():
    return True


@contextlib.contextmanager
def np_shape(active=True):
    yield active


@contextlib.contextmanager
def np_array(active=True):
    yield active


def use_np(func):
    return func


def set_np(shape=True, array=True, dtype=False):
    """NumPy semantics are always on (reference: a no-op too)."""


def reset_np():
    pass


def default_array(source_array, ctx=None, dtype=None):
    from .numpy import array
    return array(source_array, dtype=dtype, ctx=ctx)


def get_gpu_count():
    from .context import num_gpus
    return num_gpus()


def get_gpu_memory(gpu_dev_id=0):
    """(free, total) bytes of card ``gpu_dev_id`` (reference:
    util.py ``get_gpu_memory``)."""
    from .context import gpu_memory_info
    return gpu_memory_info(gpu_dev_id)


def getenv(name):
    """An environment variable, None when unset (reference: util.py
    ``getenv``)."""
    return os.environ.get(name)


def setenv(name, value):
    """Set (or, with None, unset) an environment variable for this
    process (reference: util.py ``setenv``)."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)


def set_module(module):
    """Decorator overriding ``__module__`` (reference: util.py
    ``set_module``)."""
    def decorator(obj):
        if module is not None:
            obj.__module__ = module
        return obj
    return decorator


