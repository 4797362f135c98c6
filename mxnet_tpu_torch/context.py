"""Device contexts and device resolution.

Counterpart of ``mxnet_tpu/context.py`` (``Context``, ``cpu()`` /
``gpu()`` / ``device()``, ``num_gpus()``, ``gpu_memory_info()``,
``current_context()`` and the thread-local ``with ctx:`` default scope).
``mx.gpu(i)`` is ``cuda:i``; "tpu" names the card too, so the reference's
scripts run unchanged.

The port runs on the card: :func:`resolve_device` gives the device of the
innermost ``with ctx:`` scope, and with no scope and no device it resolves
to ``cuda:0`` and raises when CUDA is absent, never carrying on silently
on the host. The CPU is used only when a caller asks for it by name
(``device="cpu"``, ``mx.cpu()``, or ``with mx.cpu():``), as the CPU tests
do.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "tpu", "device",
           "num_gpus", "gpu_memory_info", "current_context",
           "resolve_device"]

_scope = threading.local()


class Context:
    """A device context (reference: context.py ``Context``). ``device_type``
    is one of 'cpu', 'gpu', 'cpu_pinned', 'cpu_shared' or 'tpu' (the
    card, as 'gpu'). ``with ctx:`` makes it this thread's default."""

    devtype2id = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5,
                  "tpu": 6}
    devid2type = {v: k for k, v in devtype2id.items()}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        elif isinstance(device_type, torch.device):
            device_type, device_id = (
                "gpu" if device_type.type == "cuda" else device_type.type,
                device_type.index or 0)
        if device_type == "cuda":
            device_type = "gpu"
        if device_type not in self.devtype2id:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self):
        return self.devtype2id[self.device_type]

    @property
    def torch_device(self):
        """The ``torch.device`` this context names (a card that is absent
        raises)."""
        if self.device_type in ("cpu", "cpu_pinned", "cpu_shared"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(f"context {self} requested but CUDA is not "
                             "available")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        stack = getattr(_scope, "stack", None)
        if stack is None:
            stack = _scope.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _scope.stack.pop()

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def empty_cache(self):
        """Release the card's cached memory (reference:
        ``Context.empty_cache``)."""
        if self.device_type in ("gpu", "tpu") and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    """The card ``cuda:device_id``."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """The reference's accelerator context; on the port, the card."""
    return Context("tpu", device_id)


def device(dev_type, device_id=0):
    return Context(dev_type, device_id)


def num_gpus():
    """Count of cards (reference: ``context.num_gpus``)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def gpu_memory_info(device_id=0):
    """(free, total) bytes of card ``device_id`` (reference: context.py
    over ``cudaMemGetInfo``); raises without that card."""
    if not 0 <= device_id < num_gpus():
        raise MXNetError(f"no GPU {device_id} ({num_gpus()} available)")
    return torch.cuda.mem_get_info(device_id)


def current_context():
    """This thread's default context: the innermost ``with ctx:`` scope's,
    else ``gpu(0)`` (reference: ``context.current_context``)."""
    stack = getattr(_scope, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)


def resolve_device(device=None):
    """The ``torch.device`` of ``device``: a :class:`Context`, a
    ``torch.device`` or its name. ``None`` -> the innermost ``with ctx:``
    scope's device, else ``cuda:0`` (raises without CUDA). A CUDA device
    that is absent raises."""
    if device is None:
        stack = getattr(_scope, "stack", None)
        if stack:
            return stack[-1].torch_device
        if not torch.cuda.is_available():
            raise MXNetError(
                "no CUDA device available; pass device='cpu' (or enter "
                "`with mx.cpu():`) to run on the host explicitly")
        return torch.device("cuda", 0)
    if isinstance(device, Context):
        return device.torch_device
    if isinstance(device, str) and device.split(":")[0] in ("gpu", "tpu"):
        kind, _, index = device.partition(":")
        return Context(kind, int(index or 0)).torch_device
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(f"device {device!r} requested but CUDA is not "
                             "available")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev
