"""mx.config — typed configuration knobs with env-var overrides.

Own, trimmed copy of ``mxnet_tpu/config.py``: the same registry mechanics
(declare / get / set / reset, env aliases) carrying only the knobs the
ported slices read, with the JAX package's defaults and env names.
"""
from __future__ import annotations

import os
import threading

from .base import MXNetError

__all__ = ["declare", "get", "set", "reset"]

_lock = threading.Lock()
_registry: dict[str, "_Knob"] = {}


class _Knob:
    __slots__ = ("name", "typ", "default", "env", "doc", "_value", "_set")

    def __init__(self, name, typ, default, env, doc):
        self.name = name
        self.typ = typ
        self.default = default
        self.env = env
        self.doc = doc
        self._value = None
        self._set = False

    def _coerce(self, val):
        if self.typ is bool and isinstance(val, str):
            return val not in ("0", "false", "False", "")
        return self.typ(val)

    def value(self):
        if self._set:
            return self._value
        if self.env:
            raw = os.environ.get(self.env)
            if raw is not None:
                return self._coerce(raw)
        return self.default


def declare(name, typ=str, default=None, env=None, doc=""):
    """Register a configuration knob (once, at module import)."""
    with _lock:
        if name in _registry:
            return _registry[name]
        knob = _Knob(name, typ, default, env, doc)
        _registry[name] = knob
        return knob


def get(name):
    knob = _registry.get(name)
    if knob is None:
        raise MXNetError(f"unknown config knob {name!r}")
    return knob.value()


def set(name, value):  # noqa: A001 - mirrors the reference's setter name
    knob = _registry.get(name)
    if knob is None:
        raise MXNetError(f"unknown config knob {name!r}")
    with _lock:
        prev = knob.value()
        knob._value = knob._coerce(value)
        knob._set = True
    return prev


def reset(name=None):
    """Drop runtime overrides (env/defaults apply again)."""
    if name is not None and name not in _registry:
        raise MXNetError(f"unknown config knob {name!r}")
    with _lock:
        for knob in ([_registry[name]] if name else _registry.values()):
            knob._set = False
            knob._value = None


declare("seed", int, 0, "MXNET_SEED",
        "Global RNG seed (reference: mx.random.seed / MXNET_SEED).")
declare("fused_ln_residual", str, "auto", "MXNET_FUSED_LN_RESIDUAL",
        "Fused dropout+residual+LayerNorm kernel in post-norm transformer "
        "encoder cells: 'auto' (CUDA tensor and live dropout), 'on', "
        "'off'.")
declare("serve.max_slots", int, 8, "MXNET_SERVE_MAX_SLOTS",
        "Decode slots in the serve engine: the fixed batch dimension of "
        "the decode step and of every preallocated KV-cache tensor.")
declare("serve.buckets", str, "16,32,64,128,256,512", "MXNET_SERVE_BUCKETS",
        "Prompt-length buckets for prefill (comma-separated). Prompts pad "
        "up to the smallest fitting bucket; buckets beyond the cache's "
        "max_seq are dropped.")
declare("serve.drain_window", int, 4, "MXNET_SERVE_DRAIN_WINDOW",
        "Bounded deferred-drain window of the serve loop: device-resident "
        "(token, done) vectors pending host fetch. Completions are "
        "observed at most this many steps late.")
declare("serve.max_queue", int, 0, "MXNET_SERVE_MAX_QUEUE",
        "Bound on requests waiting for a decode slot; submit() past it "
        "raises EngineBusy. 0 = unbounded.")
