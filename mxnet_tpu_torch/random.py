"""Seeded generators and the process-global default generators.

Counterpart of ``mxnet_tpu/random.py``. Where the JAX package splits one
process-global threefry key, the port keeps one default
``torch.Generator`` per device, made at first use from the ``seed`` knob
(``MXNET_SEED``) or from the last :func:`seed`. A sampler draws from an
explicit generator where its caller gives one (a block's ``generator``)
and from :func:`default_generator` of its tensor's device otherwise, so
``seed(s)`` makes the same calls give the same draws. The streams are
torch's (Philox on the card, Mersenne Twister on the CPU): they cannot
give the JAX package's bits.

Two thread-local hooks serve ``functional.functional_call`` and the
hybridized blocks of ``gluon/cached_graph.py``: :func:`generator_scope`
makes one generator the default of its device for a call (the reference's
``rng_key`` argument), and :func:`track_generators` records every
generator a call draws from, with its state before the first draw (the
samplers of ``dropout_mask`` and ``mx.np.random`` report theirs through
:func:`note_draw`).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import config

__all__ = ["generator", "seed", "default_generator", "dropout_mask",
           "note_draw", "get_state", "set_state"]

_lock = threading.Lock()
_defaults: dict[torch.device, torch.Generator] = {}
_seed = None  # None: the ``seed`` knob
_local = threading.local()  # .scoped: {device: generator}; .track: dict


def generator(seed=0, device="cpu"):
    """A fresh ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def _key(device):
    dev = getattr(device, "torch_device", None) or torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(seed_state, ctx="all"):
    """Seed the default generators (reference: random.py ``seed(seed_state,
    ctx)``): every device's with ``ctx="all"``, else only that device's.
    Generators made later start from ``seed_state`` too."""
    global _seed
    with _lock:
        if ctx == "all":
            _seed = int(seed_state)
            for gen in _defaults.values():
                gen.manual_seed(_seed)
        else:
            dev = _key(ctx)
            _defaults[dev] = generator(seed_state, dev)


def get_state():
    """Snapshot of every random stream a resume must replay (reference:
    random.py ``get_state``): the seed, the state of each default
    generator made so far (the CPU's and each card's), this thread's
    scoped generators (:func:`generator_scope`), and numpy's global state,
    which seeds samplers and shuffles. Plain numpy and Python data, so it
    pickles into a ``TrainState`` bundle; :func:`set_state` restores it
    bit for bit."""
    import numpy as onp
    with _lock:
        defaults = {str(d): g.get_state().numpy().copy()
                    for d, g in _defaults.items()}
        start = _seed
    scoped = getattr(_local, "scoped", None) or {}
    return {"seed": start, "defaults": defaults,
            "scoped": {str(d): g.get_state().numpy().copy()
                       for d, g in scoped.items()},
            "numpy": onp.random.get_state()}


def set_state(state):
    """Restore a snapshot from :func:`get_state`: the seed, each default
    generator (made where it is missing), this thread's scoped generators
    where a scope is active for their device, and numpy's global state."""
    import numpy as onp
    global _seed
    with _lock:
        _seed = state.get("seed")
    for name, st in (state.get("defaults") or {}).items():
        default_generator(torch.device(name))  # made at first use
        with _lock:
            _defaults[_key(torch.device(name))].set_state(
                torch.from_numpy(onp.asarray(st, onp.uint8).copy()))
    scoped = getattr(_local, "scoped", None) or {}
    for name, st in (state.get("scoped") or {}).items():
        gen = scoped.get(_key(torch.device(name)))
        if gen is not None:
            gen.set_state(torch.from_numpy(onp.asarray(st, onp.uint8).copy()))
    np_state = state.get("numpy")
    if np_state is not None:
        onp.random.set_state(np_state)


def default_generator(device):
    """The default generator of ``device``, made at first use (the one
    :func:`generator_scope` gives, inside it)."""
    dev = _key(device)
    scoped = getattr(_local, "scoped", None)
    if scoped and dev in scoped:
        return scoped[dev]
    with _lock:
        gen = _defaults.get(dev)
        if gen is None:
            start = config.get("seed") if _seed is None else _seed
            gen = _defaults[dev] = generator(start, dev)
        return gen


def dropout_mask(like, rate, generator=None):
    """Inverted-dropout keep mask (1 keep, 0 drop) of ``like``'s shape,
    dtype and device, drawn from ``generator`` or else from the default
    generator of ``like``'s device. Every dropout site of the port draws
    through here, so a fused and an unfused route make the same draws."""
    gen = generator if generator is not None \
        else default_generator(like.device)
    note_draw(gen)
    return torch.empty_like(like).bernoulli_(1.0 - rate, generator=gen)


def note_draw(gen):
    """Record ``gen`` in the :func:`track_generators` scope of this thread
    (with its state before its first draw there): every sampler of the
    port calls this before it draws."""
    track = getattr(_local, "track", None)
    if track is not None and gen not in track:
        track[gen] = gen.get_state()


@contextlib.contextmanager
def generator_scope(gen):
    """Within the scope (this thread), ``gen`` is the default generator of
    its device; ``None`` changes nothing."""
    if gen is None:
        yield
        return
    prev = getattr(_local, "scoped", None)
    _local.scoped = {**(prev or {}), _key(gen.device): gen}
    try:
        yield
    finally:
        _local.scoped = prev


@contextlib.contextmanager
def track_generators():
    """Yield a dict that collects, within the scope (this thread), every
    generator a sampler draws from (:func:`note_draw`), mapped to its state
    before the scope's first draw from it."""
    prev = getattr(_local, "track", None)
    _local.track = track = {}
    try:
        yield track
    finally:
        _local.track = prev
