"""gluon.data.DataLoader.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py`` (reference parity:
python/mxnet/gluon/data/dataloader.py, multiprocessing workers +
shared-memory batches + a prefetch queue).

Where the batch lives: samples are fetched and batchified on the host, in
``with mx.cpu():`` (a spawned worker makes numpy batches; a thread worker
and the inline path make host ``mx.np`` arrays), so a worker never touches
the card and ``mx.np`` creation there never reaches ``cuda:0``. Each batch
then moves to the consumer once: with ``prefetch_to_device`` a
:class:`~mxnet_tpu_torch.pipeline.DevicePrefetcher` copies it from pinned
memory on a side CUDA stream while the previous step computes; without
it, the loop's ``__next__`` copies it to the current context (the CPU
inside ``with mx.cpu():``). ``pin_memory=True`` stages host batches in
pinned memory when nothing prefetches them; under a prefetch to the card a
spawned worker's batch is copied out of its shared-memory segment straight
into the prefetcher's pinned staging ring, which the copy to the card then
reads (one host copy whatever ``pin_memory`` says).

Process workers are spawned (never forked: a forked child of a process
with CUDA up cannot use it, and the port's children must not touch the
card anyway) and ship each batch through one shared-memory segment that
packs all its leaves (``_to_shm`` / ``_from_shm``), reused across batches
through the parent's ``_ShmRing``. A crashed or hung pool is respawned
with backoff, its in-flight batches requeued in order; after
``dataloader.max_respawns`` losses the loader finishes on threads for the
rest of its life (the reference's documented degradation of host
workers). ``worker_mode`` "auto" probes the per-sample cost once and takes
processes only above ``dataloader.mp_threshold_ms``.

The served cursor ``_served`` counts batches handed to the loop on the
consumer side of the prefetcher, so a ``TrainState`` bundle never records
a batch that was prefetched and not consumed. A batch's host transforms
draw from a CPU generator seeded by the epoch's augmentation seed and the
batch's sample indices (:func:`_batch_generator`), so a batch is augmented
the same whichever worker makes it. The epoch's seed is drawn from
``mx.random``'s default CPU generator when the epoch starts (so
``mx.random.seed`` decides it and each epoch draws anew) and is kept in
``state_dict()``, so a resumed epoch replays its batches bit for bit.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import time
import zlib

import numpy as onp
import torch

from ... import config as _config
from ... import fault as _fault
from ... import pipeline as _pipeline
from ... import random as _random
from ... import telemetry as _telemetry
from ... import trace as _trace
from ...base import host_dtype, torch_dtype
from ...context import cpu as _cpu
from ...context import resolve_device
from ...numpy.multiarray import _wrap, array, ndarray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into ``mx.np`` arrays on the current context
    (reference: dataloader.py default_batchify_fn); the loader calls it in
    ``with mx.cpu():``."""
    if isinstance(data[0], ndarray):
        return _wrap(torch.stack([d._data for d in data]))
    if isinstance(data[0], torch.Tensor):
        return _wrap(torch.stack(data))
    if isinstance(data[0], (tuple, list)):
        return type(data[0])(default_batchify_fn(list(x)) for x in zip(*data))
    return array(onp.asarray(data))


def default_mp_batchify_fn(data):
    """Worker-process batchify: stacks to host numpy (the parent copies it
    out of shared memory)."""
    if isinstance(data[0], ndarray):
        data = [d.asnumpy() for d in data]
    elif isinstance(data[0], torch.Tensor):
        data = [d.cpu().numpy() for d in data]
    if isinstance(data[0], (tuple, list)):
        return type(data[0])(
            default_mp_batchify_fn(list(x)) for x in zip(*data))
    return onp.stack([onp.asarray(d) for d in data])


def _batch_generator(indices, aug_seed):
    """The CPU generator of one batch's transforms (the default generator
    of the host inside the batch's fetch), seeded by the epoch's
    augmentation seed and the batch's sample indices: a pure function of
    the epoch, not of the worker or the time."""
    key = onp.asarray([aug_seed, *indices], onp.int64)
    return _random.generator(zlib.crc32(key.tobytes()), "cpu")


def _host_alloc(pin):
    """``alloc(shape, dtype)`` of host tensors, pinned with ``pin``."""
    return lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            pin_memory=pin)


def _pin(batch):
    """Host batch leaves -> pinned memory (a no-op without CUDA)."""
    if not torch.cuda.is_available():
        return batch
    if isinstance(batch, (tuple, list)):
        return type(batch)(_pin(b) for b in batch)
    if isinstance(batch, ndarray) and batch._data.device.type == "cpu":
        return _wrap(batch._data.pin_memory())
    if isinstance(batch, torch.Tensor) and batch.device.type == "cpu":
        return batch.pin_memory()
    return batch


def _to_device(batch, dev):
    """Move a batch's array leaves to ``dev`` (the consumer's context)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, dev) for b in batch)
    if isinstance(batch, ndarray):
        if batch._data.device == dev:
            return batch
        return _wrap(batch._data.to(dev))
    if isinstance(batch, torch.Tensor):
        return batch.to(dev)
    if isinstance(batch, onp.ndarray):
        return array(batch, device=dev)
    return batch


# ---------------------------------------------------------------------------
# multiprocess workers: the worker packs ALL leaves of a batch into ONE
# shared-memory segment at 64-byte-aligned offsets and ships a single
# ("pack", name, tree, alloc, created) spec whose tree leaves carry
# (shape, dtype, offset); the parent copies each leaf out. With the
# dataloader.shm_ring knob (default on) segments are pooled and reused
# across batches; otherwise each segment is unlinked after its one batch.
# ---------------------------------------------------------------------------

_worker_state = {}


def _mp_worker_init(dataset, batchify):
    # the worker's whole life is on the host: mx.np creation with no
    # context (imdecode, transforms, batchify) must not reach cuda:0; and
    # one intra-op thread each, as torch's own loader workers take, or N
    # workers' thread pools oversubscribe the host's cores
    _cpu().__enter__()
    torch.set_num_threads(1)
    _worker_state["dataset"] = dataset
    _worker_state["batchify"] = batchify
    _worker_state["segs"] = {}  # name -> SharedMemory (attached handles)


def _grant_segment(nbytes, grants):
    """Pick a segment for one packed batch: best-fit from the parent's
    grant list (used grants are popped), else a fresh power-of-2 sized
    block, so the parent's pool converges on a few reusable segments.
    Attached handles are cached (LRU, bounded)."""
    from multiprocessing import shared_memory
    segs = _worker_state.setdefault("segs", {})
    best = None
    for i, (name, size) in enumerate(grants):
        if size >= nbytes and (best is None or size < grants[best][1]):
            best = i
    if best is not None:
        name, size = grants.pop(best)
        shm = segs.get(name)
        if shm is None:
            try:
                shm = shared_memory.SharedMemory(name=name)
                segs[name] = shm
            except FileNotFoundError:  # parent retired it meanwhile
                shm = None
        if shm is not None:
            segs[name] = segs.pop(name)  # LRU touch
            return shm, name, size, False
    size = 1 << (max(nbytes, 1) - 1).bit_length()
    shm = shared_memory.SharedMemory(create=True, size=size)
    segs[shm.name] = shm
    while len(segs) > 64:  # stale handles accumulate only via retires
        segs.pop(next(iter(segs))).close()
    return shm, shm.name, size, True


#: leaf offsets inside a packed segment are cache-line aligned
_PACK_ALIGN = 64


def _pack_layout(batch, leaves, offset):
    """Flatten ``batch`` into ``leaves`` ([(array, offset)]) and return
    ``(tree, end)``: the tree's leaves are ("leaf", shape, dtype, offset)."""
    if isinstance(batch, (tuple, list)):
        parts = []
        for b in batch:
            sub, offset = _pack_layout(b, leaves, offset)
            parts.append(sub)
        return (type(batch).__name__, parts), offset
    a = onp.ascontiguousarray(onp.asarray(batch))
    offset = -(-offset // _PACK_ALIGN) * _PACK_ALIGN
    leaves.append((a, offset))
    return ("leaf", a.shape, str(a.dtype), offset), offset + a.nbytes


def _to_shm(batch, grants=None):
    """Serialize one batch into a SINGLE packed shm segment. ``grants`` is
    the mutable list of (name, size) segments the parent loaned this task
    (ring mode); None means a one-shot segment the parent unlinks."""
    from multiprocessing import shared_memory
    leaves = []
    tree, total = _pack_layout(batch, leaves, 0)
    total = max(total, 1)
    if grants is None:
        shm = shared_memory.SharedMemory(create=True, size=total)
        name, size, created = shm.name, total, True
    else:
        shm, name, size, created = _grant_segment(total, grants)
    for a, off in leaves:
        onp.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=off)[...] = a
    if grants is None:
        shm.close()
    return ("pack", name, tree, size, created)


def _mp_worker_task(indices, aug_seed, fault_step=0, grants=None,
                    trace_ctx=None):
    # fault hooks (armed through MXNET_FAULT_SPEC, inherited by the
    # spawned worker's environment): crash = hard death with no cleanup;
    # hang = the worker stops producing, which the parent's deadline must
    # catch. fault_step is the parent's global task sequence, so at=N
    # fires deterministically whichever worker runs the task.
    if _fault._active:
        if _fault.fire("dataloader.worker_crash", step=fault_step):
            os._exit(117)
        if _fault.fire("dataloader.worker_hang", step=fault_step):
            time.sleep(3600)
    t0u = _trace.clock_us() if trace_ctx is not None else 0
    ds, bf = _worker_state["dataset"], _worker_state["batchify"]
    grants = list(grants) if grants is not None else None
    fetch = getattr(ds, "sample_batch", None)
    with _random.generator_scope(_batch_generator(indices, aug_seed)):
        samples = (fetch(indices) if fetch is not None
                   else [ds[i] for i in indices])
        batch = bf(samples)
    spec = _to_shm(batch, grants)
    spans = []
    if trace_ctx is not None:
        spans.append(_trace.make_span(
            "dataloader.worker_batch", t0u, _trace.clock_us() - t0u,
            tuple(trace_ctx), category="dataloader",
            samples=len(indices), task_seq=fault_step,
            worker_pid=os.getpid()))
    # leftover grants ride back so the parent can return them to the pool
    return (grants or [], spec, spans)


class _ShmRing:
    """Parent-side pool of reusable SharedMemory segments.

    A segment name lives in exactly one place at any time: the free pool,
    the grant list of one in-flight task, or one unconsumed result spec.
    ``grant()`` moves names out best-fit against the previous batch's
    packed-segment size; ``give_back()`` returns them after the copy out;
    pool overflow unlinks oldest-first (``dataloader.shm_ring_max``)."""

    def __init__(self, max_segments):
        self._free = []       # [(size, name)] insertion order
        self._attached = {}   # name -> SharedMemory
        self._max = max(1, int(max_segments))
        self.last_sizes = []  # packed segment bytes of the latest batch

    def grant(self):
        grants = []
        for want in self.last_sizes:
            best = None
            for i, (size, _name) in enumerate(self._free):
                if size >= want and (best is None
                                     or size < self._free[best][0]):
                    best = i
            if best is not None:
                size, name = self._free.pop(best)
                grants.append((name, size))
        return grants

    def attach(self, name):
        shm = self._attached.get(name)
        if shm is None:
            from multiprocessing import shared_memory
            shm = shared_memory.SharedMemory(name=name)
            self._attached[name] = shm
        return shm

    def give_back(self, name, size):
        self._free.append((size, name))
        while len(self._free) > self._max:
            self._retire(self._free.pop(0)[1])

    def _retire(self, name):
        from multiprocessing import shared_memory
        shm = self._attached.pop(name, None)
        if shm is None:
            try:
                shm = shared_memory.SharedMemory(name=name)
            except FileNotFoundError:
                return
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass

    def close(self):
        """Unlink every pooled segment (DataLoader.close / __del__)."""
        while self._free:
            self._retire(self._free.pop()[1])
        for name in list(self._attached):
            self._retire(name)


def _free_shm(spec, ring=None):
    """Return a batch's packed segment without copying (abandoned
    iterator): back into the ring, or unlinked in one-shot mode."""
    from multiprocessing import shared_memory
    _, name, _tree, alloc, _created = spec
    if ring is not None:
        ring.give_back(name, alloc)
        return
    try:
        shm = shared_memory.SharedMemory(name=name)
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass


def _unpack_tree(tree, buf, alloc):
    """Copy every leaf of a packed segment out of ``buf`` into host
    tensors from ``alloc(shape, dtype)`` (pageable, pinned, or the
    prefetcher's staging ring), wrapped as ``mx.np`` arrays, rebuilding
    the nesting. The copy is what lets the ring hand the segment out
    again."""
    if tree[0] == "leaf":
        _, shape, dtype, off = tree
        view = onp.ndarray(shape, dtype, buffer=buf, offset=off)
        dt = host_dtype(view)
        src = (torch.from_numpy(view) if torch_dtype(view.dtype) is dt
               else array(view, device="cpu")._data)  # the 32-bit rule casts
        out = alloc(tuple(shape), dt)
        out.copy_(src)
        return _wrap(out)
    kind, parts = tree
    seq = [_unpack_tree(p, buf, alloc) for p in parts]
    return tuple(seq) if kind == "tuple" else seq


def _from_shm(spec, alloc, ring=None, sizes=None):
    from multiprocessing import shared_memory
    _, name, tree, alloc_bytes, created = spec
    if ring is not None:
        shm = ring.attach(name)
        out = _unpack_tree(tree, shm.buf, alloc)
        if sizes is not None:
            sizes.append(alloc_bytes)
        ring.give_back(name, alloc_bytes)
        if _telemetry._active:
            _telemetry.inc("dataloader.shm_created_total" if created
                           else "dataloader.shm_reused_total")
    else:
        shm = shared_memory.SharedMemory(name=name)
        try:
            out = _unpack_tree(tree, shm.buf, alloc)
        finally:
            shm.close()
            shm.unlink()
    return out


class DataLoader:
    """Reference: dataloader.py DataLoader. ``prefetch_to_device``: None /
    False off; True the card (raises without one); a device or context
    (``"cpu"`` included) that target."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=None, timeout=120,
                 try_nopython=None, prefetch_to_device=None,
                 device_prefetch_depth=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._num_workers = max(0, num_workers)
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when no batch_sampler")
            if sampler is None:
                sampler = (RandomSampler(len(dataset)) if shuffle
                           else SequentialSampler(len(dataset)))
            elif shuffle:
                raise ValueError("shuffle and sampler are mutually exclusive")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        # thread_pool=None -> mode from mx.config dataloader.worker_mode;
        # explicit True/False keeps the reference's meaning
        self._thread_pool = thread_pool
        self._user_batchify = batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._proc_pool = None
        self._worker_mode_cache = None
        self._force_threads = False   # set after repeated worker crashes
        self._task_seq = 0            # global task counter (fault at=N)
        self._served = 0              # batches handed to the training loop
        self._prefetch_to_device = prefetch_to_device
        self._device_prefetch_depth = device_prefetch_depth
        self._ring = None             # _ShmRing, built lazily by _mp_pump
        self._aug_seed = None         # the current epoch's augmentation seed
        self._resume_aug_seed = None  # a loaded state's, for the next epoch

    def _batchify(self, mp_mode):
        if self._user_batchify is not None:
            return self._user_batchify
        return default_mp_batchify_fn if mp_mode else default_batchify_fn

    @property
    def _batchify_fn(self):
        return self._batchify(self._resolve_worker_mode() == "processes"
                              and self._num_workers > 0)

    def _resolve_worker_mode(self):
        """'threads' or 'processes' for num_workers>0: the knob, or under
        'auto' a probe of one sample's cost against
        ``dataloader.mp_threshold_ms``; 'threads' for good after
        ``dataloader.max_respawns`` pool losses."""
        if self._force_threads:
            return "threads"
        if self._thread_pool is not None:
            return "threads" if self._thread_pool else "processes"
        mode = _config.get("dataloader.worker_mode")
        if mode in ("threads", "processes"):
            return mode
        if mode != "auto":
            raise ValueError(f"dataloader.worker_mode {mode!r} not in "
                             "('auto', 'threads', 'processes')")
        if self._worker_mode_cache is None:
            n = min(len(self._dataset), 3)
            if n == 0:
                self._worker_mode_cache = "threads"
            else:
                t0 = time.perf_counter()
                with _cpu():
                    for i in range(n):
                        self._dataset[i]
                per_ms = (time.perf_counter() - t0) * 1000.0 / n
                self._worker_mode_cache = (
                    "processes"
                    if per_ms >= _config.get("dataloader.mp_threshold_ms")
                    else "threads")
        return self._worker_mode_cache

    def _make_batch(self, indices, aug_seed, pin):
        # streaming sources (mx.stream.StreamDataset) fetch whole batches:
        # the corrupt-record skip policy must be able to shrink a batch
        with _cpu(), _random.generator_scope(
                _batch_generator(indices, aug_seed)):
            fetch = getattr(self._dataset, "sample_batch", None)
            samples = (fetch(indices) if fetch is not None
                       else [self._dataset[i] for i in indices])
            batch = self._batchify(False)(samples)
        return _pin(batch) if pin else batch

    def _draw_aug_seed(self):
        """The epoch's augmentation seed: a loaded state's, else a draw
        from ``mx.random``'s default CPU generator."""
        if self._resume_aug_seed is not None:
            seed, self._resume_aug_seed = self._resume_aug_seed, None
            return seed
        return int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=_random.default_generator("cpu")))

    def _get_proc_pool(self):
        # a persistent spawned pool for the loader's lifetime (reference:
        # dataloader.py:520); spawn, never fork (see the module docstring)
        if self._proc_pool is None:
            import multiprocessing as mp
            self._proc_pool = cf.ProcessPoolExecutor(
                self._num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_mp_worker_init,
                initargs=(self._dataset, self._batchify(True)))
        return self._proc_pool

    def _kill_pool(self):
        """Tear the worker pool down hard: hung workers never exit on
        their own, so terminate before shutdown."""
        pool, self._proc_pool = self._proc_pool, None
        if pool is None:
            return
        for proc in list((getattr(pool, "_processes", None) or {}).values()):
            try:
                proc.terminate()
            except Exception:  # noqa: BLE001 - already-dead workers
                pass
        pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self):
        # the served-batch cursor is what TrainState bundles record: with
        # prefetching workers, batches *generated* run ahead of batches
        # the loop has consumed, and resume continues at the consumed one
        self._served = (self._batch_sampler.resume_cursor()
                        if hasattr(self._batch_sampler, "resume_cursor")
                        else 0)
        self._aug_seed = aug_seed = self._draw_aug_seed()
        # under a prefetch to the card, host batches land in the
        # prefetcher's pinned staging ring (set below, before the source
        # starts in the prefetch thread)
        staging = []
        src = self._iter_impl(aug_seed, staging)
        pf = None
        target = self._prefetch_to_device
        if target not in (None, False):
            # the served counter stays on the consumer side of the
            # prefetcher: batches it buffered but did not hand out are
            # replayed after a resume, not skipped
            pf = src = _pipeline.DevicePrefetcher(
                src, shardings=None if target is True else target,
                depth=self._device_prefetch_depth)
            if pf.to_card:
                staging.append(pf.staging)
        else:
            dev = resolve_device()
            src = (_to_device(b, dev) for b in src)
        try:
            for batch in src:
                self._served += 1
                yield batch
        finally:
            if pf is not None:
                pf.close()
            else:
                src.close()

    def _iter_impl(self, aug_seed, staging):
        """Host batches of one epoch; ``staging`` holds the prefetcher's
        staging ring when the batches go on to the card, which makes
        ``pin_memory`` a no-op (the ring is pinned)."""
        pin = bool(self._pin_memory) and not staging

        def make(indices):
            return self._make_batch(indices, aug_seed, pin)

        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield make(indices)
            return
        if self._resolve_worker_mode() == "threads":
            with cf.ThreadPoolExecutor(self._num_workers) as pool:
                yield from self._pump(pool, make, iter(self._batch_sampler))
            return
        alloc = (staging[0].acquire if staging
                 else _host_alloc(pin and torch.cuda.is_available()))
        yield from self._mp_pump(aug_seed, alloc, make)

    # -- elastic resume: the loader's position is {epoch replay state,
    # batches served}; restoring it continues at the exact next batch ------
    def state_dict(self):
        """The sampler's state at the served cursor, and the epoch's
        augmentation seed (``aug_seed``, which the JAX package's state
        does not have: its draws come from the advancing global key)."""
        from ...base import MXNetError
        if not hasattr(self._batch_sampler, "state_dict"):
            raise MXNetError(
                f"batch_sampler {type(self._batch_sampler).__name__} has no "
                "state_dict; implement state_dict/load_state_dict to make "
                "this DataLoader resumable")
        return {**self._batch_sampler.state_dict(cursor=self._served),
                "aug_seed": self._aug_seed}

    def load_state_dict(self, state):
        from ...base import MXNetError
        if not hasattr(self._batch_sampler, "load_state_dict"):
            raise MXNetError(
                f"batch_sampler {type(self._batch_sampler).__name__} has no "
                "load_state_dict; cannot resume this DataLoader")
        self._batch_sampler.load_state_dict(state)
        self._resume_aug_seed = state.get("aug_seed")

    def publish_cursor(self, **kwargs):
        """Streaming passthrough: publish the sampler's cursor at the
        consumed position (``self._served``). No-op for other samplers."""
        publish = getattr(self._batch_sampler, "publish_cursor", None)
        if publish is None:
            return None
        kwargs.setdefault("cursor", self._served)
        return publish(**kwargs)

    def take_over_host(self, dead_rank, **kwargs):
        """Streaming passthrough: adopt this host's share of a dead
        peer's unfinished shards (see StreamSampler.take_over_host)."""
        take = getattr(self._batch_sampler, "take_over_host", None)
        return take(dead_rank, **kwargs) if take is not None else 0

    def _pump(self, pool, task, batches):
        pending = []
        it = iter(batches)
        try:
            for _ in range(self._prefetch or self._num_workers):
                pending.append(pool.submit(task, next(it)))
        except StopIteration:
            pass
        while pending:
            fut = pending.pop(0)
            try:
                pending.append(pool.submit(task, next(it)))
            except StopIteration:
                pass
            if _telemetry._active:
                # batch wait = how long the loop starves on input; queue
                # depth = prefetch headroom at that moment
                _telemetry.set_gauge("dataloader.queue_depth",
                                     len(pending) + 1)
                _t0 = time.perf_counter()
                result = fut.result(timeout=self._timeout)
                _telemetry.observe("dataloader.wait_seconds",
                                   time.perf_counter() - _t0)
                _telemetry.inc("dataloader.batches_total")
                yield result
            else:
                yield fut.result(timeout=self._timeout)

    def _mp_pump(self, aug_seed, alloc, make):
        """Process-worker pipeline with crash/hang recovery: a dead pool
        (BrokenProcessPool) or a missed per-batch deadline (``timeout``)
        tears the pool down and respawns it with exponential backoff,
        requeueing every in-flight batch in order; after
        ``dataloader.max_respawns`` losses the rest runs on threads
        (``make``). Each batch is copied out of its segment into tensors
        from ``alloc(shape, dtype)``. Every recovery is counted in
        ``mx.fault.stats()``."""
        from concurrent.futures.process import BrokenProcessPool
        max_respawns = _config.get("dataloader.max_respawns")
        backoff = _config.get("dataloader.respawn_backoff")
        depth = max(1, self._prefetch or self._num_workers)
        if self._ring is None and _config.get("dataloader.shm_ring"):
            self._ring = _ShmRing(_config.get("dataloader.shm_ring_max"))
        ring = self._ring
        todo = collections.deque(self._batch_sampler)
        inflight = collections.deque()  # (future, indices, grants)
        crashes = 0
        try:
            while todo or inflight:
                try:
                    pool = self._get_proc_pool()
                    while todo and len(inflight) < depth:
                        indices = todo.popleft()
                        self._task_seq += 1
                        grants = ring.grant() if ring is not None else None
                        try:
                            inflight.append(
                                (pool.submit(_mp_worker_task, indices,
                                             aug_seed, self._task_seq,
                                             grants,
                                             (_trace.current_context()
                                              if _trace._active
                                              else None)),
                                 indices, grants))
                        except BaseException:
                            todo.appendleft(indices)
                            if ring is not None:
                                for name, size in grants:
                                    ring.give_back(name, size)
                            raise
                    fut, _, _ = inflight[0]
                    if _telemetry._active:
                        _telemetry.set_gauge("dataloader.queue_depth",
                                             len(inflight))
                        _t0 = time.perf_counter()
                        leftover, spec, wspans = \
                            fut.result(timeout=self._timeout)
                        _telemetry.observe("dataloader.wait_seconds",
                                           time.perf_counter() - _t0)
                        _telemetry.inc("dataloader.batches_total")
                    else:
                        leftover, spec, wspans = \
                            fut.result(timeout=self._timeout)
                    if wspans and _trace._active:
                        _trace.ingest(wspans)
                    inflight.popleft()
                except (BrokenProcessPool, cf.BrokenExecutor,
                        cf.TimeoutError, TimeoutError):
                    crashes += 1
                    # kill BEFORE reclaiming grants: a hung-but-alive
                    # worker could otherwise write into a segment the
                    # ring has already re-granted to a new task
                    self._kill_pool()
                    self._requeue(todo, inflight, ring)
                    if crashes > max_respawns:
                        _fault.record("dataloader.fallback_threaded")
                        self._force_threads = True
                        yield from self._threaded_remainder(todo, make)
                        return
                    _fault.record("dataloader.worker_respawn")
                    if _telemetry._active:
                        _telemetry.inc("dataloader.respawn_total")
                    time.sleep(backoff * (2 ** (crashes - 1)))
                    continue
                if ring is not None:
                    for name, size in leftover:
                        ring.give_back(name, size)
                    sizes = []
                    batch = _from_shm(spec, alloc, ring, sizes)
                    ring.last_sizes = sizes
                else:
                    batch = _from_shm(spec, alloc)
                yield batch
        finally:
            for fut, _, grants in inflight:
                try:
                    leftover, spec, _wspans = \
                        fut.result(timeout=self._timeout)
                    if ring is not None:
                        for name, size in leftover:
                            ring.give_back(name, size)
                    _free_shm(spec, ring)
                except (Exception, cf.CancelledError):  # noqa: BLE001
                    # a timed-out worker may still be writing into its
                    # granted segments: kill the pool first so the ring
                    # never re-grants a segment under a live writer
                    self._kill_pool()
                    if ring is not None and grants:
                        for name, size in grants:
                            ring.give_back(name, size)

    @staticmethod
    def _requeue(todo, inflight, ring=None):
        """Move every in-flight batch back onto the queue in order; shm
        blocks of tasks that did complete go back to the ring (or are
        unlinked), unused grants of tasks that did not are reclaimed. The
        caller has torn the pool down first."""
        for fut, _, grants in inflight:
            if fut.done() and not fut.cancelled() and \
                    fut.exception() is None:
                try:
                    leftover, spec, _wspans = fut.result()
                    if ring is not None:
                        for name, size in leftover:
                            ring.give_back(name, size)
                    _free_shm(spec, ring)
                    continue
                except Exception:  # noqa: BLE001 - best-effort cleanup
                    pass
            if ring is not None and grants:
                for name, size in grants:
                    ring.give_back(name, size)
        todo.extendleft(indices for _, indices, _ in reversed(inflight))
        inflight.clear()

    def _threaded_remainder(self, todo, make):
        """Finish the epoch on threads after the process pool was given
        up on; the host batchify keeps batch values identical."""
        with cf.ThreadPoolExecutor(self._num_workers) as pool:
            yield from self._pump(pool, make, todo)

    def close(self):
        """Release the worker pool and the pooled shm segments
        (idempotent; also run from __del__)."""
        self._kill_pool()
        ring, self._ring = self._ring, None
        if ring is not None:
            ring.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter-shutdown races
            pass

    def __len__(self):
        return len(self._batch_sampler)
