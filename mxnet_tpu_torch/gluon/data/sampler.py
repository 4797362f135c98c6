"""Samplers (reference: python/mxnet/gluon/data/sampler.py).

Copy of ``mxnet_tpu/gluon/data/sampler.py``: host-only, numpy-seeded, so
the two packages draw the same permutations from the same seeds.

Elastic-training addition (the reference's "Preemption & elastic
resume"): ``RandomSampler`` and ``BatchSampler`` carry ``state_dict()`` /
``load_state_dict()`` so a preempted run can resume at the exact next
batch of the interrupted epoch — the permutation is regenerated from the
recorded epoch seed and the already-consumed prefix is skipped.
"""
from __future__ import annotations

import numpy as onp


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """Shuffled indices; every epoch's permutation is drawn from a recorded
    per-epoch seed so it can be replayed bitwise on resume.

    ``seed=None`` (default) keeps the historical stochastic behavior (each
    epoch draws a fresh seed from numpy's global RNG) but still *records*
    the draw; a fixed ``seed`` makes epoch E's permutation a pure function
    of ``(seed, E)``.
    """

    def __init__(self, length, seed=None):
        self._length = length
        self._seed = seed
        self._epoch = 0          # epochs fully started (== index of next)
        self._epoch_seed = None  # seed of the most recently started epoch
        self._resume_seed = None

    def _draw_seed(self):
        if self._resume_seed is not None:
            s, self._resume_seed = self._resume_seed, None
            return s
        if self._seed is None:
            return int(onp.random.randint(0, 2 ** 31 - 1))
        return int(onp.random.SeedSequence(
            [int(self._seed), int(self._epoch)]).generate_state(1)[0])

    def __iter__(self):
        self._epoch_seed = self._draw_seed()
        self._epoch += 1
        indices = onp.random.RandomState(self._epoch_seed) \
            .permutation(self._length)
        return iter(indices.tolist())

    def __len__(self):
        return self._length

    def state_dict(self):
        """Replay info for the epoch currently being consumed (i.e. the
        most recent ``__iter__``)."""
        return {"epoch": self._epoch, "epoch_seed": self._epoch_seed,
                "seed": self._seed}

    def load_state_dict(self, state):
        self._epoch = max(0, int(state["epoch"]) - 1)
        self._resume_seed = state["epoch_seed"]


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class BatchSampler(Sampler):
    """Reference: sampler.py BatchSampler (keep/discard/rollover).

    Mid-epoch resume: ``state_dict()`` records the batch cursor (set by the
    DataLoader to the number of batches actually *served* to the training
    loop, not merely generated into the prefetch queue), the rollover carry
    the epoch started with, and the inner sampler's epoch-replay state.
    After ``load_state_dict()`` the next ``__iter__`` regenerates the same
    epoch and skips the consumed prefix.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []
        self._epoch_carry = []   # _prev as of the last epoch start (replay)
        self._cursor = 0         # batches generated this epoch
        self._resume = None

    def __iter__(self):
        skip = 0
        if self._resume is not None:
            skip = int(self._resume.get("cursor", 0))
            self._prev = list(self._resume.get("carry", []))
            self._resume = None
        self._epoch_carry = list(self._prev)
        self._cursor = 0
        batch, self._prev = self._prev, []

        def _emit(b):
            self._cursor += 1
            return self._cursor > skip

        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                if _emit(batch):
                    yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                if _emit(batch):
                    yield batch
            elif self._last_batch == "discard":
                pass
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(f"unknown last_batch {self._last_batch!r}")

    def resume_cursor(self):
        """Batches a pending resume will skip (0 when none is pending)."""
        return int(self._resume["cursor"]) if self._resume else 0

    def state_dict(self, cursor=None):
        inner = (self._sampler.state_dict()
                 if hasattr(self._sampler, "state_dict") else None)
        return {"cursor": self._cursor if cursor is None else int(cursor),
                "carry": list(self._epoch_carry), "sampler": inner}

    def load_state_dict(self, state):
        self._resume = {"cursor": int(state.get("cursor", 0)),
                        "carry": list(state.get("carry", []))}
        inner = state.get("sampler")
        if inner is not None:
            if not hasattr(self._sampler, "load_state_dict"):
                raise ValueError(
                    f"inner sampler {type(self._sampler).__name__} recorded "
                    "state but has no load_state_dict")
            self._sampler.load_state_dict(inner)

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length
