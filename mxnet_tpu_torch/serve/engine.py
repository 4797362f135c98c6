"""Continuous-batching serve engine over a fixed-footprint KV cache.

Counterpart of ``mxnet_tpu/serve/engine.py`` (the base engine: no weight
quantization, speculative decoding, prefix cache, SLO classes, telemetry,
tracing or health in this slice; asking for any of them raises).

- **Fixed footprint.** The KV cache (per layer one
  (max_slots, max_seq, heads, head_dim) K and V tensor) is allocated once,
  on the model's device, and updated in place by every prefill and decode.
- **One decode step for all slots.** Every live request advances together
  (batch dim = max_slots); idle and finished slots ride along masked.
  Prefill pads each prompt to the smallest fitting bucket
  (``serve.buckets``) and samples at ``length - 1``. ``warmup()`` runs each
  bucket's prefill and one decode step once, so the kernel build and the
  first launches happen outside any timed window.
- **Continuous batching.** A slot is freed the moment its request finishes
  (EOS or token budget) and the next queued request is admitted into it.
- **Sync-free step loop.** Each step's sampled (token, done) tensors stay on
  the device in a bounded :class:`_EmitWindow`; the host fetches them at
  most ``serve.drain_window`` steps later (or when it needs a slot), so
  dispatching a step never waits for the device.
"""
from __future__ import annotations

import collections
import time

import numpy as onp
import torch

from .. import config as _config
from .. import random as _random
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["Request", "ServeEngine", "EngineBusy", "load"]


class EngineBusy(MXNetError):
    """:meth:`ServeEngine.submit` rejected the request: the engine is
    stopping, or the bounded queue (``serve.max_queue``) is full.
    ``reason`` ("stopping" / "queue_full"), ``queued`` (depth at
    rejection), ``max_queue`` (the bound; 0 = unbounded) and
    ``retry_after_hint`` (queue depth x observed TPOT p50, seconds)."""

    def __init__(self, reason, queued, max_queue, retry_after_hint=0.0):
        self.reason = reason
        self.queued = queued
        self.max_queue = max_queue
        self.retry_after_hint = float(retry_after_hint)
        bound = f", bound {max_queue} (serve.max_queue)" if max_queue else ""
        hint = (f", retry after ~{self.retry_after_hint:.3f}s"
                if self.retry_after_hint else "")
        super().__init__(
            f"serve engine busy ({reason}): {queued} queued{bound}{hint}")


class Request:
    """One generation request and its latency record.

    ``generated`` holds every sampled token id (EOS included when hit);
    ``output_ids`` strips a trailing EOS. TTFT/TPOT are measured at drain
    time, when the token was available to the caller, so the deferred
    window's bounded staleness is charged to the engine."""

    __slots__ = ("id", "prompt", "max_new_tokens", "eos_id", "generated",
                 "slot", "finished", "rejected", "reject_reason",
                 "t_submit", "t_admitted", "t_first", "t_done")

    def __init__(self, rid, prompt, max_new_tokens, eos_id=None):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new_tokens = max(1, int(max_new_tokens))
        self.eos_id = eos_id
        self.generated = []
        self.slot = None
        self.finished = False
        self.rejected = False
        self.reject_reason = None
        self.t_submit = time.perf_counter()
        self.t_admitted = None
        self.t_first = None
        self.t_done = None

    @property
    def output_ids(self):
        out = list(self.generated)
        if out and self.eos_id is not None and out[-1] == self.eos_id:
            out.pop()
        return out

    @property
    def ttft(self):
        if self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def tpot(self):
        if self.t_done is None or self.t_first is None:
            return None
        return (self.t_done - self.t_first) / max(1, len(self.generated) - 1)

    def __repr__(self):
        state = "done" if self.finished else (
            "slot%d" % self.slot if self.slot is not None else "queued")
        return (f"Request(id={self.id}, prompt={len(self.prompt)} tok, "
                f"out={len(self.generated)} tok, {state})")


class _EmitWindow:
    """Bounded FIFO of ``(device tensors, sink)`` pairs whose host fetch is
    deferred off the step loop: the engine's own copy of the JAX package's
    ``pipeline.DeferredWindow``. ``push`` never touches the host until the
    window overflows, when the oldest entry (``window`` steps old, almost
    always computed by then) is fetched in place."""

    def __init__(self, window):
        self._window = max(0, int(window))
        self._pending = []

    def __len__(self):
        return len(self._pending)

    def push(self, value, sink):
        self._pending.append((value, sink))
        while len(self._pending) > self._window:
            self._drain_one()

    def _drain_one(self):
        value, sink = self._pending.pop(0)
        sink(tuple(v.cpu().numpy() for v in value))

    def drain_oldest(self, n=1):
        for _ in range(min(n, len(self._pending))):
            self._drain_one()

    def drain(self):
        """Fetch and deliver every pending entry, oldest first."""
        while self._pending:
            self._drain_one()


def _parse_buckets(spec):
    try:
        vals = sorted({int(v) for v in str(spec).split(",") if v.strip()})
    except ValueError as e:
        raise MXNetError(f"bad serve.buckets spec {spec!r}") from e
    if not vals or any(v <= 0 for v in vals):
        raise MXNetError(f"bad serve.buckets spec {spec!r}")
    return vals


def _not_in_slice(what):
    return MXNetError(f"{what} is not part of this slice of the PyTorch "
                      "port (mxnet_tpu_torch); see ROADMAP.md")


class ServeEngine:
    """Online inference over a block exposing the KV-cache surface
    (``init_cache`` / ``prefill`` / ``decode_step``: the GPT family).

    Usage::

        eng = mx.serve.load(model, max_slots=8, eos_id=50256)
        eng.warmup()
        reqs = [eng.submit(ids, max_new_tokens=64) for ids in prompts]
        eng.run()
        reqs[0].output_ids, reqs[0].ttft, eng.stats()

    ``temperature=0`` is greedy; >0 samples from softmax(logits/T) with a
    generator seeded from ``seed``. ``device`` defaults to ``cuda:0`` (it
    raises without CUDA) and must be the model's device.
    """

    def __init__(self, model, max_slots=None, max_seq=None, buckets=None,
                 eos_id=None, temperature=0.0, seed=0, quantize=None,
                 drain_window=None, cache_dtype="float32", draft=None,
                 prefix_cache=None, device=None):
        if quantize:
            raise _not_in_slice(f"quantize={quantize!r}")
        if draft is not None:
            raise _not_in_slice("speculative decoding (draft=)")
        if prefix_cache:
            raise _not_in_slice("the radix prefix cache (prefix_cache=)")
        for attr in ("init_cache", "prefill", "decode_step"):
            if not callable(getattr(model, attr, None)):
                raise MXNetError(
                    f"model {type(model).__name__} has no {attr}(); the "
                    "serve engine needs the KV-cache block surface")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise MXNetError(f"model lives on {model.device}, engine asked "
                             f"for {self.device}")
        if not model.initialized:
            raise MXNetError("model parameters are not initialized: call "
                             "initialize() or functional.load_params()")
        self.model = model
        self.max_slots = int(max_slots if max_slots is not None
                             else _config.get("serve.max_slots"))
        if self.max_slots <= 0:
            raise MXNetError("max_slots must be positive")
        if max_seq is None:
            max_seq = getattr(model, "max_length", None)
            if max_seq is None:
                raise MXNetError("max_seq not given and model has no "
                                 "max_length")
        self.max_seq = int(max_seq)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self._gen = _random.generator(seed, self.device)
        buckets = _parse_buckets(buckets if buckets is not None
                                 else _config.get("serve.buckets"))
        self.buckets = [b for b in buckets if b <= self.max_seq] \
            or [self.max_seq]
        self.cache_dtype = cache_dtype
        self._cache = model.init_cache(self.max_slots, self.max_seq,
                                       dtype=cache_dtype)
        n, dev = self.max_slots, self.device
        self._state = {
            "tokens": torch.zeros((n,), dtype=torch.long, device=dev),
            "positions": torch.zeros((n,), dtype=torch.long, device=dev),
            "done": torch.ones((n,), dtype=torch.bool, device=dev),
            "limits": torch.zeros((n,), dtype=torch.long, device=dev),
        }
        self._queue = collections.deque()
        self._slots = [None] * n
        self._free = list(range(n - 1, -1, -1))  # pop() -> lowest first
        self._window = _EmitWindow(
            drain_window if drain_window is not None
            else _config.get("serve.drain_window"))
        self._warmed = False
        self._next_id = 0
        self._steps = 0
        self._completed = []
        self._stopping = False
        self._max_queue = int(_config.get("serve.max_queue"))

    # -- device step functions -------------------------------------------

    def _sample(self, logits):
        if self.temperature > 0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def _decode(self):
        """Advance every slot one token; done slots keep their state.
        Returns the emit pair (token or -1 per slot, done per slot)."""
        st = self._state
        logits, self._cache = self.model.decode_step(
            st["tokens"][:, None], self._cache, st["positions"])
        tok = self._sample(logits)
        done0 = st["done"]
        positions = torch.where(done0, st["positions"], st["positions"] + 1)
        done = done0 | (positions >= st["limits"])
        if self.eos_id is not None:
            done = done | (tok == self.eos_id)
        self._state = {
            "tokens": torch.where(done0, st["tokens"], tok),
            "positions": positions,
            "done": done,
            "limits": st["limits"],
        }
        return torch.where(done0, -1, tok), done

    @torch.no_grad()
    def _prefill(self, prompt, slot, length, limit):
        """Prefill the bucket-padded ``prompt`` (bucket,) into ``slot`` and
        sample its first token at row ``length - 1``. Returns the emit
        pair (token, done) as 0-d device tensors."""
        logits, self._cache = self.model.prefill(prompt[None, :],
                                                 self._cache, slot)
        tok = self._sample(logits[0, length - 1][None, :])[0]
        if length >= limit:
            done = torch.ones((), dtype=torch.bool, device=self.device)
        elif self.eos_id is not None:
            done = tok == self.eos_id
        else:
            done = torch.zeros((), dtype=torch.bool, device=self.device)
        # fresh state tensors, so emits already in the window never change
        st = {k: v.clone() for k, v in self._state.items()}
        st["tokens"][slot] = tok
        st["positions"][slot] = length
        st["done"][slot] = done
        st["limits"][slot] = limit
        self._state = st
        return tok, done

    def warmup(self):
        """Run each bucket's prefill and one decode step once, on a free
        slot and without touching the engine state, then synchronize: the
        kernel build and first launches land here, not in a timed window.
        """
        if not self._free:
            raise MXNetError("warmup needs a free slot")
        scratch = self._free[-1]
        with torch.no_grad():
            for b in self.buckets:
                ids = torch.zeros((1, b), dtype=torch.long,
                                  device=self.device)
                self.model.prefill(ids, self._cache, scratch)
            st = self._state
            self.model.decode_step(st["tokens"][:, None], self._cache,
                                   st["positions"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True
        return self

    # -- scheduling ------------------------------------------------------

    def bucket_for(self, length):
        for b in self.buckets:
            if length <= b:
                return b
        raise MXNetError(
            f"prompt length {length} exceeds the largest bucket "
            f"{self.buckets[-1]} (serve.buckets, max_seq={self.max_seq})")

    def submit(self, prompt, max_new_tokens=32, eos_id="engine",
               slo_class=None):
        """Enqueue one request; returns its :class:`Request` handle.
        Admission happens inside :meth:`step` when a slot frees up."""
        if slo_class is not None:
            raise _not_in_slice("SLO classes (slo_class=)")
        prompt = [int(t) for t in onp.asarray(prompt).reshape(-1)]
        if not prompt:
            raise MXNetError("empty prompt")
        self.bucket_for(len(prompt))  # validate now, not at admission
        if self._stopping:
            raise EngineBusy("stopping", len(self._queue), self._max_queue,
                             retry_after_hint=self._retry_after_hint())
        if self._max_queue and len(self._queue) >= self._max_queue:
            raise EngineBusy("queue_full", len(self._queue), self._max_queue,
                             retry_after_hint=self._retry_after_hint())
        req = Request(self._next_id, prompt, max_new_tokens,
                      self.eos_id if eos_id == "engine" else eos_id)
        self._next_id += 1
        self._queue.append(req)
        return req

    def _finish(self, req):
        req.finished = True
        req.t_done = time.perf_counter()
        if req.slot is not None:
            self._slots[req.slot] = None
            self._free.append(req.slot)
            self._free.sort(reverse=True)
            req.slot = None
        self._completed.append(req)

    def _prefill_sink(self, req):
        def sink(fetched):
            tok, done = int(fetched[0]), bool(fetched[1])
            req.t_first = time.perf_counter()
            req.generated.append(tok)
            if done:
                self._finish(req)
        return sink

    def _decode_sink(self, slot_map):
        def sink(fetched):
            toks, done = fetched
            for slot, req in slot_map.items():
                if req.finished:
                    continue  # finished in an older entry of this window
                tok = int(toks[slot])
                if tok >= 0:
                    req.generated.append(tok)
                if bool(done[slot]):
                    self._finish(req)
        return sink

    def _admit(self):
        admitted = 0
        while self._queue and self._free:
            self._dispatch_prefill(self._queue.popleft(), self._free.pop())
            admitted += 1
        return admitted

    def _dispatch_prefill(self, req, slot):
        length = len(req.prompt)
        limit = min(length + req.max_new_tokens - 1, self.max_seq - 1)
        padded = onp.zeros((self.bucket_for(length),), dtype=onp.int64)
        padded[:length] = req.prompt
        prompt = torch.from_numpy(padded).to(self.device, non_blocking=True)
        emit = self._prefill(prompt, slot, length, limit)
        req.slot = slot
        req.t_admitted = time.perf_counter()
        self._slots[slot] = req
        self._window.push(emit, self._prefill_sink(req))

    # -- the serve loop --------------------------------------------------

    def step(self):
        """One continuous-batching iteration: free slots via bounded drain
        when the queue is starved, admit, dispatch ONE decode step for
        every live slot, defer the result. Returns False when fully idle
        (nothing queued, running, or pending drain)."""
        if self._queue and not self._free and len(self._window):
            # starved for slots: reclaim just enough, oldest first
            self._window.drain_oldest(min(len(self._queue),
                                          len(self._window)))
        admitted = self._admit()
        live = {i: r for i, r in enumerate(self._slots) if r is not None}
        if not live:
            if len(self._window):
                self._window.drain()
                return True
            return admitted > 0
        emit = self._decode()
        self._steps += 1
        self._window.push(emit, self._decode_sink(live))
        return True

    def drain(self):
        """Fetch every deferred emit (host sync); completions land."""
        self._window.drain()

    @property
    def pending(self):
        return bool(self._queue or len(self._window)
                    or any(s is not None for s in self._slots))

    def run(self, max_steps=None):
        """Drive :meth:`step` until every submitted request finished (or
        ``max_steps`` decode steps elapsed), then drain."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self.drain()
        return self

    def stop(self, drain=True):
        """Graceful shutdown: from now on :meth:`submit` raises
        :class:`EngineBusy` ("stopping"). ``drain=True`` finishes every
        in-flight and queued request first; ``drain=False`` rejects the
        queued ones and only fetches already-dispatched emits."""
        if self._stopping:
            return self
        self._stopping = True
        if drain:
            self.run()
        else:
            while self._queue:
                req = self._queue.popleft()
                req.rejected = True
                req.reject_reason = "stopping"
            self.drain()
        return self

    def update_weights(self, params):
        raise _not_in_slice("update_weights")

    def _retry_after_hint(self):
        tpots = sorted(r.tpot for r in self._completed[-256:]
                       if r.tpot is not None)
        tpot = tpots[len(tpots) // 2] if tpots else 0.02
        return tpot * max(1, len(self._queue))

    # -- reporting -------------------------------------------------------

    def stats(self):
        """Host-side aggregate: counts, tokens and latency percentiles
        (seconds) from the per-request records."""
        done = self._completed
        ttfts = sorted(r.ttft for r in done if r.ttft is not None)
        tpots = sorted(r.tpot for r in done if r.tpot is not None)

        def pct(vals, q):
            return float(onp.percentile(vals, q)) if vals else None

        out = {
            "completed": len(done),
            "queued": len(self._queue),
            "live": sum(1 for s in self._slots if s is not None),
            "steps": self._steps,
            "tokens_out": sum(len(r.generated) for r in done),
            "max_slots": self.max_slots,
            "max_seq": self.max_seq,
            "buckets": list(self.buckets),
            "cache_dtype": str(self.cache_dtype),
        }
        for name, vals in (("ttft", ttfts), ("tpot", tpots)):
            out[name] = {"p50": pct(vals, 50), "p95": pct(vals, 95),
                         "p99": pct(vals, 99)}
        return out


def load(model, max_slots=None, quantize=None, warmup=False, **kwargs):
    """Build a :class:`ServeEngine` over ``model``; ``warmup=True`` runs
    :meth:`ServeEngine.warmup` before returning."""
    eng = ServeEngine(model, max_slots=max_slots, quantize=quantize,
                      **kwargs)
    if warmup:
        eng.warmup()
    return eng
