"""Continuous-batching serve engine: each step is one captured CUDA graph.

Counterpart of ``mxnet_tpu/serve/engine.py``, whose engine is built on one
resident compiled decode step and one executable per prefill bucket. Here
the counterpart of an ahead-of-time executable is a CUDA graph:

- **Fixed footprint.** The KV cache (per layer one
  (max_slots, max_seq, heads, head_dim) K and V tensor, or int8 values with
  per-(slot, row, head) fp32 scales) is allocated once, on the model's
  device, and updated in place by every step.
- **One graph per executable the reference compiles.** The decode step
  (or, with a draft model, the speculative propose-and-verify round), one
  prefill per prompt-length bucket (``serve.buckets``), and with the prefix
  cache one fused block-copy + suffix prefill per bucket. ``warmup()``
  builds all of them: each step function runs once eagerly on a side
  stream (kernel builds, library handles), the engine state it touched is
  put back, and on the card the function is captured as one
  ``torch.cuda.CUDAGraph`` into a memory pool the engine's graphs share
  (they never run concurrently). A later call copies its host inputs
  (prompt, slot, lengths: one int64 vector) into the graph's input buffer
  and replays it; slots, rows and lengths are device tensors inside the
  graph, never Python ints baked into it. ``compiles`` counts the builds
  and ``post_warmup_compiles`` those after ``warmup()``, which should stay
  0. On the CPU the same functions run eagerly (the build is their first
  call). On the card a capture or replay that fails raises with its
  reason; nothing runs the eager step in its place.
- **Continuous batching.** A slot is freed the moment its request finishes
  (EOS or token budget) and the next queued request is admitted into it,
  in strict SLO-class priority with starvation aging
  (``serve.slo_classes``, ``serve.class_aging_ms``,
  ``serve.class_max_queue``).
- **Sync-free step loop.** Each step's emit (sampled tokens and done
  flags, one int64 tensor copied out of the graph's output buffer, which
  the next replay overwrites) stays on the device in a bounded
  :class:`_EmitWindow`; the host fetches it at most ``serve.drain_window``
  steps later (or when it needs a slot).
- **Low-bit storage** (``quantize=``, serve/quantize.py): int8 or int4
  weights dequantized at the top of every step (plain PyTorch inside the
  graph), and an int8 KV cache.
- **Radix prefix cache** (``prefix_cache=``, serve/prefix.py): a prompt
  whose leading blocks are indexed gathers their KV rows from their donor
  slots and prefills only the suffix, in one dispatch.
- **Speculative decoding** (``draft=``, greedy only): the draft proposes
  ``serve.spec_tokens`` tokens and the model verifies them in one
  ``decode_multi``; the output equals the non-speculative greedy output.
- **Weight swaps** (``update_weights`` / ``restore_weights``) copy into the
  weight tensors the graphs read, so no capture is needed.

The engine holds its own copy of the model's weights (the reference's
engine holds the arrays it read at construction): a weight swap never
changes the model, and changes to the model after construction do not
reach the engine.

The host planes, as the reference's engine feeds them: the ``serve.*``
metrics (requests, admissions, completions, tokens, TTFT and TPOT observed
at drain, rejections, queue depth, slot occupancy, prefix and speculation
counters); ``mx.trace`` spans (a ``serve.request`` root per request with
``serve.enqueue``, ``serve.prefill``, one ``serve.decode_step`` per step
and ``serve.drain`` children); a ``/healthz`` provider (red while
stopping, when the step loop stalls past ``serve.health_window`` with work
pending, or when a declared SLO's error budget burns past
``goodput.burn_threshold``), ``slo_burn`` over the ``serve.slo_ttft_ms`` /
``serve.slo_tpot_ms`` objectives; the phase reservoir of
``stats()["phases"]`` (``serve.phase_sampling``); the
``serve.prefix_evict`` fault point; ``telemetry.note_compile`` and
``insight.register_executable`` for each built graph, its cost counted on
the warm-up run; a goodput ``drain`` bracket around ``stop()``; and a
blackbox bundle when ``run()`` dies. A graph's ops count once, on its
warm-up run (``_hooks.tracing``); its capture and every later call (an
eager call on the CPU too) run them without hooks. Every hook is host
work outside the graphs, and none synchronizes: TTFT and TPOT are taken
when the deferred window drains.
"""
from __future__ import annotations

import collections
import contextlib
import time
import weakref

import numpy as onp
import torch

from .. import _hooks
from .. import config as _config
from .. import fault as _fault
from .. import functional as _functional
from .. import goodput as _goodput
from .. import insight as _insight
from .. import pipeline as _pipeline
from .. import profiler as _profiler
from .. import random as _random
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..base import MXNetError
from ..context import resolve_device
from ..ops.attention import _leaves, gather_cache_rows
from . import quantize as _quantize
from .prefix import RadixIndex

__all__ = ["Request", "ServeEngine", "EngineBusy", "load", "QUANTIZE_MODES"]

_telemetry.declare_metric(
    "serve.requests_total", "counter",
    "requests submitted to serve engines")
_telemetry.declare_metric(
    "serve.admitted_total", "counter",
    "requests admitted into a decode slot (prefill dispatched)")
_telemetry.declare_metric(
    "serve.completed_total", "counter",
    "requests finished (EOS or token budget)")
_telemetry.declare_metric(
    "serve.tokens_total", "counter",
    "generated tokens delivered to requests")
_telemetry.declare_metric(
    "serve.prefill_tokens_total", "counter",
    "prompt tokens processed by prefill (bucket-padded length)")
_telemetry.declare_metric(
    "serve.steps_total", "counter",
    "continuous-batching decode steps dispatched")
_telemetry.declare_metric(
    "serve.step_seconds", "histogram",
    "host wall time to dispatch one decode step (sync-free: excludes "
    "device completion)", buckets=_telemetry.TIME_BUCKETS)
_telemetry.declare_metric(
    "serve.ttft_seconds", "histogram",
    "time to first token: submit -> first token drained to the host",
    buckets=_telemetry.TIME_BUCKETS)
_telemetry.declare_metric(
    "serve.tpot_seconds", "histogram",
    "time per output token after the first (decode cadence per request)",
    buckets=_telemetry.TIME_BUCKETS)
_telemetry.declare_metric(
    "serve.queue_depth", "gauge",
    "requests waiting for a free slot")
_telemetry.declare_metric(
    "serve.rejected_total", "counter",
    "requests rejected by submit() (engine stopping, or the bounded "
    "serve.max_queue backpressure) or discarded queued by "
    "stop(drain=False)")
_telemetry.declare_metric(
    "serve.slot_occupancy", "gauge",
    "slots holding a live request")
_telemetry.declare_metric(
    "serve.post_warmup_compiles_total", "counter",
    "XLA compiles after warmup() — should stay 0; any hit means a "
    "request shape escaped the bucket grid")
_telemetry.declare_metric(
    "serve.quantized_params", "gauge",
    "parameters stored low-bit by the engine's weight quantization "
    "(serve.quantize_min_elems / serve.quantize_ndim govern eligibility)")
_telemetry.declare_metric(
    "serve.passthrough_params", "gauge",
    "parameters kept in float by the engine's weight quantization "
    "(ineligible rank/size, or quantization off)")
_telemetry.declare_metric(
    "serve.slo_violations_total", "counter",
    "requests finishing past a declared serving SLO objective, by kind "
    "(ttft: serve.slo_ttft_ms at first token; tpot: serve.slo_tpot_ms "
    "per output token at finish)")
_telemetry.declare_metric(
    "serve.slo_burn_rate", "gauge",
    "per-engine error-budget burn rate against serve.slo_target over "
    "the trailing window, by kind — 1.0 spends the budget exactly; "
    "past goodput.burn_threshold the engine's /healthz goes red (the "
    "autoscaler admission signal)")

_telemetry.declare_metric(
    "serve.prefix_hits_total", "counter",
    "admissions that reused a cached KV prefix (radix prefix cache): "
    "matched blocks were row-copied and only the suffix prefilled")
_telemetry.declare_metric(
    "serve.prefix_misses_total", "counter",
    "admissions that prefilled the whole prompt (no cached prefix, a "
    "suffix that would overrun max_seq, or a serve.prefix_evict "
    "injection between match and copy)")
_telemetry.declare_metric(
    "serve.prefix_tokens_reused_total", "counter",
    "prompt tokens whose KV was row-copied from the prefix cache "
    "instead of recomputed by prefill")
_telemetry.declare_metric(
    "serve.prefix_evictions_total", "counter",
    "KV blocks dropped from the radix index (slot reuse, LRU capacity "
    "pressure, or the serve.prefix_evict chaos injection)")
_telemetry.declare_metric(
    "serve.prefix_blocks", "gauge",
    "KV blocks currently indexed by the engine's radix prefix cache")
_telemetry.declare_metric(
    "serve.spec_rounds_total", "counter",
    "speculative-decoding rounds dispatched (one draft propose + one "
    "batched big-model verify per round)")
_telemetry.declare_metric(
    "serve.spec_proposed_total", "counter",
    "draft tokens proposed by speculative decoding (k per live slot "
    "per round)")
_telemetry.declare_metric(
    "serve.spec_accepted_total", "counter",
    "draft proposals the big-model verify accepted (the emitted "
    "correction token is not counted)")
_telemetry.declare_metric(
    "serve.spec_acceptance_rate", "gauge",
    "trailing draft-acceptance ratio (accepted / proposed) — the "
    "knob that decides whether speculation pays for its draft")
_telemetry.declare_metric(
    "serve.class_ttft_seconds", "histogram",
    "per-SLO-class time to first token (labelled slo_class; the "
    "unlabelled serve.ttft_seconds carries the aggregate)",
    buckets=_telemetry.TIME_BUCKETS)
_telemetry.declare_metric(
    "serve.class_tpot_seconds", "histogram",
    "per-SLO-class time per output token (labelled slo_class)",
    buckets=_telemetry.TIME_BUCKETS)
_telemetry.declare_metric(
    "serve.class_queue_depth", "gauge",
    "queued requests per SLO class (labelled slo_class)")
_telemetry.declare_metric(
    "serve.aged_admissions_total", "counter",
    "admissions where starvation aging (serve.class_aging_ms) "
    "promoted a request ahead of strict class priority")

#: weight-storage modes ServeEngine(quantize=...) understands; combine with
#: "," (e.g. "int4_weights,int8_kv")
QUANTIZE_MODES = ("int8_weights", "int4_weights", "int8_kv")


def _parse_quantize(quantize):
    """-> (normalized spec or None, weight mode or None, kv_int8 flag)."""
    if not quantize:
        return None, None, False
    modes = [m.strip() for m in str(quantize).split(",") if m.strip()]
    unknown = [m for m in modes if m not in QUANTIZE_MODES]
    if unknown or not modes:
        raise MXNetError(
            f"unknown quantize mode {quantize!r}; modes: "
            f"{', '.join(QUANTIZE_MODES)} (comma-combinable)")
    weight = [m for m in modes if m.endswith("_weights")]
    if len(weight) > 1:
        raise MXNetError(f"conflicting weight modes in {quantize!r}")
    return ",".join(dict.fromkeys(modes)), \
        (weight[0] if weight else None), "int8_kv" in modes


class EngineBusy(MXNetError):
    """:meth:`ServeEngine.submit` rejected the request: the engine is
    stopping, or the bounded queue (``serve.max_queue``, or the class's
    ``serve.class_max_queue``) is full. ``reason`` ("stopping" /
    "queue_full" / "class_queue_full"), ``queued`` (depth at rejection),
    ``max_queue`` (the bound; 0 = unbounded) and ``retry_after_hint``
    (queue depth x observed TPOT p50, seconds)."""

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
                 "t_submit", "t_admitted", "t_first", "t_done", "phases",
                 "_span", "_enq", "slo_class", "prefix_tokens", "_nodes")

    def __init__(self, rid, prompt, max_new_tokens, eos_id=None,
                 slo_class="default"):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new_tokens = max(1, int(max_new_tokens))
        self.eos_id = eos_id
        #: admission-priority class (serve.slo_classes; "default" when the
        #: engine runs classless)
        self.slo_class = slo_class
        #: prompt tokens served from the radix prefix cache (KV rows
        #: copied instead of recomputed); 0 = full prefill
        self.prefix_tokens = 0
        self._nodes = ()  # pinned radix path, released at _finish
        self.generated = []
        self.slot = None
        self.finished = False
        self.rejected = False
        self.reject_reason = None
        self.t_submit = time.perf_counter()
        self.t_admitted = None
        self.t_first = None
        self.t_done = None
        #: per-phase wall-time samples (seconds), the source of
        #: stats()["phases"]: unbounded while mx.trace records this
        #: request, else capped by serve.phase_sampling
        self.phases = {}
        self._span = None   # serve.request root (trace.SpanHandle)
        self._enq = None    # serve.enqueue child, open until admission

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


class _EmitWindow(_pipeline.DeferredWindow):
    """DeferredWindow whose entries are device *tensors* (per-slot token
    ids and done flags), not scalars: the drain copies one to the host and
    hands the sink a NumPy array. Overflow keeps the base class's
    behaviour: the oldest entry (``window`` steps old, almost always
    computed by then) is fetched in place, counted as a host sync and a
    ``pipeline.deferred_evictions_total`` tick."""

    def _drain_one(self):
        value, sink = self._pending.pop(0)
        sink(value.cpu().numpy())

    def drain_oldest(self, n=1):
        for _ in range(min(n, len(self._pending))):
            if _pipeline._guard_depth:
                _pipeline.note_host_sync("serve.drain")
            self._drain_one()


def _parse_buckets(spec):
    try:
        vals = sorted({int(v) for v in str(spec).split(",") if v.strip()})
    except ValueError as e:
        raise MXNetError(f"bad serve.buckets spec {spec!r}") from e
    if not vals or any(v <= 0 for v in vals):
        raise MXNetError(f"bad serve.buckets spec {spec!r}")
    return vals


class _Step:
    """One step executable: ``fn(inputs)`` -> emit tensor, where ``inputs``
    is the call's int64 host vector (None for the decode step) carried to
    the device. On the CPU ``fn`` runs eagerly; on the card it is one CUDA
    graph whose input buffer each call fills (one H2D copy from pinned
    memory) before the replay, and whose output is copied out, so an emit
    in the window is never the buffer the next replay writes."""

    def __init__(self, fn, n_in, device):
        self.fn = fn
        self.n_in = n_in
        self.device = device
        self.graph = None
        self.static_in = (torch.zeros((n_in,), dtype=torch.long,
                                      device=device) if n_in else None)
        self.static_out = None
        #: seconds of the warm-up run and the capture
        self.build_s = 0.0
        #: the cost counted on the warm-up run, while mx.insight is on
        self.cost = {}

    def cost_analysis(self):
        """The counted cost under XLA's keys (``insight.capture_cost``)."""
        return {"flops": self.cost.get("flops"),
                "bytes accessed": self.cost.get("bytes_accessed"),
                "bytes accessedout{}": self.cost.get("output_bytes")}

    def _inputs(self, host):
        if not self.n_in:
            return None
        src = torch.from_numpy(host)
        if self.device.type == "cuda":
            self.static_in.copy_(src.pin_memory(), non_blocking=True)
            return self.static_in
        return src

    def capture(self, stream, pool, generator):
        """Capture ``fn`` into ``pool`` on ``stream``: the steps of
        ``torch.cuda.graph`` without its garbage collection and cache
        emptying, which would cost every one of an engine's captures."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool, capture_error_mode="thread_local")
            try:
                out = self.fn(self.static_in)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid already: report fn's error
                raise
            graph.capture_end()
        self.static_out = out
        self.graph = graph

    def __call__(self, host=None):
        inputs = self._inputs(host)
        if self.graph is None:
            return self.fn(inputs)
        self.graph.replay()
        return self.static_out.clone()


class ServeEngine:
    """Online inference over a block exposing the KV-cache surface
    (``init_cache`` / ``prefill`` / ``decode_step``; ``prefill_suffix`` and
    ``copy_cache_rows`` for the prefix cache, ``decode_multi`` for
    speculative decoding: the GPT family).

    Usage::

        eng = mx.serve.load(net, max_slots=8, eos_id=50256)
        eng.warmup()                      # capture the whole grid
        reqs = [eng.submit(ids, max_new_tokens=64) for ids in prompts]
        eng.run()
        reqs[0].output_ids, reqs[0].ttft, eng.stats()

    ``temperature=0`` is greedy; >0 samples from softmax(logits/T) with a
    generator seeded from ``seed``. ``quantize`` picks low-bit storage,
    comma-combinable: ``"int8_weights"`` (per-channel int8 weights),
    ``"int4_weights"`` (group-wise int4, two nibbles a byte), ``"int8_kv"``
    (int8 KV cache with per-(slot, row, head) scales). ``draft`` is a small
    model with the same KV-cache surface for speculative decoding
    (``temperature=0`` only); ``prefix_cache`` (default
    ``serve.prefix_cache``) turns on radix prefix-cache KV reuse.
    ``device`` defaults to ``cuda:0`` (it raises without CUDA) and must be
    the model's device.
    """

    def __init__(self, model, max_slots=None, max_seq=None, buckets=None,
                 eos_id=None, temperature=0.0, seed=0, quantize=None,
                 drain_window=None, cache_dtype="float32", draft=None,
                 prefix_cache=None, device=None):
        for attr in ("init_cache", "prefill", "decode_step"):
            if not callable(getattr(model, attr, None)):
                raise MXNetError(
                    f"model {type(model).__name__} has no {attr}(); the "
                    "serve engine needs the KV-cache block surface")
        self.device = resolve_device(device)
        self._check_model(model, "model")
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
        self.quantize, weight_mode, kv_int8 = _parse_quantize(quantize)
        self._weight_mode = weight_mode
        if (weight_mode == "int4_weights"
                and getattr(model, "_fp8_trained", False)
                and not _config.get("serve.allow_fp8_requant")):
            # fp8-trained weights already carry ~2 mantissa bits of
            # quantization noise at every matmul site; group-wise int4 on
            # top compounds it past the accuracy int4 was validated under.
            # int8_weights / int8_kv compose (int8's grid is finer than
            # e4m3's).
            raise MXNetError(
                "quantize='int4_weights' on an fp8-trained checkpoint "
                "(model._fp8_trained is set): compounding int4 weight "
                "quantization on fp8 training noise is refused by "
                "default. Serve with 'int8_weights'/'int8_kv' (which "
                "compose with fp8 training), or set "
                "mx.config.set('serve.allow_fp8_requant', True) to "
                "override after validating accuracy.")
        if kv_int8:
            cache_dtype = "int8"
        with torch.no_grad():
            # the engine's own weights: a swap copies into these tensors
            params = {n: p.data().detach().clone()
                      for n, p in model.collect_params().items()}
            pt, qt, qdt = self._quantize_weights(params)
        del params
        self._params = (pt, qt)
        self._qdtypes = qdt
        if _telemetry._active and weight_mode:
            _telemetry.set_gauge("serve.quantized_params", len(qt))
            _telemetry.set_gauge("serve.passthrough_params", len(pt))
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
        self._exe = {}
        self._warmed = False
        self.compiles = 0
        self.post_warmup_compiles = 0
        #: seconds spent building (warming up and capturing) step graphs
        self.capture_seconds = 0.0
        self._pool = self._stream = None
        self._next_id = 0
        self._steps = 0
        self._completed = []
        self._stopping = False
        self._max_queue = int(_config.get("serve.max_queue"))
        self._last_step_time = None
        self._created = time.monotonic()
        # serving SLO objectives (0 = disarmed) + the always-on bounded
        # phase reservoir (stats()["phases"] without the tracer)
        self._slo_ttft = float(_config.get("serve.slo_ttft_ms")) / 1e3
        self._slo_tpot = float(_config.get("serve.slo_tpot_ms")) / 1e3
        self._slo_events = collections.deque(maxlen=2048)
        self._phase_cap = int(_config.get("serve.phase_sampling"))
        # the prefix/spec graphs are a second planned grid: they count
        # against their own owner in the recompile detector
        self._aux_exe_owner = type("ServeAuxGrid", (), {})()
        # -- SLO classes: strict-priority admission over one queue ------
        spec = str(_config.get("serve.slo_classes") or "")
        self._classes = [c.strip() for c in spec.split(",") if c.strip()] \
            or ["default"]
        if len(set(self._classes)) != len(self._classes):
            raise MXNetError(
                f"duplicate class in serve.slo_classes {spec!r}")
        self._class_rank = {c: i for i, c in enumerate(self._classes)}
        self._class_bounds = {}
        bspec = str(_config.get("serve.class_max_queue") or "")
        for part in (p.strip() for p in bspec.split(",") if p.strip()):
            cls, _, bound = part.partition("=")
            cls = cls.strip()
            if cls not in self._class_rank or not bound.strip().isdigit():
                raise MXNetError(
                    f"bad serve.class_max_queue entry {part!r} (classes: "
                    f"{', '.join(self._classes)})")
            self._class_bounds[cls] = int(bound)
        self._aging = float(_config.get("serve.class_aging_ms")) / 1e3
        self._aged_admissions = 0
        # -- radix prefix cache -----------------------------------------
        if prefix_cache is None:
            prefix_cache = bool(_config.get("serve.prefix_cache"))
        self._prefix = None
        self._prefix_block = int(_config.get("serve.prefix_block"))
        if prefix_cache:
            if self._prefix_block <= 0:
                raise MXNetError("serve.prefix_block must be positive")
            for attr in ("prefill_suffix", "copy_cache_rows"):
                if not callable(getattr(model, attr, None)):
                    raise MXNetError(
                        f"model {type(model).__name__} has no {attr}(); "
                        "the prefix cache needs the suffix-prefill block "
                        "surface")
            self._prefix = RadixIndex(
                self._prefix_block,
                int(_config.get("serve.prefix_capacity")))
        # -- speculative decoding (draft model) -------------------------
        self.draft = draft
        self._spec_k = 0
        self._draft_params = None
        self._draft_cache = None
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        if draft is not None:
            if self.temperature != 0.0:
                raise MXNetError(
                    "speculative decoding needs temperature=0: the verify "
                    "keeps greedy output token-for-token identical, which "
                    "has no sampled analogue here")
            if not callable(getattr(model, "decode_multi", None)):
                raise MXNetError(
                    f"model {type(model).__name__} has no decode_multi(); "
                    "the speculative verify needs the multi-token decode "
                    "surface")
            for attr in ("init_cache", "prefill", "decode_step"):
                if not callable(getattr(draft, attr, None)):
                    raise MXNetError(
                        f"draft {type(draft).__name__} has no {attr}(); "
                        "the draft must expose the same KV-cache surface "
                        "as the served model")
            if self._prefix is not None:
                for attr in ("prefill_suffix", "copy_cache_rows"):
                    if not callable(getattr(draft, attr, None)):
                        raise MXNetError(
                            f"draft {type(draft).__name__} has no {attr}(); "
                            "combining the prefix cache with speculative "
                            "decoding needs it on the draft too (its KV "
                            "rows are copied alongside)")
            self._check_model(draft, "draft")
            self._spec_k = max(2, int(_config.get("serve.spec_tokens")))
            # the draft's weights stay float and are read in place: the
            # engine never writes them, and the verify pins the output to
            # the served model
            self._draft_params = {n: p.data() for n, p in
                                  draft.collect_params().items()}
            self._draft_cache = draft.init_cache(self.max_slots,
                                                 self.max_seq,
                                                 dtype=cache_dtype)
        self._register_health()

    def _register_health(self):
        """Register this engine's /healthz provider: the ops endpoint's
        /healthz reflects THIS engine's step-loop liveness (a process hosts
        one serving engine; the newest wins). Bound weakly: a collected
        engine must not pin a stale check. Re-registered by :meth:`resume`
        after :meth:`stop` unregistered it."""
        ref = weakref.ref(self)

        def _check():
            eng = ref()
            if eng is None:
                _telemetry.unregister_health("serve")
                return True
            return eng._health()

        self._health_name = _telemetry.register_health("serve", _check)

    def _check_model(self, model, what):
        if model.device != self.device:
            raise MXNetError(f"{what} lives on {model.device}, engine asked "
                             f"for {self.device}")
        if not model.initialized:
            raise MXNetError(f"{what} parameters are not initialized: call "
                             "initialize() or functional.load_params()")

    # -- weights ---------------------------------------------------------

    def _quantize_weights(self, params):
        """The engine's weight-storage mode over a flat {name: tensor} dict
        -> ``(passthrough, quantized, qdtypes)``; shared by __init__ and
        :meth:`update_weights`, so a swap reproduces the layout the graphs
        were captured against."""
        if self._weight_mode == "int8_weights":
            return _quantize.quantize_params_int8(params)
        if self._weight_mode == "int4_weights":
            return _quantize.quantize_params_int4(params)
        return params, {}, {}

    def _full_params(self):
        pt, qt = self._params
        if not qt:
            return pt
        return _quantize.dequantize_params(pt, qt, self._qdtypes)

    # -- step functions (run eagerly, or captured once per graph) --------

    def _sample(self, logits):
        if self.temperature > 0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _call(self, model, params, method, *args):
        (out, _), _ = _functional.functional_call(model, params, *args,
                                                  method=method)
        return out

    def _decode_fn(self, _inputs):
        """Advance every slot one token; done slots keep their state.
        Emit: (2, slots) of (token or -1, done)."""
        st = self._state
        logits = self._call(self.model, self._full_params(), "decode_step",
                            st["tokens"][:, None], self._cache,
                            st["positions"])
        tok = self._sample(logits)
        done0 = st["done"]
        positions = torch.where(done0, st["positions"], st["positions"] + 1)
        done = done0 | (positions >= st["limits"])
        if self.eos_id is not None:
            done = done | (tok == self.eos_id)
        emit = torch.stack([torch.where(done0, -1, tok), done.long()])
        tokens = torch.where(done0, st["tokens"], tok)
        st["tokens"].copy_(tokens)
        st["positions"].copy_(positions)
        st["done"].copy_(done)
        return emit

    def _admit_state(self, logits, slot, length, end, limit):
        """Sample the first token from row ``length - 1`` of a prompt's
        logits (L, vocab) and set ``slot``'s state (position ``end``); all
        operands are device scalars. Emit: (token, done)."""
        row = logits.index_select(0, (length - 1).reshape(1))
        tok = self._sample(row)[0]
        done = end >= limit
        if self.eos_id is not None:
            done = done | (tok == self.eos_id)
        st, at = self._state, slot.reshape(1)
        for key, value in (("tokens", tok), ("positions", end),
                           ("done", done), ("limits", limit)):
            st[key].index_copy_(0, at, value.reshape(1).to(st[key].dtype))
        return torch.stack([tok, done.long()])

    def _prefill_fn(self, bucket):
        def fn(inputs):
            prompt = inputs[:bucket][None, :]
            slot, length, limit = inputs[bucket:bucket + 3].unbind()
            logits = self._call(self.model, self._full_params(), "prefill",
                                prompt, self._cache, slot)
            if self.draft is not None:
                self._call(self.draft, self._draft_params, "prefill",
                           prompt, self._draft_cache, slot)
            return self._admit_state(logits[0], slot, length, length, limit)
        return fn

    def _cache_tree(self):
        if self.draft is not None:
            return (self._cache, self._draft_cache)
        return self._cache

    def _suffix_fn(self, bucket):
        """Prefix-cache admission, fused: gather the matched KV block path
        into rows [0, start) of ``slot`` (identity coordinates past it),
        then prefill only the ``length``-token suffix (padded to its
        bucket) and sample from its last real row."""
        s = self.max_seq

        def fn(inputs):
            suffix = inputs[:bucket][None, :]
            src_slots = inputs[bucket:bucket + s]
            src_rows = inputs[bucket + s:bucket + 2 * s]
            slot, start, length, limit = \
                inputs[bucket + 2 * s:bucket + 2 * s + 4].unbind()
            gather_cache_rows(self._cache_tree(), src_slots, src_rows, slot)
            logits = self._call(self.model, self._full_params(),
                                "prefill_suffix", suffix, self._cache, slot,
                                start)
            if self.draft is not None:
                self._call(self.draft, self._draft_params, "prefill_suffix",
                           suffix, self._draft_cache, slot, start)
            return self._admit_state(logits[0], slot, length, start + length,
                                     limit)
        return fn

    def _spec_fn(self, _inputs):
        """One speculative round: the draft proposes k tokens greedily
        against its own cache, then the model verifies all k in one
        ``decode_multi``. Proposal i stands iff every earlier one matched
        the model's argmax, and the first disagreement is replaced by the
        model's own token, so the output is the non-speculative greedy
        output token for token. A live slot emits 1 to k tokens (none when
        done); rows written past the accepted point are rewritten before
        anything attends to them. Emit: (slots, k + 1): k tokens (-1 padded)
        and the done flag."""
        st = self._state
        n, k = self.max_slots, self._spec_k
        pos0 = st["positions"]
        cur = st["tokens"]
        drafts = []
        for i in range(k):
            dlogits = self._call(self.draft, self._draft_params,
                                 "decode_step", cur[:, None],
                                 self._draft_cache, pos0 + i)
            cur = torch.argmax(dlogits, dim=-1)
            drafts.append(cur)
        d = torch.stack(drafts, dim=1)                        # (n, k)
        seq = torch.cat([st["tokens"][:, None], d[:, :k - 1]], dim=1)
        logits = self._call(self.model, self._full_params(), "decode_multi",
                            seq, self._cache, pos0)
        b = torch.argmax(logits, dim=-1)                      # (n, k)
        ones = torch.ones((n, 1), dtype=torch.bool, device=b.device)
        ok = torch.cat([ones, torch.cumprod(
            (d[:, :k - 1] == b[:, :k - 1]).long(), dim=1).bool()], dim=1)
        pos_i = pos0[:, None] + 1 + torch.arange(k, device=b.device)[None, :]
        stop = pos_i >= st["limits"][:, None]
        if self.eos_id is not None:
            stop = stop | (b == self.eos_id)
        before_stop = torch.cat([ones, torch.cumprod(
            (~stop[:, :k - 1]).long(), dim=1).bool()], dim=1)
        live = ~st["done"]
        valid = ok & before_stop & live[:, None]
        toks = torch.where(valid, b, -1)
        nvalid = valid.sum(dim=1)          # >= 1 for every live slot
        last = (nvalid - 1).clamp(min=0)[:, None]
        last_tok = torch.gather(b, 1, last)[:, 0]
        last_stop = torch.gather(stop, 1, last)[:, 0]
        new_done = st["done"] | (live & last_stop)
        tokens = torch.where(live, last_tok, st["tokens"])
        positions = torch.where(live, pos0 + nvalid, pos0)
        emit = torch.cat([toks, new_done.long()[:, None]], dim=1)
        st["tokens"].copy_(tokens)
        st["positions"].copy_(positions)
        st["done"].copy_(new_done)
        return emit

    # -- building the step executables -----------------------------------

    def _build(self, key, fn, n_in, warm_inputs):
        """Make the executable of ``key``: run ``fn`` once on
        ``warm_inputs`` (slot 0) and put back what the run changed (the
        state vectors, slot 0's KV rows, the sampling generator), then on
        the card capture ``fn`` as one CUDA graph. The warm-up's other
        writes are KV rows at or past a slot's position counter, which the
        engine rewrites before they become visible."""
        t0 = time.perf_counter()
        exe = _Step(fn, n_in, self.device)
        cuda = self.device.type == "cuda"
        rows = [leaf[0] for leaf in _leaves(self._cache_tree())] \
            if n_in else []
        # the warm-up run's ops count once (the reference traces once);
        # with mx.insight on, its cost is counted over the weights, cache,
        # state and inputs it reads and the emit it writes
        counted = (_insight.count([self._params, self._cache_tree(),
                                   self._state, warm_inputs])
                   if _insight._active else contextlib.nullcontext({}))
        with torch.no_grad():
            saved = [t.clone() for t in _leaves(self._state) + rows]
            gen_state = self._gen.get_state()
            if cuda:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                    self._stream = torch.cuda.Stream(self.device)
                self._stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self._stream), _hooks.tracing(), \
                        counted as cost:
                    cost["outputs"] = exe(warm_inputs)
                torch.cuda.current_stream().wait_stream(self._stream)
            else:
                with _hooks.tracing(), counted as cost:
                    cost["outputs"] = exe(warm_inputs)
            cost.pop("outputs", None)
            exe.cost = cost
            for t, s in zip(_leaves(self._state) + rows, saved):
                t.copy_(s)
            self._gen.set_state(gen_state)
            del saved
            if cuda:
                try:
                    with _hooks.silent():
                        exe.capture(self._stream, self._pool,
                                    self._gen if self.temperature > 0
                                    else None)
                except Exception as e:
                    raise MXNetError(f"serve engine: capturing the {key} "
                                     f"graph failed: {e}") from e
        self._exe[key] = exe
        exe.build_s = time.perf_counter() - t0
        self.capture_seconds += exe.build_s
        self.compiles += 1
        if self._warmed:
            self.post_warmup_compiles += 1
            if _telemetry._active:
                _telemetry.inc("serve.post_warmup_compiles_total")
        kind = key if isinstance(key, str) else f"{key[0]}_{key[1]}"
        owner = self if kind == "decode" or kind.startswith("prefill") \
            else self._aux_exe_owner
        _telemetry.note_compile(owner, f"serve.{kind}", exe.build_s,
                                signatures=len(self._exe))
        if _insight._active:
            _insight.register_executable(f"serve.{kind}", compiled=exe,
                                         args=warm_inputs, kind="serve")
        return exe

    def _run(self, key, host=None):
        """Dispatch one step: build ``key``'s executable on first use, then
        run it on the int64 host inputs. Returns the emit (device)."""
        exe = self._exe.get(key)
        if exe is None:
            exe = self._build(key, *self._recipe(key))
        try:
            # the step's ops counted at its build: no hooks here (on the
            # CPU the step runs eagerly)
            with torch.no_grad(), (_hooks.silent() if _hooks.on
                                   else contextlib.nullcontext()):
                return exe(host)
        except RuntimeError as e:
            if exe.graph is None:
                raise
            raise MXNetError(f"serve engine: replaying the {key} graph "
                             f"failed: {e}") from e

    def _recipe(self, key):
        """(fn, input length, warm-up inputs) of an executable key:
        "decode", "spec", ("prefill", bucket) or ("suffix", bucket)."""
        if key in ("decode", "spec"):
            return (self._decode_fn if key == "decode" else self._spec_fn,
                    0, None)
        kind, bucket = key
        if kind == "prefill":
            return (self._prefill_fn(bucket), bucket + 3,
                    self._pack_prefill([0], bucket, 0, 1, 1))
        src = onp.arange(self.max_seq, dtype=onp.int64)
        return (self._suffix_fn(bucket), bucket + 2 * self.max_seq + 4,
                self._pack_suffix([0], bucket, src * 0, src, 0, 0, 1, 1))

    @staticmethod
    def _pack_prefill(prompt, bucket, slot, length, limit):
        host = onp.zeros((bucket + 3,), dtype=onp.int64)
        host[:len(prompt)] = prompt
        host[bucket:] = (slot, length, limit)
        return host

    @staticmethod
    def _pack_suffix(suffix, bucket, src_slots, src_rows, slot, start,
                     length, limit):
        s = len(src_slots)
        host = onp.zeros((bucket + 2 * s + 4,), dtype=onp.int64)
        host[:len(suffix)] = suffix
        host[bucket:bucket + s] = src_slots
        host[bucket + s:bucket + 2 * s] = src_rows
        host[bucket + 2 * s:] = (slot, start, length, limit)
        return host

    def warmup(self):
        """Build the full executable grid: the decode step (or the
        speculative round with a draft), one prefill per bucket and, with
        the prefix cache, one fused block-copy + suffix prefill per bucket.
        On the card each is one CUDA graph; after this no request whose
        prompt fits the buckets builds another (``post_warmup_compiles``
        stays 0)."""
        keys = ["spec" if self.draft is not None else "decode"]
        keys += [("prefill", b) for b in self.buckets]
        if self._prefix is not None:
            keys += [("suffix", b) for b in self.buckets]
        for key in keys:
            if key not in self._exe:
                self._build(key, *self._recipe(key))
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
        Admission happens inside :meth:`step` when a slot frees up.
        ``slo_class`` names one of ``serve.slo_classes`` (priority
        admission); ``None`` takes the lowest-priority (last) class."""
        prompt = [int(t) for t in onp.asarray(prompt).reshape(-1)]
        if not prompt:
            raise MXNetError("empty prompt")
        self.bucket_for(len(prompt))  # validate now, not at admission
        cls = self._classes[-1] if slo_class is None else str(slo_class)
        if cls not in self._class_rank:
            raise MXNetError(
                f"unknown slo_class {cls!r} (serve.slo_classes: "
                f"{', '.join(self._classes)})")
        if self._stopping:
            if _telemetry._active:
                _telemetry.inc("serve.rejected_total", reason="stopping")
            raise EngineBusy("stopping", len(self._queue), self._max_queue,
                             retry_after_hint=self._retry_after_hint())
        if self._max_queue and len(self._queue) >= self._max_queue:
            if _telemetry._active:
                _telemetry.inc("serve.rejected_total", reason="queue_full")
            raise EngineBusy("queue_full", len(self._queue), self._max_queue,
                             retry_after_hint=self._retry_after_hint())
        bound = self._class_bounds.get(cls, 0)
        if bound and sum(1 for r in self._queue
                         if r.slo_class == cls) >= bound:
            if _telemetry._active:
                _telemetry.inc("serve.rejected_total",
                               reason="class_queue_full")
            raise EngineBusy("class_queue_full", len(self._queue), bound,
                             retry_after_hint=self._retry_after_hint())
        req = Request(self._next_id, prompt, max_new_tokens,
                      self.eos_id if eos_id == "engine" else eos_id,
                      slo_class=cls)
        self._next_id += 1
        self._queue.append(req)
        if _trace._active:
            req._span = _trace.begin("serve.request", category="serve",
                                     request=req.id,
                                     prompt_tokens=len(prompt))
            req._enq = _trace.begin("serve.enqueue", category="serve",
                                    parent=req._span.context,
                                    request=req.id)
        if _telemetry._active:
            _telemetry.inc("serve.requests_total")
            _telemetry.set_gauge("serve.queue_depth", len(self._queue))
        return req

    def _finish(self, req):
        req.finished = True
        req.t_done = time.perf_counter()
        if req.slot is not None:
            self._slots[req.slot] = None
            self._free.append(req.slot)
            self._free.sort(reverse=True)
            req.slot = None
        if req._nodes:
            # unpin the request's radix path: its blocks become
            # LRU-evictable again
            self._prefix.release(list(req._nodes))
            req._nodes = ()
        self._completed.append(req)
        if req._enq is not None:  # finished without ever being admitted
            req._enq.end()
            req._enq = None
        if req._span is not None:
            req._span.end(tokens=len(req.generated))
            req._span = None
        if _telemetry._active:
            _telemetry.inc("serve.completed_total")
            _telemetry.inc("serve.tokens_total", len(req.generated))
            if req.tpot is not None:
                _telemetry.observe("serve.tpot_seconds", req.tpot)
                _telemetry.observe("serve.class_tpot_seconds", req.tpot,
                                   slo_class=req.slo_class)
        if self._slo_tpot and req.tpot is not None:
            self._slo_observe("tpot", req.tpot > self._slo_tpot,
                              req.slo_class)

    def _prefill_sink(self, req):
        def sink(fetched):
            t0u = _profiler.now_us() if _trace._active else 0
            span_ctx = req._span.context if req._span is not None else None
            tok, done = int(fetched[0]), bool(fetched[1])
            req.t_first = time.perf_counter()
            req.generated.append(tok)
            if _telemetry._active and req.ttft is not None:
                _telemetry.observe("serve.ttft_seconds", req.ttft)
                _telemetry.observe("serve.class_ttft_seconds", req.ttft,
                                   slo_class=req.slo_class)
            if self._slo_ttft and req.ttft is not None:
                self._slo_observe("ttft", req.ttft > self._slo_ttft,
                                  req.slo_class)
            if done:
                self._finish(req)
            if _trace._active and span_ctx is not None:
                _trace.emit("serve.drain", t0u, _profiler.now_us() - t0u,
                            parent=span_ctx, category="serve",
                            request=req.id, first_token=True)
        return sink

    def _decode_sink(self, slot_map):
        def sink(fetched):
            t0u = _profiler.now_us() if _trace._active else 0
            toks, done = fetched
            for slot, req in slot_map.items():
                if req.finished:
                    continue  # finished in an older entry of this window
                span_ctx = (req._span.context
                            if req._span is not None else None)
                tok = int(toks[slot])
                if tok >= 0:
                    req.generated.append(tok)
                if bool(done[slot]):
                    self._finish(req)
                if _trace._active and span_ctx is not None and tok >= 0:
                    _trace.emit("serve.drain", t0u,
                                _profiler.now_us() - t0u,
                                parent=span_ctx, category="serve",
                                request=req.id)
        return sink

    def _spec_sink(self, slot_map):
        """Drain sink of a speculative round: each live slot carries up to
        k token ids (-1 past the accepted point) and its done flag. A live
        slot always emits at least one token (the model's own), so
        ``emitted - 1`` proposals survived the verify."""
        def sink(fetched):
            t0u = _profiler.now_us() if _trace._active else 0
            toks, done = fetched[:, :-1], fetched[:, -1]
            k, proposed, accepted = self._spec_k, 0, 0
            for slot, req in slot_map.items():
                if req.finished:
                    continue  # finished in an older entry of this window
                span_ctx = (req._span.context
                            if req._span is not None else None)
                emitted = [int(t) for t in toks[slot] if int(t) >= 0]
                req.generated.extend(emitted)
                if emitted:
                    # rows with no emit were already done on the device:
                    # the draft proposed nothing real for them
                    proposed += k
                    accepted += len(emitted) - 1
                if bool(done[slot]):
                    self._finish(req)
                if _trace._active and span_ctx is not None and emitted:
                    _trace.emit("serve.drain", t0u,
                                _profiler.now_us() - t0u,
                                parent=span_ctx, category="serve",
                                request=req.id, tokens=len(emitted))
            self._spec_proposed += proposed
            self._spec_accepted += accepted
            if _telemetry._active and proposed:
                _telemetry.inc("serve.spec_proposed_total", proposed)
                _telemetry.inc("serve.spec_accepted_total", accepted)
                _telemetry.set_gauge(
                    "serve.spec_acceptance_rate",
                    round(self._spec_accepted
                          / max(1, self._spec_proposed), 4))
        return sink

    def _next_request(self):
        """Dequeue under strict class priority (``serve.slo_classes`` order,
        FIFO within a class), with starvation aging: once a request waits
        past ``serve.class_aging_ms`` it competes on age alone, so a
        saturated high class cannot starve the low classes forever."""
        q = self._queue
        if len(self._classes) == 1 or len(q) == 1:
            return q.popleft()
        best, best_rank = None, len(self._classes)
        for r in q:
            rank = self._class_rank[r.slo_class]
            if rank < best_rank:
                best, best_rank = r, rank
                if rank == 0:
                    break
        req = best
        if self._aging:
            now = time.perf_counter()
            aged = [r for r in q if (now - r.t_submit) >= self._aging]
            if aged:
                oldest = min(aged, key=lambda r: r.t_submit)
                if oldest is not best:
                    req = oldest
                    self._aged_admissions += 1
                    if _telemetry._active:
                        _telemetry.inc("serve.aged_admissions_total")
        q.remove(req)
        return req

    def _pick_slot(self):
        """Free-slot choice. Without the prefix cache: the lowest slot.
        With it: the coldest free slot (the one whose newest indexed block
        is oldest, never-indexed first), so admissions overwrite the
        least-reusable KV rows."""
        if self._prefix is None or len(self._free) == 1:
            return self._free.pop()
        slot = min(self._free,
                   key=lambda s: (self._prefix.slot_heat(s), s))
        self._free.remove(slot)
        return slot

    def _admit(self):
        admitted = 0
        while self._queue and self._free:
            self._dispatch_prefill(self._next_request(), self._pick_slot())
            admitted += 1
        return admitted

    def _dispatch_prefill(self, req, slot):
        """Admit ``req`` into ``slot``. With the prefix cache on, the
        longest indexed prompt prefix is gathered from its donor slots
        (block granular) and only the suffix is prefilled; the whole prompt
        is then (re)indexed under this slot and pinned until the request
        finishes."""
        length = len(req.prompt)
        limit = min(length + req.max_new_tokens - 1, self.max_seq - 1)
        t0u = _profiler.now_us() if _trace._active else 0
        t0p = time.perf_counter()
        nodes, start, sbucket = (), 0, None
        if self._prefix is not None:
            nodes = tuple(self._prefix.match(req.prompt))
            if nodes and _fault._active \
                    and _fault.fire("serve.prefix_evict"):
                # chaos: the matched prefix vanishes between match and
                # copy; the engine falls back to a full prefill
                dropped = self._prefix.evict_path(list(nodes))
                if dropped and _telemetry._active:
                    _telemetry.inc("serve.prefix_evictions_total", dropped)
                nodes = ()
            if nodes:
                start = len(nodes) * self._prefix_block
                sbucket = self.bucket_for(length - start)
                if start + sbucket > self.max_seq:
                    # the padded suffix would overrun the cache rows
                    nodes, start, sbucket = (), 0, None
            # the destination slot's stale rows leave the index first
            evicted = self._prefix.evict_slot(slot)
            if evicted and _telemetry._active:
                _telemetry.inc("serve.prefix_evictions_total", evicted)
        if nodes:
            # per-row source coordinates for the matched prefix; rows past
            # it are identity (dest slot, own row): untouched
            blk = self._prefix_block
            src_slots = onp.full((self.max_seq,), slot, dtype=onp.int64)
            src_rows = onp.arange(self.max_seq, dtype=onp.int64)
            for i, node in enumerate(nodes):
                src_slots[i * blk:(i + 1) * blk] = node.slot
                src_rows[i * blk:(i + 1) * blk] = onp.arange(
                    node.row, node.row + blk)
            suffix = req.prompt[start:]
            emit = self._run(("suffix", sbucket), self._pack_suffix(
                suffix, sbucket, src_slots, src_rows, slot, start,
                len(suffix), limit))
            req.prefix_tokens = start
            self._prefix.hits += 1
            self._prefix.tokens_reused += start
            bucket = sbucket
            if _telemetry._active:
                _telemetry.inc("serve.prefix_hits_total")
                _telemetry.inc("serve.prefix_tokens_reused_total", start)
        else:
            if self._prefix is not None:
                self._prefix.misses += 1
                if _telemetry._active:
                    _telemetry.inc("serve.prefix_misses_total")
            bucket = self.bucket_for(length)
            emit = self._run(("prefill", bucket), self._pack_prefill(
                req.prompt, bucket, slot, length, limit))
        if self._prefix is not None:
            path = self._prefix.insert(req.prompt, slot)
            self._prefix.acquire(path)
            req._nodes = tuple(path)
            if _telemetry._active:
                _telemetry.set_gauge("serve.prefix_blocks",
                                     len(self._prefix))
        req.slot = slot
        req.t_admitted = time.perf_counter()
        if req._enq is not None:
            req._enq.end()
            req._enq = None
        if _trace._active and req._span is not None:
            _trace.emit("serve.prefill", t0u, _profiler.now_us() - t0u,
                        parent=req._span.context, category="serve",
                        request=req.id, slot=slot, bucket=bucket,
                        prefix_tokens=req.prefix_tokens)
        if _trace._active or self._phase_cap:
            self._phase_note(req, "queue_wait",
                             req.t_admitted - req.t_submit)
            self._phase_note(req, "prefill", req.t_admitted - t0p)
        self._slots[slot] = req
        self._window.push(emit, self._prefill_sink(req))
        if _telemetry._active:
            _telemetry.inc("serve.admitted_total")
            _telemetry.inc("serve.prefill_tokens_total", bucket)

    # -- the serve loop --------------------------------------------------

    def step(self):
        """One continuous-batching iteration: free slots via bounded drain
        when the queue is starved, admit, dispatch ONE decode step (or
        speculative round) for every live slot, defer the result. Returns
        False when fully idle (nothing queued, running, or pending
        drain)."""
        self._last_step_time = time.monotonic()
        if self._queue and not self._free and len(self._window):
            # starved for slots: reclaim just enough, oldest first
            self._window.drain_oldest(min(len(self._queue),
                                          len(self._window)))
        admitted = self._admit()
        live = {i: r for i, r in enumerate(self._slots) if r is not None}
        if _telemetry._active:
            _telemetry.set_gauge("serve.queue_depth", len(self._queue))
            _telemetry.set_gauge("serve.slot_occupancy", len(live))
            if len(self._classes) > 1:
                depth = {c: 0 for c in self._classes}
                for r in self._queue:
                    depth[r.slo_class] += 1
                for c, v in depth.items():
                    _telemetry.set_gauge("serve.class_queue_depth", v,
                                         slo_class=c)
        if not live:
            if len(self._window):
                self._window.drain()
                return True
            return admitted > 0
        key = "spec" if self.draft is not None else "decode"
        if key not in self._exe:
            self._build(key, *self._recipe(key))
        t0 = time.perf_counter()
        emit = self._run(key)
        dt = time.perf_counter() - t0
        if self.draft is not None:
            self._spec_rounds += 1
            sink = self._spec_sink(live)
        else:
            sink = self._decode_sink(live)
        self._steps += 1
        if _telemetry._active:
            _telemetry.inc("serve.steps_total")
            _telemetry.observe("serve.step_seconds", dt)
            if self.draft is not None:
                _telemetry.inc("serve.spec_rounds_total")
        if _trace._active:
            # one span per live request per step: the dispatch wall time
            # was measured anyway, so re-stamp it on the shared clock
            duru = int(dt * 1e6)
            t0u = _profiler.now_us() - duru
            for slot, req in live.items():
                if req._span is not None:
                    _trace.emit("serve.decode_step", t0u, duru,
                                parent=req._span.context,
                                category="serve", request=req.id,
                                slot=slot, step=self._steps)
                self._phase_note(req, "decode_step", dt)
        elif self._phase_cap:
            for req in live.values():
                self._phase_note(req, "decode_step", dt)
        self._window.push(emit, sink)
        return True

    def _phase_note(self, req, key, val):
        """Per-request phase sample: unbounded while the tracer runs, else
        capped at ``serve.phase_sampling`` samples per phase so
        stats()["phases"] stays populated at a bounded cost."""
        lst = req.phases.setdefault(key, [])
        if _trace._active or len(lst) < self._phase_cap:
            lst.append(val)

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
        try:
            while self.pending:
                self.step()
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    break
            self.drain()
        except Exception as e:
            # the serving loop is the long-running production surface:
            # freeze the evidence window with engine state attached before
            # the exception unwinds (the excepthook dedupes on the same
            # exception object, so this is the one bundle)
            from .. import blackbox as _blackbox
            if _blackbox._active:
                _blackbox.set_context(serve={
                    "decode_steps": steps,
                    "queued": len(self._queue),
                    "live_slots": sum(1 for s in self._slots
                                      if s is not None),
                    "completed": len(self._completed)})
                _blackbox.dump(trigger="manual",
                               reason=f"serve.run fatal: "
                                      f"{type(e).__name__}: {e}", exc=e)
            raise
        return self

    def stop(self, drain=True):
        """Graceful shutdown: from now on :meth:`submit` raises
        :class:`EngineBusy` ("stopping"). ``drain=True`` finishes every
        in-flight and queued request first; ``drain=False`` rejects the
        queued ones (each counted in ``serve.rejected_total``) and only
        fetches already-dispatched emits. Either way the engine's /healthz
        provider is unregistered; the stop is a goodput ``drain``."""
        if self._stopping:
            return self
        self._stopping = True
        tok = _goodput.begin("drain") if _goodput._active else None
        try:
            if drain:
                self.run()
            else:
                while self._queue:
                    self._reject(self._queue.popleft(), "stopping")
                self.drain()
        finally:
            _goodput.end(tok)
            _telemetry.unregister_health(self._health_name)
        return self

    # -- weight swaps ----------------------------------------------------

    def update_weights(self, params):
        """Swap the engine's weights in place for a flat ``{name: array}``
        dict (the :func:`functional.param_arrays` layout: numpy arrays or
        tensors) and return a copy of the previous ``(passthrough,
        quantized)`` weights for :meth:`restore_weights`.

        The new weights go through the engine's quantization mode and must
        match the current ones in names, shapes and dtypes; they are
        copied into the tensors the captured graphs read, so no graph is
        captured again. The KV cache is untouched: drain in-flight
        requests first (``stop(drain=True)``), since tokens decoded under
        the old weights must not continue under the new ones."""
        with torch.no_grad():
            new = {n: torch.as_tensor(v, device=self.device)
                   for n, v in dict(params).items()}
            pt, qt, qdt = self._quantize_weights(new)
        old_pt, old_qt = self._params

        def sig(tree):
            return {k: [(tuple(t.shape), t.dtype) for t in _leaves([v])]
                    for k, v in tree.items()}
        for label, got, have in (("passthrough", pt, old_pt),
                                 ("quantized", qt, old_qt)):
            if sig(got) != sig(have) or (label == "quantized"
                                         and qdt != self._qdtypes):
                missing = sorted(set(have) - set(got))
                extra = sorted(set(got) - set(have))
                changed = sorted(k for k in set(got) & set(have)
                                 if sig({k: got[k]}) != sig({k: have[k]}))
                raise MXNetError(
                    f"update_weights: incoming {label} params do not match "
                    f"the tree the engine captured against "
                    f"(missing={missing[:4]}, extra={extra[:4]}, "
                    f"changed={changed[:4]}); build a fresh engine for a "
                    "different architecture")
        return self._write_weights((pt, qt))

    def _write_weights(self, params):
        """Copy ``params`` ((passthrough, quantized), by name) into the live
        weight tensors; returns a copy of what they held."""
        with torch.no_grad():
            old = tuple({k: (tuple(t.clone() for t in v)
                             if isinstance(v, tuple) else v.clone())
                         for k, v in tree.items()} for tree in self._params)
            for tree, src in zip(self._params, params):
                for k, v in tree.items():
                    for dst, s in zip(_leaves([v]), _leaves([src[k]])):
                        dst.copy_(s)
        return old

    def restore_weights(self, old):
        """Roll back to weights returned by :meth:`update_weights` (copied
        into the live tensors, as a swap is)."""
        self._write_weights(old)
        return self

    def resume(self):
        """Re-open a stopped engine after a weight swap: :meth:`submit`
        admits again, and the /healthz provider :meth:`stop` unregistered
        is registered again. The graphs, KV cache and slot machinery are
        untouched."""
        self._stopping = False
        self._register_health()
        return self

    def _slo_observe(self, kind, violated, slo_class="default"):
        """Account one request against the declared SLO objective of
        ``kind``: the drain-time observation point the burn rate rides."""
        self._slo_events.append(
            (time.monotonic(), kind, bool(violated), slo_class))
        if violated and _telemetry._active:
            _telemetry.inc("serve.slo_violations_total", kind=kind,
                           slo_class=slo_class)

    def slo_burn(self, window=300.0):
        """Per-kind error-budget burn rate over the trailing ``window``
        seconds: violation rate over the budget ``1 - serve.slo_target``
        (1.0 spends the budget exactly). {} until an objective is armed
        and a request has been observed."""
        budget = 1.0 - float(_config.get("serve.slo_target"))
        if budget <= 0:
            return {}
        cut = time.monotonic() - window
        out = {}
        for kind, armed in (("ttft", self._slo_ttft),
                            ("tpot", self._slo_tpot)):
            if not armed:
                continue
            hits = [v for (t, k, v, _c) in self._slo_events
                    if k == kind and t >= cut]
            if not hits:
                continue
            burn = (sum(hits) / len(hits)) / budget
            out[kind] = round(burn, 4)
            if _telemetry._active:
                _telemetry.set_gauge("serve.slo_burn_rate",
                                     round(burn, 4), kind=kind)
        return out

    def _tpot_p50(self):
        """Observed TPOT p50 over the most recent completions (the unit of
        the EngineBusy ``retry_after_hint``); before any request finished,
        the armed TPOT objective, then 20 ms."""
        tpots = sorted(r.tpot for r in self._completed[-256:]
                       if r.tpot is not None)
        if tpots:
            return tpots[len(tpots) // 2]
        return self._slo_tpot if self._slo_tpot else 0.02

    def _retry_after_hint(self):
        return self._tpot_p50() * max(1, len(self._queue))

    def _reject(self, req, reason):
        """Account a queued request discarded by stop(drain=False): its
        spans close (rejected=True), ``rejected``/``reject_reason`` flip,
        and it never reaches a slot."""
        req.rejected = True
        req.reject_reason = reason
        if req._enq is not None:
            req._enq.end()
            req._enq = None
        if req._span is not None:
            req._span.end(rejected=True)
            req._span = None
        if _telemetry._active:
            _telemetry.inc("serve.rejected_total", reason=reason)

    def _health(self):
        """/healthz provider: red while stopping; red when the engine has
        pending work but the step loop has not dispatched within
        ``serve.health_window`` seconds (a wedged or abandoned loop); red
        as well when a declared serving SLO's error budget burns past
        ``goodput.burn_threshold``."""
        if self._stopping:
            return {"ok": False, "state": "stopping"}
        if self._slo_ttft or self._slo_tpot:
            burn = self.slo_burn()
            thresh = float(_config.get("goodput.burn_threshold"))
            if burn and max(burn.values()) > thresh:
                return {"ok": False, "state": "slo_burn", "burn": burn,
                        "threshold": thresh}
        if not self.pending:
            return {"ok": True, "state": "idle", "steps": self._steps}
        last = (self._last_step_time if self._last_step_time is not None
                else self._created)
        age = time.monotonic() - last
        window = _config.get("serve.health_window")
        return {"ok": age < window, "state": "serving",
                "steps": self._steps, "last_step_age_s": round(age, 3)}

    # -- reporting -------------------------------------------------------

    def stats(self):
        """Host-side aggregate: counts, tokens and latency percentiles
        (seconds) from the per-request records, and the state of each
        feature in use."""
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
            "compiles": self.compiles,
            "post_warmup_compiles": self.post_warmup_compiles,
            "capture_seconds": self.capture_seconds,
            "max_slots": self.max_slots,
            "max_seq": self.max_seq,
            "buckets": list(self.buckets),
            "quantize": self.quantize,
            "cache_dtype": str(self.cache_dtype),
        }
        for name, vals in (("ttft", ttfts), ("tpot", tpots)):
            out[name] = {"p50": pct(vals, 50), "p95": pct(vals, 95),
                         "p99": pct(vals, 99)}
        # per-request phase breakdown: unbounded while mx.trace records,
        # else the bounded always-on reservoir (serve.phase_sampling; None
        # per phase only when both are off)
        phases = {}
        for key, label in (("queue_wait", "queue_wait"),
                           ("prefill", "prefill"),
                           ("decode_step", "decode_per_token")):
            vals = sorted(v for r in done for v in r.phases.get(key, ()))
            phases[label] = None if not vals else {
                "p50": pct(vals, 50), "p95": pct(vals, 95),
                "p99": pct(vals, 99)}
        out["phases"] = phases
        if self._slo_ttft or self._slo_tpot:
            viol = {}
            for (_t, kind, v, _c) in self._slo_events:
                if v:
                    viol[kind] = viol.get(kind, 0) + 1
            out["slo"] = {
                "ttft_ms": self._slo_ttft * 1e3 if self._slo_ttft else None,
                "tpot_ms": self._slo_tpot * 1e3 if self._slo_tpot else None,
                "target": float(_config.get("serve.slo_target")),
                "burn": self.slo_burn(),
                "violations": viol,
            }
        if self.quantize:
            pt, qt = self._params
            now, was = _quantize.quantized_bytes(pt, qt, self._qdtypes)
            out["weight_bytes"] = now
            out["weight_bytes_fp"] = was
            out["quantized_params"] = len(qt)
            out["passthrough_params"] = len(pt)
        if self._prefix is not None:
            out["prefix"] = self._prefix.stats()
        if self.draft is not None:
            rate = (self._spec_accepted / self._spec_proposed
                    if self._spec_proposed else None)
            out["spec"] = {
                "k": self._spec_k,
                "rounds": self._spec_rounds,
                "proposed": self._spec_proposed,
                "accepted": self._spec_accepted,
                "acceptance_rate": None if rate is None else round(rate, 4),
            }
        if len(self._classes) > 1 or self._aging:
            per = {}
            for cls in self._classes:
                rs = [r for r in done if r.slo_class == cls]
                ct = sorted(r.ttft for r in rs if r.ttft is not None)
                cp = sorted(r.tpot for r in rs if r.tpot is not None)
                per[cls] = {
                    "completed": len(rs),
                    "queued": sum(1 for r in self._queue
                                  if r.slo_class == cls),
                    "ttft": {"p50": pct(ct, 50), "p99": pct(ct, 99)},
                    "tpot": {"p50": pct(cp, 50), "p99": pct(cp, 99)},
                }
            out["classes"] = per
            out["aged_admissions"] = self._aged_admissions
        return out

    @property
    def prefix_hits(self):
        """Prefix-cache admission hits (0 without the prefix cache)."""
        return self._prefix.hits if self._prefix is not None else 0

    @property
    def spec_acceptance(self):
        """Draft-acceptance ratio, None without a draft or before the first
        speculative round drained."""
        if self.draft is None or not self._spec_proposed:
            return None
        return self._spec_accepted / self._spec_proposed


def load(model, max_slots=None, quantize=None, warmup=False, **kwargs):
    """Build a :class:`ServeEngine` over ``model``; ``quantize`` enables
    low-bit storage ("int8_weights", "int4_weights", "int8_kv",
    comma-combinable), ``warmup=True`` builds the whole executable grid
    before returning, ``prefix_cache=True`` turns on radix prefix-cache KV
    reuse and ``draft=small_model`` speculative decoding."""
    eng = ServeEngine(model, max_slots=max_slots, quantize=quantize,
                      **kwargs)
    if warmup:
        eng.warmup()
    return eng
