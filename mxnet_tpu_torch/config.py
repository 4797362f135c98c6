"""mx.config — typed configuration knobs with env-var overrides.

Own, trimmed copy of ``mxnet_tpu/config.py``: the same registry mechanics
(declare / get / set / reset / knobs / describe, env aliases) carrying
only the knobs the ported slices read, with the JAX package's defaults
and env names. The host planes' knobs (profiler, fault, telemetry, trace,
insight, blackbox, goodput and the serve engine's SLO and health knobs)
are the reference's declarations as they stand there.
"""
from __future__ import annotations

import os
import threading

from .base import MXNetError

__all__ = ["declare", "get", "set", "reset", "knobs", "describe"]

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


def knobs():
    return dict(_registry)


def describe():
    """Human-readable table of every knob (env_var.md analog)."""
    lines = []
    for name in sorted(_registry):
        k = _registry[name]
        env = f" [env {k.env}]" if k.env else ""
        lines.append(f"{name} ({k.typ.__name__}, default={k.default!r})"
                     f"{env}: {k.doc}")
    return "\n".join(lines)


declare("seed", int, 0, "MXNET_SEED",
        "Global RNG seed (reference: mx.random.seed / MXNET_SEED).")
declare("fused_ln_residual", str, "auto", "MXNET_FUSED_LN_RESIDUAL",
        "Fused dropout+residual+LayerNorm kernel in post-norm transformer "
        "encoder cells: 'auto' (CUDA tensor and live dropout), 'on', "
        "'off'.")
declare("fused_conv_bn", str, "auto", "MXNET_FUSED_CONV_BN",
        "Fused conv3x3+BatchNorm+ReLU training route of "
        "nn.FusableSequential, whose backward is kernel 8: 'auto' (an "
        "eligible triplet on a CUDA tensor whose triplet runs in float32 "
        "after the AMP policy, bf16 being faster through cuDNN on the H100; "
        "the reference's 'auto' "
        "is off, from a TPU v5e A/B, a TPU fact not carried over), 'on' "
        "(every eligible triplet, on the CPU through the kernel's plain "
        "version), 'off' (child by child).")
declare("quantize.fused_matmul", str, "auto", "MXNET_QUANTIZE_FUSED_MATMUL",
        "Fused quantize+matmul+epilogue route of npx.quantized_dense_fused "
        "(the int8 kernel) and npx.fp8_dense_fused (the fp8 kernel): "
        "'auto' (the CUDA kernel on a CUDA tensor, raising on a card it "
        "was not built for; the plain chain on a CPU tensor), 'on' (the "
        "kernel; raises on the CPU), 'off' (the plain chain).")
declare("quantize.fp8_format", str, "e4m3", "MXNET_QUANTIZE_FP8_FORMAT",
        "fp8 activation/weight format for the fp8 matmul variant: 'e4m3' "
        "(more mantissa, inference default) or 'e5m2' (more range).")
declare("amp.fp8_history", int, 16, "MXNET_AMP_FP8_HISTORY",
        "Delayed-scaling amax history length (steps) for fp8 training: "
        "each tensor's quantization scale derives from the max |x| seen "
        "over this many past steps.")
declare("amp.fp8_margin", float, 1.0, "MXNET_AMP_FP8_MARGIN",
        "Safety margin multiplied into the delayed-scaling amax before "
        "mapping it to the fp8 format's absmax; >1 trades headroom for "
        "resolution against inter-step amax growth.")
declare("amp.fp8_min_elems", int, 256, "MXNET_AMP_FP8_MIN_ELEMS",
        "Smallest 2-D '.weight' parameter (elements) the fp8 training "
        "path quantizes; smaller layers stay in fp32.")
declare("trainer.skip_nonfinite", bool, False, "MXNET_TRAINER_SKIP_NONFINITE",
        "Trainer.step skips (and counts) updates whose global grad norm "
        "is non-finite instead of poisoning the weights; automatic when "
        "an AMP loss scaler is attached.")
declare("kvstore.async_timeout", float, 120.0,
        "MXNET_KVSTORE_ASYNC_TIMEOUT",
        "Seconds a blocking dist kvstore collective (a push's reduce, a "
        "dist_async reconciling pull) may wait before its watchdog raises "
        "CollectiveTimeout (mismatched pull schedules deadlock the "
        "collective; the reference's ZMQ server has no such constraint)")
declare("kvstore.retry_max", int, 2, "MXNET_KVSTORE_RETRY_MAX",
        "Transient-failure retries per blocking dist collective "
        "(CollectiveTimeout / transport hiccups): each retry re-barriers "
        "through the process group's store, then waits again for an "
        "attempt already in the group (or issues one that never reached "
        "it); 0 disables retry (a timeout raises immediately); exhausting "
        "the budget escalates a structured resilience.WorkerLost.")
declare("kvstore.retry_backoff", float, 0.5, "MXNET_KVSTORE_RETRY_BACKOFF",
        "Base seconds slept before a collective retry (doubles per "
        "attempt, +25% jitter so rejoining workers don't stampede the "
        "rendezvous store).")
declare("kvstore.rejoin_timeout", float, 10.0, "MXNET_KVSTORE_REJOIN_TIMEOUT",
        "Seconds a retrying worker waits at the rejoin barrier (the "
        "process group's store) for its peers, or for its own attempt to "
        "complete, before retrying anyway (alignment only: no rank issues "
        "a collective twice, so a missed barrier is counted, not fatal).")
declare("comm.compress", str, "none", "MXNET_COMM_COMPRESS",
        "Gradient compression for the dp-axis reduction inside "
        "ShardedTrainStep: 'none', 'int8' (symmetric int8 with error "
        "feedback, ~4x fewer wire bytes) or 'bf16' (~2x). Requires a "
        "pure-dp mesh.")
declare("comm.bucket_mb", float, 4.0, "MXNET_COMM_BUCKET_MB",
        "Flat gradient bucket size (MiB, fp32 element count) for the "
        "compressed dp reduction; each bucket reduces as one collective.")
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
declare("serve.allow_fp8_requant", bool, False, "MXNET_SERVE_ALLOW_FP8_REQUANT",
        "Let int4_weights serve engines requantize fp8-trained "
        "checkpoints anyway (default off: double quantization below the "
        "fp8 grid's resolution degrades accuracy silently).")
declare("serve.quantize_min_elems", int, 4096, "MXNET_SERVE_QUANTIZE_MIN_ELEMS",
        "Smallest parameter (elements) serve weight quantization touches; "
        "below it the bytes saved don't cover the dequant epilogue.")
declare("serve.quantize_ndim", int, 2, "MXNET_SERVE_QUANTIZE_NDIM",
        "Parameter rank serve weight quantization targets (2 = matmul "
        "weights; biases/norms always pass through in fp).")
declare("serve.quantize_group_size", int, 128,
        "MXNET_SERVE_QUANTIZE_GROUP_SIZE",
        "Input-axis group size for int4 group-wise weight scales; rows "
        "whose width is not divisible fall back to one scale per row.")
declare("serve.prefix_cache", int, 0, "MXNET_SERVE_PREFIX_CACHE",
        "Enable the engine's radix prefix cache (1 = on): requests "
        "sharing a cached token-block prefix copy the matching KV rows "
        "inside the fixed donated cache allocation and prefill only "
        "the suffix. Off by default — enabling adds a block-copy and a "
        "per-bucket suffix-prefill executable to the warmup grid.")
declare("serve.prefix_block", int, 16, "MXNET_SERVE_PREFIX_BLOCK",
        "Tokens per KV block in the prefix cache's radix index (and in "
        "mx.servefleet's prefix-fingerprint router): reuse happens at "
        "whole-block granularity, so smaller blocks match more but "
        "index more.")
declare("serve.prefix_capacity", int, 0, "MXNET_SERVE_PREFIX_CAPACITY",
        "Max blocks the prefix cache's radix index may hold before "
        "LRU-evicting refcount-0 leaves; 0 = unbounded (the natural "
        "bound is max_slots * max_seq / prefix_block — the index only "
        "ever points at rows of the fixed cache allocation).")
declare("serve.spec_tokens", int, 4, "MXNET_SERVE_SPEC_TOKENS",
        "Speculative-decoding proposal length k: the draft model "
        "proposes k tokens greedily per round and the big model "
        "verifies all k in one batched call. Used only when the "
        "engine was built with a draft model.")
declare("serve.slo_classes", str, "", "MXNET_SERVE_SLO_CLASSES",
        "Multi-tenant SLO classes, comma-separated, highest priority "
        "first (e.g. 'gold,bronze'). Admission dequeues strict-"
        "priority with starvation aging (serve.class_aging_ms); '' = "
        "one implicit 'default' class (plain FIFO, the single-tenant "
        "behaviour).")
declare("serve.class_aging_ms", float, 0.0, "MXNET_SERVE_CLASS_AGING_MS",
        "Starvation-aging knob for SLO-class admission: a queued "
        "request waiting longer than this is promoted ahead of "
        "strict priority (oldest aged request first). 0 = pure "
        "strict priority (low classes can starve under overload).")
declare("serve.class_max_queue", str, "", "MXNET_SERVE_CLASS_MAX_QUEUE",
        "Per-class queue budgets as 'class=N,class=N' (e.g. "
        "'gold=8,bronze=64'): submit() rejects a class past its own "
        "budget with EngineBusy(queue_full) even when the global "
        "serve.max_queue still has room. Classes absent from the spec "
        "fall back to the global bound.")
declare("cached_graph.max_signatures", int, 512,
        "MXNET_CACHED_GRAPH_MAX_SIGNATURES",
        "Most signatures one hybridized block (per train mode) keeps; the "
        "least recently used is dropped, with its CUDA graphs and memory "
        "pool, when a new one would pass it (reference analog: "
        "CachedOpConfig limits, src/imperative/cached_op.h:412-459).")

# -- the host planes (mx.profiler, fault, telemetry, trace, pipeline, insight,
# blackbox, goodput) and the serve engine's SLO and health knobs: the
# reference's declarations
declare("profiler.autostart", bool, False, "MXNET_PROFILER_AUTOSTART",
        "Start the profiler at import (reference: profiler env knob).")
declare("fault.spec", str, "", "MXNET_FAULT_SPEC",
        "Fault-injection spec, 'point:at=N[,prob=P,times=K,seed=S];...' "
        "('' = all injection points disabled; see mx.fault.POINTS).")
declare("telemetry.enable", bool, False, "MXNET_TELEMETRY",
        "Enable the mx.telemetry metrics registry (counters/gauges/"
        "histograms wired through cached-graph compile, dataloader, "
        "trainer, kvstore and fault paths); disabled, every hook costs "
        "one module-attribute read.")
declare("telemetry.recompile_limit", int, 8, "MXNET_TELEMETRY_RECOMPILE_LIMIT",
        "Per-block XLA trace+compile count above which the recompilation "
        "detector emits a structured RecompileWarning (the TPU shape-"
        "polymorphism pitfall); fires once per block.")
declare("telemetry.jsonl", str, "", "MXNET_TELEMETRY_JSONL",
        "Default JSONL path for TrainingTelemetry step records and the "
        "final run report ('' = keep records in memory only).")
declare("telemetry.step_interval", int, 1, "MXNET_TELEMETRY_STEP_INTERVAL",
        "TrainingTelemetry emits a JSONL step record every N step() calls.")
declare("dataloader.worker_mode", str, "auto", "MXNET_DATALOADER_WORKER_MODE",
        "num_workers>0 execution mode: 'threads', 'processes', or 'auto' "
        "(a first-batch cost probe picks processes only for GIL-bound "
        "python transforms).")
declare("dataloader.mp_threshold_ms", float, 2.0,
        "MXNET_DATALOADER_MP_THRESHOLD_MS",
        "auto worker mode: per-sample python cost (ms) above which the "
        "GIL dominates and process workers beat threads.")
declare("dataloader.max_respawns", int, 2, "MXNET_DATALOADER_MAX_RESPAWNS",
        "Crashed/hung worker-pool respawns tolerated per epoch before the "
        "loader degrades to threaded workers.")
declare("dataloader.respawn_backoff", float, 0.1,
        "MXNET_DATALOADER_RESPAWN_BACKOFF",
        "Base seconds slept before respawning a crashed worker pool "
        "(doubles per retry).")
declare("dataloader.shm_ring", bool, True, "MXNET_DATALOADER_SHM_RING",
        "Process-worker loaders reuse a pool of SharedMemory segments "
        "across batches instead of create/unlink per batch; off restores "
        "one-shot segments.")
declare("dataloader.shm_ring_max", int, 32, "MXNET_DATALOADER_SHM_RING_MAX",
        "Max idle SharedMemory segments the reuse pool keeps per loader; "
        "overflow segments are unlinked oldest-first.")
declare("pipeline.prefetch_depth", int, 2, "MXNET_PIPELINE_PREFETCH_DEPTH",
        "In-flight batch window of a mx.pipeline.DevicePrefetcher (2 = "
        "double buffering, 3 = triple); bounds host+device memory pinned "
        "by prefetched batches.")
declare("pipeline.stall_timeout", float, 30.0, "MXNET_PIPELINE_STALL_TIMEOUT",
        "Seconds a DevicePrefetcher consumer waits on an empty queue "
        "before declaring the background thread stalled and handing its "
        "source iterator to a replacement thread (counted in "
        "mx.fault.stats()).")
declare("pipeline.deferred_window", int, 32, "MXNET_PIPELINE_DEFERRED_WINDOW",
        "Default mx.pipeline.DeferredWindow capacity: device scalars "
        "(grad norms, metric accumulators) pending host fetch; overflow "
        "drains oldest-first and counts as a host sync.")
declare("trace.enable", bool, False, "MXNET_TRACE",
        "Enable the mx.trace span recorder (causal tracing through the "
        "train step, pipeline prefetch, serve request and autotune trial "
        "lifecycles); disabled, every hook costs one module-attribute "
        "read, like telemetry.enable.")
declare("trace.buffer", int, 4096, "MXNET_TRACE_BUFFER",
        "Capacity of the per-process mx.trace span ring buffer; overflow "
        "drops oldest-first and counts trace.dropped_total.")
declare("telemetry.http_port", int, 0, "MXNET_TELEMETRY_PORT",
        "Arm the stdlib ops endpoint at import on this port (0 = off): "
        "GET /metrics (Prometheus exposition), /healthz, /trace?last=N. "
        "mx.telemetry.serve_http(port) starts it at runtime; port 0 "
        "there binds an ephemeral port.")
declare("fleet.lease_dir", str, "", "MXNET_FLEET_LEASE_DIR",
        "Shared directory for the file-backed heartbeat-lease fallback "
        "of the mx.fleet health plane ('' = coordination-service only). "
        "Every host renews host-<rank>.lease there; peers whose lease "
        "age exceeds fleet.lease_timeout are treated as lost.")
declare("insight.enable", bool, False, "MXNET_INSIGHT",
        "Master switch for the mx.insight attribution plane (XLA cost "
        "capture, live MFU/roofline gauges, step-time drift detection, "
        "fleet snapshots). Disabled, every insight hook costs one "
        "attribute read.")
declare("insight.drift_window", int, 32, "MXNET_INSIGHT_DRIFT_WINDOW",
        "Samples anchoring the drift detector's robust baseline "
        "(median + MAD) and setting the EWMA half-life over step-time "
        "sources; an injected slowdown must alarm within this many "
        "samples.")
declare("insight.drift_sigma", float, 3.0, "MXNET_INSIGHT_DRIFT_SIGMA",
        "Robust z-score (MAD-scaled) the step-time EWMA must exceed "
        "above baseline, two samples running, before insight.drift "
        "fires — the false-positive vs time-to-detect dial.")
declare("insight.snapshot_interval", float, 5.0,
        "MXNET_INSIGHT_SNAPSHOT_INTERVAL",
        "Seconds between atomic insight-<rank>.json fleet snapshots "
        "published next to the heartbeat leases (riding the "
        "HealthPlane.beat cadence, so no extra thread).")
declare("insight.input_bound_ratio", float, 0.5,
        "MXNET_INSIGHT_INPUT_BOUND_RATIO",
        "Fraction of the measured step time the pipeline.input_stall_"
        "seconds p50 must exceed before the roofline verdict flips to "
        "'input' — the data plane, not the math, is the bottleneck "
        "(surfaced on /insight and in bench rows).")
declare("insight.straggler_ratio", float, 1.5,
        "MXNET_INSIGHT_STRAGGLER_RATIO",
        "A host whose step-time EWMA (from its fleet snapshot) exceeds "
        "this multiple of the fleet median is marked a straggler by "
        "check_peers, independent of the fixed fleet.slow_fraction "
        "deadline cutoff.")
declare("stream.on_corrupt", str, "raise", "MXNET_STREAM_ON_CORRUPT",
        "Checksum-failure policy for mx.stream record reads: 'raise' "
        "escalates a structured CorruptRecord, 'skip' drops the record "
        "and counts it in stream.records_skipped_total.")
declare("stream.open_retries", int, 2, "MXNET_STREAM_OPEN_RETRIES",
        "Shard-open attempts retried (with stream.open_backoff * attempt "
        "sleeps) before mx.stream escalates a WorkerLost-style "
        "ShardUnreadable; the bounded budget guarantees escalation "
        "instead of a hang.")
declare("stream.open_backoff", float, 0.05, "MXNET_STREAM_OPEN_BACKOFF",
        "Base backoff (seconds) between shard-open retries; attempt k "
        "sleeps k * backoff.")
declare("resilience.max_restarts", int, 3, "MXNET_RESILIENCE_MAX_RESTARTS",
        "In-process training restarts mx.resilience.run() performs after "
        "a WorkerLost escalation (each restart restores the last "
        "TrainState bundle) before re-raising to the caller.")
declare("resilience.keep_bundles", int, 3, "MXNET_RESILIENCE_KEEP_BUNDLES",
        "Valid TrainState bundle generations retained by save() as the "
        "fallback chain (<path>.gN history hard-links); torn and older "
        "generations are deleted at save time. 0 keeps only the primary "
        "bundle file.")
declare("resilience.restart_window_steps", int, 1000,
        "MXNET_RESILIENCE_RESTART_WINDOW",
        "Healthy-progress window (optimizer steps between WorkerLost "
        "events) after which mx.resilience.run's restart budget resets; "
        "0 keeps the budget monotonic.")
declare("telemetry.report_max_bytes", int, 0,
        "MXNET_TELEMETRY_REPORT_MAX_BYTES",
        "Size cap (bytes) for a TrainingTelemetry JSONL report file; when "
        "the next record would cross it the file rotates to the next free "
        "<path>.gNNNN generation (whole records only, never truncated "
        "mid-line) so ROADMAP item 5 keeps every generation discoverable "
        "via TrainingTelemetry.generations(). 0 = unbounded.")
declare("telemetry.event_ring", int, 256, "MXNET_TELEMETRY_EVENT_RING",
        "Capacity of the bounded telemetry event ring that captures "
        "python warnings (RecompileWarning et al.) and framework log "
        "records >= WARNING once mx.blackbox arms its capture hooks; "
        "postmortem bundles embed this ring so crashes carry the "
        "warnings that preceded them.")
declare("blackbox.enable", bool, False, "MXNET_BLACKBOX",
        "Arm the mx.blackbox flight recorder: sys/threading excepthooks, "
        "warning/log capture into the telemetry event ring, and shadow "
        "snapshots riding HealthPlane.beat; terminal triggers (uncaught "
        "exception, preemption, WorkerLost, non-finite escalation, "
        "insight drift) then write one crash-atomic checksummed "
        "postmortem bundle. Disabled, every hook costs one module-"
        "attribute read.")
declare("blackbox.dir", str, "", "MXNET_BLACKBOX_DIR",
        "Directory for blackbox-<rank>-<step>.json postmortem bundles "
        "('' = fall back to fleet.lease_dir at dump time so surviving "
        "hosts can read a dead peer's bundle; if that is also unset, "
        "dumps are skipped).")
declare("blackbox.window", int, 256, "MXNET_BLACKBOX_WINDOW",
        "Last-N evidence window a postmortem bundle embeds: newest N "
        "trace spans and newest N telemetry events (the metric snapshot "
        "and knob dump are always whole).")
declare("blackbox.checkpoint_interval", float, 10.0,
        "MXNET_BLACKBOX_CHECKPOINT_INTERVAL",
        "Seconds between shadow bundle snapshots riding HealthPlane.beat "
        "(no extra thread) so SIGKILL/OOM — where no excepthook runs — "
        "still leaves a <=interval-stale bundle per host; 0 disables "
        "shadow snapshots.")
declare("blackbox.keep", int, 3, "MXNET_BLACKBOX_KEEP",
        "Newest postmortem bundles retained per rank by dump()'s "
        "retention sweep (older bundle + .sha256 sidecar pairs are "
        "deleted); 0 keeps every bundle.")
declare("serve.health_window", float, 30.0, "MXNET_SERVE_HEALTH_WINDOW",
        "Seconds without a decode step while work is pending before the "
        "serve engine reports itself unhealthy on the ops /healthz "
        "endpoint (step-loop liveness, not static OK).")
declare("goodput.enable", bool, False, "MXNET_GOODPUT",
        "Master switch for the mx.goodput wall-clock ledger (badput "
        "attribution, fleet device-second merge, SLO burn rates). "
        "Disabled, every goodput hook costs one attribute read.")
declare("goodput.target", float, 0.0, "MXNET_GOODPUT_TARGET",
        "Training goodput SLO: the target fraction of wall clock spent "
        "in compute (e.g. 0.95). Setting it arms the 5m/1h error-"
        "budget burn-rate gauges and the goodput /healthz provider; "
        "0 disables the SLO layer.")
declare("goodput.burn_threshold", float, 2.0,
        "MXNET_GOODPUT_BURN_THRESHOLD",
        "Error-budget burn rate past which the goodput /healthz "
        "provider reports unhealthy (503) — only when every burn "
        "window agrees, so a 5-minute blip alone never pages.")
declare("goodput.snapshot_interval", float, 5.0,
        "MXNET_GOODPUT_SNAPSHOT_INTERVAL",
        "Seconds between atomic goodput-<rank>.json ledger snapshots "
        "published next to the heartbeat leases (riding the "
        "HealthPlane.beat cadence, so no extra thread).")
declare("serve.slo_ttft_ms", float, 0.0, "MXNET_SERVE_SLO_TTFT_MS",
        "Serving SLO: time-to-first-token objective in milliseconds. "
        "A finished prefill slower than this counts into "
        "serve.slo_violations_total{kind=ttft} and the per-engine "
        "burn gauge; 0 disarms the ttft objective.")
declare("serve.slo_tpot_ms", float, 0.0, "MXNET_SERVE_SLO_TPOT_MS",
        "Serving SLO: per-output-token decode latency objective in "
        "milliseconds, checked at request finish; violations count "
        "into serve.slo_violations_total{kind=tpot}. 0 disarms.")
declare("serve.slo_target", float, 0.99, "MXNET_SERVE_SLO_TARGET",
        "Fraction of requests that must meet the serve SLO "
        "objectives; 1 - target is the error budget the "
        "serve.slo_burn_rate gauges burn against.")
declare("serve.phase_sampling", int, 64, "MXNET_SERVE_PHASE_SAMPLING",
        "Per-request cap on always-on phase timing samples "
        "(queue_wait/prefill/decode_step) kept for stats()['phases'] "
        "without the tracer armed; 0 restores the trace-only "
        "behaviour (one attribute read on the disabled path).")
