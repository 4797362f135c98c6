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
